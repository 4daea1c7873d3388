"""Do seeded training runs of the port repeat bit for bit?

    python scripts/check_repeat.py                 # on the card
    python scripts/check_repeat.py --small --device cpu   # a quick trial

Starts ``--processes`` processes (default 2). Each trains twice: config2
through ``bignn_tpu_torch.run.main`` (2 epochs), config4's device-sampled
``MinibatchTrainer`` from the init of seed 0 (4 chunks of 8 steps) and
config5's p2 mode through ``run.main`` (1 epoch, 4 graph shards on the one
device). It then prints every run's losses and AUCs, and which runs agree
bit for bit within a process and between processes. A last process runs
the same once more with ``torch.use_deterministic_algorithms(True,
warn_only=True)`` and anomaly mode on. It names the CUDA ops without a
deterministic implementation that the runs reached, from PyTorch's own
warnings. It also names each autograd node whose backward scatters
(``index_select``, ``gather``, ``index``, ``index_add``, ``scatter_add``
...), with the port's line that made it. ``--small`` runs config1 and
config4 at 300 drugs, and no config5, small enough for the CPU. The last
line is one JSON object; the exit code is 0 whether or not the runs
repeat.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# autograd nodes whose backward is a scatter (several rows summed into one)
SCATTER_NODES = ("IndexSelectBackward0", "GatherBackward0", "IndexBackward0",
                 "IndexAddBackward0", "ScatterAddBackward0",
                 "ScatterBackward0", "ScatterReduceBackward0",
                 "IndexPutBackward0", "EmbeddingBackward0", "TakeBackward0",
                 "PutBackward0")
C4_CHUNKS, C4_CHUNK = 4, 8
CONFIGS = ("config2", "config4", "config5")  # the order a child runs them


def run_config2(dev: str, small: bool) -> dict:
    from bignn_tpu_torch import run

    name = "config1" if small else "config2"
    out = run.main(["--config", name, "--epochs", "2", "--device", dev])
    return {"config": name,
            "losses": [float(h["loss"]) for h in out["history"]],
            "val_auc": [float(h["val_auc"]) for h in out["history"]],
            "best_epoch": out["best_epoch"],
            "test_auc": float(out["test_auc"])}


def run_config5(dev: str) -> dict:
    from bignn_tpu_torch import run

    out = run.main(["--config", "config5", "--epochs", "1", "--device", dev])
    return {"config": "config5",
            "losses": [float(h["loss"]) for h in out["history"]],
            "final_loss": float(out["final_loss"]),
            "test_auc": float(out["test_auc"])}


def config4_dataset(small: bool):
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset

    cfg = get_config("config4")
    kwargs = dict(cfg.dataset_kwargs)
    if small:
        kwargs["num_drugs"] = 300
    return load_dataset(cfg.dataset, **kwargs)


def run_config4(dev: str, ds, small: bool) -> dict:
    import dataclasses

    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import MinibatchTrainer

    cfg = get_config("config4")
    train = cfg.train
    max_drugs = cfg.max_drugs
    if small:
        train = dataclasses.replace(train, batch_size=32)
        max_drugs = 256
    tr = MinibatchTrainer(BiGNN(cfg.model, seed=0), ds, train,
                          fanouts=cfg.fanouts, max_drugs=max_drugs,
                          dispatch_chunk=C4_CHUNK, device_sample=True,
                          device=dev)
    tr.init(0)
    losses = []
    for c in range(C4_CHUNKS):
        ls, _ = tr.train_chunk_device(0, c * C4_CHUNK, C4_CHUNK)
        losses += [float(v) for v in ls.float().cpu()]
    weights = torch.cat([p.detach().float().reshape(-1).cpu()
                         for p in tr.model.parameters()])
    return {"config": "config4", "losses": losses,
            "weights_sum": float(weights.double().sum()),
            "weights_sha": __import__("hashlib").sha256(
                weights.numpy().tobytes()).hexdigest()[:16]}


def _port_frame(stack: str) -> str:
    """The two innermost lines of the port's package in a forward
    traceback, as ``file:line (function)``, the innermost last."""
    sites = []
    for ln in stack.splitlines():
        ln = ln.strip()
        if ln.startswith("File") and "bignn_tpu_torch" in ln:
            path, line, func = ln.split(", ")[:3]
            path = path[len('File "'):-1].split("bignn_tpu_torch/", 1)[1]
            sites.append(f"{path}:{line.split()[1]} ({func.split()[1]})")
    return " < ".join(sites[-2:][::-1]) or "(no frame of the port)"


def _walk(root, seen: dict) -> None:
    stack, visited = [root], set()
    while stack:
        node = stack.pop()
        if node is None or node in visited:
            continue
        visited.add(node)
        name = type(node).__name__
        if name in SCATTER_NODES:
            tb = node.metadata.get("traceback_", "")
            site = _port_frame("".join(tb) if isinstance(tb, list) else tb)
            seen[f"{name} @ {site}"] += 1
        stack.extend(fn for fn, _ in node.next_functions)


def child(dev: str, small: bool, find: bool) -> dict:
    from bignn_tpu_torch.ops import cuda_lib

    if dev != "cpu":
        cuda_lib.build()
    out = {"pid": os.getpid(), "runs": []}
    nodes: dict = collections.Counter()
    messages: dict = collections.Counter()
    original = torch.Tensor.backward

    def backward(self, *a, **k):
        _walk(self.grad_fn, nodes)
        return original(self, *a, **k)

    ds = config4_dataset(small)
    repeats = 1 if find else 2
    with warnings.catch_warnings(record=True) as caught:
        if find:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            torch.autograd.set_detect_anomaly(True, check_nan=False)
            torch.Tensor.backward = backward
        try:
            for _ in range(repeats):
                t0 = time.perf_counter()
                out["runs"].append(run_config2(dev, small))
                out["runs"].append(run_config4(dev, ds, small))
                if not small:
                    out["runs"].append(run_config5(dev))
                out["runs"][-1]["seconds"] = time.perf_counter() - t0
        finally:
            torch.Tensor.backward = original
    for w in caught:
        text = str(w.message)
        if "deterministic" in text:
            messages[text.splitlines()[0][:200]] += 1
    if find:
        out["nondeterministic_warnings"] = dict(messages)
        out["scatter_nodes"] = dict(nodes)
    return out


def _same(a: dict, b: dict) -> bool:
    keys = [k for k in a if k not in ("seconds",)]
    return all(a[k] == b.get(k) for k in keys)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--small", action="store_true")
    p.add_argument("--child", choices=["runs", "find"], default=None)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.device, args.small, args.child == "find")))
        return 0
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("check_repeat: no CUDA device")
    base = [sys.executable, str(Path(__file__).resolve()), "--device",
            args.device] + (["--small"] if args.small else [])
    results = []
    for kind in ["runs"] * args.processes + ["find"]:
        t0 = time.perf_counter()
        # cuBLAS's workspace setting only where deterministic mode wants it
        env = dict(os.environ, **({"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
                                  if kind == "find" else {}))
        proc = subprocess.run(base + ["--child", kind], env=env, cwd=ROOT,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-8000:])
            raise SystemExit(f"check_repeat: a {kind} process failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["kind"], res["seconds"] = kind, time.perf_counter() - t0
        results.append(res)
        print(f"process {len(results)} ({kind}, {res['seconds']:.1f} s):")
        for r in res["runs"]:
            print("  " + json.dumps(r))
        for key in ("nondeterministic_warnings", "scatter_nodes"):
            for msg, n in res.get(key, {}).items():
                print(f"  {key}: {n} x {msg}")
    runs = [r for r in results if r["kind"] == "runs"]
    verdict = {}
    configs = CONFIGS[:2] if args.small else CONFIGS
    for i, config in enumerate(configs):
        within = all(_same(r["runs"][i], r["runs"][i + len(configs)])
                     for r in runs)
        between = all(_same(runs[0]["runs"][i], r["runs"][i]) for r in runs)
        verdict[config] = {"within_process": within,
                           "between_processes": between}
        if not between:
            a, b = runs[0]["runs"][i], runs[-1]["runs"][i]
            diff = np.abs(np.subtract(a["losses"], b["losses"]))
            verdict[config]["max_loss_difference"] = float(diff.max())
    find = results[-1]
    print(json.dumps({
        "device": (torch.cuda.get_device_name(0) if args.device != "cpu"
                   else "cpu"),
        "repeat": verdict,
        "nondeterministic_warnings": find["nondeterministic_warnings"],
        "scatter_nodes": find["scatter_nodes"]}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        sys.exit(1)
