"""Time row 9 across cards (the halo exchange) and the steps that run it,
from several checkouts, in one run on four cards, so that a change to the
exchange can be told apart from the spread between runs.

    python3 scripts/compare_exchange_trees.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository, timed in processes of its own
that import ``bignn_tpu_torch`` from that ROOT (and so build that ROOT's
kernels under ROOT/build), in the order given: give them as A B B A
(parent, change, change, parent). The measurements are this checkout's
``chip_smoke.py`` functions, whatever tree is timed:

- ``m_exchange``: path M(i), one process over the four cards, at config5's
  and config5-large's send buffers (``chip_smoke.M_SHAPES``): exact
  against the plain version forward and backward, then device ms queued
  behind a sleep, host-paced ms and each card's kernel by
  ``torch.profiler``;
- the M(ii) step: config5, its 4 graph shards over the cards in one
  process, path G's first ``chip_smoke.K_STEPS`` batches: the median
  step, the losses and the parameters' digest;
- path N through ``chip_smoke.k_worker_step`` as two processes of two
  cards each: the N(i) step median, losses and digest, and row 9 across
  them (``k_exchange_times``) at config5's buffers (the step's own) and at
  config5-large's (``n_exchange_large``): the whole exchange's host ms,
  every process's launches at once queued behind sleeps, each card's
  kernel by ``torch.profiler``.

The functions it calls take only what every tree since the exchange
across processes of several cards has (``ops.all_to_all``,
``PeerExchange.launch_staged``, the kernel named ``exchange``).

One JSON line per ROOT (``{"root": ..., "m": ..., "m_step": ..., "n":
[...]}``), then a ``same_bits`` line: whether every ROOT gave the same
losses and digests (the exchange moves bytes, so it must). Needs four
cards; every process it starts is waited for or killed.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
TIMEOUT = 900  # seconds for one tree, its processes included


def _smoke(root: str):
    """This checkout's chip_smoke.py as a module, ``root``'s package first
    on the path."""
    sys.path.insert(0, str(Path(root).resolve()))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CHECKOUT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    return smoke


def _m_step(smoke, cards) -> dict:
    """Path M(ii)'s step: config5 over the cards in one process."""
    import numpy as np

    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.parallel import make_mesh, spread_devices

    cfg = get_config("config5")
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    mesh = make_mesh(dp=1, graph=cfg.graph_shards,
                     devices=spread_devices(cfg.graph_shards, cards))
    _, _, plan_d = smoke.p2_layout(cards[0], ds, cfg.graph_shards,
                                   cfg.model.inner_layers, mesh=mesh)
    model = BiGNN(cfg.model, seed=smoke.SEED).to(cards[0])
    tr = smoke.P2Trainer(model, cfg.train, mesh, ds.num_drugs, plan_d)
    secs = []
    losses, _ = smoke._timed_steps(
        tr, smoke._train_batches(ds, cfg.train)[:smoke.K_STEPS],
        "M(ii) step", secs)
    return {"median_ms": float(np.median(secs) * 1e3), "secs": secs,
            "losses": losses, "digest": smoke._digest(model)}


def _tree(root: str) -> dict:
    smoke = _smoke(root)
    smoke.check_device()
    smoke.build_kernels()
    cards = smoke.visible_cards()
    if len(cards) < 4:
        raise SystemExit(f"needs four cards, found {len(cards)}")
    rate = smoke.link_rate()
    m = smoke.m_exchange(cards, rate, smoke.M_SHAPES)
    m_step = _m_step(smoke, cards)
    port = smoke._free_port()
    outs = smoke._spawn(
        [[sys.executable, str(Path(__file__).resolve()), "--worker", root,
          str(r), str(port)] for r in range(smoke.N_PROCS)], "compare_n")
    n = [smoke._last_json(o) for o in outs]
    return {"root": root, "card": smoke.card_line(), "m": m,
            "m_step": m_step, "n": n}


def _worker(root: str, rank: int, port: int) -> dict:
    smoke = _smoke(root)
    return smoke.k_worker_step(rank, port, "auto", smoke.N_PROCS, True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--worker"]:
        root, rank, port = argv[1], int(argv[2]), int(argv[3])
        print(json.dumps(_worker(root, rank, port)), flush=True)
        return 0
    if argv[:1] == ["--tree"]:
        print(json.dumps(_tree(argv[1])), flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    bits = []
    for root in map(str, (Path(r).resolve() for r in argv)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree", root],
            cwd=CHECKOUT, capture_output=True, text=True, timeout=TIMEOUT)
        lines = proc.stdout.rstrip().splitlines() or [""]
        sys.stderr.write("".join(x + "\n" for x in lines[:-1])
                         + proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exited {proc.returncode}")
        print(lines[-1], flush=True)
        got = json.loads(lines[-1])
        bits.append((got["m_step"]["losses"], got["m_step"]["digest"],
                     [(w["losses"], w["digest"]) for w in got["n"]]))
    print(json.dumps({"same_bits": all(b == bits[0] for b in bits)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
