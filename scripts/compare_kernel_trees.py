"""Time the port's float32 streaming kernels from several checkouts on the
same inputs, in one run on one card, so that a change to a kernel source
can be told apart from the spread between runs.

    python3 scripts/compare_kernel_trees.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository. Each is timed in a process of
its own that imports ``bignn_tpu_torch`` from that ROOT (and so builds that
ROOT's kernels under ROOT/build), in the order given: give them as A B B A.
The forms are rows 5-7 of PERF.md's kernel table at the shapes
``chip_smoke.py`` gives them:

- ``segment_max:f32``: the largest bucket of the DrugBank stand-in (block-
  local ids with padding runs), F 128;
- ``spmm_sorted_coo{,_bwd}:f32{,:weighted}``: the largest bucket of the
  stand-in with molecules up to 160 atoms, F 128 unweighted, F 64 weighted;
- ``block_spmm{,_bwd}:f32{,:weighted}``: the largest bucket of
  synthetic-large cut to 16,384 drugs (301,312 rows), F 128.

Each form is timed by CUDA events in two ways: ``ms``, the mean of 10 calls
after 3 warm-ups, as ``chip_smoke.py`` times it (the host's cost of a call
can set this rate); ``device_ms``, the mean of 200 calls queued behind a
device sleep, so that the card runs them back to back and the host does
not set the rate (``host_ms`` is the host's time to queue them, which must
stay below the sleep). Each result is checked against the plain version.
Prints one JSON line per ROOT; needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
REPS, WARMUP = 10, 3
DEVICE_REPS = 200
SLEEP_CYCLES = 400_000_000  # ~0.2 s at the H100's 1.98 GHz boost clock


def events_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Mean milliseconds per call by CUDA events, as chip_smoke.py's
    ``cuda_ms``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sleep_ms() -> float:
    """Device milliseconds of one ``torch.cuda._sleep(SLEEP_CYCLES)``."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, reps: int = DEVICE_REPS) -> tuple[float, float]:
    """Mean device milliseconds per call with the calls queued behind a
    device sleep, and the host's milliseconds to queue them all."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def largest(bucketing):
    return max(bucketing.batches, key=lambda b: b.node_cap)


def cases(dev):
    """(name, kernel call, plain call) for each float32 form."""
    import torch

    from bignn_tpu_torch import ops
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.sparse import bucket_graphs

    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = []

    b = largest(bucket_graphs(load_dataset("drugbank").molecules))
    ids = torch.as_tensor(b.graph_ids, device=dev)
    s = b.num_graphs
    x = torch.randn(b.node_cap, 128, device=dev, generator=gen)
    out.append(("segment_max:f32", lambda: ops.segment_max(x, ids, s),
                lambda: ops.segment_max_plain(x, ids, s)))

    b = largest(bucket_graphs(load_dataset(
        "drugbank", max_atoms=160).molecules)).to(dev)
    n = b.node_cap
    for w, feat, form in ((None, 128, ""), (b.edge_weight, 64, ":weighted")):
        xs = torch.randn(n, feat, device=dev, generator=gen)
        gs = torch.randn(n, feat, device=dev, generator=gen)
        fwd = (xs, b.edge_src, b.edge_dst, w, n)
        bwd = (gs, b.edge_src, b.edge_dst, w, n, b.edge_src_perm,
               b.edge_src_sorted)
        out.append((f"spmm_sorted_coo:f32{form}",
                    lambda fwd=fwd: ops.spmm_sorted_coo(*fwd),
                    lambda fwd=fwd: ops.spmm_sorted_coo_plain(*fwd)))
        out.append((f"spmm_sorted_coo_bwd:f32{form}",
                    lambda bwd=bwd: ops.spmm_sorted_coo_bwd(*bwd),
                    lambda bwd=bwd: ops.spmm_sorted_coo_bwd_plain(*bwd)))

    b = largest(bucket_graphs(load_dataset(
        "synthetic-large", num_drugs=16384).molecules)).to(dev)
    n = b.node_cap
    xb = torch.randn(n, 128, device=dev, generator=gen)
    gb = torch.randn(n, 128, device=dev, generator=gen)
    for w, tw, form in ((None, None, ""),
                        (b.edge_weight, b.edge_tweight, ":weighted")):
        fwd = (xb, b.edge_src, b.edge_dst, w, b.block_estarts, b.edge_tsrc,
               b.edge_tdst, tw, b.block_tstarts, n)
        bwd = (gb, b.edge_tsrc, b.edge_tdst, tw, b.block_tstarts, n)
        out.append((f"block_spmm:f32{form}",
                    lambda fwd=fwd: ops.block_spmm(*fwd),
                    lambda w=w: ops.block_spmm_plain(
                        xb, b.edge_src, b.edge_dst, w, num_nodes=n)))
        out.append((f"block_spmm_bwd:f32{form}",
                    lambda bwd=bwd: ops.block_spmm_bwd(*bwd),
                    lambda bwd=bwd: ops.block_spmm_plain(*bwd[:4],
                                                         num_nodes=n)))
    return out


def run_one(root: str) -> dict:
    """Time every form with the ``bignn_tpu_torch`` of ``root``."""
    sys.path.insert(0, root)
    import torch

    import bignn_tpu_torch
    from bignn_tpu_torch.ops import cuda_lib

    pkg = Path(bignn_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise SystemExit(f"imported {pkg}, not the package under {root}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    build_s = time.perf_counter() - t0
    sleep = sleep_ms()
    forms = {}
    with torch.no_grad():
        for name, kernel, plain in cases(dev):
            got, want = kernel(), plain()
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            if not err <= 1e-4 * scale:
                raise AssertionError(f"{name}: max_abs_err {err} off plain")
            ms = events_ms(kernel)
            dms, host = device_ms(kernel)
            if not host < sleep:
                raise AssertionError(f"{name}: the host took {host:.1f} ms "
                                     f"to queue, the sleep {sleep:.1f} ms")
            forms[name] = dict(ms=ms, device_ms=dms, host_ms=host,
                               max_abs_err=err)
    return dict(root=str(Path(root).resolve()), library=lib.name,
                build_s=build_s, sleep_ms=sleep, forms=forms)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    roots = sys.argv[1:]
    if not roots:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    for root in roots:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            raise SystemExit(f"{root}: exit {out.returncode}")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
