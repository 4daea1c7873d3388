"""Time variants of the bf16 tensor-core block-local SpMM
(``csrc/block_spmm.cu``, ``block_spmm_tc``) on one card, to see which
phase holds it.

    python3 scripts/probe_block_spmm_tc.py NAME [NAME ...]

A variant is the checkout's source with some lines taken out (see
``VARIANTS``): ``base`` keeps all; ``nomma`` drops the block products,
``nocount`` the counts (A_b stays as it is, every slab multiplied), ``nostore`` the stores of y;
``allslabs`` multiplies every 16-source slab, those without a count too;
``f128`` fixes F at 128 in the kernel, so that its index arithmetic takes
shifts, not divisions; ``twocta`` compiles for 2 CTAs an SM, not 3. Each is built alone with ``nvcc`` (the flags of ``ops/cuda_lib.py``) into
``build/probe_block/`` and bound by ctypes, then timed on the largest
bucket of synthetic-large cut to 16,384 drugs (301,312 rows), F 128, as
``scripts/compare_kernel_trees.py`` times a form (``device_ms``, 100 calls
queued behind a device sleep). Only ``base`` is held against the plain
version (within 1e-2 of max(1, max |plain|)): the others compute something
else. Prints the card, then one JSON line per variant with the CTAs an SM
holds at once.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import compare_kernel_trees as ckt  # noqa: E402
from bignn_tpu_torch import ops  # noqa: E402
from bignn_tpu_torch.data import load_dataset  # noqa: E402
from bignn_tpu_torch.ops import cuda_lib  # noqa: E402
from bignn_tpu_torch.sparse import bucket_graphs  # noqa: E402

VARIANTS = {
    "base": [],
    "nomma": [("block_products(a, xsm, xs, c0, nc, warp, lane, slabs, acc);",
               "")],
    "nocount": [("  build_fast();\n", "  if (tid == 0) {\n    over = 0;\n"
                 "    slabs = ~0u;\n  }\n  __syncthreads();\n")],
    "nostore": [("""          *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(r) * feat +
                                    8 * w) =
              *reinterpret_cast<const uint4*>(st + r * xs + 8 * w);""",
                 "")],
    "allslabs": [("if (((band >> (k0 / 16)) & 1u) == 0) continue;", "")],
    "f128": [("const int fp = padded_feat(feat);",
              "feat = 128;\n  const int fp = 128;")],
    "twocta": [("__launch_bounds__(kTcThreads, 3)",
                "__launch_bounds__(kTcThreads, 2)")],
}
PROBE_EXPORT = """
extern "C" int bignn_probe_ctas(int feat) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, block_spmm_tc<8>,
                                                kTcThreads,
                                                tc_smem_bytes(feat));
  return n;
}
"""


def build_variant(name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "probe_block" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(cuda_lib.CSRC, out / "csrc")
    src = out / "csrc" / "block_spmm.cu"
    text = src.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in {src}")
        text = text.replace(old, new)
    src.write_text(text + PROBE_EXPORT)
    lib = out / "libprobe.so"
    proc = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(src)], capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    cdll = ctypes.CDLL(str(lib))
    cdll.bignn_block_spmm_bf16.argtypes = [
        *cuda_lib._SIGNATURES["bignn_block_spmm_bf16"], ctypes.c_void_p]
    cdll.bignn_block_spmm_bf16.restype = ctypes.c_int
    cdll.bignn_probe_ctas.argtypes = [ctypes.c_int]
    cdll.bignn_probe_ctas.restype = ctypes.c_int
    return cdll


def main() -> int:
    names = sys.argv[1:]
    if not names or any(n not in VARIANTS for n in names):
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    b = ckt.largest(bucket_graphs(load_dataset(
        "synthetic-large", num_drugs=16384).molecules)).to(dev)
    n = b.node_cap
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, 128, device=dev, generator=gen).to(torch.bfloat16)
    plain = ops.block_spmm_plain(x, b.edge_src, b.edge_dst, None,
                                 num_nodes=n)
    sleep = ckt.sleep_ms()
    for name in names:
        lib = build_variant(name)
        y = torch.empty_like(x)

        def call():
            rc = lib.bignn_block_spmm_bf16(
                x.data_ptr(), b.edge_src.data_ptr(), b.edge_dst.data_ptr(),
                None, b.block_estarts.data_ptr(), b.edge_src.shape[0],
                n // 128, 128, y.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        row = dict(variant=name, ctas=lib.bignn_probe_ctas(128))
        if name == "base":
            err = (y.float() - plain.float()).abs().max().item()
            if not err <= ckt.BF16_TOL * max(1.0, plain.float().abs().max()
                                             .item()):
                raise AssertionError(f"base: max_abs_err {err}")
            row["max_abs_err"] = err
        dms, host, slept = ckt.device_ms(call, sleep, ckt.DEVICE_REPS)
        row["device_ms"] = dms if host < slept else None
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
