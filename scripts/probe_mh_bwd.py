"""Time variants of the multi-head SpMM backward (``csrc/spmm_multihead.cu``,
``mh_backward``) on one card: rows in flight a lane, blocks an SM holds at
least, and warps a block.

    python3 scripts/probe_mh_bwd.py U:MB:W [U:MB:W ...]

Each variant is the checkout's source with ``kRowsInFlight = U``,
``kBwdMinBlocks = MB`` and ``kBwdWarps = W``, built alone with ``nvcc``
(the flags of ``ops/cuda_lib.py``) into ``build/probe_mh/`` and bound by
ctypes. The inputs are those of ``scripts/compare_kernel_trees.py``
(``build/compare_inputs.pt``, built as that script builds it when it is
missing): the 16,384-drug outer graph (f32), shard 0 of path H's plan
(f32) and config4's sampled outer graph (bf16), H 4, D 32. Each variant's
result is held against the plain backward (f32 within 1e-4, bf16 within
1e-2, of max(1, max |plain|)) and timed as that script times a form
(``device_ms``: 100 calls queued behind a device sleep). Prints the card,
then one JSON line per variant.
"""

from __future__ import annotations

import ctypes
import json
import re
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
from bignn_tpu_torch.ops import cuda_lib  # noqa: E402

CONSTANTS = ("kRowsInFlight", "kBwdMinBlocks", "kBwdWarps")


def build_variant(values: tuple[int, int, int]) -> ctypes.CDLL:
    tag = "_".join(map(str, values))
    out = ROOT / "build" / "probe_mh" / tag
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(cuda_lib.CSRC, out / "csrc")
    src = out / "csrc" / "spmm_multihead.cu"
    text = src.read_text()
    for name, value in zip(CONSTANTS, values):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"{name} not found once in {src}")
    src.write_text(text)
    lib = out / "libprobe.so"
    proc = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(src)], capture_output=True, text=True, check=False)
    regs = re.findall(r"mh_backward.*?Used (\d+) registers", proc.stdout
                      + proc.stderr, flags=re.S)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    cdll = ctypes.CDLL(str(lib))
    for name in ("bignn_spmm_multihead_bwd_f32",
                 "bignn_spmm_multihead_bwd_bf16"):
        fn = getattr(cdll, name)
        fn.argtypes = [*cuda_lib._SIGNATURES[name], ctypes.c_void_p]
        fn.restype = ctypes.c_int
    cdll.registers = regs
    return cdll


def call(lib, v, src, dst, alpha, n_out, g, perm, ssorted):
    n, heads, head_dim = v.shape
    d_v = torch.empty_like(v)
    d_alpha = torch.zeros_like(alpha)
    first = torch.empty(n, dtype=torch.int32, device=v.device)
    last = torch.empty(n, dtype=torch.int32, device=v.device)
    name = "bignn_spmm_multihead_bwd_" + cuda_lib.dtype_name(v.dtype)
    rc = getattr(lib, name)(
        v.data_ptr(), g.data_ptr(), dst.data_ptr(), alpha.data_ptr(),
        perm.data_ptr(), ssorted.data_ptr(), src.shape[0], n, n_out, heads,
        head_dim, first.data_ptr(), last.data_ptr(), d_v.data_ptr(),
        d_alpha.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return d_v, d_alpha


def inputs(dev):
    inp = torch.load(ckt.INPUTS)
    out = []
    for tag, key, n_src, n_out, dtype in (
            ("f32", "outer", "n", "n", torch.float32),
            ("f32:shard", "shard", "n_src", "n_out", torch.float32),
            ("bf16", "config4", "n", "n", torch.bfloat16)):
        o = {k: v.to(dev) if torch.is_tensor(v) else v
             for k, v in inp[key].items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        alpha = ops.segment_softmax_plain(3 * torch.randn(
            len(o["dst"]), 4, device=dev, generator=gen), o["dst"],
            o[n_out]).to(dtype)
        v = torch.randn(o[n_src], 4, 32, device=dev, generator=gen).to(dtype)
        g = torch.randn(o[n_out], 4, 32, device=dev, generator=gen).to(dtype)
        out.append((tag, (v, o["src"], o["dst"], alpha, o[n_out], g,
                          o["perm"], o["ssorted"])))
    return out


def main() -> int:
    variants = [tuple(int(x) for x in a.split(":")) for a in sys.argv[1:]]
    if not variants or any(len(v) != 3 for v in variants):
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    if not ckt.INPUTS.exists():
        ckt.build_inputs(str(ROOT), ckt.INPUTS)
    sleep = ckt.sleep_ms()
    cases = inputs(dev)
    with torch.no_grad():
        plain = {tag: ops.spmm_multihead_bwd_plain(*args)
                 for tag, args in cases}
        for values in variants:
            lib = build_variant(values)
            row = dict(zip(CONSTANTS, values), registers=lib.registers)
            for tag, args in cases:
                tol = ckt.BF16_TOL if "bf16" in tag else ckt.F32_TOL
                for a, b in zip(call(lib, *args), plain[tag]):
                    err = (a.float() - b.float()).abs().max().item()
                    if not err <= tol * max(1.0, b.float().abs().max().item()):
                        raise AssertionError(f"{values} {tag}: {err}")
                dms, host, slept = ckt.device_ms(
                    lambda a=args: call(lib, *a), sleep, ckt.DEVICE_REPS)
                row[tag] = dms if host < slept else None
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
