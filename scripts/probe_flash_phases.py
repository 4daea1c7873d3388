"""Time the flash-GAT pair's wide forms with one phase taken out at a time,
on one card, to see which phase holds them.

    python3 scripts/probe_flash_phases.py

A variant is the checkout's ``csrc/flash_gat.cu`` (``fwd_*``) or
``csrc/flash_gat_bwd.cu`` (``bwd_*``) with some lines replaced (``FWD``,
``BWD``): ``base`` keeps all; the forward's ``no_rowmax`` takes m as 0 in
place of the row-max pass, ``no_mma`` folds the fragments into the sums in
place of the products, ``no_exp`` takes p = cnt e, ``one_mma`` keeps the
hi x hi product of 3xTF32 alone; the backward's ``no_dot`` drops g v^T,
``no_dv`` alpha^T g's products, ``no_exp`` the exp, ``no_cnt`` the mask's
loads (cnt 1), ``one_mma`` the two smaller products of both. Each is built
alone with ``nvcc`` (the flags of ``ops/cuda_lib.py``; all the builds
started together) into ``build/phase/`` and bound by ctypes, then timed at
``scripts/probe_variants.py``'s flash shapes (config2's dense outer mask,
N 1,704: H 4, D 32; H 8, D 64; H 4, D 256; H 8, D 128) as
``scripts/compare_kernel_trees.py`` times a form (``device_ms``, 100 calls
queued behind a device sleep), with a digest of each result's bits. The
variants compute something else: nothing is held against the plain
version. Prints one JSON line per variant.
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
import probe_variants as pv  # noqa: E402
from bignn_tpu_torch.ops import cuda_lib  # noqa: E402


def last(old: str, new: str):
    """An edit: the last ``old`` of the source becomes ``new``."""
    def edit(text: str) -> str:
        i = text.rindex(old)
        return text[:i] + new + text[i + len(old):]
    return edit


def once(old: str, new: str):
    """An edit: the one ``old`` of the source becomes ``new``."""
    def edit(text: str) -> str:
        assert text.count(old) == 1, old
        return text.replace(old, new)
    return edit


FWD = {
    "base": [],
    "no_rowmax": [once(
        "row_bounds<kWideInFlight>(d, in, h, vec_cnt, lane, mx, mn);",
        "mx[0] = 0.f; mn[0] = 0.f;")],
    "no_mma": [once(
        "bignn::mma_3xtf32(acc[mt][t], a_hi[mt], a_lo[mt], b_hi, b_lo);",
        "acc[mt][t][0] += __uint_as_float(a_hi[mt][0] ^ b_hi[0] ^ "
        "a_lo[mt][1] ^ b_lo[1]);")],
    "no_exp": [once("const float p = w > 0.f ? w * expf(e - m[i]) : 0.f;",
                    "const float p = w * e;")],
    "one_mma": [once(
        "bignn::mma_3xtf32(acc[mt][t], a_hi[mt], a_lo[mt], b_hi, b_lo);",
        "bignn::mma_tf32(acc[mt][t], a_hi[mt], b_hi);")],
}
BWD = {
    "base": [],
    "no_dot": [once(
        "      wide_dot<kDP>(sm.g[buf], sm.v, dr, sc, gid, tig, dot);\n"
        "    } else {", "    } else {")],
    "no_dv": [last("mma_3xtf32(dv_acc[t], a_hi, a_lo, b_hi, b_lo);",
                   "dv_acc[t][0] += __uint_as_float(b_hi[0] ^ b_lo[1] ^ "
                   "a_hi[t & 3]);")],
    "no_exp": [last(
        "const float a = cnt[i][j] * expf(fminf(e - lse[i], 0.f));",
        "const float a = cnt[i][j] * (e - lse[i]);")],
    "no_cnt": [last(
        "? __ldg(in.cnt + static_cast<int64_t>(d) * n + s) : 0.f;",
        "? 1.f : 0.f;")],
    "one_mma": [last("mma_3xtf32(dv_acc[t], a_hi, a_lo, b_hi, b_lo);",
                     "bignn::mma_tf32(dv_acc[t], a_hi, b_hi);"),
                last("      mma_3xtf32(dot[t], a_hi, a_lo, b_hi, b_lo);",
                     "      bignn::mma_tf32(dot[t], a_hi, b_hi);")],
}


def build(tag: str, source: str, edits):
    """Write the variant's source and start its build; returns the build's
    process and the library it makes."""
    out = ROOT / "build" / "phase" / tag
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(cuda_lib.CSRC, out / "csrc")
    src = out / "csrc" / source
    text = src.read_text()
    for edit in edits:
        text = edit(text)
    src.write_text(text)
    lib = out / "lib.so"
    proc = subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, lib


def main() -> int:
    jobs = ([("fwd_" + k, "flash_gat.cu", v, "fgf") for k, v in FWD.items()]
            + [("bwd_" + k, "flash_gat_bwd.cu", v, "fgb")
               for k, v in BWD.items()])
    builds = [build(tag, src, edits) for tag, src, edits, _ in jobs]
    sleep = ckt.sleep_ms()
    with torch.no_grad():
        graphs = {"outer": {"dst": torch.zeros(1, device="cuda")}}
        cases = {"fgf": pv.fgf_cases(graphs), "fgb": pv.fgb_cases(graphs)}
        for (tag, _, _, kind), (proc, lib) in zip(jobs, builds):
            report, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{tag}: build failed\n{report}")
            k = pv.KINDS[kind]
            cdll = ctypes.CDLL(str(lib))
            entries = {}
            for t in k.types:
                fn = getattr(cdll, k.entry + t)
                fn.argtypes = [*cuda_lib._SIGNATURES[k.entry + t],
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
                entries[t.removesuffix("_f32") if t != "f32" else t] = fn
            row = {"tag": tag}
            for ctag, args, _ in cases[kind]:
                def run(args=args):
                    rc, got = k.call(entries, "f32", *args)
                    if rc:
                        raise RuntimeError(f"{tag} {ctag}: CUDA error {rc}")
                    return got

                row[ctag + ":digest"] = ckt.digest(run())
                dms, host, slept = ckt.device_ms(run, sleep, ckt.DEVICE_REPS)
                row[ctag] = dms if host < slept else None
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
