"""Build each mutant of the wide kernels in a copy outside the checkout and
run the card tests of the wide cases there: every mutant must fail them.

    python3 scripts/check_wide_mutants.py OUT_DIR

Each mutant is a copy of ``bignn_tpu_torch/`` and ``tests/`` in a new
directory of its own under the temporary directory (``TMPDIR``), with one
line of a kernel source replaced; the run removes only the directories it
made. Each log goes to OUT_DIR. Exits non-zero when a mutant passes.
"""
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MUTANTS = {
    # every column past a multi-head row's first strip left at zero
    "mh_strips_zero": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                       "o[w] = bignn::pack_word<T, NV, W>(acc[k]);",
                       "o[w] = kStrip && sp.col0 > 0 ? W{}"
                       " : bignn::pack_word<T, NV, W>(acc[k]);",
                       "wide_mh_f32 or wide_mh_bf16"),
    # row 8's d_alpha from a wide head's first strip alone
    "mh_dalpha_first_strip": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                              "for (int p = 1; p < strips; ++p)",
                              "for (int p = 1; p < 1; ++p)",
                              "wide_mh_bwd"),
    # row 3b's g . v over a wide head's first strip alone
    "flash_dot_first_strip": ("bignn_tpu_torch/csrc/flash_gat_bwd.cu",
                              "for (int q = 0; q < strips; ++q) {",
                              "for (int q = 0; q < 1; ++q) {",
                              "wide_flash_bwd"),
}


def main() -> int:
    out = Path(sys.argv[1])
    out.mkdir(parents=True, exist_ok=True)
    ok = True
    for name, (src, old, new, tests) in MUTANTS.items():
        copy = Path(tempfile.mkdtemp(prefix=f"mutant_{name}_"))
        try:
            for part in ("bignn_tpu_torch", "tests"):
                shutil.copytree(ROOT / part, copy / part,
                                ignore=shutil.ignore_patterns("__pycache__"))
            path = copy / src
            text = path.read_text()
            assert text.count(old) == 1, (name, text.count(old))
            path.write_text(text.replace(old, new))
            proc = subprocess.run(
                [sys.executable, "-m", "pytest", "--noconftest", "-m", "gpu",
                 "tests/test_torch_kernels.py", "-q", "-p",
                 "no:cacheprovider", "-k",
                 f"test_sparse_kernel_matches_plain_on_card and ({tests})"],
                cwd=copy, capture_output=True, text=True, timeout=900)
        finally:
            shutil.rmtree(copy, ignore_errors=True)
        (out / f"{name}.log").write_text(proc.stdout + proc.stderr)
        last = [ln for ln in proc.stdout.splitlines() if ln.strip()][-1:]
        failed = proc.returncode != 0 and "failed" in " ".join(last)
        print(f"mutant {name}: rc {proc.returncode}, {' '.join(last)}; "
              f"{'caught' if failed else 'NOT CAUGHT'}")
        ok &= failed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
