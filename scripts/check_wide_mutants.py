"""Build each mutant of the wide kernels (and of row 9's table past 32
shards) in a copy outside the checkout and run the card tests of its cases
there: every mutant must fail them.

    python3 scripts/check_wide_mutants.py OUT_DIR [NAME ...]

Each mutant is a copy of ``bignn_tpu_torch/`` and ``tests/`` in a new
directory of its own under the temporary directory (``TMPDIR``), with one
line of a kernel source replaced; the run removes only the directories it
made. Each log goes to OUT_DIR. NAMEs pick mutants (all by default).
Exits non-zero when a mutant passes.
"""
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the card tests of the wide cases, narrowed by -k to the given cases
WIDE = "test_sparse_kernel_matches_plain_on_card and ({})"
MUTANTS = {
    # every column past a multi-head row's first strip left at zero
    "mh_strips_zero": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                       "o[w] = bignn::pack_word<T, NV, W>(acc[k]);",
                       "o[w] = kStrip && sp.col0 > 0 ? W{}"
                       " : bignn::pack_word<T, NV, W>(acc[k]);",
                       WIDE.format("wide_mh_f32 or wide_mh_bf16")),
    # row 8's d_alpha from a wide head's first strip alone
    "mh_dalpha_first_strip": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                              "for (int p = 1; p < strips; ++p)",
                              "for (int p = 1; p < 1; ++p)",
                              WIDE.format("wide_mh_bwd")),
    # row 3b's g . v over a wide head's first strip alone
    "flash_dot_first_strip": ("bignn_tpu_torch/csrc/flash_gat_bwd.cu",
                              "for (int q = 0; q < strips; ++q) {",
                              "for (int q = 0; q < 1; ++q) {",
                              WIDE.format("wide_flash_bwd")),
    # row 3's wide form: a block's row tiles past the first left unwritten
    "flash_fwd_rows_first_tile": ("bignn_tpu_torch/csrc/flash_gat.cu",
                                  "if (d >= n) continue;\n"
                                  "      const float s = fmaxf(sm.l[r], kFloor);",
                                  "if (d >= n || r >= 16) continue;\n"
                                  "      const float s = fmaxf(sm.l[r], kFloor);",
                                  WIDE.format("wide_flash_d or wide_flash_n")),
    # row 3's wide form: a strip past the first multiplies p by the first
    # strip's features of v
    "flash_fwd_strip_first_v": ("bignn_tpu_torch/csrc/flash_gat.cu",
                                "const float* vh = in.v + h * in.head_dim + c0;",
                                "const float* vh = in.v + h * in.head_dim;",
                                WIDE.format("wide_flash_d or wide_flash_n")),
    # row 3's wide form: a row's sum l over its 32 source lanes added over
    # 16 of them
    "flash_fwd_l_half_lanes": ("bignn_tpu_torch/csrc/flash_gat.cu",
                               "for (int o = 16; o > 0; o >>= 1) x += "
                               "__shfl_xor_sync",
                               "for (int o = 8; o > 0; o >>= 1) x += "
                               "__shfl_xor_sync",
                               WIDE.format("wide_flash_d or wide_flash_n")),
    # row 3b: the first part's dv dropped from the parts' sum (the wide
    # sweep's parts, where it has more than one)
    "flash_bwd_dv_part_dropped": ("bignn_tpu_torch/csrc/flash_gat_bwd.cu",
                                  "for (int k = 0; k < splits; ++k) a += "
                                  "dv_part[k * nhd + i];",
                                  "for (int k = 1; k < splits; ++k) a += "
                                  "dv_part[k * nhd + i];",
                                  WIDE.format("wide_flash_bwd")),
    # row 8's backward strips: a padded lane group's first idle lane takes
    # the next head's first word (into this head's dot and d_v)
    "mh_pad_lane_reads": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                          "wk[k] = hl < sp.nh && wi < sp.hw ? hl * sp.hw + wi"
                          " : -1;",
                          "wk[k] = hl < sp.nh && wi <= sp.hw ? hl * sp.hw + wi"
                          " : -1;",
                          WIDE.format("wide_mh_bwd")),
    # row 6's tiled form: A_b, counted once, multiplied into the first
    # tile of columns alone (the later tiles left at zero)
    "block_first_tile_only": ("bignn_tpu_torch/csrc/block_spmm.cu",
                              "if (!exact)\n          block_products(a, cur,",
                              "if (!exact && t == 0)\n          "
                              "block_products(a, cur,",
                              WIDE.format("wide_block_spmm")),
    # row 9's pointer table past 32 shards read as if cut at 32
    "a2a_table_cut_32": ("bignn_tpu_torch/csrc/all_to_all.cu",
                         "return reinterpret_cast<const unsigned char*>(t[i]);",
                         "return reinterpret_cast<const unsigned char*>("
                         "t[i & 31]);",
                         "test_all_to_all_refuses_on_card"),
}


def main() -> int:
    out = Path(sys.argv[1])
    out.mkdir(parents=True, exist_ok=True)
    ok = True
    for name in sys.argv[2:] or MUTANTS:
        src, old, new, select = MUTANTS[name]
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
                 "no:cacheprovider", "-k", select],
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
