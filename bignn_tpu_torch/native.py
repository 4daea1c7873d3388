"""ctypes binding to the native host-side graph construction code
(``native/graphbuild.cpp`` at the repository root; counterpart of
``bignn_tpu/native``).

Both packages load the same ``native/libbignn_native.so``: greedy block
packing in the library and in the NumPy fallback give different layouts, so
two packages on two libraries would lay the same molecules out differently.
The library is built with ``g++`` when it is missing; every entry point has
a NumPy fallback for a machine without a toolchain.
"""

from __future__ import annotations

import ctypes
import subprocess
import warnings
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
LIB_PATH = NATIVE_DIR / "libbignn_native.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not LIB_PATH.exists():
        src = NATIVE_DIR / "graphbuild.cpp"
        if not src.exists():
            return None
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-o", str(LIB_PATH),
                 str(src)],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError) as e:
            warnings.warn(f"native build failed ({e}); using NumPy fallback")
            return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError as e:
        warnings.warn(f"native load failed ({e}); using NumPy fallback")
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.build_sorted_graph.restype = ctypes.c_int64
    lib.build_sorted_graph.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, f32p,
    ]
    lib.greedy_pack_blocks.restype = ctypes.c_int64
    lib.greedy_pack_blocks.argtypes = [
        ctypes.c_int64, i32p, ctypes.c_int32, i32p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_sorted_graph(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    add_self_loops: bool = True,
    normalize: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Destination-sorted edges (+ self-loops) with GCN weights.

    Native: one counting sort, O(E + N). Fallback: ``gcn_normalize`` and a
    stable NumPy sort. Both sort by dst; the order within a destination row
    may differ."""
    lib = _load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if lib is None:
        from bignn_tpu_torch.sparse import formats

        if normalize:
            s, d, w = formats.gcn_normalize(src, dst, num_nodes,
                                            add_self_loops)
        else:
            if add_self_loops:
                loop = np.arange(num_nodes, dtype=np.int64)
                s = np.concatenate([src, loop])
                d = np.concatenate([dst, loop])
            else:
                s, d = src, dst
            w = np.ones(s.shape[0], np.float32)
        order = np.argsort(d, kind="stable")
        return s[order].astype(np.int32), d[order].astype(np.int32), w[order]

    n_out = len(src) + (num_nodes if add_self_loops else 0)
    out_src = np.empty(n_out, np.int32)
    out_dst = np.empty(n_out, np.int32)
    out_w = np.empty(n_out, np.float32)
    r = lib.build_sorted_graph(
        num_nodes, len(src), src, dst,
        int(add_self_loops), int(normalize), out_src, out_dst, out_w,
    )
    if r < 0:
        raise ValueError("edge endpoints out of range")
    return out_src, out_dst, out_w


def greedy_pack_blocks(
    sizes: np.ndarray, block_rows: int = 128
) -> tuple[np.ndarray, int]:
    """Greedy first-fit packing of items into ``block_rows``-row blocks (no
    item straddles a boundary). Returns (offsets [n] int32, extent rows).

    Native: one O(n) pass. Fallback: fixed-stride packing,
    ``block_rows // max_size`` items per block, which keeps the layout
    contract with a larger extent."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    n = len(sizes)
    lib = _load()
    if lib is not None:
        off = np.empty(n, np.int32)
        extent = int(lib.greedy_pack_blocks(n, sizes, block_rows, off))
        if extent >= 0:
            return off, extent
    mx = int(sizes.max()) if n else 1
    if mx > block_rows:
        raise ValueError(f"item size {mx} > block_rows {block_rows}")
    per = max(block_rows // max(mx, 1), 1)
    blk, lane = np.arange(n) // per, np.arange(n) % per
    nb = int(blk[-1]) + 1 if n else 0
    within = np.zeros((nb, per), np.int64)
    within[blk, lane] = sizes
    within = np.cumsum(within, axis=1) - within
    off = (blk * block_rows + within[blk, lane]).astype(np.int32)
    extent = int(off[-1] + sizes[-1]) if n else 0
    return off, extent
