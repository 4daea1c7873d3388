"""Build and bind the port's CUDA kernels (``bignn_tpu_torch/csrc/*.cu``).

The sources have a plain C interface. At first use each is compiled with
``nvcc`` for Hopper (``sm_90a``), all at once in parallel, and the objects
are linked into one shared library under ``build/bignn_tpu_torch/`` at the
repository root, bound with ctypes. The library's file name carries a hash
of the sources, headers and flags, so an edited kernel is never served from
a stale build. Nothing here runs at import time: the CPU tests import every
module, and a machine without ``nvcc`` never builds.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0.
The exchange across processes and cards adds host entry points
(``_HOST_SIGNATURES``: its staging buffers' and signal areas' allocation,
CUDA IPC handles, mapped host memory, peer access, and its launch on
several cards at once), which take no stream argument of their own and
return the CUDA call's own error; :func:`call` raises on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bignn_tpu_torch"
SOURCES = ("segment_sum.cu", "block_adj.cu", "flash_gat.cu",
           "flash_gat_bwd.cu", "segment_softmax.cu", "spmm_multihead.cu",
           "spmm.cu", "block_spmm.cu", "segment_max.cu", "all_to_all.cu")
HEADERS = ("segment_bounds.cuh", "segment_walk.cuh", "elem.cuh",
           "tf32_mma.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F32 = ctypes.c_float
_SEGMENT_SUM = [_VP, _VP, _I32, _I32, _I32, _VP, _VP, _VP]
_SEGMENT_SUM_PERM = [_VP, _VP, _VP, _I32, _I32, _I32, _VP, _VP, _VP]
_BLOCK_ADJ = [_VP, _VP, _VP, _VP, _I32, _I32, _VP]
_SOFTMAX_FWD = [_VP, _VP, _I32, _I32, _I32, _VP, _VP, _VP]
_SOFTMAX_BWD = [_VP, _VP, _VP, _I32, _I32, _I32, _VP, _VP, _VP]
_MH_FWD = [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _VP, _VP, _VP]
_MH_BWD = [_VP, _VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _VP,
           _VP, _VP, _VP, _VP, _I64]
_SPMM = [_VP, _I32, _VP, _VP, _VP, _I32, _I32, _I32, _VP, _VP, _VP, _VP]
_SPMM_BWD = [_VP, _I32, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _VP, _VP, _VP,
             _VP]
_BLOCK_SPMM = [_VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _VP]
# data, ids, out, g, rows, F, segments, first, last, saved (0/1), d
_SEGMENT_MAX_BWD = [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _VP, _VP, _I32, _VP]
_SIGNATURES = {
    # name: argument types after which the stream follows
    "bignn_segment_sum_f32": _SEGMENT_SUM,
    "bignn_segment_sum_bf16": _SEGMENT_SUM,
    "bignn_segment_sum_perm_f32": _SEGMENT_SUM_PERM,
    "bignn_segment_sum_perm_bf16": _SEGMENT_SUM_PERM,
    "bignn_block_adj_f32": _BLOCK_ADJ,
    "bignn_block_adj_bf16": _BLOCK_ADJ,
    "bignn_block_adj_int8": _BLOCK_ADJ,
    "bignn_block_adj_int16": _BLOCK_ADJ,
    "bignn_flash_gat_fwd_f32": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _F32,
                                _VP, _VP],
    "bignn_flash_gat_bwd_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I32, _I32,
                                _I32, _F32, _VP, _VP, _VP, _VP, _I64],
    # n, heads, head_dim, where to write the scratch's float count (int64)
    "bignn_flash_gat_bwd_scratch_f32": [_I32, _I32, _I32, _VP],
    "bignn_segment_softmax_fwd_f32": _SOFTMAX_FWD,
    "bignn_segment_softmax_fwd_bf16": _SOFTMAX_FWD,
    "bignn_segment_softmax_bwd_f32": _SOFTMAX_BWD,
    "bignn_segment_softmax_bwd_bf16": _SOFTMAX_BWD,
    "bignn_segment_softmax_bwd_saved_f32": _SOFTMAX_BWD,
    "bignn_segment_softmax_bwd_saved_bf16": _SOFTMAX_BWD,
    "bignn_spmm_multihead_fwd_f32": _MH_FWD,
    "bignn_spmm_multihead_fwd_bf16": _MH_FWD,
    # edges, heads, head_dim, where to write the scratch's float count (int64)
    "bignn_spmm_multihead_bwd_scratch": [_I32, _I32, _I32, _VP],
    "bignn_spmm_multihead_bwd_f32": _MH_BWD,
    "bignn_spmm_multihead_bwd_bf16": _MH_BWD,
    # positions, F, where to write the scratch's bytes (int64)
    "bignn_spmm_scratch": [_I32, _I32, _VP],
    "bignn_spmm_f32": _SPMM,
    "bignn_spmm_bf16": _SPMM,
    "bignn_spmm_bwd_f32": _SPMM_BWD,
    "bignn_spmm_bwd_bf16": _SPMM_BWD,
    "bignn_block_spmm_f32": _BLOCK_SPMM,
    "bignn_block_spmm_bf16": _BLOCK_SPMM,
    "bignn_segment_max_f32": _SEGMENT_SUM,
    "bignn_segment_max_bf16": _SEGMENT_SUM,
    "bignn_segment_max_bwd_f32": _SEGMENT_MAX_BWD,
    "bignn_segment_max_bwd_bf16": _SEGMENT_MAX_BWD,
    # G send and j_count receive base pointers, G, j_begin, j_count, bytes
    # of a slot
    "bignn_all_to_all": [_VP, _VP, _I32, _I32, _I32, _I64],
    # the same past 32 shards: the device table of the pointers and the
    # destinations, G, j_count, bytes of a slot
    "bignn_all_to_all_table": [_VP, _I32, _I32, _I64],
}
# entry points that take no stream: the staging buffers and signal areas of
# the exchange across processes and cards (ops/collectives.py), mapped host
# memory, peer access between the cards of one process, and the exchange's
# launch on several cards at once, each on the stream it is given
_HOST_SIGNATURES = {
    # bytes, the leading bytes to zero (a signal area), where to write the
    # pointer
    "bignn_ipc_alloc": [_I64, _I64, _VP],
    "bignn_ipc_free": [_VP],
    "bignn_ipc_handle": [_VP, _VP],  # pointer, where to write 64 bytes
    "bignn_ipc_open": [_VP, _VP],  # 64 handle bytes, where to write
    "bignn_ipc_close": [_VP],
    # row 9 with the semaphores on the cards, one launch on each local card
    # on the streams it is given: send pointers by card, receive pointers,
    # G, each shard's card, bytes of a slot, signal areas by card, the card
    # count, local cards, their participant indices, CUDA devices and
    # streams, their error words, the limit in ns, and past 32 shards or
    # cards each local card's device table (else null)
    "bignn_all_to_all_sync": [_VP, _VP, _I32, _VP, _I64, _VP, _I32, _I32,
                              _VP, _VP, _VP, _VP, _I64, _VP],
    # bytes, where to write the host and the device pointer (mapped
    # page-locked memory: the exchange's error words)
    "bignn_host_alloc": [_I64, _VP, _VP],
    "bignn_host_free": [_VP],
    # the peer card that the current one may then read (ops/collectives.py
    # enable_peer_access)
    "bignn_enable_peer_access": [_I32],
}

# element type -> the suffix of its entry points and of its launch count
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int8: "int8", torch.int16: "int16"}


def dtype_name(dtype: torch.dtype) -> str:
    return DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def counter(fn):
    """Give a kernel wrapper its launch counts: ``fn.launches`` (all
    launches) and ``fn.launches_by_dtype`` (per form: the element type's
    suffix, and ``:weighted`` after it for the weighted form of an SpMM);
    returns ``fn``."""
    fn.launches = 0
    fn.launches_by_dtype = {}
    return fn


def count(fn, dtype: torch.dtype, weighted: bool = False,
          suffix: str = "") -> None:
    """One launch of ``fn``'s kernel on ``dtype`` data (``weighted``: its
    weighted form; ``suffix`` names another form, e.g. ``:procs``)."""
    fn.launches += 1
    key = dtype_name(dtype) + (":weighted" if weighted else "") + suffix
    fn.launches_by_dtype[key] = fn.launches_by_dtype.get(key, 0) + 1


def require_float(t: torch.Tensor, name: str, op: str) -> str:
    """The entry-point suffix for ``t``'s type; raises for a type the
    kernels of ``op`` do not take (float32 and bf16)."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"{op} kernels take float32 or bfloat16 {name}, got {t.dtype}")
    return DTYPE_NAMES[t.dtype]


_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home}/bin or on PATH; the CUDA "
            "kernels of bignn_tpu_torch need the CUDA toolkit to build")
    return found


def build() -> Path:
    """Compile the kernels unless this version is already built; returns
    the library's path.

    One ``nvcc -c`` per source, all started together, then one link.
    nvcc's report (registers, shared memory and spills of each kernel, from
    ``-Xptxas -v``) is kept beside the library as ``<name>.log``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libbignn_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(name).stem}_{tag}.o" for name in SOURCES]
    logs = [obj.with_suffix(".log") for obj in objs]
    procs = []
    for name, obj, log in zip(SOURCES, objs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                stdout=f, stderr=subprocess.STDOUT))
    failed = [name for name, p in zip(SOURCES, procs) if p.wait() != 0]
    report = "".join(log.read_text() for log in logs)
    for log in logs:
        log.unlink()
    if failed:
        for obj in objs:
            obj.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{report}")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True, check=False)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{proc.stdout}"
            f"{proc.stderr}")
    out.with_suffix(".log").write_text(report)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [*argtypes, _VP]
            fn.restype = _I32
        for name, argtypes in _HOST_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I32
        lib.bignn_error_string.argtypes = [_I32]
        lib.bignn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; raise if the
    launch was refused."""
    lib = library()
    for arg, argtype in zip(args, _SIGNATURES[name]):
        if argtype is _I32 and not -2**31 <= arg < 2**31:
            raise ValueError(f"{name}: {arg} does not fit the kernel's int")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA error {rc} ({lib.bignn_error_string(rc).decode()})")


def call(name: str, device: torch.device, *args) -> None:
    """Call host entry point ``name`` (``_HOST_SIGNATURES``) with
    ``device`` current; raise if it returns an error."""
    lib = library()
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA error {rc} ({lib.bignn_error_string(rc).decode()})")


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of ``dtype`` and
    rank ``ndim`` on ``device``."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
