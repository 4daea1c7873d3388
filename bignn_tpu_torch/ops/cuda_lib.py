"""Build and bind the port's CUDA kernels (``bignn_tpu_torch/csrc/*.cu``).

The sources have a plain C interface. At first use they are compiled with
``nvcc`` for Hopper (``sm_90a``) into one shared library under
``build/bignn_tpu_torch/`` at the repository root, and bound with ctypes.
The library's file name carries a hash of the sources and flags, so an edited
kernel is never served from a stale build. Nothing here runs at import time:
the CPU tests import every module, and a machine without ``nvcc`` never
builds.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0.
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
SOURCES = ("segment_sum.cu", "block_adj.cu", "flash_gat.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: argument types after which the stream follows
    "bignn_segment_sum_f32": [_VP, _VP, _I32, _I32, _I32, _VP, _VP, _VP],
    "bignn_block_adj_f32": [_VP, _VP, _VP, _VP, _I32, _I32, _VP],
    "bignn_flash_gat_fwd_f32": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _F32,
                                _VP, _VP],
}

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

    nvcc's report (registers, shared memory and spills of each kernel, from
    ``-Xptxas -v``) is kept beside the library as ``<name>.log``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libbignn_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
