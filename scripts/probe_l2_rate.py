"""Measure the card's L2 read rate for row gathers: the rate at which
warps can read rows picked at random from a table that L2 holds, as row 8
(the multi-head SpMM) gathers v or g rows by edge.

    python3 scripts/probe_l2_rate.py [OUT_JSON]

A small kernel (written here, built with ``nvcc`` for ``sm_90a`` into
``build/probe_l2/``, bound by ctypes) reads ``reads`` rows of a table of
``rows`` x ``row_bytes``, the row ids drawn at random on the card: each
warp takes rows in turn, each lane one 16-byte word of the row (a row of
more than 512 bytes takes up to 4 words a lane), 4 rows in flight a lane
group, and folds what it reads into one word a thread that it writes at
the end (so the reads cannot be dropped and the writes are negligible).
Timed by CUDA events over 20 launches after 3 warm-ups, for tables of 8
and 32 MB (both inside the H100's 50 MB L2) and rows of 256, 512, 1,536
and 2,048 bytes (row 8's f32 H 4 D 32, f32 H 4 D 128, bf16 H 32 D 24, bf16
H 4 D 256), against a table of 1 GB (device memory) for comparison. The
ids themselves (4 bytes a row read) are counted as read too. Prints the
card and one JSON line; ``l2_bytes_per_s`` is the highest rate seen from
an L2-resident table, the rate ``chip_smoke.bound_ms`` takes for gathered
rows.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe_l2"

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

// Each group of G = min(32, row_words) lanes reads whole rows (word c, c +
// G, ... of the row), 4 rows in flight, rows of the warp's share of ids.
__global__ void __launch_bounds__(256) gather_rows(
    const uint4* __restrict__ table, const int* __restrict__ ids,
    long long reads, int row_words, int lg, unsigned* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int G = 1 << lg;
  const int q = lane >> lg, c = lane & (G - 1);
  const int slots = 32 >> lg;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  const long long w = blockIdx.x * static_cast<long long>(blockDim.x / 32) +
                      threadIdx.x / 32;
  unsigned acc = 0;
  for (long long r0 = w * slots * 4; r0 < reads; r0 += warps * slots * 4) {
    uint4 v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long r = r0 + q + slots * u;
      const int id = r < reads ? __ldg(ids + r) : -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int word = c + k * G;
        v[u][k] = id >= 0 && word < row_words
                      ? __ldg(table + static_cast<long long>(id) * row_words +
                              word)
                      : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc ^= v[u][k].x ^ v[u][k].y ^ v[u][k].z ^ v[u][k].w;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int probe_gather(const void* table, const void* ids,
                            long long reads, int row_words, int lg,
                            void* out, int blocks, void* stream) {
  gather_rows<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(ids), reads,
      row_words, lg, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

BLOCKS = 132 * 8
READS = 1 << 22


def build() -> ctypes.CDLL:
    from bignn_tpu_torch.ops import cuda_lib

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "gather.cu", OUT / "libgather.so"
    src.write_text(SOURCE)
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.probe_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return cdll


def rate(cdll, table_bytes: int, row_bytes: int) -> float:
    """Bytes a second read: the gathered rows and their ids."""
    dev = torch.device("cuda")
    words = row_bytes // 16
    rows = table_bytes // row_bytes
    table = torch.randint(0, 2**31 - 1, (rows * words * 4,), device=dev,
                          dtype=torch.int32)
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, rows, (READS,), device=dev, generator=gen,
                        dtype=torch.int32)
    out = torch.empty(BLOCKS * 256, device=dev, dtype=torch.int32)
    lg = max(0, (min(words, 32) - 1).bit_length())
    if words > 4 << lg:
        raise ValueError(f"rows of {row_bytes} bytes need more than 4 words "
                         "a lane")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = cdll.probe_gather(table.data_ptr(), ids.data_ptr(), READS, words,
                               lg, out.data_ptr(), BLOCKS, stream)
        if rc:
            raise RuntimeError(f"probe_gather: CUDA error {rc}")

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 20
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    secs = start.elapsed_time(end) / reps / 1e3
    return READS * (row_bytes + 4) / secs


def main() -> int:
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    cdll = build()
    rates = {}
    for table in (8 << 20, 32 << 20, 1 << 30):
        for row in (256, 512, 1536, 2048):
            rates[f"table {table >> 20} MB, rows {row} B"] = rate(cdll, table,
                                                                  row)
    l2 = max(v for k, v in rates.items() if not k.startswith("table 1024"))
    result = {"card": card, "l2_bytes_per_s": l2, "rates": rates}
    print(json.dumps(result), flush=True)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
