"""Measure the tensor cores' rate through mma.sync on one card: the
ceiling of the flash-GAT pair's 3xTF32 products (three m16n8k8 TF32
products a k-step), beside bf16's m16n8k16.

    python3 scripts/probe_mma_rate.py

Writes a small CUDA source under ``build/probe_mma/``, builds it with
``nvcc`` (the target of ``ops/cuda_lib.py``) and runs it: blocks of W warps,
B blocks an SM, each warp C independent accumulator chains of 4,096
products on register operands. Prints the card and a line a shape with its
TFLOP/s (2 m n k operations a product), by CUDA events.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bignn_tpu_torch.ops import cuda_lib  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2], bool bf16) {
  if (bf16)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <int C, bool BF>
__global__ void chains(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + i) & 0x3f800000u;
  b[0] = a[1] ^ 0x1000;
  b[1] = a[2] ^ 0x2000;
  float c[C][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < C; ++j) mma(c[j], a, b, BF);
  }
  float s = 0;
  for (int j = 0; j < C; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 1.2345f) out[0] = s;  // keeps the products
}
template <int C, bool BF>
void run(int warps, int blocks_per_sm) {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, 4);
  const int iters = 4096, blocks = sms * blocks_per_sm;
  chains<C, BF><<<blocks, warps * 32>>>(out, 16, 3);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chains<C, BF><<<blocks, warps * 32>>>(out, iters, 3);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 16 * 8 * (BF ? 16 : 8) * double(iters) * C *
                      warps * blocks;
  printf("%s chains %d warps/block %d blocks/SM %d: %.4f ms, %.1f TFLOP/s "
         "(%s)\n", BF ? "bf16 m16n8k16" : "tf32 m16n8k8", C, warps,
         blocks_per_sm, ms, flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  run<4, false>(8, 2);
  run<8, false>(8, 2);
  run<8, false>(16, 1);
  run<8, false>(16, 2);
  run<16, false>(8, 2);
  run<4, false>(4, 4);
  run<8, true>(16, 1);
  run<8, true>(8, 2);
  return 0;
}
"""


def main() -> int:
    out = ROOT / "build" / "probe_mma"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mma_rate.cu").write_text(SOURCE)
    flags = [f for f in cuda_lib.NVCC_FLAGS
             if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([cuda_lib._nvcc(), *flags, "-o", str(out / "mma_rate"),
                    str(out / "mma_rate.cu")], check=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    return subprocess.run([str(out / "mma_rate")], timeout=300).returncode


if __name__ == "__main__":
    sys.exit(main())
