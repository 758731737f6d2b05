// The rate of mma.sync m16n8k8 with TF32 operands on one CUDA GPU: each
// warp runs CHAINS independent accumulator chains of dependent products,
// with 8, 16 or 32 warps a block and one or two blocks an SM. It is the
// ceiling of the 3xTF32 kernels C7-C9 (flash_attention*.cu), which issue
// their products through mma.sync, not through wgmma.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/mma_tf32_rate scripts/mma_tf32_rate.cu && build/mma_tf32_rate
//
// Prints one line a configuration: the time by CUDA events and the rate in
// TFLOP/s (2 * 16 * 8 * 8 flops a product).
#include <cstdio>
#include <cuda_runtime.h>

template <int CHAINS>
__global__ void bench(float* out, int iters, unsigned seed) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed + threadIdx.x * 7 + i) & 0x3f800000u;
  b[0] = a[1];
  b[1] = a[2];
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ch = 0; ch < CHAINS; ++ch)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[ch][0]), "+f"(c[ch][1]), "+f"(c[ch][2]), "+f"(c[ch][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int ch = 0; ch < CHAINS; ++ch) s += c[ch][0] + c[ch][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS>
void run(int threads, int blocks, float* out) {
  const int iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  bench<CHAINS><<<blocks, threads>>>(out, 16, 1);
  cudaEventRecord(e0);
  bench<CHAINS><<<blocks, threads>>>(out, iters, 1);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops =
      2.0 * 16 * 8 * 8 * (double)iters * CHAINS * (threads / 32) * blocks;
  printf("chains %d, %d warps a block, %d blocks: %.3f ms, %.1f TFLOP/s\n",
         CHAINS, threads / 32, blocks, ms, flops / ms / 1e9);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  if (cudaMalloc(&out, 1 << 24) != cudaSuccess) return 1;
  run<1>(256, 2 * sms, out);
  run<2>(256, 2 * sms, out);
  run<4>(256, 2 * sms, out);
  run<8>(256, 2 * sms, out);
  run<4>(512, sms, out);
  run<8>(512, sms, out);
  run<8>(1024, sms, out);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
