// C6 scatter_rows: dst[idx[j]] += src[j] for rows of 3 floats, in place.
//
// Replaces the y->x scatter-add of the chamfer glue (the JAX package's
// ops/fused_iteration.py _chamfer_glue, `gx.at[rarg].add(gy)`, which XLA
// compiled; the port's glue is otherwise plain PyTorch). On CUDA,
// PyTorch's index_add_ sums with float atomics in whatever order the
// threads arrive, so the same pair could stop its level an iteration
// earlier or later from one run to the next; its index_put_ with
// accumulate sorts first, which costs about ten more launches per solver
// iteration on a path that the host's launches bound.
//
// Design: one thread per destination row keeps the row in registers and
// walks the whole index list in increasing j, tiles of which the block
// stages in shared memory and every thread reads as a broadcast; it adds
// the sources whose index is its row, one after another. That is the
// order of a sequential index_add_, so the result is deterministic and
// equal bit for bit to index_add_ on the CPU. No atomics.
//
// What bounds it: N x M index compares (2000 x 2000 at the solver's
// shapes, 6000 x 6000 for the shape-transfer demo), a few instructions
// each, from shared memory; the bytes (M indices and M rows, 40 B a
// source) are read once per block. Indices outside [0, N) are skipped.
#include "common.cuh"

#define SC_BLOCK 128

__global__ void scatter_rows_kernel(float* __restrict__ dst, int n,
                                    const long long* __restrict__ idx,
                                    const float* __restrict__ src, int m) {
  __shared__ long long si[SC_BLOCK];
  __shared__ float ss[SC_BLOCK * 3];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * SC_BLOCK + tid;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f;
  if (i < n) {
    r0 = dst[i * 3 + 0];
    r1 = dst[i * 3 + 1];
    r2 = dst[i * 3 + 2];
  }
  for (int tile = 0; tile < m; tile += SC_BLOCK) {
    const int j = tile + tid;
    if (j < m) {
      si[tid] = idx[j];
      ss[tid * 3 + 0] = src[j * 3 + 0];
      ss[tid * 3 + 1] = src[j * 3 + 1];
      ss[tid * 3 + 2] = src[j * 3 + 2];
    } else {
      si[tid] = -1;
    }
    __syncthreads();
    const int cnt = min(SC_BLOCK, m - tile);
    for (int k = 0; k < cnt; ++k) {
      if (si[k] == i) {
        r0 = __fadd_rn(r0, ss[k * 3 + 0]);
        r1 = __fadd_rn(r1, ss[k * 3 + 1]);
        r2 = __fadd_rn(r2, ss[k * 3 + 2]);
      }
    }
    __syncthreads();
  }
  if (i < n) {
    dst[i * 3 + 0] = r0;
    dst[i * 3 + 1] = r1;
    dst[i * 3 + 2] = r2;
  }
}

extern "C" int dp_scatter_rows(void* dst, int n, const void* idx,
                               const void* src, int m, void* stream) {
  if (n > 0 && m > 0) {
    const int blocks = (n + SC_BLOCK - 1) / SC_BLOCK;
    scatter_rows_kernel<<<blocks, SC_BLOCK, 0, (cudaStream_t)stream>>>(
        (float*)dst, n, (const long long*)idx, (const float*)src, m);
  }
  return (int)cudaGetLastError();
}
