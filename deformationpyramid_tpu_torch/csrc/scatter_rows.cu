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
// Contract: each row adds its sources one after another in increasing j,
// the order of a sequential index_add_, so the result is deterministic and
// equal bit for bit to index_add_ on the CPU. No float atomics, one launch.
// Indices outside [0, N) are skipped.
//
// What bounds it: latency, not the card's rates. The function moves 44 B a
// source (2000 x 2000 at the solver's shapes: 88 KB, 0.03 us at the memory
// rate); what costs is the dependence of each row's sum on its sources in
// order: one thread a row walking all M indices is N x M compares on a few
// blocks. Here the critical path is one load of the index list and the
// sources that land, two barriers and a walk of the block's own entries.
//
// Design (a bucket pass in one launch, bucket_rows.cuh, shared with C12's
// finish): each block owns ``rows`` destination rows, 16 to 256 of them
// (at most ~264 blocks, two an SM, once N > 4224), one thread a row, which
// reads its row first and keeps the sum in registers. The block streams
// the index list once, coalesced, in chunks of 2048 (eight per thread); a
// source that lands in the block's rows loads its row at once. A warp
// ballot and a prefix popc give each such source its place in a shared
// list, in increasing j, and each row's thread walks the block's list,
// which holds only the block's own entries, and adds its rows in list
// order. Chosen over a warp per row (design b), which would read all M
// indices once per row, N x M / 32 warp steps.
#include "bucket_rows.cuh"

__global__ void __launch_bounds__(SC_THREADS)
scatter_rows_kernel(float* __restrict__ dst, int n,
                    const long long* __restrict__ idx,
                    const float* __restrict__ src, int m, int rows) {
  __shared__ float4 list[SC_CHUNK];
  __shared__ int counts[SC_PER * SC_WARPS];
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, (long long)n - row0);

  // the thread's destination row (rows <= SC_THREADS), read before the
  // index list so that the load overlaps the stream
  float a[3] = {0.f, 0.f, 0.f};
  if (tid < nrows) {
    const float* row = dst + (size_t)(row0 + tid) * 3;
    a[0] = row[0];
    a[1] = row[1];
    a[2] = row[2];
  }
  bucket_pass<3>(a, list, nullptr, counts, idx, src, m, row0, nrows);
  if (tid < nrows) {  // a row without sources writes back its own bits
    float* row = dst + (size_t)(row0 + tid) * 3;
    row[0] = a[0];
    row[1] = a[1];
    row[2] = a[2];
  }
}

extern "C" int dp_scatter_rows(void* dst, int n, const void* idx,
                               const void* src, int m, void* stream) {
  if (n > 0 && m > 0) {
    const int rows = bucket_rows_per_block(n);
    const int blocks = (n + rows - 1) / rows;
    scatter_rows_kernel<<<blocks, SC_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)dst, n, (const long long*)idx, (const float*)src, m, rows);
  }
  return (int)cudaGetLastError();
}
