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
// Design (a bucket pass in one launch): each block owns ``rows`` destination
// rows, 16 to 256 of them (at most ~264 blocks, two an SM, once N > 4224),
// one thread a row, which reads its row first and keeps the sum in
// registers. The block
// streams the index list once, coalesced, in chunks of 2048 (eight per
// thread); a source that lands in the block's rows loads its row at once.
// A warp ballot and a prefix popc give each such source its place in a
// shared list, in increasing j: every warp scans the (chunk slot, warp)
// counts itself, so the order is that of j whatever the threads' timing,
// at two barriers a chunk. Then each row's thread walks the block's list,
// which holds only the block's own entries, eight at a time, and adds its
// rows in list order. At uniform indices a block's list holds ~M x rows / N
// entries (16 at 2000 x 2000); when all M sources land on one row, that
// row's thread adds M rows from shared memory, a serial chain of M adds
// that the contract requires. Chosen over a warp per row (design b), which
// would read all M indices once per row, N x M / 32 warp steps.
#include "common.cuh"

#define SC_THREADS 256
#define SC_PER 8                          // chunk slots per thread
#define SC_MIN_ROWS 16
#define SC_CHUNK (SC_THREADS * SC_PER)    // sources a chunk stages
#define SC_WARPS (SC_THREADS / 32)
#define SC_TARGET_BLOCKS 264              // two per SM of an H100
static_assert(SC_PER * SC_WARPS == 64, "the scan takes two counts a lane");

__global__ void __launch_bounds__(SC_THREADS)
scatter_rows_kernel(float* __restrict__ dst, int n,
                    const long long* __restrict__ idx,
                    const float* __restrict__ src, int m, int rows) {
  __shared__ float4 list[SC_CHUNK];       // (src row, local dst row) in j order
  __shared__ int counts[SC_PER * SC_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, (long long)n - row0);

  // the thread's destination row (rows <= SC_THREADS), read before the
  // index list so that the load overlaps the stream
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (tid < nrows) {
    const float* row = dst + (size_t)(row0 + tid) * 3;
    a0 = row[0];
    a1 = row[1];
    a2 = row[2];
  }

  for (int c0 = 0; c0 < m; c0 += SC_CHUNK) {
    // all of the chunk's index loads first: a ballot between two loads
    // would wait for the first before issuing the second
    long long rel[SC_PER];
#pragma unroll
    for (int k = 0; k < SC_PER; ++k) {
      const int j = c0 + k * SC_THREADS + tid;
      rel[k] = j < m ? __ldg(idx + j) - row0 : -1;
    }
    unsigned hits[SC_PER];
    float4 ent[SC_PER];
#pragma unroll
    for (int k = 0; k < SC_PER; ++k) {
      const bool hit = rel[k] >= 0 && rel[k] < nrows;
      hits[k] = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const float* s = src + (size_t)(c0 + k * SC_THREADS + tid) * 3;
        ent[k] = make_float4(__ldg(s), __ldg(s + 1), __ldg(s + 2),
                             __int_as_float((int)rel[k]));
      }
      if (lane == 0) counts[k * SC_WARPS + warp] = __popc(hits[k]);
    }
    __syncthreads();
    // every warp scans the SC_PER x SC_WARPS counts in j order (slot k, then
    // warp), two consecutive counts a lane, and fetches its own slots' bases
    const int ca = counts[2 * lane], cb = counts[2 * lane + 1];
    int incl = ca + cb;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const int excl = incl - ca - cb;
    const int total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int k = 0; k < SC_PER; ++k) {
      const int i = k * SC_WARPS + warp;   // the lane holding it: i / 2
      const int e = __shfl_sync(0xffffffffu, excl, i >> 1);
      const int f = __shfl_sync(0xffffffffu, ca, i >> 1);
      const int base = (i & 1) ? e + f : e;
      if ((hits[k] >> lane) & 1u)
        list[base + __popc(hits[k] & ((1u << lane) - 1u))] = ent[k];
    }
    __syncthreads();
    if (tid < nrows) {
      // the row's sources in list order, eight entries loaded at a time
      for (int e0 = 0; e0 < total; e0 += 8) {
        const float4 none = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
        float4 t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = e0 + u < total ? list[e0 + u] : none;
        // predicated adds, no branch: only the adds' chain is serial
#pragma unroll
        for (int u = 0; u < 8; ++u)
          asm("{\n .reg .pred p;\n setp.eq.s32 p, %3, %4;\n"
              " @p add.rn.f32 %0, %0, %5;\n @p add.rn.f32 %1, %1, %6;\n"
              " @p add.rn.f32 %2, %2, %7;\n}"
              : "+f"(a0), "+f"(a1), "+f"(a2)
              : "r"(__float_as_int(t[u].w)), "r"(tid), "f"(t[u].x),
                "f"(t[u].y), "f"(t[u].z));
      }
    }
    if (c0 + SC_CHUNK < m) __syncthreads();  // before the next chunk's list
  }
  if (tid < nrows) {  // a row without sources writes back its own bits
    float* row = dst + (size_t)(row0 + tid) * 3;
    row[0] = a0;
    row[1] = a1;
    row[2] = a2;
  }
}

extern "C" int dp_scatter_rows(void* dst, int n, const void* idx,
                               const void* src, int m, void* stream) {
  if (n > 0 && m > 0) {
    // 16 to SC_THREADS rows a block, about SC_TARGET_BLOCKS blocks
    int rows = (n + SC_TARGET_BLOCKS - 1) / SC_TARGET_BLOCKS;
    rows = rows < SC_MIN_ROWS ? SC_MIN_ROWS
                              : (rows > SC_THREADS ? SC_THREADS : rows);
    const int blocks = (n + rows - 1) / rows;
    scatter_rows_kernel<<<blocks, SC_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)dst, n, (const long long*)idx, (const float*)src, m, rows);
  }
  return (int)cudaGetLastError();
}
