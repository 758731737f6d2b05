// The bucket pass of C6 scatter_rows (scatter_rows.cu), shared with the
// finish of C12 chamfer_fused (chamfer_fused.cu): each thread of a block
// owns one destination row and adds, one after another in increasing j,
// the W floats of every source row j whose index idx[j] is its row, the
// order of a sequential index_add_. No float atomics: the sums are
// deterministic and bit-equal to index_add_ on the CPU.
//
// Design: each block owns ``rows`` destination rows (16 to 256 of them,
// bucket_rows_per_block: at most ~264 blocks, two an SM, once N > 4224),
// one thread a row, which keeps its sum in registers. The block streams
// the index list once, coalesced, in chunks of SC_CHUNK (eight a thread);
// a source that lands in the block's rows loads its row at once. A warp
// ballot and a prefix popc give each such source its place in a shared
// list, in increasing j: every warp scans the (chunk slot, warp) counts
// itself, so the order is that of j whatever the threads' timing, at two
// barriers a chunk. Then each row's thread walks the block's list, which
// holds only the block's own entries, eight at a time, and adds its rows
// in list order with predicated adds (only the adds' chain is serial). At
// uniform indices a block's list holds ~M x rows / N entries (16 at 2000 x
// 2000); when all M sources land on one row, that row's thread adds M rows
// from shared memory, a serial chain of M adds that the contract requires.
//
// W = 3: C6's rows of 3 floats at a stride of 3, an entry one float4 with
// the local row in w. W = 4: C12's float4 rows (s_j, s_j * y_j), an entry
// a float4 and the local row beside it.
#pragma once

#include "common.cuh"

#define SC_THREADS 256
#define SC_PER 8                          // chunk slots per thread
#define SC_MIN_ROWS 16
#define SC_CHUNK (SC_THREADS * SC_PER)    // sources a chunk stages
#define SC_WARPS (SC_THREADS / 32)
#define SC_TARGET_BLOCKS 264              // two per SM of an H100
static_assert(SC_PER * SC_WARPS == 64, "the scan takes two counts a lane");

// Destination rows a block: 16 to SC_THREADS, about SC_TARGET_BLOCKS blocks.
static inline int bucket_rows_per_block(int n) {
  const int rows = (n + SC_TARGET_BLOCKS - 1) / SC_TARGET_BLOCKS;
  return rows < SC_MIN_ROWS ? SC_MIN_ROWS
                            : (rows > SC_THREADS ? SC_THREADS : rows);
}

// Adds to ``a`` (the thread's row row0 + threadIdx.x, where threadIdx.x <
// nrows) every source row j < m whose idx[j] is that row, in increasing j.
// Every thread of the block calls it, with the block's shared arrays:
// ``list`` [SC_CHUNK] (the entries in j order), ``rowl`` [SC_CHUNK] (W = 4
// only: the entries' local rows; null for W = 3) and ``counts``
// [SC_PER * SC_WARPS]. Separate __shared__ arrays, not one struct: one
// struct passed by reference cost C6 6-10% on an H100 (12 registers fewer,
// its loads scheduled worse).
template <int W>
__device__ __forceinline__ void bucket_pass(float (&a)[W],
                                            float4* __restrict__ list,
                                            int* __restrict__ rowl,
                                            int* __restrict__ counts,
                                            const long long* __restrict__ idx,
                                            const float* __restrict__ src,
                                            int m, long long row0,
                                            int nrows) {
  static_assert(W == 3 || W == 4, "rows of 3 or 4 floats");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
        const int j = c0 + k * SC_THREADS + tid;
        if constexpr (W == 3) {
          const float* s = src + (size_t)j * 3;
          ent[k] = make_float4(__ldg(s), __ldg(s + 1), __ldg(s + 2),
                               __int_as_float((int)rel[k]));
        } else {
          ent[k] = __ldg(reinterpret_cast<const float4*>(src) + j);
        }
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
      if ((hits[k] >> lane) & 1u) {
        const int at = base + __popc(hits[k] & ((1u << lane) - 1u));
        list[at] = ent[k];
        if constexpr (W == 4) rowl[at] = (int)rel[k];
      }
    }
    __syncthreads();
    if (tid < nrows) {
      // the row's sources in list order, eight entries loaded at a time
      for (int e0 = 0; e0 < total; e0 += 8) {
        if constexpr (W == 3) {
          const float4 none = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
          float4 t[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            t[u] = e0 + u < total ? list[e0 + u] : none;
          // predicated adds, no branch: only the adds' chain is serial
#pragma unroll
          for (int u = 0; u < 8; ++u)
            asm("{\n .reg .pred p;\n setp.eq.s32 p, %3, %4;\n"
                " @p add.rn.f32 %0, %0, %5;\n @p add.rn.f32 %1, %1, %6;\n"
                " @p add.rn.f32 %2, %2, %7;\n}"
                : "+f"(a[0]), "+f"(a[1]), "+f"(a[2])
                : "r"(__float_as_int(t[u].w)), "r"(tid), "f"(t[u].x),
                  "f"(t[u].y), "f"(t[u].z));
        } else {
          float4 t[8];
          int r[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const bool in = e0 + u < total;
            t[u] = in ? list[e0 + u] : make_float4(0.f, 0.f, 0.f, 0.f);
            r[u] = in ? rowl[e0 + u] : -1;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            asm("{\n .reg .pred p;\n setp.eq.s32 p, %4, %5;\n"
                " @p add.rn.f32 %0, %0, %6;\n @p add.rn.f32 %1, %1, %7;\n"
                " @p add.rn.f32 %2, %2, %8;\n @p add.rn.f32 %3, %3, %9;\n}"
                : "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3])
                : "r"(r[u]), "r"(tid), "f"(t[u].x), "f"(t[u].y),
                  "f"(t[u].z), "f"(t[u].w));
        }
      }
    }
    if (c0 + SC_CHUNK < m) __syncthreads();  // before the next chunk's list
  }
}
