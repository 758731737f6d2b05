// C12 chamfer_fused: the truncated L1 chamfer between a query cloud w
// [N, 3] and a fixed target y [M, 3] with everything its gradient to w
// needs, in one call of two launches.
//
// Replaces the JAX package's ops/chamfer_fused.py _kernel (the opt-in
// `use_fused_chamfer` loss of solve/registration.py). Outputs, as that
// kernel's:
//   rmin [N], rarg [N]  each query row's squared distance to its nearest
//                       target column and that column (first index on ties)
//   cmin [M], carg [M]  the same for each target column over the rows
//   cgrad [N, 3]        w_i * cnt_i - sum_j s_j y_j over the columns j whose
//                       argmin is row i, s_j = 1 / sqrt(max(cmin_j, 1e-16))
//                       where cmin_j < trunc, else 0
//   sums [2]            the truncated row sum sum_i sqrt(max(rmin_i, 1e-16))
//                       over rmin_i < trunc, and the column sum likewise
// Distances are the exact squared difference ((dx^2 + dy^2) + dz^2) with no
// FMA contraction, never |w|^2 + |y|^2 - 2 w.y: here the sweep's minimum is
// the loss itself, and the expanded form's cancellation is the size of a
// converged distance. Invalid rows and columns get +BIG (3e38) added, row
// term first, so they never win a minimum against a valid candidate and
// always fail the truncation, which compares the squared distance.
//
// Design. The TPU kernel kept w resident and walked y tiles through its
// sequential grid, carrying the row minima and the column gradient across
// grid steps. Blocks on Hopper run in parallel and in no order, so:
//   launch 1 (chamfer_sweep_kernel) is C1's split-database sweep
//     (nn_sweep.cuh) with these semantics: 32 queries a block (rows, then
//     columns in the blocks after the row blocks), the other cloud split
//     into 16 contiguous slices, one a warp, each candidate staged as one
//     float4 (x, y, z, its mask term 0 or BIG) and the slices' (min,
//     argmin) merged by the (d, i) rule, so ties go to the first index.
//     A pad past a slice's end is staged with x = NaN and never wins, but
//     an invalid candidate keeps its +BIG arithmetic: a query whose
//     candidates are all invalid gets 3e38 as before, not +inf, and where
//     BIG + BIG overflows to +inf the slice keeps (+inf, NONE), turned
//     into index 0 as before. The column blocks also write s_j and
//     s_j * y_j as one float4 [M], the terms the finish adds;
//   launch 2 (chamfer_finish_kernel) adds the column terms onto their
//     winning rows with C6's bucket pass (bucket_rows.cuh: each block owns
//     a range of rows, streams carg once and adds its rows' entries in
//     increasing j, the order of a sequential index_add_, from zero), then
//     writes cgrad = w * cnt - sum s_j y_j; one extra block sums the row
//     and column terms in a fixed order (strided partial sums over 128
//     threads, then a tree in shared memory).
// No atomics: the outputs repeat bit for bit, and they are those of the
// one-query-a-thread sweep and the row-by-row walk that this design
// replaced. What bounds it: the N x M distance evaluations (8 flops each,
// issued as ~14 instructions with the two BIG adds), issue and latency at
// the solver's 2000 x 2000, as C1; the inputs (48 KB) stay in L1 / L2.
#include "bucket_rows.cuh"
#include "nn_sweep.cuh"

#define CF_WARPS 16                // slices a query, one a warp
#define CF_SUMS 128                // threads of the sums' fixed order
#define CF_BIG 3.0e38f
#define CF_FLOOR 1e-16f
using CFSweep = NNSweep<CF_WARPS, 1, 1>;

// Candidate j of the slice ending at `hi`: (x, y, z, 0 or BIG for an
// invalid row); x = NaN past the slice.
struct CFStage {
  const float* __restrict__ db;
  const unsigned char* __restrict__ dbv;
  __device__ __forceinline__ float4 operator()(int j, int hi) const {
    float4 c = make_float4(__int_as_float(0x7fffffff), 0.f, 0.f, 0.f);
    if (j < hi) {
      c.x = db[j * 3 + 0];
      c.y = db[j * 3 + 1];
      c.z = db[j * 3 + 2];
      c.w = dbv[j] ? 0.f : CF_BIG;
    }
    return c;
  }
};

// The distance with both mask terms, the row term (w's) added first in
// both directions: a row query adds its own term, then the candidate's; a
// column query the candidate's, then its own. The squared differences are
// sign-symmetric, so the direction of the subtraction is free.
template <bool ROWS>
struct CFDist {
  float qx, qy, qz, qb;
  __device__ __forceinline__ float operator()(int, const float4& c) const {
    const float d = nn_sqdist(qx, qy, qz, c);
    return ROWS ? __fadd_rn(__fadd_rn(d, qb), c.w)
                : __fadd_rn(__fadd_rn(d, c.w), qb);
  }
};

__device__ __forceinline__ float cf_inv_root(float d, float trunc) {
  return d < trunc ? 1.f / sqrtf(fmaxf(d, CF_FLOOR)) : 0.f;
}

__device__ __forceinline__ float cf_root(float d, float trunc) {
  return d < trunc ? sqrtf(fmaxf(d, CF_FLOOR)) : 0.f;
}

__global__ void __launch_bounds__(CF_WARPS * 32)
chamfer_sweep_kernel(const float* __restrict__ w, const float* __restrict__ y,
                     const unsigned char* __restrict__ wv,
                     const unsigned char* __restrict__ yv, int n, int m,
                     float trunc, float* __restrict__ rmin,
                     long long* __restrict__ rarg, float* __restrict__ cmin,
                     long long* __restrict__ carg, float4* __restrict__ sy) {
  __shared__ CFSweep::Smem sm;

  const int bx = (n + CFSweep::Q - 1) / CFSweep::Q;
  const bool rows = blockIdx.x < (unsigned)bx;
  const float* q = rows ? w : y;
  const unsigned char* qv = rows ? wv : yv;
  const int nq = rows ? n : m;
  const int q0 = (rows ? blockIdx.x : blockIdx.x - bx) * CFSweep::Q;
  const int qi = q0 + (threadIdx.x & 31);
  float qx = 0.f, qy = 0.f, qz = 0.f, qb = 0.f;
  if (qi < nq) {
    qx = q[qi * 3 + 0];
    qy = q[qi * 3 + 1];
    qz = q[qi * 3 + 2];
    qb = qv[qi] ? 0.f : CF_BIG;
  }
  if (rows) {
    nn_sweep<CF_WARPS, 1, 1>(sm, CFStage{y, yv}, CFDist<true>{qx, qy, qz, qb},
                             m);
  } else {
    nn_sweep<CF_WARPS, 1, 1>(sm, CFStage{w, wv},
                             CFDist<false>{qx, qy, qz, qb}, n);
  }
  __syncthreads();

  // thread p < 32 is lane p of warp 0: query q0 + p is its own (qx, qy, qz)
  if (threadIdx.x < CFSweep::Q && qi < nq) {
    float d;
    int i;
    nn_merge<CF_WARPS, 1, 1>(sm, threadIdx.x, d, i);
    i = i == NN_NONE ? 0 : i;
    if (rows) {
      rmin[qi] = fmaxf(d, 0.f);
      rarg[qi] = i;
    } else {
      cmin[qi] = d;
      carg[qi] = i;
      const float s = cf_inv_root(d, trunc);
      sy[qi] = make_float4(s, __fmul_rn(s, qx), __fmul_rn(s, qy),
                           __fmul_rn(s, qz));
    }
  }
}

// Blocks [0, ceil(n / rows)) add the column terms onto their rows (C6's
// bucket pass) and write cgrad; the last block writes the two sums.
__global__ void __launch_bounds__(SC_THREADS)
chamfer_finish_kernel(const float* __restrict__ w, int n, int m, float trunc,
                      const float* __restrict__ rmin,
                      const float* __restrict__ cmin,
                      const long long* __restrict__ carg,
                      const float4* __restrict__ sy,
                      float* __restrict__ cgrad, float* __restrict__ sums,
                      int rows) {
  __shared__ float4 list[SC_CHUNK];
  __shared__ int rowl[SC_CHUNK];
  __shared__ int counts[SC_PER * SC_WARPS];
  __shared__ float ss[2 * CF_SUMS];
  const int tid = threadIdx.x;
  const int row_blocks = (n + rows - 1) / rows;

  if (blockIdx.x == (unsigned)row_blocks) {
    // the two truncated sums, in a fixed order
    if (tid < CF_SUMS) {
      float r = 0.f, c = 0.f;
      for (int i = tid; i < n; i += CF_SUMS)
        r = __fadd_rn(r, cf_root(rmin[i], trunc));
      for (int j = tid; j < m; j += CF_SUMS)
        c = __fadd_rn(c, cf_root(cmin[j], trunc));
      ss[tid] = r;
      ss[CF_SUMS + tid] = c;
    }
    __syncthreads();
    for (int s = CF_SUMS / 2; s > 0; s >>= 1) {
      if (tid < s) {
        ss[tid] = __fadd_rn(ss[tid], ss[tid + s]);
        ss[CF_SUMS + tid] = __fadd_rn(ss[CF_SUMS + tid], ss[CF_SUMS + tid + s]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      sums[0] = ss[0];
      sums[1] = ss[CF_SUMS];
    }
    return;
  }

  // the column terms (s_j, s_j y_j) onto their winning rows, from zero, in
  // increasing column order
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, (long long)n - row0);
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  bucket_pass<4>(a, list, rowl, counts, carg,
                 reinterpret_cast<const float*>(sy), m, row0, nrows);
  if (tid < nrows) {
    const long long i = row0 + tid;
    cgrad[i * 3 + 0] = __fsub_rn(__fmul_rn(w[i * 3 + 0], a[0]), a[1]);
    cgrad[i * 3 + 1] = __fsub_rn(__fmul_rn(w[i * 3 + 1], a[0]), a[2]);
    cgrad[i * 3 + 2] = __fsub_rn(__fmul_rn(w[i * 3 + 2], a[0]), a[3]);
  }
}

extern "C" int dp_chamfer_fused(const void* w, const void* y,
                                const void* w_valid, const void* y_valid,
                                int n, int m, float trunc, void* rmin,
                                void* rarg, void* cmin, void* carg, void* sy,
                                void* cgrad, void* sums, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int sweep = (n + CFSweep::Q - 1) / CFSweep::Q
                    + (m + CFSweep::Q - 1) / CFSweep::Q;
  chamfer_sweep_kernel<<<sweep, CF_WARPS * 32, 0, st>>>(
      (const float*)w, (const float*)y, (const unsigned char*)w_valid,
      (const unsigned char*)y_valid, n, m, trunc, (float*)rmin,
      (long long*)rarg, (float*)cmin, (long long*)carg, (float4*)sy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = bucket_rows_per_block(n);
  chamfer_finish_kernel<<<(n + rows - 1) / rows + 1, SC_THREADS, 0, st>>>(
      (const float*)w, n, m, trunc, (const float*)rmin, (const float*)cmin,
      (const long long*)carg, (const float4*)sy, (float*)cgrad,
      (float*)sums, rows);
  return (int)cudaGetLastError();
}
