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
//   launch 1 (chamfer_sweep_kernel) is C1's sweep with these semantics: one
//     thread a query (a row, or a column in the blocks after the row
//     blocks) keeps its running (min, argmin) in registers and streams the
//     other cloud through shared memory in tiles every thread reads as a
//     broadcast; strict '<' in index order keeps the first index;
//   launch 2 (chamfer_finish_kernel) scatters the column terms onto their
//     winning rows as C6 does: one thread a row walks every column in
//     increasing j and adds the columns it won, one after another (the
//     order of a sequential index_add_), then writes cgrad; one extra block
//     sums the row and column terms in a fixed order (strided partial sums
//     a thread, then a tree in shared memory).
// No atomics: the outputs repeat bit for bit. What bounds it: the N x M
// distance evaluations (8 flops each) and the N x M index compares of the
// walk, issue and latency at the solver's 2000 x 2000, as C1 and C6; the
// inputs (48 KB) stay in L1 / L2.
#include "common.cuh"

#define CF_BLOCK 64
#define CF_FINISH 128
#define CF_BIG 3.0e38f
#define CF_FLOOR 1e-16f

__device__ __forceinline__ float cf_dist(float w0, float w1, float w2,
                                         float y0, float y1, float y2,
                                         float bx, float by) {
  const float dx = __fsub_rn(w0, y0);
  const float dy = __fsub_rn(w1, y1);
  const float dz = __fsub_rn(w2, y2);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return __fadd_rn(__fadd_rn(d, bx), by);
}

__global__ void chamfer_sweep_kernel(const float* __restrict__ w,
                                     const float* __restrict__ y,
                                     const unsigned char* __restrict__ wv,
                                     const unsigned char* __restrict__ yv,
                                     int n, int m,
                                     float* __restrict__ rmin,
                                     long long* __restrict__ rarg,
                                     float* __restrict__ cmin,
                                     long long* __restrict__ carg) {
  __shared__ float sp[CF_BLOCK * 3];
  __shared__ float sb[CF_BLOCK];

  const int bx_blocks = (n + CF_BLOCK - 1) / CF_BLOCK;
  const bool rows = blockIdx.x < (unsigned)bx_blocks;
  const float* q = rows ? w : y;
  const float* db = rows ? y : w;
  const unsigned char* qv = rows ? wv : yv;
  const unsigned char* dbv = rows ? yv : wv;
  const int nq = rows ? n : m;
  const int ndb = rows ? m : n;

  const int tid = threadIdx.x;
  const int qi = (rows ? blockIdx.x : blockIdx.x - bx_blocks) * CF_BLOCK + tid;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f, qb = 0.f;
  if (qi < nq) {
    q0 = q[qi * 3 + 0];
    q1 = q[qi * 3 + 1];
    q2 = q[qi * 3 + 2];
    qb = qv[qi] ? 0.f : CF_BIG;
  }
  float best = INFINITY;
  long long best_i = 0;

  for (int tile = 0; tile < ndb; tile += CF_BLOCK) {
    const int j = tile + tid;
    if (j < ndb) {
      sp[tid * 3 + 0] = db[j * 3 + 0];
      sp[tid * 3 + 1] = db[j * 3 + 1];
      sp[tid * 3 + 2] = db[j * 3 + 2];
      sb[tid] = dbv[j] ? 0.f : CF_BIG;
    }
    __syncthreads();
    const int cnt = min(CF_BLOCK, ndb - tile);
    for (int k = 0; k < cnt; ++k) {
      // the same operands in the same order in both directions: the row
      // term (w's mask) is added first
      const float d =
          rows ? cf_dist(q0, q1, q2, sp[k * 3], sp[k * 3 + 1], sp[k * 3 + 2],
                         qb, sb[k])
               : cf_dist(sp[k * 3], sp[k * 3 + 1], sp[k * 3 + 2], q0, q1, q2,
                         sb[k], qb);
      if (d < best) {
        best = d;
        best_i = tile + k;
      }
    }
    __syncthreads();
  }
  if (qi < nq) {
    if (rows) {
      rmin[qi] = fmaxf(best, 0.f);
      rarg[qi] = best_i;
    } else {
      cmin[qi] = best;
      carg[qi] = best_i;
    }
  }
}

__device__ __forceinline__ float cf_inv_root(float d, float trunc) {
  return d < trunc ? 1.f / sqrtf(fmaxf(d, CF_FLOOR)) : 0.f;
}

__device__ __forceinline__ float cf_root(float d, float trunc) {
  return d < trunc ? sqrtf(fmaxf(d, CF_FLOOR)) : 0.f;
}

__global__ void chamfer_finish_kernel(const float* __restrict__ w,
                                      const float* __restrict__ y, int n,
                                      int m, float trunc,
                                      const float* __restrict__ rmin,
                                      const float* __restrict__ cmin,
                                      const long long* __restrict__ carg,
                                      float* __restrict__ cgrad,
                                      float* __restrict__ sums) {
  __shared__ long long si[CF_FINISH];
  __shared__ float ss[CF_FINISH * 4];
  const int tid = threadIdx.x;
  const int row_blocks = (n + CF_FINISH - 1) / CF_FINISH;

  if (blockIdx.x == (unsigned)row_blocks) {
    // the two truncated sums, in a fixed order
    float r = 0.f, c = 0.f;
    for (int i = tid; i < n; i += CF_FINISH) r = __fadd_rn(r, cf_root(rmin[i], trunc));
    for (int j = tid; j < m; j += CF_FINISH) c = __fadd_rn(c, cf_root(cmin[j], trunc));
    ss[tid] = r;
    ss[CF_FINISH + tid] = c;
    __syncthreads();
    for (int s = CF_FINISH / 2; s > 0; s >>= 1) {
      if (tid < s) {
        ss[tid] = __fadd_rn(ss[tid], ss[tid + s]);
        ss[CF_FINISH + tid] = __fadd_rn(ss[CF_FINISH + tid], ss[CF_FINISH + tid + s]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      sums[0] = ss[0];
      sums[1] = ss[CF_FINISH];
    }
    return;
  }

  // the column terms onto their winning rows, in increasing column order
  const int i = blockIdx.x * CF_FINISH + tid;
  float cnt = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int tile = 0; tile < m; tile += CF_FINISH) {
    const int j = tile + tid;
    if (j < m) {
      const float s = cf_inv_root(cmin[j], trunc);
      si[tid] = carg[j];
      ss[tid * 4 + 0] = s;
      ss[tid * 4 + 1] = __fmul_rn(s, y[j * 3 + 0]);
      ss[tid * 4 + 2] = __fmul_rn(s, y[j * 3 + 1]);
      ss[tid * 4 + 3] = __fmul_rn(s, y[j * 3 + 2]);
    }
    __syncthreads();
    const int cnt_k = min(CF_FINISH, m - tile);
    for (int k = 0; k < cnt_k; ++k) {
      if (si[k] == i) {
        cnt = __fadd_rn(cnt, ss[k * 4 + 0]);
        s0 = __fadd_rn(s0, ss[k * 4 + 1]);
        s1 = __fadd_rn(s1, ss[k * 4 + 2]);
        s2 = __fadd_rn(s2, ss[k * 4 + 3]);
      }
    }
    __syncthreads();
  }
  if (i < n) {
    cgrad[i * 3 + 0] = __fsub_rn(__fmul_rn(w[i * 3 + 0], cnt), s0);
    cgrad[i * 3 + 1] = __fsub_rn(__fmul_rn(w[i * 3 + 1], cnt), s1);
    cgrad[i * 3 + 2] = __fsub_rn(__fmul_rn(w[i * 3 + 2], cnt), s2);
  }
}

extern "C" int dp_chamfer_fused(const void* w, const void* y,
                                const void* w_valid, const void* y_valid,
                                int n, int m, float trunc, void* rmin,
                                void* rarg, void* cmin, void* carg,
                                void* cgrad, void* sums, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int sweep = (n + CF_BLOCK - 1) / CF_BLOCK + (m + CF_BLOCK - 1) / CF_BLOCK;
  chamfer_sweep_kernel<<<sweep, CF_BLOCK, 0, st>>>(
      (const float*)w, (const float*)y, (const unsigned char*)w_valid,
      (const unsigned char*)y_valid, n, m, (float*)rmin, (long long*)rarg,
      (float*)cmin, (long long*)carg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int finish = (n + CF_FINISH - 1) / CF_FINISH + 1;
  chamfer_finish_kernel<<<finish, CF_FINISH, 0, st>>>(
      (const float*)w, (const float*)y, n, m, trunc, (const float*)rmin,
      (const float*)cmin, (const long long*)carg, (float*)cgrad,
      (float*)sums);
  return (int)cudaGetLastError();
}
