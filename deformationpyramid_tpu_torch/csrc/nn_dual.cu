// C1 nn_dual: both directions of the exact 1-NN between two point clouds
// in one launch.
//
// Replaces the dual sweep of the JAX package: ops/knn.py _nn_dual_kernel
// (v1, which defines the selection semantics), _nn_dual_kernel_v3 and
// _nn_dual_kernel_v4 (the TPU defaults), and the sweep half of
// ops/fused_iteration.py _fwd_sweep_kernel.
//
// What bounds it: N*M distance evaluations (2000 x 2000 x 2 directions at
// the solver's shapes, ~8 flops each); the inputs are 48 KB and stay in
// L1/L2, so it is latency- and issue-bound, not memory-bound. The TPU
// kernels tiled an [tn, tm] distance block through VMEM and reduced it
// with masked-iota argmins; on Hopper one thread owns one query point and
// keeps its running (min, argmin) in registers, while the block streams
// the database through shared memory in tiles of NN_BLOCK points that
// every thread reads as a broadcast. The first ceil(N/NN_BLOCK) blocks
// take the x->y queries, the remaining blocks the y->x queries.
//
// Semantics: the distance is the exact difference form
// (qx-px)^2 + (qy-py)^2 + (qz-pz)^2, summed left to right with no FMA
// contraction (never |q|^2 + |p|^2 - 2 q.p, whose cancellation floors the
// chamfer loss); candidates are visited in increasing index order with a
// strict '<', so exact ties go to the first index, as in v1; rows whose
// valid flag is 0 never win. A query with no valid candidate returns
// (+inf, 0). No atomics: the result is deterministic.
#include "common.cuh"

#define NN_BLOCK 64

__global__ void nn_dual_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               const unsigned char* __restrict__ x_valid,
                               const unsigned char* __restrict__ y_valid,
                               int n, int m,
                               float* __restrict__ d_xy,
                               long long* __restrict__ i_xy,
                               float* __restrict__ d_yx,
                               long long* __restrict__ i_yx) {
  __shared__ float sp[NN_BLOCK * 3];
  __shared__ unsigned char sv[NN_BLOCK];

  const int bx = (n + NN_BLOCK - 1) / NN_BLOCK;
  const bool xdir = blockIdx.x < (unsigned)bx;
  const float* q = xdir ? x : y;
  const float* db = xdir ? y : x;
  const unsigned char* dbv = xdir ? y_valid : x_valid;
  const int nq = xdir ? n : m;
  const int ndb = xdir ? m : n;
  float* out_d = xdir ? d_xy : d_yx;
  long long* out_i = xdir ? i_xy : i_yx;

  const int tid = threadIdx.x;
  const int qi = (xdir ? blockIdx.x : blockIdx.x - bx) * NN_BLOCK + tid;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f;
  if (qi < nq) {
    q0 = q[qi * 3 + 0];
    q1 = q[qi * 3 + 1];
    q2 = q[qi * 3 + 2];
  }
  float best = INFINITY;
  long long best_i = 0;

  for (int tile = 0; tile < ndb; tile += NN_BLOCK) {
    const int j = tile + tid;
    if (j < ndb) {
      sp[tid * 3 + 0] = db[j * 3 + 0];
      sp[tid * 3 + 1] = db[j * 3 + 1];
      sp[tid * 3 + 2] = db[j * 3 + 2];
      sv[tid] = dbv[j];
    } else {
      sv[tid] = 0;
    }
    __syncthreads();
    const int cnt = min(NN_BLOCK, ndb - tile);
    for (int k = 0; k < cnt; ++k) {
      if (!sv[k]) continue;
      const float dx = __fsub_rn(q0, sp[k * 3 + 0]);
      const float dy = __fsub_rn(q1, sp[k * 3 + 1]);
      const float dz = __fsub_rn(q2, sp[k * 3 + 2]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_i = tile + k;
      }
    }
    __syncthreads();
  }
  if (qi < nq) {
    out_d[qi] = best;
    out_i[qi] = best_i;
  }
}

extern "C" int dp_nn_dual(const void* x, const void* y, const void* x_valid,
                          const void* y_valid, int n, int m, void* d_xy,
                          void* i_xy, void* d_yx, void* i_yx, void* stream) {
  const int blocks = (n + NN_BLOCK - 1) / NN_BLOCK + (m + NN_BLOCK - 1) / NN_BLOCK;
  if (blocks > 0) {
    nn_dual_kernel<<<blocks, NN_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)y, (const unsigned char*)x_valid,
        (const unsigned char*)y_valid, n, m, (float*)d_xy, (long long*)i_xy,
        (float*)d_yx, (long long*)i_yx);
  }
  return (int)cudaGetLastError();
}
