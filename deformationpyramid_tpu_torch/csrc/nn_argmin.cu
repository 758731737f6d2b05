// C14 nn_argmin: the exact 1-NN of each query point in one database, one
// direction.
//
// Replaces the JAX package's one-direction streaming 1-NN: ops/knn.py
// _nn_kernel (wrapped by _nn_argmin_pallas_padded and nn_argmin_pallas),
// which the JAX nn_argmin takes on a TPU from N*M >= 4096^2 on. The port's
// nn_argmin launches this kernel on CUDA tensors at every size; its callers
// are ops/render.py point_2_plane_distance (twice a call, once each way) and
// the package-level nn_argmin.
//
// What bounds it: N*M distance evaluations of ~8 flops each (1.6e9 pairs at
// 40k x 40k, ~0.19 ms of float32 at 67 TFLOP/s); the inputs are under 1 MB,
// so operations bound it, not bytes. The TPU kernel kept the whole database
// in VMEM and swept [tn, tm] tiles of the expanded distance through the
// matrix unit; here, as in C1's x->y half (nn_dual.cu), one thread owns one
// query and keeps its running (min, argmin) in registers, while the block
// streams the database through shared memory in tiles of NNA_BLOCK points.
// A point is stored as one float4 (x, y, z, valid flag), so a candidate costs
// one 16-byte broadcast load that every thread of the warp shares.
//
// Semantics (the port's, not the TPU's): the distance is the exact
// difference form (qx-px)^2 + (qy-py)^2 + (qz-pz)^2, summed left to right
// with no FMA contraction, never |q|^2 + |p|^2 - 2 q.p as the TPU kernel
// computes it; candidates are visited in increasing index order with a
// strict '<', so an exact tie goes to the first index; a database row whose
// valid flag is 0 never wins (y_valid may be null: every row valid); a
// query with no valid candidate returns (+inf, 0). No atomics: the result
// is deterministic.
#include "common.cuh"

#define NNA_BLOCK 64

__global__ void __launch_bounds__(NNA_BLOCK)
nn_argmin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const unsigned char* __restrict__ y_valid, int n, int m,
                 float* __restrict__ out_d, long long* __restrict__ out_i) {
  __shared__ float4 sp[NNA_BLOCK];

  const int tid = threadIdx.x;
  const int qi = blockIdx.x * NNA_BLOCK + tid;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f;
  if (qi < n) {
    q0 = x[qi * 3 + 0];
    q1 = x[qi * 3 + 1];
    q2 = x[qi * 3 + 2];
  }
  float best = INFINITY;
  int best_i = 0;

  for (int tile = 0; tile < m; tile += NNA_BLOCK) {
    const int j = tile + tid;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < m) {
      p.x = y[j * 3 + 0];
      p.y = y[j * 3 + 1];
      p.z = y[j * 3 + 2];
      p.w = (y_valid == nullptr || y_valid[j]) ? 1.f : 0.f;
    }
    sp[tid] = p;
    __syncthreads();
    const int cnt = min(NNA_BLOCK, m - tile);
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const float4 c = sp[k];
      if (c.w == 0.f) continue;
      const float dx = __fsub_rn(q0, c.x);
      const float dy = __fsub_rn(q1, c.y);
      const float dz = __fsub_rn(q2, c.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_i = tile + k;
      }
    }
    __syncthreads();
  }
  if (qi < n) {
    out_d[qi] = best;
    out_i[qi] = best_i;
  }
}

extern "C" int dp_nn_argmin(const void* x, const void* y, const void* y_valid,
                            int n, int m, void* out_d, void* out_i,
                            void* stream) {
  if (n > 0) {
    const int blocks = (n + NNA_BLOCK - 1) / NNA_BLOCK;
    nn_argmin_kernel<<<blocks, NNA_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)y, (const unsigned char*)y_valid, n, m,
        (float*)out_d, (long long*)out_i);
  }
  return (int)cudaGetLastError();
}
