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
// L1/L2, so operations bind it, not bytes. The TPU kernels tiled an
// [tn, tm] distance block through VMEM and reduced it with masked-iota
// argmins. Here a block of NN_WARPS warps takes 32 queries, one a lane,
// and splits the database into NN_WARPS contiguous slices in index order,
// one a warp: every SM gets warps enough to hide the latency of the
// running minimum's compare-and-select chain, and at 2000 + 2000 queries
// the grid (ceil(N/32) + ceil(M/32) blocks, the x->y queries first)
// fills the 132 SMs about once. Each warp streams its slice through its
// own NN_STAGE-candidate buffer in shared memory, two candidates a lane
// loaded a tile ahead, as one float4 (x, y, z, pad): a candidate is one
// broadcast 16-byte load that feeds every query of the warp. An invalid
// row, and a pad past the slice's end, is staged with x = NaN, so its
// distance is NaN and never passes the strict '<': no branch on a mask.
// The warps' (min, argmin) partials are then merged through shared memory.
// No atomics and no second launch: the result is deterministic.
//
// Slots (the counterpart of the vmapped Pallas 1-NN of the continuous-
// batching solver, solve/streaming.py _pair_step): B independent pairs of
// the same shapes, x [B, N, 3] and y [B, M, 3] with masks [B, N], [B, M],
// in one launch; the grid's y axis is the slot, and each block offsets
// every pointer by its slot and runs the one-pair sweep unchanged, so a
// slot's result is bit-equal to a one-pair launch on that slot's inputs.
// The one-pair entry is the launch at B = 1.
//
// Semantics (bit-equal to the one-query-a-thread sweep it replaced, on
// every input; the sweep and its merge are nn_sweep.cuh's, shared with C14
// and C12): the distance is the exact difference form
// (qx-px)^2 + (qy-py)^2 + (qz-pz)^2, summed left to right with no FMA
// contraction (never |q|^2 + |p|^2 - 2 q.p, whose cancellation floors the
// chamfer loss); a warp visits its slice in increasing index order with a
// strict '<', so an exact tie goes to the slice's first index; a slice
// with no winner (no valid candidate, or only +inf / NaN distances) keeps
// (+inf, NN_NONE); the merge takes (d, i) over (d', i') when
// d < d' || (d == d' && i < i'), a rule that is associative and
// commutative, so the merged pair is the first-index minimum of the whole
// database (v1's, ops/knn.py:166) in any merge order. A query with no
// winner returns (+inf, 0).
#include "nn_sweep.cuh"

#define NN_WARPS 16                // database slices a block, one a warp
using C1Sweep = NNSweep<NN_WARPS, 1, 1>;

__global__ void __launch_bounds__(NN_WARPS * 32)
nn_dual_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const unsigned char* __restrict__ x_valid,
               const unsigned char* __restrict__ y_valid, int n, int m,
               float* __restrict__ d_xy, long long* __restrict__ i_xy,
               float* __restrict__ d_yx, long long* __restrict__ i_yx) {
  __shared__ C1Sweep::Smem sm;

  const size_t slot = blockIdx.y;
  x += slot * n * 3;
  y += slot * m * 3;
  x_valid += slot * n;
  y_valid += slot * m;
  d_xy += slot * n;
  i_xy += slot * n;
  d_yx += slot * m;
  i_yx += slot * m;
  const int bx = (n + C1Sweep::Q - 1) / C1Sweep::Q;
  const bool xdir = blockIdx.x < (unsigned)bx;
  const float* q = xdir ? x : y;
  const int nq = xdir ? n : m;
  const int q0 = (xdir ? blockIdx.x : blockIdx.x - bx) * C1Sweep::Q;
  const int qi = q0 + (threadIdx.x & 31);
  NNDistPlain<1> dist{{0.f}, {0.f}, {0.f}};
  if (qi < nq) {
    dist.qx[0] = q[qi * 3 + 0];
    dist.qy[0] = q[qi * 3 + 1];
    dist.qz[0] = q[qi * 3 + 2];
  }
  const NNStageNaN<false> stage{xdir ? y : x, xdir ? y_valid : x_valid};
  nn_sweep<NN_WARPS, 1, 1>(sm, stage, dist, xdir ? m : n);
  __syncthreads();

  if (threadIdx.x < C1Sweep::Q) {
    const int p = threadIdx.x;
    float d;
    int i;
    nn_merge<NN_WARPS, 1, 1>(sm, p, d, i);
    if (q0 + p < nq) {
      float* out_d = xdir ? d_xy : d_yx;
      long long* out_i = xdir ? i_xy : i_yx;
      out_d[q0 + p] = d;
      out_i[q0 + p] = i == NN_NONE ? 0 : i;
    }
  }
}

// b slots of n and m points each (b = 1: one pair); the slots lie one
// after another in every array.
extern "C" int dp_nn_dual(const void* x, const void* y, const void* x_valid,
                          const void* y_valid, int b, int n, int m,
                          void* d_xy, void* i_xy, void* d_yx, void* i_yx,
                          void* stream) {
  const int blocks = (n + C1Sweep::Q - 1) / C1Sweep::Q
                     + (m + C1Sweep::Q - 1) / C1Sweep::Q;
  if (blocks > 0 && b > 0) {
    nn_dual_kernel<<<dim3(blocks, b), NN_WARPS * 32, 0,
                     (cudaStream_t)stream>>>(
        (const float*)x, (const float*)y, (const unsigned char*)x_valid,
        (const unsigned char*)y_valid, n, m, (float*)d_xy, (long long*)i_xy,
        (float*)d_yx, (long long*)i_yx);
  }
  return (int)cudaGetLastError();
}
