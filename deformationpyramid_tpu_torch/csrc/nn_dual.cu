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
// argmins. Here a block of NN_WARPS warps takes NN_Q queries, one a lane,
// and splits the database into NN_WARPS contiguous slices in index order,
// one a warp: every SM gets warps enough to hide the latency of the
// running minimum's compare-and-select chain, and at 2000 + 2000 queries
// the grid (ceil(N/NN_Q) + ceil(M/NN_Q) blocks, the x->y queries first)
// fills the 132 SMs about once. Each warp streams its slice through its
// own NN_STAGE-candidate buffer in shared memory, two candidates a lane
// loaded a tile ahead, as one float4 (x, y, z, pad): a candidate is one
// broadcast 16-byte load that feeds every query of the warp. An invalid
// row, and a pad past the slice's end, is staged with x = NaN, so its
// distance is NaN and never passes the strict '<': no branch on a mask.
// The warps' (min, argmin) partials are then merged through shared memory.
// No atomics and no second launch: the result is deterministic.
//
// Semantics (bit-equal to the one-query-a-thread sweep it replaced, on
// every input): the distance is the exact difference form
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
#include <climits>

#include "common.cuh"

#define NN_WARPS 16                // database slices a block, one a warp
#define NN_Q 32                    // queries a block, one a lane
#define NN_STAGE 64                // candidates a warp stages at a time,
                                   // two a lane
#define NN_NONE INT_MAX            // a slice's index while nothing won

// Candidate j of the slice ending at `hi`, as staged: NaN in x where the
// row is invalid or past the slice.
__device__ __forceinline__ float4 nn_candidate(const float* __restrict__ db,
                                               const unsigned char* __restrict__ dbv,
                                               int j, int hi) {
  float4 c = make_float4(__int_as_float(0x7fffffff), 0.f, 0.f, 0.f);
  if (j < hi) {
    c.y = db[j * 3 + 1];
    c.z = db[j * 3 + 2];
    if (dbv[j]) c.x = db[j * 3 + 0];
  }
  return c;
}

__global__ void __launch_bounds__(NN_WARPS * 32)
nn_dual_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const unsigned char* __restrict__ x_valid,
               const unsigned char* __restrict__ y_valid, int n, int m,
               float* __restrict__ d_xy, long long* __restrict__ i_xy,
               float* __restrict__ d_yx, long long* __restrict__ i_yx) {
  __shared__ float4 stage[NN_WARPS][NN_STAGE];
  __shared__ float part_d[NN_WARPS][NN_Q];
  __shared__ int part_i[NN_WARPS][NN_Q];

  const int bx = (n + NN_Q - 1) / NN_Q;
  const bool xdir = blockIdx.x < (unsigned)bx;
  const float* q = xdir ? x : y;
  const float* db = xdir ? y : x;
  const unsigned char* dbv = xdir ? y_valid : x_valid;
  const int nq = xdir ? n : m;
  const int ndb = xdir ? m : n;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (xdir ? blockIdx.x : blockIdx.x - bx) * NN_Q;
  const int qi = q0 + lane;
  float q_x = 0.f, q_y = 0.f, q_z = 0.f;
  if (qi < nq) {
    q_x = q[qi * 3 + 0];
    q_y = q[qi * 3 + 1];
    q_z = q[qi * 3 + 2];
  }

  // This warp's slice [lo, hi) of the database, in index order.
  const int per = (ndb + NN_WARPS - 1) / NN_WARPS;
  const int lo = min(warp * per, ndb), hi = min(lo + per, ndb);
  float4* st = stage[warp];
  float best = INFINITY;
  int best_i = NN_NONE;
  float4 next0 = nn_candidate(db, dbv, lo + lane, hi);
  float4 next1 = nn_candidate(db, dbv, lo + 32 + lane, hi);
  for (int t = lo; t < hi; t += NN_STAGE) {
    __syncwarp();
    st[lane] = next0;
    st[lane + 32] = next1;
    __syncwarp();
    next0 = nn_candidate(db, dbv, t + NN_STAGE + lane, hi);
    next1 = nn_candidate(db, dbv, t + NN_STAGE + 32 + lane, hi);
#pragma unroll
    for (int k = 0; k < NN_STAGE; ++k) {
      const float4 c = st[k];
      const float dx = __fsub_rn(q_x, c.x);
      const float dy = __fsub_rn(q_y, c.y);
      const float dz = __fsub_rn(q_z, c.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_i = t + k;
      }
    }
  }
  part_d[warp][lane] = best;
  part_i[warp][lane] = best_i;
  __syncthreads();

  if (threadIdx.x < NN_Q) {
    const int p = threadIdx.x;
    float d = part_d[0][p];
    int i = part_i[0][p];
#pragma unroll
    for (int w = 1; w < NN_WARPS; ++w) {
      const float dw = part_d[w][p];
      const int iw = part_i[w][p];
      if (dw < d || (dw == d && iw < i)) {
        d = dw;
        i = iw;
      }
    }
    if (q0 + p < nq) {
      float* out_d = xdir ? d_xy : d_yx;
      long long* out_i = xdir ? i_xy : i_yx;
      out_d[q0 + p] = d;
      out_i[q0 + p] = i == NN_NONE ? 0 : i;
    }
  }
}

extern "C" int dp_nn_dual(const void* x, const void* y, const void* x_valid,
                          const void* y_valid, int n, int m, void* d_xy,
                          void* i_xy, void* d_yx, void* i_yx, void* stream) {
  const int blocks = (n + NN_Q - 1) / NN_Q + (m + NN_Q - 1) / NN_Q;
  if (blocks > 0) {
    nn_dual_kernel<<<blocks, NN_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)y, (const unsigned char*)x_valid,
        (const unsigned char*)y_valid, n, m, (float*)d_xy, (long long*)i_xy,
        (float*)d_yx, (long long*)i_yx);
  }
  return (int)cudaGetLastError();
}
