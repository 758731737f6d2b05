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
// What bounds it: N*M distance evaluations (1.5e9 pairs at the ED pair's
// 40159 x 37417); the inputs are under 1 MB, so operations bound it, not
// bytes. The exact difference form cannot use the FMA (8 flops a pair as
// 3 subtracts, 3 multiplies and 2 adds, then a compare and two selects: ~12
// instructions a pair, ~0.55 ms of issue at that shape); the function's
// bound counts the 8 flops at the FMA rate. The TPU kernel kept the whole
// database in VMEM and swept [tn, tm] tiles of the expanded distance
// through the matrix unit. Here it is C1's x->y half (nn_sweep.cuh): a
// block of WARPS warps takes 32 x QPL queries, QPL a lane (one broadcast
// candidate load feeds them all), and splits the database into WARPS
// contiguous slices, one a warp, streamed through shared memory as float4s
// with an invalid row staged as NaN; the slices' (min, argmin) pairs are
// merged by the (d, i) rule. The shape picks the first of three
// configurations whose grid fills the SMs: NNA_WARPS warps with NNA_QPL
// queries a lane (from ~8.4k queries on; ~40k at the ED pair), 16 warps
// with one, and, where ceil(N / 32) blocks would leave SMs idle (2000
// queries: 63 blocks), 16 warps whose lanes split into two groups of 16
// with a slice each: 16 queries a block, 32 slices a query.
//
// Semantics (the port's, not the TPU's; bit-equal to C1's x->y half and
// to the one-query-a-thread kernel this design replaced): the distance is
// the exact difference form (qx-px)^2 + (qy-py)^2 + (qz-pz)^2, summed left
// to right with no FMA contraction, never |q|^2 + |p|^2 - 2 q.p as the TPU
// kernel computes it; candidates are visited in increasing index order
// with a strict '<' and the slices merged by the (d, i) rule, so an exact
// tie goes to the first index; a database row whose valid flag is 0 never
// wins (y_valid may be null: every row valid); a query with no valid
// candidate returns (+inf, 0). No atomics: the result is deterministic.
#include "nn_sweep.cuh"

#define NNA_WARPS 8                // slices a block at the large shapes
#define NNA_QPL 2                  // queries a lane at the large shapes

template <int WARPS, int G, int QPL>
__global__ void __launch_bounds__(WARPS * 32)
nn_argmin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const unsigned char* __restrict__ y_valid, int n, int m,
                 float* __restrict__ out_d, long long* __restrict__ out_i) {
  using S = NNSweep<WARPS, G, QPL>;
  __shared__ typename S::Smem sm;

  const int q0 = blockIdx.x * S::Q;
  const int lane = threadIdx.x & 31;
  NNDistPlain<QPL> dist;
#pragma unroll
  for (int r = 0; r < QPL; ++r) {
    const int qi = q0 + S::query_of(lane, r);
    dist.qx[r] = qi < n ? x[qi * 3 + 0] : 0.f;
    dist.qy[r] = qi < n ? x[qi * 3 + 1] : 0.f;
    dist.qz[r] = qi < n ? x[qi * 3 + 2] : 0.f;
  }
  const NNStageNaN<true> stage{y, y_valid};
  nn_sweep<WARPS, G, QPL>(sm, stage, dist, m);
  __syncthreads();

  if (threadIdx.x < S::Q) {
    const int p = threadIdx.x;
    float d;
    int i;
    nn_merge<WARPS, G, QPL>(sm, p, d, i);
    if (q0 + p < n) {
      out_d[q0 + p] = d;
      out_i[q0 + p] = i == NN_NONE ? 0 : i;
    }
  }
}

// One configuration's launch when its grid fills the SMs (or `always`).
template <int WARPS, int G, int QPL>
static bool nn_argmin_launch(const void* x, const void* y,
                             const void* y_valid, int n, int m, void* out_d,
                             void* out_i, cudaStream_t st, int sms,
                             bool always) {
  const int q = NNSweep<WARPS, G, QPL>::Q;
  const int blocks = (n + q - 1) / q;
  if (blocks < sms && !always) return false;
  nn_argmin_kernel<WARPS, G, QPL><<<blocks, WARPS * 32, 0, st>>>(
      (const float*)x, (const float*)y, (const unsigned char*)y_valid, n, m,
      (float*)out_d, (long long*)out_i);
  return true;
}

extern "C" int dp_nn_argmin(const void* x, const void* y, const void* y_valid,
                            int n, int m, void* out_d, void* out_i,
                            void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaStream_t st = (cudaStream_t)stream;
  if (!nn_argmin_launch<NNA_WARPS, 1, NNA_QPL>(x, y, y_valid, n, m, out_d,
                                               out_i, st, sms, false)
      && !nn_argmin_launch<16, 1, 1>(x, y, y_valid, n, m, out_d, out_i, st,
                                     sms, false))
    nn_argmin_launch<16, 2, 1>(x, y, y_valid, n, m, out_d, out_i, st, sms,
                               true);
  return (int)cudaGetLastError();
}
