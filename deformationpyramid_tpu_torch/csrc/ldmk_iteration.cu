// C5 ldmk_iteration: one whole landmark-only solver iteration (LNDP level
// loop with w_cd = 0) in one launch.
//
// Replaces the JAX package's ops/fused_iteration.py _ldmk_iter_kernel
// (run_fused_level_ldmk). Per launch:
//   1. an iteration that starts halted (done set, or it >= iters) returns
//      at once in every block and changes nothing, so the host may read
//      the stop flag only every few iterations;
//   2. every block warps its tile of TP landmark rows (level_tile.cuh
//      forward_tile + motion_fwd) and writes them to `aux`;
//   3. the masked residual d = (warped - tgt) * mask gives the block's
//      share of sum(d^2) (summed over its rows in a fixed order) and the
//      cotangent (2 / count) d, which needs no cross-block value;
//   4. the block's VJP (level_tile.cuh backward_tile) goes into its own
//      row of an [n_blocks, P] buffer, as in C3;
//   5. a grid-wide barrier (cooperative launch: every block is resident);
//   6. every block sums the loss shares in block order and takes the same
//      3-way early-stop decision (solve/loop.py) from the state it read
//      before the barrier; block 0 writes the new state;
//   7. unless the decision stops, every block sums the gradient rows in
//      block order for its own slice of the parameters and applies the
//      optax-exact Adam step to that slice of p, m, v in place.
// No atomics: the result does not depend on block scheduling.
//
// The TPU kernel held all ~2000 rows in VMEM and reduced them in one
// program; Hopper needs ~64 blocks for 2048 rows, and the cross-block sum
// (64 x 34,694 partials, 8.9 MB) is spread over all of them after the
// barrier: one SM alone reads it at ~20 GB/s, too few loads in flight.
//
// What bounds it: at 2048 rows, width 128, depth 3, the forward and VJP
// (~0.5 GFLOP over 64 blocks), as in C3. The cooperative launch needs the
// whole grid resident: at width 128 two blocks an SM (85 KB of shared
// memory each), i.e. 264 blocks or 8448 rows on an H100; a larger grid is
// refused at launch.
#include <cooperative_groups.h>

#include "level_tile.cuh"

#define LDMK_TP 32

struct StopState {
  const float* count;      // clamp(sum(mask), 1)
  float* loss;             // loss of the last iteration that ran
  float* loss_prev;        // loss of the last iteration that stepped
  int* counter;            // plateau counter
  unsigned char* done;     // bool
  int* it;                 // iterations run
  float* applied;          // Adam steps taken
  int iters, max_break;
  float thr_ratio, loss_eps;
};

struct AdamArgs {
  float lr, b1, b2, c1, c2, eps;
};

// The register bound of C3 (level_warp.cu), whose body this kernel shares.
template <int TP, int MOTION, int FMT>
__global__ void __launch_bounds__(DP_MAX_WIDTH, 2)
    ldmk_iteration_kernel(float* __restrict__ prm, float* __restrict__ m,
                          float* __restrict__ v, const float* __restrict__ x,
                          const float* __restrict__ tgt,
                          const float* __restrict__ mask, int n,
                          const LevelLayout L, float freq, float scale,
                          StopState st, AdamArgs ad,
                          float* __restrict__ partial,
                          float* __restrict__ ploss,
                          float* __restrict__ aux) {
  constexpr int HS = HeadCount<MOTION, FMT>::value;
  if (*st.done || *st.it >= st.iters) return;   // uniform over the grid
  // The state as it was before this iteration; block 0 overwrites it
  // after the barrier.
  const float loss_prev = *st.loss_prev;
  const int counter0 = *st.counter;
  const float applied0 = *st.applied;
  const int it0 = *st.it;
  const float count = *st.count;

  extern __shared__ float sm[];
  __shared__ bool s_hold;
  float* xs = sm;
  float* fea = xs + TP * 3;
  float* head = fea + TP * 6;
  float* gs = head + TP * HS;
  float* gh = gs + TP * 3;
  float* acts = gh + TP * HS;
  float* dA = acts + L.depth * TP * L.w;
  float* dB = dA + TP * L.w;
  const int base = blockIdx.x * TP;

  load_rows<TP>(x, n, base, xs);
  __syncthreads();
  forward_tile<TP, MOTION, FMT>(prm, L, freq, scale, xs, fea, head, acts,
                                true);

  // Warp, residual and cotangent: thread p < TP takes row p (warp 0).
  if (threadIdx.x < 32) {
    float sq = 0.f;
    for (int p = threadIdx.x; p < TP; p += 32) {
      const int row = base + p;
      float o[3];
      motion_fwd<MOTION, FMT>(head + p * HS, xs + p * 3, o);
      for (int k = 0; k < 3; ++k) {
        float d = 0.f;
        if (row < n) {
          aux[row * 3 + k] = o[k];
          d = (o[k] - tgt[row * 3 + k]) * mask[row];
        }
        sq += d * d;
        gs[p * 3 + k] = (2.f / count) * d;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_down_sync(0xffffffffu, sq, off);
    if (threadIdx.x == 0) ploss[blockIdx.x] = sq;
  }
  __syncthreads();
  backward_tile<TP, MOTION, FMT>(prm, L, scale, xs, fea, head, gs, gh, acts,
                                 dA, dB,
                                 partial + (size_t)blockIdx.x * L.total);

  cooperative_groups::this_grid().sync();

  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (unsigned b = 0; b < gridDim.x; ++b) tot += __ldcg(ploss + b);
    const float loss = tot / count;
    const bool small = loss < st.loss_eps;
    const bool plateau = fabsf(loss_prev - loss) < loss_prev * st.thr_ratio;
    const int counter = counter0 + (plateau ? 1 : 0);
    const bool done = small || counter >= st.max_break;
    s_hold = done;
    if (blockIdx.x == 0) {
      *st.counter = counter;
      *st.done = done ? 1 : 0;
      *st.loss = loss;
      *st.it = it0 + 1;
      if (!done) {
        *st.loss_prev = loss;
        *st.applied = applied0 + 1.f;
      }
    }
  }
  __syncthreads();
  if (s_hold) return;
  const int P = L.total;
  const int per = (P + gridDim.x - 1) / gridDim.x;
  const int hi = min(P, (int)(blockIdx.x + 1) * per);
  for (int i = blockIdx.x * per + threadIdx.x; i < hi; i += blockDim.x) {
    float g = 0.f;
    for (unsigned b = 0; b < gridDim.x; ++b)
      g += __ldcg(partial + (size_t)b * P + i);
    adam_update(prm + i, m + i, v + i, g, applied0 + 1.f, ad.lr, ad.b1,
                ad.b2, ad.c1, ad.c2, ad.eps);
  }
}

extern "C" int dp_ldmk_iteration(
    void* prm, void* m, void* v, const void* x, const void* tgt,
    const void* mask, int n, int width, int depth, int motion, int fmt,
    float freq, float scale, const void* count, void* loss, void* loss_prev,
    void* counter, void* done, void* it, void* applied, int iters,
    int max_break, float thr_ratio, float loss_eps, float lr, float b1,
    float b2, float c1, float c2, float eps, void* partial, void* ploss,
    void* aux, int n_rows, void* stream) {
  if (!layout_supported(width, depth, motion, fmt)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // The caller sizes `partial` as [n_rows, P] and `ploss` as [n_rows].
  const int blocks = (n + LDMK_TP - 1) / LDMK_TP;
  if (n_rows != blocks) return (int)cudaErrorInvalidValue;
  const LevelLayout L = level_layout(width, depth, motion, fmt);
  const size_t smem = sizeof(float) * bwd_tile_floats(LDMK_TP, width, depth, L.hs);
  StopState st = {(const float*)count, (float*)loss, (float*)loss_prev,
                  (int*)counter, (unsigned char*)done, (int*)it,
                  (float*)applied, iters, max_break, thr_ratio, loss_eps};
  AdamArgs ad = {lr, b1, b2, c1, c2, eps};
  float* p_prm = (float*)prm;
  float* p_m = (float*)m;
  float* p_v = (float*)v;
  const float* p_x = (const float*)x;
  const float* p_tgt = (const float*)tgt;
  const float* p_mask = (const float*)mask;
  float* p_partial = (float*)partial;
  float* p_ploss = (float*)ploss;
  float* p_aux = (float*)aux;
  void* args[] = {&p_prm, &p_m, &p_v, &p_x, &p_tgt, &p_mask, &n,
                  (void*)&L, &freq, &scale, &st, &ad, &p_partial, &p_ploss,
                  &p_aux};
  return (int)dispatch_layout(motion, fmt, [&](auto mo, auto r) {
    auto kernel = ldmk_iteration_kernel<LDMK_TP, decltype(mo)::value,
                                        decltype(r)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    return cudaLaunchCooperativeKernel((const void*)kernel, blocks,
                                       threads_for(width), args, smem,
                                       (cudaStream_t)stream);
  });
}
