// C5 ldmk_iteration: one whole landmark-only solver iteration (LNDP level
// loop with w_cd = 0) in one launch.
//
// Replaces the JAX package's ops/fused_iteration.py _ldmk_iter_kernel
// (run_fused_level_ldmk). Per launch:
//   1. an iteration that starts halted (done set, or it >= iters) returns
//      at once in every block and changes nothing, so the host may read
//      the stop flag only every few iterations;
//   2. every block takes tiles of tp landmark rows (whole 16-row m-tiles),
//      tile b, b + G, ... for block b of G, and for each runs the level's
//      forward (level_tile_tc.cuh c3_forward, C2's and C3's code: the
//      hidden layers as 3xTF32 on the tensor cores) and the motion warp,
//      and writes the warped rows to `aux`;
//   3. the masked residual d = (warped - tgt) * mask gives the tile's share
//      of sum(d^2) (summed in a fixed order) and the cotangent (2 / count) d,
//      which needs no cross-block value;
//   4. a tile whose d is exactly zero on every row (every mask 0 and every
//      warped row finite: a non-finite warp or target times a mask of 0 is
//      NaN and keeps its VJP) has a zero cotangent and skips its VJP;
//      otherwise the VJP (c3_backward, C3's code) goes into the block's own
//      row of a [G, P] buffer, added in tile order to the block's earlier
//      tiles; the block marks its row full (`full`) and writes its loss
//      share, both before
//   5. a grid-wide barrier (cooperative launch: every block is resident);
//   6. every block sums the loss shares in the same fixed order and takes
//      the same 3-way early-stop decision (solve/loop.py) from the state it
//      read before the barrier; block 0 writes the new state;
//   7. unless the decision stops, every block sums the full rows in block
//      order for its own contiguous slice of the parameters and applies the
//      optax-exact Adam step to that slice of p, m, v in place. The rows it
//      leaves out hold exact zeros: a sequential sum from +0 that drops them
//      gives the same bits up to the sign of a zero sum, which Adam maps to
//      the same p, m and v.
// No atomics: the result does not depend on block scheduling.
//
// The TPU kernel held all ~2000 rows in VMEM and reduced them in one
// program. Here the grid is as many blocks of C3_THREADS as fit on the card
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs, one
// block an SM), or the tile count where that is smaller; the host sizes the
// tile by C3's one-wave rule (ops/fused_iteration.py bwd_tile: 2048 rows ->
// 128 blocks of 16, 4096 -> 128 of 32) and asks dp_ldmk_blocks for G.
//
// What bounds it: at 2048 valid rows, width 128, depth 3, the forward and
// the VJP as in C3; on the lndp path (4096 rows, ~30 valid) the forward of
// every tile and the few VJPs of the tiles that hold a valid row, then the
// barrier and the Adam step over the full rows.
#include <cooperative_groups.h>

#include "level_tile_tc.cuh"

#define LDMK_MAX_ROWS (1 << 24)   // the landmark rows one launch takes
#define LDMK_BATCH 16             // partial rows loaded at once a thread
#define LDMK_STATIC_SMEM 128      // bytes of the kernel's static shared
                                  // memory, kept free beside the tile

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

template <int MOTION, int FMT>
__global__ void __launch_bounds__(C3_THREADS, 1)
    ldmk_iteration_kernel(float* __restrict__ prm, float* __restrict__ m,
                          float* __restrict__ v, const float* __restrict__ x,
                          const float* __restrict__ tgt,
                          const float* __restrict__ mask, int n,
                          const LevelLayout L, int tp, float freq,
                          float scale, StopState st, AdamArgs ad,
                          float* __restrict__ partial, int* __restrict__ full,
                          float* __restrict__ ploss,
                          float* __restrict__ aux) {
  constexpr int HS = HeadCount<MOTION, FMT, false>::value;
  if (*st.done || *st.it >= st.iters) return;   // uniform over the grid
  // The state as it was before this iteration; block 0 overwrites it
  // after the barrier.
  const float loss_prev = *st.loss_prev;
  const int counter0 = *st.counter;
  const float applied0 = *st.applied;
  const int it0 = *st.it;
  const float count = *st.count;

  const int ld = c3_ld(L.w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ float sm[];
  __shared__ float s_red[C3_WARPS];
  __shared__ bool s_hold;
  __shared__ int s_nfull;
  float* acts = sm;
  float* dA = acts + L.depth * tp * ld;
  float* dB = dA + tp * ld;
  float* xs = dB + tp * ld;
  float* gs = xs + tp * 3;
  float* fea = gs + tp * 3;
  float* head = fea + tp * 6;
  float* gh = head + tp * HS;
  float* part = partial + (size_t)blockIdx.x * L.total;

  const int tiles = (n + tp - 1) / tp;
  float share = 0.f;     // the block's loss share (thread 0)
  bool have = false;     // the block's row holds a VJP
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int base = t * tp;
    load_rows(x, n, base, tp, xs);
    __syncthreads();
    c3_forward<MOTION, FMT, false, true>(prm, L, tp, freq, scale, xs, fea,
                                         head, acts);

    // Warp, residual and cotangent, one thread a row.
    float sq = 0.f;
    int nz = 0;
    for (int p = threadIdx.x; p < tp; p += blockDim.x) {
      const int row = base + p;
      float o[3];
      point_warp<MOTION, FMT, false>(head + p * HS, xs + p * 3, false, o);
      for (int k = 0; k < 3; ++k) {
        float d = 0.f;
        if (row < n) {
          aux[row * 3 + k] = o[k];
          d = (o[k] - tgt[row * 3 + k]) * mask[row];
        }
        sq = fmaf(d, d, sq);
        nz |= d != 0.f;   // NaN too
        gs[p * 3 + k] = (2.f / count) * d;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_down_sync(0xffffffffu, sq, off);
    if (lane == 0) s_red[warp] = sq;
    const bool vjp = __syncthreads_or(nz) != 0;
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < C3_WARPS; ++w) s += s_red[w];
      share += s;
    }
    if (vjp && have) {
      c3_backward<MOTION, FMT, false, true>(prm, L, tp, scale, false, xs, gs,
                                            nullptr, fea, head, gh, acts, dA,
                                            dB, part);
    } else if (vjp) {
      c3_backward<MOTION, FMT, false>(prm, L, tp, scale, false, xs, gs,
                                      nullptr, fea, head, gh, acts, dA, dB,
                                      part);
      have = true;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    ploss[blockIdx.x] = share;
    full[blockIdx.x] = have ? 1 : 0;
  }

  cooperative_groups::this_grid().sync();

  const int G = gridDim.x;
  if (warp == 0) {
    // The loss: lane l sums the shares l, l + 32, ... in order, then a
    // fixed shuffle tree; every block gets the same bits.
    float tot = 0.f;
    for (int b = lane; b < G; b += 32) tot += __ldcg(ploss + b);
    for (int off = 16; off > 0; off >>= 1)
      tot += __shfl_down_sync(0xffffffffu, tot, off);
    // The full rows in block order, into shared memory.
    int* rows = reinterpret_cast<int*>(sm);
    int nf = 0;
    for (int b0 = 0; b0 < G; b0 += 32) {
      const int b = b0 + lane;
      const bool f = b < G && __ldcg(full + b) != 0;
      const unsigned ball = __ballot_sync(0xffffffffu, f);
      if (f) rows[nf + __popc(ball & ((1u << lane) - 1u))] = b;
      nf += __popc(ball);
    }
    if (lane == 0) {
      const float loss = tot / count;
      const bool small = loss < st.loss_eps;
      const bool plateau = fabsf(loss_prev - loss) < loss_prev * st.thr_ratio;
      const int counter = counter0 + (plateau ? 1 : 0);
      const bool done = small || counter >= st.max_break;
      s_hold = done;
      s_nfull = nf;
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
  }
  __syncthreads();
  if (s_hold) return;
  const int* rows = reinterpret_cast<const int*>(sm);
  const int nf = s_nfull;
  const int P = L.total;
  const int per = (P + G - 1) / G;
  const int hi = min(P, (int)(blockIdx.x + 1) * per);
  for (int i = blockIdx.x * per + threadIdx.x; i < hi; i += blockDim.x) {
    float g = 0.f;
    int r = 0;
    for (; r + LDMK_BATCH <= nf; r += LDMK_BATCH) {
      float q[LDMK_BATCH];
#pragma unroll
      for (int u = 0; u < LDMK_BATCH; ++u)
        q[u] = __ldcg(partial + (size_t)rows[r + u] * P + i);
#pragma unroll
      for (int u = 0; u < LDMK_BATCH; ++u) g += q[u];
    }
    for (; r < nf; ++r) g += __ldcg(partial + (size_t)rows[r] * P + i);
    adam_update(prm + i, m + i, v + i, g, applied0 + 1.f, ad.lr, ad.b1,
                ad.b2, ad.c1, ad.c2, ad.eps);
  }
}

// The grid for n rows in tiles of `tile`: every tile its block where the
// card holds them all at once, else as many blocks as it holds (each then
// loops over its tiles). Sets the kernel's shared-memory limit on the way.
template <typename K>
static cudaError_t ldmk_grid(K kernel, int n, int tile, size_t smem,
                             int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      C3_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (n + tile - 1) / tile;
  *grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  return cudaSuccess;
}

static bool ldmk_shape_ok(int n, int width, int depth, int motion, int fmt,
                          int tile) {
  if (!layout_supported(width, depth, motion, fmt)) return false;
  const LevelLayout L = level_layout(width, depth, motion, fmt);
  return n >= 1 && n <= LDMK_MAX_ROWS && tile >= C3_MT &&
         tile % C3_MT == 0 &&
         sizeof(float) * c3_smem_floats(tile, width, depth, L.hs, false) +
                 LDMK_STATIC_SMEM <=
             C3_SMEM_LIMIT;
}

// The number of blocks (and partial rows) C5 takes for n rows in tiles of
// `tile` on the current device; a negative CUDA error code if it cannot.
extern "C" int dp_ldmk_blocks(int n, int width, int depth, int motion,
                              int fmt, int tile) {
  if (!ldmk_shape_ok(n, width, depth, motion, fmt, tile))
    return -(int)cudaErrorInvalidValue;
  const LevelLayout L = level_layout(width, depth, motion, fmt);
  const size_t smem =
      sizeof(float) * c3_smem_floats(tile, width, depth, L.hs, false);
  int grid = 0;
  const cudaError_t err = dispatch_layout(motion, fmt, [&](auto mo, auto r) {
    return ldmk_grid(ldmk_iteration_kernel<decltype(mo)::value,
                                           decltype(r)::value>,
                     n, tile, smem, &grid);
  });
  return err == cudaSuccess ? grid : -(int)err;
}

extern "C" int dp_ldmk_iteration(
    void* prm, void* m, void* v, const void* x, const void* tgt,
    const void* mask, int n, int width, int depth, int motion, int fmt,
    float freq, float scale, const void* count, void* loss, void* loss_prev,
    void* counter, void* done, void* it, void* applied, int iters,
    int max_break, float thr_ratio, float loss_eps, float lr, float b1,
    float b2, float c1, float c2, float eps, void* partial, void* full,
    void* ploss, void* aux, int n_rows, int tile, void* stream) {
  if (n <= 0 && layout_supported(width, depth, motion, fmt))
    return (int)cudaGetLastError();
  // The caller picks the tile (ops/fused_iteration.py bwd_tile) and sizes
  // `partial` as [n_rows, P], `full` and `ploss` as [n_rows], n_rows from
  // dp_ldmk_blocks.
  if (!ldmk_shape_ok(n, width, depth, motion, fmt, tile))
    return (int)cudaErrorInvalidValue;
  const LevelLayout L = level_layout(width, depth, motion, fmt);
  const size_t smem =
      sizeof(float) * c3_smem_floats(tile, width, depth, L.hs, false);
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
  int* p_full = (int*)full;
  float* p_ploss = (float*)ploss;
  float* p_aux = (float*)aux;
  void* args[] = {&p_prm, &p_m, &p_v, &p_x, &p_tgt, &p_mask, &n,
                  (void*)&L, &tile, &freq, &scale, &st, &ad, &p_partial,
                  &p_full, &p_ploss, &p_aux};
  return (int)dispatch_layout(motion, fmt, [&](auto mo, auto r) {
    auto kernel = ldmk_iteration_kernel<decltype(mo)::value,
                                        decltype(r)::value>;
    int grid = 0;
    cudaError_t err = ldmk_grid(kernel, n, tile, smem, &grid);
    if (err != cudaSuccess) return err;
    if (n_rows != grid) return cudaErrorInvalidValue;
    return cudaLaunchCooperativeKernel((const void*)kernel, grid, C3_THREADS,
                                       args, smem, (cudaStream_t)stream);
  });
}
