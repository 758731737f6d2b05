#pragma once
// C2 level_warp_fwd and C3 level_warp_bwd: one pyramid level's warp
// (SE3, Sim3 or sflow motion; axis-angle, XYZ-Euler, quaternion or 6D
// rotation; with or without the nonrigidity head) and its parameter VJP.
// The kernels and their host launchers; level_warp.cu instantiates them
// without the nonrigidity head and holds the C entry points,
// level_warp_nr.cu instantiates them with it (two sources, so that nvcc
// builds the two halves in parallel).
//
// C2 replaces the warp half of the JAX package's kernel 1
// (ops/fused_iteration.py _fwd_sweep_kernel, through
// ops/fused_level.py _forward_math_t), its warp-only kernel
// (_warp_only_kernel, the sweep-reuse iterations) and the standalone level
// warp (ops/fused_level.py _fwd_kernel, _fwd_kernel_t); C3 replaces the VJP
// half of kernel 2 (ops/fused_iteration.py _bwd_adam_kernel) and, followed
// by C13 sum_partials (adam.cu), the standalone VJP (ops/fused_level.py
// _bwd_kernel, _bwd_kernel_t).
//
// The math, per point x: posenc at one frequency, a 6->w ReLU layer,
// (depth-1) w->w ReLU layers, the rotation, translation and (Sim3) scale
// heads scaled by mlp_scale, then out = s R x + t (common.cuh motion_fwd;
// SE3: s = 1; Sim3: s = head + 1; sflow: out = x + t, no rotation head);
// with the nonrigidity head, nr = sigmoid(mlp_scale (h w_nr + b_nr)) and
// at level > 0 out = x + nr (out - x) (level_tile_tc.cuh point_warp); C2
// writes nr beside the points and C3 takes its cotangent.
//
// Both run one tile code, level_tile_tc.cuh: the width x width products
// as 3xTF32 on the tensor cores, everything else full-precision
// sinf/cosf/sqrtf and f32 FMAs (the axis-angle VJP divides by theta ~ 1e-3,
// so the build uses no fast-math). C2 is its forward (c3_forward), so C2's
// warp is bit for bit the function whose VJP C3 computes.
//
// What bounds them: ~2 * 34k flops per point and direction at width 128,
// depth 3 (0.14 GFLOP forward, ~0.3 GFLOP backward for 2000 points), far
// below the card's rates; the launch and the serial layer chain (each
// product a chain of k-steps of three dependent mma.sync) set the time.
// A block of 16 warps takes a tile of whole 16-point m-tiles that the host
// sizes so that the grid fills the card once (2000 points: 125 blocks of
// 16; 6000: 125 of 48).
//
// C2 keeps two ping-pong activation buffers; C3 recomputes the forward for
// its tile (as the TPU kernel did, rather than storing activations between
// launches), keeping every layer's activations, backpropagates through the
// motion, the heads, the hidden layers and the input layer, and writes its
// own partial gradient vector into row blockIdx.x of an [n_blocks, P]
// buffer. The TPU kernel accumulated across its sequential grid; blocks on
// Hopper run in parallel, so the sum over blocks happens in a fixed order
// in C4 (adam.cu) and no atomics are needed. The buffers exceed the 48 KB
// static limit at larger tiles, so both raise the kernel's dynamic
// shared-memory limit before their launch.
#include "level_tile_tc.cuh"

// Each kernel is instantiated for every (motion, format) pair
// (common.cuh dispatch_layout: nine of them) and for NR in {false, true},
// so the per-point head arrays have a compile-time size (3 to 11 floats)
// and stay in registers.

// One block of C3_THREADS threads a tile of `tp` points (a multiple of
// C3_MT): the forward, then one thread a point warps it and, with NR,
// writes its nonrigidity.
template <int MOTION, int FMT, bool NR>
__global__ void __launch_bounds__(C3_THREADS, 1)
    level_warp_fwd_kernel(const float* __restrict__ prm,
                          const float* __restrict__ x, int n,
                          const LevelLayout L, int tp, float freq,
                          float scale, bool gate, float* __restrict__ out,
                          float* __restrict__ nr_out) {
  constexpr int HS = HeadCount<MOTION, FMT, NR>::value;
  const int ld = c3_ld(L.w);
  extern __shared__ float sm[];
  float* acts = sm;
  float* xs = acts + 2 * tp * ld;
  float* fea = xs + tp * 3;
  float* head = fea + tp * 6;
  const int base = blockIdx.x * tp;

  load_rows(x, n, base, tp, xs);
  __syncthreads();
  c3_forward<MOTION, FMT, NR, false>(prm, L, tp, freq, scale, xs, fea, head,
                                     acts);

  for (int p = threadIdx.x; p < tp; p += blockDim.x) {
    if (base + p >= n) continue;
    float o[3];
    const float nr = point_warp<MOTION, FMT, NR>(head + p * HS, xs + p * 3,
                                                 gate, o);
    for (int k = 0; k < 3; ++k) out[(base + p) * 3 + k] = o[k];
    if constexpr (NR) nr_out[base + p] = nr;
  }
}

// One block of C3_THREADS threads a tile of `tp` points (a multiple of
// C3_MT). One block an SM: at n = 2000 the grid has one block for each SM
// anyway.
template <int MOTION, int FMT, bool NR>
__global__ void __launch_bounds__(C3_THREADS, 1)
    level_warp_bwd_kernel(const float* __restrict__ prm,
                          const float* __restrict__ x,
                          const float* __restrict__ g,
                          const float* __restrict__ g_nr, int n,
                          const LevelLayout L, int tp, float freq,
                          float scale, bool gate,
                          float* __restrict__ partial) {
  constexpr int HS = HeadCount<MOTION, FMT, NR>::value;
  const int ld = c3_ld(L.w);
  extern __shared__ float sm[];
  float* acts = sm;
  float* dA = acts + L.depth * tp * ld;
  float* dB = dA + tp * ld;
  float* xs = dB + tp * ld;
  float* gs = xs + tp * 3;
  float* fea = gs + tp * 3;
  float* head = fea + tp * 6;
  float* gh = head + tp * HS;
  float* gnr = gh + tp * HS;
  const int base = blockIdx.x * tp;

  load_rows(x, n, base, tp, xs);
  load_rows(g, n, base, tp, gs);
  if constexpr (NR) {
    for (int p = threadIdx.x; p < tp; p += blockDim.x)
      gnr[p] = base + p < n ? g_nr[base + p] : 0.f;
  }
  __syncthreads();
  c3_tile<MOTION, FMT, NR>(prm, L, tp, freq, scale, gate, xs, gs, gnr, fea,
                           head, gh, acts, dA, dB,
                           partial + (size_t)blockIdx.x * L.total);
}

template <bool NR>
cudaError_t launch_level_warp_fwd(const void* prm, const void* x, int n,
                                  int width, int depth, int motion, int fmt,
                                  bool gate, float freq, float scale,
                                  void* out, void* nr_out, int tile,
                                  void* stream) {
  const int blocks = (n + tile - 1) / tile;
  const LevelLayout L = level_layout(width, depth, motion, fmt, NR);
  const size_t smem = sizeof(float) * c2_smem_floats(tile, width, L.hs);
  return dispatch_layout(motion, fmt, [&](auto m, auto r) {
    auto kernel = level_warp_fwd_kernel<decltype(m)::value,
                                        decltype(r)::value, NR>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, C3_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)prm, (const float*)x, n, L, tile, freq, scale, gate,
        (float*)out, (float*)nr_out);
    return cudaGetLastError();
  });
}

template <bool NR>
cudaError_t launch_level_warp_bwd(const void* prm, const void* x,
                                  const void* g, const void* g_nr, int n,
                                  int width, int depth, int motion, int fmt,
                                  bool gate, float freq, float scale,
                                  void* partial, int tile, void* stream) {
  const int blocks = (n + tile - 1) / tile;
  const LevelLayout L = level_layout(width, depth, motion, fmt, NR);
  const size_t smem =
      sizeof(float) * c3_smem_floats(tile, width, depth, L.hs, NR);
  return dispatch_layout(motion, fmt, [&](auto m, auto r) {
    auto kernel = level_warp_bwd_kernel<decltype(m)::value,
                                        decltype(r)::value, NR>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, C3_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)prm, (const float*)x, (const float*)g,
        (const float*)g_nr, n, L, tile, freq, scale, gate, (float*)partial);
    return cudaGetLastError();
  });
}

// The nonrigid instantiations, built in level_warp_nr.cu.
cudaError_t launch_level_warp_fwd_nr(const void* prm, const void* x, int n,
                                     int width, int depth, int motion,
                                     int fmt, bool gate, float freq,
                                     float scale, void* out, void* nr_out,
                                     int tile, void* stream);
cudaError_t launch_level_warp_bwd_nr(const void* prm, const void* x,
                                     const void* g, const void* g_nr, int n,
                                     int width, int depth, int motion,
                                     int fmt, bool gate, float freq,
                                     float scale, void* partial, int tile,
                                     void* stream);
