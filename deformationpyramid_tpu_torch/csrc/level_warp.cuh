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
// at level > 0 out = x + nr (out - x) (level_tile.cuh point_warp); C2
// writes nr beside the points and C3 takes its cotangent.
// Full-precision sinf/cosf/sqrtf and plain
// f32 FMAs: the axis-angle VJP divides by theta ~ 1e-3, so the build uses
// no fast-math.
//
// What bounds them: ~2 * 34k flops per point and direction at width 128,
// depth 3 (0.14 GFLOP forward, ~0.3 GFLOP backward for 2000 points), far
// below the card's f32 rate; the launch, the serial layer chain and
// shared-memory traffic set the time. Design: level_tile.cuh.
//
// C3 recomputes the forward for its tile (as the TPU kernel did, rather
// than storing activations between launches), backpropagates through the
// motion, the heads, the hidden layers and the input layer, and writes
// its own partial gradient vector into row blockIdx.x of an
// [n_blocks, P] buffer. The TPU kernel accumulated across its sequential
// grid; blocks on Hopper run in parallel, so the sum over blocks happens
// in a fixed order in C4 (adam.cu) and no atomics are needed. All depth
// layers of TP x width activations plus two gradient buffers exceed the
// 48 KB static limit (84 KB at width 128, depth 3), so C3 raises the
// kernel's dynamic shared-memory limit before its launch.
#include "level_tile.cuh"

#define FWD_TP 32
#define BWD_TP 32

// Each kernel is instantiated for every (motion, format) pair
// (common.cuh dispatch_layout: nine of them) and for NR in {false, true},
// so the per-point head arrays have a compile-time size (3 to 11 floats)
// and stay in registers.

template <int TP, int MOTION, int FMT, bool NR>
__global__ void level_warp_fwd_kernel(const float* __restrict__ prm,
                                      const float* __restrict__ x, int n,
                                      const LevelLayout L, float freq,
                                      float scale, bool gate,
                                      float* __restrict__ out,
                                      float* __restrict__ nr_out) {
  constexpr int HS = HeadCount<MOTION, FMT, NR>::value;
  extern __shared__ float sm[];
  float* xs = sm;
  float* fea = xs + TP * 3;
  float* head = fea + TP * 6;
  float* acts = head + TP * HS;
  const int base = blockIdx.x * TP;

  load_rows<TP>(x, n, base, xs);
  __syncthreads();
  forward_tile<TP, MOTION, FMT, NR>(prm, L, freq, scale, xs, fea, head,
                                    acts, false);

  for (int p = threadIdx.x; p < TP; p += blockDim.x) {
    if (base + p >= n) continue;
    float o[3];
    const float nr = point_warp<MOTION, FMT, NR>(head + p * HS, xs + p * 3,
                                                 gate, o);
    for (int k = 0; k < 3; ++k) out[(base + p) * 3 + k] = o[k];
    if constexpr (NR) nr_out[base + p] = nr;
  }
}

// The bound (up to 256 threads, two blocks an SM) lets the compiler keep
// 96 registers a thread; left to itself it took 64 and ran 17% slower on
// an H100 (0.157 against 0.134 ms at 2000 points, width 128, depth 3).
template <int TP, int MOTION, int FMT, bool NR>
__global__ void __launch_bounds__(DP_MAX_WIDTH, 2)
    level_warp_bwd_kernel(const float* __restrict__ prm,
                          const float* __restrict__ x,
                          const float* __restrict__ g,
                          const float* __restrict__ g_nr, int n,
                          const LevelLayout L, float freq, float scale,
                          bool gate, float* __restrict__ partial) {
  constexpr int HS = HeadCount<MOTION, FMT, NR>::value;
  extern __shared__ float sm[];
  float* xs = sm;
  float* fea = xs + TP * 3;
  float* head = fea + TP * 6;
  float* gs = head + TP * HS;
  float* gnr = gs + TP * 3;
  float* gh = gnr + (NR ? TP : 0);
  float* acts = gh + TP * HS;
  float* dA = acts + L.depth * TP * L.w;
  float* dB = dA + TP * L.w;
  const int base = blockIdx.x * TP;

  load_rows<TP>(x, n, base, xs);
  load_rows<TP>(g, n, base, gs);
  if constexpr (NR) {
    for (int p = threadIdx.x; p < TP; p += blockDim.x)
      gnr[p] = base + p < n ? g_nr[base + p] : 0.f;
  }
  __syncthreads();
  forward_tile<TP, MOTION, FMT, NR>(prm, L, freq, scale, xs, fea, head,
                                    acts, true);
  backward_tile<TP, MOTION, FMT, NR>(prm, L, scale, xs, fea, head, gs, gh,
                                     acts, dA, dB,
                                     partial + (size_t)blockIdx.x * L.total,
                                     gnr, gate);
}

template <bool NR>
cudaError_t launch_level_warp_fwd(const void* prm, const void* x, int n,
                                  int width, int depth, int motion, int fmt,
                                  bool gate, float freq, float scale,
                                  void* out, void* nr_out, void* stream) {
  const LevelLayout L = level_layout(width, depth, motion, fmt, NR);
  const size_t smem = sizeof(float) * (FWD_TP * (9 + L.hs) + 2 * FWD_TP * width);
  const int blocks = (n + FWD_TP - 1) / FWD_TP;
  return dispatch_layout(motion, fmt, [&](auto m, auto r) {
    auto kernel = level_warp_fwd_kernel<FWD_TP, decltype(m)::value,
                                        decltype(r)::value, NR>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads_for(width), smem, (cudaStream_t)stream>>>(
        (const float*)prm, (const float*)x, n, L, freq, scale, gate,
        (float*)out, (float*)nr_out);
    return cudaGetLastError();
  });
}

template <bool NR>
cudaError_t launch_level_warp_bwd(const void* prm, const void* x,
                                  const void* g, const void* g_nr, int n,
                                  int width, int depth, int motion, int fmt,
                                  bool gate, float freq, float scale,
                                  void* partial, void* stream) {
  const int blocks = (n + BWD_TP - 1) / BWD_TP;
  const LevelLayout L = level_layout(width, depth, motion, fmt, NR);
  const size_t smem =
      sizeof(float) * bwd_tile_floats(BWD_TP, width, depth, L.hs, NR);
  return dispatch_layout(motion, fmt, [&](auto m, auto r) {
    auto kernel = level_warp_bwd_kernel<BWD_TP, decltype(m)::value,
                                        decltype(r)::value, NR>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads_for(width), smem, (cudaStream_t)stream>>>(
        (const float*)prm, (const float*)x, (const float*)g,
        (const float*)g_nr, n, L, freq, scale, gate, (float*)partial);
    return cudaGetLastError();
  });
}

// The nonrigid instantiations, built in level_warp_nr.cu.
cudaError_t launch_level_warp_fwd_nr(const void* prm, const void* x, int n,
                                     int width, int depth, int motion,
                                     int fmt, bool gate, float freq,
                                     float scale, void* out, void* nr_out,
                                     void* stream);
cudaError_t launch_level_warp_bwd_nr(const void* prm, const void* x,
                                     const void* g, const void* g_nr, int n,
                                     int width, int depth, int motion,
                                     int fmt, bool gate, float freq,
                                     float scale, void* partial,
                                     void* stream);
