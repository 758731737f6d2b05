// C2 level_warp_fwd and C3 level_warp_bwd: one pyramid level's warp
// (SE3, Sim3 or sflow motion; axis-angle, XYZ-Euler, quaternion or 6D
// rotation) and its parameter VJP.
//
// C2 replaces the warp half of the JAX package's kernel 1
// (ops/fused_iteration.py _fwd_sweep_kernel, through
// ops/fused_level.py _forward_math_t); C3 replaces the VJP half of kernel 2
// (ops/fused_iteration.py _bwd_adam_kernel).
//
// The math, per point x: posenc at one frequency, a 6->w ReLU layer,
// (depth-1) w->w ReLU layers, the rotation, translation and (Sim3) scale
// heads scaled by mlp_scale, then out = s R x + t (common.cuh motion_fwd;
// SE3: s = 1; Sim3: s = head + 1; sflow: out = x + t, no rotation head).
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
// (common.cuh dispatch_layout: nine of them), so the per-point head arrays
// have a compile-time size (3 to 10 floats) and stay in registers.

template <int TP, int MOTION, int FMT>
__global__ void level_warp_fwd_kernel(const float* __restrict__ prm,
                                      const float* __restrict__ x, int n,
                                      const LevelLayout L, float freq,
                                      float scale, float* __restrict__ out) {
  constexpr int HS = HeadCount<MOTION, FMT>::value;
  extern __shared__ float sm[];
  float* xs = sm;
  float* fea = xs + TP * 3;
  float* head = fea + TP * 6;
  float* acts = head + TP * HS;
  const int base = blockIdx.x * TP;

  load_rows<TP>(x, n, base, xs);
  __syncthreads();
  forward_tile<TP, MOTION, FMT>(prm, L, freq, scale, xs, fea, head, acts,
                                false);

  for (int p = threadIdx.x; p < TP; p += blockDim.x) {
    if (base + p >= n) continue;
    motion_fwd<MOTION, FMT>(head + p * HS, xs + p * 3, out + (base + p) * 3);
  }
}

// The bound (up to 256 threads, two blocks an SM) lets the compiler keep
// 96 registers a thread; left to itself it took 64 and ran 17% slower on
// an H100 (0.157 against 0.134 ms at 2000 points, width 128, depth 3).
template <int TP, int MOTION, int FMT>
__global__ void __launch_bounds__(DP_MAX_WIDTH, 2)
    level_warp_bwd_kernel(const float* __restrict__ prm,
                          const float* __restrict__ x,
                          const float* __restrict__ g, int n,
                          const LevelLayout L, float freq, float scale,
                          float* __restrict__ partial) {
  constexpr int HS = HeadCount<MOTION, FMT>::value;
  extern __shared__ float sm[];
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
  load_rows<TP>(g, n, base, gs);
  __syncthreads();
  forward_tile<TP, MOTION, FMT>(prm, L, freq, scale, xs, fea, head, acts,
                                true);
  backward_tile<TP, MOTION, FMT>(prm, L, scale, xs, fea, head, gs, gh, acts,
                                 dA, dB,
                                 partial + (size_t)blockIdx.x * L.total);
}

extern "C" int dp_level_warp_fwd(const void* prm, const void* x, int n,
                                 int width, int depth, int motion, int fmt,
                                 float freq, float scale, void* out,
                                 void* stream) {
  if (!layout_supported(width, depth, motion, fmt)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const LevelLayout L = level_layout(width, depth, motion, fmt);
  const size_t smem = sizeof(float) * (FWD_TP * (9 + L.hs) + 2 * FWD_TP * width);
  const int blocks = (n + FWD_TP - 1) / FWD_TP;
  return (int)dispatch_layout(motion, fmt, [&](auto m, auto r) {
    auto kernel = level_warp_fwd_kernel<FWD_TP, decltype(m)::value,
                                        decltype(r)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads_for(width), smem, (cudaStream_t)stream>>>(
        (const float*)prm, (const float*)x, n, L, freq, scale, (float*)out);
    return cudaGetLastError();
  });
}

extern "C" int dp_level_warp_bwd(const void* prm, const void* x, const void* g,
                                 int n, int width, int depth, int motion,
                                 int fmt, float freq, float scale,
                                 void* partial, int n_rows, void* stream) {
  if (!layout_supported(width, depth, motion, fmt)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // The caller sizes `partial` as [n_rows, P]; each block writes one row.
  const int blocks = (n + BWD_TP - 1) / BWD_TP;
  if (n_rows != blocks) return (int)cudaErrorInvalidValue;
  const LevelLayout L = level_layout(width, depth, motion, fmt);
  const size_t smem = sizeof(float) * bwd_tile_floats(BWD_TP, width, depth, L.hs);
  return (int)dispatch_layout(motion, fmt, [&](auto m, auto r) {
    auto kernel = level_warp_bwd_kernel<BWD_TP, decltype(m)::value,
                                        decltype(r)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads_for(width), smem, (cudaStream_t)stream>>>(
        (const float*)prm, (const float*)x, (const float*)g, n, L, freq,
        scale, (float*)partial);
    return cudaGetLastError();
  });
}
