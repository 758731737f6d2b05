// C2 level_warp_fwd and C3 level_warp_bwd: one pyramid level's warp
// (SE3 motion, axis-angle rotation) and its parameter VJP.
//
// C2 replaces the warp half of the JAX package's kernel 1
// (ops/fused_iteration.py _fwd_sweep_kernel, through
// ops/fused_level.py _forward_math_t); C3 replaces the VJP half of kernel 2
// (ops/fused_iteration.py _bwd_adam_kernel).
//
// The math, per point x: posenc at one frequency (sin/cos of x*freq,
// feature order [sin x, cos x, sin y, cos y, sin z, cos z]), a 6->w ReLU
// layer, (depth-1) w->w ReLU layers, the rotation and translation heads
// scaled by mlp_scale, and the matrix-free Rodrigues rotation with the
// 1e-12 floor on theta^2:
//   out = x + sin(t) (w x x) + (1 - cos(t)) (w (w.x) - x) + trn,
//   t = sqrt(max(|r|^2, 1e-12)), w = r / t.
// Full-precision sinf/cosf/sqrtf and plain f32 FMAs: the VJP divides by
// theta ~ 1e-3, so the build uses no fast-math.
//
// What bounds them: ~2 * 34k flops per point and direction at width 128,
// depth 3 (0.14 GFLOP forward, ~0.3 GFLOP backward for 2048 points), far
// below the card's f32 rate; the launch, the serial layer chain and
// shared-memory traffic set the time. Design: one block per tile of TP
// points, one thread per hidden unit, the tile's activations in shared
// memory (each weight read from L2 once per block, each activation read by
// all threads as a broadcast), width given at run time up to 256.
//
// C3 recomputes the forward for its tile (as the TPU kernel did, rather
// than storing activations between launches), backpropagates through
// Rodrigues, the heads, the hidden layers and the input layer, and writes
// its own partial gradient vector into row blockIdx.x of an
// [n_blocks, P] buffer. The TPU kernel accumulated across its sequential
// grid; blocks on Hopper run in parallel, so the sum over blocks happens
// in a fixed order in C4 (adam.cu) and no atomics are needed. All depth
// layers of TP x width activations plus two gradient buffers exceed the
// 48 KB static limit (84 KB at width 128, depth 3), so C3 raises the
// kernel's dynamic shared-memory limit before its launch.
#include "common.cuh"

#define FWD_TP 32
#define BWD_TP 32

template <int TP>
__device__ void posenc_tile(const float* xs, float* fea, float freq) {
  for (int i = threadIdx.x; i < TP * 3; i += blockDim.x) {
    const int p = i / 3, c = i % 3;
    const float a = xs[i] * freq;
    fea[p * 6 + 2 * c] = sinf(a);
    fea[p * 6 + 2 * c + 1] = cosf(a);
  }
}

// Input layer and hidden layers. Layer l's activations go to
// acts + l*TP*W (keep_all) or to one of two ping-pong buffers; returns the
// last layer's activations. Ends with __syncthreads().
template <int TP>
__device__ const float* trunk_tile(const float* __restrict__ prm,
                                   const LevelLayout L, const float* fea,
                                   float* acts, bool keep_all) {
  const int W = L.w;
  float* cur = acts;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    float acc[TP];
#pragma unroll
    for (int p = 0; p < TP; ++p) acc[p] = 0.f;
    for (int k = 0; k < 6; ++k) {
      const float wk = prm[L.iw + k * W + j];
#pragma unroll
      for (int p = 0; p < TP; ++p) acc[p] = fmaf(fea[p * 6 + k], wk, acc[p]);
    }
    const float b = prm[L.ib + j];
#pragma unroll
    for (int p = 0; p < TP; ++p) cur[p * W + j] = fmaxf(acc[p] + b, 0.f);
  }
  __syncthreads();
  for (int l = 1; l < L.depth; ++l) {
    const float* prev = cur;
    cur = acts + (keep_all ? l : (l & 1)) * TP * W;
    const float* Wl = prm + L.hw + (l - 1) * W * W;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      float acc[TP];
#pragma unroll
      for (int p = 0; p < TP; ++p) acc[p] = 0.f;
      for (int k = 0; k < W; ++k) {
        const float wk = Wl[k * W + j];
#pragma unroll
        for (int p = 0; p < TP; ++p) acc[p] = fmaf(prev[p * W + k], wk, acc[p]);
      }
      const float b = prm[L.hb + (l - 1) * W + j];
#pragma unroll
      for (int p = 0; p < TP; ++p) cur[p * W + j] = fmaxf(acc[p] + b, 0.f);
    }
    __syncthreads();
  }
  return cur;
}

// head[p*6 + o]: o < 3 the scaled rotation head, o >= 3 the scaled
// translation head. Caller synchronises afterwards.
template <int TP>
__device__ void heads_tile(const float* __restrict__ prm, const LevelLayout L,
                           const float* h, float* head, float scale) {
  for (int i = threadIdx.x; i < TP * 6; i += blockDim.x) {
    const int p = i / 6, o = i % 6, oo = o % 3;
    const float* Wm = prm + (o < 3 ? L.rw : L.tw);
    float acc = 0.f;
    for (int k = 0; k < L.w; ++k) acc = fmaf(h[p * L.w + k], Wm[k * 3 + oo], acc);
    head[i] = scale * (acc + prm[(o < 3 ? L.rb : L.tb) + oo]);
  }
}

template <int TP>
__device__ void load_rows(const float* __restrict__ src, int n, int base,
                          float* dst) {
  for (int i = threadIdx.x; i < TP * 3; i += blockDim.x) {
    dst[i] = (base + i / 3 < n) ? src[base * 3 + i] : 0.f;
  }
}

template <int TP>
__global__ void level_warp_fwd_kernel(const float* __restrict__ prm,
                                      const float* __restrict__ x, int n,
                                      int width, int depth, float freq,
                                      float scale, float* __restrict__ out) {
  extern __shared__ float sm[];
  const LevelLayout L = level_layout(width, depth);
  float* xs = sm;
  float* fea = xs + TP * 3;
  float* head = fea + TP * 6;
  float* acts = head + TP * 6;
  const int base = blockIdx.x * TP;

  load_rows<TP>(x, n, base, xs);
  __syncthreads();
  posenc_tile<TP>(xs, fea, freq);
  __syncthreads();
  const float* h = trunk_tile<TP>(prm, L, fea, acts, false);
  heads_tile<TP>(prm, L, h, head, scale);
  __syncthreads();

  for (int p = threadIdx.x; p < TP; p += blockDim.x) {
    if (base + p >= n) continue;
    const float* r = head + p * 6;
    const float* t = r + 3;
    const float* xp = xs + p * 3;
    const float sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
    const float theta = sqrtf(fmaxf(sq, 1e-12f));
    const float w0 = r[0] / theta, w1 = r[1] / theta, w2 = r[2] / theta;
    const float st = sinf(theta), ct = cosf(theta);
    const float c0 = w1 * xp[2] - w2 * xp[1];
    const float c1 = w2 * xp[0] - w0 * xp[2];
    const float c2 = w0 * xp[1] - w1 * xp[0];
    const float a = w0 * xp[0] + w1 * xp[1] + w2 * xp[2];
    float* o = out + (base + p) * 3;
    o[0] = xp[0] + st * c0 + (1.f - ct) * (w0 * a - xp[0]) + t[0];
    o[1] = xp[1] + st * c1 + (1.f - ct) * (w1 * a - xp[1]) + t[1];
    o[2] = xp[2] + st * c2 + (1.f - ct) * (w2 * a - xp[2]) + t[2];
  }
}

template <int TP>
__global__ void level_warp_bwd_kernel(const float* __restrict__ prm,
                                      const float* __restrict__ x,
                                      const float* __restrict__ g, int n,
                                      int width, int depth, float freq,
                                      float scale, float* __restrict__ partial) {
  extern __shared__ float sm[];
  const LevelLayout L = level_layout(width, depth);
  const int W = width;
  float* xs = sm;
  float* fea = xs + TP * 3;
  float* head = fea + TP * 6;
  float* gs = head + TP * 6;
  float* gh = gs + TP * 3;
  float* acts = gh + TP * 6;
  float* dA = acts + depth * TP * W;
  float* dB = dA + TP * W;
  const int base = blockIdx.x * TP;
  float* part = partial + (size_t)blockIdx.x * L.total;

  load_rows<TP>(x, n, base, xs);
  load_rows<TP>(g, n, base, gs);
  __syncthreads();
  posenc_tile<TP>(xs, fea, freq);
  __syncthreads();
  const float* hL = trunk_tile<TP>(prm, L, fea, acts, true);
  heads_tile<TP>(prm, L, hL, head, scale);
  __syncthreads();

  // Rodrigues VJP: cotangents of the scaled head pre-activations.
  for (int p = threadIdx.x; p < TP; p += blockDim.x) {
    const float* r = head + p * 6;
    const float* xp = xs + p * 3;
    const float* gp = gs + p * 3;
    const float sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
    const float theta = sqrtf(fmaxf(sq, 1e-12f));
    const float w[3] = {r[0] / theta, r[1] / theta, r[2] / theta};
    const float st = sinf(theta), ct = cosf(theta);
    const float c[3] = {w[1] * xp[2] - w[2] * xp[1], w[2] * xp[0] - w[0] * xp[2],
                        w[0] * xp[1] - w[1] * xp[0]};
    const float a = w[0] * xp[0] + w[1] * xp[1] + w[2] * xp[2];
    // x cross g
    const float xg[3] = {xp[1] * gp[2] - xp[2] * gp[1], xp[2] * gp[0] - xp[0] * gp[2],
                         xp[0] * gp[1] - xp[1] * gp[0]};
    const float gdw = gp[0] * w[0] + gp[1] * w[1] + gp[2] * w[2];
    float gth = 0.f, gw[3];
    for (int k = 0; k < 3; ++k) {
      gth += gp[k] * (ct * c[k] + st * (w[k] * a - xp[k]));
      gw[k] = st * xg[k] + (1.f - ct) * (a * gp[k] + gdw * xp[k]);
    }
    // w = r / theta, theta = sqrt(max(|r|^2, eps)): theta depends on r only
    // where the floor is not active.
    const float gww = gw[0] * w[0] + gw[1] * w[1] + gw[2] * w[2];
    const float coef = sq > 1e-12f ? (gth - gww / theta) : 0.f;
    for (int k = 0; k < 3; ++k) {
      gh[p * 6 + k] = scale * (gw[k] / theta + coef * w[k]);
      gh[p * 6 + 3 + k] = scale * gp[k];
    }
  }
  __syncthreads();

  // Heads: bias and weight gradients, and the cotangent of the last layer.
  for (int i = threadIdx.x; i < 6; i += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < TP; ++p) s += gh[p * 6 + i];
    part[(i < 3 ? L.rb : L.tb) + i % 3] = s;
  }
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    for (int o = 0; o < 6; ++o) {
      float s = 0.f;
      for (int p = 0; p < TP; ++p) s = fmaf(hL[p * W + k], gh[p * 6 + o], s);
      part[(o < 3 ? L.rw : L.tw) + k * 3 + o % 3] = s;
    }
    float wr[6];
    for (int o = 0; o < 3; ++o) {
      wr[o] = prm[L.rw + k * 3 + o];
      wr[3 + o] = prm[L.tw + k * 3 + o];
    }
    for (int p = 0; p < TP; ++p) {
      float s = 0.f;
      for (int o = 0; o < 6; ++o) s = fmaf(wr[o], gh[p * 6 + o], s);
      dA[p * W + k] = s;
    }
  }
  __syncthreads();

  // Hidden layers, last to first. dA holds d(loss)/d(activations of l).
  for (int l = depth - 1; l >= 1; --l) {
    const float* hl = acts + l * TP * W;
    const float* hprev = acts + (l - 1) * TP * W;
    const float* Wl = prm + L.hw + (l - 1) * W * W;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < TP; ++p) {
        const float dz = hl[p * W + j] > 0.f ? dA[p * W + j] : 0.f;
        dA[p * W + j] = dz;
        s += dz;
      }
      part[L.hb + (l - 1) * W + j] = s;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      float dz[TP];
#pragma unroll
      for (int p = 0; p < TP; ++p) dz[p] = dA[p * W + j];
      float* pw = part + L.hw + (l - 1) * W * W + j;
      for (int k = 0; k < W; ++k) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < TP; ++p) s = fmaf(hprev[p * W + k], dz[p], s);
        pw[k * W] = s;
      }
    }
    for (int k = threadIdx.x; k < W; k += blockDim.x) {
      float acc[TP];
#pragma unroll
      for (int p = 0; p < TP; ++p) acc[p] = 0.f;
      for (int j = 0; j < W; ++j) {
        const float wkj = Wl[k * W + j];
#pragma unroll
        for (int p = 0; p < TP; ++p) acc[p] = fmaf(wkj, dA[p * W + j], acc[p]);
      }
#pragma unroll
      for (int p = 0; p < TP; ++p) dB[p * W + k] = acc[p];
    }
    __syncthreads();
    float* tmp = dA;
    dA = dB;
    dB = tmp;
  }

  // Input layer.
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    float dz[TP];
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      dz[p] = acts[p * W + j] > 0.f ? dA[p * W + j] : 0.f;
      s += dz[p];
    }
    part[L.ib + j] = s;
    for (int k = 0; k < 6; ++k) {
      float t = 0.f;
#pragma unroll
      for (int p = 0; p < TP; ++p) t = fmaf(fea[p * 6 + k], dz[p], t);
      part[L.iw + k * W + j] = t;
    }
  }
}

static int threads_for(int width) { return ((width + 31) / 32) * 32; }

static size_t fwd_smem(int width) {
  return sizeof(float) * (FWD_TP * 15 + 2 * FWD_TP * width);
}

static size_t bwd_smem(int width, int depth) {
  return sizeof(float) * (BWD_TP * 24 + (depth + 2) * BWD_TP * width);
}

extern "C" int dp_level_warp_fwd(const void* prm, const void* x, int n,
                                 int width, int depth, float freq, float scale,
                                 void* out, void* stream) {
  if (width < 1 || width > DP_MAX_WIDTH || depth < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = fwd_smem(width);
  cudaError_t err = cudaFuncSetAttribute(level_warp_fwd_kernel<FWD_TP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + FWD_TP - 1) / FWD_TP;
  level_warp_fwd_kernel<FWD_TP><<<blocks, threads_for(width), smem,
                                  (cudaStream_t)stream>>>(
      (const float*)prm, (const float*)x, n, width, depth, freq, scale,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int dp_level_warp_bwd(const void* prm, const void* x, const void* g,
                                 int n, int width, int depth, float freq,
                                 float scale, void* partial, int n_rows,
                                 void* stream) {
  if (width < 1 || width > DP_MAX_WIDTH || depth < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // The caller sizes `partial` as [n_rows, P]; each block writes one row.
  const int blocks = (n + BWD_TP - 1) / BWD_TP;
  if (n_rows != blocks) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(width, depth);
  cudaError_t err = cudaFuncSetAttribute(level_warp_bwd_kernel<BWD_TP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  level_warp_bwd_kernel<BWD_TP><<<blocks, threads_for(width), smem,
                                  (cudaStream_t)stream>>>(
      (const float*)prm, (const float*)x, (const float*)g, n, width, depth,
      freq, scale, (float*)partial);
  return (int)cudaGetLastError();
}
