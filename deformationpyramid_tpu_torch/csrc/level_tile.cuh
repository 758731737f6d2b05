// C5 ldmk_iteration's tile (ldmk_iteration.cu): one pyramid level's
// forward and VJP over a tile of TP points; and the row loader and posenc
// that C2 / C3's tensor-core tile (level_tile_tc.cuh) takes from here.
//
// Layout: one thread per hidden unit, the tile's points, features, head
// outputs and every layer's activations in shared memory (each weight
// read from L2 once per block, each activation read by all threads as a
// broadcast), width given at run time up to 256. The motion and the
// rotation format come from the LevelLayout (common.cuh).
#pragma once

#include "common.cuh"

// Shared memory of the backward tile, in floats: xs, fea, head, gs, gh
// (hs head outputs a point: 3 for sflow up to 10 for Sim3 + 6D) and the
// activations of every layer plus two gradient buffers.
__host__ inline size_t bwd_tile_floats(int tp, int width, int depth, int hs) {
  return (size_t)tp * (3 + 6 + hs + 3 + hs) + (size_t)(depth + 2) * tp * width;
}

__host__ inline int threads_for(int width) { return ((width + 31) / 32) * 32; }

// dst [rows * 3] = src rows base .. base + rows - 1 of [n, 3], zero past n.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int n, int base, int rows,
                                          float* dst) {
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x) {
    dst[i] = (base + i / 3 < n) ? src[base * 3 + i] : 0.f;
  }
}

// posenc at one frequency: sin/cos of x*freq, feature order
// [sin x, cos x, sin y, cos y, sin z, cos z].
__device__ __forceinline__ void posenc_rows(const float* xs, float* fea,
                                            int rows, float freq) {
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x) {
    const int p = i / 3, c = i % 3;
    const float a = xs[i] * freq;
    fea[p * 6 + 2 * c] = sinf(a);
    fea[p * 6 + 2 * c + 1] = cosf(a);
  }
}

// Input layer and hidden layers. Layer l's activations go to
// acts + l*TP*W; returns the last layer's activations. Ends with
// __syncthreads().
template <int TP>
__device__ __forceinline__ const float* trunk_tile(const float* __restrict__ prm,
                                   const LevelLayout L, const float* fea,
                                   float* acts) {
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
    cur = acts + l * TP * W;
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

// head[p*HS + o]: the heads' outputs scaled by mlp_scale (common.cuh
// LevelLayout). Ends with __syncthreads().
template <int TP, int HS>
__device__ __forceinline__ void heads_tile(const float* __restrict__ prm,
                                           const LevelLayout L, const float* h,
                                           float* head, float scale) {
  for (int i = threadIdx.x; i < TP * HS; i += blockDim.x) {
    const int p = i / HS;
    const HeadSlot s = head_slot(L, i % HS);
    float acc = 0.f;
    for (int k = 0; k < L.w; ++k) acc = fmaf(h[p * L.w + k], prm[s.w + k * s.ncol], acc);
    head[i] = scale * (acc + prm[s.b]);
  }
  __syncthreads();
}

// Forward of the tile up to the heads: xs [TP*3] must be loaded and
// synchronised; every layer's activations stay in acts for backward_tile.
// Returns the last layer's activations.
template <int TP, int MOTION, int FMT>
__device__ __forceinline__ const float* forward_tile(const float* __restrict__ prm,
                                     const LevelLayout L, float freq,
                                     float scale, const float* xs, float* fea,
                                     float* head, float* acts) {
  posenc_rows(xs, fea, TP, freq);
  __syncthreads();
  const float* h = trunk_tile<TP>(prm, L, fea, acts);
  heads_tile<TP, HeadCount<MOTION, FMT>::value>(prm, L, h, head, scale);
  return h;
}

// VJP of the tile's warp for the cotangents gs [TP*3] (zero on rows past
// the end), after forward_tile; writes every entry of
// the parameter-gradient row `part` [L.total]. gh [TP*HS], dA and dB
// [TP*W] are scratch.
template <int TP, int MOTION, int FMT>
__device__ __forceinline__ void backward_tile(const float* __restrict__ prm,
                              const LevelLayout L, float scale,
                              const float* xs, const float* fea,
                              const float* head, const float* gs, float* gh,
                              const float* acts, float* dA, float* dB,
                              float* __restrict__ part) {
  constexpr int HS = HeadCount<MOTION, FMT>::value;
  const int W = L.w;
  const float* hL = acts + (L.depth - 1) * TP * W;

  // Motion VJP: cotangents of the heads' pre-activations.
  for (int p = threadIdx.x; p < TP; p += blockDim.x) {
    float ghp[HS];
    motion_vjp<MOTION, FMT>(head + p * HS, xs + p * 3, gs + p * 3, ghp);
#pragma unroll
    for (int o = 0; o < HS; ++o) gh[p * HS + o] = scale * ghp[o];
  }
  __syncthreads();

  // Heads: bias and weight gradients, and the cotangent of the last layer.
  for (int o = threadIdx.x; o < HS; o += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < TP; ++p) s += gh[p * HS + o];
    part[head_slot(L, o).b] = s;
  }
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    float wr[HS];
#pragma unroll
    for (int o = 0; o < HS; ++o) {
      const HeadSlot sl = head_slot(L, o);
      float s = 0.f;
      for (int p = 0; p < TP; ++p) s = fmaf(hL[p * W + k], gh[p * HS + o], s);
      part[sl.w + k * sl.ncol] = s;
      wr[o] = prm[sl.w + k * sl.ncol];
    }
    for (int p = 0; p < TP; ++p) {
      float s = 0.f;
#pragma unroll
      for (int o = 0; o < HS; ++o) s = fmaf(wr[o], gh[p * HS + o], s);
      dA[p * W + k] = s;
    }
  }
  __syncthreads();

  // Hidden layers, last to first. dA holds d(loss)/d(activations of l).
  for (int l = L.depth - 1; l >= 1; --l) {
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
