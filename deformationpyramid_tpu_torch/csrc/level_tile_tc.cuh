// The level tile of C2 level_warp_fwd, C3 level_warp_bwd (level_warp.cuh)
// and C5 ldmk_iteration (ldmk_iteration.cu): one pyramid level's forward
// over a tile of `tp` points (c3_forward; C2 warps the points with it) and
// its parameter VJP from the forward's kept activations (c3_backward; C3
// runs both in a row, c3_tile, C5 the VJP only where its cotangent is not
// exactly zero), the width x width products as 3xTF32 on the tensor cores
// (tf32_mma.cuh).
//
// The products: the hidden layers h_l = relu(h_{l-1} W_l + b_l),
// the weight gradients h_{l-1}^T dz_l and the cotangents dz_l W_l^T, as
// mma.sync m16n8k8 with each operand split toward zero into hi + lo
// (tc_split_rz) and every k-step's three passes summed from zero and added
// on the FMA units (tc_mma3): the tensor cores' own accumulation truncates.
// ~1e-6 off f32. The TPU kernels computed these as bf16x3 on their MXU
// (ops/fused_level.py _dot_wide). Everything else stays f32 on the FMA
// units with full-precision sinf/cosf: the posenc input layer (K = 6),
// the heads (3-11 outputs at mlp_scale 1e-3), the motion and its VJP (the
// axis-angle VJP divides by theta ~ 1e-3) and the nonrigidity gate, as the
// TPU kernels kept their [3, x] dots at HIGHEST.
//
// Layout: a block of C3_THREADS threads (16 warps) takes tp points, a
// multiple of the 16 rows of an m-tile, chosen by the host
// (ops/fused_iteration.py fwd_tile, bwd_tile) so that the grid fills the
// card's SMs once. The activations (every layer's for C3, two ping-pong
// buffers for C2) and C3's two gradient buffers sit in shared memory as
// [tp][ld] rows, ld = the width rounded up to 16 and then to
// 8 (mod 32) floats: the fragment loads of a warp fall on 32 distinct
// banks, both the row-major ones (two floats a load, the summed index t
// read as column 2t and t + 4 as 2t + 1, a permutation of the sum that the
// B operand reads alike) and the transposed ones of the weight gradients.
// Columns from the width to the rounded width hold zeros. The weights are
// read from global memory through L1: every block reads all of them, and
// staging the hidden layers' in shared memory by cp.async gained 2% at
// 2000 points, not worth a second path. Each warp takes jobs of one
// m-tile by C3_NT n-tiles of 8, which share one split A fragment. The
// weight gradients go straight from the accumulators to the block's
// partial row. The heads' forward takes a warp a point (its lanes split
// the width, a fixed shuffle tree sums), their VJP and the input layer's
// spread over every thread. Every output of a point depends on that
// point's row alone, so C2's warp does not depend on the tile.
#pragma once

#include "common.cuh"
#include "tf32_mma.cuh"

#define C3_THREADS 512
#define C3_WARPS (C3_THREADS / 32)
#define C3_MT 16   // points of one m-tile; a block's tile is a multiple
#define C3_NT 2    // n-tiles of 8 columns in one warp's job
#define C3_SMEM_LIMIT 232448   // shared memory a Hopper block may opt in to

// The width rounded up to whole m-tiles, and the row stride of the tile's
// buffers: = 8 (mod 32) floats.
__host__ __device__ __forceinline__ int c3_wpad(int width) {
  return (width + 15) & ~15;
}
__host__ __device__ __forceinline__ int c3_ld(int width) {
  const int wp = c3_wpad(width);
  return wp + ((40 - (wp & 31)) & 31);
}

// Shared memory of one C3 block in floats: every layer's activations and two
// gradient buffers ([tp][ld] each), then xs, gs, fea, head, gh and, with
// the nonrigidity head, gnr.
__host__ inline size_t c3_smem_floats(int tp, int width, int depth, int hs,
                                      bool nonrigid) {
  return (size_t)(depth + 2) * tp * c3_ld(width) +
         (size_t)tp * (3 + 3 + 6 + 2 * hs + (nonrigid ? 1 : 0));
}

// Shared memory of one C2 block in floats: two activation buffers
// ([tp][ld] each), then xs, fea and head.
__host__ inline size_t c2_smem_floats(int tp, int width, int hs) {
  return (size_t)2 * tp * c3_ld(width) + (size_t)tp * (3 + 6 + hs);
}

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

// *dst = v, or *dst += v where ADD (C5's block adds the VJPs of its later
// tiles into its row). A compile-time choice: with a run-time one every
// store of the partial row also loaded it, and C5 at 2048 rows ran 9%
// slower on an H100.
template <bool ADD>
__device__ __forceinline__ void put(float* dst, float v) {
  if constexpr (ADD) {
    *dst += v;
  } else {
    *dst = v;
  }
}

// One point's warp from its head outputs `head` (HeadCount<.., NR> of
// them): out = s R x + t, and with the nonrigidity head (models/pyramid.py
// level_warp, JAX ops/fused_level.py _forward_math_t `finish`) gated at
// level > 0: out = x + nr (out - x), nr = sigmoid(head[HS - 1]); at level 0
// the warp is ungated and the returned nonrigidity is 1.
template <int MOTION, int FMT, bool NR>
__device__ __forceinline__ float point_warp(const float* head, const float* x,
                                            bool gate, float* out) {
  motion_fwd<MOTION, FMT>(head, x, out);
  if constexpr (NR) {
    constexpr int HS = HeadCount<MOTION, FMT, NR>::value;
    if (!gate) return 1.f;
    const float nr = sigmoid_f(head[HS - 1]);
    for (int k = 0; k < 3; ++k) out[k] = x[k] + nr * (out[k] - x[k]);
    return nr;
  } else {
    return 1.f;
  }
}

// The cotangents of one point's head outputs (before mlp_scale) for the
// cotangent gp of its warped point (common.cuh motion_vjp) and, with NR,
// gnr of its nonrigidity: at level > 0 (gate) out = x + nr (m - x), so m
// gets nr gp and nr gets gp.(m - x) + gnr; at level 0 the nonrigidity head
// gets exactly zero.
template <int MOTION, int FMT, bool NR>
__device__ __forceinline__ void point_warp_vjp(const float* hp,
                                               const float* xp,
                                               const float* gp, float gnr,
                                               bool gate, float* ghp) {
  if constexpr (NR) {
    constexpr int HS = HeadCount<MOTION, FMT, NR>::value;
    if (gate) {
      const float nr = sigmoid_f(hp[HS - 1]);
      float m[3];
      motion_fwd<MOTION, FMT>(hp, xp, m);
      const float gm[3] = {nr * gp[0], nr * gp[1], nr * gp[2]};
      motion_vjp<MOTION, FMT>(hp, xp, gm, ghp);
      const float gn = gp[0] * (m[0] - xp[0]) + gp[1] * (m[1] - xp[1]) +
                       gp[2] * (m[2] - xp[2]) + gnr;
      ghp[HS - 1] = gn * (nr * (1.f - nr));
    } else {
      motion_vjp<MOTION, FMT>(hp, xp, gp, ghp);
      ghp[HS - 1] = 0.f;
    }
  } else {
    motion_vjp<MOTION, FMT>(hp, xp, gp, ghp);
  }
}

// One warp's m-tile of rows `a` (row-major, rows of ld floats, k < kn) by
// C3_NT n-tiles from column n0: c[s] += a B[:, n0 + 8 s ..] for k < kn,
// B read through ldb(k, n).
template <typename LoadB>
__device__ __forceinline__ void c3_rows_tile(float (&c)[C3_NT][4],
                                             const float* a, int ld, int kn,
                                             int n0, LoadB ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * ld + 2 * t;
  const float* a1 = a0 + 8 * ld;
#pragma unroll 4
  for (int k0 = 0; k0 < kn; k0 += 8) {
    const float2 u = *reinterpret_cast<const float2*>(a0 + k0);
    const float2 v = *reinterpret_cast<const float2*>(a1 + k0);
    unsigned ah[4], al[4];
    tc_split_rz(u.x, ah[0], al[0]);
    tc_split_rz(v.x, ah[1], al[1]);
    tc_split_rz(u.y, ah[2], al[2]);
    tc_split_rz(v.y, ah[3], al[3]);
#pragma unroll
    for (int s = 0; s < C3_NT; ++s) {
      const int n = n0 + 8 * s + g;
      unsigned bh[2], bl[2];
      tc_split_rz(ldb(k0 + 2 * t, n), bh[0], bl[0]);
      tc_split_rz(ldb(k0 + 2 * t + 1, n), bh[1], bl[1]);
      tc_mma3(c[s], ah, al, bh, bl);
    }
  }
}

// Writes f(row, col, value) for the job's accumulators: rows m0 + g and
// m0 + g + 8, columns n0 + 8 s + 2 t and + 1, as float2 pairs.
template <typename Store>
__device__ __forceinline__ void c3_epilogue(const float (&c)[C3_NT][4],
                                            int m0, int n0, Store st) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < C3_NT; ++s) {
    const int col = n0 + 8 * s + 2 * t;
    st(m0 + g, col, c[s][0], c[s][1]);
    st(m0 + g + 8, col, c[s][2], c[s][3]);
  }
}

// out = relu(in W + b) for one hidden layer over the tile: W [w, w]
// row-major ([in, out]); zero in the padded columns.
__device__ __forceinline__ void c3_layer_fwd(const float* in, float* out,
                                             const float* __restrict__ Wl,
                                             const float* __restrict__ bl,
                                             int tp, int w, int ld) {
  const int wp = c3_wpad(w), ng = wp / (8 * C3_NT);
  for (int job = threadIdx.x >> 5; job < (tp / C3_MT) * ng; job += C3_WARPS) {
    const int m0 = (job / ng) * C3_MT, n0 = (job % ng) * 8 * C3_NT;
    float c[C3_NT][4] = {};
    c3_rows_tile(c, in + m0 * ld, ld, wp, n0, [&](int k, int n) {
      return k < w && n < w ? __ldg(Wl + k * w + n) : 0.f;
    });
    c3_epilogue(c, m0, n0, [&](int r, int col, float v0, float v1) {
      const float b0 = col < w ? __ldg(bl + col) : 0.f;
      const float b1 = col + 1 < w ? __ldg(bl + col + 1) : 0.f;
      *reinterpret_cast<float2*>(out + r * ld + col) =
          make_float2(fmaxf(v0 + b0, 0.f), fmaxf(v1 + b1, 0.f));
    });
  }
}

// The cotangent of layer l - 1's activations, masked by its ReLU: dn =
// (hprev > 0) (dz W^T), zero in the padded columns (hprev is zero there).
__device__ __forceinline__ void c3_layer_cot(const float* dz, float* dn,
                                             const float* hprev,
                                             const float* __restrict__ Wl,
                                             int tp, int w, int ld) {
  const int wp = c3_wpad(w), ng = wp / (8 * C3_NT);
  for (int job = threadIdx.x >> 5; job < (tp / C3_MT) * ng; job += C3_WARPS) {
    const int m0 = (job / ng) * C3_MT, n0 = (job % ng) * 8 * C3_NT;
    float c[C3_NT][4] = {};
    c3_rows_tile(c, dz + m0 * ld, ld, wp, n0, [&](int j, int k) {
      return j < w && k < w ? __ldg(Wl + k * w + j) : 0.f;
    });
    c3_epilogue(c, m0, n0, [&](int r, int col, float v0, float v1) {
      const float2 h = *reinterpret_cast<const float2*>(hprev + r * ld + col);
      *reinterpret_cast<float2*>(dn + r * ld + col) =
          make_float2(h.x > 0.f ? v0 : 0.f, h.y > 0.f ? v1 : 0.f);
    });
  }
}

// The weight gradient gw[k * w + j] = sum over the tile's points p of
// h[p][k] dz[p][j]: M = the width (rows k), N = the width, K = the tp
// points, A read transposed (one float a load, rows of ld = 8 mod 32
// floats put a warp's loads on 32 banks); added to gw where ADD.
template <bool ADD>
__device__ __forceinline__ void c3_wgrad(const float* h, const float* dz,
                                         float* __restrict__ gw, int tp,
                                         int w, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wp = c3_wpad(w), ng = wp / (8 * C3_NT);
  for (int job = threadIdx.x >> 5; job < (wp / C3_MT) * ng; job += C3_WARPS) {
    const int m0 = (job / ng) * C3_MT, n0 = (job % ng) * 8 * C3_NT;
    float c[C3_NT][4] = {};
    for (int p0 = 0; p0 < tp; p0 += 8) {
      const float* r0 = h + (p0 + t) * ld + m0 + g;
      const float* r1 = r0 + 4 * ld;
      unsigned ah[4], al[4];
      tc_split_rz(r0[0], ah[0], al[0]);
      tc_split_rz(r0[8], ah[1], al[1]);
      tc_split_rz(r1[0], ah[2], al[2]);
      tc_split_rz(r1[8], ah[3], al[3]);
#pragma unroll
      for (int s = 0; s < C3_NT; ++s) {
        const float* q = dz + (p0 + t) * ld + n0 + 8 * s + g;
        unsigned bh[2], bl[2];
        tc_split_rz(q[0], bh[0], bl[0]);
        tc_split_rz(q[4 * ld], bh[1], bl[1]);
        tc_mma3(c[s], ah, al, bh, bl);
      }
    }
    c3_epilogue(c, m0, n0, [&](int r, int col, float v0, float v1) {
      if (r < w && col < w) put<ADD>(gw + r * w + col, v0);
      if (r < w && col + 1 < w) put<ADD>(gw + r * w + col + 1, v1);
    });
  }
}

// The level's forward over a tile of tp points (xs loaded and
// synchronised, zero on rows past the end): posenc into fea, the input
// layer, the hidden layers on the tensor cores and the heads, scaled by
// mlp_scale, into head [tp][HS]. Layer l's activations go to
// acts + l * tp * ld where KEEP (C3 and C5, whose VJP reads every layer),
// else to one of two ping-pong buffers (C2). Returns the last layer's
// activations; ends with __syncthreads(). C2, C3 and C5 run this same code,
// so C2's warp is bit for bit the forward whose VJP C3 computes.
template <int MOTION, int FMT, bool NR, bool KEEP>
__device__ __forceinline__ const float* c3_forward(
    const float* __restrict__ prm, const LevelLayout L, int tp, float freq,
    float scale, const float* xs, float* fea, float* head, float* acts) {
  constexpr int HS = HeadCount<MOTION, FMT, NR>::value;
  const int W = L.w, wp = c3_wpad(W), ld = c3_ld(W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto layer = [&](int l) { return acts + (KEEP ? l : (l & 1)) * tp * ld; };

  posenc_rows(xs, fea, tp, freq);
  __syncthreads();

  // Input layer (K = 6, FMA): thread column j keeps its weights in
  // registers; zero in the padded columns.
  {
    float* h0 = layer(0);
    const int groups = blockDim.x / wp, j = threadIdx.x % wp;
    if ((int)threadIdx.x < groups * wp) {
      float wi[6], b = 0.f;
      for (int k = 0; k < 6; ++k)
        wi[k] = j < W ? __ldg(prm + L.iw + k * W + j) : 0.f;
      if (j < W) b = __ldg(prm + L.ib + j);
      for (int p = threadIdx.x / wp; p < tp; p += groups) {
        float v = 0.f;
        if (j < W) {
          float acc = 0.f;
          for (int k = 0; k < 6; ++k) acc = fmaf(fea[p * 6 + k], wi[k], acc);
          v = fmaxf(acc + b, 0.f);
        }
        h0[p * ld + j] = v;
      }
    }
  }
  __syncthreads();
  for (int l = 1; l < L.depth; ++l) {
    c3_layer_fwd(layer(l - 1), layer(l), prm + L.hw + (l - 1) * W * W,
                 prm + L.hb + (l - 1) * W, tp, W, ld);
    __syncthreads();
  }
  const float* hL = layer(L.depth - 1);

  // Heads, scaled by mlp_scale (FMA): a warp a point, its lanes over the
  // width, summed by a fixed shuffle tree.
  for (int p = warp; p < tp; p += C3_WARPS) {
    float acc[HS];
#pragma unroll
    for (int o = 0; o < HS; ++o) acc[o] = 0.f;
    for (int k = lane; k < W; k += 32) {
      const float h = hL[p * ld + k];
#pragma unroll
      for (int o = 0; o < HS; ++o) {
        const HeadSlot sl = head_slot(L, o);
        acc[o] = fmaf(h, __ldg(prm + sl.w + k * sl.ncol), acc[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < HS; ++o) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[o] += __shfl_down_sync(0xffffffffu, acc[o], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int o = 0; o < HS; ++o)
        head[p * HS + o] = scale * (acc[o] + __ldg(prm + head_slot(L, o).b));
    }
  }
  __syncthreads();
  return hL;
}

// The block's VJP from the kept activations of c3_forward<..., KEEP = true>
// (acts, fea and head as it left them; gs and, with NR, gnr loaded and
// synchronised; zero cotangents on rows past the end): every entry of the
// partial row `part` [L.total], written, or added to it where ADD.
template <int MOTION, int FMT, bool NR, bool ADD = false>
__device__ __forceinline__ void c3_backward(const float* __restrict__ prm,
                                            const LevelLayout L, int tp,
                                            float scale, bool gate,
                                            const float* xs, const float* gs,
                                            const float* gnr,
                                            const float* fea,
                                            const float* head, float* gh,
                                            const float* acts, float* dA,
                                            float* dB,
                                            float* __restrict__ part) {
  constexpr int HS = HeadCount<MOTION, FMT, NR>::value;
  const int W = L.w, wp = c3_wpad(W), ld = c3_ld(W);
  const float* hL = acts + (L.depth - 1) * tp * ld;

  // head o's weight from hidden unit k
  auto head_w = [&](int k, int o) {
    const HeadSlot sl = head_slot(L, o);
    return __ldg(prm + sl.w + k * sl.ncol);
  };

  // Motion VJP: the cotangents of the heads' pre-activations.
  for (int p = threadIdx.x; p < tp; p += blockDim.x) {
    float ghp[HS];
    point_warp_vjp<MOTION, FMT, NR>(head + p * HS, xs + p * 3, gs + p * 3,
                                    NR ? gnr[p] : 0.f, gate, ghp);
#pragma unroll
    for (int o = 0; o < HS; ++o) gh[p * HS + o] = scale * ghp[o];
  }
  __syncthreads();

  // Heads: bias and weight gradients, and the cotangent of the last
  // layer, masked by its ReLU.
  for (int o = threadIdx.x; o < HS; o += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < tp; ++p) s += gh[p * HS + o];
    put<ADD>(part + head_slot(L, o).b, s);
  }
  for (int i = threadIdx.x; i < W * HS; i += blockDim.x) {
    const int k = i / HS, o = i - k * HS;
    const HeadSlot sl = head_slot(L, o);
    float s = 0.f;
    for (int p = 0; p < tp; ++p) s = fmaf(hL[p * ld + k], gh[p * HS + o], s);
    put<ADD>(part + sl.w + k * sl.ncol, s);
  }
  for (int i = threadIdx.x; i < tp * wp; i += blockDim.x) {
    const int p = i / wp, k = i - p * wp;
    float s = 0.f;
    if (k < W) {
#pragma unroll
      for (int o = 0; o < HS; ++o) s = fmaf(head_w(k, o), gh[p * HS + o], s);
    }
    dA[p * ld + k] = hL[p * ld + k] > 0.f ? s : 0.f;
  }
  __syncthreads();

  // Hidden layers, last to first; dz holds d(loss)/d(pre-activations of
  // l): its bias gradient, its weight gradient and the next dz.
  float* dz = dA;
  float* dn = dB;
  for (int l = L.depth - 1; l >= 1; --l) {
    const float* hprev = acts + (l - 1) * tp * ld;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < tp; ++p) s += dz[p * ld + j];
      put<ADD>(part + L.hb + (l - 1) * W + j, s);
    }
    c3_layer_cot(dz, dn, hprev, prm + L.hw + (l - 1) * W * W, tp, W, ld);
    c3_wgrad<ADD>(hprev, dz, part + L.hw + (l - 1) * W * W, tp, W, ld);
    __syncthreads();
    float* tmp = dz;
    dz = dn;
    dn = tmp;
  }

  // Input layer (K = 6, FMA): its bias (k = 6) and weight gradients.
  for (int i = threadIdx.x; i < 7 * W; i += blockDim.x) {
    const int k = i / W, j = i - k * W;
    float s = 0.f;
    if (k == 6) {
      for (int p = 0; p < tp; ++p) s += dz[p * ld + j];
      put<ADD>(part + L.ib + j, s);
    } else {
      for (int p = 0; p < tp; ++p) s = fmaf(fea[p * 6 + k], dz[p * ld + j], s);
      put<ADD>(part + L.iw + k * W + j, s);
    }
  }
}

// C3's block: the forward of its tp points (xs, gs and, with NR, gnr
// loaded and synchronised; zero cotangents on rows past the end), then
// its VJP into every entry of the partial row `part` [L.total].
template <int MOTION, int FMT, bool NR>
__device__ __forceinline__ void c3_tile(const float* __restrict__ prm,
                                        const LevelLayout L, int tp,
                                        float freq, float scale, bool gate,
                                        const float* xs, const float* gs,
                                        const float* gnr, float* fea,
                                        float* head, float* gh, float* acts,
                                        float* dA, float* dB,
                                        float* __restrict__ part) {
  c3_forward<MOTION, FMT, NR, true>(prm, L, tp, freq, scale, xs, fea, head,
                                    acts);
  c3_backward<MOTION, FMT, NR>(prm, L, tp, scale, gate, xs, gs, gnr, fea,
                               head, gh, acts, dA, dB, part);
}
