// C10 nsfp_fwd and C11 nsfp_bwd: the Neural Scene Flow Prior's warp
// x + mlp(x) and its parameter VJP.
//
// C10 replaces the warp half of the JAX package's kernel 1 with
// model="nsfp" (ops/fused_iteration.py _fwd_sweep_kernel through
// _nsfp_forward_t); C11 replaces the VJP half of kernel 2 with model="nsfp"
// (_bwd_adam_kernel). The sweep stays C1 (nn_dual.cu) and the Adam step C4
// (adam.cu), as for the pyramid levels.
//
// The math, per point x: an L-layer MLP 3 -> w -> ... -> w -> 3 with ReLU
// on all but the last layer (models/baselines.py nsfp_flow, reference
// nets.py:256-292), out = x + mlp(x).
//
// The flat parameter vector is the layer list flattened in the order of
// JAX's ravel_pytree: for each layer its bias [out], then its weight
// [in, out], row-major:
//   layer 0: b [w], w [3, w];  layers 1..L-2: b [w], w [w, w];
//   layer L-1: b [3], w [w, 3]
// (116,483 values at w = 128, L = 9). A hidden layer's bias and weight are
// the [w] and [w, w] row-major arrays that C3's tile products read.
//
// Design: C3's tensor-core tile (level_tile_tc.cuh). A block of C3_THREADS
// threads (16 warps) takes a tile of tp points, a multiple of the 16 rows
// of an m-tile, chosen by the host (ops/fused_iteration.py nsfp_fwd_tile,
// nsfp_bwd_tile). The activations sit in shared memory as [tp][ld] rows
// (c3_ld; zero in the columns from w to the width rounded up to 16). The
// L - 2 hidden layers' products (forward h W, and in C11 the weight
// gradients h^T dz and the cotangents dz W^T) run as 3xTF32 mma.sync
// through c3_layer_fwd, c3_wgrad and c3_layer_cot (the TPU kernel computed
// them as bf16x3 on its MXU); the 3 -> w input layer and the w -> 3 head
// stay f32 on the FMA units, as C3 keeps its posenc layer and heads. Every
// output of a point depends on that point's row alone, so C10's warp does
// not depend on the tile.
//
// C11 recomputes the forward for its tile keeping every layer's
// activations ((L - 1) [tp][ld] buffers and two gradient buffers: 87 KB at
// w = 128, L = 9, tp = 16), backpropagates from the cotangent of the warped
// points (out = x + flow, so it is the flow's cotangent as it stands) and
// writes its own partial gradient vector into row blockIdx.x of an
// [n_blocks, P] buffer; C4 sums the rows in block order, so no atomics are
// needed and a solve repeats bit for bit. ReLU's gradient at exactly 0 is
// 0, as torch.relu's. Where those buffers exceed a block's shared memory
// (a narrow net many layers deep) the host hands C11 a global scratch of
// the same layout, one slice a block.
//
// What bounds them: operations. 2 * 115,456 multiply-adds a point forward
// (0.46 GFLOP for 2000 points), about three times that backward, nearly
// all in the hidden layers; each product is a chain of k-steps of three
// dependent mma.sync and the layers run in series, so the chain, not the
// card's rate, sets the time at 2000 points.
#include "level_tile_tc.cuh"

struct NsfpLayout {
  int w, n_layers, total;
};

__host__ __device__ __forceinline__ int nsfp_total(int w, int n_layers) {
  return 4 * w + (n_layers - 2) * (w + w * w) + 3 + 3 * w;
}

// Offsets of layer l's bias; its weight follows the bias.
__host__ __device__ __forceinline__ int nsfp_bias_off(int w, int l) {
  return l == 0 ? 0 : 4 * w + (l - 1) * (w + w * w);
}

__host__ inline bool nsfp_supported(int w, int n_layers, int tile) {
  return w >= 4 && w <= DP_MAX_WIDTH && w % 4 == 0 && n_layers >= 2 &&
         tile > 0 && tile % C3_MT == 0;
}

// Layers 0..L-2 of the tile (xs [tp][3] loaded and synchronised, zero on
// rows past the end): the input layer on the FMA units, the hidden layers
// on the tensor cores. Layer l's activations go to acts + l * tp * ld
// where KEEP (C11, whose VJP reads every layer), else to one of two
// ping-pong buffers (C10). Returns the last hidden layer's activations;
// ends with __syncthreads().
template <bool KEEP>
__device__ __forceinline__ const float* nsfp_trunk(
    const float* __restrict__ prm, const NsfpLayout L, int tp,
    const float* xs, float* acts) {
  const int W = L.w, wp = c3_wpad(W), ld = c3_ld(W);
  auto layer = [&](int l) { return acts + (KEEP ? l : (l & 1)) * tp * ld; };

  // Input layer (K = 3, FMA): thread column j keeps its weights in
  // registers; zero in the padded columns.
  {
    float* h0 = layer(0);
    const int groups = blockDim.x / wp, j = threadIdx.x % wp;
    if ((int)threadIdx.x < groups * wp) {
      float wi[3], b = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        wi[k] = j < W ? __ldg(prm + W + k * W + j) : 0.f;
      if (j < W) b = __ldg(prm + j);
      for (int p = threadIdx.x / wp; p < tp; p += groups) {
        float v = 0.f;
        if (j < W) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < 3; ++k) acc = fmaf(xs[p * 3 + k], wi[k], acc);
          v = fmaxf(acc + b, 0.f);
        }
        h0[p * ld + j] = v;
      }
    }
  }
  __syncthreads();
  for (int l = 1; l < L.n_layers - 1; ++l) {
    const int off = nsfp_bias_off(W, l);
    c3_layer_fwd(layer(l - 1), layer(l), prm + off + W, prm + off, tp, W, ld);
    __syncthreads();
  }
  return layer(L.n_layers - 2);
}

// One block of C3_THREADS threads a tile of `tp` points: the trunk, then
// the head (w -> 3, FMA) a warp a point, its lanes over the width, summed
// by a fixed shuffle tree, and out = x + flow.
__global__ void __launch_bounds__(C3_THREADS, 1)
    nsfp_fwd_kernel(const float* __restrict__ prm,
                    const float* __restrict__ x, int n, const NsfpLayout L,
                    int tp, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int W = L.w, ld = c3_ld(W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acts = sm;                     // 2 x [tp][ld]
  float* xs = acts + 2 * tp * ld;       // [tp][3]
  const int base = blockIdx.x * tp;

  load_rows(x, n, base, tp, xs);
  __syncthreads();
  const float* hL = nsfp_trunk<false>(prm, L, tp, xs, acts);

  const int off = nsfp_bias_off(W, L.n_layers - 1);
  for (int p = warp; p < tp; p += C3_WARPS) {
    if (base + p >= n) break;
    float acc[3] = {0.f, 0.f, 0.f};
    for (int k = lane; k < W; k += 32) {
      const float h = hL[p * ld + k];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] = fmaf(h, __ldg(prm + off + 3 + k * 3 + c), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c] += __shfl_down_sync(0xffffffffu, acc[c], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[(base + p) * 3 + c] =
            xs[p * 3 + c] + (acc[c] + __ldg(prm + off + c));
    }
  }
}

// One block of C3_THREADS threads a tile of `tp` points: the trunk keeping
// every layer, then the VJP into every entry of the block's partial row.
// The layer and gradient buffers sit in shared memory after xs and gs, or
// in the block's slice of `scratch` where the host gives one.
__global__ void __launch_bounds__(C3_THREADS, 1)
    nsfp_bwd_kernel(const float* __restrict__ prm,
                    const float* __restrict__ x, const float* __restrict__ g,
                    int n, const NsfpLayout L, int tp,
                    float* __restrict__ partial, float* scratch) {
  extern __shared__ __align__(16) float sm[];
  const int W = L.w, NL = L.n_layers, wp = c3_wpad(W), ld = c3_ld(W);
  float* xs = sm;                       // [tp][3]
  float* gs = xs + tp * 3;              // [tp][3]
  float* acts = scratch == nullptr
                    ? gs + tp * 3
                    : scratch + (size_t)blockIdx.x * (NL + 1) * tp * ld;
  float* dz = acts + (NL - 1) * tp * ld;   // (L - 1) x [tp][ld], then
  float* dn = dz + tp * ld;                // two [tp][ld] gradients
  const int base = blockIdx.x * tp;
  float* part = partial + (size_t)blockIdx.x * L.total;

  load_rows(x, n, base, tp, xs);
  load_rows(g, n, base, tp, gs);
  __syncthreads();
  const float* hL = nsfp_trunk<true>(prm, L, tp, xs, acts);

  // Head, w -> 3: its bias and weight gradients, and the cotangent of the
  // last hidden layer, masked by its ReLU.
  {
    const int off = nsfp_bias_off(W, NL - 1);
    for (int c = threadIdx.x; c < 3; c += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < tp; ++p) s += gs[p * 3 + c];
      part[off + c] = s;
    }
    for (int i = threadIdx.x; i < W * 3; i += blockDim.x) {
      const int k = i / 3, c = i - 3 * k;
      float s = 0.f;
      for (int p = 0; p < tp; ++p) s = fmaf(hL[p * ld + k], gs[p * 3 + c], s);
      part[off + 3 + i] = s;
    }
    for (int i = threadIdx.x; i < tp * wp; i += blockDim.x) {
      const int p = i / wp, k = i - p * wp;
      float s = 0.f;
      if (k < W) {
        for (int c = 0; c < 3; ++c)
          s = fmaf(__ldg(prm + off + 3 + k * 3 + c), gs[p * 3 + c], s);
      }
      dz[p * ld + k] = hL[p * ld + k] > 0.f ? s : 0.f;
    }
    __syncthreads();
  }

  // Hidden layers, last to first; dz holds d(loss)/d(pre-activations of
  // l): its bias gradient, its weight gradient and the next dz.
  for (int l = NL - 2; l >= 1; --l) {
    const float* hprev = acts + (l - 1) * tp * ld;
    const int off = nsfp_bias_off(W, l);
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < tp; ++p) s += dz[p * ld + j];
      part[off + j] = s;
    }
    c3_layer_cot(dz, dn, hprev, prm + off + W, tp, W, ld);
    c3_wgrad<false>(hprev, dz, part + off + W, tp, W, ld);
    __syncthreads();
    float* tmp = dz;
    dz = dn;
    dn = tmp;
  }

  // Input layer, 3 -> w (FMA): part[k * W + j] is its bias (k = 0) and its
  // weight row k - 1.
  for (int i = threadIdx.x; i < 4 * W; i += blockDim.x) {
    const int k = i / W, j = i - k * W;
    float s = 0.f;
    if (k == 0) {
      for (int p = 0; p < tp; ++p) s += dz[p * ld + j];
    } else {
      for (int p = 0; p < tp; ++p)
        s = fmaf(xs[p * 3 + k - 1], dz[p * ld + j], s);
    }
    part[i] = s;
  }
}

extern "C" int dp_nsfp_fwd(const void* prm, const void* x, int n, int width,
                           int n_layers, void* out, int tile, void* stream) {
  if (!nsfp_supported(width, n_layers, tile))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const NsfpLayout L = {width, n_layers, nsfp_total(width, n_layers)};
  const size_t smem =
      sizeof(float) * (2 * (size_t)tile * c3_ld(width) + 3 * (size_t)tile);
  cudaError_t err = cudaFuncSetAttribute(
      nsfp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nsfp_fwd_kernel<<<(n + tile - 1) / tile, C3_THREADS, smem,
                    (cudaStream_t)stream>>>((const float*)prm,
                                            (const float*)x, n, L, tile,
                                            (float*)out);
  return (int)cudaGetLastError();
}

// `partial` is [n_rows, P], one row a block of `tile` points; `scratch`,
// where not null, holds each block's (L + 1) x [tile][ld] buffers in place
// of shared memory.
extern "C" int dp_nsfp_bwd(const void* prm, const void* x, const void* g,
                           int n, int width, int n_layers, void* partial,
                           int n_rows, int tile, void* scratch,
                           void* stream) {
  if (!nsfp_supported(width, n_layers, tile))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + tile - 1) / tile;
  if (n_rows != blocks) return (int)cudaErrorInvalidValue;
  const NsfpLayout L = {width, n_layers, nsfp_total(width, n_layers)};
  const size_t smem =
      sizeof(float) * (6 * (size_t)tile +
                       (scratch == nullptr
                            ? (size_t)(n_layers + 1) * tile * c3_ld(width)
                            : 0));
  cudaError_t err = cudaFuncSetAttribute(
      nsfp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nsfp_bwd_kernel<<<blocks, C3_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)prm, (const float*)x, (const float*)g, n, L, tile,
      (float*)partial, (float*)scratch);
  return (int)cudaGetLastError();
}
