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
// nets.py:256-292), out = x + mlp(x). Plain f32 FMAs (the TPU kernel's
// three-pass bf16 products were a way to f32 accuracy on its matrix unit,
// not semantics).
//
// The flat parameter vector is the layer list flattened in the order of
// JAX's ravel_pytree: for each layer its bias [out], then its weight
// [in, out], row-major:
//   layer 0: b [w], w [3, w];  layers 1..L-2: b [w], w [w, w];
//   layer L-1: b [3], w [w, 3]
// (116,483 values at w = 128, L = 9). Every offset is a multiple of w, so
// with w a multiple of 4 every weight row is 16-byte aligned.
//
// Design. One block takes a tile of TP points and has one thread per hidden
// unit. Activations sit in shared memory unit-major, [w][TP + 4]: for one
// input unit k the TP values of the tile are contiguous, so a thread that
// accumulates its own output unit over k reads them as TP / 4 broadcast
// 16-byte loads for TP FMAs (the pyramid's tile keeps them point-major and
// pays one load per FMA); the pad of 4 keeps the 16-byte stores of
// neighbouring threads on distinct banks. A hidden layer's weight column is
// read once per block from L2, coalesced across threads.
//
// C11 recomputes the forward for its tile keeping the activations of
// every layer (L-1 buffers of w x (TP + 4) floats: 82 KB at w = 128, L = 9,
// TP = 16, plus two gradient buffers, 102 KB in all, two blocks an SM),
// backpropagates from the cotangent of the warped points (out = x + flow, so
// it is the flow's cotangent as it stands) and writes its own partial
// gradient vector into row blockIdx.x of an [n_blocks, P] buffer; C4 sums
// the rows in block order, so no atomics are needed and a solve repeats bit
// for bit. ReLU's gradient at exactly 0 is 0, as torch.relu's.
//
// What bounds them: operations. 2 * 115,456 multiply-adds a point forward
// (0.46 GFLOP for 2000 points), about three times that backward; at 2000
// points the 125 blocks of 16 points are one partial wave on 132 SMs, so
// the serial chain of L layers and the shared-memory reads set the time,
// not the card's f32 rate.
#include "common.cuh"

#define NSFP_TP 16
#define NSFP_TPP (NSFP_TP + 4)

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

__host__ inline bool nsfp_supported(int w, int n_layers) {
  return w >= 4 && w <= DP_MAX_WIDTH && w % 4 == 0 && n_layers >= 2;
}

__host__ inline int nsfp_threads(int w) { return ((w + 31) / 32) * 32; }

// Loads the tile's rows of an [n, 3] array as xs[c * TP + p] (zero past
// the end).
__device__ __forceinline__ void nsfp_load_rows(const float* __restrict__ src,
                                               int n, int base, float* dst) {
  for (int i = threadIdx.x; i < NSFP_TP * 3; i += blockDim.x) {
    const int p = i / 3, c = i % 3;
    dst[c * NSFP_TP + p] = (base + p < n) ? src[(base + p) * 3 + c] : 0.f;
  }
}

__device__ __forceinline__ void store_unit(float* dst, const float* acc) {
#pragma unroll
  for (int q = 0; q < NSFP_TP / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] =
        make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

__device__ __forceinline__ void load_unit(const float* src, float* v) {
#pragma unroll
  for (int q = 0; q < NSFP_TP / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(src)[q];
    v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
  }
}

// Layers 0..L-2 of the tile. Layer l's activations go to
// acts + l * w * TPP (keep_all) or to one of two ping-pong buffers; returns
// the last hidden layer's activations. Ends with __syncthreads().
__device__ __forceinline__ const float* nsfp_trunk(
    const float* __restrict__ prm, const NsfpLayout L, const float* xs,
    float* acts, bool keep_all) {
  const int W = L.w;
  float* cur = acts;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    float acc[NSFP_TP];
    const float b = prm[j];
#pragma unroll
    for (int p = 0; p < NSFP_TP; ++p) acc[p] = b;
    for (int k = 0; k < 3; ++k) {
      const float wk = prm[W + k * W + j];
#pragma unroll
      for (int p = 0; p < NSFP_TP; ++p)
        acc[p] = fmaf(xs[k * NSFP_TP + p], wk, acc[p]);
    }
#pragma unroll
    for (int p = 0; p < NSFP_TP; ++p) acc[p] = fmaxf(acc[p], 0.f);
    store_unit(cur + j * NSFP_TPP, acc);
  }
  __syncthreads();
  for (int l = 1; l < L.n_layers - 1; ++l) {
    const float* prev = cur;
    cur = acts + (keep_all ? l : (l & 1)) * W * NSFP_TPP;
    const int off = nsfp_bias_off(W, l);
    const float* Wl = prm + off + W;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      float acc[NSFP_TP];
      const float b = prm[off + j];
#pragma unroll
      for (int p = 0; p < NSFP_TP; ++p) acc[p] = b;
#pragma unroll 4
      for (int k = 0; k < W; ++k) {
        const float wk = Wl[k * W + j];
        float h[NSFP_TP];
        load_unit(prev + k * NSFP_TPP, h);
#pragma unroll
        for (int p = 0; p < NSFP_TP; ++p) acc[p] = fmaf(h[p], wk, acc[p]);
      }
#pragma unroll
      for (int p = 0; p < NSFP_TP; ++p) acc[p] = fmaxf(acc[p], 0.f);
      store_unit(cur + j * NSFP_TPP, acc);
    }
    __syncthreads();
  }
  return cur;
}

__global__ void nsfp_fwd_kernel(const float* __restrict__ prm,
                                const float* __restrict__ x, int n,
                                const NsfpLayout L,
                                float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                       // [3][TP]
  float* acts = xs + 3 * NSFP_TP;       // 2 x [w][TPP]
  const int base = blockIdx.x * NSFP_TP;
  const int W = L.w;

  nsfp_load_rows(x, n, base, xs);
  __syncthreads();
  const float* h = nsfp_trunk(prm, L, xs, acts, false);

  // Last layer, w -> 3: one thread per (point, coordinate).
  const int off = nsfp_bias_off(W, L.n_layers - 1);
  for (int i = threadIdx.x; i < NSFP_TP * 3; i += blockDim.x) {
    const int p = i / 3, c = i % 3;
    if (base + p >= n) continue;
    float acc = prm[off + c];
    for (int k = 0; k < W; ++k)
      acc = fmaf(h[k * NSFP_TPP + p], prm[off + 3 + k * 3 + c], acc);
    out[(base + p) * 3 + c] = xs[c * NSFP_TP + p] + acc;
  }
}

// The bound (up to 256 threads, two blocks an SM) leaves 128 registers a
// thread for the two TP-wide register tiles of the weight-gradient loop.
__global__ void __launch_bounds__(DP_MAX_WIDTH, 2)
    nsfp_bwd_kernel(const float* __restrict__ prm, const float* __restrict__ x,
                    const float* __restrict__ g, int n, const NsfpLayout L,
                    float* __restrict__ partial) {
  extern __shared__ __align__(16) float sm[];
  const int W = L.w;
  const int NL = L.n_layers;
  float* xs = sm;                            // [3][TP]
  float* gs = xs + 3 * NSFP_TP;              // [3][TP]
  float* acts = gs + 3 * NSFP_TP;            // (L-1) x [w][TPP]
  float* dA = acts + (NL - 1) * W * NSFP_TPP;
  float* dB = dA + W * NSFP_TPP;
  const int base = blockIdx.x * NSFP_TP;
  float* part = partial + (size_t)blockIdx.x * L.total;

  nsfp_load_rows(x, n, base, xs);
  nsfp_load_rows(g, n, base, gs);
  __syncthreads();
  nsfp_trunk(prm, L, xs, acts, true);

  // Last layer, w -> 3: its bias and weight gradients, and the cotangent
  // of the last hidden layer's activations.
  {
    const int off = nsfp_bias_off(W, NL - 1);
    const float* hl = acts + (NL - 2) * W * NSFP_TPP;
    for (int c = threadIdx.x; c < 3; c += blockDim.x) {
      float s = 0.f;
      for (int p = 0; p < NSFP_TP; ++p) s += gs[c * NSFP_TP + p];
      part[off + c] = s;
    }
    for (int k = threadIdx.x; k < W; k += blockDim.x) {
      float h[NSFP_TP], d[NSFP_TP];
      load_unit(hl + k * NSFP_TPP, h);
#pragma unroll
      for (int p = 0; p < NSFP_TP; ++p) d[p] = 0.f;
      for (int c = 0; c < 3; ++c) {
        const float wkc = prm[off + 3 + k * 3 + c];
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < NSFP_TP; ++p) {
          const float gp = gs[c * NSFP_TP + p];
          s = fmaf(h[p], gp, s);
          d[p] = fmaf(wkc, gp, d[p]);
        }
        part[off + 3 + k * 3 + c] = s;
      }
      store_unit(dA + k * NSFP_TPP, d);
    }
    __syncthreads();
  }

  // Hidden layers w -> w, last to first. dA holds d(loss)/d(activations
  // of layer l).
  for (int l = NL - 2; l >= 1; --l) {
    const float* hl = acts + l * W * NSFP_TPP;
    const float* hprev = acts + (l - 1) * W * NSFP_TPP;
    const int off = nsfp_bias_off(W, l);
    const float* Wl = prm + off + W;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      float h[NSFP_TP], dz[NSFP_TP];
      load_unit(hl + j * NSFP_TPP, h);
      load_unit(dA + j * NSFP_TPP, dz);
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < NSFP_TP; ++p) {
        dz[p] = h[p] > 0.f ? dz[p] : 0.f;
        s += dz[p];
      }
      part[off + j] = s;
      store_unit(dA + j * NSFP_TPP, dz);
      // weight gradient column j: sum over the tile of hprev[k] dz[j]
      float* pw = part + off + W + j;
#pragma unroll 4
      for (int k = 0; k < W; ++k) {
        float hp[NSFP_TP];
        load_unit(hprev + k * NSFP_TPP, hp);
        float t = 0.f;
#pragma unroll
        for (int p = 0; p < NSFP_TP; ++p) t = fmaf(hp[p], dz[p], t);
        pw[k * W] = t;
      }
    }
    __syncthreads();
    // cotangent of layer l-1's activations: dB[k] = sum_j W[k][j] dz[j]
    for (int k = threadIdx.x; k < W; k += blockDim.x) {
      float acc[NSFP_TP];
#pragma unroll
      for (int p = 0; p < NSFP_TP; ++p) acc[p] = 0.f;
      const float4* wrow = reinterpret_cast<const float4*>(Wl + k * W);
      for (int j4 = 0; j4 < W / 4; ++j4) {
        const float4 w4 = wrow[j4];
        const float wj[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float dz[NSFP_TP];
          load_unit(dA + (4 * j4 + jj) * NSFP_TPP, dz);
#pragma unroll
          for (int p = 0; p < NSFP_TP; ++p) acc[p] = fmaf(wj[jj], dz[p], acc[p]);
        }
      }
      store_unit(dB + k * NSFP_TPP, acc);
    }
    __syncthreads();
    float* tmp = dA;
    dA = dB;
    dB = tmp;
  }

  // Layer 0, 3 -> w.
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    float h[NSFP_TP], dz[NSFP_TP];
    load_unit(acts + j * NSFP_TPP, h);
    load_unit(dA + j * NSFP_TPP, dz);
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < NSFP_TP; ++p) {
      dz[p] = h[p] > 0.f ? dz[p] : 0.f;
      s += dz[p];
    }
    part[j] = s;
    for (int k = 0; k < 3; ++k) {
      float t = 0.f;
#pragma unroll
      for (int p = 0; p < NSFP_TP; ++p) t = fmaf(xs[k * NSFP_TP + p], dz[p], t);
      part[W + k * W + j] = t;
    }
  }
}

extern "C" int dp_nsfp_fwd(const void* prm, const void* x, int n, int width,
                           int n_layers, void* out, void* stream) {
  if (!nsfp_supported(width, n_layers)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const NsfpLayout L = {width, n_layers, nsfp_total(width, n_layers)};
  const size_t smem =
      sizeof(float) * (3 * NSFP_TP + 2 * (size_t)width * NSFP_TPP);
  const int blocks = (n + NSFP_TP - 1) / NSFP_TP;
  nsfp_fwd_kernel<<<blocks, nsfp_threads(width), smem, (cudaStream_t)stream>>>(
      (const float*)prm, (const float*)x, n, L, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int dp_nsfp_bwd(const void* prm, const void* x, const void* g,
                           int n, int width, int n_layers, void* partial,
                           int n_rows, void* stream) {
  if (!nsfp_supported(width, n_layers)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // The caller sizes `partial` as [n_rows, P]; each block writes one row.
  const int blocks = (n + NSFP_TP - 1) / NSFP_TP;
  if (n_rows != blocks) return (int)cudaErrorInvalidValue;
  const NsfpLayout L = {width, n_layers, nsfp_total(width, n_layers)};
  const size_t smem =
      sizeof(float) *
      (6 * NSFP_TP + (size_t)(n_layers - 1 + 2) * width * NSFP_TPP);
  cudaError_t err = cudaFuncSetAttribute(
      nsfp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nsfp_bwd_kernel<<<blocks, nsfp_threads(width), smem, (cudaStream_t)stream>>>(
      (const float*)prm, (const float*)x, (const float*)g, n, L,
      (float*)partial);
  return (int)cudaGetLastError();
}
