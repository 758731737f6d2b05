// C8 flash_attention_bwd_dkv and C9 flash_attention_bwd_dq: the backward of
// the streamed multi-head attention C7 (flash_attention.cu).
//
// With s = q k^T * sm_scale over the valid source prefix, p = exp(s - lse)
// (lse the row log-sum-exp that C7 wrote), o = p v and the upstream
// gradient do:
//
//   delta[l, h] = sum_c do[l, h, c] * o[l, h, c]       (the caller's, one
//                                                      elementwise pass)
//   dp = do v^T            ds = p * (dp - delta)
//   dv = p^T do            dk = ds^T q * sm_scale      (C8)
//   dq = ds k * sm_scale                               (C9)
//
// q, do, dq [L, H, d]; k, v, dk, dv [S, H, d]; lse, delta [L, H]; all f32 and
// row-major. The [L, S, H] probabilities are recomputed tile by tile and
// never reach global memory.
//
// Replaces the two backward kernels of the stock Pallas TPU flash attention
// that the JAX package's match/attention.py _flash_attention differentiates
// through (_flash_attention_bwd_dkv and _flash_attention_bwd_dq). As there,
// two kernels so that every output element has one owner and no atomic add
// is needed: C8's blocks own a tile of source rows and a head and loop over
// the query tiles; C9's blocks own a tile of query rows and a head and loop
// over the source tiles. Each repeats bit for bit.
//
// What bounds them: 10 * L * src_len * H * d operations on the f32 FMA units
// (three products in C8, two in C9, the logits and dp recomputed in both:
// 6 : 4 of the function's five); all operands together are ~35 MB at
// L = S = 4096, H = 4, d = 132 and stay in L2, so bytes do not bind. Exact
// f32 as in C7: FMA accumulation, full-precision expf, no tensor cores.
//
// Design (both): one block of 256 threads, a 16 x 16 thread grid with 4 x 4
// register tiles of the 64 x 64 logits and of dp, computed in one sweep over
// d from tiles in shared memory (16-byte loads); then the products that sum
// over the tile's rows, where each thread keeps 4 rows x 9 column slots of
// its outputs (two such accumulators in C8). The source side of the sweep
// (16 threads, 16 different rows) needs its tiles transposed ([d][68]); the
// query side reads one address for all 16 threads, so row-major tiles serve
// it. C8 therefore keeps its own K and V transposed for the whole block and
// streams Q and dO row-major, one load for both kinds of product. C9 keeps
// its own Q and dO transposed and streams K and V transposed, then loads K
// again row-major into the same buffer for dQ. Source rows at or beyond
// src_len are never loaded (zeros take their place, so NaN there cannot
// leak) and get zero dk, dv; every query row below L attends; src_len == 0
// gives zero dq without reading lse (-inf there). 174 KB (C8) and 161 KB
// (C9) of shared memory at d = 132: one block an SM. Any L, S >= 0 and any
// head width 1 <= d <= 144.
#include <cuda_runtime.h>
#include <math.h>

#define FB_BT 64        // rows per tile, both operands
#define FB_LD 68        // padded row of the transposed tiles (16-byte aligned)
#define FB_THREADS 256
#define FB_DMAX 144     // 9 output columns per thread x 16 threads
#define FB_OC 9

// dst[c][r] = x[row0 + r, head, c] for the tile's 64 rows; rows at or beyond
// ``limit`` give zeros and are not read.
__device__ __forceinline__ void fb_load_transposed(
    float* __restrict__ dst, const float* __restrict__ x, int row0, int limit,
    size_t stride, int head, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < FB_BT; r += FB_THREADS / 32) {
    const int row = row0 + r;
    const float* src = x + (size_t)row * stride + (size_t)head * d;
    for (int c = lane; c < d; c += 32)
      dst[c * FB_LD + r] = row < limit ? src[c] : 0.f;
  }
}

// dst[r][c] = x[row0 + r, head, c] with rows of ``ld`` >= d floats; rows at
// or beyond ``limit`` and columns d .. ld - 1 zero.
__device__ __forceinline__ void fb_load_rows(
    float* __restrict__ dst, const float* __restrict__ x, int row0, int limit,
    size_t stride, int head, int d, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < FB_BT; r += FB_THREADS / 32) {
    const int row = row0 + r;
    const float* src = x + (size_t)row * stride + (size_t)head * d;
    for (int c = lane; c < ld; c += 32)
      dst[r * ld + c] = row < limit && c < d ? src[c] : 0.f;
  }
}

// From the raw products s = q k^T (in ``p``) and dp = do v^T (in ``ds``) of
// query rows ty*4 + i of the tile at l0 and source rows tx*4 + j of the tile
// at s0: p = exp(s * scale - lse) and ds = p * (dp - delta). Query rows at
// or beyond L and source rows at or beyond src_len give p = ds = 0.
__device__ __forceinline__ void fb_p_ds(
    const float* __restrict__ lse, const float* __restrict__ delta, int l0,
    int s0, int L, int src_len, int H, int head, float sm_scale,
    float (&p)[4][4], float (&ds)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = l0 + ty * 4 + i;
    const bool in = row < L;
    const float lse_r = in ? lse[(size_t)row * H + head] : 0.f;
    const float delta_r = in ? delta[(size_t)row * H + head] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = in && s0 + tx * 4 + j < src_len;
      const float pr = valid ? expf(p[i][j] * sm_scale - lse_r) : 0.f;
      p[i][j] = pr;
      ds[i][j] = valid ? pr * (ds[i][j] - delta_r) : 0.f;
    }
  }
}

// Both products in one sweep over d, all four tiles transposed ([d][FB_LD]).
__device__ __forceinline__ void fb_products_tt(
    const float* __restrict__ Qt, const float* __restrict__ Kt,
    const float* __restrict__ Gt, const float* __restrict__ Vt, int d,
    float (&p)[4][4], float (&ds)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[i][j] = 0.f;
      ds[i][j] = 0.f;
    }
#pragma unroll 2
  for (int c = 0; c < d; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(Qt + c * FB_LD + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Kt + c * FB_LD + tx * 4);
    const float4 e = *reinterpret_cast<const float4*>(Gt + c * FB_LD + ty * 4);
    const float4 f = *reinterpret_cast<const float4*>(Vt + c * FB_LD + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
    const float ev[4] = {e.x, e.y, e.z, e.w};
    const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = fmaf(av[i], bv[j], p[i][j]);
        ds[i][j] = fmaf(ev[i], fv[j], ds[i][j]);
      }
  }
}

// The same products with the query-side tiles row-major ([FB_BT][dp], dp = d
// rounded up to 4, the tail zero) and the source-side tiles transposed with
// dp rows (rows d.. zero): four columns a step. The 16 threads of a query
// row read one address (a broadcast), so the row-major side needs no
// transposed copy.
__device__ __forceinline__ void fb_products_rt(
    const float* __restrict__ Qr, const float* __restrict__ Kt,
    const float* __restrict__ Gr, const float* __restrict__ Vt, int dp,
    float (&p)[4][4], float (&ds)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[i][j] = 0.f;
      ds[i][j] = 0.f;
    }
  for (int c = 0; c < dp; c += 4) {
    float av[4][4], ev[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(Qr + (ty * 4 + i) * dp + c);
      const float4 e =
          *reinterpret_cast<const float4*>(Gr + (ty * 4 + i) * dp + c);
      av[i][0] = a.x; av[i][1] = a.y; av[i][2] = a.z; av[i][3] = a.w;
      ev[i][0] = e.x; ev[i][1] = e.y; ev[i][2] = e.z; ev[i][3] = e.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 b =
          *reinterpret_cast<const float4*>(Kt + (c + cc) * FB_LD + tx * 4);
      const float4 f =
          *reinterpret_cast<const float4*>(Vt + (c + cc) * FB_LD + tx * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[i][j] = fmaf(av[i][cc], bv[j], p[i][j]);
          ds[i][j] = fmaf(ev[i][cc], fv[j], ds[i][j]);
        }
    }
  }
}

__global__ void __launch_bounds__(FB_THREADS, 1)
flash_attention_bwd_dkv_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ src_len_p, int L, int S,
                               int H, int d, float sm_scale,
                               float* __restrict__ dk, float* __restrict__ dv) {
  extern __shared__ __align__(16) float fb_smem[];
  const int dp = (d + 3) & ~3;       // d rounded up to whole float4s
  float* Kt = fb_smem;               // [dp][FB_LD], the block's source rows
  float* Vt = Kt + dp * FB_LD;       // [dp][FB_LD]
  float* Qb = Vt + dp * FB_LD;       // [FB_BT][dp], the streamed query tile
  float* Gb = Qb + FB_BT * dp;       // [FB_BT][dp], its upstream gradient
  float* Pb = Gb + FB_BT * dp;       // [FB_BT][FB_LD]: Pb[r][n] = p[r][n]
  float* Sb = Pb + FB_BT * FB_LD;    // [FB_BT][FB_LD]: Sb[r][n] = ds[r][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.y;
  const int s0 = blockIdx.x * FB_BT;
  const size_t stride = (size_t)H * d;
  const int slots = (d + 15) >> 4;   // output column slots in use (<= FB_OC)

  int src_len = *src_len_p;
  src_len = src_len < 0 ? 0 : (src_len > S ? S : src_len);

  float dk_acc[4][FB_OC], dv_acc[4][FB_OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < FB_OC; ++jj) {
      dk_acc[i][jj] = 0.f;
      dv_acc[i][jj] = 0.f;
    }

  if (s0 < src_len) {
    fb_load_transposed(Kt, k, s0, src_len, stride, head, d);
    fb_load_transposed(Vt, v, s0, src_len, stride, head, d);
    for (int i = d * FB_LD + tid; i < dp * FB_LD; i += FB_THREADS) {
      Kt[i] = 0.f;
      Vt[i] = 0.f;
    }
    for (int l0 = 0; l0 < L; l0 += FB_BT) {
      __syncthreads();  // the previous tile's accumulation is done
      fb_load_rows(Qb, q, l0, L, stride, head, d, dp);
      fb_load_rows(Gb, dout, l0, L, stride, head, d, dp);
      __syncthreads();

      float p[4][4], ds[4][4];
      fb_products_rt(Qb, Kt, Gb, Vt, dp, p, ds);
      fb_p_ds(lse, delta, l0, s0, L, src_len, H, head, sm_scale, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(Pb + (ty * 4 + i) * FB_LD + tx * 4) =
            make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
        *reinterpret_cast<float4*>(Sb + (ty * 4 + i) * FB_LD + tx * 4) =
            make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
      }
      __syncthreads();

      // source rows ty*4 + i, columns tx + 16 jj:
      //   dv += p[r][.] do[r][.], dk += ds[r][.] q[r][.] over query rows r.
      // A column slot at or beyond d reads shared memory past the row (inside
      // the block's allocation) into an accumulator that is never stored.
#pragma unroll 2
      for (int r = 0; r < FB_BT; ++r) {
        const float4 pp =
            *reinterpret_cast<const float4*>(Pb + r * FB_LD + ty * 4);
        const float4 ss =
            *reinterpret_cast<const float4*>(Sb + r * FB_LD + ty * 4);
        const float* qr = Qb + r * dp + tx;
        const float* gr = Gb + r * dp + tx;
#pragma unroll
        for (int jj = 0; jj < FB_OC; ++jj) {
          if (jj < slots) {
            const float g = gr[16 * jj];
            const float qq = qr[16 * jj];
            dv_acc[0][jj] = fmaf(pp.x, g, dv_acc[0][jj]);
            dv_acc[1][jj] = fmaf(pp.y, g, dv_acc[1][jj]);
            dv_acc[2][jj] = fmaf(pp.z, g, dv_acc[2][jj]);
            dv_acc[3][jj] = fmaf(pp.w, g, dv_acc[3][jj]);
            dk_acc[0][jj] = fmaf(ss.x, qq, dk_acc[0][jj]);
            dk_acc[1][jj] = fmaf(ss.y, qq, dk_acc[1][jj]);
            dk_acc[2][jj] = fmaf(ss.z, qq, dk_acc[2][jj]);
            dk_acc[3][jj] = fmaf(ss.w, qq, dk_acc[3][jj]);
          }
        }
      }
    }
  }

  // rows at or beyond src_len kept zero accumulators
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = s0 + ty * 4 + i;
    if (row < S) {
      const size_t off = (size_t)row * stride + (size_t)head * d;
#pragma unroll
      for (int jj = 0; jj < FB_OC; ++jj) {
        const int c = tx + 16 * jj;
        if (c < d) {
          dk[off + c] = row < src_len ? dk_acc[i][jj] * sm_scale : 0.f;
          dv[off + c] = row < src_len ? dv_acc[i][jj] : 0.f;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(FB_THREADS, 1)
flash_attention_bwd_dq_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ src_len_p, int L, int S,
                              int H, int d, float sm_scale,
                              float* __restrict__ dq) {
  extern __shared__ __align__(16) float fb_smem[];
  float* Qt = fb_smem;               // [d][FB_LD], the block's query rows
  float* Gt = Qt + d * FB_LD;        // dO^T [d][FB_LD]
  float* Kb = Gt + d * FB_LD;        // K^T [d][FB_LD], then K [FB_BT][d]
  float* Vt = Kb + d * FB_LD;        // [d][FB_LD]
  float* St = Vt + d * FB_LD;        // [FB_BT][FB_LD]: St[n][r] = ds[r][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.y;
  const int l0 = blockIdx.x * FB_BT;
  const size_t stride = (size_t)H * d;
  const int slots = (d + 15) >> 4;

  int src_len = *src_len_p;
  src_len = src_len < 0 ? 0 : (src_len > S ? S : src_len);

  float acc[4][FB_OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < FB_OC; ++jj) acc[i][jj] = 0.f;

  fb_load_transposed(Qt, q, l0, L, stride, head, d);
  fb_load_transposed(Gt, dout, l0, L, stride, head, d);

  for (int s0 = 0; s0 < src_len; s0 += FB_BT) {
    __syncthreads();  // the previous tile's accumulation is done
    fb_load_transposed(Kb, k, s0, src_len, stride, head, d);
    fb_load_transposed(Vt, v, s0, src_len, stride, head, d);
    __syncthreads();

    float p[4][4], ds[4][4];
    fb_products_tt(Qt, Kb, Gt, Vt, d, p, ds);
    fb_p_ds(lse, delta, l0, s0, L, src_len, H, head, sm_scale, p, ds);
    __syncthreads();  // every thread is done with K^T

#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(St + (tx * 4 + j) * FB_LD + ty * 4) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    fb_load_rows(Kb, k, s0, src_len, stride, head, d, d);
    __syncthreads();

    // query rows ty*4 + i, columns tx + 16 jj: dq += ds[.][n] k[n][.]
#pragma unroll 2
    for (int n = 0; n < FB_BT; ++n) {
      const float4 ss =
          *reinterpret_cast<const float4*>(St + n * FB_LD + ty * 4);
      const float* kr = Kb + n * d + tx;
#pragma unroll
      for (int jj = 0; jj < FB_OC; ++jj) {
        if (jj < slots) {
          const float kk = kr[16 * jj];
          acc[0][jj] = fmaf(ss.x, kk, acc[0][jj]);
          acc[1][jj] = fmaf(ss.y, kk, acc[1][jj]);
          acc[2][jj] = fmaf(ss.z, kk, acc[2][jj]);
          acc[3][jj] = fmaf(ss.w, kk, acc[3][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = l0 + ty * 4 + i;
    if (row < L) {
      float* dst = dq + (size_t)row * stride + (size_t)head * d;
#pragma unroll
      for (int jj = 0; jj < FB_OC; ++jj) {
        const int c = tx + 16 * jj;
        if (c < d) dst[c] = acc[i][jj] * sm_scale;
      }
    }
  }
}

static bool fb_bad_shape(int L, int S, int H, int d) {
  return d < 1 || d > FB_DMAX || L < 0 || S < 0 || H < 0;
}

extern "C" int dp_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          const void* src_len, int L, int S,
                                          int H, int d, float sm_scale,
                                          void* dk, void* dv, void* stream) {
  if (fb_bad_shape(L, S, H, d)) return (int)cudaErrorInvalidValue;
  if (S > 0 && H > 0) {
    const int dp = (d + 3) & ~3;
    const size_t smem = (size_t)(2 * dp * FB_LD + 2 * FB_BT * dp +
                                 2 * FB_BT * FB_LD) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bwd_dkv_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + FB_BT - 1) / FB_BT, H);
    flash_attention_bwd_dkv_kernel<<<grid, FB_THREADS, smem,
                                     (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (const int*)src_len, L, S, H,
        d, sm_scale, (float*)dk, (float*)dv);
  }
  return (int)cudaGetLastError();
}

extern "C" int dp_flash_attention_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         const void* src_len, int L, int S,
                                         int H, int d, float sm_scale,
                                         void* dq, void* stream) {
  if (fb_bad_shape(L, S, H, d)) return (int)cudaErrorInvalidValue;
  if (L > 0 && H > 0) {
    const size_t smem =
        (size_t)(4 * d * FB_LD + FB_BT * FB_LD) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bwd_dq_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + FB_BT - 1) / FB_BT, H);
    flash_attention_bwd_dq_kernel<<<grid, FB_THREADS, smem,
                                    (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (const int*)src_len, L, S, H,
        d, sm_scale, (float*)dq);
  }
  return (int)cudaGetLastError();
}
