// C7 flash_attention_fwd: multi-head attention streamed over the source
// rows with an online softmax, for one cloud pair of the Lepard matcher.
//
//   o[l, h, :] = sum_s softmax_s(q[l, h, :] . k[s, h, :] * sm_scale) v[s, h, :]
//
// over the valid source prefix s < src_len. q [L, H, d], k and v [S, H, d],
// o [L, H, d], all f32 and row-major. The [L, S, H] logits never reach
// global memory.
//
// Replaces the JAX package's match/attention.py _flash_attention (the stock
// Pallas TPU flash attention with segment ids for the padding). That
// kernel pads the head width 132 to 256 lanes and needs L and S to be
// multiples of 128; this one takes any L, S >= 0 and any head width
// 1 <= d <= 144 as it is.
//
// What bounds it: 4 * L * src_len * H * d operations (two products) on the
// f32 FMA units; q, k, v and o together are ~17 MB at L = S = 2048, H = 4,
// d = 132 and stay in L2, so bytes do not bind. Exact f32: FMA
// accumulation and full-precision expf, no tensor cores (TF32 would put
// ~1e-3 into logits that the dual softmax divides by a temperature of 0.1).
//
// Design: one block of 256 threads per (tile of 64 query rows, head). The
// Q tile sits transposed in shared memory for the whole block; K tiles of
// 64 rows stream through a second buffer, transposed, so that the 16 x 16
// thread grid computes the 64 x 64 logits as 4 x 4 register tiles from two
// 16-byte shared loads per step of d. Each thread keeps the running max
// and sum of its 4 rows (the 16 threads of a row share them by shuffles),
// rescales its 4 x 9 slice of the output accumulator on a new max, writes
// the tile's probabilities transposed to shared memory, and the V tile then
// takes the K buffer's place for the second product. 89 KB of shared memory
// at d = 132: two blocks an SM. src_len is read on the device; rows at or
// beyond it are never loaded, and src_len == 0 gives zeros.
//
// Where the caller needs a gradient it passes ``lse`` [L, H]: the kernel
// then also writes each row's log-sum-exp m + log(l) of the scaled logits
// (-inf for an empty prefix), which the backward kernels C8 and C9
// (flash_attention_bwd.cu) recompute the probabilities from. A null ``lse``
// (inference) writes nothing more.
#include <cuda_runtime.h>
#include <math.h>

#define FA_BM 64        // query rows per block
#define FA_BN 64        // source rows per tile
#define FA_LD 68        // padded row of the transposed tiles (16-byte aligned)
#define FA_THREADS 256
#define FA_DMAX 144     // 9 output columns per thread x 16 threads
#define FA_OC 9

__global__ void __launch_bounds__(FA_THREADS, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ src_len_p, int L, int S, int H,
                       int d, float sm_scale, float* __restrict__ out,
                       float* __restrict__ lse) {
  extern __shared__ __align__(16) float fa_smem[];
  float* Qt = fa_smem;              // [d][FA_LD]: Qt[c][r] = q[l0 + r, head, c]
  float* KV = Qt + d * FA_LD;       // K^T [d][FA_LD], then V [FA_BN][d]
  float* Pt = KV + d * FA_LD;       // [FA_BN][FA_LD]: Pt[n][r] = p[r][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int head = blockIdx.y;
  const int l0 = blockIdx.x * FA_BM;
  const size_t stride = (size_t)H * d;
  const int slots = (d + 15) >> 4;  // output column slots in use (<= FA_OC)

  int src_len = *src_len_p;
  src_len = src_len < 0 ? 0 : (src_len > S ? S : src_len);

  for (int r = warp; r < FA_BM; r += FA_THREADS / 32) {
    const int row = l0 + r;
    const float* src = q + (size_t)row * stride + (size_t)head * d;
    for (int c = lane; c < d; c += 32) Qt[c * FA_LD + r] = row < L ? src[c] : 0.f;
  }

  float acc[4][FA_OC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < FA_OC; ++jj) acc[i][jj] = 0.f;
  }

  for (int s0 = 0; s0 < src_len; s0 += FA_BN) {
    __syncthreads();  // the previous tile's second product is done
    for (int r = warp; r < FA_BN; r += FA_THREADS / 32) {
      const int row = s0 + r;
      const float* src = k + (size_t)row * stride + (size_t)head * d;
      for (int c = lane; c < d; c += 32)
        KV[c * FA_LD + r] = row < src_len ? src[c] : 0.f;
    }
    __syncthreads();

    // logits of this tile: rows ty*4 + i, columns tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + c * FA_LD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(KV + c * FA_LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax; the tile holds at least one valid column, so the new
    // max is finite
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = s0 + tx * 4 + j < src_len;
        s[i][j] = valid ? s[i][j] * sm_scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);  // 0 on the first tile
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);         // 0 where masked
        rowsum += s[i][j];
      }
      l_i[i] = l_i[i] * alpha + rowsum;          // this thread's 4 columns
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < FA_OC; ++jj) acc[i][jj] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * FA_LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // every thread is done with K; P is visible

    for (int r = warp; r < FA_BN; r += FA_THREADS / 32) {
      const int row = s0 + r;
      const float* src = v + (size_t)row * stride + (size_t)head * d;
      for (int c = lane; c < d; c += 32)
        KV[r * d + c] = row < src_len ? src[c] : 0.f;
    }
    __syncthreads();

    // o[rows ty*4 + i, columns tx + 16 jj] += p . v. A column slot at or
    // beyond d reads shared memory past the row (inside the block's
    // allocation) into an accumulator that is never stored.
#pragma unroll 2
    for (int n = 0; n < FA_BN; ++n) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + n * FA_LD + ty * 4);
      const float* vr = KV + n * d + tx;
#pragma unroll
      for (int jj = 0; jj < FA_OC; ++jj) {
        if (jj < slots) {
          const float vv = vr[16 * jj];
          acc[0][jj] = fmaf(p.x, vv, acc[0][jj]);
          acc[1][jj] = fmaf(p.y, vv, acc[1][jj]);
          acc[2][jj] = fmaf(p.z, vv, acc[2][jj]);
          acc[3][jj] = fmaf(p.w, vv, acc[3][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = l0 + ty * 4 + i;
    if (row < L) {
      if (lse != nullptr && tx == 0)
        lse[(size_t)row * H + head] = l > 0.f ? m_i[i] + logf(l) : -INFINITY;
      float* dst = out + (size_t)row * stride + (size_t)head * d;
#pragma unroll
      for (int jj = 0; jj < FA_OC; ++jj) {
        const int c = tx + 16 * jj;
        if (c < d) dst[c] = l > 0.f ? __fdiv_rn(acc[i][jj], l) : 0.f;
      }
    }
  }
}

extern "C" int dp_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* src_len,
                                      int L, int S, int H, int d,
                                      float sm_scale, void* out, void* lse,
                                      void* stream) {
  if (d < 1 || d > FA_DMAX || L < 0 || S < 0 || H < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (L > 0 && H > 0) {
    const size_t smem = (size_t)(2 * d * FA_LD + FA_BN * FA_LD) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + FA_BM - 1) / FA_BM, H);
    flash_attention_kernel<<<grid, FA_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const int*)src_len, L, S, H, d, sm_scale, (float*)out,
        (float*)lse);
  }
  return (int)cudaGetLastError();
}
