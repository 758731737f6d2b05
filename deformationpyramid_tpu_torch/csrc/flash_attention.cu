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
// What bounds it: 4 * L * src_len * H * d operations (two products); q, k,
// v and o together are ~17 MB at L = S = 2048, H = 4, d = 132 and stay in
// L2, so bytes do not bind. Both products run on the tensor cores as
// 3xTF32 (tf32_mma.cuh: mma.sync m16n8k8, a = a_hi + a_lo in TF32, three
// passes a k-step summed from zero and added on the FMA units), ~1e-6 off
// f32 in the logits and outputs on unit-scale inputs: one TF32 pass would
// put ~1e-3 into logits that the dual softmax divides by a temperature of
// 0.1, three keep them within the 2e-5 that o and lse are held to. The
// softmax runs in log2 units on exp2f. What bounds it on this card is not
// the tensor cores' rate (mma.sync reaches ~312 of the 495 TF32 TFLOP/s)
// but the instructions around each product and their latency: the splits,
// the fragment loads from shared memory, the sums on the FMA units, the
// copies of the streamed tiles.
//
// Design: one block of 512 threads per (tile of 64 query rows, head, chunk
// of the source prefix). The Q tile sits in shared memory split once into
// its TF32 hi and lo parts; K and V stream row-major in tiles of 64 rows
// through a two-stage cp.async ring. Warp w owns query rows 16 (w & 3) ..
// +15 and source rows 16 (w >> 2) .. +15 of every tile, two n-tiles of 8:
// it computes its 16 x 16 slice of the logits, keeps a running max and sum
// of its rows over its own source rows (the max reduced across the four
// lanes of a quad that hold a row), rescales its output accumulator of all
// d columns when the max moves, and adds P V with P's accumulator
// fragments as the A operands (tc_split_acc: no round trip through shared
// memory). At the end the four warps of a row tile merge their (max, sum,
// output) in warp order. 206 KB of shared memory at d = 132: one block an
// SM, 16 warps (the 32 x 32-row design with two blocks of 8 warps an SM ran
// 0.955 ms at 4096 / 2836, this one 0.78). src_len is read on the device;
// rows at or beyond it are never loaded, and src_len == 0 gives zeros.
//
// Where (L / 64) x H blocks leave SMs idle (L <= 1024 at 4 heads), the
// caller asks for ``splits`` > 1: the source rows are cut into that many
// chunks of whole tiles (chosen on the host from S), each block writes its
// chunk's unnormalised output, max and sum to ``part`` [chunks, L, H, d +
// 2], and a second launch merges the chunks in chunk order, so a repeat is
// bit-equal. Chunks at or beyond src_len exit at once and are never read.
//
// Where the caller needs a gradient it passes ``lse`` [L, H]: the kernel
// then also writes each row's log-sum-exp m + log(l) of the scaled logits
// (-inf for an empty prefix), which the backward kernels C8 and C9
// (flash_attention_bwd.cu) recompute the probabilities from. A null ``lse``
// (inference) writes nothing more, and o is the same either way.
#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

#define FA_BL 64        // query rows a block owns
#define FA_BS 64        // source rows a streamed tile holds
#define FA_THREADS 512  // warps: 4 (16 query rows) x 4 (16 source rows)
#define FA_WARPS (FA_THREADS / 32)
#define FA_DMAX 144
#define FA_NT (FA_DMAX / 8)  // output n-tiles
#define FA_MAX_SPLITS 8

// Shared memory for rows of ld floats: Q split into TF32 hi and lo, the
// two-stage ring of K and V tiles, and the merge's maxima and sums.
static size_t fa_smem_bytes(int ld) {
  return ((size_t)(2 * FA_BL + 4 * FA_BS) * ld + FA_WARPS * 16 * 2 +
          FA_BL * 2) * sizeof(float);
}

// The K and V tile of source rows row0 .. row0 + FA_BS - 1 (those at or
// beyond ``limit`` zero).
__device__ __forceinline__ void fa_stage_kv(float* Kd, float* Vd,
                                            const float* k, const float* v,
                                            int row0, int limit,
                                            size_t stride, int head, int d,
                                            int dpad, int ld, bool vec) {
  if (vec) {
    const size_t off = (size_t)row0 * stride + (size_t)head * d;
    tc_stage16<FA_THREADS, FA_BS>(Kd, k + off, limit - row0, stride, d, dpad,
                                  ld);
    tc_stage16<FA_THREADS, FA_BS>(Vd, v + off, limit - row0, stride, d, dpad,
                                  ld);
  } else {
    tc_stage<FA_THREADS>(Kd, k, row0, limit, FA_BS, stride, head, d, dpad, ld,
                         false);
    tc_stage<FA_THREADS>(Vd, v, row0, limit, FA_BS, stride, head, d, dpad, ld,
                         false);
  }
}

__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ src_len_p, int L, int S, int H,
                       int d, int ld, float sm_scale, int chunk, int vec,
                       float* __restrict__ out, float* __restrict__ lse,
                       float* __restrict__ part) {
  extern __shared__ __align__(16) float fa_smem[];
  const int dpad = tc_dpad(d);
  const int nk = dpad >> 3;
  float* Qh = fa_smem;                 // [FA_BL][ld]: Q, then its TF32 hi
  float* Ql = Qh + FA_BL * ld;         // [FA_BL][ld]: its lo
  float* Ks = Ql + FA_BL * ld;         // [2][FA_BS][ld]
  float* Vs = Ks + 2 * FA_BS * ld;     // [2][FA_BS][ld]
  float* ML = Vs + 2 * FA_BS * ld;     // [warps][16 rows][m, l]
  float* RS = ML + FA_WARPS * 16 * 2;  // [FA_BL][m, l] of the block

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 16;      // the warp's query rows
  const int wn = (warp >> 2) * 16;     // its source rows of every tile
  const int head = blockIdx.y;
  const int l0 = blockIdx.x * FA_BL;
  const size_t stride = (size_t)H * d;
  const bool v16 = vec != 0;
  const bool split = gridDim.z > 1;
  const float scale2 = sm_scale * TC_LOG2E;

  int src_len = *src_len_p;
  src_len = src_len < 0 ? 0 : (src_len > S ? S : src_len);
  const int lo = blockIdx.z * chunk;
  const int hi = min(src_len, lo + chunk);
  if (split && lo >= src_len) return;  // the merge reads only live chunks

  float acc[FA_NT][4];
#pragma unroll
  for (int n = 0; n < FA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  if (lo < hi) {
    tc_stage<FA_THREADS>(Qh, q, l0, L, FA_BL, stride, head, d, dpad, ld, v16);
    tc_commit();
    fa_stage_kv(Ks, Vs, k, v, lo, hi, stride, head, d, dpad, ld, v16);
    tc_commit();
    tc_wait<1>();
    __syncthreads();
    // Q is read by every tile: split it once (each element by the thread
    // that reads it here; the loop's first barrier orders the writes)
    for (int i = threadIdx.x; i < FA_BL * dpad; i += FA_THREADS) {
      const int r = i / dpad, c = i - r * dpad;
      unsigned h, l;
      tc_split_rz(Qh[r * ld + c], h, l);
      Qh[r * ld + c] = __uint_as_float(h);
      Ql[r * ld + c] = __uint_as_float(l);
    }
    const int ra = wn + tc_perm(g);          // the logits' B rows, + 8 u
    const int rb0 = wn + tc_perm(2 * t);     // P V's B rows, + 8 u
    const int rb1 = wn + tc_perm(2 * t + 1);
    const int ntiles = (hi - lo + FA_BS - 1) / FA_BS;
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1, s0 = lo + it * FA_BS;
      if (it + 1 < ntiles) {
        const int nb = buf ^ 1;
        fa_stage_kv(Ks + nb * FA_BS * ld, Vs + nb * FA_BS * ld, k, v,
                    s0 + FA_BS, hi, stride, head, d, dpad, ld, v16);
        tc_commit();
        tc_wait<1>();
      } else {
        tc_wait<0>();
      }
      __syncthreads();
      const float* Kb = Ks + buf * FA_BS * ld;
      const float* Vb = Vs + buf * FA_BS * ld;

      // logits of the warp's 16 query rows x 2 x 8 source rows, summed over
      // d; the summed index read as 2t, 2t + 1 for the fragment's t, t + 4
      // in both operands (8-byte loads)
      float sacc[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[u][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < nk; ++kk) {
        const int c0 = kk * 8 + 2 * t;
        const int r0 = (wm + g) * ld + c0, r1 = r0 + 8 * ld;
        const uint2 a = *reinterpret_cast<const uint2*>(Qh + r0);
        const uint2 b = *reinterpret_cast<const uint2*>(Qh + r1);
        const uint2 e = *reinterpret_cast<const uint2*>(Ql + r0);
        const uint2 f = *reinterpret_cast<const uint2*>(Ql + r1);
        const unsigned ah[4] = {a.x, b.x, a.y, b.y};
        const unsigned al[4] = {e.x, f.x, e.y, f.y};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 kv = *reinterpret_cast<const float2*>(
              Kb + (ra + 8 * u) * ld + c0);
          unsigned kh[2], kl[2];
          tc_split_rz(kv.x, kh[0], kl[0]);
          tc_split_rz(kv.y, kh[1], kl[1]);
          tc_mma3(sacc[u], ah, al, kh, kl);
        }
      }

      // online softmax over the warp's source rows, in log2 units;
      // column c of n-tile u is source row s0 + wn + 8 u + tc_perm(c), -inf
      // beyond the chunk's valid rows. A row's max is the same in the
      // quad's four lanes.
      float p[2][4], alpha[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[u][e] = s0 + wn + 8 * u + tc_perm(2 * t + (e & 1)) < hi
                        ? sacc[u][e] * scale2
                        : -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = fmaxf(fmaxf(p[0][2 * h], p[0][2 * h + 1]),
                         fmaxf(p[1][2 * h], p[1][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[h], mx);
        float rs = 0.f;
        if (m_new == -INFINITY) {      // no valid row of the warp's yet
          alpha[h] = 1.f;
#pragma unroll
          for (int u = 0; u < 2; ++u) p[u][2 * h] = p[u][2 * h + 1] = 0.f;
        } else {
          alpha[h] = exp2f(m_r[h] - m_new);  // 0 on the first valid tile
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            p[u][2 * h] = exp2f(p[u][2 * h] - m_new);
            p[u][2 * h + 1] = exp2f(p[u][2 * h + 1] - m_new);
            rs += p[u][2 * h] + p[u][2 * h + 1];
          }
        }
        l_r[h] = l_r[h] * alpha[h] + rs;
        m_r[h] = m_new;
      }
      // a scale of 1 changes no bit: skipped unless a lane's max moved
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < FA_NT; ++n) {
          if (n < nk) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
          }
        }
      }

      // o += P V over the warp's 16 source rows, P from registers
      unsigned ph[2][4], pl[2][4];
      tc_split_acc(p[0], ph[0], pl[0]);
      tc_split_acc(p[1], ph[1], pl[1]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* v0 = Vb + (rb0 + 8 * u) * ld + g;
        const float* v1 = Vb + (rb1 + 8 * u) * ld + g;
#pragma unroll
        for (int n = 0; n < FA_NT; ++n) {
          if (n < nk) {
            unsigned bh[2], bl[2];
            tc_split_rz(v0[8 * n], bh[0], bl[0]);
            tc_split_rz(v1[8 * n], bh[1], bl[1]);
            tc_mma3(acc[n], ph[u], pl[u], bh, bl);
          }
        }
      }
      __syncthreads();  // the tile's buffers are free again
    }
  }

  // Merge the four source slices of each query row in slice order: the
  // block's max M, its sum L = sum_j l_j exp(m_j - M), its output
  // sum_j acc_j exp(m_j - M). Warp w = i + 4 j holds slice j of row tile i.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    if (t == 0) {
      ML[(warp * 16 + g + 8 * h) * 2] = m_r[h];
      ML[(warp * 16 + g + 8 * h) * 2 + 1] = l_r[h];
    }
  }
  __syncthreads();
  const int wj = FA_BL * 2;            // ML: from slice j to j + 1
  if (threadIdx.x < FA_BL) {
    const float* ml = ML + threadIdx.x * 2;   // row r of tile r >> 4, j = 0
    const float M = fmaxf(fmaxf(ml[0], ml[wj]), fmaxf(ml[2 * wj], ml[3 * wj]));
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mj = ml[j * wj];
      lsum += mj == -INFINITY ? 0.f : ml[j * wj + 1] * exp2f(mj - M);
    }
    RS[threadIdx.x * 2] = M;
    RS[threadIdx.x * 2 + 1] = lsum;
  }
  float sc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* ml = ML + (wm + g + 8 * h) * 2;
    const float M = fmaxf(fmaxf(ml[0], ml[wj]), fmaxf(ml[2 * wj], ml[3 * wj]));
    sc[h] = m_r[h] == -INFINITY ? 0.f : exp2f(m_r[h] - M);
  }
  float* red = Ks;                     // [warps][16][ld], the ring's space
#pragma unroll
  for (int n = 0; n < FA_NT; ++n) {
    if (n < nk) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(red + (warp * 16 + g) * ld + c) =
          make_float2(acc[n][0] * sc[0], acc[n][1] * sc[0]);
      *reinterpret_cast<float2*>(red + (warp * 16 + g + 8) * ld + c) =
          make_float2(acc[n][2] * sc[1], acc[n][3] * sc[1]);
    }
  }
  __syncthreads();
  const int rj = FA_BL * ld;           // red: from slice j to j + 1
  for (int i = threadIdx.x; i < FA_BL * d; i += FA_THREADS) {
    const int r = i / d, c = i - r * d;
    const int row = l0 + r;
    if (row >= L) continue;
    const float* p = red + r * ld + c;
    const float o = ((p[0] + p[rj]) + p[2 * rj]) + p[3 * rj];
    const float M = RS[r * 2], lsum = RS[r * 2 + 1];
    if (!split) {
      out[(size_t)row * stride + (size_t)head * d + c] =
          lsum > 0.f ? __fdiv_rn(o, lsum) : 0.f;
      if (lse != nullptr && c == 0)
        lse[(size_t)row * H + head] =
            lsum > 0.f ? fmaf(M, TC_LN2, logf(lsum)) : -INFINITY;
    } else {
      float* dst =
          part + ((size_t)(blockIdx.z * L + row) * H + head) * (d + 2);
      dst[c] = o;
      if (c == 0) {
        dst[d] = M;
        dst[d + 1] = lsum;
      }
    }
  }
}

// One warp a (query row, head): the live chunks' partial outputs weighted
// by exp(m_z - M), summed in chunk order, over the summed weights. A live
// chunk holds at least one valid source row, so its max is finite.
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_merge_kernel(const float* __restrict__ part,
                             const int* __restrict__ src_len_p, int L, int S,
                             int H, int d, int chunk, int chunks,
                             float* __restrict__ out,
                             float* __restrict__ lse) {
  const int w = blockIdx.x * (TC_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= L * H) return;
  const int row = w / H, head = w - row * H;
  int src_len = *src_len_p;
  src_len = src_len < 0 ? 0 : (src_len > S ? S : src_len);
  const int live = min(chunks, (src_len + chunk - 1) / chunk);
  const size_t zs = (size_t)L * H * (d + 2);   // from chunk z to z + 1
  const float* p = part + (size_t)w * (d + 2);
  float M = -INFINITY;
  for (int z = 0; z < live; ++z) M = fmaxf(M, p[z * zs + d]);
  float wt[FA_MAX_SPLITS];
  float lsum = 0.f;
#pragma unroll
  for (int z = 0; z < FA_MAX_SPLITS; ++z) {
    wt[z] = z < live ? exp2f(p[z * zs + d] - M) : 0.f;
    if (z < live) lsum += p[z * zs + d + 1] * wt[z];
  }
  float* dst = out + (size_t)row * H * d + (size_t)head * d;
  for (int c = lane; c < d; c += 32) {
    float o = 0.f;
#pragma unroll
    for (int z = 0; z < FA_MAX_SPLITS; ++z)
      if (z < live) o += p[z * zs + c] * wt[z];
    dst[c] = lsum > 0.f ? __fdiv_rn(o, lsum) : 0.f;
  }
  if (lse != nullptr && lane == 0)
    lse[w] = lsum > 0.f ? fmaf(M, TC_LN2, logf(lsum)) : -INFINITY;
}

extern "C" int dp_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* src_len,
                                      int L, int S, int H, int d,
                                      float sm_scale, int splits, void* part,
                                      void* out, void* lse, void* stream) {
  if (d < 1 || d > FA_DMAX || L < 0 || S < 0 || H < 0 || splits < 1 ||
      splits > FA_MAX_SPLITS || (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (L > 0 && H > 0) {
    // rows of 8 (mod 16) floats where they fit (d <= 136), else unpadded
    int ld = tc_ld(d);
    if (fa_smem_bytes(ld) > 232448) ld = tc_dpad(d);
    const size_t smem = fa_smem_bytes(ld);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_attention_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    // chunks of whole tiles; ``splits`` chunks at most
    int chunk = S, chunks = 1;
    if (splits > 1 && S > 0) {
      chunk = ((S + splits - 1) / splits + FA_BS - 1) / FA_BS * FA_BS;
      chunks = (S + chunk - 1) / chunk;
      if (chunks == 1) chunk = S;
    }
    const size_t bases = (size_t)q | (size_t)k | (size_t)v;
    const int vec = d % 4 == 0 && bases % 16 == 0;
    const dim3 grid((L + FA_BL - 1) / FA_BL, H, chunks);
    flash_attention_kernel<<<grid, FA_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const int*)src_len, L, S, H, d, ld, sm_scale, chunk, vec, (float*)out,
        (float*)lse, (float*)part);
    if (chunks > 1) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int warps = TC_THREADS / 32;
      flash_attention_merge_kernel<<<(L * H + warps - 1) / warps, TC_THREADS,
                                     0, (cudaStream_t)stream>>>(
          (const float*)part, (const int*)src_len, L, S, H, d, chunk, chunks,
          (float*)out, (float*)lse);
    }
  }
  return (int)cudaGetLastError();
}
