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
// over the source tiles. Each repeats bit for bit. Source rows at or beyond
// src_len are never loaded (zeros take their place, so NaN there cannot
// leak) and get zero dk, dv; every query row below L attends; src_len == 0
// gives zero dq without reading lse (-inf there). Any L, S >= 0 and any head
// width 1 <= d <= 144.
//
// What bounds them: 10 * L * src_len * H * d operations (the function's five
// products; the logits and dp are recomputed in both kernels, counted 6 : 4);
// all operands together are ~35 MB at L = S = 4096, H = 4, d = 132 and stay
// in L2, so bytes do not bind.
//
// C9: exact f32 on the FMA units. One block of 256
// threads, a 16 x 16 thread grid with 4 x 4 register tiles of the 64 x 64
// logits and of dp, computed in one sweep over d from transposed tiles in
// shared memory (16-byte loads); then dq summed over the tile's source rows,
// each thread keeping 4 rows x 9 column slots. It keeps its own Q and dO
// transposed and streams K and V transposed, then loads K again row-major
// into the same buffer. 161 KB of shared memory at d = 132: one block an SM.
//
// C8: its products on the tensor cores, as 3xTF32 (mma.sync m16n8k8):
// each operand x = hi + lo, both rounded to TF32, and a b = a_lo b_hi +
// a_hi b_lo + a_hi b_hi, ~1e-6 off f32 on unit-scale inputs (one TF32 pass
// keeps about three decimal digits, beyond the 2e-5 the tests hold).
// The tensor cores' own f32 accumulation truncates, and over a long product
// its bias reaches 2e-5; so every k-step's three passes start from zero and
// are added to the running sum on the FMA units, which round to nearest. A
// block owns 32 source rows and takes 114 KB of shared memory at d = 132,
// so two blocks of 8 warps share an SM and 264 run at once (356 have work
// at 4096 / 2836 rows; with 64 rows and one block an SM, 180 blocks left
// the second wave 36% full). The next query tile's Q, dO, lse and delta
// arrive by cp.async (a two-stage ring) while the current one's products
// run. The head width is padded with zeros to whole k-steps of 8 in shared
// memory (d = 132 -> 136). What bounds it is not the tensor cores' rate
// but the instructions around each product (the splits, the fragment
// loads, the sums on the FMA units: ~7 an mma) and their latency.
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

// ---- C8: 3xTF32 tensor-core products, its own code (C9 above stays SIMT) ----

#define DKV_BS 32        // source rows a block owns
#define DKV_BL 32        // query rows a streamed tile holds
#define DKV_WC 4         // column groups of warps
#define DKV_THREADS (64 * DKV_WC)  // warps: 2 (16 source rows) x DKV_WC
#define DKV_LDP 36       // row of the P^T / dS^T tiles, = 4 mod 32
#define DKV_NT1 (DKV_BL / 8 / DKV_WC)       // query n-tiles a warp, first
#define DKV_NT ((18 + DKV_WC - 1) / DKV_WC) // output n-tiles a warp (d <= 144)

__device__ __forceinline__ unsigned dkv_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi = x rounded to tf32 (ties away) and lo the rest,
// rounded again: hi*b_hi + hi*b_lo + lo*b_hi carries ~21 bits of x*b.
__device__ __forceinline__ void dkv_split(float x, unsigned& hi,
                                          unsigned& lo) {
  hi = dkv_tf32(x);
  lo = dkv_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void dkv_mma(float (&c)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b for one k-step, in three tensor-core passes (the small terms
// first) summed from zero, then added to c on the FMA units. The tensor
// cores' own f32 accumulation truncates; summing a long product there let
// the bias grow with the product's length (2e-5 off f32 at 333 rows), so
// each k-step's eight terms start from zero and the running sum rounds to
// nearest.
__device__ __forceinline__ void dkv_mma3(float (&c)[4], const unsigned (&ah)[4],
                                         const unsigned (&al)[4],
                                         const unsigned (&bh)[2],
                                         const unsigned (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  dkv_mma(t, al, bh);
  dkv_mma(t, ah, bl);
  dkv_mma(t, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], t[e]);
}

__device__ __forceinline__ void dkv_cp16(float* smem, const float* gmem,
                                         bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void dkv_cp4(float* smem, const float* gmem,
                                        bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void dkv_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

template <int N>
__device__ __forceinline__ void dkv_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Starts the copy dst[r][c] = x[row0 + r, head, c] for ``nrows`` rows and
// c < dpad; rows at or beyond ``limit`` and columns d .. dpad - 1 are
// zero-filled without reading global memory. ``vec``: 16-byte copies (d a
// multiple of 4 and every base 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void dkv_stage(float* __restrict__ dst,
                                          const float* __restrict__ x,
                                          int row0, int limit, int nrows,
                                          size_t stride, int head, int d,
                                          int dpad, int ld, bool vec) {
  const int step = vec ? 4 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += DKV_THREADS / 32) {
    const bool row_ok = row0 + r < limit;
    const float* xr = x + (size_t)(row0 + r) * stride + (size_t)head * d;
    for (int c = lane * step; c < dpad; c += 32 * step) {
      const bool ok = row_ok && c < d;
      if (vec)
        dkv_cp16(dst + r * ld + c, ok ? xr + c : x, ok);
      else
        dkv_cp4(dst + r * ld + c, ok ? xr + c : x, ok);
    }
  }
}

// The query tile at l0: Q and dO rows, and lse and delta of those rows.
__device__ __forceinline__ void dkv_stage_tile(
    float* Qb, float* Gb, float* Lb, float* Db, const float* q,
    const float* dout, const float* lse, const float* delta, int l0, int L,
    int H, int head, size_t stride, int d, int dpad, int ld, bool vec) {
  dkv_stage(Qb, q, l0, L, DKV_BL, stride, head, d, dpad, ld, vec);
  dkv_stage(Gb, dout, l0, L, DKV_BL, stride, head, d, dpad, ld, vec);
  const int t = threadIdx.x;
  if (t < 2 * DKV_BL) {
    const int r = t & (DKV_BL - 1);
    const bool ok = l0 + r < L;
    const float* src = t < DKV_BL ? lse : delta;
    dkv_cp4((t < DKV_BL ? Lb : Db) + r,
            ok ? src + (size_t)(l0 + r) * H + head : src, ok);
  }
}

// Each block owns DKV_BS source rows of one head and streams the query rows
// in tiles of DKV_BL through a two-stage cp.async ring. Warp w owns source
// rows 16 (w & 1) .. +15; in the first products (S^T = K Q^T, dP^T = V dO^T,
// summed over d) query columns 8 (w >> 1) .. +7, in the second (dV += P^T
// dO, dK += dS^T Q, summed over the tile's query rows) a quarter of the
// output column tiles (5, 5, 5, 2 of d = 132's 17). Fragments of m16n8k8:
// g = lane / 4 picks rows, t = lane % 4 the summed index. In the first
// products the summed index (a column of the row-major K, V, Q, dO tiles)
// is read in the order 2t, 2t + 1 for the fragment's t, t + 4, the same
// for both operands, so that each pair is one 8-byte load; with rows of
// ld = 8 (mod 16) floats no two lanes of a half-warp share a bank. In the
// second products the summed index is a query row of the P^T / dS^T tiles
// (rows of 36) and of Q, dO (rows of ld), read in the fragment's own order,
// again without bank conflicts.
__global__ void __launch_bounds__(DKV_THREADS, 2)
flash_attention_bwd_dkv_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ src_len_p, int L, int S,
                               int H, int d, float sm_scale, int vec,
                               float* __restrict__ dk, float* __restrict__ dv) {
  extern __shared__ __align__(16) float dkv_smem[];
  const int dpad = (d + 7) & ~7;                 // whole k-steps of 8
  const int ld = (dpad & 15) ? dpad : dpad + 8;  // = 8 (mod 16)
  const int nk = dpad >> 3;
  float* Ks = dkv_smem;                          // [DKV_BS][ld]
  float* Vs = Ks + DKV_BS * ld;                  // [DKV_BS][ld]
  float* Qs = Vs + DKV_BS * ld;                  // [2][DKV_BL][ld]
  float* Gs = Qs + 2 * DKV_BL * ld;              // [2][DKV_BL][ld]
  float* Pt = Gs + 2 * DKV_BL * ld;              // [DKV_BS][DKV_LDP]
  float* St = Pt + DKV_BS * DKV_LDP;             // [DKV_BS][DKV_LDP]
  float* Ls = St + DKV_BS * DKV_LDP;             // [2][DKV_BL]
  float* Ds = Ls + 2 * DKV_BL;                   // [2][DKV_BL]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 16;
  const int wc = warp >> 1;
  const int wn = wc * 8 * DKV_NT1;
  const int per = (nk + DKV_WC - 1) / DKV_WC;
  const int nbase = wc * per;
  const int ncnt = max(0, min(per, nk - nbase));
  const int head = blockIdx.y;
  const int s0 = blockIdx.x * DKV_BS;
  const size_t stride = (size_t)H * d;
  const bool v16 = vec != 0;

  int src_len = *src_len_p;
  src_len = src_len < 0 ? 0 : (src_len > S ? S : src_len);

  float dv_acc[DKV_NT][4], dk_acc[DKV_NT][4];
#pragma unroll
  for (int j = 0; j < DKV_NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dv_acc[j][e] = 0.f;
      dk_acc[j][e] = 0.f;
    }

  if (s0 < src_len && L > 0) {
    dkv_stage(Ks, k, s0, src_len, DKV_BS, stride, head, d, dpad, ld, v16);
    dkv_stage(Vs, v, s0, src_len, DKV_BS, stride, head, d, dpad, ld, v16);
    dkv_stage_tile(Qs, Gs, Ls, Ds, q, dout, lse, delta, 0, L, H, head, stride,
                   d, dpad, ld, v16);
    dkv_commit();
    const int ntiles = (L + DKV_BL - 1) / DKV_BL;
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1, l0 = it * DKV_BL;
      if (it + 1 < ntiles) {
        const int nb = buf ^ 1;
        dkv_stage_tile(Qs + nb * DKV_BL * ld, Gs + nb * DKV_BL * ld,
                       Ls + nb * DKV_BL, Ds + nb * DKV_BL, q, dout, lse,
                       delta, l0 + DKV_BL, L, H, head, stride, d, dpad, ld,
                       v16);
        dkv_commit();
        dkv_wait<1>();
      } else {
        dkv_wait<0>();
      }
      __syncthreads();
      const float* Qb = Qs + buf * DKV_BL * ld;
      const float* Gb = Gs + buf * DKV_BL * ld;
      const float* Lb = Ls + buf * DKV_BL;
      const float* Db = Ds + buf * DKV_BL;

      // S^T and dP^T for the warp's 16 source rows x 16 query columns
      float sacc[DKV_NT1][4], pacc[DKV_NT1][4];
#pragma unroll
      for (int nt = 0; nt < DKV_NT1; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sacc[nt][e] = 0.f;
          pacc[nt][e] = 0.f;
        }
#pragma unroll 2
      for (int kk = 0; kk < nk; ++kk) {
        const int c0 = kk * 8 + 2 * t;
        unsigned kh[4], kl[4], vh[4], vl[4];
        {
          const float2 a = *reinterpret_cast<const float2*>(
              Ks + (wm + g) * ld + c0);
          const float2 b = *reinterpret_cast<const float2*>(
              Ks + (wm + g + 8) * ld + c0);
          dkv_split(a.x, kh[0], kl[0]);
          dkv_split(b.x, kh[1], kl[1]);
          dkv_split(a.y, kh[2], kl[2]);
          dkv_split(b.y, kh[3], kl[3]);
          const float2 e = *reinterpret_cast<const float2*>(
              Vs + (wm + g) * ld + c0);
          const float2 f = *reinterpret_cast<const float2*>(
              Vs + (wm + g + 8) * ld + c0);
          dkv_split(e.x, vh[0], vl[0]);
          dkv_split(f.x, vh[1], vl[1]);
          dkv_split(e.y, vh[2], vl[2]);
          dkv_split(f.y, vh[3], vl[3]);
        }
#pragma unroll
        for (int nt = 0; nt < DKV_NT1; ++nt) {
          const int row = (wn + nt * 8 + g) * ld + c0;
          const float2 a = *reinterpret_cast<const float2*>(Qb + row);
          const float2 b = *reinterpret_cast<const float2*>(Gb + row);
          unsigned qh[2], ql[2], gh[2], gl[2];
          dkv_split(a.x, qh[0], ql[0]);
          dkv_split(a.y, qh[1], ql[1]);
          dkv_split(b.x, gh[0], gl[0]);
          dkv_split(b.y, gh[1], gl[1]);
          dkv_mma3(sacc[nt], kh, kl, qh, ql);
          dkv_mma3(pacc[nt], vh, vl, gh, gl);
        }
      }

      // p = exp(s * scale - lse), ds = p (dp - delta); zero outside the
      // valid source prefix and beyond L. Written as P^T, dS^T.
#pragma unroll
      for (int nt = 0; nt < DKV_NT1; ++nt) {
        const int col = wn + nt * 8 + 2 * t;
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm + g + (e >> 1) * 8, c = col + (e & 1);
          const bool valid = s0 + r < src_len && l0 + c < L;
          const float pr =
              valid ? expf(sacc[nt][e] * sm_scale - Lb[c]) : 0.f;
          p[e] = pr;
          ds[e] = valid ? pr * (pacc[nt][e] - Db[c]) : 0.f;
        }
        *reinterpret_cast<float2*>(Pt + (wm + g) * DKV_LDP + col) =
            make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(Pt + (wm + g + 8) * DKV_LDP + col) =
            make_float2(p[2], p[3]);
        *reinterpret_cast<float2*>(St + (wm + g) * DKV_LDP + col) =
            make_float2(ds[0], ds[1]);
        *reinterpret_cast<float2*>(St + (wm + g + 8) * DKV_LDP + col) =
            make_float2(ds[2], ds[3]);
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's query rows
#pragma unroll
      for (int kk = 0; kk < DKV_BL / 8; ++kk) {
        const int r0 = (wm + g) * DKV_LDP + kk * 8 + t;
        const int r1 = r0 + 8 * DKV_LDP;
        unsigned ph[4], pl[4], sh[4], sl[4];
        dkv_split(Pt[r0], ph[0], pl[0]);
        dkv_split(Pt[r1], ph[1], pl[1]);
        dkv_split(Pt[r0 + 4], ph[2], pl[2]);
        dkv_split(Pt[r1 + 4], ph[3], pl[3]);
        dkv_split(St[r0], sh[0], sl[0]);
        dkv_split(St[r1], sh[1], sl[1]);
        dkv_split(St[r0 + 4], sh[2], sl[2]);
        dkv_split(St[r1 + 4], sh[3], sl[3]);
        const float* g0 = Gb + (kk * 8 + t) * ld + g;
        const float* q0 = Qb + (kk * 8 + t) * ld + g;
#pragma unroll
        for (int j = 0; j < DKV_NT; ++j) {
          if (j < ncnt) {
            const int c = (nbase + j) * 8;
            unsigned gh[2], gl[2], qh[2], ql[2];
            dkv_split(g0[c], gh[0], gl[0]);
            dkv_split(g0[c + 4 * ld], gh[1], gl[1]);
            dkv_split(q0[c], qh[0], ql[0]);
            dkv_split(q0[c + 4 * ld], qh[1], ql[1]);
            dkv_mma3(dv_acc[j], ph, pl, gh, gl);
            dkv_mma3(dk_acc[j], sh, sl, qh, ql);
          }
        }
      }
      __syncthreads();  // the tile's buffers and P^T, dS^T are free again
    }
  }

  // rows at or beyond src_len kept zero accumulators
#pragma unroll
  for (int j = 0; j < DKV_NT; ++j) {
    if (j < ncnt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = s0 + wm + g + (e >> 1) * 8;
        const int c = (nbase + j) * 8 + 2 * t + (e & 1);
        if (row < S && c < d) {
          const size_t off = (size_t)row * stride + (size_t)head * d + c;
          dk[off] = row < src_len ? dk_acc[j][e] * sm_scale : 0.f;
          dv[off] = row < src_len ? dv_acc[j][e] : 0.f;
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
    const int dpad = (d + 7) & ~7;
    const int ld = (dpad & 15) ? dpad : dpad + 8;
    const size_t smem = (size_t)(2 * DKV_BS * ld + 4 * DKV_BL * ld +
                                 2 * DKV_BS * DKV_LDP + 4 * DKV_BL) *
                        sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bwd_dkv_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    // 16-byte copies need whole float4 rows and aligned bases
    const size_t bases = (size_t)q | (size_t)k | (size_t)v | (size_t)dout;
    const int vec = d % 4 == 0 && bases % 16 == 0;
    const dim3 grid((S + DKV_BS - 1) / DKV_BS, H);
    flash_attention_bwd_dkv_kernel<<<grid, DKV_THREADS, smem,
                                     (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (const int*)src_len, L, S, H,
        d, sm_scale, vec, (float*)dk, (float*)dv);
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
