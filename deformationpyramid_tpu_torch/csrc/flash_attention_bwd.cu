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
// in L2, so bytes do not bind. Both compute their products on the tensor
// cores as 3xTF32 (tf32_mma.cuh: mma.sync m16n8k8, each k-step's three
// passes summed from zero and added on the FMA units; ~1e-6 off f32 on
// unit-scale inputs). The head width is padded with zeros to whole k-steps
// of 8 in shared memory (d = 132 -> 136), rows of ld = 8 (mod 16) floats.
// What bounds them on this card is not the tensor cores' rate but the
// instructions around each product (the splits, the fragment loads, the
// sums on the FMA units) and their latency.
//
// C8: a block owns 32 source rows and takes 114 KB of shared memory at d =
// 132, so two blocks of 8 warps share an SM and 264 run at once (356 have
// work at 4096 / 2836 rows; with 64 rows and one block an SM, 180 blocks
// left the second wave 36% full). The next query tile's Q, dO, lse and
// delta arrive by cp.async (a two-stage ring) while the current one's
// products run.
//
// C9: a block owns 64 query rows of one head, whose Q and dO stay in
// shared memory, and streams K and V in tiles of 64 source rows through a
// two-stage cp.async ring; each tile is loaded once, and its row-major K
// serves both S = Q K^T and dq += dS K. Warp w owns query rows 16 (w & 3)
// .. +15 and source rows 16 (w >> 2) .. +15 of every tile (two n-tiles):
// it computes its 16 x 16 slices of S and dP over d, then ds, and adds dS
// K over its own 16 source rows to a partial dq of all d columns, with
// ds's accumulator fragments as the A operands (tc_split_acc). The four
// warps of a query row tile sum their partials once, in order, at the
// end. 204 KB of shared memory at d = 132: one block of 16 warps an SM,
// 256 blocks at 4096 rows and 128 at 2048 (the 64-row SIMT design before
// it took 161 KB with 8 warps). Q and dO are split on every use, K and V
// too, with tc_split_rz.
#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

#define FB_DMAX 144     // 18 n-tiles of 8 output columns

// ---- C8 ----

#define DKV_BS 32        // source rows a block owns
#define DKV_BL 32        // query rows a streamed tile holds
#define DKV_WC 4         // column groups of warps
#define DKV_THREADS (64 * DKV_WC)  // warps: 2 (16 source rows) x DKV_WC
#define DKV_LDP 36       // row of the P^T / dS^T tiles, = 4 mod 32
#define DKV_NT1 (DKV_BL / 8 / DKV_WC)       // query n-tiles a warp, first
#define DKV_NT ((18 + DKV_WC - 1) / DKV_WC) // output n-tiles a warp (d <= 144)

static_assert(DKV_THREADS == TC_THREADS, "tc_stage strides by TC_THREADS");

// The query tile at l0: Q and dO rows, and lse and delta of those rows.
__device__ __forceinline__ void dkv_stage_tile(
    float* Qb, float* Gb, float* Lb, float* Db, const float* q,
    const float* dout, const float* lse, const float* delta, int l0, int L,
    int H, int head, size_t stride, int d, int dpad, int ld, bool vec) {
  tc_stage(Qb, q, l0, L, DKV_BL, stride, head, d, dpad, ld, vec);
  tc_stage(Gb, dout, l0, L, DKV_BL, stride, head, d, dpad, ld, vec);
  const int t = threadIdx.x;
  if (t < 2 * DKV_BL) {
    const int r = t & (DKV_BL - 1);
    const bool ok = l0 + r < L;
    const float* src = t < DKV_BL ? lse : delta;
    tc_cp4((t < DKV_BL ? Lb : Db) + r,
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
    tc_stage(Ks, k, s0, src_len, DKV_BS, stride, head, d, dpad, ld, v16);
    tc_stage(Vs, v, s0, src_len, DKV_BS, stride, head, d, dpad, ld, v16);
    dkv_stage_tile(Qs, Gs, Ls, Ds, q, dout, lse, delta, 0, L, H, head, stride,
                   d, dpad, ld, v16);
    tc_commit();
    const int ntiles = (L + DKV_BL - 1) / DKV_BL;
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1, l0 = it * DKV_BL;
      if (it + 1 < ntiles) {
        const int nb = buf ^ 1;
        dkv_stage_tile(Qs + nb * DKV_BL * ld, Gs + nb * DKV_BL * ld,
                       Ls + nb * DKV_BL, Ds + nb * DKV_BL, q, dout, lse,
                       delta, l0 + DKV_BL, L, H, head, stride, d, dpad, ld,
                       v16);
        tc_commit();
        tc_wait<1>();
      } else {
        tc_wait<0>();
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
          tc_split(a.x, kh[0], kl[0]);
          tc_split(b.x, kh[1], kl[1]);
          tc_split(a.y, kh[2], kl[2]);
          tc_split(b.y, kh[3], kl[3]);
          const float2 e = *reinterpret_cast<const float2*>(
              Vs + (wm + g) * ld + c0);
          const float2 f = *reinterpret_cast<const float2*>(
              Vs + (wm + g + 8) * ld + c0);
          tc_split(e.x, vh[0], vl[0]);
          tc_split(f.x, vh[1], vl[1]);
          tc_split(e.y, vh[2], vl[2]);
          tc_split(f.y, vh[3], vl[3]);
        }
#pragma unroll
        for (int nt = 0; nt < DKV_NT1; ++nt) {
          const int row = (wn + nt * 8 + g) * ld + c0;
          const float2 a = *reinterpret_cast<const float2*>(Qb + row);
          const float2 b = *reinterpret_cast<const float2*>(Gb + row);
          unsigned qh[2], ql[2], gh[2], gl[2];
          tc_split(a.x, qh[0], ql[0]);
          tc_split(a.y, qh[1], ql[1]);
          tc_split(b.x, gh[0], gl[0]);
          tc_split(b.y, gh[1], gl[1]);
          tc_mma3(sacc[nt], kh, kl, qh, ql);
          tc_mma3(pacc[nt], vh, vl, gh, gl);
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
        tc_split(Pt[r0], ph[0], pl[0]);
        tc_split(Pt[r1], ph[1], pl[1]);
        tc_split(Pt[r0 + 4], ph[2], pl[2]);
        tc_split(Pt[r1 + 4], ph[3], pl[3]);
        tc_split(St[r0], sh[0], sl[0]);
        tc_split(St[r1], sh[1], sl[1]);
        tc_split(St[r0 + 4], sh[2], sl[2]);
        tc_split(St[r1 + 4], sh[3], sl[3]);
        const float* g0 = Gb + (kk * 8 + t) * ld + g;
        const float* q0 = Qb + (kk * 8 + t) * ld + g;
#pragma unroll
        for (int j = 0; j < DKV_NT; ++j) {
          if (j < ncnt) {
            const int c = (nbase + j) * 8;
            unsigned gh[2], gl[2], qh[2], ql[2];
            tc_split(g0[c], gh[0], gl[0]);
            tc_split(g0[c + 4 * ld], gh[1], gl[1]);
            tc_split(q0[c], qh[0], ql[0]);
            tc_split(q0[c + 4 * ld], qh[1], ql[1]);
            tc_mma3(dv_acc[j], ph, pl, gh, gl);
            tc_mma3(dk_acc[j], sh, sl, qh, ql);
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

// ---- C9 ----

#define DQ_BL 64        // query rows a block owns
#define DQ_BS 64        // source rows a streamed tile holds
#define DQ_THREADS 512  // warps: 4 (16 query rows) x 4 (16 source rows)
#define DQ_NT (FB_DMAX / 8)  // output n-tiles (d <= 144)

// Shared memory of C9 for rows of ld floats: Q and dO, and the two-stage
// ring of K and V tiles.
static size_t dq_smem_bytes(int ld) {
  return (size_t)(2 * DQ_BL + 4 * DQ_BS) * ld * sizeof(float);
}

// The K and V tile of source rows row0 .. row0 + DQ_BS - 1 (those at or
// beyond ``limit`` zero).
__device__ __forceinline__ void dq_stage_kv(float* Kd, float* Vd,
                                            const float* k, const float* v,
                                            int row0, int limit,
                                            size_t stride, int head, int d,
                                            int dpad, int ld, bool vec) {
  if (vec) {
    const size_t off = (size_t)row0 * stride + (size_t)head * d;
    tc_stage16<DQ_THREADS, DQ_BS>(Kd, k + off, limit - row0, stride, d, dpad,
                                  ld);
    tc_stage16<DQ_THREADS, DQ_BS>(Vd, v + off, limit - row0, stride, d, dpad,
                                  ld);
  } else {
    tc_stage<DQ_THREADS>(Kd, k, row0, limit, DQ_BS, stride, head, d, dpad, ld,
                         false);
    tc_stage<DQ_THREADS>(Vd, v, row0, limit, DQ_BS, stride, head, d, dpad, ld,
                         false);
  }
}

__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_attention_bwd_dq_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ src_len_p, int L, int S,
                              int H, int d, int ld, float sm_scale, int vec,
                              float* __restrict__ dq) {
  extern __shared__ __align__(16) float dq_smem[];
  const int dpad = tc_dpad(d);
  const int nk = dpad >> 3;
  float* Qs = dq_smem;                 // [DQ_BL][ld]
  float* Gs = Qs + DQ_BL * ld;         // dO [DQ_BL][ld]
  float* Ks = Gs + DQ_BL * ld;         // [2][DQ_BS][ld]
  float* Vs = Ks + 2 * DQ_BS * ld;     // [2][DQ_BS][ld]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 16;      // the warp's query rows
  const int wn = (warp >> 2) * 16;     // its source rows of every tile
  const int head = blockIdx.y;
  const int l0 = blockIdx.x * DQ_BL;
  const size_t stride = (size_t)H * d;
  const bool v16 = vec != 0;

  int src_len = *src_len_p;
  src_len = src_len < 0 ? 0 : (src_len > S ? S : src_len);

  float acc[DQ_NT][4];
#pragma unroll
  for (int n = 0; n < DQ_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (src_len > 0) {
    tc_stage<DQ_THREADS>(Qs, q, l0, L, DQ_BL, stride, head, d, dpad, ld, v16);
    tc_stage<DQ_THREADS>(Gs, dout, l0, L, DQ_BL, stride, head, d, dpad, ld,
                         v16);
    dq_stage_kv(Ks, Vs, k, v, 0, src_len, stride, head, d, dpad, ld, v16);
    tc_commit();
    // lse (in log2 units) and delta of the thread's query rows g, g + 8
    bool row_ok[2];
    float lse2[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = l0 + wm + g + 8 * h;
      row_ok[h] = row < L;
      lse2[h] = row_ok[h] ? lse[(size_t)row * H + head] * TC_LOG2E : 0.f;
      delta_r[h] = row_ok[h] ? delta[(size_t)row * H + head] : 0.f;
    }
    const float scale2 = sm_scale * TC_LOG2E;
    const int ra = wn + tc_perm(g);          // S's and dP's B rows, + 8 u
    const int rb0 = wn + tc_perm(2 * t);     // dq's B rows, + 8 u
    const int rb1 = wn + tc_perm(2 * t + 1);
    const int ntiles = (src_len + DQ_BS - 1) / DQ_BS;
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1, s0 = it * DQ_BS;
      if (it + 1 < ntiles) {
        const int nb = buf ^ 1;
        dq_stage_kv(Ks + nb * DQ_BS * ld, Vs + nb * DQ_BS * ld, k, v,
                    s0 + DQ_BS, src_len, stride, head, d, dpad, ld, v16);
        tc_commit();
        tc_wait<1>();
      } else {
        tc_wait<0>();
      }
      __syncthreads();
      const float* Kb = Ks + buf * DQ_BS * ld;
      const float* Vb = Vs + buf * DQ_BS * ld;

      // S and dP for the warp's 16 query rows x 2 x 8 source rows, summed
      // over d; the summed index read as 2t, 2t + 1 for the fragment's t,
      // t + 4 in both operands (8-byte loads)
      float sacc[2][4], pacc[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[u][e] = pacc[u][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const int c0 = kk * 8 + 2 * t;
        unsigned qh[4], ql[4], gh[4], gl[4];
        {
          const float2 a = *reinterpret_cast<const float2*>(
              Qs + (wm + g) * ld + c0);
          const float2 b = *reinterpret_cast<const float2*>(
              Qs + (wm + g + 8) * ld + c0);
          tc_split_rz(a.x, qh[0], ql[0]);
          tc_split_rz(b.x, qh[1], ql[1]);
          tc_split_rz(a.y, qh[2], ql[2]);
          tc_split_rz(b.y, qh[3], ql[3]);
          const float2 e = *reinterpret_cast<const float2*>(
              Gs + (wm + g) * ld + c0);
          const float2 f = *reinterpret_cast<const float2*>(
              Gs + (wm + g + 8) * ld + c0);
          tc_split_rz(e.x, gh[0], gl[0]);
          tc_split_rz(f.x, gh[1], gl[1]);
          tc_split_rz(e.y, gh[2], gl[2]);
          tc_split_rz(f.y, gh[3], gl[3]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          unsigned kh[2], kl[2], vh[2], vl[2];
          const float2 kv = *reinterpret_cast<const float2*>(
              Kb + (ra + 8 * u) * ld + c0);
          const float2 vv = *reinterpret_cast<const float2*>(
              Vb + (ra + 8 * u) * ld + c0);
          tc_split_rz(kv.x, kh[0], kl[0]);
          tc_split_rz(kv.y, kh[1], kl[1]);
          tc_split_rz(vv.x, vh[0], vl[0]);
          tc_split_rz(vv.y, vh[1], vl[1]);
          tc_mma3(sacc[u], qh, ql, kh, kl);
          tc_mma3(pacc[u], gh, gl, vh, vl);
        }
      }

      // p = exp(s * scale - lse), ds = p (dp - delta); column c of n-tile
      // u is source row s0 + wn + 8 u + tc_perm(c); zero outside the valid
      // prefix and beyond L. ds's fragments are the A operands of dS K.
      unsigned dh[2][4], dl[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const bool valid = row_ok[h] &&
                             s0 + wn + 8 * u + tc_perm(2 * t + (e & 1)) <
                                 src_len;
          const float pr =
              valid ? exp2f(fmaf(sacc[u][e], scale2, -lse2[h])) : 0.f;
          ds[e] = valid ? pr * (pacc[u][e] - delta_r[h]) : 0.f;
        }
        tc_split_acc(ds, dh[u], dl[u]);
      }
      // dq += dS K over the warp's 16 source rows
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* k0 = Kb + (rb0 + 8 * u) * ld + g;
        const float* k1 = Kb + (rb1 + 8 * u) * ld + g;
#pragma unroll
        for (int n = 0; n < DQ_NT; ++n) {
          if (n < nk) {
            unsigned bh[2], bl[2];
            tc_split_rz(k0[8 * n], bh[0], bl[0]);
            tc_split_rz(k1[8 * n], bh[1], bl[1]);
            tc_mma3(acc[n], dh[u], dl[u], bh, bl);
          }
        }
      }
      __syncthreads();  // the tile's buffers are free again
    }
  }

  // The four source slices' partials of a query row, summed in slice order
  // in the ring's space: red[w][r][c] for warp w's row r.
  float* red = Ks;
#pragma unroll
  for (int n = 0; n < DQ_NT; ++n) {
    if (n < nk) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(red + (warp * 16 + g) * ld + c) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(red + (warp * 16 + g + 8) * ld + c) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  const int rj = DQ_BL * ld;           // from slice j to j + 1: four warps
  for (int i = threadIdx.x; i < DQ_BL * d; i += DQ_THREADS) {
    const int r = i / d, c = i - r * d;
    const int row = l0 + r;
    if (row < L) {
      const float* p = red + r * ld + c;
      const float sum = ((p[0] + p[rj]) + p[2 * rj]) + p[3 * rj];
      dq[(size_t)row * stride + (size_t)head * d + c] = sum * sm_scale;
    }
  }
}

static bool fb_bad_shape(int L, int S, int H, int d) {
  return d < 1 || d > FB_DMAX || L < 0 || S < 0 || H < 0;
}

// 16-byte copies need whole float4 rows and aligned bases
static int fb_vec(int d, const void* q, const void* k, const void* v,
                  const void* dout) {
  const size_t bases = (size_t)q | (size_t)k | (size_t)v | (size_t)dout;
  return d % 4 == 0 && bases % 16 == 0;
}

extern "C" int dp_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          const void* src_len, int L, int S,
                                          int H, int d, float sm_scale,
                                          void* dk, void* dv, void* stream) {
  if (fb_bad_shape(L, S, H, d)) return (int)cudaErrorInvalidValue;
  if (S > 0 && H > 0) {
    const int ld = tc_ld(d);
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
    const dim3 grid((S + DKV_BS - 1) / DKV_BS, H);
    flash_attention_bwd_dkv_kernel<<<grid, DKV_THREADS, smem,
                                     (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (const int*)src_len, L, S, H,
        d, sm_scale, fb_vec(d, q, k, v, dout), (float*)dk, (float*)dv);
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
    // rows of 8 (mod 16) floats where they fit (d <= 136), else unpadded
    int ld = tc_ld(d);
    if (dq_smem_bytes(ld) > 232448) ld = tc_dpad(d);
    const size_t smem = dq_smem_bytes(ld);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bwd_dq_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + DQ_BL - 1) / DQ_BL, H);
    flash_attention_bwd_dq_kernel<<<grid, DQ_THREADS, smem,
                                    (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (const int*)src_len, L, S, H,
        d, ld, sm_scale, fb_vec(d, q, k, v, dout), (float*)dq);
  }
  return (int)cudaGetLastError();
}
