// What the streamed-attention kernels C7 (flash_attention.cu), C8 and C9
// (flash_attention_bwd.cu) share: 3xTF32 products on the tensor cores
// (mma.sync m16n8k8) and cp.async copies of row-major tiles into shared
// memory, for blocks of TC_THREADS threads.
//
// 3xTF32: each operand x = hi + lo, both rounded to TF32 (ties away), and
// a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, ~1e-6 off f32 on unit-scale
// inputs; one TF32 pass keeps about three decimal digits (~1e-3 in a logit
// of 132 terms), beyond the 2e-5 the kernels are held to. The tensor cores'
// own f32 accumulation truncates, and over a long product its bias reaches
// 2e-5, so every k-step's three passes start from zero and are added to the
// running sum on the FMA units, which round to nearest.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, row-major)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// column-major) b0 (t, g), b1 (t + 4, g); the accumulator c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
#pragma once

#include <cuda_runtime.h>

#define TC_THREADS 256
#define TC_LOG2E 1.4426950408889634f   // the softmaxes run in log2 units
#define TC_LN2 0.6931471805599453f

__device__ __forceinline__ unsigned tc_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi = x rounded to tf32 (ties away) and lo the rest,
// rounded again: hi*b_hi + hi*b_lo + lo*b_hi carries ~21 bits of x*b.
__device__ __forceinline__ void tc_split(float x, unsigned& hi, unsigned& lo) {
  hi = tc_tf32(x);
  lo = tc_tf32(x - __uint_as_float(hi));
}

// The split of C7 and C9, in two instructions on the full-rate units: hi
// = x with the 13 bits that TF32 drops cleared (rounded toward zero), lo =
// x - hi exactly, handed to the tensor cores as it is: they read the top 19
// bits of a TF32 operand, so lo too is rounded toward zero there. a b then
// carries ~20 bits, as close to f32 as tc_split's on unit-scale inputs
// (the CPU tests emulate both). tc_split's two cvt.rna.tf32.f32 run on the
// conversion unit: with them an earlier build of C9 took 1.80 ms at 4096 /
// 2836 rows, with this split 1.37.
__device__ __forceinline__ void tc_split_rz(float x, unsigned& hi,
                                            unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void tc_mma(float (&c)[4], const unsigned (&a)[4],
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
__device__ __forceinline__ void tc_mma3(float (&c)[4], const unsigned (&ah)[4],
                                        const unsigned (&al)[4],
                                        const unsigned (&bh)[2],
                                        const unsigned (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  tc_mma(t, al, bh);
  tc_mma(t, ah, bl);
  tc_mma(t, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], t[e]);
}

// An accumulator fragment (16 x 8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8,
// 2t), c3 (g + 8, 2t + 1)) as the A operand of the next product, split:
// the next product reads its summed index t as the accumulator's column 2t
// and t + 4 as column 2t + 1 (a permutation of the sum), so the fragment
// feeds the tensor cores from registers, with no round trip through shared
// memory. Its B operand reads the same permutation: b0 from the row of
// column 2t, b1 from the row of column 2t + 1.
__device__ __forceinline__ void tc_split_acc(const float (&c)[4],
                                             unsigned (&hi)[4],
                                             unsigned (&lo)[4]) {
  tc_split_rz(c[0], hi[0], lo[0]);
  tc_split_rz(c[2], hi[1], lo[1]);
  tc_split_rz(c[1], hi[2], lo[2]);
  tc_split_rz(c[3], hi[3], lo[3]);
}

// Which of a slice's 8 streamed rows the n index g of a first product (S =
// Q K^T) reads, so that accumulator column c stands for row tc_perm(c).
// With rows of ld = 8 (mod 16) floats, row r starts at bank 8r or 24r (mod
// 32), so rows whose index differs mod 4 never share a bank. The first
// product's 8-byte loads read rows tc_perm(0..3), then tc_perm(4..7); the
// second product's 4-byte loads rows tc_perm(2t) and tc_perm(2t + 1) for t
// = 0..3: each set is 4 rows distinct mod 4 under g ^ ((g >> 2) & 1), where
// the identity puts rows 0 and 4 (2t for t = 0, 2) on one bank.
__device__ __forceinline__ int tc_perm(int g) { return g ^ ((g >> 2) & 1); }

__device__ __forceinline__ void tc_cp16(float* smem, const float* gmem,
                                        bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void tc_cp4(float* smem, const float* gmem,
                                       bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void tc_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

template <int N>
__device__ __forceinline__ void tc_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Starts the copy dst[r][c] = x[row0 + r, head, c] for ``nrows`` rows and
// c < dpad; rows at or beyond ``limit`` and columns d .. dpad - 1 are
// zero-filled without reading global memory. ``vec``: 16-byte copies (d a
// multiple of 4 and every base 16-byte aligned), else 4-byte ones. A block
// of THREADS threads.
template <int THREADS = TC_THREADS>
__device__ __forceinline__ void tc_stage(float* __restrict__ dst,
                                         const float* __restrict__ x,
                                         int row0, int limit, int nrows,
                                         size_t stride, int head, int d,
                                         int dpad, int ld, bool vec) {
  const int step = vec ? 4 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += THREADS / 32) {
    const bool row_ok = row0 + r < limit;
    const float* xr = x + (size_t)(row0 + r) * stride + (size_t)head * d;
    for (int c = lane * step; c < dpad; c += 32 * step) {
      const bool ok = row_ok && c < d;
      if (vec)
        tc_cp16(dst + r * ld + c, ok ? xr + c : x, ok);
      else
        tc_cp4(dst + r * ld + c, ok ? xr + c : x, ok);
    }
  }
}

// tc_stage's 16-byte path for a tile of ROWS rows with the loops unrolled
// at compile time: thread (warp, lane) copies rows warp + i THREADS / 32
// of the tile, columns 4 lane and 4 lane + 128 (dpad <= 144). ``x``
// points at the tile's first row of the head; rows at or beyond
// ``nvalid`` are zero-filled.
template <int THREADS, int ROWS>
__device__ __forceinline__ void tc_stage16(float* __restrict__ dst,
                                           const float* __restrict__ x,
                                           int nvalid, size_t stride, int d,
                                           int dpad, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < ROWS / (THREADS / 32); ++i) {
    const int r = warp + i * (THREADS / 32);
    const float* xr = x + (size_t)r * stride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 4 * lane + 128 * h;
      if (c < dpad) {
        const bool ok = r < nvalid && c < d;
        tc_cp16(dst + r * ld + c, ok ? xr + c : x, ok);
      }
    }
  }
}

// The head width padded to whole k-steps of 8, and the row of a tile in
// shared memory: = 8 (mod 16) floats, so that the fragment loads of a
// half-warp fall on distinct banks.
__host__ __device__ __forceinline__ int tc_dpad(int d) { return (d + 7) & ~7; }
__host__ __device__ __forceinline__ int tc_ld(int d) {
  const int dpad = tc_dpad(d);
  return (dpad & 15) ? dpad : dpad + 8;
}
