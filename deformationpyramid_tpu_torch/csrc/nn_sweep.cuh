// The split-database exact 1-NN sweep of the port's nearest-neighbour
// kernels: C1 nn_dual (nn_dual.cu), C14 nn_argmin (nn_argmin.cu) and the
// sweep of C12 chamfer_fused (chamfer_fused.cu).
//
// A block of WARPS warps answers NNSweep::Q queries. The lanes of a warp
// form G groups of 32 / G lanes, a query a lane (QPL of them: lane l of a
// group holds queries l, l + 32 / G, ...), and the database is split into
// WARPS x G contiguous slices in index order, one a group. Each warp
// streams its groups' slices through its own NN_STAGE-candidate buffer in
// shared memory, two candidates a lane loaded a tile ahead, each staged as
// one float4 by the kernel's Stage functor: a candidate is one broadcast
// 16-byte load that feeds every query of its group. A pad past a slice's
// end is staged with x = NaN, so its distance is NaN and never passes the
// strict '<'. The slices' (min, argmin) partials are then merged through
// shared memory. G > 1 gives more slices a query, and so more blocks'
// worth of warps for the same queries, where ceil(N / 32) blocks would
// leave SMs idle; QPL > 1 feeds QPL queries from one candidate load.
//
// Selection (bit-equal for any WARPS, G and QPL): a group visits its slice
// in increasing index order with a strict '<', so an exact tie goes to the
// slice's first index; a slice with no winner (no candidate below +inf:
// only invalid, +inf or NaN distances) keeps (+inf, NN_NONE); the merge
// takes (d, i) over (d', i') when d < d' || (d == d' && i < i'), a rule
// that is associative and commutative, so the merged pair is the
// first-index minimum of the whole database in any number of slices and
// any merge order. The caller turns NN_NONE into 0. No atomics.
//
// The distance is the kernel's Dist functor, called as dist(r, c) for the
// lane's query r and a staged candidate c.
#pragma once

#include <climits>

#include "common.cuh"

#define NN_STAGE 64                // candidates a warp stages at a time,
                                   // two a lane
#define NN_NONE INT_MAX            // a slice's index while nothing won

template <int WARPS, int G, int QPL>
struct NNSweep {
  static_assert(G == 1 || G == 2, "one or two lane groups a warp");
  static constexpr int LANES = 32 / G;        // lanes of a group
  static constexpr int Q = LANES * QPL;       // queries a block
  static constexpr int SLICES = WARPS * G;    // slices a query
  static constexpr int TILE = NN_STAGE / G;   // a group's share of a stage
  struct Smem {
    float4 stage[WARPS][NN_STAGE];
    float part_d[SLICES][Q];
    int part_i[SLICES][Q];
  };
  // The block's query p (0 <= p < Q) held by lane `lane` as its query r.
  __device__ static int query_of(int lane, int r) {
    return lane % LANES + r * LANES;
  }
};

// The sweep of one block: every lane's best (d, i) over its group's slice
// for its QPL queries (set up by `dist`), written to the partials. The
// caller then __syncthreads() and merges (nn_merge).
template <int WARPS, int G, int QPL, class Stage, class Dist>
__device__ __forceinline__ void nn_sweep(
    typename NNSweep<WARPS, G, QPL>::Smem& sm, const Stage& stage,
    const Dist& dist, int ndb) {
  using S = NNSweep<WARPS, G, QPL>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / S::LANES;
  // slice s of ndb rows: [min(s * per, ndb), min(s * per + per, ndb))
  const int per = (ndb + S::SLICES - 1) / S::SLICES;
  const int lo = min((warp * G + g) * per, ndb);
  // the stage's slots lane and lane + 32: group ga / gb, candidate ka / kb
  const int ga = lane / S::TILE, gb = (lane + 32) / S::TILE;
  const int ka = lane % S::TILE, kb = (lane + 32) % S::TILE;
  const int lo_a = min((warp * G + ga) * per, ndb);
  const int lo_b = min((warp * G + gb) * per, ndb);
  const int hi_a = min(lo_a + per, ndb), hi_b = min(lo_b + per, ndb);
  // the warp's first slice is its longest: its length bounds the loop
  const int lo0 = min(warp * G * per, ndb);
  const int len = min(lo0 + per, ndb) - lo0;
  float4* st = sm.stage[warp];
  const float4* mine = st + g * S::TILE;
  float best[QPL];
  int best_i[QPL];
#pragma unroll
  for (int r = 0; r < QPL; ++r) {
    best[r] = INFINITY;
    best_i[r] = NN_NONE;
  }
  float4 next0 = stage(lo_a + ka, hi_a);
  float4 next1 = stage(lo_b + kb, hi_b);
  for (int off = 0; off < len; off += S::TILE) {
    __syncwarp();
    st[lane] = next0;
    st[lane + 32] = next1;
    __syncwarp();
    next0 = stage(lo_a + off + S::TILE + ka, hi_a);
    next1 = stage(lo_b + off + S::TILE + kb, hi_b);
#pragma unroll
    for (int k = 0; k < S::TILE; ++k) {
      const float4 c = mine[k];
#pragma unroll
      for (int r = 0; r < QPL; ++r) {
        const float d = dist(r, c);
        if (d < best[r]) {
          best[r] = d;
          best_i[r] = lo + off + k;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < QPL; ++r) {
    sm.part_d[warp * G + g][S::query_of(lane, r)] = best[r];
    sm.part_i[warp * G + g][S::query_of(lane, r)] = best_i[r];
  }
}

// Query p's merged (d, i) over the slices' partials, in slice order; i is
// NN_NONE where no slice had a winner.
template <int WARPS, int G, int QPL>
__device__ __forceinline__ void nn_merge(
    const typename NNSweep<WARPS, G, QPL>::Smem& sm, int p, float& d,
    int& i) {
  d = sm.part_d[0][p];
  i = sm.part_i[0][p];
#pragma unroll
  for (int s = 1; s < NNSweep<WARPS, G, QPL>::SLICES; ++s) {
    const float ds = sm.part_d[s][p];
    const int is = sm.part_i[s][p];
    if (ds < d || (ds == d && is < i)) {
      d = ds;
      i = is;
    }
  }
}

// The exact difference form (qx-px)^2 + (qy-py)^2 + (qz-pz)^2, summed left
// to right with no FMA contraction (never |q|^2 + |p|^2 - 2 q.p, whose
// cancellation floors the chamfer loss).
__device__ __forceinline__ float nn_sqdist(float qx, float qy, float qz,
                                           const float4& c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The staging of C1 and C14: candidate j of the slice ending at `hi` as
// (x, y, z, 0), with x = NaN where the row is invalid (dbv[j] == 0) or
// past the slice. NULLABLE: a null dbv means every row is valid (C14's
// y_valid; C1 always has its masks).
template <bool NULLABLE>
struct NNStageNaN {
  const float* __restrict__ db;
  const unsigned char* __restrict__ dbv;
  __device__ __forceinline__ float4 operator()(int j, int hi) const {
    float4 c = make_float4(__int_as_float(0x7fffffff), 0.f, 0.f, 0.f);
    if (j < hi) {
      c.y = db[j * 3 + 1];
      c.z = db[j * 3 + 2];
      if ((NULLABLE && dbv == nullptr) || dbv[j]) c.x = db[j * 3 + 0];
    }
    return c;
  }
};

// The plain distance of C1 and C14 from the lane's QPL queries.
template <int QPL>
struct NNDistPlain {
  float qx[QPL], qy[QPL], qz[QPL];
  __device__ __forceinline__ float operator()(int r, const float4& c) const {
    return nn_sqdist(qx[r], qy[r], qz[r], c);
  }
};
