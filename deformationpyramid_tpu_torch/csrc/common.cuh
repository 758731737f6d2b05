// Shared definitions of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Offsets of one pyramid level's parameters in the flat f32 vector that the
// solver optimizes. The order is that of a flattened parameter dict with
// sorted keys (JAX's ravel_pytree, which the JAX solver's Adam loop uses):
//   hidden.b [d-1, w], hidden.w [d-1, w, w], input.b [w], input.w [6, w],
//   rot.b [3], rot.w [w, 3], trn.b [3], trn.w [w, 3]
// with every weight stored [in, out], row-major. SE3 motion with the
// axis-angle rotation head only (the kernels' coverage).
struct LevelLayout {
  int w, depth;
  int hb, hw, ib, iw, rb, rw, tb, tw, total;
};

__host__ __device__ inline LevelLayout level_layout(int w, int depth) {
  LevelLayout L;
  const int nh = depth - 1;
  L.w = w;
  L.depth = depth;
  L.hb = 0;
  L.hw = L.hb + nh * w;
  L.ib = L.hw + nh * w * w;
  L.iw = L.ib + w;
  L.rb = L.iw + 6 * w;
  L.rw = L.rb + 3;
  L.tb = L.rw + 3 * w;
  L.tw = L.tb + 3;
  L.total = L.tw + 3 * w;
  return L;
}

#define DP_MAX_WIDTH 256
