// Shared definitions of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#define DP_MAX_WIDTH 256

// Motion and rotation-format codes; the host passes them as ints
// (ops/fused_iteration.py MOTIONS, ROTATION_FORMATS).
enum DpMotion { DP_SE3 = 0, DP_SIM3 = 1 };
enum DpRotFmt { DP_AXIS_ANGLE = 0, DP_EULER = 1 };

// Offsets of one pyramid level's parameters in the flat f32 vector that the
// solver optimizes. The order is that of a flattened parameter dict with
// sorted keys (JAX's ravel_pytree, which the JAX solver's Adam loop uses):
//   hidden.b [d-1, w], hidden.w [d-1, w, w], input.b [w], input.w [6, w],
//   rot.b [rd], rot.w [w, rd], scale.b [1], scale.w [w, 1] (Sim3 only),
//   trn.b [3], trn.w [w, 3]
// with every weight stored [in, out], row-major; rd is the rotation head's
// width (3 for axis_angle and euler).
//
// The heads' outputs of one point sit in `hs` consecutive floats:
// [0, rd) the rotation head, [rd, rd + 3) the translation head, and for
// Sim3 the scale head at rd + 3.
struct LevelLayout {
  int w, depth, rd, hs;
  int hb, hw, ib, iw, rb, rw, sb, sw, tb, tw, total;
};

__host__ __device__ constexpr int rot_dim(int fmt) {
  return fmt == DP_AXIS_ANGLE || fmt == DP_EULER ? 3 : -1;
}

// Head outputs per point for a motion and format, known at compile time so
// that the per-point head arrays stay in registers.
template <int MOTION, int FMT>
struct HeadCount {
  static constexpr int value = rot_dim(FMT) + 3 + (MOTION == DP_SIM3 ? 1 : 0);
};

// Calls f(motion, fmt) with both as std::integral_constant, for the four
// (motion, format) pairs the kernels are built for.
template <typename F>
__host__ inline cudaError_t dispatch_layout(int motion, int fmt, F f) {
  using SE3 = std::integral_constant<int, DP_SE3>;
  using SIM3 = std::integral_constant<int, DP_SIM3>;
  using AA = std::integral_constant<int, DP_AXIS_ANGLE>;
  using EUL = std::integral_constant<int, DP_EULER>;
  if (motion == DP_SE3 && fmt == DP_AXIS_ANGLE) return f(SE3{}, AA{});
  if (motion == DP_SE3 && fmt == DP_EULER) return f(SE3{}, EUL{});
  if (motion == DP_SIM3 && fmt == DP_AXIS_ANGLE) return f(SIM3{}, AA{});
  if (motion == DP_SIM3 && fmt == DP_EULER) return f(SIM3{}, EUL{});
  return cudaErrorInvalidValue;
}

__host__ __device__ __forceinline__ LevelLayout level_layout(int w, int depth,
                                                   int motion, int fmt) {
  LevelLayout L;
  const int nh = depth - 1;
  L.w = w;
  L.depth = depth;
  L.rd = rot_dim(fmt);
  L.hb = 0;
  L.hw = L.hb + nh * w;
  L.ib = L.hw + nh * w * w;
  L.iw = L.ib + w;
  L.rb = L.iw + 6 * w;
  L.rw = L.rb + L.rd;
  int next = L.rw + L.rd * w;
  L.sb = L.sw = -1;
  if (motion == DP_SIM3) {
    L.sb = next;
    L.sw = L.sb + 1;
    next = L.sw + w;
  }
  L.tb = next;
  L.tw = L.tb + 3;
  L.total = L.tw + 3 * w;
  L.hs = L.rd + 3 + (motion == DP_SIM3 ? 1 : 0);
  return L;
}

__host__ inline bool layout_supported(int width, int depth, int motion,
                                      int fmt) {
  return width >= 1 && width <= DP_MAX_WIDTH && depth >= 1 &&
         (motion == DP_SE3 || motion == DP_SIM3) && rot_dim(fmt) > 0;
}

// Where head output o of a point comes from: its bias is prm[b], its
// weight column prm[w + k * ncol] for k < width.
struct HeadSlot {
  int b, w, ncol;
};

__device__ __forceinline__ HeadSlot head_slot(const LevelLayout& L, int o) {
  HeadSlot s;
  if (o < L.rd) {
    s.b = L.rb + o;
    s.w = L.rw + o;
    s.ncol = L.rd;
  } else if (o < L.rd + 3) {
    s.b = L.tb + (o - L.rd);
    s.w = L.tw + (o - L.rd);
    s.ncol = 3;
  } else {
    s.b = L.sb;
    s.w = L.sw;
    s.ncol = 1;
  }
  return s;
}

// ---------------------------------------------------------------------------
// Rotations: R x from the (mlp-scaled) rotation head r, and the VJP that
// maps a cotangent g of R x to the cotangent of r. Full-precision
// sinf/cosf/sqrtf: the axis-angle VJP divides by theta ~ 1e-3.
// ---------------------------------------------------------------------------

// Matrix-free Rodrigues with the 1e-12 floor on theta^2:
//   R x = x + sin(t) (w x x) + (1 - cos(t)) (w (w.x) - x),
//   t = sqrt(max(|r|^2, 1e-12)), w = r / t.
__device__ __forceinline__ void axis_angle_fwd(const float* r, const float* x,
                                      float* out) {
  const float sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const float theta = sqrtf(fmaxf(sq, 1e-12f));
  const float w0 = r[0] / theta, w1 = r[1] / theta, w2 = r[2] / theta;
  const float st = sinf(theta), ct = cosf(theta);
  const float c0 = w1 * x[2] - w2 * x[1];
  const float c1 = w2 * x[0] - w0 * x[2];
  const float c2 = w0 * x[1] - w1 * x[0];
  const float a = w0 * x[0] + w1 * x[1] + w2 * x[2];
  out[0] = x[0] + st * c0 + (1.f - ct) * (w0 * a - x[0]);
  out[1] = x[1] + st * c1 + (1.f - ct) * (w1 * a - x[1]);
  out[2] = x[2] + st * c2 + (1.f - ct) * (w2 * a - x[2]);
}

__device__ __forceinline__ void axis_angle_vjp(const float* r, const float* x,
                                      const float* g, float* gr) {
  const float sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const float theta = sqrtf(fmaxf(sq, 1e-12f));
  const float w[3] = {r[0] / theta, r[1] / theta, r[2] / theta};
  const float st = sinf(theta), ct = cosf(theta);
  const float c[3] = {w[1] * x[2] - w[2] * x[1], w[2] * x[0] - w[0] * x[2],
                      w[0] * x[1] - w[1] * x[0]};
  const float a = w[0] * x[0] + w[1] * x[1] + w[2] * x[2];
  // x cross g
  const float xg[3] = {x[1] * g[2] - x[2] * g[1], x[2] * g[0] - x[0] * g[2],
                       x[0] * g[1] - x[1] * g[0]};
  const float gdw = g[0] * w[0] + g[1] * w[1] + g[2] * w[2];
  float gth = 0.f, gw[3];
  for (int k = 0; k < 3; ++k) {
    gth += g[k] * (ct * c[k] + st * (w[k] * a - x[k]));
    gw[k] = st * xg[k] + (1.f - ct) * (a * g[k] + gdw * x[k]);
  }
  // w = r / theta, theta = sqrt(max(|r|^2, eps)): theta depends on r only
  // where the floor is not active.
  const float gww = gw[0] * w[0] + gw[1] * w[1] + gw[2] * w[2];
  const float coef = sq > 1e-12f ? (gth - gww / theta) : 0.f;
  for (int k = 0; k < 3; ++k) gr[k] = gw[k] / theta + coef * w[k];
}

// XYZ Euler angles (a, b, c): R = Rx(a) Ry(b) Rz(c), applied as
// z = Rz(c) x, y = Ry(b) z, R x = Rx(a) y (ops/fused_level.py
// _forward_math_t, reference rigid_body.py:19-56).
__device__ __forceinline__ void euler_chain(const float* r, const float* x, float* z,
                                   float* y, float* o, float* sc) {
  const float sa = sinf(r[0]), ca = cosf(r[0]);
  const float sb = sinf(r[1]), cb = cosf(r[1]);
  const float s_c = sinf(r[2]), c_c = cosf(r[2]);
  z[0] = c_c * x[0] - s_c * x[1];
  z[1] = s_c * x[0] + c_c * x[1];
  z[2] = x[2];
  y[0] = cb * z[0] + sb * z[2];
  y[1] = z[1];
  y[2] = -sb * z[0] + cb * z[2];
  o[0] = y[0];
  o[1] = ca * y[1] - sa * y[2];
  o[2] = sa * y[1] + ca * y[2];
  sc[0] = sa; sc[1] = ca; sc[2] = sb; sc[3] = cb; sc[4] = s_c; sc[5] = c_c;
}

__device__ __forceinline__ void euler_fwd(const float* r, const float* x, float* out) {
  float z[3], y[3], sc[6];
  euler_chain(r, x, z, y, out, sc);
}

// d(Rx(a) y)/da = (0, -o2, o1); back through Rx, d(Ry(b) z)/db =
// (y2, 0, -y0); back through Ry, d(Rz(c) x)/dc = (-z1, z0, 0).
__device__ __forceinline__ void euler_vjp(const float* r, const float* x,
                                 const float* g, float* gr) {
  float z[3], y[3], o[3], sc[6];
  euler_chain(r, x, z, y, o, sc);
  const float sa = sc[0], ca = sc[1], sb = sc[2], cb = sc[3];
  gr[0] = g[2] * o[1] - g[1] * o[2];
  const float gy0 = g[0];
  const float gy1 = ca * g[1] + sa * g[2];
  const float gy2 = -sa * g[1] + ca * g[2];
  gr[1] = gy0 * y[2] - gy2 * y[0];
  const float gz0 = cb * gy0 - sb * gy2;
  const float gz1 = gy1;
  gr[2] = gz1 * z[0] - gz0 * z[1];
}

template <int FMT>
__device__ __forceinline__ void rot_fwd(const float* r, const float* x, float* out) {
  if constexpr (FMT == DP_EULER) {
    euler_fwd(r, x, out);
  } else {
    axis_angle_fwd(r, x, out);
  }
}

template <int FMT>
__device__ __forceinline__ void rot_vjp(const float* r, const float* x, const float* g,
                               float* gr) {
  if constexpr (FMT == DP_EULER) {
    euler_vjp(r, x, g, gr);
  } else {
    axis_angle_vjp(r, x, g, gr);
  }
}

// ---------------------------------------------------------------------------
// Motion: out = s R x + t (SE3: s = 1), from one point's head outputs
// `head` (already mlp-scaled; the Sim3 scale head gives s = head + 1).
// ---------------------------------------------------------------------------

template <int MOTION, int FMT>
__device__ __forceinline__ void motion_fwd(const float* head, const float* x,
                                  float* out) {
  constexpr int RD = rot_dim(FMT);
  float rx[3];
  rot_fwd<FMT>(head, x, rx);
  const float* t = head + RD;
  if constexpr (MOTION == DP_SIM3) {
    const float s = head[RD + 3] + 1.f;
    for (int k = 0; k < 3; ++k) out[k] = s * rx[k] + t[k];
  } else {
    for (int k = 0; k < 3; ++k) out[k] = rx[k] + t[k];
  }
}

// Cotangents of the head outputs for the cotangent g of the warped point:
// translation g, scale g . (R x), rotation the rotation VJP of s g.
template <int MOTION, int FMT>
__device__ __forceinline__ void motion_vjp(const float* head, const float* x,
                                  const float* g, float* ghead) {
  constexpr int RD = rot_dim(FMT);
  for (int k = 0; k < 3; ++k) ghead[RD + k] = g[k];
  if constexpr (MOTION == DP_SIM3) {
    float rx[3];
    rot_fwd<FMT>(head, x, rx);
    const float s = head[RD + 3] + 1.f;
    ghead[RD + 3] = g[0] * rx[0] + g[1] * rx[1] + g[2] * rx[2];
    const float sg[3] = {s * g[0], s * g[1], s * g[2]};
    rot_vjp<FMT>(head, x, sg, ghead);
  } else {
    rot_vjp<FMT>(head, x, g, ghead);
  }
}

// ---------------------------------------------------------------------------
// optax.adam(lr) with b1, b2, eps, eps_root = 0, bias correction by t steps:
//   m2 = b1 m + (1-b1) g,  v2 = b2 v + (1-b2) g^2,
//   upd = -lr (m2 / bc1) / (sqrt(v2 / bc2) + eps),  bc = 1 - b^t.
// c1 = 1-b1 and c2 = 1-b2 come from the host, rounded from double as
// optax rounds them.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void adam_update(float* p, float* m, float* v, float g,
                                   float t, float lr, float b1, float b2,
                                   float c1, float c2, float eps) {
  const float bc1 = 1.f - powf(b1, t);
  const float bc2 = 1.f - powf(b2, t);
  const float m2 = b1 * (*m) + c1 * g;
  const float v2 = b2 * (*v) + c2 * (g * g);
  const float upd = (m2 / bc1) / (sqrtf(v2 / bc2) + eps) * (-lr);
  *p = *p + upd;
  *m = m2;
  *v = v2;
}
