// Shared definitions of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#define DP_MAX_WIDTH 256

// Motion and rotation-format codes; the host passes them as ints
// (ops/fused_iteration.py MOTIONS, ROTATION_FORMATS).
enum DpMotion { DP_SE3 = 0, DP_SIM3 = 1, DP_SFLOW = 2 };
enum DpRotFmt { DP_AXIS_ANGLE = 0, DP_EULER = 1, DP_QUATERNION = 2, DP_SIXD = 3 };

// Offsets of one pyramid level's parameters in the flat f32 vector that the
// solver optimizes. The order is that of a flattened parameter dict with
// sorted keys (JAX's ravel_pytree, which the JAX solver's Adam loop uses):
//   hidden.b [d-1, w], hidden.w [d-1, w, w], input.b [w], input.w [6, w],
//   nr.b [1], nr.w [w, 1] (the nonrigidity head, nonrigidity_est only),
//   rot.b [rd], rot.w [w, rd] (not for sflow), scale.b [1], scale.w [w, 1]
//   (Sim3 only), trn.b [3], trn.w [w, 3]
// with every weight stored [in, out], row-major; rd is the rotation head's
// width (3 for axis_angle and euler, 4 for the quaternion, 6 for 6D, and 0
// for sflow, which has a translation head only).
//
// The heads' outputs of one point sit in `hs` consecutive floats:
// [0, rd) the rotation head, [rd, rd + 3) the translation head, for Sim3
// the scale head at rd + 3, and last (hs - 1) the nonrigidity head's
// pre-activation where the layout has one.
struct LevelLayout {
  int w, depth, rd, hs;
  int hb, hw, ib, iw, nb, nw, rb, rw, sb, sw, tb, tw, total;
};

__host__ __device__ constexpr int rot_dim(int fmt) {
  return fmt == DP_AXIS_ANGLE || fmt == DP_EULER ? 3
         : fmt == DP_QUATERNION                  ? 4
         : fmt == DP_SIXD                        ? 6
                                                 : -1;
}

// Width of the rotation head in the layout: sflow has none.
__host__ __device__ constexpr int head_rot_dim(int motion, int fmt) {
  return motion == DP_SFLOW ? 0 : rot_dim(fmt);
}

// Head outputs per point for a motion and format (and the nonrigidity head
// when NR), known at compile time so that the per-point head arrays stay
// in registers.
template <int MOTION, int FMT, bool NR = false>
struct HeadCount {
  static constexpr int value =
      head_rot_dim(MOTION, FMT) + 3 + (MOTION == DP_SIM3 ? 1 : 0) + (NR ? 1 : 0);
};

// Calls f(motion, fmt) with both as std::integral_constant, for the nine
// (motion, format) pairs the kernels are built for: SE3 and Sim3 with each
// of the four formats, and sflow, which has no rotation (one instantiation
// serves every format).
template <typename F>
__host__ inline cudaError_t dispatch_layout(int motion, int fmt, F f) {
  using SE3 = std::integral_constant<int, DP_SE3>;
  using SIM3 = std::integral_constant<int, DP_SIM3>;
  using SFLOW = std::integral_constant<int, DP_SFLOW>;
  using AA = std::integral_constant<int, DP_AXIS_ANGLE>;
  using EUL = std::integral_constant<int, DP_EULER>;
  using QUAT = std::integral_constant<int, DP_QUATERNION>;
  using SIXD = std::integral_constant<int, DP_SIXD>;
  if (rot_dim(fmt) < 0) return cudaErrorInvalidValue;
  if (motion == DP_SFLOW) return f(SFLOW{}, AA{});
  if (motion == DP_SE3) {
    if (fmt == DP_AXIS_ANGLE) return f(SE3{}, AA{});
    if (fmt == DP_EULER) return f(SE3{}, EUL{});
    if (fmt == DP_QUATERNION) return f(SE3{}, QUAT{});
    return f(SE3{}, SIXD{});
  }
  if (motion == DP_SIM3) {
    if (fmt == DP_AXIS_ANGLE) return f(SIM3{}, AA{});
    if (fmt == DP_EULER) return f(SIM3{}, EUL{});
    if (fmt == DP_QUATERNION) return f(SIM3{}, QUAT{});
    return f(SIM3{}, SIXD{});
  }
  return cudaErrorInvalidValue;
}

__host__ __device__ __forceinline__ LevelLayout level_layout(
    int w, int depth, int motion, int fmt, bool nonrigid = false) {
  LevelLayout L;
  const int nh = depth - 1;
  L.w = w;
  L.depth = depth;
  L.rd = head_rot_dim(motion, fmt);
  L.hb = 0;
  L.hw = L.hb + nh * w;
  L.ib = L.hw + nh * w * w;
  L.iw = L.ib + w;
  int after_input = L.iw + 6 * w;
  L.nb = L.nw = -1;
  if (nonrigid) {
    L.nb = after_input;
    L.nw = L.nb + 1;
    after_input = L.nw + w;
  }
  L.rb = after_input;    // empty for sflow (rd = 0)
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
  L.hs = L.rd + 3 + (motion == DP_SIM3 ? 1 : 0) + (nonrigid ? 1 : 0);
  return L;
}

__host__ inline bool layout_supported(int width, int depth, int motion,
                                      int fmt) {
  return width >= 1 && width <= DP_MAX_WIDTH && depth >= 1 &&
         (motion == DP_SE3 || motion == DP_SIM3 || motion == DP_SFLOW) &&
         rot_dim(fmt) > 0;
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
  } else if (L.sb >= 0 && o == L.rd + 3) {
    s.b = L.sb;
    s.w = L.sw;
    s.ncol = 1;
  } else {   // the nonrigidity head, the last slot
    s.b = L.nb;
    s.w = L.nw;
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

// Quaternion (r, i, j, k), as the model applies it (models/pyramid.py
// rotation_from_features, reference nets.py:154-157 and
// rigid_body.py:62-85): q = h / (sgn * root), root = sqrt(max(|h|^2, 1e-12)),
// sgn = -1 where h_r < 0 (the scalar part ends up non-negative), then
//   R x = x + two_s (q_r (v cross x) + v (v.x) - x |v|^2),
// v = (q_i, q_j, q_k), two_s = 2 / max(|q|^2, 1e-12).
struct QuatState {
  float q[4], denom, two_s, m;
  bool above;   // |h|^2 above the floor: root depends on h
};

__device__ __forceinline__ QuatState quat_state(const float* h) {
  QuatState s;
  const float sq = h[0] * h[0] + h[1] * h[1] + h[2] * h[2] + h[3] * h[3];
  const float root = sqrtf(fmaxf(sq, 1e-12f));
  s.above = sq > 1e-12f;
  s.denom = h[0] < 0.f ? -root : root;
  for (int k = 0; k < 4; ++k) s.q[k] = h[k] / s.denom;
  const float n2 = s.q[0] * s.q[0] + s.q[1] * s.q[1] + s.q[2] * s.q[2] +
                   s.q[3] * s.q[3];
  s.m = fmaxf(n2, 1e-12f);
  s.two_s = 2.f / s.m;
  return s;
}

// u = q_r (v cross x) + v (v.x) - x |v|^2
__device__ __forceinline__ void quat_u(const float* q, const float* x, float* u) {
  const float* v = q + 1;
  const float c[3] = {v[1] * x[2] - v[2] * x[1], v[2] * x[0] - v[0] * x[2],
                      v[0] * x[1] - v[1] * x[0]};
  const float vx = v[0] * x[0] + v[1] * x[1] + v[2] * x[2];
  const float vv = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  for (int k = 0; k < 3; ++k) u[k] = q[0] * c[k] + v[k] * vx - x[k] * vv;
}

__device__ __forceinline__ void quaternion_fwd(const float* h, const float* x,
                                               float* out) {
  const QuatState s = quat_state(h);
  float u[3];
  quat_u(s.q, x, u);
  for (int k = 0; k < 3; ++k) out[k] = x[k] + s.two_s * u[k];
}

__device__ __forceinline__ void quaternion_vjp(const float* h, const float* x,
                                               const float* g, float* gh) {
  const QuatState s = quat_state(h);
  const float* v = s.q + 1;
  float u[3];
  quat_u(s.q, x, u);
  const float c[3] = {v[1] * x[2] - v[2] * x[1], v[2] * x[0] - v[0] * x[2],
                      v[0] * x[1] - v[1] * x[0]};
  const float xg[3] = {x[1] * g[2] - x[2] * g[1], x[2] * g[0] - x[0] * g[2],
                       x[0] * g[1] - x[1] * g[0]};
  const float vx = v[0] * x[0] + v[1] * x[1] + v[2] * x[2];
  const float gv = g[0] * v[0] + g[1] * v[1] + g[2] * v[2];
  const float gx = g[0] * x[0] + g[1] * x[1] + g[2] * x[2];
  const float g_two_s = g[0] * u[0] + g[1] * u[1] + g[2] * u[2];
  // cotangent of q: through u, then through two_s = 2 / max(|q|^2, floor)
  float gq[4];
  gq[0] = s.two_s * (g[0] * c[0] + g[1] * c[1] + g[2] * c[2]);
  for (int k = 0; k < 3; ++k)
    gq[1 + k] = s.two_s * (s.q[0] * xg[k] + g[k] * vx + x[k] * gv -
                           2.f * gx * v[k]);
  const float n2 = s.q[0] * s.q[0] + s.q[1] * s.q[1] + s.q[2] * s.q[2] +
                   s.q[3] * s.q[3];
  if (n2 > 1e-12f) {
    const float coef = -g_two_s * s.two_s * s.two_s;   // d two_s / d q = -(4 / m^2) q
    for (int k = 0; k < 4; ++k) gq[k] += coef * s.q[k];
  }
  // q = h / denom, denom = sgn * root: the projection off q where root
  // depends on h.
  float gqq = 0.f;
  if (s.above) gqq = gq[0] * s.q[0] + gq[1] * s.q[1] + gq[2] * s.q[2] + gq[3] * s.q[3];
  for (int k = 0; k < 4; ++k) gh[k] = (gq[k] - gqq * s.q[k]) / s.denom;
}

// 6D (a1, a2), Gram-Schmidt rows (geometry/rotations.py sixd_to_SO3,
// reference rigid_body.py:5-16): b1 = a1 / |a1|, c = a2 - (b1.a2) b1,
// b2 = c / |c|, b3 = b1 cross b2, R x = (b1.x, b2.x, b3.x); each norm is
// sqrt(max(|.|^2, 1e-12)).
struct SixdState {
  float b1[3], b2[3], b3[3], n1, n2, d;
  bool above1, above2;
};

__device__ __forceinline__ SixdState sixd_state(const float* h) {
  SixdState s;
  const float* a1 = h;
  const float* a2 = h + 3;
  const float sq1 = a1[0] * a1[0] + a1[1] * a1[1] + a1[2] * a1[2];
  s.above1 = sq1 > 1e-12f;
  s.n1 = sqrtf(fmaxf(sq1, 1e-12f));
  for (int k = 0; k < 3; ++k) s.b1[k] = a1[k] / s.n1;
  s.d = s.b1[0] * a2[0] + s.b1[1] * a2[1] + s.b1[2] * a2[2];
  float c[3];
  for (int k = 0; k < 3; ++k) c[k] = a2[k] - s.d * s.b1[k];
  const float sq2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
  s.above2 = sq2 > 1e-12f;
  s.n2 = sqrtf(fmaxf(sq2, 1e-12f));
  for (int k = 0; k < 3; ++k) s.b2[k] = c[k] / s.n2;
  s.b3[0] = s.b1[1] * s.b2[2] - s.b1[2] * s.b2[1];
  s.b3[1] = s.b1[2] * s.b2[0] - s.b1[0] * s.b2[2];
  s.b3[2] = s.b1[0] * s.b2[1] - s.b1[1] * s.b2[0];
  return s;
}

__device__ __forceinline__ void sixd_fwd(const float* h, const float* x,
                                         float* out) {
  const SixdState s = sixd_state(h);
  out[0] = s.b1[0] * x[0] + s.b1[1] * x[1] + s.b1[2] * x[2];
  out[1] = s.b2[0] * x[0] + s.b2[1] * x[1] + s.b2[2] * x[2];
  out[2] = s.b3[0] * x[0] + s.b3[1] * x[1] + s.b3[2] * x[2];
}

__device__ __forceinline__ void sixd_vjp(const float* h, const float* x,
                                         const float* g, float* gh) {
  const SixdState s = sixd_state(h);
  const float* a2 = h + 3;
  float gb1[3], gb2[3], gb3[3];
  for (int k = 0; k < 3; ++k) {
    gb1[k] = g[0] * x[k];
    gb2[k] = g[1] * x[k];
    gb3[k] = g[2] * x[k];
  }
  // b3 = b1 cross b2: d/d b1 = b2 cross g3, d/d b2 = g3 cross b1
  gb1[0] += s.b2[1] * gb3[2] - s.b2[2] * gb3[1];
  gb1[1] += s.b2[2] * gb3[0] - s.b2[0] * gb3[2];
  gb1[2] += s.b2[0] * gb3[1] - s.b2[1] * gb3[0];
  gb2[0] += gb3[1] * s.b1[2] - gb3[2] * s.b1[1];
  gb2[1] += gb3[2] * s.b1[0] - gb3[0] * s.b1[2];
  gb2[2] += gb3[0] * s.b1[1] - gb3[1] * s.b1[0];
  // b2 = c / n2
  float gc[3];
  const float p2 = s.above2 ? gb2[0] * s.b2[0] + gb2[1] * s.b2[1] + gb2[2] * s.b2[2] : 0.f;
  for (int k = 0; k < 3; ++k) gc[k] = (gb2[k] - p2 * s.b2[k]) / s.n2;
  // c = a2 - d b1, d = b1 . a2
  const float gd = -(gc[0] * s.b1[0] + gc[1] * s.b1[1] + gc[2] * s.b1[2]);
  for (int k = 0; k < 3; ++k) {
    gh[3 + k] = gc[k] + gd * s.b1[k];
    gb1[k] += -s.d * gc[k] + gd * a2[k];
  }
  // b1 = a1 / n1
  const float p1 = s.above1 ? gb1[0] * s.b1[0] + gb1[1] * s.b1[1] + gb1[2] * s.b1[2] : 0.f;
  for (int k = 0; k < 3; ++k) gh[k] = (gb1[k] - p1 * s.b1[k]) / s.n1;
}

template <int FMT>
__device__ __forceinline__ void rot_fwd(const float* r, const float* x, float* out) {
  if constexpr (FMT == DP_EULER) {
    euler_fwd(r, x, out);
  } else if constexpr (FMT == DP_QUATERNION) {
    quaternion_fwd(r, x, out);
  } else if constexpr (FMT == DP_SIXD) {
    sixd_fwd(r, x, out);
  } else {
    axis_angle_fwd(r, x, out);
  }
}

template <int FMT>
__device__ __forceinline__ void rot_vjp(const float* r, const float* x, const float* g,
                               float* gr) {
  if constexpr (FMT == DP_EULER) {
    euler_vjp(r, x, g, gr);
  } else if constexpr (FMT == DP_QUATERNION) {
    quaternion_vjp(r, x, g, gr);
  } else if constexpr (FMT == DP_SIXD) {
    sixd_vjp(r, x, g, gr);
  } else {
    axis_angle_vjp(r, x, g, gr);
  }
}

// ---------------------------------------------------------------------------
// Motion: out = s R x + t (SE3: s = 1; sflow: out = x + t, no rotation),
// from one point's head outputs `head` (already mlp-scaled; the Sim3 scale
// head gives s = head + 1).
// ---------------------------------------------------------------------------

template <int MOTION, int FMT>
__device__ __forceinline__ void motion_fwd(const float* head, const float* x,
                                  float* out) {
  constexpr int RD = head_rot_dim(MOTION, FMT);
  const float* t = head + RD;
  if constexpr (MOTION == DP_SFLOW) {
    for (int k = 0; k < 3; ++k) out[k] = x[k] + t[k];
  } else {
    float rx[3];
    rot_fwd<FMT>(head, x, rx);
    if constexpr (MOTION == DP_SIM3) {
      const float s = head[RD + 3] + 1.f;
      for (int k = 0; k < 3; ++k) out[k] = s * rx[k] + t[k];
    } else {
      for (int k = 0; k < 3; ++k) out[k] = rx[k] + t[k];
    }
  }
}

// Cotangents of the head outputs for the cotangent g of the warped point:
// translation g, scale g . (R x), rotation the rotation VJP of s g.
template <int MOTION, int FMT>
__device__ __forceinline__ void motion_vjp(const float* head, const float* x,
                                  const float* g, float* ghead) {
  constexpr int RD = head_rot_dim(MOTION, FMT);
  for (int k = 0; k < 3; ++k) ghead[RD + k] = g[k];
  if constexpr (MOTION == DP_SFLOW) {
    return;
  } else if constexpr (MOTION == DP_SIM3) {
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

// The nonrigidity head: nr = sigmoid(z) of its (mlp-scaled) pre-activation,
// as torch.sigmoid and jax.nn.sigmoid compute it.
__device__ __forceinline__ float sigmoid_f(float z) {
  return 1.f / (1.f + expf(-z));
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
