// Device counterparts of jello_tpu_torch/flatten_math.py and of the
// point evaluation the walk and the Euler expansion share
// (pipeline/lockstep.py::pq_at, pipeline/flatten.py::euler_line_points).
//
// Written op by op in the torch code's order, with Python's constant
// folding done in double and cast to float once, so that with
// -fmad=false each value rounds as the torch version's does on the card.
// The subdivision count (a ceil of these values) then agrees exactly;
// only cbrt's expf/logf seed and espc_int_inv_approx's powf may differ
// from torch's by an ulp, and they only position points along a segment.

#pragma once

#include "pmath.cuh"

namespace fm {

using pm::clamp_min;
using pm::clamp_max;

constexpr double kDerivThresh = 1e-6;
constexpr double kDerivEps = 1e-6;
constexpr float kSubdivLimit = 1.0f / 65536.0f;
constexpr double kTangentThresh = 1e-6;
constexpr double kRobustEpsilon = 2e-7;
constexpr double kK1Thresh = 1e-3;
constexpr double kDistThresh = 1e-3;
constexpr float kTol = 0.25f;
constexpr int kRobustNormal = 0;
constexpr int kRobustLowK1 = 1;
constexpr int kRobustLowDist = 2;

struct Cubic {
  float p[8];  // p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y
};

struct PQ {
  float px, py, qx, qy, t;
};

// cubic_start_tangent and cubic_end_tangent: the first chord from the
// segment's start (end) longer than ROBUST_EPSILON squared, else the whole.
__device__ __forceinline__ void cubic_start_tangent(const Cubic& P, float* tx, float* ty) {
  const float* p = P.p;
  const float d01x = p[2] - p[0], d01y = p[3] - p[1];
  const float d02x = p[4] - p[0], d02y = p[5] - p[1];
  const float d03x = p[6] - p[0], d03y = p[7] - p[1];
  const bool use01 = d01x * d01x + d01y * d01y > F(kRobustEpsilon);
  const bool use02 = d02x * d02x + d02y * d02y > F(kRobustEpsilon);
  *tx = use01 ? d01x : (use02 ? d02x : d03x);
  *ty = use01 ? d01y : (use02 ? d02y : d03y);
}

__device__ __forceinline__ void cubic_end_tangent(const Cubic& P, float* tx, float* ty) {
  const float* p = P.p;
  const float d23x = p[6] - p[4], d23y = p[7] - p[5];
  const float d13x = p[6] - p[2], d13y = p[7] - p[3];
  const float d03x = p[6] - p[0], d03y = p[7] - p[1];
  const bool use23 = d23x * d23x + d23y * d23y > F(kRobustEpsilon);
  const bool use13 = d13x * d13x + d13y * d13y > F(kRobustEpsilon);
  *tx = use23 ? d23x : (use13 ? d13x : d03x);
  *ty = use23 ? d23y : (use13 ? d13y : d03y);
}

__device__ __forceinline__ void eval_cubic_and_deriv(const Cubic& P, float t, float* px,
                                                     float* py, float* qx, float* qy) {
  const float m = 1.0f - t;
  const float mm = m * m, mt = m * t, tt = t * t;
  const float* p = P.p;
  *px = p[0] * (mm * m) + (p[2] * (3.0f * mm) + p[4] * (3.0f * mt) + p[6] * tt) * t;
  *py = p[1] * (mm * m) + (p[3] * (3.0f * mm) + p[5] * (3.0f * mt) + p[7] * tt) * t;
  *qx = (p[2] - p[0]) * mm + (p[4] - p[2]) * (2.0f * mt) + (p[6] - p[4]) * tt;
  *qy = (p[3] - p[1]) * mm + (p[5] - p[3]) * (2.0f * mt) + (p[7] - p[5]) * tt;
}

// pipeline/lockstep.py::pq_at: point and derivative at t, resampled
// DERIV_EPS earlier where the derivative nearly vanishes.
__device__ __forceinline__ PQ pq_at(const Cubic& P, float t) {
  PQ o;
  eval_cubic_and_deriv(P, t, &o.px, &o.py, &o.qx, &o.qy);
  o.t = t;
  const bool small = o.qx * o.qx + o.qy * o.qy < F(kDerivThresh * kDerivThresh);
  if (small) {
    const float ts = t == 0.0f ? F(kDerivEps) : t - F(kDerivEps);
    float px2, py2, qx2, qy2;
    eval_cubic_and_deriv(P, ts, &px2, &py2, &qx2, &qy2);
    o.qx = qx2;
    o.qy = qy2;
    if (t > 0.0f && t < 1.0f) {
      o.px = px2;
      o.py = py2;
      o.t = t - F(kDerivEps);
    }
  }
  return o;
}

struct Fit {
  float th0, th1, chord_len, err;
};

__device__ __forceinline__ Fit cubic_params_from_points_derivs(float p0x, float p0y, float p1x,
                                                               float p1y, float q0x, float q0y,
                                                               float q1x, float q1y, float dt) {
  const float chordx = p1x - p0x, chordy = p1y - p0y;
  const float chord_sq = chordx * chordx + chordy * chordy;
  const float chord_len = sqrtf(chord_sq);
  const bool degenerate = chord_sq < F(kTangentThresh * kTangentThresh);
  Fit o;
  if (degenerate) {
    const float q0_ls = q0x * q0x + q0y * q0y;
    const float q1_ls = q1x * q1x + q1y * q1y;
    o.th0 = 0.0f;
    o.th1 = 0.0f;
    o.chord_len = F(kTangentThresh);
    o.err = sqrtf(F(9.0 / 32.0) * (q0_ls + q1_ls)) * dt;
    return o;
  }
  const float scale = dt / chord_sq;
  const float h0x = q0x * chordx + q0y * chordy;
  const float h0y = q0y * chordx - q0x * chordy;
  const float th0 = pm::arctan2(h0y, h0x);
  const float d0 = sqrtf(h0x * h0x + h0y * h0y) * scale;
  const float h1x = q1x * chordx + q1y * chordy;
  const float h1y = q1x * chordy - q1y * chordx;
  const float th1 = pm::arctan2(h1y, h1x);
  const float d1 = sqrtf(h1x * h1x + h1y * h1y) * scale;

  const float cth0 = pm::cos(th0), cth1 = pm::cos(th1);
  const float e0 = F(2.0 / 3.0) / clamp_min(1.0f + cth0, F(1e-9));
  const float e1 = F(2.0 / 3.0) / clamp_min(1.0f + cth1, F(1e-9));
  const float s0 = pm::sin(th0), s1 = pm::sin(th1);
  const float s01 = cth0 * s1 + cth1 * s0;
  const float amin = F(0.15) * (2.0f * e0 * s0 + 2.0f * e1 * s1 - e0 * e1 * s01);
  const float a = F(0.15) * (2.0f * d0 * s0 + 2.0f * d1 * s1 - d0 * d1 * s01);
  const float aerr = fabsf(a - amin);
  const float symm = fabsf(th0 + th1);
  const float asymm = fabsf(th0 - th1);
  const float dist = sqrtf((d0 - e0) * (d0 - e0) + (d1 - e1) * (d1 - e1));
  // symm ** 5 is powf on the card (torch's pow with a scalar exponent).
  const float ctr = F(4.625e-6) * powf(symm, 5.0f) + F(7.5e-3) * asymm * (symm * symm);
  const float halo_symm = F(5e-3) * symm * dist;
  const float halo_asymm = F(7e-2) * asymm * dist;
  const float err_happy =
      cth0 * cth1 < 0.0f ? 2.0f : ctr + F(1.55) * aerr + halo_symm + halo_asymm;
  o.th0 = th0;
  o.th1 = th1;
  o.chord_len = chord_len;
  o.err = err_happy * chord_len;
  return o;
}

struct EulerParams {
  float k0, k1, ch;
};

__device__ __forceinline__ EulerParams euler_params_from_angles(float th0, float th1) {
  const float k0 = th0 + th1;
  const float dth = th1 - th0;
  const float d2 = dth * dth;
  const float k2 = k0 * k0;
  float a = 6.0f - d2 * F(1.0 / 70.0) - (d2 * d2) * F(1.0 / 10780.0) +
            (d2 * d2 * d2) * F(2.769178184818219e-07);
  float b = F(-0.1) + d2 * F(1.0 / 4200.0) + d2 * d2 * F(1.6959677820260655e-05);
  float c = F(-1.0 / 1400.0) + d2 * F(6.84915970574303e-05) - k2 * F(7.936475029053326e-06);
  a = a + (b + c * k2) * k2;
  EulerParams o;
  o.k0 = k0;
  o.k1 = dth * a;
  float ch = 1.0f - d2 * F(1.0 / 40.0) + (d2 * d2) * F(0.00034226190482569864) -
             (d2 * d2 * d2) * F(1.9349474568904524e-06);
  b = F(-1.0 / 24.0) + d2 * F(0.0024702380951963226) - d2 * d2 * F(3.7297408997537985e-05);
  c = F(1.0 / 1920.0) - d2 * F(4.87350869747975e-05) - k2 * F(3.1001936068463107e-06);
  o.ch = ch + (b + c * k2) * k2;
  return o;
}

constexpr double kSinScale = 1.0976991822760038;
constexpr double kInvSinScale = 0.9109963969605669;  // 1.0 / _SIN_SCALE
constexpr double kSqrt8Over3 = 0.9428090453147888;   // float32 sqrt(8) / 3
constexpr double kPi4 = 0.7853981633974483;          // math.pi / 4.0
constexpr double kCbrt98 = 1.040041911525952;        // math.cbrt(9 / 8)

__device__ __forceinline__ float espc_int_approx(float x) {
  const float y = fabsf(x);
  float a;
  if (y < F(0.8)) {
    a = pm::sin(F(kSinScale) * clamp_max(y, F(0.8))) * F(kInvSinScale);
  } else if (y < F(1.25)) {
    a = F(kSqrt8Over3) * (y - 1.0f) * sqrtf(fabsf(y - 1.0f)) + F(kPi4);
  } else {
    const bool lt = y < F(2.1);
    const float qa = lt ? F(0.6406) : F(0.5);
    const float qb = lt ? F(-0.81) : F(-0.156);
    const float qc = lt ? F(0.9148117935952064) : F(0.16145779359520596);
    a = qa * y * y + qb * y + qc;
  }
  return x >= 0.0f ? a : -a;
}

__device__ __forceinline__ float espc_int_inv_approx(float x) {
  const float y = fabsf(x);
  float a;
  if (y < F(0.7010707591262915)) {
    a = pm::arcsin(pm::clamp(x * F(kSinScale), -1.0f, 1.0f)) * F(kInvSinScale);
  } else if (y < F(0.903249293595206)) {
    const float b = y - F(kPi4);
    const float u = pm::sign(b) * powf(fabsf(b), F(2.0 / 3.0));
    a = u * F(kCbrt98) + 1.0f;
  } else {
    const bool lt = y < F(2.038857793595206);
    // b1 = 0.5 * _QUAD_B1 / _QUAD_A1, b2 likewise, folded in double.
    const float u3 = lt ? F(-1.0283527584268173) : F(-0.2985795871904119);
    const float v3 = lt ? F(1.5610365282547614) : F(2.0);
    const float w3 = lt ? F(-0.6322197939431784) : F(-0.156);
    a = sqrtf(clamp_min(u3 + v3 * y, 0.0f)) - w3;
  }
  return x >= 0.0f ? fabsf(a) : -fabsf(a);
}

struct Espc {
  float n, a, b, int0, integral, norm_off;
  int robust;
};

// espc_subdivision: the line count and the arclength map's parameters.
// Only the branch that `robust` selects is evaluated; the torch version
// evaluates all of them and selects, which gives the same values.
__device__ __forceinline__ Espc espc_subdivision(float k0_full, float k1, float ch,
                                                 float chord_len, float offset, float scale) {
  const float k0 = k0_full - 0.5f * k1;
  Espc o;
  o.norm_off = offset / chord_len;
  const float dist_scaled = o.norm_off * ch;
  const float scale_multiplier =
      F(0.35355339059327373) * sqrtf(scale * chord_len / (ch * kTol));  // 0.5 * (1 / sqrt 2)
  const bool low_k1 = fabsf(k1) < F(kK1Thresh);
  const bool low_dist = fabsf(dist_scaled) < F(kDistThresh);
  const float safe_k1 = fabsf(k1) < F(1e-12) ? F(1e-12) : k1;
  float n_frac;
  if (low_k1) {
    const float k = k0 + 0.5f * k1;
    n_frac = sqrtf(fabsf(k * (k * dist_scaled + 1.0f)));
    o.robust = kRobustLowK1;
  } else if (low_dist) {
    const float f_b = k0 * sqrtf(fabsf(k0));
    const float f_ab = (k1 + k0) * sqrtf(fabsf(k1 + k0));
    const float integral_ld = f_ab - f_b;
    n_frac = F(2.0 / 3.0) * integral_ld / safe_k1;
    o.robust = kRobustLowDist;
    o.int0 = f_b;
    o.integral = integral_ld;
  } else {
    const float a_n = -2.0f * dist_scaled * k1;
    const float b_n = -1.0f - 2.0f * dist_scaled * k0;
    const float int0_n = espc_int_approx(b_n);
    const float int1_n = espc_int_approx(a_n + b_n);
    const float integral_n = int1_n - int0_n;
    const float safe_a_n = fabsf(a_n) < F(1e-30) ? F(1e-30) : a_n;
    const float k_peak = k0 - k1 * b_n / safe_a_n;
    const float integrand_peak = sqrtf(fabsf(k_peak * (k_peak * dist_scaled + 1.0f)));
    n_frac = integral_n * integrand_peak / safe_a_n;
    o.robust = kRobustNormal;
    o.a = a_n;
    o.b = b_n;
    o.int0 = int0_n;
    o.integral = integral_n;
  }
  if (o.robust != kRobustNormal) {
    o.a = safe_k1;
    o.b = k0;
    if (o.robust == kRobustLowK1) {
      o.int0 = k0 * sqrtf(fabsf(k0));
      o.integral = (k1 + k0) * sqrtf(fabsf(k1 + k0)) - o.int0;
    }
  }
  o.n = pm::clamp(ceilf(n_frac * scale_multiplier), 1.0f, 100.0f);
  return o;
}

__device__ __forceinline__ float espc_s_of_t(float t, const Espc& e) {
  if (e.robust == kRobustLowK1) return t;
  const float arg = e.integral * t + e.int0;
  const float safe_a = fabsf(e.a) < F(1e-30) ? F(1e-30) : e.a;
  float inv;
  if (e.robust == kRobustLowDist) {
    const float c = pm::cbrt(arg);
    inv = c * fabsf(c);
  } else {
    inv = espc_int_inv_approx(arg);
  }
  return (inv - e.b) / safe_a;
}

__device__ __forceinline__ void integrate_euler10(float k0, float k1, float* u_out,
                                                  float* v_out) {
  const float t1_1 = k0;
  const float t1_2 = 0.5f * k1;
  const float t2_2 = t1_1 * t1_1;
  const float t2_3 = 2.0f * (t1_1 * t1_2);
  const float t2_4 = t1_2 * t1_2;
  const float t3_4 = t2_2 * t1_2 + t2_3 * t1_1;
  const float t3_6 = t2_4 * t1_2;
  const float t4_4 = t2_2 * t2_2;
  const float t4_5 = 2.0f * (t2_2 * t2_3);
  const float t4_6 = 2.0f * (t2_2 * t2_4) + t2_3 * t2_3;
  const float t4_7 = 2.0f * (t2_3 * t2_4);
  const float t4_8 = t2_4 * t2_4;
  const float t5_6 = t4_4 * t1_2 + t4_5 * t1_1;
  const float t5_8 = t4_6 * t1_2 + t4_7 * t1_1;
  const float t6_6 = t4_4 * t2_2;
  const float t6_7 = t4_4 * t2_3 + t4_5 * t2_2;
  const float t6_8 = t4_4 * t2_4 + t4_5 * t2_3 + t4_6 * t2_2;
  const float t7_8 = t6_6 * t1_2 + t6_7 * t1_1;
  const float t8_8 = t6_6 * t2_2;
  *u_out = 1.0f - (F(1.0 / 24.0) * t2_2 + F(1.0 / 160.0) * t2_4) +
           (F(1.0 / 1920.0) * t4_4 + F(1.0 / 10752.0) * t4_6 + F(1.0 / 55296.0) * t4_8) -
           (F(1.0 / 322560.0) * t6_6 + F(1.0 / 1658880.0) * t6_8) +
           F(1.0 / 92897280.0) * t8_8;
  *v_out = F(1.0 / 12.0) * t1_2 - (F(1.0 / 480.0) * t3_4 + F(1.0 / 2688.0) * t3_6) +
           (F(1.0 / 53760.0) * t5_6 + F(1.0 / 276480.0) * t5_8) -
           F(1.0 / 11612160.0) * t7_8;
}

__device__ __forceinline__ float euler_eval_th(float k0, float k1, float th0, float t) {
  return (k0 + 0.5f * k1 * (t - 1.0f)) * t - th0;
}

// euler_seg_eval_with_offset(p0, p1, k0, k1, ch, th0, t, normalized_offset)
__device__ __forceinline__ void euler_seg_eval_with_offset(float p0x, float p0y, float p1x,
                                                           float p1y, const EulerParams& e,
                                                           float th0, float t, float offset,
                                                           float* ox, float* oy) {
  const float chordx = p1x - p0x, chordy = p1y - p0y;
  const float th = euler_eval_th(e.k0, e.k1, th0, t);
  const float vx = offset * pm::sin(th);
  const float vy = offset * pm::cos(th);
  // euler_eval
  const float thm = euler_eval_th(e.k0, e.k1, th0, t * 0.5f);
  float u, v;
  integrate_euler10((e.k0 + e.k1 * (0.5f * t - 0.5f)) * t, e.k1 * t * t, &u, &v);
  const float s = t / e.ch * pm::sin(thm);
  const float c = t / e.ch * pm::cos(thm);
  const float x = (u * c - v * s) + vx;
  const float y = (-v * c - u * s) + vy;
  *ox = p0x + chordx * x - chordy * y;
  *oy = p0y + chordx * y + chordy * x;
}

// pipeline/flatten.py::euler_line_points: the end point of line i (of
// n) of the Euler segment over [t0, t1], recomputing the fit exactly as
// the walk did.
__device__ __forceinline__ void euler_line_point(const Cubic& P, float t0, float t1, float i,
                                                 float n, float offset, float scale,
                                                 float tend_x, float tend_y, float* lx,
                                                 float* ly) {
  if (i == n - 1.0f && t1 == 1.0f) {
    *lx = tend_x;
    *ly = tend_y;
    return;
  }
  const PQ a = pq_at(P, t0);
  const PQ b = pq_at(P, t1);
  const Fit f = cubic_params_from_points_derivs(a.px, a.py, b.px, b.py, a.qx, a.qy, b.qx, b.qy,
                                                t1 - t0);
  const EulerParams e = euler_params_from_angles(f.th0, f.th1);
  const Espc sd = espc_subdivision(e.k0, e.k1, e.ch, f.chord_len, offset, scale);
  const float t = (i + 1.0f) / clamp_min(n, 1.0f);
  const float s = espc_s_of_t(t, sd);
  euler_seg_eval_with_offset(a.px, a.py, b.px, b.py, e, f.th0, s, sd.norm_off, lx, ly);
}

}  // namespace fm
