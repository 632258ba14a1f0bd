// Mix/compose blending for the per-tile interpreter (fine_interp.cu).
//
// The device copy of jello_tpu_torch/blend_math.py (jello_tpu's
// blend_math.py, reference shared/blend.wgsl). The Python selects among
// all modes with where chains; the blend word is uniform over a CTA, so
// here a switch runs the one selected branch, with that branch's
// arithmetic op for op (EPSILON 1e-15, the 1e-30 denominators of
// _clip_color and _set_sat, _set_sat's tie rules). Colors are
// premultiplied RGBA at the blend_mix_compose boundary.

#pragma once

#include <cuda_runtime.h>

namespace jello {

constexpr int MIX_MULTIPLY = 1;
constexpr int MIX_SCREEN = 2;
constexpr int MIX_OVERLAY = 3;
constexpr int MIX_DARKEN = 4;
constexpr int MIX_LIGHTEN = 5;
constexpr int MIX_COLOR_DODGE = 6;
constexpr int MIX_COLOR_BURN = 7;
constexpr int MIX_HARD_LIGHT = 8;
constexpr int MIX_SOFT_LIGHT = 9;
constexpr int MIX_DIFFERENCE = 10;
constexpr int MIX_EXCLUSION = 11;
constexpr int MIX_HUE = 12;
constexpr int MIX_SATURATION = 13;
constexpr int MIX_COLOR = 14;
constexpr int MIX_LUMINOSITY = 15;

constexpr int COMPOSE_SRC_OVER = 0;
constexpr int COMPOSE_COPY = 1;
constexpr int COMPOSE_DEST = 2;
constexpr int COMPOSE_DEST_OVER = 4;
constexpr int COMPOSE_SRC_IN = 5;
constexpr int COMPOSE_DEST_IN = 6;
constexpr int COMPOSE_SRC_OUT = 7;
constexpr int COMPOSE_DEST_OUT = 8;
constexpr int COMPOSE_SRC_ATOP = 9;
constexpr int COMPOSE_DEST_ATOP = 10;
constexpr int COMPOSE_XOR = 11;
constexpr int COMPOSE_PLUS = 12;
constexpr int COMPOSE_PLUS_LIGHTER = 13;

constexpr float BLEND_EPSILON = 1e-15f;

__device__ __forceinline__ float min3_f(float r, float g, float b) {
  return fminf(r, fminf(g, b));
}

__device__ __forceinline__ float max3_f(float r, float g, float b) {
  return fmaxf(r, fmaxf(g, b));
}

__device__ __forceinline__ float screen_f(float cb, float cs) { return cb + cs - cb * cs; }

__device__ __forceinline__ float color_dodge_f(float cb, float cs) {
  float r = fminf(1.0f, cb / fmaxf(1.0f - cs, 1e-30f));
  r = cs == 1.0f ? 1.0f : r;
  return cb == 0.0f ? 0.0f : r;
}

__device__ __forceinline__ float color_burn_f(float cb, float cs) {
  float r = 1.0f - fminf(1.0f, (1.0f - cb) / fmaxf(cs, 1e-30f));
  r = cs == 0.0f ? 0.0f : r;
  return cb == 1.0f ? 1.0f : r;
}

__device__ __forceinline__ float hard_light_f(float cb, float cs) {
  return cs <= 0.5f ? cb * 2.0f * cs : screen_f(cb, 2.0f * cs - 1.0f);
}

__device__ __forceinline__ float soft_light_f(float cb, float cs) {
  const float d = cb <= 0.25f ? ((16.0f * cb - 12.0f) * cb + 4.0f) * cb
                              : sqrtf(fmaxf(cb, 0.0f));
  return cs <= 0.5f ? cb - (1.0f - 2.0f * cs) * cb * (1.0f - cb)
                    : cb + (2.0f * cs - 1.0f) * (d - cb);
}

__device__ __forceinline__ float lum3_f(float r, float g, float b) {
  return 0.3f * r + 0.59f * g + 0.11f * b;
}

__device__ __forceinline__ void clip_color_f(float c[3]) {
  const float l = lum3_f(c[0], c[1], c[2]);
  const float n = min3_f(c[0], c[1], c[2]);
  float x = max3_f(c[0], c[1], c[2]);
  if (n < 0.0f) {
    const float denom = (l - n) == 0.0f ? 1e-30f : l - n;
    for (int k = 0; k < 3; ++k) c[k] = l + ((c[k] - l) * l) / denom;
    x = max3_f(c[0], c[1], c[2]);
  }
  if (x > 1.0f) {
    const float denom = (x - l) == 0.0f ? 1e-30f : x - l;
    for (int k = 0; k < 3; ++k) c[k] = l + ((c[k] - l) * (1.0f - l)) / denom;
  }
}

__device__ __forceinline__ void set_lum_f(float c[3], float l) {
  const float d = l - lum3_f(c[0], c[1], c[2]);
  for (int k = 0; k < 3; ++k) c[k] = c[k] + d;
  clip_color_f(c);
}

// Scale the channels so that max - min == s, keeping their order. A
// channel equal to the minimum maps to 0 before one equal to the maximum
// maps to s; all equal gives zeros.
__device__ __forceinline__ void set_sat_f(float c[3], float s) {
  const float cmax = max3_f(c[0], c[1], c[2]);
  const float cmin = min3_f(c[0], c[1], c[2]);
  const float cmid = c[0] + c[1] + c[2] - cmax - cmin;
  const float rng = cmax - cmin;
  const float denom = rng == 0.0f ? 1e-30f : rng;
  const float new_mid = rng > 0.0f ? ((cmid - cmin) * s) / denom : 0.0f;
  const float new_max = rng > 0.0f ? s : 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float v = c[k] == cmin ? 0.0f : (c[k] == cmax ? new_max : new_mid);
    c[k] = rng == 0.0f ? 0.0f : v;
  }
}

// Mix two separated RGB colors; a mix id outside the table is NORMAL.
__device__ __forceinline__ void blend_mix_f(const float cb[3], const float cs[3], int mode,
                                            float out[3]) {
  switch (mode) {
    case MIX_MULTIPLY:
      for (int k = 0; k < 3; ++k) out[k] = cb[k] * cs[k];
      return;
    case MIX_SCREEN:
      for (int k = 0; k < 3; ++k) out[k] = screen_f(cb[k], cs[k]);
      return;
    case MIX_OVERLAY:
      for (int k = 0; k < 3; ++k) out[k] = hard_light_f(cs[k], cb[k]);
      return;
    case MIX_DARKEN:
      for (int k = 0; k < 3; ++k) out[k] = fminf(cb[k], cs[k]);
      return;
    case MIX_LIGHTEN:
      for (int k = 0; k < 3; ++k) out[k] = fmaxf(cb[k], cs[k]);
      return;
    case MIX_COLOR_DODGE:
      for (int k = 0; k < 3; ++k) out[k] = color_dodge_f(cb[k], cs[k]);
      return;
    case MIX_COLOR_BURN:
      for (int k = 0; k < 3; ++k) out[k] = color_burn_f(cb[k], cs[k]);
      return;
    case MIX_HARD_LIGHT:
      for (int k = 0; k < 3; ++k) out[k] = hard_light_f(cb[k], cs[k]);
      return;
    case MIX_SOFT_LIGHT:
      for (int k = 0; k < 3; ++k) out[k] = soft_light_f(cb[k], cs[k]);
      return;
    case MIX_DIFFERENCE:
      for (int k = 0; k < 3; ++k) out[k] = fabsf(cb[k] - cs[k]);
      return;
    case MIX_EXCLUSION:
      for (int k = 0; k < 3; ++k) out[k] = cb[k] + cs[k] - 2.0f * cb[k] * cs[k];
      return;
    case MIX_HUE: {
      const float sat_cb = max3_f(cb[0], cb[1], cb[2]) - min3_f(cb[0], cb[1], cb[2]);
      for (int k = 0; k < 3; ++k) out[k] = cs[k];
      set_sat_f(out, sat_cb);
      set_lum_f(out, lum3_f(cb[0], cb[1], cb[2]));
      return;
    }
    case MIX_SATURATION: {
      const float sat_cs = max3_f(cs[0], cs[1], cs[2]) - min3_f(cs[0], cs[1], cs[2]);
      for (int k = 0; k < 3; ++k) out[k] = cb[k];
      set_sat_f(out, sat_cs);
      set_lum_f(out, lum3_f(cb[0], cb[1], cb[2]));
      return;
    }
    case MIX_COLOR:
      for (int k = 0; k < 3; ++k) out[k] = cs[k];
      set_lum_f(out, lum3_f(cb[0], cb[1], cb[2]));
      return;
    case MIX_LUMINOSITY:
      for (int k = 0; k < 3; ++k) out[k] = cb[k];
      set_lum_f(out, lum3_f(cs[0], cs[1], cs[2]));
      return;
    default:
      for (int k = 0; k < 3; ++k) out[k] = cs[k];
  }
}

// Porter-Duff composition of separated colors; the result is
// premultiplied. A mode outside the table (CLEAR included) has zero
// factors.
__device__ __forceinline__ void blend_compose_f(const float cb[3], const float cs[3],
                                                float ab, float as, int mode, float out[4]) {
  if (mode == COMPOSE_PLUS_LIGHTER) {
    for (int k = 0; k < 3; ++k) out[k] = fminf(1.0f, as * cs[k] + ab * cb[k]);
    out[3] = fminf(1.0f, as + ab);
    return;
  }
  float fa = 0.0f, fb = 0.0f;
  switch (mode) {
    case COMPOSE_COPY: fa = 1.0f; fb = 0.0f; break;
    case COMPOSE_DEST: fa = 0.0f; fb = 1.0f; break;
    case COMPOSE_SRC_OVER: fa = 1.0f; fb = 1.0f - as; break;
    case COMPOSE_DEST_OVER: fa = 1.0f - ab; fb = 1.0f; break;
    case COMPOSE_SRC_IN: fa = ab; fb = 0.0f; break;
    case COMPOSE_DEST_IN: fa = 0.0f; fb = as; break;
    case COMPOSE_SRC_OUT: fa = 1.0f - ab; fb = 0.0f; break;
    case COMPOSE_DEST_OUT: fa = 0.0f; fb = 1.0f - as; break;
    case COMPOSE_SRC_ATOP: fa = ab; fb = 1.0f - as; break;
    case COMPOSE_DEST_ATOP: fa = 1.0f - ab; fb = as; break;
    case COMPOSE_XOR: fa = 1.0f - ab; fb = 1.0f - as; break;
    case COMPOSE_PLUS: fa = 1.0f; fb = 1.0f; break;
    default: break;
  }
  const float as_fa = as * fa;
  const float ab_fb = ab * fb;
  for (int k = 0; k < 3; ++k) out[k] = as_fa * cs[k] + ab_fb * cb[k];
  out[3] = fminf(as_fa + ab_fb, 1.0f);
}

// Mix and compose premultiplied RGBA under the packed word
// mode = (mix << 8) | compose. Mix NORMAL or CLIP with SRC_OVER
// (word & 0x7FFF == 0) is plain src-over.
__device__ __forceinline__ void blend_mix_compose_f(const float bg[4], const float src[4],
                                                    int mode, float out[4]) {
  const float sa = src[3];
  const float ba = bg[3];
  if ((mode & 0x7FFF) == 0) {
    for (int k = 0; k < 4; ++k) out[k] = bg[k] * (1.0f - sa) + src[k];
    return;
  }
  const float inv_sa = 1.0f / fmaxf(sa, BLEND_EPSILON);
  const float inv_ba = 1.0f / fmaxf(ba, BLEND_EPSILON);
  float cs[3], cb[3], mixed[3];
  for (int k = 0; k < 3; ++k) {
    cs[k] = src[k] * inv_sa;
    cb[k] = bg[k] * inv_ba;
  }
  blend_mix_f(cb, cs, (mode >> 8) & 0xFFFFFF, mixed);
  for (int k = 0; k < 3; ++k) cs[k] = cs[k] + (mixed[k] - cs[k]) * ba;
  const int compose = mode & 0xFF;
  if (compose == COMPOSE_SRC_OVER) {
    // The premultiplied backdrop toward the mixed separated source by the
    // source alpha (blend.wgsl:304-306).
    for (int k = 0; k < 3; ++k) out[k] = bg[k] + (cs[k] - bg[k]) * sa;
    out[3] = sa + ba * (1.0f - sa);
    return;
  }
  blend_compose_f(cb, cs, ba, sa, compose, out);
}

}  // namespace jello
