// Paint evaluation shared by the fine kernels: kernel B (fine_v2.cu), the
// image tap F (image_tap.cu) and the per-tile interpreter G/H
// (fine_interp.cu). Each function evaluates one pixel of a 16x16 tile.
//
//   - the fill rule on a raw winding value, and the clip to [0, 1] that
//     takes its place on a row that arrives resolved (MSAA);
//   - the three gradient kinds of a 16-word record against the stop
//     table (jello_tpu/tpu/fine_v2.py:216-339, the same math as
//     fine_pallas.py:313-396), premultiplied, the radial validity mask
//     folded into all four channels;
//   - the bilinear image tap of an image record: sample position,
//     clamped atlas-absolute corners, the tile's corner extent that the
//     region-window contracts are stated on (from the tile's four corner
//     pixels), and the four-texel gather from the planar premultiplied
//     atlas.
//
// Rounding follows the reference op by op: rintf (half to even, as
// jnp.round), IEEE division and square root, no fast math; every file
// that includes this is built with -fmad=false.

#pragma once

#include <cuda_runtime.h>

namespace jello {

constexpr int kPixels = 256;

constexpr int CMD_COLOR = 1;
constexpr int CMD_LIN_GRAD = 2;
constexpr int CMD_RAD_GRAD = 3;
constexpr int CMD_SWEEP_GRAD = 4;
constexpr int CMD_IMAGE = 5;
constexpr int CMD_BEGIN_CLIP = 6;
constexpr int CMD_END_CLIP = 7;
constexpr int RAD_KIND_CIRCULAR = 1;
constexpr int RAD_KIND_STRIP = 2;
constexpr int RAD_KIND_FOCAL_ON_CIRCLE = 3;
constexpr int RAD_SWAPPED = 1;
// One image region window of the padded atlas.
constexpr int REGH = 64;
constexpr int REGW = 256;

__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__device__ __forceinline__ float clip_f(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// floor(a / b) for b > 0 (Python's //).
__device__ __forceinline__ int floordiv_i(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Coverage of a raw winding value under the even-odd or the nonzero rule.
__device__ __forceinline__ float fill_rule(float a, bool even_odd) {
  return even_odd ? fabsf(a - 2.0f * rintf(0.5f * a)) : fminf(fabsf(a), 1.0f);
}

// Coverage of a row that kernel A already resolved per sample (MSAA): the
// value as it is, no rule.
__device__ __forceinline__ float resolved_coverage(float a) {
  return clip_f(a, 0.0f, 1.0f);
}

__device__ __forceinline__ float extend_f(float t, int mode) {
  if (mode == 0) return clip_f(t, 0.0f, 1.0f);
  if (mode == 1) return t - floorf(t);
  return fabsf(t - 2.0f * rintf(0.5f * t));
}

__device__ __forceinline__ float eotf(float x) {
  const float hi = expf(2.4f * logf(fmaxf(x + 0.055f, 1e-6f) * (float)(1.0 / 1.055)));
  return x <= 0.04045f ? x * (float)(1.0 / 12.92) : hi;
}

// Gradient position t and validity mask for one pixel of a record.
__device__ __forceinline__ float gradient_t(int kind, const int* w, float gx, float gy,
                                            float* vmask) {
  const float* f = reinterpret_cast<const float*>(w);
  *vmask = 1.0f;
  float t;
  if (kind == CMD_LIN_GRAD) {
    t = f[6] * gx + f[7] * gy + f[8];
  } else {
    const float m0 = f[6], m1 = f[7], m2 = f[8], m3 = f[9];
    const float lx = m0 * gx + m2 * gy + f[10];
    const float ly = m1 * gx + m3 * gy + f[11];
    if (kind == CMD_RAD_GRAD) {
      const float focal_x = f[12];
      const float radius = f[13];
      const int rkind = w[14] & 0x7;
      const bool swapped = ((w[14] >> 3) & RAD_SWAPPED) != 0;
      const float r1r = rkind == RAD_KIND_CIRCULAR
                            ? 0.0f
                            : 1.0f / (radius == 0.0f ? 1.0f : radius);
      const float less_scale =
          (swapped || (1.0f - focal_x) < 0.0f) ? -1.0f : 1.0f;
      const float t_sign = sign_f(1.0f - focal_x);
      const float xx = lx * lx;
      const float yy = ly * ly;
      float tr;
      if (rkind == RAD_KIND_STRIP) {
        const float a_s = radius - yy;
        tr = sqrtf(fmaxf(a_s, 0.0f)) + lx;
        *vmask = a_s >= 0.0f ? 1.0f : 0.0f;
      } else if (rkind == RAD_KIND_FOCAL_ON_CIRCLE) {
        tr = (xx + yy) / (lx == 0.0f ? 1.0f : lx);
        *vmask = (tr >= 0.0f && lx != 0.0f) ? 1.0f : 0.0f;
      } else if (radius > 1.0f) {
        tr = sqrtf(xx + yy) - lx * r1r;
      } else {
        const float a_c = xx - yy;
        tr = less_scale * sqrtf(fmaxf(a_c, 0.0f)) - lx * r1r;
        *vmask = (a_c >= 0.0f && tr >= 0.0f) ? 1.0f : 0.0f;
      }
      t = focal_x + t_sign * tr;
    } else {  // sweep: atan polynomial (fine.wgsl:1035-1067)
      const float t0s = f[12], t1s = f[13];
      const float xabs = fabsf(lx), yabs = fabsf(ly);
      const float mx = fmaxf(xabs, yabs);
      const float slope = fminf(xabs, yabs) / (mx == 0.0f ? 1.0f : mx);
      const float s2 = slope * slope;
      float phi = slope * ((float)0.15912117063999176025390625 +
                           s2 * ((float)-5.185396969318389892578125e-2 +
                                 s2 * ((float)2.476101927459239959716796875e-2 +
                                       s2 * (float)-7.0547382347285747528076171875e-3)));
      phi = xabs < yabs ? 0.25f - phi : phi;
      phi = lx < 0.0f ? 0.5f - phi : phi;
      phi = ly < 0.0f ? 1.0f - phi : phi;
      phi = phi != phi ? 0.0f : phi;
      const float safe_dt = t1s == t0s ? 1.0f : t1s - t0s;
      t = (phi - t0s) / safe_dt;
    }
  }
  t = extend_f(t, w[5]);
  if (kind == CMD_RAD_GRAD && ((w[14] >> 3) & RAD_SWAPPED) != 0) t = 1.0f - t;
  return t;
}

// Premultiplied gradient color of one pixel of a gradient record. The
// record's stop-table row (word 15) may have any width: every thread of
// the CTA reads the same words, which the cache broadcasts. A ramp id out
// of range reads as a row of zeros.
__device__ __forceinline__ void gradient_fg(int kind, const int* w, float gx, float gy,
                                            const float* __restrict__ stops,
                                            int n_ramp_rows, int row_w, float fg[4]) {
  float vmask;
  const float t = gradient_t(kind, w, gx, gy, &vmask);
  const int S = (row_w - 1) / 5;
  const int ramp = w[15];
  const float* row =
      (ramp >= 0 && ramp < n_ramp_rows) ? stops + (size_t)ramp * row_w : nullptr;
  auto stop = [row](int j) { return row != nullptr ? __ldg(row + j) : 0.0f; };
  float acc[4];
  for (int ch = 0; ch < 4; ++ch) acc[ch] = stop(1 + S + ch);
  for (int k = 0; k < S - 1; ++k) {
    const float pk = stop(1 + k);
    const float dk = fmaxf(stop(2 + k) - pk, 1e-9f);
    const float u = clip_f((t - pk) / dk, 0.0f, 1.0f);
    for (int ch = 0; ch < 4; ++ch) {
      const float c0 = stop(1 + S + 4 * k + ch);
      const float c1 = stop(1 + S + 4 * (k + 1) + ch);
      acc[ch] = acc[ch] + (c1 - c0) * u;
    }
  }
  const float ga = acc[3] * vmask;
  fg[0] = eotf(acc[0]) * ga;
  fg[1] = eotf(acc[1]) * ga;
  fg[2] = eotf(acc[2]) * ga;
  fg[3] = ga;
}

// The bilinear tap of one pixel of an image record: atlas-absolute clamped
// corners (floor and ceil of the sample position, clamped to the image,
// offset by its atlas placement), the mix weights and the in-bounds mask.
struct Tap {
  int c0, c1, r0, r1;
  float fx, fy;
  bool inb;
};

__device__ __forceinline__ Tap image_tap_corners(const int* w, float gx, float gy) {
  const float* f = reinterpret_cast<const float*>(w);
  const float m0 = f[6], m1 = f[7], m2 = f[8], m3 = f[9];
  const float xl = f[10], yl = f[11];
  const unsigned axy = (unsigned)w[12];
  const int ax = (int)(axy & 0xFFFFu);
  const int ay = (int)(axy >> 16);
  const unsigned wh = (unsigned)w[13];
  const int iwi = (int)(wh >> 16);
  const int ihi = (int)(wh & 0xFFFFu);
  const float ux = m0 * gx + m2 * gy + xl;
  const float uy = m1 * gx + m3 * gy + yl;
  Tap t;
  t.inb = ux < (float)iwi && uy < (float)ihi && ux >= 0.0f && uy >= 0.0f;
  const float x0f = floorf(ux);
  const float y0f = floorf(uy);
  t.fx = ux - x0f;
  t.fy = uy - y0f;
  const int xmax = max(iwi - 1, 0);
  const int ymax = max(ihi - 1, 0);
  t.c0 = ax + clamp_i((int)x0f, 0, xmax);
  t.c1 = ax + clamp_i((int)ceilf(ux), 0, xmax);
  t.r0 = ay + clamp_i((int)y0f, 0, ymax);
  t.r1 = ay + clamp_i((int)ceilf(uy), 0, ymax);
  return t;
}

// The record's corner extent over the 16x16 tile whose first pixel is at
// (ox, oy): the least floor corner and the greatest ceil corner of all
// 256 pixels, from the tile's four corner pixels alone. Any thread can
// call it; no reduction and no barrier.
//
// Why four pixels give the same bits as all 256: a pixel's sample
// position is ux = m0 gx + m2 gy + xl (uy alike), three IEEE operations
// evaluated in that order with no contraction (-fmad=false). A correctly
// rounded operation is monotone in each operand, so m0 gx is monotone in
// gx (rising for m0 >= 0, falling for m0 < 0), and adding a fixed
// m2 gy, then xl, keeps that: ux is monotone in gx for a fixed gy, and
// in gy for a fixed gx, each in a direction fixed for the record. The
// pixel coordinates themselves, (p & 15) + ox, rise with the column and
// the row. floor, ceil, the conversion to int, the clamp to the image and
// + ax are monotone too. A function on the tile's grid that is monotone
// in each coordinate takes its least and greatest values at corners, so
// the four corner pixels hold the extent that kernel F and the
// interpreter test against their region windows.
__device__ __forceinline__ void image_tap_corner_extent(const int* w, int ox, int oy, int* rx0,
                                                        int* ry0, int* rx1, int* ry1) {
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Tap t = image_tap_corners(w, (float)((k & 1) * 15) + (float)ox,
                                    (float)((k >> 1) * 15) + (float)oy);
    x0 = k == 0 ? t.c0 : min(x0, t.c0);
    y0 = k == 0 ? t.r0 : min(y0, t.r0);
    x1 = k == 0 ? t.c1 : max(x1, t.c1);
    y1 = k == 0 ? t.r1 : max(y1, t.r1);
  }
  *rx0 = x0;
  *ry0 = y0;
  *rx1 = x1;
  *ry1 = y1;
}

// Origin of the region window that holds the extent's low corner.
__device__ __forceinline__ void image_region_origin(int rx0, int ry0, int AHp, int AWp,
                                                    int* x_lo, int* y_lo) {
  *x_lo = clamp_i(floordiv_i(rx0, 128) * 128, 0, AWp - REGW);
  *y_lo = clamp_i(floordiv_i(ry0, 8) * 8, 0, AHp - REGH);
}

// The four premultiplied texels of each channel from the planar atlas
// (small, it stays in L2), mixed x first, then y, with the weights
// (1 - f) and f. When floor and ceil name the same texel the two weighted
// terms add, t (1 - f) + t f, as the TPU kernel's two one-hots do. A live
// record's corners lie inside its image, which the packer placed inside
// the atlas; the clamp only keeps a malformed record's reads in bounds.
__device__ __forceinline__ void image_tap_gather(const float* __restrict__ atlas, int AHp,
                                                 int AWp, const Tap& t, float fg[4]) {
  const int rr0 = clamp_i(t.r0, 0, AHp - 1), rr1 = clamp_i(t.r1, 0, AHp - 1);
  const int cc0 = clamp_i(t.c0, 0, AWp - 1), cc1 = clamp_i(t.c1, 0, AWp - 1);
  const size_t plane = (size_t)AHp * AWp;
  const size_t i00 = (size_t)rr0 * AWp + cc0, i01 = (size_t)rr0 * AWp + cc1;
  const size_t i10 = (size_t)rr1 * AWp + cc0, i11 = (size_t)rr1 * AWp + cc1;
  const float wx0 = 1.0f - t.fx, wy0 = 1.0f - t.fy;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const float* a = atlas + ch * plane;
    const float top = __ldg(a + i00) * wx0 + __ldg(a + i01) * t.fx;
    const float bot = __ldg(a + i10) * wx0 + __ldg(a + i11) * t.fx;
    fg[ch] = top * wy0 + bot * t.fy;
  }
}

}  // namespace jello
