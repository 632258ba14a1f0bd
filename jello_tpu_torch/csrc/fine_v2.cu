// Kernel B: record-stream fine compositing (standalone, clip-free).
//
// Replaces the Pallas kernel jello_tpu/tpu/fine_v2.py
// (make_fine_v2_kernel, pallas_call at :564; wrapper fine_v2). The TPU
// kernel composes 128-record chunks as a log2(C)-step segmented affine
// scan with scalar-prefetched run gates and carries across chunks,
// because a TPU pays per scalar-dispatched step. On Hopper a tile is a
// CTA that walks its own run of records in painter's order.
//
// One CTA of 256 threads per tile, one thread per pixel. The CTA starts
// from the premultiplied base color and, for each record of the tile's
// contiguous run [tile_start, tile_end) of the tile-sorted stream:
//   - reads the record's coverage row and applies the fill rule on raw
//     winding (even-odd |a - 2 rint(a/2)|, nonzero min(|a|, 1); a
//     rowless record covers fully);
//   - evaluates the paint: solid premultiplied color, or a linear,
//     radial (strip / focal / cone, swapped post-flip) or sweep
//     gradient from the stop table (fine_v2.py:216-339), with the sRGB
//     EOTF as exp(2.4 log(...)); or an image paint, whose premultiplied
//     foreground is the record's row of the image-tap table (kernel F,
//     image_tap.cu; row = record word 14, the image rank in stream
//     order; the in-bounds mask is already folded into the row);
//   - composites v = v (1 - fa cov) + fg cov;
//   - writes the un-premultiplied inclusive composite at the record's
//     own index.
// A record flagged legacy-tile (flag bit 1) is the identity, as in the
// TPU kernel. Without an fg table (a frame with no image atlas) an image
// record is the identity too. The pass-1 clip-group composition (flag
// bits 4/5) is not on the clip-free path.
//
// What bounds it on an H100: every record reads a 1 KB coverage row and
// writes its 4 KB composite, so it is bound by device memory bandwidth
// (5 KB per record; an image record reads 4 KB more); gradient records
// add ~100 flops per pixel. Rounding
// follows the reference: rintf (half to even, as jnp.round), IEEE
// division, no fast math, built with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kPixels = 256;

constexpr int CMD_COLOR = 1;
constexpr int CMD_LIN_GRAD = 2;
constexpr int CMD_RAD_GRAD = 3;
constexpr int CMD_SWEEP_GRAD = 4;
constexpr int CMD_IMAGE = 5;
constexpr int RAD_KIND_CIRCULAR = 1;
constexpr int RAD_KIND_STRIP = 2;
constexpr int RAD_KIND_FOCAL_ON_CIRCLE = 3;
constexpr int RAD_SWAPPED = 1;

__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__device__ __forceinline__ float clip_f(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
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
__device__ float gradient_t(int kind, const int* w, float gx, float gy, float* vmask) {
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

__global__ void __launch_bounds__(kPixels)
fine_v2_kernel(const int* __restrict__ rec, const float* __restrict__ cov,
               const float* __restrict__ stops,
               const int* __restrict__ tile_start,
               const int* __restrict__ tile_end,
               const float* __restrict__ base,
               const float* __restrict__ fg_tab, float* __restrict__ out,
               int n_ramp_rows, int row_w, int wit, int n_fg_rows) {
  __shared__ int w[16];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[tile];
  const int end = tile_end[tile];
  if (start >= end) return;

  const int S = (row_w - 1) / 5;
  const float gx = (float)((tile % wit) * 16) + (float)(p & 15);
  const float gy = (float)((tile / wit) * 16) + (float)(p >> 4);
  float v0 = base[0], v1 = base[1], v2 = base[2], v3 = base[3];

  for (int i = start; i < end; ++i) {
    const int* r = rec + (size_t)i * 16;
    __syncthreads();
    if (p < 16) w[p] = r[p];
    __syncthreads();

    const int kind = w[0];
    const int flags = w[4];
    const bool is_color = kind == CMD_COLOR;
    const bool is_grad = kind == CMD_LIN_GRAD || kind == CMD_RAD_GRAD ||
                         kind == CMD_SWEEP_GRAD;
    const bool is_img = kind == CMD_IMAGE && fg_tab != nullptr;
    const bool live = (is_color || is_grad || is_img) && (flags & 2) == 0;

    if (live) {
      const float a = cov[(size_t)i * kPixels + p];
      float c;
      if (w[1] < 0) {
        c = 1.0f;  // seg-less fill: the tile is fully inside
      } else if ((flags & 1) != 0) {
        c = fabsf(a - 2.0f * rintf(0.5f * a));
      } else {
        c = fminf(fabsf(a), 1.0f);
      }
      float fg0, fg1, fg2, fg3;
      if (is_color) {
        const float* f = reinterpret_cast<const float*>(w);
        fg0 = f[5]; fg1 = f[6]; fg2 = f[7]; fg3 = f[8];
      } else if (is_img) {
        // A rank past the table (img_recs_overflow, the frame is
        // retried) paints nothing.
        const int rank = w[14];
        if (rank >= 0 && rank < n_fg_rows) {
          const float* row = fg_tab + (size_t)rank * 4 * kPixels + p;
          fg0 = row[0];
          fg1 = row[kPixels];
          fg2 = row[2 * kPixels];
          fg3 = row[3 * kPixels];
        } else {
          fg0 = fg1 = fg2 = fg3 = 0.0f;
        }
      } else {
        float vmask;
        const float t = gradient_t(kind, w, gx, gy, &vmask);
        // The record's stop-table row, of any width: every thread of the
        // CTA reads the same words, which the cache broadcasts. A ramp
        // id out of range reads as a row of zeros.
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
        fg0 = eotf(acc[0]) * ga;
        fg1 = eotf(acc[1]) * ga;
        fg2 = eotf(acc[2]) * ga;
        fg3 = ga;
      }
      const float A = 1.0f - fg3 * c;
      v0 = fg0 * c + A * v0;
      v1 = fg1 * c + A * v1;
      v2 = fg2 * c + A * v2;
      v3 = fg3 * c + A * v3;
    }
    const float inv_a = 1.0f / fmaxf(v3, 1e-6f);
    float* o = out + (size_t)i * 4 * kPixels + p;
    o[0] = v0 * inv_a;
    o[kPixels] = v1 * inv_a;
    o[2 * kPixels] = v2 * inv_a;
    o[3 * kPixels] = v3;
  }
}

}  // namespace

extern "C" int jello_fine_v2(const void* rec, const void* cov, const void* stops,
                             const void* tile_start, const void* tile_end,
                             const void* base, const void* fg_tab, void* out,
                             int n_tiles, int n_ramp_rows, int row_w, int wit,
                             int n_fg_rows, void* stream) {
  if (n_tiles > 0) {
    fine_v2_kernel<<<n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const int*)rec, (const float*)cov, (const float*)stops,
        (const int*)tile_start, (const int*)tile_end, (const float*)base,
        (const float*)fg_tab, (float*)out, n_ramp_rows, row_w, wit, n_fg_rows);
  }
  return (int)cudaGetLastError();
}
