// Kernel B: record-stream fine compositing.
//
// Replaces the Pallas kernel jello_tpu/tpu/fine_v2.py
// (make_fine_v2_kernel, pallas_call at :564; wrapper fine_v2). The TPU
// kernel composes 128-record chunks as two log2(C)-step segmented affine
// scans (clip groups, then tiles) with scalar-prefetched run gates and
// carries across chunks, because a TPU pays per scalar-dispatched step.
// On Hopper a tile is a CTA that walks its own run of records in
// painter's order.
//
// One CTA of 256 threads per tile, one thread per pixel. The CTA starts
// from the premultiplied base color and, for each record of the tile's
// contiguous run [tile_start, tile_end) of the tile-sorted stream:
//   - reads the record's coverage row and applies the fill rule on raw
//     winding (even-odd |a - 2 rint(a/2)|, nonzero min(|a|, 1); a
//     rowless record covers fully); with `resolved` set (an MSAA frame)
//     the row is kernel A's resolved coverage and is only clipped to
//     [0, 1], whatever the record's rule (fine_v2.py:182-183);
//   - evaluates the paint (paint.cuh): solid premultiplied color, or a
//     linear, radial (strip / focal / cone, swapped post-flip) or sweep
//     gradient from the stop table, with the sRGB EOTF as
//     exp(2.4 log(...)); or an image paint, whose premultiplied
//     foreground is the record's row of the image-tap table (kernel F,
//     image_tap.cu; row = record word 14, the image rank in stream
//     order; the in-bounds mask is already folded into the row);
//   - composites v = v (1 - fa cov) + fg cov;
//   - writes the un-premultiplied inclusive composite at the record's
//     own index.
// A record flagged legacy-tile (flag bit 1) is the identity, as in the
// TPU kernel: the interpreter (fine_interp.cu) renders that tile. Without
// an fg table (a frame with no image atlas) an image record is the
// identity too.
//
// Clip groups (the TPU kernel's pass 1, fine_v2.py:192-214,401-460). On a
// tile that is not legacy a clip group has depth 1 and a src-over blend,
// so the group is itself an affine map of the background. Beside v the
// CTA keeps the open group's composite (A_g, B_g) over transparent
// black: a BeginClip (flag bit 4, kind 6) opens it at the identity, each
// member (bit 4) composes its own map into it and leaves v alone, and
// the EndClip (bit 5) applies
//     v = (1 - covc (1 - A_g)) v + covc B_g,
// covc = min(|clip row|, 1) alpha (the nonzero rule, the row the EndClip
// shares with its BeginClip; the clipped row itself when `resolved`,
// fine_v2.py:204-205), or for a rowless EndClip in either mode
// min(|backdrop word 7|, 1) alpha: 0 for a group that covers nothing,
// alpha for one that covers the tile. A record that leaves v alone still
// writes the running composite at its own index. The group ids in flag
// bits 8+ are not read: within one tile's run a group is the records
// from its BeginClip to its EndClip.
//
// What bounds it on an H100: every record reads a 1 KB coverage row and
// writes its 4 KB composite, so it is bound by device memory bandwidth
// (5 KB per record; an image record reads 4 KB more); gradient records
// add ~100 flops per pixel. Rounding
// follows the reference: rintf (half to even, as jnp.round), IEEE
// division, no fast math, built with -fmad=false.

#include <cuda_runtime.h>

#include "paint.cuh"

namespace {

using namespace jello;

__global__ void __launch_bounds__(kPixels)
fine_v2_kernel(const int* __restrict__ rec, const float* __restrict__ cov,
               const float* __restrict__ stops,
               const int* __restrict__ tile_start,
               const int* __restrict__ tile_end,
               const float* __restrict__ base,
               const float* __restrict__ fg_tab, float* __restrict__ out,
               int n_ramp_rows, int row_w, int wit, int n_fg_rows, int resolved) {
  __shared__ int w[16];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[tile];
  const int end = tile_end[tile];
  if (start >= end) return;

  const float gx = (float)((tile % wit) * 16) + (float)(p & 15);
  const float gy = (float)((tile / wit) * 16) + (float)(p >> 4);
  float v0 = base[0], v1 = base[1], v2 = base[2], v3 = base[3];
  // The open clip group's composite over transparent black.
  float Ag = 1.0f, Bg[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int i = start; i < end; ++i) {
    const int* r = rec + (size_t)i * 16;
    __syncthreads();
    if (p < 16) w[p] = r[p];
    __syncthreads();

    const int kind = w[0];
    const int flags = w[4];
    const float* f = reinterpret_cast<const float*>(w);
    const bool is_color = kind == CMD_COLOR;
    const bool is_grad = kind == CMD_LIN_GRAD || kind == CMD_RAD_GRAD ||
                         kind == CMD_SWEEP_GRAD;
    const bool is_img = kind == CMD_IMAGE && fg_tab != nullptr;
    const bool live = (is_color || is_grad || is_img) && (flags & 2) == 0;
    const bool member = (flags & 16) != 0;
    const bool end_group = (flags & 32) != 0;

    // The record's own map (A, B): the identity unless it paints.
    float A = 1.0f, B[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      const float a = cov[(size_t)i * kPixels + p];
      // A seg-less fill has no row: the tile is fully inside.
      const float c = w[1] < 0 ? 1.0f
                      : resolved ? resolved_coverage(a)
                                 : fill_rule(a, (flags & 1) != 0);
      float fg[4];
      if (is_color) {
        fg[0] = f[5]; fg[1] = f[6]; fg[2] = f[7]; fg[3] = f[8];
      } else if (is_img) {
        // A rank past the table (img_recs_overflow, the frame is
        // retried) paints nothing.
        const int rank = w[14];
        if (rank >= 0 && rank < n_fg_rows) {
          const float* row = fg_tab + (size_t)rank * 4 * kPixels + p;
          fg[0] = row[0];
          fg[1] = row[kPixels];
          fg[2] = row[2 * kPixels];
          fg[3] = row[3 * kPixels];
        } else {
          fg[0] = fg[1] = fg[2] = fg[3] = 0.0f;
        }
      } else {
        gradient_fg(kind, w, gx, gy, stops, n_ramp_rows, row_w, fg);
      }
      A = 1.0f - fg[3] * c;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) B[ch] = fg[ch] * c;
    }

    if (member) {
      if (kind == CMD_BEGIN_CLIP) {
        Ag = 1.0f;
        Bg[0] = Bg[1] = Bg[2] = Bg[3] = 0.0f;
      }
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) Bg[ch] = B[ch] + A * Bg[ch];
      Ag = A * Ag;
      A = 1.0f;
      B[0] = B[1] = B[2] = B[3] = 0.0f;
    } else if (end_group) {
      float covc_base = fminf(fabsf((float)w[7]), 1.0f);
      if (w[1] >= 0) {
        const float a = cov[(size_t)i * kPixels + p];
        covc_base = resolved ? resolved_coverage(a) : fill_rule(a, false);
      }
      const float covc = covc_base * f[6];
      A = 1.0f - covc * (1.0f - Ag);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) B[ch] = covc * Bg[ch];
    }
    if (live || end_group) {
      v0 = B[0] + A * v0;
      v1 = B[1] + A * v1;
      v2 = B[2] + A * v2;
      v3 = B[3] + A * v3;
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
                             int n_fg_rows, int resolved, void* stream) {
  if (n_tiles > 0) {
    fine_v2_kernel<<<n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const int*)rec, (const float*)cov, (const float*)stops,
        (const int*)tile_start, (const int*)tile_end, (const float*)base,
        (const float*)fg_tab, (float*)out, n_ramp_rows, row_w, wit, n_fg_rows, resolved);
  }
  return (int)cudaGetLastError();
}
