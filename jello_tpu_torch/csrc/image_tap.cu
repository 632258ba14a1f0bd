// Kernel F: bilinear premultiplied atlas taps for image paint records.
//
// Replaces the Pallas kernel jello_tpu/tpu/image_tap.py
// (make_image_tap_kernel, pallas_call at :248; wrapper image_tap). The
// TPU kernel cannot gather: it DMAs a 64x256 atlas window per record
// into VMEM, does the x-mix as a one-hot (64,256)x(256,256) MXU product
// and the y-mix as a weighted row reduce, double-buffers the windows
// across records and sweeps up to MAX_WIN sub-windows for minified
// images. Hopper gathers, so none of that is carried over.
//
// One CTA of 256 threads per compacted image record, one thread per
// pixel of the record's 16x16 tile. A thread
//   - maps its pixel through the record's inverse transform (words
//     6..11) to the sample position (ux, uy);
//   - takes floor and ceil, clamps both to the image, and offsets them
//     by the image's atlas placement (word 12, ay << 16 | ax);
//   - reads the four premultiplied texels of each channel from the
//     planar atlas in global memory (the atlas is small and stays in
//     L2);
//   - mixes x first, then y, with the weights (1 - f) and f. When floor
//     and ceil name the same texel the two weighted terms add,
//     t (1 - f) + t f, as the TPU kernel's two one-hots do: no special
//     case;
//   - multiplies by the in-bounds mask and writes out[rec][256 ch + p],
//     coalesced. Rows that are not image records (the zero rows past
//     the image count) write zeros.
//
// Contract kept from the TPU kernel although no window exists here: a
// record whose clamped corners span more than MAX_WIN 64x256 windows of
// the padded atlas (the wrapper-side _region_offsets of the reference)
// writes zeros and raises the region-overflow flag, so that both
// implementations reroute the same frames. The record's min/max corner
// is a block reduction in the CTA.
//
// What bounds it on an H100: each record writes 4 KB and reads 64 bytes
// of record plus at most 16 texels per pixel that hit L2, so it is
// bound by the bytes written to device memory. Built with -fmad=false:
// ux = m0 gx + m2 gy + xl must round as the reference's separate
// multiplies and adds do, or a texel index flips at a boundary.

#include <cuda_runtime.h>

namespace {

constexpr int kPixels = 256;
constexpr int CMD_IMAGE = 5;
constexpr int REGH = 64;
constexpr int REGW = 256;
constexpr int MAX_WIN = 12;

__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// floor(a / b) for b > 0 (Python's //).
__device__ __forceinline__ int floordiv_i(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(kPixels)
image_tap_kernel(const int* __restrict__ rec, const float* __restrict__ atlas,
                 float* __restrict__ out, int* __restrict__ region_flag,
                 int grid, int wit, int AHp, int AWp) {
  __shared__ int w[16];
  __shared__ int red[4][kPixels / 32];
  const int i = blockIdx.x;
  const int p = threadIdx.x;
  if (p < 16) w[p] = rec[(size_t)i * 16 + p];
  __syncthreads();

  const float* f = reinterpret_cast<const float*>(w);
  const int t = w[3];
  const bool valid = w[0] == CMD_IMAGE && t >= 0 && t < grid;
  const int tc = clamp_i(t, 0, grid - 1);
  const float gx = (float)(p & 15) + (float)((tc % wit) * 16);
  const float gy = (float)(p >> 4) + (float)((tc / wit) * 16);

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
  const bool inb = ux < (float)iwi && uy < (float)ihi && ux >= 0.0f && uy >= 0.0f;
  const float x0f = floorf(ux);
  const float y0f = floorf(uy);
  const float fx = ux - x0f;
  const float fy = uy - y0f;
  const int xmax = max(iwi - 1, 0);
  const int ymax = max(ihi - 1, 0);
  // Atlas-absolute clamped corners.
  const int c0 = ax + clamp_i((int)x0f, 0, xmax);
  const int c1 = ax + clamp_i((int)ceilf(ux), 0, xmax);
  const int r0 = ay + clamp_i((int)y0f, 0, ymax);
  const int r1 = ay + clamp_i((int)ceilf(uy), 0, ymax);

  // The record's corner extent over all 256 pixels: min of the floor
  // corners, max of the ceil corners.
  const unsigned full = 0xFFFFFFFFu;
  const int wmin_x = __reduce_min_sync(full, c0);
  const int wmin_y = __reduce_min_sync(full, r0);
  const int wmax_x = __reduce_max_sync(full, c1);
  const int wmax_y = __reduce_max_sync(full, r1);
  if ((p & 31) == 0) {
    red[0][p >> 5] = wmin_x;
    red[1][p >> 5] = wmin_y;
    red[2][p >> 5] = wmax_x;
    red[3][p >> 5] = wmax_y;
  }
  __syncthreads();
  int rx0 = red[0][0], ry0 = red[1][0], rx1 = red[2][0], ry1 = red[3][0];
  for (int k = 1; k < kPixels / 32; ++k) {
    rx0 = min(rx0, red[0][k]);
    ry0 = min(ry0, red[1][k]);
    rx1 = max(rx1, red[2][k]);
    ry1 = max(ry1, red[3][k]);
  }
  const int x_lo = clamp_i(floordiv_i(rx0, 128) * 128, 0, AWp - REGW);
  const int y_lo = clamp_i(floordiv_i(ry0, 8) * 8, 0, AHp - REGH);
  const int nx = min(max(rx1 - x_lo, 0) / REGW + 1, 255);
  const int ny = min(max(ry1 - y_lo, 0) / REGH + 1, 255);
  const bool region_bad = ny * nx > MAX_WIN;
  if (p == 0 && region_bad && valid) atomicOr(region_flag, 1);

  float* o = out + (size_t)i * 4 * kPixels + p;
  if (!(inb && valid && !region_bad)) {
    o[0] = 0.0f;
    o[kPixels] = 0.0f;
    o[2 * kPixels] = 0.0f;
    o[3 * kPixels] = 0.0f;
    return;
  }
  // A live record's corners lie inside its image, which the packer
  // placed inside the atlas; the clamp only keeps a malformed record's
  // reads in bounds.
  const int rr0 = clamp_i(r0, 0, AHp - 1), rr1 = clamp_i(r1, 0, AHp - 1);
  const int cc0 = clamp_i(c0, 0, AWp - 1), cc1 = clamp_i(c1, 0, AWp - 1);
  const size_t plane = (size_t)AHp * AWp;
  const size_t i00 = (size_t)rr0 * AWp + cc0, i01 = (size_t)rr0 * AWp + cc1;
  const size_t i10 = (size_t)rr1 * AWp + cc0, i11 = (size_t)rr1 * AWp + cc1;
  const float wx0 = 1.0f - fx, wy0 = 1.0f - fy;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const float* a = atlas + ch * plane;
    const float top = __ldg(a + i00) * wx0 + __ldg(a + i01) * fx;
    const float bot = __ldg(a + i10) * wx0 + __ldg(a + i11) * fx;
    o[ch * kPixels] = top * wy0 + bot * fy;
  }
}

}  // namespace

extern "C" int jello_image_tap(const void* rec, const void* atlas, void* out,
                               void* region_flag, int n_recs, int grid, int wit,
                               int AHp, int AWp, void* stream) {
  if (n_recs > 0) {
    image_tap_kernel<<<n_recs, kPixels, 0, (cudaStream_t)stream>>>(
        (const int*)rec, (const float*)atlas, (float*)out, (int*)region_flag,
        grid, wit, AHp, AWp);
  }
  return (int)cudaGetLastError();
}
