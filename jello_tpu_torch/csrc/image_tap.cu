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
// multiplies and adds do, or a texel index flips at a boundary. The tap
// itself (corners, extent, gather) is paint.cuh's, shared with the
// interpreter (fine_interp.cu).

#include <cuda_runtime.h>

#include "paint.cuh"

namespace {

using namespace jello;

constexpr int MAX_WIN = 12;

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

  const int t = w[3];
  const bool valid = w[0] == CMD_IMAGE && t >= 0 && t < grid;
  const int tc = clamp_i(t, 0, grid - 1);
  const float gx = (float)(p & 15) + (float)((tc % wit) * 16);
  const float gy = (float)(p >> 4) + (float)((tc / wit) * 16);

  const Tap tap = image_tap_corners(w, gx, gy);
  // The record's corner extent over all 256 pixels, and the origin of its
  // first region window.
  int rx0, ry0, rx1, ry1, x_lo, y_lo;
  image_tap_extent(tap, red, &rx0, &ry0, &rx1, &ry1);
  image_region_origin(rx0, ry0, AHp, AWp, &x_lo, &y_lo);
  const int nx = min(max(rx1 - x_lo, 0) / REGW + 1, 255);
  const int ny = min(max(ry1 - y_lo, 0) / REGH + 1, 255);
  const bool region_bad = ny * nx > MAX_WIN;
  if (p == 0 && region_bad && valid) atomicOr(region_flag, 1);

  float* o = out + (size_t)i * 4 * kPixels + p;
  float fg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (tap.inb && valid && !region_bad) image_tap_gather(atlas, AHp, AWp, tap, fg);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) o[ch * kPixels] = fg[ch];
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
