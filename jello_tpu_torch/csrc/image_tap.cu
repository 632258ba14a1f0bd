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
// One warp per record at a time; a CTA of eight warps walks records
// blockIdx.x * 8 + warp, then a grid's worth further on, so that the
// grid is at most the CTAs the card holds at once, not one CTA per row.
// A warp
//   - takes the record's 16 words (lanes 0..15 load one each into the
//     warp's shared slot);
//   - writes a row that is not a live image record (kind, or tile out of
//     the grid: the zero rows past the image count) as zeros, 16-byte
//     stores, and goes on;
//   - takes the record's corner extent over its 16x16 tile from the
//     tile's four corner pixels (paint.cuh: image_tap_corner_extent says
//     why that equals the extent over all 256 pixels, bit for bit), so
//     no reduction and no barrier; a record whose clamped corners span
//     more than MAX_WIN 64x256 windows of the padded atlas (the
//     wrapper-side _region_offsets of the reference) writes zeros and
//     sets the region-overflow byte, so that port and reference reroute
//     the same frames;
//   - gives each lane 2 x 4 consecutive pixels: per pixel it maps the
//     pixel centre through the record's inverse transform (words 6..11),
//     takes floor and ceil, clamps both to the image, offsets them by its
//     atlas placement (word 12, ay << 16 | ax), reads the four
//     premultiplied texels of each channel from the planar atlas (small,
//     it stays in L2) and mixes x first, then y, with the weights (1 - f)
//     and f. When floor and ceil name the same texel the two weighted
//     terms add, t (1 - f) + t f, as the TPU kernel's two one-hots do.
//     Pixels out of the image are zero. A lane stores its four pixels of
//     a channel as one 16-byte vector: out[rec][256 ch + p].
//
// The C entry clears the region byte with one cudaMemsetAsync and
// launches the kernel: one memset and one kernel a call.
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
constexpr int kWarps = 8;  // warps a CTA, one record each at a time
constexpr int kMaxDevices = 16;

__device__ __forceinline__ void store_zeros(float4* o, int lane) {
#pragma unroll
  for (int k = lane; k < kPixels; k += 32) o[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kWarps * 32)
image_tap_kernel(const int* __restrict__ rec, const float* __restrict__ atlas,
                 float* __restrict__ out, unsigned char* __restrict__ region_flag, int n_recs,
                 int grid, int wit, int AHp, int AWp) {
  __shared__ int words[kWarps][16];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* w = words[warp];
  for (int i = blockIdx.x * kWarps + warp; i < n_recs; i += gridDim.x * kWarps) {
    __syncwarp();  // the previous record's words are read
    if (lane < 16) words[warp][lane] = __ldg(rec + (size_t)i * 16 + lane);
    __syncwarp();
    float4* o = reinterpret_cast<float4*>(out + (size_t)i * 4 * kPixels);
    const int t = w[3];
    if (!(w[0] == CMD_IMAGE && t >= 0 && t < grid)) {
      store_zeros(o, lane);
      continue;
    }
    const int ox = (t % wit) * 16, oy = (t / wit) * 16;
    // The record's corner extent and the origin of its first region window.
    int rx0, ry0, rx1, ry1, x_lo, y_lo;
    image_tap_corner_extent(w, ox, oy, &rx0, &ry0, &rx1, &ry1);
    image_region_origin(rx0, ry0, AHp, AWp, &x_lo, &y_lo);
    const int nx = min(max(rx1 - x_lo, 0) / REGW + 1, 255);
    const int ny = min(max(ry1 - y_lo, 0) / REGH + 1, 255);
    if (ny * nx > MAX_WIN) {
      if (lane == 0) *region_flag = 1;
      store_zeros(o, lane);
      continue;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = lane + 32 * half;  // pixels 4q .. 4q + 3, a quarter of a tile row
      float fg[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * q + j;
        const Tap tap = image_tap_corners(w, (float)(p & 15) + (float)ox,
                                          (float)(p >> 4) + (float)oy);
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) fg[j][ch] = 0.0f;
        if (tap.inb) image_tap_gather(atlas, AHp, AWp, tap, fg[j]);
      }
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        o[ch * (kPixels / 4) + q] = make_float4(fg[0][ch], fg[1][ch], fg[2][ch], fg[3][ch]);
    }
  }
}

// The CTAs of image_tap_kernel one multiprocessor holds at once, and the
// multiprocessors, of the current device (cached per device).
cudaError_t resident_ctas(int* per_sm, int* sms) {
  static int cache[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev][0] == 0) {
    int n = 0, m = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, image_tap_kernel, kWarps * 32, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cache[dev][1] = m;
    cache[dev][0] = n > 0 ? n : 1;
  }
  *per_sm = cache[dev][0];
  *sms = cache[dev][1];
  return cudaSuccess;
}

}  // namespace

// tap_rec [n_recs, 16] i32, atlas [4, AHp, AWp] f32, out [n_recs, 1024]
// f32, region_flag one byte (cleared here, set to 1 by a live record past
// MAX_WIN windows).
extern "C" int jello_image_tap(const void* rec, const void* atlas, void* out,
                               void* region_flag, int n_recs, int grid, int wit,
                               int AHp, int AWp, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(region_flag, 0, 1, s);
  if (err != cudaSuccess || n_recs <= 0) return (int)err;
  int per_sm = 0, sms = 0;
  err = resident_ctas(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const int need = (n_recs + kWarps - 1) / kWarps;
  image_tap_kernel<<<need < per_sm * sms ? need : per_sm * sms, kWarps * 32, 0, s>>>(
      (const int*)rec, (const float*)atlas, (float*)out, (unsigned char*)region_flag,
      n_recs, grid, wit, AHp, AWp);
  return (int)cudaGetLastError();
}

// CTAs of image_tap_kernel resident on one multiprocessor of the current
// device (a query, no launch; -1 on a CUDA error).
extern "C" int jello_image_tap_ctas() {
  int per_sm = 0, sms = 0;
  return resident_ctas(&per_sm, &sms) == cudaSuccess ? per_sm : -1;
}
