// Kernel A: per-row fill coverage, area mode.
//
// Replaces the Pallas kernel jello_tpu/tpu/coverage_pallas.py
// (make_coverage_kernel, pallas_call at :266; wrapper
// compute_area_rows_pallas) in area mode. The TPU kernel streams
// C-segment blocks through a one-hot MXU segmented sum and carries open
// rows from one grid step to the next; blocks on Hopper run in no order,
// so here each coverage row is one CTA that owns its whole segment run.
//
// One CTA of 256 threads per slot-rank row, one thread per pixel of the
// 16x16 tile (the shape of vello's fine.wgsl:824-864). The row's
// segments are the contiguous run [row_start[r], row_end[r]) of the
// slot-sorted segment stream; the CTA stages them through shared memory
// in blocks of 256, every thread sums the analytic trapezoid winding of
// its pixel over all of them, adds the row's backdrop and stores one
// float. The arithmetic is coverage_pallas.py:139-158 term for term,
// including the -1e-6 on xmin and the division by (xmax0 - xmin), but
// for one regrouping: the numerator b + (d^2 - c^2)/2 - xmin is summed
// as (b - xmin) + (d - c)(d + c)/2. Under a vertical edge the quotient
// is ~1e-6 over ~1e-6, and in float32 the difference of squares loses
// up to 6% of it (2.5e-2 of a pixel's coverage against the float64
// numpy oracle on a rectangle at a fractional x); regrouped, both terms
// are exact differences and the row stays within 2e-7 of the oracle.
//
// What bounds it on an H100: the segment stream is read once per row
// and each row writes 1 KB, so bytes are small; the time is the per
// pixel float work (~30 flops per segment) and, for short rows, the
// launch of one CTA per row. Built with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kPixels = 256;
constexpr int kStage = 256;  // segments staged per shared-memory pass
constexpr int kCols = 8;     // x0, y0, x1, y1, y_edge, valid, 0, 0

__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kPixels)
coverage_area_kernel(const float* __restrict__ seg,
                     const int* __restrict__ row_start,
                     const int* __restrict__ row_end,
                     const float* __restrict__ row_bd,
                     float* __restrict__ out) {
  __shared__ float s[kStage * kCols];
  const int r = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)(p & 15);
  const float py = (float)(p >> 4);
  const int start = row_start[r];
  const int end = row_end[r];
  float acc = 0.0f;
  for (int base = start; base < end; base += kStage) {
    const int n = min(kStage, end - base);
    __syncthreads();
    for (int i = p; i < n * kCols; i += kPixels) {
      s[i] = seg[(size_t)base * kCols + i];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* g = s + j * kCols;
      const float sx0 = g[0], sy0 = g[1], sx1 = g[2], sy1 = g[3];
      const float sye = g[4], valid = g[5];
      const float dx = sx1 - sx0;
      const float dy = sy1 - sy0;
      const float y = sy0 - py;
      const float y0c = clip01(y);
      const float y1c = clip01(y + dy);
      const float dyc = y0c - y1c;
      const float safe_dy = dy == 0.0f ? 1.0f : dy;
      const float t0 = (y0c - y) / safe_dy;
      const float t1 = (y1c - y) / safe_dy;
      const float startx = sx0 - px;
      const float x0 = startx + t0 * dx;
      const float x1 = startx + t1 * dx;
      const float xmin0 = fminf(x0, x1);
      const float xmax0 = fmaxf(x0, x1);
      const float xmin = fminf(xmin0, 1.0f) - 1.0e-6f;
      const float b = fminf(xmax0, 1.0f);
      const float cc = fmaxf(b, 0.0f);
      const float d = fmaxf(xmin, 0.0f);
      const float a = ((b - xmin) + 0.5f * ((d - cc) * (d + cc))) / (xmax0 - xmin);
      float contrib = dyc != 0.0f ? a * dyc : 0.0f;
      contrib = contrib + sign_f(dx) * clip01(py - sye + 1.0f);
      acc = acc + contrib * valid;
    }
  }
  out[(size_t)r * kPixels + p] = acc + row_bd[r];
}

}  // namespace

extern "C" int jello_coverage_area(const void* seg, const void* row_start,
                                   const void* row_end, const void* row_bd,
                                   void* out, int n_rows, void* stream) {
  if (n_rows > 0) {
    coverage_area_kernel<<<n_rows, kPixels, 0, (cudaStream_t)stream>>>(
        (const float*)seg, (const int*)row_start, (const int*)row_end,
        (const float*)row_bd, (float*)out);
  }
  return (int)cudaGetLastError();
}
