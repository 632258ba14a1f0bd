// Kernel A: per-row fill coverage, in area mode and in the two MSAA
// modes.
//
// Replaces the Pallas kernel jello_tpu/tpu/coverage_pallas.py
// (make_coverage_kernel, pallas_call at :266; wrapper
// compute_area_rows_pallas), both of its bodies. The TPU kernel streams
// C-segment blocks through a one-hot MXU segmented sum (one product a
// sample under MSAA), carries open rows from one grid step to the next
// and fetches the rows' backdrops and rules through a window DMA; blocks
// on Hopper run in no order, so here each coverage row is one CTA that
// owns its whole segment run, and none of that is carried over.
//
// One CTA of 256 threads per slot-rank row, one thread per pixel of the
// 16x16 tile (the shape of vello's fine.wgsl:824-864). The row's
// segments are the contiguous run [row_start[r], row_end[r]) of the
// slot-sorted segment stream; the CTA stages them through shared memory
// in blocks of 256.
//
// Area mode (coverage_area_kernel): every thread sums the analytic
// trapezoid winding of its pixel over the run, adds the row's backdrop
// and stores one float of raw winding; the fine kernels apply the fill
// rule. The arithmetic is coverage_pallas.py:139-158 term for term,
// including the -1e-6 on xmin and the division by (xmax0 - xmin), but
// for one regrouping: the numerator b + (d^2 - c^2)/2 - xmin is summed
// as (b - xmin) + (d - c)(d + c)/2. Under a vertical edge the quotient
// is ~1e-6 over ~1e-6, and in float32 the difference of squares loses
// up to 6% of it (2.5e-2 of a pixel's coverage against the float64
// numpy oracle on a rectangle at a fractional x); regrouped, both terms
// are exact differences and the row stays within 2e-7 of the oracle.
//
// MSAA (coverage_msaa_kernel<S>, S = 8 or 16; coverage_pallas.py:164-181
// and 199-208): every thread keeps S winding sums in registers, one a
// sample of its pixel. A segment adds -sign(dy) to a sample whose row it
// crosses left of the sample, and sign(dx) once the sample lies at or
// below the segment's y_edge (the zero-width limit of the area terms);
// each addend is a small integer, so the float sums are exact in any
// order. Then the backdrop is added, the sum rounded half to even, the
// sample is inside by the row's rule (odd under even-odd, else nonzero;
// a clip row arrives with the nonzero rule), and the thread stores the
// mean over its samples: the row is RESOLVED coverage in [0, 1], and the
// fine kernels read it as it is. The crossing's x needs an IEEE division
// and is evaluated only for a sample whose row the segment crosses; a
// sample it does not cross gets no crossing term either way. The sample
// positions are the patterns of renderer/mask.py, written below as
// compile-time tables: sample i of S lies at ((pattern[i] + 0.5) / S,
// (i + 0.5) / S), all multiples of 1/32 and exact in float32.
//
// What bounds it on an H100: the segment stream is read once per row
// and each row writes 1 KB, so bytes are small; the time is the per
// pixel float work (~30 flops per segment in area mode; under MSAA ~8
// per segment and sample plus ~5 for a crossed sample row) and, for
// short rows, the launch of one CTA per row. Under MSAA that is more
// than the function needs: the crossing test, the crossing's x and the
// y_edge term depend on the pixel's row and the sample, not on the pixel,
// yet the 16 threads of a pixel row each evaluate them; only `xi < xs`
// and the accumulation (~2) are needed per pixel, so the kernel spends
// about four times the operations of its floor. Built with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kPixels = 256;
constexpr int kStage = 256;  // segments staged per shared-memory pass
constexpr int kCols = 8;     // x0, y0, x1, y1, y_edge, valid, 0, 0

// The x step of sample i, in units of 1 / S (renderer/mask.py:
// _MASK8_PATTERN, the rotated grid, and _MASK16_PATTERN, the D3D11
// standard 16x pattern).
template <int S>
__device__ __forceinline__ int sample_pattern(int i);

template <>
__device__ __forceinline__ int sample_pattern<8>(int i) {
  constexpr int kMask8Pattern[8] = {0, 5, 3, 7, 1, 4, 6, 2};
  return kMask8Pattern[i];
}

template <>
__device__ __forceinline__ int sample_pattern<16>(int i) {
  constexpr int kMask16Pattern[16] = {1, 8, 4, 11, 15, 7, 3, 12, 0, 9, 5, 13, 2, 10, 6, 14};
  return kMask16Pattern[i];
}

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

template <int S>
__global__ void __launch_bounds__(kPixels)
coverage_msaa_kernel(const float* __restrict__ seg,
                     const int* __restrict__ row_start,
                     const int* __restrict__ row_end,
                     const float* __restrict__ row_bd,
                     const int* __restrict__ row_eo,
                     float* __restrict__ out) {
  __shared__ float s[kStage * kCols];
  const int r = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)(p & 15);
  const float py = (float)(p >> 4);
  const int start = row_start[r];
  const int end = row_end[r];
  float acc[S];
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = 0.0f;
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
      const float safe_dy = dy == 0.0f ? 1.0f : dy;
      const float sgn_dx = sign_f(dx);
      const float sgn_dy = sign_f(dy);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float xs = px + ((float)sample_pattern<S>(i) + 0.5f) * (1.0f / S);
        const float ys = py + ((float)i + 0.5f) * (1.0f / S);
        float w = 0.0f;
        if ((sy0 <= ys) != (sy1 <= ys)) {
          const float t = (ys - sy0) / safe_dy;
          const float xi = sx0 + t * dx;
          if (xi < xs) w = -sgn_dy;
        }
        w = w + sgn_dx * (ys >= sye ? 1.0f : 0.0f);
        acc[i] = acc[i] + w * valid;
      }
    }
  }
  const float bd = row_bd[r];
  const bool even_odd = row_eo[r] != 0;
  int count = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int wi = (int)rintf(acc[i] + bd);
    count += (even_odd ? (wi & 1) != 0 : wi != 0) ? 1 : 0;
  }
  out[(size_t)r * kPixels + p] = (float)count * (1.0f / S);
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

// n_samples: 8 or 16 (anything else is refused). row_eo [n_rows] i32, 1
// where the row resolves by the even-odd rule.
extern "C" int jello_coverage_msaa(const void* seg, const void* row_start,
                                   const void* row_end, const void* row_bd,
                                   const void* row_eo, void* out, int n_rows,
                                   int n_samples, void* stream) {
  if (n_samples != 8 && n_samples != 16) return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_samples == 8) {
      coverage_msaa_kernel<8><<<n_rows, kPixels, 0, s>>>(
          (const float*)seg, (const int*)row_start, (const int*)row_end,
          (const float*)row_bd, (const int*)row_eo, (float*)out);
    } else {
      coverage_msaa_kernel<16><<<n_rows, kPixels, 0, s>>>(
          (const float*)seg, (const int*)row_start, (const int*)row_end,
          (const float*)row_bd, (const int*)row_eo, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}
