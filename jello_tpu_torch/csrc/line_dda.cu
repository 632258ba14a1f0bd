// Kernel J: the per-line DDA table.
//
// Replaces no Pallas kernel: jello_tpu leaves this chain to XLA
// (pipeline/tiling.py::line_dda_clip and path_count_params, the per-line
// half of path_count). The port ran it as torch ops over vectors of L
// lines, L the class's line capacity: about 215 elementwise kernels for
// the DDA set-up and the bbox clip, 25 casts to float64, a stack of 21
// columns into the P table and, later, a strided stack of five of them
// (the row table), each a full pass over L.
//
// The contract (pipeline/tiling.py::line_tables_plain, whose
// line_dda_clip is the specification): each line's path index clamped
// to [0, D - 1] as gather_guarded does; its path's tile rect and tile
// offset as float32; every step of line_dda_clip in its own precision,
// float32 up to the robustness nudge of `a` and float64 from there, at
// the same promotion points; outputs P [L, 21] float64 (the columns of
// tiling.py::line_tables_plain, in order), the row table [L, 5] float64
// (P's columns ymin, tiles_base, bb1, stride, delta) and the crossing
// and backdrop-row counts, int32.
//
// Exactness: every expression below is the torch expression it stands
// for, one IEEE operation each, built with -fmad=false so no product
// and sum contract. torch.round is nearbyint (half to even); the
// divisions are one division each; torch.maximum, minimum and clamp
// return a NaN operand where fmax/fmin would drop it, so tmax, tmin and
// the clamps below do what torch's CUDA kernels do. A float that torch
// holds as float32 is held as float here, and widened where torch
// promotes it.
//
// What bounds it on an H100: bytes. A line reads 21 bytes and its
// path's 20 (cached: a path's lines are consecutive) and writes 216, so
// ~0.1 ms for the ~1.2M lines of a large stroked scene. The design is
// one pass, one line a thread. A thread that stored its own 168-byte P
// row would make each store of a warp touch 32 sectors 8 bytes at a
// time (that first design ran at 14% of the bound); so each warp stages
// its 32 rows in shared memory and stores them as one contiguous run,
// 256 bytes a store, then does the same with its row-table rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 21;    // P's columns (tiling.py::line_tables_plain)
constexpr int kRowCols = 5;  // the row table's (tiling.py::ROW_COLS)
constexpr float kTileScale = 1.0f / 16.0f;
constexpr float kOneMinusUlp = 0.99999994f;
constexpr double kRobustEpsilon = 2e-7;
constexpr double kTiny = (double)1e-12f;  // float32 1e-12, as tiling.TINY

// torch.maximum / torch.minimum on CUDA.
template <class T>
__device__ __forceinline__ T tmax(T a, T b) {
  return a != a ? a : (b != b ? b : ::max(a, b));
}
template <class T>
__device__ __forceinline__ T tmin(T a, T b) {
  return a != a ? a : (b != b ? b : ::min(a, b));
}
// torch.clamp(v, min=lo) and torch.clamp(v, max=hi) on CUDA.
template <class T>
__device__ __forceinline__ T clamp_lo(T v, T lo) {
  return v != v ? v : ::max(v, lo);
}
template <class T>
__device__ __forceinline__ T clamp_hi(T v, T hi) {
  return v != v ? v : ::min(v, hi);
}

// ceil(max(a, b)) - floor(min(a, b)), at least 1 (line_dda_clip's span_f).
__device__ __forceinline__ float span_f(float a, float b) {
  return clamp_lo(ceilf(tmax(a, b)) - floorf(tmin(a, b)), 1.0f);
}

// The clip's index search against one edge e: line_dda_clip's `fl` (e =
// bb0) and `fr` (e = bb2).
__device__ __forceinline__ double edge_index(float e, float x0f, float sign, float b,
                                             float fudge, double safe_a, bool is_positive) {
  double f = nearbyint((double)(sign * (e - x0f) - b + fudge) / safe_a);
  const double x = (double)x0f + (double)sign * floor(safe_a * f + (double)b);
  return (x < (double)e) == is_positive ? f + 1.0 : f;
}

// The first i of the line's DDA at or below the row edge e: line_dda_clip's
// `iminf` (e = bb1) and `imaxf` (e = bb3).
__device__ __forceinline__ double row_index(float e, float y0i, float b, double a,
                                            double safe_oma) {
  const double f = nearbyint(((double)(e - y0i + b) - a) / safe_oma) - 1.0;
  return (double)y0i + f - floor(a * f + (double)b) < (double)e ? f + 1.0 : f;
}

// One line's P row (v) and counts: line_dda_clip and line_tables_plain
// for line i.
__device__ __forceinline__ void line_row(
    int i, const float* __restrict__ lx0, const float* __restrict__ ly0,
    const float* __restrict__ lx1, const float* __restrict__ ly1,
    const bool* __restrict__ lvalid, const int* __restrict__ lpath,
    const int* __restrict__ rx0, const int* __restrict__ ry0, const int* __restrict__ rx1,
    const int* __restrict__ ry1, const int* __restrict__ toff, int D, double (&v)[kCols],
    int& n_cross, int& n_rows) {
  const int p = min(max(lpath[i], 0), D - 1);
  const float bb0 = (float)rx0[p], bb1 = (float)ry0[p];
  const float bb2 = (float)rx1[p], bb3 = (float)ry1[p];
  const float tiles_base = (float)toff[p];
  const float x0 = lx0[i], y0 = ly0[i], x1 = lx1[i], y1 = ly1[i];

  // Float32, up to the nudge of `a`.
  const bool is_down = y1 >= y0;
  const float ax0 = is_down ? x0 : x1, ay0 = is_down ? y0 : y1;
  const float ax1 = is_down ? x1 : x0, ay1 = is_down ? y1 : y0;
  const float s0x = ax0 * kTileScale, s0y = ay0 * kTileScale;
  const float s1x = ax1 * kTileScale, s1y = ay1 * kTileScale;
  const float count_x = span_f(s0x, s1x) - 1.0f;
  const float count = count_x + span_f(s0y, s1y);
  const float dx = fabsf(s1x - s0x);
  const float dy = s1y - s0y;
  const bool skip = (dx + dy == 0.0f) || (dy == 0.0f && floorf(s0y) == s0y);
  const float idxdy = 1.0f / (skip ? 1.0f : dx + dy);
  const float a32 = dx * idxdy;
  const bool is_positive = s1x >= s0x;
  const float sign = is_positive ? 1.0f : -1.0f;
  const float xt0 = floorf(s0x * sign);
  const float c = s0x * sign - xt0;
  const float y0i = floorf(s0y);
  const float ytop = s0y == s1y ? ceilf(s0y) : y0i + 1.0f;
  const float b = clamp_hi((dy * c + dx * (ytop - s0y)) * idxdy, kOneMinusUlp);
  const float robust_err = floorf(a32 * (count - 1.0f) + b) - count_x;

  // Float64 from here, as in the oracle.
  double a = (double)a32;
  if (robust_err != 0.0f) a = a - (robust_err > 0.0f ? 1.0 : -1.0) * kRobustEpsilon;
  const float x0f = xt0 * sign + (is_positive ? 0.0f : -1.0f);

  const bool valid = lvalid[i] && !skip;
  const float stride = bb2 - bb0;
  const float xmin = tmin(s0x, s1x);
  const float xmax = tmax(s0x, s1x);
  const bool line_dead = s0y >= bb3 || s1y < bb1 || xmin >= bb2 || stride == 0.0f || !valid;

  const double one_minus_a = 1.0 - a;
  const double safe_oma = one_minus_a == 0.0 ? kTiny : one_minus_a;
  double imin = s0y < bb1 ? row_index(bb1, y0i, b, a, safe_oma) : 0.0;
  double imax = s1y > bb3 ? row_index(bb3, y0i, b, a, safe_oma) : (double)count;

  const float delta = is_down ? -1.0f : 1.0f;
  double ymin = 0.0, ymax = 0.0;
  const bool all_left = xmax < bb0;
  if (all_left) {
    ymin = (double)ceilf(s0y);
    ymax = (double)ceilf(s1y);
    imax = imin;
  }

  const float fudge = is_positive ? 0.0f : 1.0f;
  const double safe_a = a == 0.0 ? kTiny : a;
  if (!all_left && xmin < bb0) {
    const double fl = edge_index(bb0, x0f, sign, b, fudge, safe_a, is_positive);
    const double ynext = (double)y0i + fl - floor(safe_a * fl + (double)b) + 1.0;
    if (is_positive && fl > imin) {
      ymin = (double)(y0i + (y0i == s0y ? 0.0f : 1.0f));
      ymax = ynext;
      imin = fl;
    }
    if (!is_positive && fl < imax) {
      ymin = ynext;
      ymax = (double)ceilf(s1y);
      imax = fl;
    }
  }
  if (!all_left && xmax > bb2) {
    const double fr = edge_index(bb2, x0f, sign, b, fudge, safe_a, is_positive);
    if (is_positive) {
      imax = tmin(imax, fr);
    } else {
      imin = tmax(imin, fr);
    }
  }

  imax = tmax(imin, imax);
  ymin = tmax(ymin, (double)bb1);
  ymax = tmin(ymax, (double)bb3);
  if (line_dead) imin = imax = ymin = ymax = 0.0;
  n_cross = (int)clamp_lo(imax - imin, 0.0);
  n_rows = (int)clamp_lo(ymax - ymin, 0.0);

  v[0] = imin;
  v[1] = a;
  v[2] = (double)b;
  v[3] = (double)sign;
  v[4] = (double)y0i;
  v[5] = (double)x0f;
  v[6] = (double)bb0;
  v[7] = (double)bb1;
  v[8] = (double)bb2;
  v[9] = (double)stride;
  v[10] = (double)tiles_base;
  v[11] = (double)s0y;
  v[12] = (double)delta;
  v[13] = ymin;
  v[14] = (double)ax0;
  v[15] = (double)ay0;
  v[16] = (double)ax1;
  v[17] = (double)ay1;
  v[18] = is_down ? 1.0 : 0.0;
  v[19] = (double)count;
  v[20] = is_positive ? 1.0 : 0.0;
}

// A warp's `rows` rows of `width` doubles, staged row by row in s, stored
// to out as one contiguous run: each store of the warp is 256 bytes.
__device__ __forceinline__ void store_rows(const double* s, double* __restrict__ out,
                                           int rows, int width, int lane) {
  __syncwarp();
  for (int k = lane; k < rows * width; k += 32) out[k] = s[k];
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
line_dda_kernel(const float* __restrict__ lx0, const float* __restrict__ ly0,
                const float* __restrict__ lx1, const float* __restrict__ ly1,
                const bool* __restrict__ lvalid, const int* __restrict__ lpath,
                const int* __restrict__ rx0, const int* __restrict__ ry0,
                const int* __restrict__ rx1, const int* __restrict__ ry1,
                const int* __restrict__ toff, double* __restrict__ P,
                double* __restrict__ PRT, int* __restrict__ n_cross,
                int* __restrict__ n_rows, int L, int D) {
  __shared__ double s_rows[kThreads / 32][32 * kCols];
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kThreads + (threadIdx.x & ~31);  // the warp's first line
  const int i = row0 + lane;
  const int rows = min(32, L - row0);
  double v[kCols];
  if (i < L) {
    line_row(i, lx0, ly0, lx1, ly1, lvalid, lpath, rx0, ry0, rx1, ry1, toff, D, v,
             n_cross[i], n_rows[i]);
  }
  // Lane l's staged row starts kCols (then kRowCols) doubles after lane
  // l - 1's, an odd number: the 64-bit stores of a half warp fall on 16
  // distinct pairs of banks.
  double* s = s_rows[threadIdx.x >> 5];
  if (i < L) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[lane * kCols + c] = v[c];
  }
  store_rows(s, P + (size_t)row0 * kCols, rows, kCols, lane);
  if (i < L) {  // ROW_COLS: ymin, tiles_base, bb1, stride, delta
    double* r = s + lane * kRowCols;
    r[0] = v[13];
    r[1] = v[10];
    r[2] = v[7];
    r[3] = v[9];
    r[4] = v[12];
  }
  store_rows(s, PRT + (size_t)row0 * kRowCols, rows, kRowCols, lane);
}

}  // namespace

// x0, y0, x1, y1 [L] f32, valid [L] bool, path [L] i32; the paths' rect
// x0, y0, x1, y1 and tile offset [D] i32 (D >= 1); P [L, 21] f64, PRT
// [L, 5] f64, n_cross, n_rows [L] i32; L, D, stream.
extern "C" int jello_line_dda(const void* x0, const void* y0, const void* x1, const void* y1,
                              const void* valid, const void* path, const void* rx0,
                              const void* ry0, const void* rx1, const void* ry1,
                              const void* toff, void* P, void* PRT, void* n_cross,
                              void* n_rows, int L, int D, void* stream) {
  if (L < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (L > 0) {
    line_dda_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(x0), static_cast<const float*>(y0),
        static_cast<const float*>(x1), static_cast<const float*>(y1),
        static_cast<const bool*>(valid), static_cast<const int*>(path),
        static_cast<const int*>(rx0), static_cast<const int*>(ry0),
        static_cast<const int*>(rx1), static_cast<const int*>(ry1),
        static_cast<const int*>(toff), static_cast<double*>(P), static_cast<double*>(PRT),
        static_cast<int*>(n_cross), static_cast<int*>(n_rows), L, D);
  }
  return (int)cudaGetLastError();
}
