// Kernel E: the expand sweep, with its three bodies E, E' and E''.
//
// Replaces the Pallas kernel jello_tpu/tpu/expand_pallas.py
// (make_expand_call, pallas_call at :248) and its bodies _euler_compute
// (:334, Euler records -> lines), _crossing_compute (:263, lines -> tile
// crossings and clipped segments) and _row_compute (:317, lines ->
// backdrop rows). The TPU kernel streams C-output chunks: one window DMA
// of the record table, ownership by a (W, C) comparison against the
// windowed prefix, and the owners' parameters landed on lanes by a
// one-hot MXU matmul. On Hopper each output slot is one thread that
// finds its owner by binary search over the inclusive prefix `incl`
// (computed by the wrapper) and reads the owner's row itself; nothing is
// shared between slots, so there are no windows.
//
// The contract (pipeline/expand.py): owner = #{incl <= j}, within =
// j - (incl[owner] - max(count, 1)), valid = 0 <= within < count, and
// slots past the total are invalid. One template, `expand_kernel<Body>`,
// runs the contract and hands (slot, owner, within, valid) to the body.
//
// What bounds it on an H100: for E, the per-line float work (two full
// line-point evaluations, since a line's start point re-evaluates the
// item's previous line instead of communicating, as the TPU body does;
// that keeps start and end points bit-identical to the chained XLA
// route); for E' and E'', the log2(R) dependent loads of the search and
// the row reads, both cached. Built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flatten_math.cuh"

namespace {

constexpr int kThreads = 128;

// --- E: Euler records -> lines -------------------------------------------
struct EulerBody {
  const float* table;  // [NW, 21] work rows
  const float* rec;    // [3, IT, NW] t0, t1, n
  int NW, IT, EC, sentinel_path;
  float* xy;           // [4, EC] x0, y0, x1, y1
  int* path;           // [EC]
  bool* valid_out;     // [EC]

  // The record holding line w of item `own`, by a prefix walk over the
  // item's iterations: (t0, t1, n, index within the record).
  __device__ void rec_at(int own, float w, float* t0, float* t1, float* n, float* wr) const {
    *t0 = *t1 = *n = *wr = 0.0f;
    float acc = 0.0f;
    for (int it = 0; it < IT; ++it) {
      const float n_it = rec[((size_t)2 * IT + it) * NW + own];
      const float hi = acc + n_it;
      if (w >= acc && w < hi) {
        *t0 = rec[(size_t)it * NW + own];
        *t1 = rec[((size_t)IT + it) * NW + own];
        *n = n_it;
        *wr = w - acc;
        return;
      }
      acc = hi;
    }
  }

  __device__ void point(const fm::Cubic& P, const float* row, int own, float w, float* x,
                        float* y) const {
    float t0, t1, n, wr;
    rec_at(own, w, &t0, &t1, &n, &wr);
    fm::euler_line_point(P, t0, t1, wr, n, row[8], row[9], row[12], row[13], x, y);
  }

  __device__ void operator()(int j, int own, int within, bool valid) const {
    valid_out[j] = valid;
    if (!valid) {
      xy[j] = xy[(size_t)EC + j] = xy[(size_t)2 * EC + j] = xy[(size_t)3 * EC + j] = 0.0f;
      path[j] = sentinel_path;
      return;
    }
    const float* row = table + (size_t)own * 21;
    fm::Cubic P;
    for (int k = 0; k < 8; ++k) P.p[k] = row[k];
    float lx1, ly1, lp0x, lp0y;
    point(P, row, own, (float)within, &lx1, &ly1);
    if (within == 0) {
      lp0x = row[10];
      lp0y = row[11];
    } else {
      point(P, row, own, (float)(within - 1), &lp0x, &lp0y);
    }
    const bool swap = row[8] < 0.0f;
    const float ex0 = swap ? lx1 : lp0x, ey0 = swap ? ly1 : lp0y;
    const float ex1 = swap ? lp0x : lx1, ey1 = swap ? lp0y : ly1;
    const float* T = row + 14;
    xy[j] = T[0] * ex0 + T[2] * ey0 + T[4];
    xy[(size_t)EC + j] = T[1] * ex0 + T[3] * ey0 + T[5];
    xy[(size_t)2 * EC + j] = T[0] * ex1 + T[2] * ey1 + T[4];
    xy[(size_t)3 * EC + j] = T[1] * ex1 + T[3] * ey1 + T[5];
    path[j] = (int)row[20];
  }
};

// --- E': lines -> tile crossings, clipped segments, top-edge bumps --------
// pipeline/tiling.py::crossings and _tile_clip_segments in double, as the
// port's plain path_count (and the numpy oracle) compute them; the
// tile's own coordinates are float32 there, and stay float here.
struct CrossingBody {
  const double* P;  // [L, 21]
  int SC, T;
  double* seg;      // [5, SC] x0, y0, x1, y1, y_edge
  int* ints;        // [3, SC] tile_slot, bump_slot, bump_delta

  __device__ void operator()(int j, int own, int within, bool valid) const {
    int* tile_slot = ints;
    int* bump_slot = ints + SC;
    int* bump_delta = ints + 2 * SC;
    if (!valid) {
      tile_slot[j] = T;
      bump_slot[j] = T;
      bump_delta[j] = 0;
      for (int k = 0; k < 4; ++k) seg[(size_t)k * SC + j] = 0.0;
      seg[(size_t)4 * SC + j] = 1e9;
      return;
    }
    const double* p = P + (size_t)own * 21;
    const double ci = p[0] + (double)(float)within;
    const double a = p[1], b = p[2], sign = p[3], y0i = p[4], x0f = p[5];
    const double z = floor(a * ci + b);
    const int cy = (int)(y0i + ci - z);
    const int cx = (int)(x0f + sign * z);
    const int bb0 = (int)p[6], bb1 = (int)p[7], bb2 = (int)p[8], stride = (int)p[9];
    const int cbase = (int)p[10] + (cy - bb1) * stride - bb0;
    const double last_z = floor(a * (ci - 1.0) + b);
    const bool top_edge = ci == 0.0 ? y0i == p[11] : last_z == z;
    const bool bump_ok = top_edge && (cx + 1 < bb2);
    tile_slot[j] = cbase + cx;
    bump_slot[j] = bump_ok ? cbase + max(cx + 1, bb0) : T;
    bump_delta[j] = bump_ok ? (int)p[12] : 0;

    // _tile_clip_segments
    const double xy0x = p[14], xy0y = p[15], xy1x = p[16], xy1y = p[17];
    const bool is_down = p[18] > 0.5, is_positive = p[20] > 0.5;
    const float count = (float)p[19];
    const float tile_x = (float)cx * 16.0f, tile_y = (float)cy * 16.0f;
    const float tile_x1 = tile_x + 16.0f, tile_y1 = tile_y + 16.0f;
    const double tiny = (double)F(1e-12);
    const double lo_x = (double)(tile_x + F(1e-3)), lo_y = (double)(tile_y + F(1e-3));
    const bool top_clipped = z == last_z;
    const double safe_dy = xy1y == xy0y ? tiny : xy1y - xy0y;
    const double safe_dx = xy1x == xy0x ? tiny : xy1x - xy0x;
    double xt = xy0x + (xy1x - xy0x) * ((double)tile_y - xy0y) / safe_dy;
    xt = mind(maxd(xt, lo_x), (double)tile_x1);
    const float x_clip_t = is_positive ? tile_x : tile_x1;
    double yt = xy0y + (xy1y - xy0y) * ((double)x_clip_t - xy0x) / safe_dx;
    yt = mind(maxd(yt, lo_y), (double)tile_y1);
    const bool has_top = ci > 0.0;
    const double nx0 = has_top ? (top_clipped ? xt : (double)x_clip_t) : xy0x;
    const double ny0 = has_top ? (top_clipped ? (double)tile_y : yt) : xy0y;

    const double z_next = floor(a * (ci + 1.0) + b);
    const bool bot_clipped = z == z_next;
    double xtb = xy0x + (xy1x - xy0x) * ((double)tile_y1 - xy0y) / safe_dy;
    xtb = mind(maxd(xtb, lo_x), (double)tile_x1);
    const float x_clip_b = is_positive ? tile_x1 : tile_x;
    double ytb = xy0y + (xy1y - xy0y) * ((double)x_clip_b - xy0x) / safe_dx;
    ytb = mind(maxd(ytb, lo_y), (double)tile_y1);
    const bool has_bot = ci < (double)(count - 1.0f);
    const double nx1 = has_bot ? (bot_clipped ? xtb : (double)x_clip_b) : xy1x;
    const double ny1 = has_bot ? (bot_clipped ? (double)tile_y1 : ytb) : xy1y;

    double p0x = nx0 - (double)tile_x, p0y = ny0 - (double)tile_y;
    double p1x = nx1 - (double)tile_x, p1y = ny1 - (double)tile_y;
    const double eps = (double)F(1e-6);
    double y_edge = 1e9;
    const bool both_zero = p0x == 0.0 && p1x == 0.0;
    const bool whole_tile = both_zero && p0y == 0.0;
    const bool vanish = both_zero && p0y != 0.0;
    if (p0x == 0.0 && p1x != 0.0 && p0y != 0.0) y_edge = p0y;
    if (p0x != 0.0 && p1x == 0.0 && p1y != 0.0) y_edge = p1y;
    if (p0x == 0.0 && (p1x == 0.0 || p0y == 0.0)) p0x = eps;
    if (p1x == 0.0 && p1y == 0.0 && !both_zero) p1x = eps;
    if (whole_tile) {
      p1x = eps;
      p1y = 16.0;
    }
    if (vanish) {
      p1x = 2.0 * eps;
      p1y = p0y;
    }
    if (p0x == floor(p0x) && p0x != 0.0) p0x = p0x - eps;
    if (p1x == floor(p1x) && p1x != 0.0) p1x = p1x - eps;
    seg[j] = is_down ? p0x : p1x;
    seg[(size_t)SC + j] = is_down ? p0y : p1y;
    seg[(size_t)2 * SC + j] = is_down ? p1x : p0x;
    seg[(size_t)3 * SC + j] = is_down ? p1y : p0y;
    seg[(size_t)4 * SC + j] = y_edge;
  }

  // torch.maximum / torch.minimum: NaN propagates.
  __device__ static double maxd(double a, double b) {
    return isnan(a) ? a : (isnan(b) ? b : fmax(a, b));
  }
  __device__ static double mind(double a, double b) {
    return isnan(a) ? a : (isnan(b) ? b : fmin(a, b));
  }
};

// --- E'': lines -> backdrop rows ---------------------------------------
// pipeline/tiling.py::backdrop_rows: PRT columns ymin, tiles_base, bb1,
// stride, delta.
struct RowBody {
  const double* PRT;  // [L, 5]
  int RC, T;
  int* ints;          // [2, RC] r_slot, r_delta

  __device__ void operator()(int j, int own, int within, bool valid) const {
    if (!valid) {
      ints[j] = T;
      ints[RC + j] = 0;
      return;
    }
    const double* p = PRT + (size_t)own * 5;
    const int r_y = (int)p[0] + within;
    ints[j] = (int)p[1] + (r_y - (int)p[2]) * (int)p[3];
    ints[RC + j] = (int)p[4];
  }
};

template <class Body>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ incl, const int* __restrict__ counts, int R, int out_cap,
              Body body) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= out_cap) return;
  // owner = #{r : incl[r] <= j} (incl is nondecreasing).
  int lo = 0, hi = R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (incl[mid] <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int own = min(lo, R - 1);
  const int cnt = counts[own];
  const int within = j - (incl[own] - max(cnt, 1));
  const bool valid = lo < R && within >= 0 && within < cnt;
  body(j, own, within, valid);
}

template <class Body>
int launch(const void* incl, const void* counts, int R, int out_cap, const Body& body,
           void* stream) {
  if (R > 0 && out_cap > 0) {
    expand_kernel<Body><<<(out_cap + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>((const int*)incl, (const int*)counts, R,
                                                  out_cap, body);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jello_expand_euler(const void* table, const void* rec, const void* incl,
                                  const void* counts, void* xy, void* path, void* valid,
                                  int NW, int IT, int EC, int sentinel_path, void* stream) {
  EulerBody body{(const float*)table, (const float*)rec, NW, IT, EC, sentinel_path,
                 (float*)xy, (int*)path, (bool*)valid};
  return launch(incl, counts, NW, EC, body, stream);
}

extern "C" int jello_expand_crossings(const void* P, const void* incl, const void* counts,
                                      void* seg, void* ints, int L, int SC, int T,
                                      void* stream) {
  CrossingBody body{(const double*)P, SC, T, (double*)seg, (int*)ints};
  return launch(incl, counts, L, SC, body, stream);
}

extern "C" int jello_expand_rows(const void* PRT, const void* incl, const void* counts,
                                 void* ints, int L, int RC, int T, void* stream) {
  RowBody body{(const double*)PRT, RC, T, (int*)ints};
  return launch(incl, counts, L, RC, body, stream);
}
