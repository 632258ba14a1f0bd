// Kernel E: the expand sweep, with its three bodies E, E' and E''.
//
// Replaces the Pallas kernel jello_tpu/tpu/expand_pallas.py
// (make_expand_call, pallas_call at :248) and its bodies _euler_compute
// (:334, Euler records -> lines), _crossing_compute (:263, lines -> tile
// crossings and clipped segments) and _row_compute (:317, lines ->
// backdrop rows). The TPU kernel streams C-output chunks: one window DMA
// of the record table, ownership by a (W, C) comparison against the
// windowed prefix, and the owners' parameters landed on lanes by a
// one-hot MXU matmul.
//
// The contract (pipeline/expand.py): incl is the inclusive prefix of
// max(count, 1), or of count under assume_compact; owner = #{incl <= j},
// within = j - (incl[owner] - max(count, 1)), valid = 0 <= within <
// count, and slots past the total are invalid. One template,
// `expand_kernel<Body>`, runs the contract and hands (slot, owner,
// within, valid) to the body.
//
// Each C entry is one call on the caller's stream with no host work
// around it: the prefix is computed here (an int32 reduce-then-scan over
// tiles of kScanTile counts, the clamp fused: one reduce kernel when
// there is more than one tile, then one scan kernel that writes `incl`
// and the 0-dim total), then the expand kernel. Reduce-then-scan rather
// than a single pass with decoupled look-back: the counts are a few
// hundred thousand int32 at most, so reading them twice costs ~2 us,
// and it needs neither status words to clear nor spin-waits between
// CTAs; each CTA of the scan sums the earlier tiles' totals itself. A
// tile of 8,192 counts keeps the small expansions (E'' always, E at
// config 3's size) to one scan launch: a launch costs the host more
// than the scan costs the card.
//
// The expand kernel takes B consecutive slots a CTA. Its first two warps
// find the owners of the CTA's first slot and of its last slot below the
// total, each by a 32-way search (4-5 dependent loads at R ~ 200k); the
// owners between them, at most B under the clamp (every owner holds a
// slot) and under assume_compact with the zero counts at the end, are
// staged into shared memory with their prefix entries and counts, and
// each slot finds its owner there by binary search. (A window wider than
// B, possible only with zero counts between nonzero ones under
// assume_compact, is searched in device memory instead.) The Euler body
// also stages each owner's running line count over its iterations, up
// to the iteration where it reaches the owner's count (~2 loads an owner
// at config 5, not IT), so that a line finds its record by a search in
// shared memory and loads its t0, t1 and n once; it evaluates its end
// point only, and takes its start point from the previous slot's end
// point in shared memory (the same function of the same operands under
// -fmad=false, so the same bits); only a CTA's first slot evaluates the
// previous line itself. The crossing body stages its owners' 21-double
// rows. Built with -fmad=false.
//
// What bounds it on an H100: for E, the per-line float work (one line
// point evaluation a line: two cubic evaluations, a fit, the Euler
// parameters and the subdivision, with their transcendentals), run at
// the occupancy its registers allow (staging the work rows as well cost
// a third of the occupancy and more time than it saved); for E', the
// double-precision clipping (four divides a crossing) and the five
// float64 outputs a slot; for E'', a call is launch-sized and the host's
// launches are its cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flatten_math.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// --- E1: the inclusive prefix of the counts --------------------------------
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;  // cuda/expand.py SCAN_TILE

// Shared-memory index of tile entry i, padded so that a thread's
// kScanItems consecutive entries and a warp's strided ones hit 32 banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <bool kClamp>
__device__ __forceinline__ unsigned count_at(const int* counts, int r, int R) {
  if (r >= R) return 0u;
  const int c = counts[r];
  return (unsigned)(kClamp ? max(c, 1) : c);
}

// The sum of v over the CTA, in every thread (unsigned: wraps as torch's
// int32 cumsum does). s holds kScanThreads / 32 words.
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* s) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned t = 0;
#pragma unroll
  for (int w = 0; w < kScanThreads / 32; ++w) t += s[w];
  __syncthreads();
  return t;
}

template <bool kClamp>
__global__ void __launch_bounds__(kScanThreads)
scan_reduce(const int* __restrict__ counts, int R, unsigned* __restrict__ sums) {
  __shared__ unsigned s_warp[kScanThreads / 32];
  const int base = blockIdx.x * kScanTile;
  unsigned v = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    v += count_at<kClamp>(counts, base + k * kScanThreads + threadIdx.x, R);
  }
  v = block_sum(v, s_warp);
  if (threadIdx.x == 0) sums[blockIdx.x] = v;
}

template <bool kClamp>
__global__ void __launch_bounds__(kScanThreads)
scan_apply(const int* __restrict__ counts, int R, const unsigned* __restrict__ sums,
           int* __restrict__ incl, int* __restrict__ total) {
  __shared__ unsigned s_tile[kScanTile + kScanTile / 32];
  __shared__ unsigned s_warp[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kScanTile;
  // This tile's offset: the totals of the tiles before it.
  unsigned off = 0;
  for (int b = tid; b < (int)blockIdx.x; b += kScanThreads) off += sums[b];
  off = block_sum(off, s_warp);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int i = k * kScanThreads + tid;
    s_tile[pad(i)] = count_at<kClamp>(counts, base + i, R);
  }
  __syncthreads();
  unsigned loc[kScanItems];
  unsigned run = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    run += s_tile[pad(tid * kScanItems + k)];
    loc[k] = run;
  }
  unsigned x = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  unsigned before = off + x - run;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) s_tile[pad(tid * kScanItems + k)] = before + loc[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int i = k * kScanThreads + tid;
    if (base + i < R) incl[base + i] = (int)s_tile[pad(i)];
    if (base + i == R - 1) *total = (int)s_tile[pad(i)];
  }
}

// --- E2: owners --------------------------------------------------------------
// The first r in [0, R) with incl[r] > j (R if none), found by one warp:
// each step probes 32 evenly spaced entries of the open interval and
// keeps the chunk where the comparison turns. Every lane returns it.
__device__ int warp_upper_bound(const int* incl, int R, int j) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = R;  // the answer lies in [lo, hi]; incl[hi] > j unless hi == R
  while (hi > lo) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step - 1;
    const bool probe = p < hi;
    const unsigned gt = __ballot_sync(kFull, probe && incl[p] > j);
    if (gt) {
      const int f = __ffs((int)gt) - 1;
      hi = lo + (f + 1) * step - 1;
      lo = lo + f * step;
    } else {
      lo = lo + __popc(__ballot_sync(kFull, probe)) * step;
    }
  }
  return hi;
}

// Where a slot's owner lies: `t` is its index in the CTA's staged window
// (-1 where the window was not staged or the slot has no owner).
struct Slot {
  int j, own, t, within;
  bool valid, in_range;  // in_range: j < out_cap
};

// --- E: Euler records -> lines -----------------------------------------------
struct EulerBody {
  static constexpr int kBlock = 128;
  static constexpr bool kClamp = true;
  const float* table;  // [NW, 21] work rows
  const float* rec;    // [3, IT, NW] t0, t1, n
  int NW, IT, sentinel_path;
  float *x0, *y0, *x1, *y1;  // [EC] each
  int* path;                 // [EC]
  bool* valid_out;           // [EC]

  // Shared memory: each owner's running line count over its iterations
  // [IT + 1, B], the iterations staged [B], each slot's end point [2, B].
  size_t smem_bytes() const { return (size_t)((IT + 1) * kBlock + 3 * kBlock) * 4; }

  __device__ void stage(int first, int W, const int* s_cnt, unsigned char* sm) const {
    float* s_pre = (float*)sm;
    int* s_its = (int*)(s_pre + (IT + 1) * kBlock);
    const int tid = threadIdx.x;
    if (tid >= W) return;
    // rec_at's running `acc`, in its order, coalesced across owners one
    // iteration at a time; it stops once it reaches the owner's count,
    // past which no line of the owner searches (the walk's records end
    // there, and a count the records do not reach leaves all IT staged).
    const float* n_col = rec + (size_t)2 * IT * NW + first + tid;
    const float want = (float)s_cnt[tid];
    float acc = 0.0f;
    int it = 0;
    s_pre[tid] = 0.0f;
    for (; it < IT && acc < want; ++it) {
      acc = acc + n_col[(size_t)it * NW];
      s_pre[(it + 1) * kBlock + tid] = acc;
    }
    s_its[tid] = it;
  }

  // The end point of line w of the owner at window index t: its record
  // is the first iteration whose running total passes w (none: zeros,
  // as the prefix walk of the plain version gives).
  __device__ void point(const float* row, const unsigned char* sm, int own, int t, float w,
                        float* x, float* y) const {
    const float* s_pre = (const float*)sm;
    const int staged = ((const int*)(s_pre + (IT + 1) * kBlock))[t];
    int lo = 1, hi = staged + 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_pre[mid * kBlock + t] > w) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    float t0 = 0.0f, t1 = 0.0f, n = 0.0f, wr = 0.0f;
    if (lo <= staged) {
      const int it = lo - 1;
      t0 = rec[(size_t)it * NW + own];
      t1 = rec[((size_t)IT + it) * NW + own];
      n = rec[((size_t)2 * IT + it) * NW + own];
      wr = w - s_pre[it * kBlock + t];
    }
    fm::Cubic P;
#pragma unroll
    for (int k = 0; k < 8; ++k) P.p[k] = row[k];
    fm::euler_line_point(P, t0, t1, wr, n, row[8], row[9], row[12], row[13], x, y);
  }

  __device__ void operator()(const Slot& s, unsigned char* sm) const {
    float* s_end = (float*)sm + (IT + 2) * kBlock;
    const int tid = threadIdx.x;
    // The work row through L1 (most of a CTA's slots share a few owners):
    // staging the rows too cost more in occupancy than it saved.
    const float* row = table + (size_t)s.own * 21;
    float lx1 = 0.0f, ly1 = 0.0f;
    // Under the clamp every owner holds a slot, so the window is always
    // staged (t >= 0) for a valid slot.
    if (s.valid) point(row, sm, s.own, s.t, (float)s.within, &lx1, &ly1);
    s_end[tid] = lx1;
    s_end[kBlock + tid] = ly1;
    __syncthreads();
    if (!s.in_range) return;
    const int j = s.j;
    valid_out[j] = s.valid;
    if (!s.valid) {
      x0[j] = y0[j] = x1[j] = y1[j] = 0.0f;
      path[j] = sentinel_path;
      return;
    }
    float lp0x, lp0y;
    if (s.within == 0) {
      lp0x = row[10];
      lp0y = row[11];
    } else if (tid > 0) {  // slot j - 1 is line within - 1 of the same owner
      lp0x = s_end[tid - 1];
      lp0y = s_end[kBlock + tid - 1];
    } else {
      point(row, sm, s.own, s.t, (float)(s.within - 1), &lp0x, &lp0y);
    }
    const bool swap = row[8] < 0.0f;
    const float ex0 = swap ? lx1 : lp0x, ey0 = swap ? ly1 : lp0y;
    const float ex1 = swap ? lp0x : lx1, ey1 = swap ? lp0y : ly1;
    const float* T = row + 14;
    x0[j] = T[0] * ex0 + T[2] * ey0 + T[4];
    y0[j] = T[1] * ex0 + T[3] * ey0 + T[5];
    x1[j] = T[0] * ex1 + T[2] * ey1 + T[4];
    y1[j] = T[1] * ex1 + T[3] * ey1 + T[5];
    path[j] = (int)row[20];
  }
};

// --- E': lines -> tile crossings, clipped segments, top-edge bumps --------
// pipeline/tiling.py::crossings and _tile_clip_segments in double, as the
// port's plain path_count (and the numpy oracle) compute them; the
// tile's own coordinates are float32 there, and stay float here.
struct CrossingBody {
  static constexpr int kBlock = 128;
  static constexpr bool kClamp = false;
  const double* P;  // [L, 21]
  int T;
  double *sx0, *sy0, *sx1, *sy1, *y_edge_out;  // [SC] each
  int *tile_slot, *bump_slot, *bump_delta;     // [SC] each

  // Shared memory: the window's rows [B, 21].
  size_t smem_bytes() const { return (size_t)kBlock * 21 * 8; }

  __device__ void stage(int first, int W, const int*, unsigned char* sm) const {
    double* s_rows = (double*)sm;
    for (int k = threadIdx.x; k < W * 21; k += kBlock) s_rows[k] = P[(size_t)first * 21 + k];
  }

  __device__ void operator()(const Slot& s, unsigned char* sm) const {
    if (!s.in_range) return;
    const int j = s.j;
    if (!s.valid) {
      tile_slot[j] = T;
      bump_slot[j] = T;
      bump_delta[j] = 0;
      sx0[j] = sy0[j] = sx1[j] = sy1[j] = 0.0;
      y_edge_out[j] = 1e9;
      return;
    }
    const double* p = s.t >= 0 ? (const double*)sm + (size_t)s.t * 21 : P + (size_t)s.own * 21;
    const double ci = p[0] + (double)(float)s.within;
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
    sx0[j] = is_down ? p0x : p1x;
    sy0[j] = is_down ? p0y : p1y;
    sx1[j] = is_down ? p1x : p0x;
    sy1[j] = is_down ? p1y : p0y;
    y_edge_out[j] = y_edge;
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
  static constexpr int kBlock = 256;
  static constexpr bool kClamp = false;
  const double* PRT;  // [L, 5]
  int T;
  int *r_slot, *r_delta;  // [RC] each

  size_t smem_bytes() const { return 0; }
  __device__ void stage(int, int, const int*, unsigned char*) const {}

  __device__ void operator()(const Slot& s, unsigned char*) const {
    if (!s.in_range) return;
    const int j = s.j;
    if (!s.valid) {
      r_slot[j] = T;
      r_delta[j] = 0;
      return;
    }
    const double* p = PRT + (size_t)s.own * 5;
    const int r_y = (int)p[0] + s.within;
    r_slot[j] = (int)p[1] + (r_y - (int)p[2]) * (int)p[3];
    r_delta[j] = (int)p[4];
  }
};

template <class Body>
__global__ void __launch_bounds__(Body::kBlock)
expand_kernel(const int* __restrict__ incl, const int* __restrict__ counts, int R, int out_cap,
              Body body) {
  constexpr int B = Body::kBlock;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_incl = (int*)smem;  // [B] the window's prefix entries
  int* s_cnt = s_incl + B;   // [B] and counts
  unsigned char* s_body = smem + 2 * B * sizeof(int);
  __shared__ int s_own[2];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * B;
  // Slots at or past the total are invalid whatever their owner, so the
  // window ends at the CTA's last slot below it.
  const int jend = min(min(out_cap, incl[R - 1]), j0 + B);
  if (tid < 64 && j0 < jend) {
    const int own = warp_upper_bound(incl, R, tid < 32 ? j0 : jend - 1);
    if ((tid & 31) == 0) s_own[tid >> 5] = own;
  }
  __syncthreads();
  const int first = j0 < jend ? s_own[0] : 0;
  const int W = j0 < jend ? s_own[1] - first + 1 : 0;
  const bool staged = W <= B;
  if (staged) {
    for (int t = tid; t < W; t += B) {
      s_incl[t] = incl[first + t];
      s_cnt[t] = counts[first + t];
    }
    body.stage(first, W, s_cnt, s_body);
  }
  __syncthreads();
  Slot s{j0 + tid, R - 1, -1, 0, false, j0 + tid < out_cap};
  if (s.j < jend) {
    // The first owner in [first, first + W) whose prefix passes j.
    int lo = 0, hi = W - 1, inc, cnt;
    if (staged) {
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_incl[mid] > s.j) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      s.t = lo;
      inc = s_incl[lo];
      cnt = s_cnt[lo];
    } else {
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (incl[first + mid] > s.j) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      inc = incl[first + lo];
      cnt = counts[first + lo];
    }
    s.own = first + lo;
    s.within = s.j - (inc - max(cnt, 1));
    s.valid = s.within >= 0 && s.within < cnt;
  }
  body(s, s_body);
}

// The prefix into scratch[0, R) (scratch[R, R + tiles) holds the tiles'
// totals) and *total, then the expansion into out_cap slots.
template <class Body>
int launch(const void* counts, int R, int out_cap, void* scratch, void* total, const Body& body,
           void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (R + kScanTile - 1) / kScanTile;
  int* incl = (int*)scratch;
  unsigned* sums = (unsigned*)(incl + R);
  if (tiles > 1) {
    scan_reduce<Body::kClamp><<<tiles, kScanThreads, 0, st>>>((const int*)counts, R, sums);
  }
  scan_apply<Body::kClamp><<<tiles, kScanThreads, 0, st>>>((const int*)counts, R, sums, incl,
                                                           (int*)total);
  if (out_cap > 0) {
    const size_t smem = 2 * Body::kBlock * sizeof(int) + body.smem_bytes();
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          expand_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    expand_kernel<Body><<<(out_cap + Body::kBlock - 1) / Body::kBlock, Body::kBlock, smem, st>>>(
        incl, (const int*)counts, R, out_cap, body);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry: counts [R] i32; scratch [R + ceil(R / kScanTile)] i32 (the
// prefix and the tiles' totals); total [] i32, written with the prefix.
extern "C" int jello_expand_euler(const void* table, const void* rec, const void* counts,
                                  void* scratch, void* total, void* x0, void* y0, void* x1,
                                  void* y1, void* path, void* valid, int NW, int IT, int EC,
                                  int sentinel_path, void* stream) {
  EulerBody body{(const float*)table, (const float*)rec, NW, IT, sentinel_path, (float*)x0,
                 (float*)y0, (float*)x1, (float*)y1, (int*)path, (bool*)valid};
  return launch(counts, NW, EC, scratch, total, body, stream);
}

extern "C" int jello_expand_crossings(const void* P, const void* counts, void* scratch,
                                      void* total, void* x0, void* y0, void* x1, void* y1,
                                      void* y_edge, void* tile_slot, void* bump_slot,
                                      void* bump_delta, int L, int SC, int T, void* stream) {
  CrossingBody body{(const double*)P, T, (double*)x0, (double*)y0, (double*)x1, (double*)y1,
                    (double*)y_edge, (int*)tile_slot, (int*)bump_slot, (int*)bump_delta};
  return launch(counts, L, SC, scratch, total, body, stream);
}

extern "C" int jello_expand_rows(const void* PRT, const void* counts, void* scratch, void* total,
                                 void* r_slot, void* r_delta, int L, int RC, int T,
                                 void* stream) {
  RowBody body{(const double*)PRT, T, (int*)r_slot, (int*)r_delta};
  return launch(counts, L, RC, scratch, total, body, stream);
}
