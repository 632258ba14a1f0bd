// Kernel A: per-row fill coverage, in area mode and in the two MSAA
// modes.
//
// Replaces the Pallas kernel jello_tpu/tpu/coverage_pallas.py
// (make_coverage_kernel, pallas_call at :266; wrapper
// compute_area_rows_pallas), both of its bodies. The TPU kernel streams
// C-segment blocks through a one-hot MXU segmented sum (one product a
// sample under MSAA), carries open rows from one grid step to the next
// and fetches the rows' backdrops and rules through a window DMA; blocks
// on Hopper run in no order, so here a row is owned by one CTA from its
// first segment to its store, and nothing is carried between CTAs.
//
// The output is one row of 256 pixels (the 16x16 tile, one thread a
// pixel, the shape of vello's fine.wgsl:824-864) for each slot-rank row;
// the row's segments are the contiguous run [row_start[r], row_end[r])
// of the slot-sorted segment stream ([SC, 8] f32, 32-byte records).
//
// Area mode (AreaBody): the analytic trapezoid winding of each pixel,
// summed over the run, plus the row's backdrop: one float of raw
// winding; the fine kernels apply the fill rule. The arithmetic is
// coverage_pallas.py:139-158 term for term, including the -1e-6 on xmin
// and the division by (xmax0 - xmin), but for one regrouping: the
// numerator b + (d^2 - c^2)/2 - xmin is summed as (b - xmin) + (d - c)(d
// + c)/2. Under a vertical edge the quotient is ~1e-6 over ~1e-6, and in
// float32 the difference of squares loses up to 6% of it (2.5e-2 of a
// pixel's coverage against the float64 numpy oracle on a rectangle at a
// fractional x); regrouped, both terms are exact differences and the row
// stays within 2e-7 of the oracle.
//
// MSAA (MsaaBody<S>, S = 8 or 16; coverage_pallas.py:164-181 and
// 199-208): S winding sums a pixel, one a sample. A segment adds
// -sign(dy) to a sample whose row it crosses left of the sample, and
// sign(dx) once the sample lies at or below the segment's y_edge (the
// zero-width limit of the area terms); each addend is a small integer,
// so the float sums are exact in any order. Then the backdrop is added,
// the sum rounded half to even, the sample is inside by the row's rule
// (odd under even-odd, else nonzero; a clip row arrives with the nonzero
// rule), and the pixel stores the mean over its samples: the row is
// RESOLVED coverage in [0, 1], and the fine kernels read it as it is.
// The sample positions are the patterns of renderer/mask.py, written
// below as compile-time tables: sample i of S lies at ((pattern[i] +
// 0.5) / S, (i + 0.5) / S), all multiples of 1/32 and exact in float32.
//
// What bounds it on an H100: operations. The stream is read once and a
// row writes 1 KB; the work is per (segment, pixel). Most of that work
// does not depend on the pixel's column, only on the segment and the
// pixel's row (and sample), and the function needs it once for each
// such pair, not once for each of the 16 pixels of the row. Config 5's
// rows are short (872,261 segments in 116,367 rows, nearly half of them
// of 1 to 4 segments), so a fixed cost for each row (its bounds, the copy
// of its run, two barriers, the store) would weigh as much as its
// segments.
//
// The design:
//  - Pixel-row terms once. For each staged segment the CTA first
//    computes into shared memory what does not depend on the pixel's
//    column: in area mode dyc, t0*dx, t1*dx and sign(dx) *
//    clip01(py - y_edge + 1) for each of the 16 pixel rows (the two
//    divisions only where dyc != 0, the only place they are used; where
//    dyc == 0 the pixel's whole contribution is the y_edge term, formed
//    once for the pixel row); under MSAA, for each (pixel row, sample), the
//    crossing's x or +inf where the segment does not cross the sample's
//    row, and for each pixel row -sign(dy), or 0 where the segment
//    crosses none of its sample rows or is invalid (the row's pixels then
//    skip it). Each is the same single IEEE operation on the same
//    operands as a per-pixel evaluation, so area rows are bit-equal to
//    it; the y_edge addends of a (pixel row, sample) are summed over the
//    run by the thread that owns the pair, exact since they are integers.
//    Then each pixel thread reads its row's terms (a broadcast: 16
//    threads share a row) and does only the pixel's work: in area mode
//    startx, the trapezoid and its one division where dyc != 0, else one
//    addition; under MSAA `xi < xs` and the sum for each sample. Per
//    pixel the sum runs over the segments in run order, as the plain
//    version's does.
//  - Rows stream, CTAs stay, short rows share a pass. A few persistent
//    CTAs a multiprocessor (as many as registers and shared memory let
//    stay resident) take their rows by grid stride, eight at a time (a
//    batch, whose bounds, backdrops and rules sit in a small table in
//    shared memory, read two batches ahead so that their latency hides).
//    A chunk is as many of a batch's rows as fit in the stage together,
//    their runs packed one after the other, or one piece of a run longer
//    than the stage; the terms are formed for the whole chunk at once and
//    each row is stored as its last segment is summed. So the copy, the
//    two barriers and the term pass are paid once a chunk, not once a row
//    (config 5: nearly half the rows hold 1 to 4 segments). Chunks come
//    into shared memory through 16-byte cp.async, double-buffered: the
//    next chunk is in flight while the current one is computed. A row is
//    never split across CTAs and there are no float atomics.
// Built with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kPixels = 256;
constexpr int kCols = 8;  // x0, y0, x1, y1, y_edge, valid, 0, 0
constexpr int kMaxDevices = 64;

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

// One 16-byte asynchronous copy from device memory into shared memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const float* seg;
  const int* row_start;
  const int* row_end;
  const float* row_bd;
  const int* row_eo;  // null in area mode
  float* out;
  int R;
};

struct Row {
  int start, end;
  float bd;
  int eo;
};

// Row r's bounds, backdrop and rule (zeros past the last row).
__device__ __forceinline__ Row fetch_row(const Args& a, int r) {
  if (r >= a.R) return {0, 0, 0.0f, 0};
  return {__ldg(a.row_start + r), __ldg(a.row_end + r), __ldg(a.row_bd + r),
          a.row_eo ? __ldg(a.row_eo + r) : 0};
}

// A CTA takes its rows (blockIdx.x, + G, + 2G, ...) in batches of
// kBatch; a batch's table lives in shared memory.
constexpr int kBatch = 8;

struct Table {
  int row[kBatch];  // the row, or -1 past the last
  int start[kBatch];
  int len[kBatch];  // run length, 0 for a row without segments
  float bd[kBatch];
  int eo[kBatch];
};

__device__ __forceinline__ void put_row(Table& T, int t, int r, int R, const Row& w) {
  T.row[t] = r < R ? r : -1;
  T.start[t] = w.start;
  T.len[t] = max(w.end - w.start, 0);
  T.bd[t] = w.bd;
  T.eo[t] = w.eo;
}

// What one pass through shared memory holds: rows [t0, t1) of a batch
// whose runs fit in a chunk together, packed one after the other, or
// one piece of a run longer than a chunk (from segment `off` of row t0).
struct Chunk {
  int batch;  // -1: no rows left
  int t0, t1;
  int off;
  int n;      // segments staged
  bool done;  // rows t0..t1-1 end in this chunk
};

// The chunk that starts at segment `off` of row t0 of a batch (or, when
// the batch is spent, at the next batch's first row).
template <int kStage>
__device__ __forceinline__ Chunk make_chunk(const Table* tables, int batch, int t0, int off) {
  const Table* T = &tables[batch % 3];
  if (t0 >= kBatch || T->row[t0] < 0) {
    ++batch;
    t0 = 0;
    off = 0;
    T = &tables[batch % 3];
    if (T->row[0] < 0) return {-1, 0, 0, 0, 0, true};
  }
  const int left = T->len[t0] - off;
  if (left > kStage) return {batch, t0, t0 + 1, off, kStage, false};
  if (off > 0) return {batch, t0, t0 + 1, off, left, true};
  int n = left, t1 = t0 + 1;
  while (t1 < kBatch && T->row[t1] >= 0 && n + T->len[t1] <= kStage) n += T->len[t1++];
  return {batch, t0, t1, 0, n, true};
}

template <int kStage>
__device__ __forceinline__ Chunk next_chunk(const Table* tables, const Chunk& c) {
  return c.done ? make_chunk<kStage>(tables, c.batch, c.t1, 0)
                : make_chunk<kStage>(tables, c.batch, c.t0, c.off + kStage);
}

// Starts the copy of a chunk's segments into a stage buffer (two
// 16-byte pieces a segment, spread over the CTA's threads) as one commit
// group of each thread.
__device__ __forceinline__ void stage_chunk(float* dst, const float* seg, const Table& T,
                                            const Chunk& c) {
  for (int q = threadIdx.x; q < 2 * c.n; q += kPixels) {
    const int p = q >> 1;
    int u = c.t0, lo = 0;
    if (c.off == 0) {
      while (p >= lo + T.len[u]) lo += T.len[u++];
    }
    cp_async16(dst + 4 * q, seg + (size_t)(T.start[u] + c.off + p - lo) * kCols + 4 * (q & 1));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

struct AreaBody {
  static constexpr int kStage = 64;  // segments a chunk
  // Shared: terms [kStage][16], then (x0, valid) [kStage]. A (segment,
  // pixel row) term is (dyc, t0*dx, t1*dx, y_edge term) where dyc != 0;
  // where dyc == 0 the pixel's whole contribution, (0 + y_edge term) *
  // valid, does not depend on its column and stands in the second slot.
  static constexpr size_t kTermBytes = kStage * 16 * sizeof(float4) + kStage * sizeof(float2);

  float4* terms;
  float2* segx;
  float* out;
  float acc;

  __device__ AreaBody(const Args& a, char* smem)
      : terms(reinterpret_cast<float4*>(smem)),
        segx(reinterpret_cast<float2*>(smem + kStage * 16 * sizeof(float4))),
        out(a.out),
        acc(0.0f) {}

  // The (segment, pixel row) terms of the chunk's staged segments.
  __device__ __forceinline__ void row_terms(const float* g, const Chunk& c, const Table&) {
    for (int q = threadIdx.x; q < c.n * 16; q += kPixels) {
      const int j = q >> 4;
      const float py = (float)(q & 15);
      const float* s = g + j * kCols;
      const float sx0 = s[0], sy0 = s[1], sx1 = s[2], sy1 = s[3], sye = s[4], valid = s[5];
      const float dx = sx1 - sx0;
      const float dy = sy1 - sy0;
      const float y = sy0 - py;
      const float y0c = clip01(y);
      const float y1c = clip01(y + dy);
      const float dyc = y0c - y1c;
      const float ye = sign_f(dx) * clip01(py - sye + 1.0f);
      if (dyc != 0.0f) {  // then y + dy != y, so dy != 0
        terms[q] = make_float4(dyc, ((y0c - y) / dy) * dx, ((y1c - y) / dy) * dx, ye);
      } else {
        terms[q] = make_float4(0.0f, (0.0f + ye) * valid, 0.0f, 0.0f);
      }
      if ((q & 15) == 0) segx[j] = make_float2(sx0, valid);
    }
  }

  // Each pixel's sum over staged segments [j0, j1), in run order.
  __device__ __forceinline__ void accumulate(int j0, int j1) {
    const float px = (float)(threadIdx.x & 15);
    const float4* t = terms + (threadIdx.x >> 4);
    for (int j = j0; j < j1; ++j) {
      const float4 w = t[j * 16];
      if (w.x == 0.0f) {
        acc = acc + w.y;
        continue;
      }
      const float2 sv = segx[j];
      const float startx = sv.x - px;
      const float x0 = startx + w.y;
      const float x1 = startx + w.z;
      const float xmin0 = fminf(x0, x1);
      const float xmax0 = fmaxf(x0, x1);
      const float xmin = fminf(xmin0, 1.0f) - 1.0e-6f;
      const float b = fminf(xmax0, 1.0f);
      const float cc = fmaxf(b, 0.0f);
      const float d = fmaxf(xmin, 0.0f);
      const float a = ((b - xmin) + 0.5f * ((d - cc) * (d + cc))) / (xmax0 - xmin);
      const float contrib = a * w.x + w.w;
      acc = acc + contrib * sv.y;
    }
  }

  // The row's store (a row without segments holds 0 + its backdrop).
  __device__ __forceinline__ void finish(int, int r, float bd, int) {
    out[(size_t)r * kPixels + threadIdx.x] = acc + bd;
    acc = 0.0f;
  }
};

template <int S>
struct MsaaBody {
  static constexpr int kStage = 32;
  static constexpr int kPairs = 16 * S;            // (pixel row, sample)
  static constexpr int kSplit = kPixels / kPairs;  // threads a pair: 2 (S = 8) or 1
  // Shared: xi [kStage][16][S]; ns [kStage][16], -sign(dy) where the
  // segment crosses a sample row of the pixel row and is valid, else 0;
  // the y_edge sums of each row of a chunk [kBatch][kSplit][kPairs].
  static constexpr size_t kTermBytes =
      (kStage * 16 * S + kStage * 16 + kBatch * kPixels) * sizeof(float);

  float* xi;
  float* ns;
  float* ye_sum;
  float* out;
  float acc[S];
  float ye;  // this thread's sum of its pair's y_edge addends over the row

  __device__ MsaaBody(const Args& a, char* smem)
      : xi(reinterpret_cast<float*>(smem)),
        ns(xi + kStage * 16 * S),
        ye_sum(ns + kStage * 16),
        out(a.out),
        ye(0.0f) {
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] = 0.0f;
  }

  // The (segment, pixel row, sample) terms of the chunk's staged
  // segments: thread t owns the pair t % kPairs and takes every
  // kSplit-th segment; the S threads of a pixel row are S neighbouring
  // lanes of one warp. A row's y_edge sum is left in its slot when the
  // row ends in this chunk.
  __device__ __forceinline__ void row_terms(const float* g, const Chunk& c, const Table& T) {
    const int pair = threadIdx.x % kPairs;
    const int py = pair / S, i = pair % S;
    const int group = (threadIdx.x & 31) & ~(S - 1);
    const float ys = (float)py + ((float)i + 0.5f) * (1.0f / S);
    int u = c.t0;                                          // the row segment j is in
    int end = c.off == 0 && c.done ? T.len[u] : c.n;  // where row u's segments end
    for (int j = threadIdx.x / kPairs; j < c.n; j += kSplit) {
      while (j >= end) {
        ye_sum[(u - c.t0) * kPixels + threadIdx.x] = ye;
        ye = 0.0f;
        end += T.len[++u];
      }
      const float* s = g + j * kCols;
      const float sx0 = s[0], sy0 = s[1], sx1 = s[2], sy1 = s[3], sye = s[4], valid = s[5];
      const float dx = sx1 - sx0;
      const float dy = sy1 - sy0;
      const bool crossed = (sy0 <= ys) != (sy1 <= ys);
      float x = __int_as_float(0x7f800000);  // +inf: no crossing
      if (crossed) x = sx0 + ((ys - sy0) / dy) * dx;  // then sy0 != sy1, so dy != 0
      xi[(j * 16 + py) * S + i] = x;
      ye = ye + sign_f(dx) * (ys >= sye ? 1.0f : 0.0f) * valid;
      const unsigned row_crossed = (__ballot_sync(0xffffffffu, crossed) >> group)
                                   & (unsigned)((1ull << S) - 1);
      if (i == 0) ns[j * 16 + py] = row_crossed ? -sign_f(dy) * valid : 0.0f;
    }
    if (c.done) {
      for (; u < c.t1; ++u) {
        ye_sum[(u - c.t0) * kPixels + threadIdx.x] = ye;
        ye = 0.0f;
      }
    }
  }

  // Each pixel's S sums over staged segments [j0, j1); a segment that
  // crosses none of the pixel row's sample rows (or is invalid) adds
  // nothing.
  __device__ __forceinline__ void accumulate(int j0, int j1) {
    const float px = (float)(threadIdx.x & 15);
    const int py = threadIdx.x >> 4;
    for (int j = j0; j < j1; ++j) {
      const float w = ns[j * 16 + py];
      if (w == 0.0f) continue;
      const float4* v4 = reinterpret_cast<const float4*>(xi + (j * 16 + py) * S);
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        const float4 v = v4[q];
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * q + k;
          const float xs = px + ((float)sample_pattern<S>(i) + 0.5f) * (1.0f / S);
          acc[i] = acc[i] + (xv[k] < xs ? w : 0.0f);
        }
      }
    }
  }

  // The row in slot `slot` of the chunk: per sample the crossings, the
  // y_edge sums and the backdrop, resolved by the row's rule.
  __device__ __forceinline__ void finish(int slot, int r, float bd, int eo) {
    const int py = threadIdx.x >> 4;
    const float* ys = ye_sum + slot * kPixels + py * S;
    int count = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float w = acc[i];
#pragma unroll
      for (int k = 0; k < kSplit; ++k) w = w + ys[k * kPairs + i];
      const int wi = (int)rintf(w + bd);
      count += (eo != 0 ? (wi & 1) != 0 : wi != 0) ? 1 : 0;
      acc[i] = 0.0f;
    }
    out[(size_t)r * kPixels + threadIdx.x] = (float)count * (1.0f / S);
  }
};

template <class Body>
__global__ void __launch_bounds__(kPixels) coverage_kernel(const Args a) {
  constexpr int kStage = Body::kStage;
  extern __shared__ float4 smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [2][kStage * kCols]
  Table* tables = reinterpret_cast<Table*>(stage + 2 * kStage * kCols);  // [3]
  Body body(a, reinterpret_cast<char*>(tables + 3));
  const int G = gridDim.x;
  const int t = threadIdx.x;
  // Batch b of this CTA holds rows blockIdx.x + (b * kBatch + t) * G,
  // t < kBatch, and its table is tables[b % 3]. The tables of batches 0
  // and 1 are read now; each batch's first chunk writes the table two
  // batches on from rows its threads fetched one batch earlier, so that
  // a table is ready before the chunk that needs it is planned and its
  // rows' latency overlaps a batch's work.
  Row ahead = {0, 0, 0.0f, 0};
  if (t < kBatch) {
    for (int b = 0; b < 2; ++b) {
      const int r = blockIdx.x + (b * kBatch + t) * G;
      put_row(tables[b], t, r, a.R, fetch_row(a, r));
    }
    ahead = fetch_row(a, blockIdx.x + (2 * kBatch + t) * G);
  }
  __syncthreads();
  Chunk c = make_chunk<kStage>(tables, 0, 0, 0);
  if (c.batch < 0) return;
  stage_chunk(stage, a.seg, tables[0], c);
  int buf = 0;
  for (;;) {
    // The next chunk's copy starts before this one is computed.
    const Chunk nc = next_chunk<kStage>(tables, c);
    const bool more = nc.batch >= 0;
    if (more) {
      stage_chunk(stage + (buf ^ 1) * kStage * kCols, a.seg, tables[nc.batch % 3], nc);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c.t0 == 0 && c.off == 0 && t < kBatch) {
      const int r = blockIdx.x + ((c.batch + 2) * kBatch + t) * G;
      put_row(tables[(c.batch + 2) % 3], t, r, a.R, ahead);
      ahead = fetch_row(a, r + kBatch * G);
    }
    const Table& T = tables[c.batch % 3];
    body.row_terms(stage + buf * kStage * kCols, c, T);
    __syncthreads();
    int lo = 0;
    for (int u = c.t0; u < c.t1; ++u) {
      const int hi = c.off == 0 && c.done ? lo + T.len[u] : c.n;
      body.accumulate(lo, hi);
      if (c.done) body.finish(u - c.t0, T.row[u], T.bd[u], T.eo[u]);
      lo = hi;
    }
    if (!more) break;
    c = nc;
    buf ^= 1;
  }
}

template <class Body>
constexpr size_t smem_bytes() {
  return 2 * Body::kStage * kCols * sizeof(float) + 3 * sizeof(Table) + Body::kTermBytes;
}

// Persistent CTAs for this device: resident CTAs a multiprocessor (from
// the kernel's registers and shared memory) times the multiprocessors.
// Found once a device; the first call also lifts the kernel's dynamic
// shared memory limit above 48 KB where it needs that.
template <class Body>
cudaError_t grid_cap(int* cap) {
  static int caps[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (caps[dev] == 0) {
    constexpr size_t smem = smem_bytes<Body>();
    err = cudaFuncSetAttribute(coverage_kernel<Body>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, coverage_kernel<Body>,
                                                        kPixels, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    caps[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  *cap = caps[dev];
  return cudaSuccess;
}

template <class Body>
int launch(const Args& a, cudaStream_t s) {
  if (a.R <= 0) return (int)cudaGetLastError();
  int cap = 0;
  const cudaError_t err = grid_cap<Body>(&cap);
  if (err != cudaSuccess) return (int)err;
  coverage_kernel<Body><<<a.R < cap ? a.R : cap, kPixels, smem_bytes<Body>(), s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jello_coverage_area(const void* seg, const void* row_start,
                                   const void* row_end, const void* row_bd,
                                   void* out, int n_rows, void* stream) {
  const Args a = {(const float*)seg, (const int*)row_start, (const int*)row_end,
                  (const float*)row_bd, nullptr, (float*)out, n_rows};
  return launch<AreaBody>(a, (cudaStream_t)stream);
}

// n_samples: 8 or 16 (anything else is refused). row_eo [n_rows] i32, 1
// where the row resolves by the even-odd rule.
extern "C" int jello_coverage_msaa(const void* seg, const void* row_start,
                                   const void* row_end, const void* row_bd,
                                   const void* row_eo, void* out, int n_rows,
                                   int n_samples, void* stream) {
  if (n_samples != 8 && n_samples != 16) return (int)cudaErrorInvalidValue;
  const Args a = {(const float*)seg, (const int*)row_start, (const int*)row_end,
                  (const float*)row_bd, (const int*)row_eo, (float*)out, n_rows};
  const cudaStream_t s = (cudaStream_t)stream;
  return n_samples == 8 ? launch<MsaaBody<8>>(a, s) : launch<MsaaBody<16>>(a, s);
}

// The persistent grid of a body on the current device (n_samples 0:
// area, 8 or 16): the CTAs one launch starts when it has at least that
// many rows. Returns -1 on a CUDA error.
extern "C" int jello_coverage_grid(int n_samples) {
  int cap = 0;
  const cudaError_t err = n_samples == 0   ? grid_cap<AreaBody>(&cap)
                          : n_samples == 8 ? grid_cap<MsaaBody<8>>(&cap)
                                           : grid_cap<MsaaBody<16>>(&cap);
  return err == cudaSuccess ? cap : -1;
}
