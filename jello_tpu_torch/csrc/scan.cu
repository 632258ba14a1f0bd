// Kernel I: the integer column scan.
//
// Replaces no Pallas kernel: jello_tpu leaves its prefix scans to XLA
// (jnp.cumsum over the stacked monoid columns in pipeline/pathtag.py and
// drawobjs.py, the count tail of pipeline/tiling.py, lax.cummax in
// expand_by_counts, clips and coverage). The port ran them as torch's
// `cumsum`/`cummax` over dim 0 of an [N, k] int32 tensor, which launch
// torch's outer-dimension scan: one thread a column walking all N rows
// in series, so a handful of threads of the card did the work (73 ms of
// an 86 ms frame at config 5).
//
// The contract (pipeline/ops.py::column_scan_plain): k <= 8 int32 columns
// of length N, each through its own pointer, all with one element stride;
// the op is a sum that wraps mod 2^32, as torch's int32 cumsum does, or
// a max (identity INT32_MIN); the output [k, N] holds each column's
// inclusive or exclusive prefix in a contiguous row, and `totals`, where
// given, each column's inclusive value at N - 1 (the identity for N = 0).
// Both ops are associative, so any order of combination gives the same
// bits.
//
// What bounds it on an H100: bytes. Each element is read once and
// written once at least (8 k N bytes), a few MB at config 5, so a few
// microseconds. The design is kernel E's E1 prefix (expand.cu) widened
// to k columns, a column a grid row: a reduce pass writes each tile's
// total when there is more than one tile of kTile elements, and the scan
// pass has each CTA combine the totals of the tiles before it in its own
// column and scan its tile from there. Reduce-then-scan reads the input
// twice, where a single pass with decoupled look-back reads it once but
// needs status words cleared inside the entry and spin-waits between
// CTAs; the second read is at most a third of the bytes. The entry
// allocates nothing and launches on the caller's stream, so it runs
// alike eagerly and inside a captured frame.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // cuda/scan.py TILE
constexpr int kMaxCols = 8;               // cuda/scan.py MAX_COLS

struct Cols {
  const int* ptr[kMaxCols];
};

// Column c's pointer, selected from the parameter without indexing it:
// an indexed parameter array is copied to local memory first.
__device__ __forceinline__ const int* column(const Cols& cols, int c) {
  const int* x = cols.ptr[0];
#pragma unroll
  for (int i = 1; i < kMaxCols; ++i) x = c == i ? cols.ptr[i] : x;
  return x;
}

// The sum, on unsigned words so that it wraps.
struct SumOp {
  static __device__ __forceinline__ int identity() { return 0; }
  static __device__ __forceinline__ int combine(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
  }
  static __device__ __forceinline__ int warp_reduce(int v) {
    return (int)__reduce_add_sync(kFull, (unsigned)v);
  }
};

struct MaxOp {
  static __device__ __forceinline__ int identity() { return INT_MIN; }
  static __device__ __forceinline__ int combine(int a, int b) { return max(a, b); }
  static __device__ __forceinline__ int warp_reduce(int v) { return __reduce_max_sync(kFull, v); }
};

// Shared-memory index of tile entry i, padded so that a thread's kItems
// consecutive entries and a warp's strided ones hit 32 banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ int load(const int* x, int stride, int i) {
  return x[(long long)i * stride];
}

// v combined over the CTA, in every thread. s holds kThreads / 32 words.
template <class Op>
__device__ __forceinline__ int block_reduce(int v, int* s) {
  v = Op::warp_reduce(v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = Op::identity();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t = Op::combine(t, s[w]);
  __syncthreads();
  return t;
}

// partial[c * tiles + b]: column c's tile b combined.
template <class Op>
__global__ void __launch_bounds__(kThreads)
colscan_reduce(Cols cols, int stride, int N, int tiles, int* __restrict__ partial) {
  __shared__ int s_warp[kThreads / 32];
  const int c = blockIdx.y;
  const int* x = column(cols, c);
  const int base = blockIdx.x * kTile;
  int v = Op::identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kThreads + threadIdx.x;
    if (i < N) v = Op::combine(v, load(x, stride, i));
  }
  v = block_reduce<Op>(v, s_warp);
  if (threadIdx.x == 0) partial[(size_t)c * tiles + blockIdx.x] = v;
}

template <class Op, bool kExclusive>
__global__ void __launch_bounds__(kThreads)
colscan_apply(Cols cols, int stride, int N, int tiles, const int* __restrict__ partial,
              int* __restrict__ out, int* __restrict__ totals) {
  __shared__ int s_tile[kTile + kTile / 32];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_wsum[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.y;
  const int* x = column(cols, c);
  const int base = blockIdx.x * kTile;
  // This tile's offset: the tiles before it in this column, combined.
  int off = Op::identity();
  for (int b = tid; b < (int)blockIdx.x; b += kThreads) {
    off = Op::combine(off, partial[(size_t)c * tiles + b]);
  }
  off = block_reduce<Op>(off, s_warp);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    s_tile[pad(i)] = base + i < N ? load(x, stride, base + i) : Op::identity();
  }
  __syncthreads();
  // Each thread's kItems consecutive entries, then the warp's and the
  // CTA's threads before it.
  int loc[kItems];
  int run = Op::identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = Op::combine(run, s_tile[pad(tid * kItems + k)]);
    loc[k] = run;
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = Op::combine(incl, y);
  }
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = Op::identity();
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  int before = off;
  for (int w = 0; w < warp; ++w) before = Op::combine(before, s_wsum[w]);
  before = Op::combine(before, excl);
  const int last = N - 1 - base;  // this tile's entry N - 1, if it holds it
  int prev = before;  // the exclusive value of entry k: the inclusive one of k - 1
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int e = tid * kItems + k;
    const int inclusive = Op::combine(before, loc[k]);
    if (totals != nullptr && e == last) totals[c] = inclusive;
    s_tile[pad(e)] = kExclusive ? prev : inclusive;
    prev = inclusive;
  }
  if (totals != nullptr && N == 0 && tid == 0) totals[c] = Op::identity();
  __syncthreads();
  int* o = out + (size_t)c * N;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    if (base + i < N) o[base + i] = s_tile[pad(i)];
  }
}

template <class Op, bool kExclusive>
int launch(const Cols& cols, int stride, int k, int N, int* out, int* totals,
           int* partial, cudaStream_t st) {
  const int tiles = N > 0 ? (N + kTile - 1) / kTile : 1;
  if (tiles > 1) {
    if (partial == nullptr) return (int)cudaErrorInvalidValue;
    colscan_reduce<Op><<<dim3(tiles, k), kThreads, 0, st>>>(cols, stride, N, tiles, partial);
  }
  colscan_apply<Op, kExclusive><<<dim3(tiles, k), kThreads, 0, st>>>(
      cols, stride, N, tiles, partial, out, totals);
  return (int)cudaGetLastError();
}

}  // namespace

// cols: a host array of k device pointers to int32 columns of N elements,
// each `stride` elements apart; k in [1, 8]; op 0 sum, 1 max; exclusive 0
// or 1; out [k, N] int32; totals [k] int32 or null; partial [k *
// ceil(N / 8192)] int32 (null when N <= 8192); stream.
extern "C" int jello_column_scan(const void* const* cols, int stride, int k, int N, int op,
                                 int exclusive, void* out, void* totals, void* partial,
                                 void* stream) {
  if (k < 1 || k > kMaxCols || N < 0 || stride < 1 || (op != 0 && op != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Cols c{};
  for (int i = 0; i < k; ++i) c.ptr[i] = static_cast<const int*>(cols[i]);
  int* o = static_cast<int*>(out);
  int* t = static_cast<int*>(totals);
  int* p = static_cast<int*>(partial);
  const cudaStream_t st = (cudaStream_t)stream;
  if (op == 0) {
    return exclusive ? launch<SumOp, true>(c, stride, k, N, o, t, p, st)
                     : launch<SumOp, false>(c, stride, k, N, o, t, p, st);
  }
  return exclusive ? launch<MaxOp, true>(c, stride, k, N, o, t, p, st)
                   : launch<MaxOp, false>(c, stride, k, N, o, t, p, st);
}
