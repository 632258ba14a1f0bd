// Kernel K: the drop scatter.
//
// Replaces no Pallas kernel: jello_tpu's scatters are XLA's
// (`.at[idx].set/add/max/min(mode="drop")`). The port ran them as torch's
// `scatter_`, `scatter_add_` and `scatter_reduce_` behind
// pipeline/ops.py, which first send every out-of-range index to a dump row
// appended to a copy of the target. Then each dropped entry, and each
// entry of a stream's padding that the stages park on a dump bin of their
// own (path_count's slot T, coarse's GRID), does one atomic read-modify-
// write on one address, and same-address atomics retire one at a time at
// the L2: a few million of them took ~2 ms of a frame at the benchmark's
// `motionmark_paths`, where the bytes take ~0.01 ms.
//
// The contract (pipeline/ops.py::drop_scatter_plain): out = a copy of the
// target [n, w] (32-bit words), then for each entry j of the m-long index
// with 0 <= idx[j] < n, row idx[j] of out combined with row j of the
// values by the op: set (one of the values wins where targets repeat),
// int32 add (wrapping), int32 max and min, float32 max (a NaN value wins,
// a NaN already there stays, as torch's CPU `scatter_reduce` amax keeps
// them); an index outside [0, n) is dropped.
//
// The design, for this card:
// - Drop, don't dump: an entry out of range does no memory operation but
//   its index load, and a warp whose entries are all out of range skips
//   the rest. An add of zero is dropped too (x + 0 == x), which takes the
//   padding parked on a dump bin off the atomics.
// - Warp-aggregated atomics: the lanes of a warp that share a target
//   (`__match_any_sync`) combine their rows in registers over log2 steps
//   of shuffles, and the lowest lane of each group issues the atomics,
//   one a column. A max or min first reads the target from L2 and skips
//   the atomic when the value cannot change it (a target only grows
//   under max, so a stale read errs on the safe side); float max is a
//   compare-and-swap loop on the same rule.
// - Rows: one entry a thread; rows of 2, 4, 8 and 16 words move as
//   vector loads and stores where the wrapper found them aligned.
// - Bits: integer add, max and min are exact in any order, and a store to
//   a target no other entry names is exact, so every integer result
//   equals the plain version's. Float max differs from it only in which
//   of +0 and -0 (or which NaN's payload) stays where they compete, which
//   torch's own order leaves open too.
//
// The entry copies the target into the output with one cudaMemcpyAsync
// and launches one kernel, both on the caller's stream; it allocates
// nothing, so it runs alike eagerly and inside a captured frame.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

enum : int { kSet = 0, kAdd = 1, kMax = 2, kMin = 3, kFMax = 4 };  // cuda/scatter.py _CODES

template <int Op>
__device__ __forceinline__ int combine(int a, int b) {
  if (Op == kAdd) return (int)((unsigned)a + (unsigned)b);
  if (Op == kMax) return max(a, b);
  if (Op == kMin) return min(a, b);
  // kFMax on the words' float values: the plain version's
  // `isnan(src) ? src : std::max(self, src)`, a = self, b = src.
  const float fa = __int_as_float(a), fb = __int_as_float(b);
  return fb != fb ? b : (fa < fb ? b : a);
}

// Row j of the values, W words (W = 0: one word at column c of a row of
// w, for rows of any other width).
template <int W>
struct Row {
  int v[W > 0 ? W : 1];
};

template <int W>
__device__ __forceinline__ void load_row(const int* p, Row<W>& r) {
  if (W >= 4) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const int4 q = reinterpret_cast<const int4*>(p)[k];
      r.v[4 * k] = q.x;
      r.v[4 * k + 1] = q.y;
      r.v[4 * k + 2] = q.z;
      r.v[4 * k + 3] = q.w;
    }
  } else if (W == 2) {
    const int2 q = *reinterpret_cast<const int2*>(p);
    r.v[0] = q.x;
    r.v[1] = q.y;
  } else {
    r.v[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void store_row(int* p, const Row<W>& r) {
  if (W >= 4) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      reinterpret_cast<int4*>(p)[k] =
          make_int4(r.v[4 * k], r.v[4 * k + 1], r.v[4 * k + 2], r.v[4 * k + 3]);
    }
  } else if (W == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(r.v[0], r.v[1]);
  } else {
    *p = r.v[0];
  }
}

// Each lane's row combined with those of the lanes above it in its group
// of peers (the lanes whose target it shares); the group's lowest lane
// ends with the whole group's. A tree over the lanes' ranks in the group:
// at step s a lane adds the next lane still in the group, then the lanes
// whose rank has bit s set leave it. Every lane takes part in every
// shuffle, whatever its group.
template <int Op, int N>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane, int (&v)[N]) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFull, above != 0)) {
    const int next = __ffs(above) - 1;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const int t = __shfl_sync(kFull, v[c], next & 31);
      if (next >= 0) v[c] = combine<Op>(v[c], t);
    }
    above &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
}

// One word combined into out[p] by an atomic, skipped where it would
// change nothing.
template <int Op>
__device__ __forceinline__ void combine_into(int* p, int v) {
  if (Op == kAdd) {
    if (v != 0) atomicAdd(p, v);
  } else if (Op == kMax) {
    if (__ldcg(p) < v) atomicMax(p, v);
  } else if (Op == kMin) {
    if (__ldcg(p) > v) atomicMin(p, v);
  } else {
    int old = __ldcg(p);
    for (;;) {
      const int want = combine<kFMax>(old, v);
      if (want == old) break;
      const int seen = atomicCAS(p, old, want);
      if (seen == old) break;
      old = seen;
    }
  }
}

template <class Idx, int Op, int W>
__global__ void __launch_bounds__(kThreads)
drop_scatter_kernel(const Idx* __restrict__ idx, const int* __restrict__ vals,
                    int* __restrict__ out, long long m, long long n, int w) {
  constexpr int kCols = W > 0 ? W : 1;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  // Warp-uniform bounds: every lane runs every step, as the shuffles need.
  for (long long base = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31); base < m;
       base += stride) {
    const long long j = base + lane;
    const long long t = j < m ? (long long)idx[j] : -1;
    const bool in_range = t >= 0 && t < n;
    if (!__any_sync(kFull, in_range)) continue;
    for (int c0 = 0; c0 < (W > 0 ? 1 : w); ++c0) {
      const long long src = W > 0 ? j * W : j * w + c0;
      const long long dst = W > 0 ? t * W : t * w + c0;
      Row<W> r;
      if (in_range) {
        load_row<W>(vals + src, r);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) r.v[c] = 0;
      }
      if (Op == kSet) {
        if (in_range) store_row<W>(out + dst, r);
        continue;
      }
      bool live = in_range;
      if (Op == kAdd) {
        bool any = false;
#pragma unroll
        for (int c = 0; c < kCols; ++c) any |= r.v[c] != 0;
        live = live && any;
      }
      if (!__any_sync(kFull, live)) continue;
      // Lanes with nothing to combine share the key -1 and issue nothing.
      const unsigned peers = __match_any_sync(kFull, live ? (int)t : -1);
      reduce_peers<Op, kCols>(peers, lane, r.v);
      if (live && lane == __ffs(peers) - 1) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) combine_into<Op>(out + dst + c, r.v[c]);
      }
    }
  }
}

template <class Idx, int Op, int W>
void launch(const void* idx, const void* vals, void* out, long long m, long long n, int w,
            cudaStream_t s) {
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  drop_scatter_kernel<Idx, Op, W><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const Idx*>(idx), static_cast<const int*>(vals), static_cast<int*>(out), m,
      n, w);
}

template <class Idx, int Op>
void launch_width(const void* idx, const void* vals, void* out, long long m, long long n,
                  int w, bool vec, cudaStream_t s) {
  switch (vec ? w : (w == 1 ? 1 : 0)) {
    case 1: return launch<Idx, Op, 1>(idx, vals, out, m, n, w, s);
    case 2: return launch<Idx, Op, 2>(idx, vals, out, m, n, w, s);
    case 4: return launch<Idx, Op, 4>(idx, vals, out, m, n, w, s);
    case 8: return launch<Idx, Op, 8>(idx, vals, out, m, n, w, s);
    case 16: return launch<Idx, Op, 16>(idx, vals, out, m, n, w, s);
    default: return launch<Idx, Op, 0>(idx, vals, out, m, n, w, s);
  }
}

template <class Idx>
void launch_op(int op, const void* idx, const void* vals, void* out, long long m, long long n,
               int w, bool vec, cudaStream_t s) {
  switch (op) {
    case kSet: return launch_width<Idx, kSet>(idx, vals, out, m, n, w, vec, s);
    case kAdd: return launch_width<Idx, kAdd>(idx, vals, out, m, n, w, vec, s);
    case kMax: return launch_width<Idx, kMax>(idx, vals, out, m, n, w, vec, s);
    case kMin: return launch_width<Idx, kMin>(idx, vals, out, m, n, w, vec, s);
    default: return launch_width<Idx, kFMax>(idx, vals, out, m, n, w, vec, s);
  }
}

}  // namespace

// target, out [n, w] 32-bit words (out is written whole: the copy, then
// the scatter); idx [m] int32 (idx64 0) or int64 (idx64 1); vals [m, w]
// words; op (0 set, 1 int32 add, 2 int32 max, 3 int32 min, 4 float32
// max); vec 1 when vals and out are aligned for rows of w words as vectors
// (8 bytes for w = 2, 16 for w = 4, 8, 16); stream.
extern "C" int jello_drop_scatter(const void* target, void* out, const void* idx, int idx64,
                                  const void* vals, long long m, long long n, int w, int op,
                                  int vec, void* stream) {
  if (m < 0 || n < 0 || w < 0 || op < kSet || op > kFMax || (idx64 != 0 && idx64 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)n * (size_t)w * sizeof(int);
  if (bytes > 0) {
    const cudaError_t err = cudaMemcpyAsync(out, target, bytes, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (m > 0 && n > 0 && w > 0) {
    if (idx64) {
      launch_op<long long>(op, idx, vals, out, m, n, w, vec != 0, s);
    } else {
      launch_op<int>(op, idx, vals, out, m, n, w, vec != 0, s);
    }
  }
  return (int)cudaGetLastError();
}
