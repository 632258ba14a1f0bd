// Kernels G and H: the per-tile command interpreter.
//
// Replace the Pallas kernels of jello_tpu/tpu/fine_pallas.py:
// make_fine_kernel (pallas_call at :567, one tile a program) and
// make_fine_kernel_b8 (pallas_call at :1079, eight tiles a program in
// lockstep). They render the tiles whose tape the record-stream kernel B
// cannot express: nested clips and mix/compose blend groups (and image
// paints, where no image tap feeds B).
//
// The TPU kernel fetches a coverage row through an 8-row DMA window,
// samples images through a 64x256 window DMA and one-hot MXU products,
// masks with f32 because booleans do not select on its vectors, and
// unrolls the blend stack into BD masked selects. None of that has a
// reason on Hopper, and none of it is carried over.
//
// The record step (both kernels): a thread keeps its pixels'
// premultiplied rgba and `area` (the resolved coverage, which carries
// over from record to record: a BeginClip does not set it, an EndClip
// sets it from its own row by the nonzero rule, a rowless fill sets 1, a
// suppressed record leaves it; it starts at 0) in registers; clip depth,
// blend depth, the clip-zero suppression depth and the overflow bits
// are registers too, the same in every thread of a tile, so the switch on
// the record kind does not diverge. Coverage is the row at word 1; with
// `resolved` set (an MSAA frame) the row is kernel A's resolved coverage
// and is clipped to [0, 1] whatever the record's rule and kind
// (fine_pallas.py:292-293, 767-768). Gradients are kernel B's device
// code (paint.cuh); an image record gathers its four texels from the
// L2-resident planar atlas as kernel F does, under the interpreter's own
// region contract: one 64x256 window at x_lo = clip(rx0 / 128 * 128, 0,
// AWp - 256), y_lo = clip(ry0 / 8 * 8, 0, AHp - 64); a record whose
// corner extent leaves it (rx1 - x_lo >= 256 or ry1 - y_lo >= 64) paints
// nothing and sets overflow bit 1, so that the port and the reference
// reroute the same frames. The extent comes from the tile's four corner
// pixels (paint.cuh, image_tap_corner_extent): any thread has it, with no
// reduction and no barrier. A push past BD sets overflow bit 0 and
// overwrites the top level; the renderer doubles BD and runs the frame
// again.
//
// G: one CTA a slot (the hardware hands slots to multiprocessors as CTAs
// finish, which evens out tapes of 2 to 37 records), 128 threads of two
// consecutive pixels of one tile row each. A CTA stages its tape,
// up to 32 records (2 KB) at a time, in shared memory with 16-byte
// cp.async and one barrier, then walks it with no barrier: a record's
// control step (depths, overflow) runs first, so the next record's
// coverage row (a coalesced 1 KB, one vector load a thread; nothing for a
// suppressed or rowless record) is in flight while this record paints
// and blends. The blend stack is [BD][4][256] floats, 4 KB a level, each
// thread touching only its own pixels (vector accesses, no barrier): its
// first kSmemLevels levels live in the CTA's dynamic shared memory; a
// tile that pushes deeper claims a row of a global scratch [rows][BD -
// kSmemLevels][4][256] from a pool (g_row_pool) and gives it back when it
// ends, so the scratch is sized by the CTAs resident at once and not by
// the slots, and a tile that stays shallow never touches it. The output
// row is written with vector stores.
//
// H: a CTA of 256 threads walks eight slots in lockstep, record index by
// record index up to the longest of its eight tapes, a thread holding
// its pixel of all eight tiles in registers and each record staged in
// shared memory between two barriers. Eight stacks at BD 8 are 256 KB,
// more than a CTA's shared memory, so H keeps its stacks in a global
// scratch [n][BD][4][256]; every access is a coalesced 1 KB row private
// to the CTA.
//
// What bounds it on an H100: per record 64 B of tape, 1 KB of coverage
// for a fill, and per push or pop 4 KB of stack traffic; per slot 4 KB
// written: 44 MB at config 4, 13 us at the card's memory rate. The
// instructions take longer: config 4's legacy tiles walk ~10 records each,
// most of them BeginClip/EndClip pairs, and an EndClip's blend and a
// gradient's colour math are tens to hundreds of instructions a pixel,
// issued once for each of the tile's 256 pixels. So the kernel is bound
// by issue, and its design spends fewer instructions a pixel (the
// control step and the record's words once for kPx pixels, no barrier a
// record) while keeping enough warps resident. Rounding follows the
// reference: no contraction (-fmad=false), IEEE division and roots,
// rintf; a pixel sees the same operations in the same order in G and H.

#include <climits>

#include <cuda_runtime.h>

#include "blend.cuh"
#include "paint.cuh"

namespace {

using namespace jello;

constexpr int kBatchTiles = 8;               // H: tiles a CTA
constexpr int kTileThreads = 128;            // G: threads a tile
constexpr int kPx = kPixels / kTileThreads;  // G: pixels a thread
constexpr int kChunk = 32;                   // G: records staged at once
constexpr int kSmemLevels = 4;               // G: stack levels in shared memory
constexpr int kMaxDevices = 16;

// Control state of one tape: uniform over the tile's threads.
struct Ctl {
  int clip_depth;
  int blend_depth;
  int zero_depth;  // > 0: suppressed until the EndClip at this depth
  int ovf;         // bit 0 blend depth, bit 1 image region
};

struct Tables {
  const float* rows;
  const float* stops;
  const float* atlas;
  int n_rows, n_ramp_rows, row_w, BD, AHp, AWp;
  int resolved;  // rows are resolved coverage (MSAA), not raw winding
};

// Whether record w reads its coverage row, given the suppression depth
// before it.
__device__ __forceinline__ bool reads_row(const int* w, int zero_depth) {
  const int kind = w[0];
  return zero_depth == 0 && ((kind >= CMD_COLOR && kind <= CMD_IMAGE) || kind == CMD_END_CLIP) &&
         w[2] > 0;
}

// PX consecutive floats at p (16-, 8- or 4-byte aligned), and their store.
template <int PX>
__device__ __forceinline__ void load_px(const float* p, float (&a)[PX]) {
  if constexpr (PX == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    a[0] = q.x; a[1] = q.y; a[2] = q.z; a[3] = q.w;
  } else if constexpr (PX == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    a[0] = q.x; a[1] = q.y;
  } else {
    a[0] = *p;
  }
}

template <int PX>
__device__ __forceinline__ void store_px(float* p, const float (&a)[PX]) {
  if constexpr (PX == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else if constexpr (PX == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
    *p = a[0];
  }
}

// A thread's PX consecutive pixels of record w's row (word 1).
template <int PX>
__device__ __forceinline__ void load_row(const Tables& tb, const int* w, int p0, float (&a)[PX]) {
  load_px<PX>(tb.rows + (size_t)clamp_i(w[1], 0, tb.n_rows - 1) * kPixels + p0, a);
}

// The control part of one record: the clip, suppression and blend depths
// after it, and overflow bit 0 on a push past BD. Returns the stack
// level the record pushes to (*push) or pops from, or -1. The
// suppression state reads the depth before this record.
__device__ __forceinline__ int control_step(const int* w, Ctl& c, int BD, bool* push) {
  const int kind = w[0];
  const bool sup = c.zero_depth > 0;
  const bool is_begin = kind == CMD_BEGIN_CLIP;
  const bool is_end = kind == CMD_END_CLIP;
  const bool begin_zero = is_begin && w[2] < 0;
  if (sup && is_end && c.clip_depth == c.zero_depth) c.zero_depth = 0;
  if (!sup && begin_zero) c.zero_depth = c.clip_depth + 1;
  c.clip_depth += (is_begin ? 1 : 0) - (is_end ? 1 : 0);
  *push = !sup && is_begin && !begin_zero;
  if (*push) {
    if (c.blend_depth >= BD) c.ovf |= 1;
    const int level = clamp_i(c.blend_depth, 0, BD - 1);
    c.blend_depth += 1;
    return level;
  }
  if (!sup && is_end) {
    c.blend_depth -= 1;
    return clamp_i(c.blend_depth, 0, BD - 1);
  }
  return -1;
}

// The pixel part of one record for a thread's PX pixels: coverage, paint,
// push or pop-and-blend. `sup` is the suppression before the record, `a`
// its row (read where reads_row says so), `lvl` the thread's column of
// the stack level control_step named (null: none), (ox, oy) the tile's
// first pixel.
template <int PX>
__device__ __forceinline__ void pixel_step(const int* w, bool sup, float* lvl, bool push,
                                           const float (&a)[PX], const float (&gx)[PX],
                                           const float (&gy)[PX], float (&v)[PX][4],
                                           float (&area)[PX], int& ovf, const Tables& tb,
                                           int ox, int oy) {
  const float* f = reinterpret_cast<const float*>(w);
  const int kind = w[0];
  const bool is_end = kind == CMD_END_CLIP;
  const bool paints = !sup && kind >= CMD_COLOR && kind <= CMD_IMAGE;

  if (paints || (!sup && is_end)) {
    const bool rowed = w[2] > 0;
    const bool even_odd = (w[4] & 1) != 0 && !is_end;
#pragma unroll
    for (int j = 0; j < PX; ++j)
      area[j] = !rowed ? 1.0f : tb.resolved ? resolved_coverage(a[j]) : fill_rule(a[j], even_odd);
  }

  if (paints) {
    bool taps = false;  // an image record inside its region window
    if (kind == CMD_IMAGE && tb.atlas != nullptr) {
      int rx0, ry0, rx1, ry1, x_lo, y_lo;
      image_tap_corner_extent(w, ox, oy, &rx0, &ry0, &rx1, &ry1);
      image_region_origin(rx0, ry0, tb.AHp, tb.AWp, &x_lo, &y_lo);
      const bool bad = (rx1 - x_lo) >= REGW || (ry1 - y_lo) >= REGH;
      if (bad) ovf |= 2;
      taps = !bad;
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      float fg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kind == CMD_COLOR) {
        fg[0] = f[5]; fg[1] = f[6]; fg[2] = f[7]; fg[3] = f[8];
      } else if (kind == CMD_IMAGE) {
        if (taps) {
          const Tap t = image_tap_corners(w, gx[j], gy[j]);
          if (t.inb) image_tap_gather(tb.atlas, tb.AHp, tb.AWp, t, fg);
        }
      } else {
        gradient_fg(kind, w, gx[j], gy[j], tb.stops, tb.n_ramp_rows, tb.row_w, fg);
      }
      const float fa = fg[3] * area[j];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) v[j][ch] = v[j][ch] * (1.0f - fa) + fg[ch] * area[j];
    }
  }

  if (lvl == nullptr) return;
  if (push) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      float c[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        c[j] = v[j][ch];
        v[j][ch] = 0.0f;
      }
      store_px<PX>(lvl + ch * kPixels, c);
    }
    return;
  }
  float bg[PX][4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float c[PX];
    load_px<PX>(lvl + ch * kPixels, c);
#pragma unroll
    for (int j = 0; j < PX; ++j) bg[j][ch] = c[j];
  }
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const float a_cov = area[j] * f[6];
    float src[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) src[ch] = v[j][ch] * a_cov;
    blend_mix_compose_f(bg[j], src, w[5], v[j]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Scratch rows of G's deep stack levels: bit r of the device's pool is
// set while a CTA holds row r. A CTA claims a row at its first push past
// its shared levels and gives it back when it ends, so that a row is
// never held by two CTAs and the pool never needs more rows than the
// CTAs resident at once (kernel launches on one stream at a time; every
// CTA gives back what it took, so the pool is empty between launches).
constexpr int kPoolWords = 1024;
__device__ unsigned g_row_pool[kPoolWords];

__device__ int claim_row(int rows) {
  const int words = (rows + 31) >> 5;
  for (int i = blockIdx.x % words;; i = i + 1 == words ? 0 : i + 1) {
    const int valid = min(32, rows - 32 * i);
    const unsigned mask = valid == 32 ? 0xFFFFFFFFu : (1u << valid) - 1u;
    unsigned free_bits = ~atomicOr(&g_row_pool[i], 0u) & mask;
    while (free_bits != 0u) {
      const unsigned bit = free_bits & (0u - free_bits);
      const unsigned old = atomicOr(&g_row_pool[i], bit);
      if ((old & bit) == 0u) return 32 * i + (__ffs((int)bit) - 1);
      free_bits = ~old & mask;
    }
  }
}

// Kernel G: one CTA a slot, kTileThreads threads of kPx consecutive pixels
// of one tile row each. Dynamic shared memory: the staged tape [kChunk][16]
// i32, then `levels` stack levels [levels][4][256] f32. scratch: [rows][BD
// - levels][4][256] f32, one row claimed from the pool by a tile that
// pushes past `levels`; null when BD <= levels.
__global__ void __launch_bounds__(kTileThreads)
interp_tile_kernel(const int* __restrict__ counts, const int* __restrict__ tile_ids,
                   const float* __restrict__ base, const int* __restrict__ slab,
                   float* __restrict__ scratch, float* __restrict__ out, int* __restrict__ ovf,
                   Tables tb, int MC, int wit, int levels, int rows) {
  extern __shared__ float4 smem[];
  __shared__ int claimed;
  int* tape = reinterpret_cast<int*>(smem);
  const int t = threadIdx.x;
  const int p0 = t * kPx;
  const int slot = blockIdx.x;
  float* stack = reinterpret_cast<float*>(smem + kChunk * 4) + p0;
  float* deep = nullptr;  // this tile's scratch row, once claimed

  const int tile = __ldg(tile_ids + slot);
  const int count = min(__ldg(counts + slot), MC);
  const int ox = (tile % wit) * 16, oy = (tile / wit) * 16;
  float gx[kPx], gy[kPx], v[kPx][4], area[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    gx[j] = (float)((p0 + j) & 15) + (float)ox;
    gy[j] = (float)((p0 + j) >> 4) + (float)oy;
    area[j] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) v[j][ch] = __ldg(base + ch);
  }
  Ctl c{0, 0, 0, 0};

  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int nc = min(kChunk, count - c0);
    if (c0 > 0) __syncthreads();  // every thread is done with the last chunk
    const int4* src = reinterpret_cast<const int4*>(slab + ((size_t)slot * MC + c0) * 16);
    for (int k = t; k < nc * 4; k += kTileThreads) cp_async16(tape + 4 * k, src + k);
    cp_async_wait_all();
    __syncthreads();
    float a[kPx] = {};
    if (reads_row(tape, c.zero_depth)) load_row<kPx>(tb, tape, p0, a);
    for (int ci = 0; ci < nc; ++ci) {
      const int* w = tape + ci * 16;
      const bool sup = c.zero_depth > 0;
      bool push;
      const int level = control_step(w, c, tb.BD, &push);
      // The next record's row, in flight while this one paints.
      float a_next[kPx] = {};
      if (ci + 1 < nc && reads_row(w + 16, c.zero_depth)) load_row<kPx>(tb, w + 16, p0, a_next);
      if (level >= levels && deep == nullptr) {  // uniform: the tile's first deep push
        if (t == 0) {
          claimed = claim_row(rows);
          __threadfence();
        }
        __syncthreads();
        deep = scratch + (size_t)claimed * (tb.BD - levels) * 4 * kPixels + p0;
      }
      float* lvl = level < 0        ? nullptr
                   : level < levels ? stack + (size_t)level * 4 * kPixels
                                    : deep + (size_t)(level - levels) * 4 * kPixels;
      pixel_step<kPx>(w, sup, lvl, push, a, gx, gy, v, area, c.ovf, tb, ox, oy);
#pragma unroll
      for (int j = 0; j < kPx; ++j) a[j] = a_next[j];
    }
  }

  float* o = out + (size_t)slot * 4 * kPixels + p0;
  float inv[kPx], q[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) inv[j] = 1.0f / fmaxf(v[j][3], 1e-6f);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
    for (int j = 0; j < kPx; ++j) q[j] = ch < 3 ? v[j][ch] * inv[j] : v[j][3];
    store_px<kPx>(o + ch * kPixels, q);
  }
  if (t == 0) ovf[slot] = c.ovf;
  if (deep != nullptr) {  // give the row back once every thread's stores are out
    __threadfence();
    __syncthreads();
    if (t == 0) atomicAnd(&g_row_pool[claimed >> 5], ~(1u << (claimed & 31)));
  }
}

// Kernel H: eight slots a CTA in lockstep, one pixel of each a thread;
// scratch [n][BD][4][256] f32.
__global__ void __launch_bounds__(kPixels)
interp_batch_kernel(const int* __restrict__ counts, const int* __restrict__ tile_ids,
                    const float* __restrict__ base, const int* __restrict__ slab,
                    float* __restrict__ scratch, float* __restrict__ out,
                    int* __restrict__ ovf, Tables tb, int MC, int wit) {
  __shared__ int w[kBatchTiles][16];
  const int p = threadIdx.x;
  const int slot0 = blockIdx.x * kBatchTiles;

  float v[kBatchTiles][1][4], area[kBatchTiles][1], gx[kBatchTiles][1], gy[kBatchTiles][1];
  int n[kBatchTiles], ox[kBatchTiles], oy[kBatchTiles];
  Ctl ctl[kBatchTiles];
  int n_max = 0;
#pragma unroll
  for (int k = 0; k < kBatchTiles; ++k) {
    const int t = tile_ids[slot0 + k];
    n[k] = min(counts[slot0 + k], MC);
    n_max = max(n_max, n[k]);
    ox[k] = (t % wit) * 16;
    oy[k] = (t / wit) * 16;
    gx[k][0] = (float)(p & 15) + (float)ox[k];
    gy[k][0] = (float)(p >> 4) + (float)oy[k];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) v[k][0][ch] = base[ch];
    area[k][0] = 0.0f;
    ctl[k] = Ctl{0, 0, 0, 0};
  }

  for (int ci = 0; ci < n_max; ++ci) {
    __syncthreads();
    if (p < kBatchTiles * 16) {
      const int k = p >> 4;
      w[k][p & 15] = slab[((size_t)(slot0 + k) * MC + ci) * 16 + (p & 15)];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBatchTiles; ++k) {
      if (ci < n[k]) {
        const bool sup = ctl[k].zero_depth > 0;
        float a[1] = {0.0f};
        if (reads_row(w[k], ctl[k].zero_depth)) load_row<1>(tb, w[k], p, a);
        bool push;
        const int level = control_step(w[k], ctl[k], tb.BD, &push);
        float* lvl = level < 0 ? nullptr
                               : scratch + ((size_t)(slot0 + k) * tb.BD + level) * 4 * kPixels + p;
        pixel_step<1>(w[k], sup, lvl, push, a, gx[k], gy[k], v[k], area[k], ctl[k].ovf, tb,
                      ox[k], oy[k]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kBatchTiles; ++k) {
    const float inv_a = 1.0f / fmaxf(v[k][0][3], 1e-6f);
    float* o = out + (size_t)(slot0 + k) * 4 * kPixels + p;
    o[0] = v[k][0][0] * inv_a;
    o[kPixels] = v[k][0][1] * inv_a;
    o[2 * kPixels] = v[k][0][2] * inv_a;
    o[3 * kPixels] = v[k][0][3];
    if (p == 0) ovf[slot0 + k] = ctl[k].ovf;
  }
}

// G's stack levels in shared memory at blend depth BD, and its dynamic
// shared memory at that many levels.
int tile_levels(int BD) { return BD < kSmemLevels ? BD : kSmemLevels; }

size_t tile_smem(int levels) {
  return (size_t)kChunk * 16 * sizeof(int) + (size_t)levels * 4 * kPixels * sizeof(float);
}

// G's CTAs resident on a multiprocessor at `levels` shared levels, and
// the multiprocessors, of the current device (cached).
cudaError_t tile_residency(int levels, int* per_sm, int* sms) {
  static int cache[kMaxDevices][kSmemLevels + 1][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || levels < 0 || levels > kSmemLevels) return cudaErrorInvalidValue;
  int* e = cache[dev][levels];
  if (e[0] == 0) {
    int nb = 0, m = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, interp_tile_kernel, kTileThreads,
                                                        tile_smem(levels));
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    e[1] = m;
    e[0] = nb > 0 ? nb : 1;
  }
  *per_sm = e[0];
  *sms = e[1];
  return cudaSuccess;
}

// Scratch rows kernel G may hold at once: its resident CTAs, at most n.
cudaError_t tile_scratch_rows(int n, int levels, int* rows) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = tile_residency(levels, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  const int resident = per_sm * sms;
  if (resident > 32 * kPoolWords) return cudaErrorInvalidValue;
  *rows = n < resident ? n : resident;
  return cudaSuccess;
}

}  // namespace

// counts [n] i32 (any words after the first n are not read), tile_ids [n]
// i32, base [4] f32, slab [n, MC, 16] i32 (16-byte aligned), rows
// [n_rows, 256] f32 (16-byte aligned), stops [NR, W] f32, atlas [4, AHp,
// AWp] f32 or null, scratch (jello_fine_interp_scratch's floats) or null
// where that is 0, out [n, 4, 256] f32, ovf [n] i32. batch != 0 launches
// H and needs n % 8 == 0; resolved != 0: the rows are resolved coverage.
extern "C" int jello_fine_interp(const void* counts, const void* tile_ids, const void* base,
                                 const void* slab, const void* rows, const void* stops,
                                 const void* atlas, void* scratch, void* out, void* ovf,
                                 int n, int MC, int n_rows, int n_ramp_rows, int row_w,
                                 int wit, int BD, int AHp, int AWp, int batch,
                                 int resolved, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const Tables tb{(const float*)rows, (const float*)stops, (const float*)atlas,
                  n_rows, n_ramp_rows, row_w, BD, AHp, AWp, resolved};
  const cudaStream_t s = (cudaStream_t)stream;
  if (batch != 0) {
    if (n % kBatchTiles != 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
    interp_batch_kernel<<<n / kBatchTiles, kPixels, 0, s>>>(
        (const int*)counts, (const int*)tile_ids, (const float*)base, (const int*)slab,
        (float*)scratch, (float*)out, (int*)ovf, tb, MC, wit);
    return (int)cudaGetLastError();
  }
  const int levels = tile_levels(BD);
  int pool = 0;
  if (BD > levels) {
    const cudaError_t err = tile_scratch_rows(n, levels, &pool);
    if (err != cudaSuccess) return (int)err;
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  }
  interp_tile_kernel<<<n, kTileThreads, tile_smem(levels), s>>>(
      (const int*)counts, (const int*)tile_ids, (const float*)base, (const int*)slab,
      (float*)scratch, (float*)out, (int*)ovf, tb, MC, wit, levels, pool);
  return (int)cudaGetLastError();
}

// Floats of stack scratch jello_fine_interp needs for n slots at blend
// depth BD: G's deep levels for the CTAs it can hold at once (0 when BD
// levels fit its shared memory), H's [n][BD][4][256]; -1 on a CUDA error
// or past INT_MAX.
extern "C" int jello_fine_interp_scratch(int n, int BD, int batch) {
  long long floats;
  if (batch != 0) {
    floats = (long long)n * BD * 4 * kPixels;
  } else {
    const int levels = tile_levels(BD);
    int rows = 0;
    if (BD > levels && tile_scratch_rows(n, levels, &rows) != cudaSuccess) return -1;
    floats = (long long)rows * (BD - levels) * 4 * kPixels;
  }
  return floats > INT_MAX ? -1 : (int)floats;
}

// CTAs of kernel G (batch 0) or H (batch 1) resident on one multiprocessor
// of the current device at blend depth BD (a query, no launch; -1 on a
// CUDA error).
extern "C" int jello_fine_interp_ctas(int batch, int BD) {
  int per_sm = 0, sms = 0;
  if (batch == 0) {
    return tile_residency(tile_levels(BD), &per_sm, &sms) == cudaSuccess ? per_sm : -1;
  }
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, interp_batch_kernel, kPixels, 0);
  return err == cudaSuccess ? per_sm : -1;
}
