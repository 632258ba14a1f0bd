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
// G: one CTA of 256 threads per slot, one thread per pixel of the slot's
// 16x16 tile. The CTA walks the slot's tape slab[slot][0 .. count): the 16
// words of a record are staged in shared memory and are uniform over the
// CTA, so the switch on the record kind does not diverge; clip depth,
// blend depth, the clip-zero suppression depth and the overflow bits are
// registers. A thread keeps its pixel's premultiplied rgba and `area`
// (the resolved coverage, which carries over from record to record: a
// BeginClip does not set it, an EndClip sets it from its own row by the
// nonzero rule, a rowless fill sets 1, a suppressed record leaves it; it
// starts at 0) in registers. Coverage is one coalesced 1 KB row read at
// index word 1; with `resolved` set (an MSAA frame) the row is kernel A's
// resolved coverage and is clipped to [0, 1] whatever the record's rule
// and kind (fine_pallas.py:292-293, 767-768). Gradients are kernel B's device code (paint.cuh); an
// image record gathers its four texels from the L2-resident planar atlas
// as kernel F does, under the interpreter's own region contract: one
// 64x256 window at x_lo = clip(rx0 / 128 * 128, 0, AWp - 256), y_lo =
// clip(ry0 / 8 * 8, 0, AHp - 64); a record whose corner extent leaves it
// (rx1 - x_lo >= 256 or ry1 - y_lo >= 64) paints nothing and sets
// overflow bit 1, so that the port and the reference reroute the same
// frames. The extent is a CTA-wide min/max.
//
// The blend stack is [BD][4][256] floats, 4 KB a level, and a thread
// touches only its own pixel's column of it, so it needs no barrier. G
// keeps it in dynamic shared memory while BD levels fit the 227 KB a CTA
// can have (32 KB at BD 8; above 48 KB the launcher opts in with
// cudaFuncSetAttribute). A push past BD sets overflow bit 0 and
// overwrites the top level; the renderer doubles BD and runs the frame
// again.
//
// H: the same record step, another mapping: a CTA walks eight slots in
// lockstep, record index by record index up to the longest of its eight
// tapes, a thread holding its pixel of all eight tiles in registers.
// Eight stacks at BD 8 are 256 KB, more than a CTA's shared memory, so H
// keeps its stacks in a global scratch [n][BD][4][256] that the wrapper
// allocates; every access is a coalesced 1 KB row private to the CTA,
// which stays in L2. G uses the same scratch when its BD levels exceed a
// CTA's shared memory. The two kernels are one template over the number
// of tiles a CTA walks; the record step exists once.
//
// What bounds it on an H100: per record 64 B of slab, 1 KB of coverage
// for a fill, and per push or pop 4 KB of stack traffic (shared memory
// for G); per slot 4 KB written. A tape is walked serially by its CTA, so
// the time is the longest tapes' latency chains spread over the SMs, not
// bytes. Rounding follows the reference: no contraction (-fmad=false),
// IEEE division and roots, rintf.

#include <cuda_runtime.h>

#include "blend.cuh"
#include "paint.cuh"

namespace {

using namespace jello;

constexpr int kBatchTiles = 8;

// Control state of one tape: uniform over the CTA.
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

// One record of one tile's tape, for this thread's pixel. `stack` points
// at this pixel's column of the tile's blend stack (stride kPixels).
__device__ __forceinline__ void record_step(const int* w, float gx, float gy, float v[4],
                                            float& area, Ctl& c, float* stack,
                                            const Tables& tb, int (*red)[kPixels / 32]) {
  const float* f = reinterpret_cast<const float*>(w);
  const int p = threadIdx.x;
  const int kind = w[0];
  const int seg_raw = w[2];
  const bool sup = c.zero_depth > 0;
  const bool is_begin = kind == CMD_BEGIN_CLIP;
  const bool is_end = kind == CMD_END_CLIP;
  const bool paints = !sup && kind >= CMD_COLOR && kind <= CMD_IMAGE;

  if (paints || (!sup && is_end)) {
    if (seg_raw > 0) {
      const int row = clamp_i(w[1], 0, tb.n_rows - 1);
      const float a = tb.rows[(size_t)row * kPixels + p];
      area = tb.resolved ? resolved_coverage(a) : fill_rule(a, (w[4] & 1) != 0 && !is_end);
    } else {
      area = 1.0f;
    }
  }

  if (paints) {
    float fg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kind == CMD_COLOR) {
      fg[0] = f[5]; fg[1] = f[6]; fg[2] = f[7]; fg[3] = f[8];
    } else if (kind == CMD_IMAGE) {
      if (tb.atlas != nullptr) {
        const Tap t = image_tap_corners(w, gx, gy);
        int rx0, ry0, rx1, ry1, x_lo, y_lo;
        image_tap_extent(t, red, &rx0, &ry0, &rx1, &ry1);
        image_region_origin(rx0, ry0, tb.AHp, tb.AWp, &x_lo, &y_lo);
        const bool bad = (rx1 - x_lo) >= REGW || (ry1 - y_lo) >= REGH;
        if (bad) c.ovf |= 2;
        if (t.inb && !bad) image_tap_gather(tb.atlas, tb.AHp, tb.AWp, t, fg);
      }
    } else {
      gradient_fg(kind, w, gx, gy, tb.stops, tb.n_ramp_rows, tb.row_w, fg);
    }
    const float fa = fg[3] * area;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) v[ch] = v[ch] * (1.0f - fa) + fg[ch] * area;
  }

  // Clips: the suppression state reads the depth before this record.
  const bool begin_zero = is_begin && seg_raw < 0;
  if (sup && is_end && c.clip_depth == c.zero_depth) c.zero_depth = 0;
  if (!sup && begin_zero) c.zero_depth = c.clip_depth + 1;
  c.clip_depth += (is_begin ? 1 : 0) - (is_end ? 1 : 0);

  if (!sup && is_begin && !begin_zero) {
    if (c.blend_depth >= tb.BD) c.ovf |= 1;
    float* s = stack + (size_t)clamp_i(c.blend_depth, 0, tb.BD - 1) * 4 * kPixels;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      s[ch * kPixels] = v[ch];
      v[ch] = 0.0f;
    }
    c.blend_depth += 1;
  }
  if (!sup && is_end) {
    c.blend_depth -= 1;
    const float* s = stack + (size_t)clamp_i(c.blend_depth, 0, tb.BD - 1) * 4 * kPixels;
    const float a_cov = area * f[6];
    float bg[4], src[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      bg[ch] = s[ch * kPixels];
      src[ch] = v[ch] * a_cov;
    }
    blend_mix_compose_f(bg, src, w[5], v);
  }
}

template <int NT>
__global__ void __launch_bounds__(kPixels)
fine_interp_kernel(const int* __restrict__ counts, const int* __restrict__ tile_ids,
                   const float* __restrict__ base, const int* __restrict__ slab,
                   float* __restrict__ scratch, float* __restrict__ out,
                   int* __restrict__ ovf, Tables tb, int MC, int wit) {
  extern __shared__ float smem_stack[];
  __shared__ int w[NT][16];
  __shared__ int red[4][kPixels / 32];
  const int p = threadIdx.x;
  const int slot0 = blockIdx.x * NT;

  float v[NT][4], area[NT], gx[NT], gy[NT];
  int n[NT];
  Ctl ctl[NT];
  int n_max = 0;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int t = tile_ids[slot0 + k];
    n[k] = min(counts[slot0 + k], MC);
    n_max = max(n_max, n[k]);
    gx[k] = (float)(p & 15) + (float)((t % wit) * 16);
    gy[k] = (float)(p >> 4) + (float)((t / wit) * 16);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) v[k][ch] = base[ch];
    area[k] = 0.0f;
    ctl[k] = Ctl{0, 0, 0, 0};
  }

  for (int ci = 0; ci < n_max; ++ci) {
    __syncthreads();
    if (p < NT * 16) {
      const int k = p >> 4;
      w[k][p & 15] = slab[((size_t)(slot0 + k) * MC + ci) * 16 + (p & 15)];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (ci < n[k]) {
        float* stack = scratch != nullptr
                           ? scratch + (size_t)(slot0 + k) * tb.BD * 4 * kPixels + p
                           : smem_stack + p;
        record_step(w[k], gx[k], gy[k], v[k], area[k], ctl[k], stack, tb, red);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const float inv_a = 1.0f / fmaxf(v[k][3], 1e-6f);
    float* o = out + (size_t)(slot0 + k) * 4 * kPixels + p;
    o[0] = v[k][0] * inv_a;
    o[kPixels] = v[k][1] * inv_a;
    o[2 * kPixels] = v[k][2] * inv_a;
    o[3 * kPixels] = v[k][3];
    if (p == 0) ovf[slot0 + k] = ctl[k].ovf;
  }
}

}  // namespace

// counts [n] i32 (any words after the first n are not read), tile_ids [n]
// i32, base [4] f32, slab [n, MC, 16] i32, rows [n_rows, 256] f32, stops
// [NR, W] f32, atlas [4, AHp, AWp] f32 or null, scratch [n, BD, 4, 256]
// f32 or null (null: G's stack in shared memory), out [n, 4, 256] f32,
// ovf [n] i32. batch != 0 launches H and needs n % 8 == 0 and a scratch;
// resolved != 0: the rows are resolved coverage.
extern "C" int jello_fine_interp(const void* counts, const void* tile_ids, const void* base,
                                 const void* slab, const void* rows, const void* stops,
                                 const void* atlas, void* scratch, void* out, void* ovf,
                                 int n, int MC, int n_rows, int n_ramp_rows, int row_w,
                                 int wit, int BD, int AHp, int AWp, int batch,
                                 int resolved, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  Tables tb{(const float*)rows, (const float*)stops, (const float*)atlas,
            n_rows, n_ramp_rows, row_w, BD, AHp, AWp, resolved};
  cudaStream_t s = (cudaStream_t)stream;
  if (batch != 0) {
    if (n % kBatchTiles != 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
    fine_interp_kernel<kBatchTiles><<<n / kBatchTiles, kPixels, 0, s>>>(
        (const int*)counts, (const int*)tile_ids, (const float*)base, (const int*)slab,
        (float*)scratch, (float*)out, (int*)ovf, tb, MC, wit);
    return (int)cudaGetLastError();
  }
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = (size_t)BD * 4 * kPixels * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(fine_interp_kernel<1>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  fine_interp_kernel<1><<<n, kPixels, smem, s>>>(
      (const int*)counts, (const int*)tile_ids, (const float*)base, (const int*)slab,
      (float*)scratch, (float*)out, (int*)ovf, tb, MC, wit);
  return (int)cudaGetLastError();
}
