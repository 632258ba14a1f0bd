// Kernel D: the lockstep Euler walk.
//
// Replaces the Pallas kernel jello_tpu/tpu/lockstep_pallas.py
// (make_lockstep_call, pallas_call at :198; the walk lockstep_walk at
// :71). The TPU runs the adaptive subdivision of all work items in
// lockstep on (8, 128) lane vectors, after transposing the work table
// onto lanes through the MXU, and always runs its IT unrolled
// iterations. On Hopper each work item is one thread: its walk state
// (cubic, last point and derivative, t0 numerator, dt) stays in
// registers and the warp leaves the loop as soon as all its items are
// done.
//
// The arithmetic is pipeline/lockstep.py's, op by op (csrc/
// flatten_math.cuh), built with -fmad=false: records and line counts
// equal the plain version's bit for bit. `iters` is the plain walk's:
// the iterations entered while some item was not done, i.e. the largest
// per-item count of iterations entered while not done, reduced over a
// warp with __reduce_max_sync and then with one atomicMax a warp on the
// device (no host sync); the entry clears it first with a 4-byte memset.
// t0u is the XLA walk's uint32 with its clamped doubling.
//
// The record table [3, IT, NW] is written once and whole by the kernel:
// (t0, t1, n) where the item emitted, zeros where it subdivided and on
// every iteration after it left the loop (or that it never entered), so
// the wrapper allocates it uninitialised. A warp steps through the
// iterations together, its finished lanes storing zeros beside the
// others' records, so that each iteration's store is one coalesced
// store across the warp's items.
//
// What bounds it on an H100: the per-item float work (a few hundred
// flops an iteration, with divisions and square roots) and the
// divergence between items of one warp that need different iteration
// counts (the warp runs its longest item's); memory traffic is one
// 84-byte row in and 12 bytes an iteration out per item, which at IT =
// 32 makes the record table nearly all of the call's bytes. The walk
// needs 63 registers, so 8 CTAs of 128 fit a multiprocessor; launch
// bounds that force more spill and run slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flatten_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 21;

__global__ void __launch_bounds__(kThreads)
lockstep_kernel(const float* __restrict__ table, const bool* __restrict__ valid, int NW, int IT,
                float* __restrict__ rec, float* __restrict__ count, bool* __restrict__ not_done,
                int* __restrict__ iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool item = i < NW;
  const float* row = table + (size_t)min(i, NW - 1) * kCols;
  fm::Cubic P;
  for (int k = 0; k < 8; ++k) P.p[k] = row[k];
  const float offset = row[8], scale = row[9];
  const float* p = P.p;
  const bool degenerate = p[0] == p[2] && p[1] == p[3] && p[0] == p[4] && p[1] == p[5] &&
                          p[0] == p[6] && p[1] == p[7];
  bool done = !(item && valid[i] && !degenerate);

  uint32_t t0u = 0;
  float dt = 1.0f;
  float lpx = p[0], lpy = p[1];
  float lqx = p[2] - p[0], lqy = p[3] - p[1];
  if (lqx * lqx + lqy * lqy < F(fm::kDerivThresh * fm::kDerivThresh)) {
    float px, py;
    fm::eval_cubic_and_deriv(P, F(fm::kDerivEps), &px, &py, &lqx, &lqy);
  }
  float last_t = 0.0f;
  float cnt = 0.0f;
  int entered = 0;
  float* rec_t0 = rec + i;
  float* rec_t1 = rec + (size_t)IT * NW + i;
  float* rec_n = rec + (size_t)2 * IT * NW + i;

  // The warp steps through the iterations together until all its items
  // are done, so that every lane stores each iteration's record (zeros
  // once it is done) in the same coalesced store; then the rest of the
  // table is zero.
  int it = 0;
  for (; it < IT && !__all_sync(0xffffffffu, done); ++it) {
    float r0 = 0.0f, r1 = 0.0f, rn = 0.0f;
    if (!done) {
      ++entered;
      const float t0 = (float)t0u * dt;
      if (t0 == 1.0f) {
        done = true;
      } else {
        const fm::PQ q = fm::pq_at(P, t0 + dt);
        const float t1 = q.t;
        const fm::Fit f =
            fm::cubic_params_from_points_derivs(lpx, lpy, q.px, q.py, lqx, lqy, q.qx, q.qy,
                                                t1 - last_t);
        const bool emit = (f.err * scale <= fm::kTol) || (dt <= fm::kSubdivLimit);
        if (emit) {
          const fm::EulerParams e = fm::euler_params_from_angles(f.th0, f.th1);
          float n = fm::espc_subdivision(e.k0, e.k1, e.ch, f.chord_len, offset, scale).n;
          if (isnan(n)) n = 1.0f;
          r0 = last_t;
          r1 = t1;
          rn = n;
          cnt = cnt + n;
          lpx = q.px;
          lpy = q.py;
          lqx = q.qx;
          lqy = q.qy;
          last_t = t1;
          // Advance: t0u + 1 with its trailing zeros shifted out (u32
          // wrap-around kept; zero has no trailing-zero count and shifts
          // by 0).
          const uint32_t t0u_e = t0u + 1u;
          const int shift = t0u_e == 0u ? 0 : __ffs((int)t0u_e) - 1;
          t0u = t0u_e >> shift;
          dt = dt * __int_as_float((127 + shift) << 23);  // dt * 2^shift, exact
        } else {
          t0u = t0u > 0x7FFFFFFFu ? 0xFFFFFFFFu : t0u * 2u;
          dt = dt * 0.5f;
        }
      }
    }
    if (item) {
      rec_t0[(size_t)it * NW] = r0;
      rec_t1[(size_t)it * NW] = r1;
      rec_n[(size_t)it * NW] = rn;
    }
  }
  if (item) {
    for (; it < IT; ++it) {
      rec_t0[(size_t)it * NW] = 0.0f;
      rec_t1[(size_t)it * NW] = 0.0f;
      rec_n[(size_t)it * NW] = 0.0f;
    }
    count[i] = cnt;
    not_done[i] = !done;
  }
  const int most = __reduce_max_sync(0xffffffffu, entered);
  if ((threadIdx.x & 31) == 0 && most > 0) atomicMax(iters, most);
}

}  // namespace

// rec [3, IT, NW] f32 and the other outputs need not be initialised:
// iters is cleared here, every other element is written by the kernel.
extern "C" int jello_lockstep_walk(const void* table, const void* valid, void* rec, void* count,
                                   void* not_done, void* iters, int NW, int IT, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(iters, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (NW > 0) {
    lockstep_kernel<<<(NW + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const float*)table, (const bool*)valid, NW, IT, (float*)rec, (float*)count,
        (bool*)not_done, (int*)iters);
  }
  return (int)cudaGetLastError();
}
