// Kernel C: monotone landing.
//
// Replaces the Pallas kernel jello_tpu/tpu/land_pallas.py (_kernel,
// pallas_call at :171; wrapper monotone_land at :127). On the TPU a
// scatter costs time per input row, so that kernel streams the rows
// through VMEM windows and lands them with one-hot MXU contractions into
// a bounded, flushed output window. On Hopper a scatter whose targets
// are distinct is just a predicated store: one thread per input row, and
// a kept row writes its K values at its position into the zeroed output.
// Kept positions are strictly increasing, so no two threads write one
// element and no atomics are needed.
//
// What bounds it on an H100: bytes. Each row reads its position, flag
// and K values (coalesced: neighbouring threads read neighbouring rows)
// and the stores go to nearly consecutive addresses. The zeroing of the
// output is the wrapper's memset.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
land_kernel(const int* __restrict__ pos, const bool* __restrict__ keep,
            const float* __restrict__ vals, float* __restrict__ out, int R, int K,
            int out_len) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R || !keep[r]) return;
  const int p = pos[r];
  if (p < 0 || p >= out_len) return;
  for (int k = 0; k < K; ++k) {
    out[(size_t)k * out_len + p] = vals[(size_t)k * R + r];
  }
}

}  // namespace

extern "C" int jello_monotone_land(const void* pos, const void* keep, const void* vals,
                                   void* out, int R, int K, int out_len, void* stream) {
  if (R > 0) {
    land_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)pos, (const bool*)keep, (const float*)vals, (float*)out, R, K, out_len);
  }
  return (int)cudaGetLastError();
}
