// Kernel C: monotone landing.
//
// Replaces the Pallas kernel jello_tpu/tpu/land_pallas.py (_kernel,
// pallas_call at :171; wrapper monotone_land at :127). On the TPU a
// scatter costs time per input row, so that kernel streams the rows
// through VMEM windows and lands them with one-hot MXU contractions into
// a bounded, flushed output window. On Hopper a scatter whose targets
// are distinct is just a predicated store: one thread per input row, and
// a kept row writes its K values at its position into the zeroed output.
//
// The kernel relies on one property of the positions only: they are
// strictly increasing on kept rows, so no two threads write one element
// and no atomics are needed. Positions may jump by any amount from one
// row to the next (flatten's worklist lands at an exclusive prefix of
// counts); the TPU kernel's "advance by at most 1 per row" bounds its
// flush window and means nothing here.
//
// What bounds it on an H100: bytes, a few hundred KB at most, so a call
// is launch-sized and the host's enqueue is what costs. The entry is
// therefore one memset and one kernel on the caller's stream and nothing
// else: the K value vectors (int32 or float32, K <= 3) arrive as separate
// pointers with a type code each and are converted in registers (exact:
// the contract holds values below 2^24), so the wrapper neither casts nor
// stacks them, and the output, allocated uninitialised by the wrapper, is
// zeroed here by cudaMemsetAsync.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVals = 3;

// The value vectors: pointer and type code (0 int32, 1 float32) each.
struct Vals {
  const void* ptr[kMaxVals];
  int code[kMaxVals];
};

__device__ __forceinline__ float load_value(const void* p, int code, int r) {
  return code == 0 ? (float)static_cast<const int*>(p)[r] : static_cast<const float*>(p)[r];
}

__global__ void __launch_bounds__(kThreads)
land_kernel(const int* __restrict__ pos, const bool* __restrict__ keep, Vals vals,
            float* __restrict__ out, int R, int K, int out_len) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R || !keep[r]) return;
  const int p = pos[r];
  if (p < 0 || p >= out_len) return;
#pragma unroll
  for (int k = 0; k < kMaxVals; ++k) {
    if (k < K) out[(size_t)k * out_len + p] = load_value(vals.ptr[k], vals.code[k], r);
  }
}

}  // namespace

// v0..v2: the K value vectors [R] (unused ones null), code0..code2 their
// types (0 int32, 1 float32); out [K, out_len] f32, need not be zeroed.
extern "C" int jello_monotone_land(const void* pos, const void* keep, const void* v0,
                                   const void* v1, const void* v2, int code0, int code1,
                                   int code2, void* out, int R, int K, int out_len,
                                   void* stream) {
  if (K < 1 || K > kMaxVals) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)K * (size_t)out_len * sizeof(float);
  if (bytes > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, bytes, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (R > 0) {
    const Vals vals = {{v0, v1, v2}, {code0, code1, code2}};
    land_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const int*)pos, (const bool*)keep, vals, (float*)out, R, K, out_len);
  }
  return (int)cudaGetLastError();
}
