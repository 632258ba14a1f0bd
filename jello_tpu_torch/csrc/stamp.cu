// The stage clock's stamp: one thread writes the card's %globaltimer
// (nanoseconds) into one slot of a small int64 buffer.
//
// `profiler.named_scope` enqueues one at the entry of each pipeline stage
// and one after the last, on the frame's stream, so each stamp runs once
// the previous stage's work is done; captured into a frame's CUDA graph,
// each is a node, and every replay stamps its own stages. The difference
// of two stamps is the device time of the stage between them.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* slots, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[slot] = (long long)t;
}

}  // namespace

// slots [n] int64 on the device, slot < n, stream.
extern "C" int jello_stamp(void* slots, int slot, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(static_cast<long long*>(slots), slot);
  return (int)cudaGetLastError();
}
