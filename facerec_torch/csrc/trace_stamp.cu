// Device timestamps for the port's tracing (facerec_torch/utils/profiling.py),
// with no counterpart in the JAX package.
//
// trace_stamp is a one-thread kernel: it reads the card's nanosecond clock
// (%globaltimer), takes the next slot of a ring in device memory from a
// device-side cursor (atomicAdd) and writes (code, time) there. It runs in
// stream order, so it stamps the moment the work queued before it has
// finished and the work queued after it has not begun. A CUDA graph
// captured around it holds it as a kernel node with the same pointers, so
// every replay takes fresh slots; the host reads the ring where it already
// waits for the card. A stamp past the ring's last slot is not written, but
// the cursor still counts it, so the host sees how many were lost.
//
// trace_timer_steps measures the clock's resolution: one thread reads
// %globaltimer until it has seen `n` changes and writes each change's size.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void trace_stamp(unsigned long long* cursor, long long* ring, long long slots,
                            long long code) {
  const unsigned long long t = global_ns();
  const unsigned long long slot = atomicAdd(cursor, 1ull);
  if (slot < (unsigned long long)slots) {
    ring[2 * slot] = code;
    ring[2 * slot + 1] = (long long)t;
  }
}

__global__ void trace_timer_steps(long long* steps, int n) {
  unsigned long long last = global_ns();
  for (int i = 0; i < n;) {
    const unsigned long long t = global_ns();
    if (t != last) {
      steps[i++] = (long long)(t - last);
      last = t;
    }
  }
}

extern "C" int trace_stamp_launch(void* cursor, void* ring, long long slots, long long code,
                                  void* stream) {
  trace_stamp<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)cursor, (long long*)ring,
                                                 slots, code);
  return (int)cudaGetLastError();
}

extern "C" int trace_timer_steps_launch(void* steps, int n, void* stream) {
  if (n <= 0) return 0;
  trace_timer_steps<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)steps, n);
  return (int)cudaGetLastError();
}
