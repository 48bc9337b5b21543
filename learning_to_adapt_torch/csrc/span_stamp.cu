// Device stamps for utils/tracing.py: one thread writes the global timer
// and a slot into a ring in device memory, so that a span's edges inside a
// step captured as a CUDA graph are timed at every replay.
//
// Replaces no TPU kernel: the JAX package times nothing inside its jitted
// programs. Bound by the launch (one thread, 16 bytes written); captured
// into a graph it costs one kernel node. The ring is
//     ring[0]            head: the stamps written since the host last read
//     ring[1 + 2 i]      the i-th stamp's %globaltimer (ns)
//     ring[2 + 2 i]      its slot (the host's table says which span edges
//                        it marks)
// A stamp past `capacity` is counted in the head and not written; the host
// reads the ring before it can fill.
#include <cuda_runtime.h>
#include <time.h>

__global__ void span_stamp_kernel(unsigned long long* ring,
                                  unsigned long long capacity,
                                  unsigned long long slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long i = atomicAdd(ring, 1ull);
  if (i < capacity) {
    ring[1 + 2 * i] = t;
    ring[2 + 2 * i] = slot;
  }
}

extern "C" int span_stamp(void* ring, unsigned long long capacity,
                          unsigned long long slot, void* stream) {
  span_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)ring, capacity, slot);
  return (int)cudaGetLastError();
}

// The node a capture on `stream` would hang its next launch on, where it
// has exactly one (*node; else 0), and the number of such nodes (*count).
// Two span edges with nothing launched between them find the same node and
// share one stamp. (The CUDA 12 signature: the toolkit the port builds
// with is 12.9.)
extern "C" int span_capture_tail(void* stream, unsigned long long* node,
                                 unsigned long long* count) {
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t rc = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status,
                                            nullptr, nullptr, &deps, &n);
  if (rc != cudaSuccess) return (int)rc;
  if (status != cudaStreamCaptureStatusActive) return -1;
  *count = n;
  *node = n == 1 ? (unsigned long long)deps[0] : 0ull;
  return 0;
}

static long long realtime_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (long long)ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

// `n` stamps into `ring` (slots 0 .. n-1), each launched alone between two
// readings of the host clock (CLOCK_REALTIME, the clock of the profiler's
// host events) and waited for: host_ns[2 i], host_ns[2 i + 1].
extern "C" int span_calibrate(void* ring, int n, void* stream,
                              long long* host_ns) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaStreamSynchronize(s);
  if (rc != cudaSuccess) return (int)rc;
  for (int i = 0; i < n; ++i) {
    host_ns[2 * i] = realtime_ns();
    span_stamp_kernel<<<1, 1, 0, s>>>((unsigned long long*)ring,
                                      (unsigned long long)n,
                                      (unsigned long long)i);
    rc = cudaStreamSynchronize(s);
    host_ns[2 * i + 1] = realtime_ns();
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaGetLastError();
}
