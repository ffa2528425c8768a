// Device phase stamps for utils/profiling.py: one-thread kernels that read
// the card's %globaltimer (nanoseconds) where a traced span opens and closes
// on a stream, capturable into a CUDA graph.
//
// A phase is one row of a device buffer of int64 slots:
//   [0] nanoseconds summed over closed occurrences
//   [1] occurrences closed
//   [2] the open time of the occurrence in progress
//   [3] the first open time (0 until the first)
//   [4] the last close time
// ts_open writes [2] (and [3] once); ts_close adds now - [2] to [0], one to
// [1], and writes [4]. Nodes of one captured stream run in order, so the two
// kernels bound the phase's kernels exactly, and every trip of an IF or
// WHILE body that holds them adds to the same row. ts_now writes the time
// alone: the clock anchor's device side.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__global__ void ts_open_kernel(long long* row) {
  const long long t = globaltimer();
  row[2] = t;
  if (row[3] == 0) row[3] = t;
}

__global__ void ts_close_kernel(long long* row) {
  const long long t = globaltimer();
  row[0] += t - row[2];
  row[1] += 1;
  row[4] = t;
}

__global__ void ts_now_kernel(long long* out) { out[0] = globaltimer(); }

// Enqueues `kernel` on `stream` of `device` (captured when the stream
// captures), with `device` current for this library's runtime meanwhile.
int launch(void (*kernel)(long long*), void* ptr, void* stream, int device) {
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  long long* arg = (long long*)ptr;
  void* args[] = {&arg};
  err = cudaLaunchKernel((const void*)kernel, dim3(1), dim3(1), args, 0, (cudaStream_t)stream);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // namespace

extern "C" {

const char* ts_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int ts_open(void* row, void* stream, int device) {
  return launch(ts_open_kernel, row, stream, device);
}

int ts_close(void* row, void* stream, int device) {
  return launch(ts_close_kernel, row, stream, device);
}

int ts_now(void* out, void* stream, int device) {
  return launch(ts_now_kernel, out, stream, device);
}

}  // extern "C"
