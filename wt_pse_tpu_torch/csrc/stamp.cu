// The device clock of the port's spans (utils/trace.py): a one-thread kernel
// that writes the card's global timer, %globaltimer (ns), into an int64 buffer
// of shape (n_marks, capacity) at [slot, *row]. Built by ops/covariance_cuda.py::build
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes.
//
// It replaces no TPU kernel: a CUDA graph replays no host range and an event
// node keeps only its last replay's time, so the stamps of every replayed step
// are taken on the card. The row is read on the card when the kernel runs, so
// a captured stamp lands in the column of the step being replayed (the
// device-side row counter of train/graph.py), with no host sync. Stream order
// puts the stamp after everything enqueued before it; it reads one int64 and
// writes one, so it costs the card about the time of a launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(int64_t* buf, const int64_t* row, int slot, int capacity) {
  const int64_t col = *row;
  if (col < 0 || col >= capacity) return;  // a row past the buffer stamps nothing
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  buf[static_cast<int64_t>(slot) * capacity + col] = static_cast<int64_t>(now);
}

}  // namespace

extern "C" {

// Launch one stamp on `stream`; returns the launch's cudaError_t (0 on success).
int wtpse_stamp(void* buf, const void* row, int slot, int capacity, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(buf), static_cast<const int64_t*>(row), slot, capacity);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
