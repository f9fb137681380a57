// Error-string lookup for the launchers' return codes.
#include "common.cuh"

REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// A kernel that does nothing, on `blocks` CTAs of `threads` threads:
// chip_smoke.py times it as the launch floor, the time no kernel of this
// library launched the same way on the same stream goes under.
REPRO_API int repro_empty_kernel(int64_t blocks, int64_t threads,
                                 void* stream) {
  empty_kernel<<<static_cast<unsigned>(blocks),
                 static_cast<unsigned>(threads), 0,
                 static_cast<cudaStream_t>(stream)>>>();
  REPRO_CHECK_LAUNCH();
  return 0;
}

// The address through which kernels on the current device reach `host`, a
// pointer into pinned host memory (a `history_storage="host"` table's
// buffer, read by gather_rows_raw and written by the pushes through the
// unified address space); cudaErrorInvalidValue for memory that is not
// pinned host memory (pageable, or on a device).
REPRO_API int repro_host_device_ptr(const void* host, void** dev) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, host);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not sticky: keep it from a later launch's check
    return static_cast<int>(err);
  }
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  *dev = attr.devicePointer;
  return 0;
}
