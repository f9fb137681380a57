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
