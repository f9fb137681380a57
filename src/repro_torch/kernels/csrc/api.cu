// Error-string lookup for the launchers' return codes.
#include "common.cuh"

REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
