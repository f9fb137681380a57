// Shared definitions for the port's CUDA kernels (built for sm_90a by
// kernels/_build.py into one shared library with a plain C interface,
// bound to Python with ctypes).
//
// Every exported launcher takes raw device pointers and the CUDA stream
// (PyTorch's current stream, passed as void*), launches on that stream
// without synchronising, allocates nothing, and returns the launch's
// cudaError_t as an int (0 = success); the Python wrapper raises on any
// other value.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

#define REPRO_CHECK_LAUNCH()                         \
  do {                                               \
    cudaError_t err_ = cudaGetLastError();           \
    if (err_ != cudaSuccess) return (int)err_;       \
  } while (0)
