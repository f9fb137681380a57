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

// The raw pull and push (gather.cu gather_rows_raw, scatter.cu
// scatter_rows_raw) move rows of several tables under one index in one
// launch. kRawMaxTables is the most tables a launch takes
// (kernels/gather.py MAX_RAW_TABLES); a call over more is split into
// ceil(T / kRawMaxTables) launches by its C entry, the last of them, where
// at most kRawSmallTables are left, on a descriptor of that many (the
// pull's, where one is left, on a descriptor of one): a launch's
// parameters take time to send (~0.5 us more at 2,304 bytes than at 288
// on an H100, PERF.md row 18).
constexpr int kRawMaxTables = 64;
constexpr int kRawSmallTables = 8;

// The tables of one launch, at most K, passed to the kernel by value (36 *
// K bytes of the 4 KB parameter space; no device buffer, no copy, no
// sync). Table j holds n[j] rows; `table[j]` is its address (a device
// pointer, or the unified address of a pinned host buffer), `rows[j]` the
// M rows pulled from it or pushed into it; each row is units[j] units of
// 2^unit_log[j] bytes.
template <int K>
struct RawTables {
  void* table[K];
  void* rows[K];
  int64_t n[K];
  int64_t units[K];
  int32_t unit_log[K];
};

// log2 of the widest unit, 16, 8, 4, 2 or 1 bytes, that divides a row's
// bytes and both of its buffers' addresses
inline int raw_unit_log(const void* a, const void* b, int64_t row_bytes) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b) |
                          static_cast<uintptr_t>(row_bytes);
  int lg = 4;
  while (lg > 0 && align % (uintptr_t{1} << lg) != 0) --lg;
  return lg;
}

// The next launch's tables: from table *next on, every table with bytes
// to move, at most K, into `p`; *next moves past them, and *most becomes
// the largest units a row among them. Returns how many it took (0 when
// none is left), or -1 for a table with no rows or a negative row size.
template <int K>
int raw_tables_next(RawTables<K>& p, void* const* tables, void* const* rows,
                    const int64_t* rows_n, const int64_t* row_bytes,
                    int64_t count, int64_t* next, int64_t* most) {
  int k = 0;
  *most = 0;
  for (; *next < count && k < K; ++*next) {
    const int64_t j = *next, rb = row_bytes[j];
    if (rb < 0) return -1;
    if (rb == 0) continue;
    if (rows_n[j] <= 0) return -1;
    const int lg = raw_unit_log(tables[j], rows[j], rb);
    p.table[k] = tables[j];
    p.rows[k] = rows[j];
    p.n[k] = rows_n[j];
    p.units[k] = rb >> lg;
    p.unit_log[k] = lg;
    if (p.units[k] > *most) *most = p.units[k];
    ++k;
  }
  return k;
}
