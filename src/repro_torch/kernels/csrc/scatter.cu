// scatter_rows: table[idx[i], :] = vals[i, :] in place (the history push).
//
// Replaces src/repro/kernels/scatter.py:39 scatter_rows (Pallas, the
// value row i copied to table row idx[i] by a sequential grid over i, the
// table aliased into the output).
//
// Semantics: rows whose index lies outside [0, N) are dropped; duplicate
// valid indices resolve to the LAST occurrence in row order. The TPU
// grid gets that for free by running in order; CTAs here run in no
// order, so the winner of each target row is resolved before any row is
// written: pass 1 resets winner[t] = -1 for every target t named in idx,
// pass 2 takes winner[t] = max position naming t (atomicMax), pass 3
// copies row i only if winner[idx[i]] == i. The three passes run in
// stream order; `winner` is caller-allocated scratch of N int32 whose
// untouched entries are never read.
//
// Bound: bytes. It reads M*D*4 bytes of values and writes M*D*4 bytes of
// table rows (plus the index vector three times and 8*M bytes of winner
// traffic). Design: the copy pass is the gather's layout — one warp per
// row, float4 lanes where D and the buffers allow, ragged edge masked in
// the loop bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;

__global__ void claim_reset(const int32_t* __restrict__ idx,
                            int32_t* __restrict__ winner, int64_t m,
                            int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int32_t t = idx[i];
  if (t >= 0 && t < n) winner[t] = -1;
}

__global__ void claim_last(const int32_t* __restrict__ idx,
                           int32_t* __restrict__ winner, int64_t m,
                           int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int32_t t = idx[i];
  if (t >= 0 && t < n) atomicMax(winner + t, static_cast<int32_t>(i));
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(V* __restrict__ table, const int32_t* __restrict__ idx,
                    const V* __restrict__ vals,
                    const int32_t* __restrict__ winner, int64_t m, int64_t n,
                    int64_t dv) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / 32;
  if (row >= m) return;
  const int32_t t = idx[row];
  if (t < 0 || t >= n || winner[t] != static_cast<int32_t>(row)) return;
  const int lane = threadIdx.x % 32;
  const V* src = vals + row * dv;
  V* dst = table + static_cast<int64_t>(t) * dv;
  for (int64_t c = lane; c < dv; c += 32) dst[c] = __ldg(src + c);
}

}  // namespace

REPRO_API int repro_scatter_rows_f32(float* table, const int32_t* idx,
                                     const float* vals, int32_t* winner,
                                     int64_t m, int64_t n, int64_t d,
                                     void* stream) {
  if (m == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 claim_grid(static_cast<unsigned>((m + kThreads - 1) / kThreads));
  claim_reset<<<claim_grid, kThreads, 0, s>>>(idx, winner, m, n);
  REPRO_CHECK_LAUNCH();
  claim_last<<<claim_grid, kThreads, 0, s>>>(idx, winner, m, n);
  REPRO_CHECK_LAUNCH();
  const dim3 grid(static_cast<unsigned>((m + kRowsPerCta - 1) / kRowsPerCta));
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  if (vec) {
    scatter_rows_kernel<float4><<<grid, kThreads, 0, s>>>(
        reinterpret_cast<float4*>(table), idx,
        reinterpret_cast<const float4*>(vals), winner, m, n, d / 4);
  } else {
    scatter_rows_kernel<float><<<grid, kThreads, 0, s>>>(table, idx, vals,
                                                         winner, m, n, d);
  }
  REPRO_CHECK_LAUNCH();
  return 0;
}
