// scatter_rows: table[idx[i], :] = vals[i, :] in place (the history push),
// for f32 and bf16 tables; and scatter_rows_q: the quantizing push of an
// int8 history table, q[idx[i], :] = clip(rint(vals[i, :] / s_i), +-127)
// and scales[idx[i]] = s_i with s_i = max|vals[i, :]| / 127 (1 for an
// all-zero row), and err[i] = ||v_i - q_i * s_i|| / (||v_i|| + 1e-12),
// the relative error of every pushed row i, written or dropped (the
// per-row term of the `hist_quant_err` diagnostic).
//
// Replaces src/repro/kernels/scatter.py:39 scatter_rows (Pallas, the
// value row i copied to table row idx[i] by a sequential grid over i, the
// table aliased into the output) and scatter.py:85 scatter_rows_q (the
// same grid with the divide-round-clip in the kernel; the reference takes
// s_i from `history.row_scales` outside the kernel and scatters the
// scales with XLA).
//
// Semantics: rows whose index lies outside [0, N) are dropped; duplicate
// valid indices resolve to the LAST occurrence in row order. The TPU
// grid gets that for free by running in order; CTAs here run in no
// order, so the winner of each target row is resolved before any row is
// written: pass 1 resets winner[t] = -1 for every target t named in idx,
// pass 2 takes winner[t] = max position naming t (atomicMax), pass 3
// writes row i only if winner[idx[i]] == i. The three passes run in
// stream order; `winner` is caller-allocated scratch of N int32 whose
// untouched entries are never read. In scatter_rows_q the winner writes
// both the code row and the scale, so a target's codes and its scale
// always come from the same pushed row.
//
// Bound: bytes. scatter_rows reads M*D*E bytes of values and writes M*D*E
// bytes of table rows (E = 4 for f32, 2 for bf16; the push rounds f32 to
// bf16 before the copy, in PyTorch); scatter_rows_q reads M*D*4 bytes and
// writes M*D int8 bytes plus 4*M of scales and 4*M of errors (plus, for
// both, the index vector three times and 8*M bytes of winner traffic).
// Design: the copy pass is the gather's layout — one warp per row,
// 16-byte lanes where the row's bytes and the buffers allow, ragged edge
// masked in the loop bound.
// The quantizing pass keeps the warp per row: a warp reduction of
// fabsf takes the row max (a max is exact in any order, so s_i is bitwise
// `row_scales`), then each element is divided with IEEE rounding
// (__fdiv_rn: the reference divides, and the build uses no fast math) and
// rounded half to even (__float2int_rn, as jnp.round; roundf would round
// half away from zero), so the codes are bitwise the plain version's.
// The same pass dequantizes each code (one IEEE multiply, as the pull)
// and sums the squares of the differences and of the values in the
// warp, so the error costs no second read of the row; its sums are taken
// in another order than the plain version's, so it agrees to rounding.
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

// Passes 1 and 2: the winner of every target row named in idx.
int claim(const int32_t* idx, int32_t* winner, int64_t m, int64_t n,
          cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + kThreads - 1) / kThreads));
  claim_reset<<<grid, kThreads, 0, s>>>(idx, winner, m, n);
  REPRO_CHECK_LAUNCH();
  claim_last<<<grid, kThreads, 0, s>>>(idx, winner, m, n);
  REPRO_CHECK_LAUNCH();
  return 0;
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

template <typename E>
int launch_scatter(void* table, const int32_t* idx, const void* vals,
                   int32_t* winner, int64_t m, int64_t n, int64_t d,
                   void* stream) {
  if (m == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int rc = claim(idx, winner, m, n, s)) return rc;
  const dim3 grid(static_cast<unsigned>((m + kRowsPerCta - 1) / kRowsPerCta));
  constexpr int64_t kPerVec = sizeof(uint4) / sizeof(E);
  const bool vec = d % kPerVec == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  if (vec) {
    scatter_rows_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<uint4*>(table), idx, static_cast<const uint4*>(vals),
        winner, m, n, d / kPerVec);
  } else {
    scatter_rows_kernel<E><<<grid, kThreads, 0, s>>>(
        static_cast<E*>(table), idx, static_cast<const E*>(vals), winner, m,
        n, d);
  }
  REPRO_CHECK_LAUNCH();
  return 0;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const int r = __float2int_rn(__fdiv_rn(v, s));
  return static_cast<int8_t>(min(max(r, -127), 127));
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_q_kernel(int8_t* __restrict__ q, float* __restrict__ scales,
                      float* __restrict__ err,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ vals,
                      const int32_t* __restrict__ winner, int64_t m,
                      int64_t n, int64_t d) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / 32;
  if (row >= m) return;
  const int32_t t = idx[row];
  // every row is quantized for its error; only the winner is written
  const bool write = t >= 0 && t < n && winner[t] == static_cast<int32_t>(row);
  const int lane = threadIdx.x % 32;
  const float* src = vals + row * d;
  float amax = 0.f;
  for (int64_t c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(__ldg(src + c)));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  int8_t* dst = q + static_cast<int64_t>(write ? t : 0) * d;
  float num = 0.f, den = 0.f;
  for (int64_t c = lane; c < d; c += 32) {
    const float v = __ldg(src + c);
    const int8_t code = quantize(v, s);
    if (write) dst[c] = code;
    const float diff = __fsub_rn(v, __fmul_rn(static_cast<float>(code), s));
    num = __fadd_rn(num, __fmul_rn(diff, diff));
    den = __fadd_rn(den, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    num += __shfl_xor_sync(0xffffffffu, num, off);
    den += __shfl_xor_sync(0xffffffffu, den, off);
  }
  if (lane == 0) {
    if (write) scales[t] = s;
    err[row] = __fdiv_rn(__fsqrt_rn(num), __fadd_rn(__fsqrt_rn(den), 1e-12f));
  }
}

}  // namespace

REPRO_API int repro_scatter_rows_f32(float* table, const int32_t* idx,
                                     const float* vals, int32_t* winner,
                                     int64_t m, int64_t n, int64_t d,
                                     void* stream) {
  return launch_scatter<float>(table, idx, vals, winner, m, n, d, stream);
}

REPRO_API int repro_scatter_rows_bf16(uint16_t* table, const int32_t* idx,
                                      const uint16_t* vals, int32_t* winner,
                                      int64_t m, int64_t n, int64_t d,
                                      void* stream) {
  return launch_scatter<uint16_t>(table, idx, vals, winner, m, n, d, stream);
}

REPRO_API int repro_scatter_rows_q(int8_t* q, float* scales, float* err,
                                   const int32_t* idx, const float* vals,
                                   int32_t* winner, int64_t m, int64_t n,
                                   int64_t d, void* stream) {
  if (m == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int rc = claim(idx, winner, m, n, s)) return rc;
  const dim3 grid(static_cast<unsigned>((m + kRowsPerCta - 1) / kRowsPerCta));
  scatter_rows_q_kernel<<<grid, kThreads, 0, s>>>(q, scales, err, idx,
                                                  vals, winner, m, n, d);
  REPRO_CHECK_LAUNCH();
  return 0;
}
