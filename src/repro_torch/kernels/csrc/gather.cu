// gather_rows: out[i, :] = table[idx[i], :]  (the history pull / feature
// gather).
//
// Replaces src/repro/kernels/gather.py:37 gather_rows (Pallas, one
// (1, bd) row tile per grid step, lane-padded to a multiple of 128).
//
// Bound: bytes. It reads M*D*4 bytes of table rows and writes M*D*4 bytes
// (plus 4*M of indices) and does no arithmetic. Design: one warp per
// output row, 8 rows per 256-thread CTA; each lane moves 16 bytes (float4)
// per step when D % 4 == 0 and both buffers are 16-byte aligned, so a
// warp moves 512 contiguous bytes per instruction and a row is read
// exactly once. The ragged edge is masked in the loop bound, so no
// caller pads the table to a tile width (the reference pads the whole
// [N, D] feature table to 128-column tiles on every pull). The index is
// read in the kernel; callers pre-clip it to [0, N).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table,
                   const int32_t* __restrict__ idx,
                   V* __restrict__ out, int64_t m, int64_t dv) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / 32;
  if (row >= m) return;
  const int lane = threadIdx.x % 32;
  const V* src = table + static_cast<int64_t>(__ldg(idx + row)) * dv;
  V* dst = out + row * dv;
  for (int64_t c = lane; c < dv; c += 32) dst[c] = __ldg(src + c);
}

}  // namespace

REPRO_API int repro_gather_rows_f32(const float* table, const int32_t* idx,
                                    float* out, int64_t m, int64_t d,
                                    void* stream) {
  if (m == 0 || d == 0) return 0;
  const dim3 grid(static_cast<unsigned>((m + kRowsPerCta - 1) / kRowsPerCta));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    gather_rows_kernel<float4><<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), idx,
        reinterpret_cast<float4*>(out), m, d / 4);
  } else {
    gather_rows_kernel<float><<<grid, kThreads, 0, s>>>(table, idx, out, m, d);
  }
  REPRO_CHECK_LAUNCH();
  return 0;
}
