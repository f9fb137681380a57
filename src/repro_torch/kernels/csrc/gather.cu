// gather_rows: out[i, :] = table[idx[i], :]  (the history pull / feature
// gather), for f32 and bf16 tables; gather_rows_dq: out[i, :] =
// float(q[idx[i], :]) * scales[idx[i]] (the dequantizing pull of an int8
// history table); and gather_rows_vq: out[i, 8s + j] =
// codebook[s, codes[idx[i], s], j] * scales[idx[i]] (the decoding pull of
// a vq history table: one uint8 code per 8-wide subvector).
//
// Replaces src/repro/kernels/gather.py:37 gather_rows (Pallas, one
// (1, bd) row tile per grid step, lane-padded to a multiple of 128) and
// gather.py:107 gather_rows_dq (Pallas, (8, bd) int8 tiles DMA'd row by
// row into a double-buffered VMEM slot, then one multiply per element by
// the row's scale from the scalar-prefetch lane) and gather.py:189
// gather_rows_vq (Pallas, the same double-buffered (8, S) code tiles, then
// one one-hot matmul per subvector against the VMEM-resident codebook and
// a multiply by the scale, the output lane-padded to 128).
//
// Bound: bytes. gather_rows reads M*D*E bytes of table rows and writes
// M*D*E bytes (E = 4 for f32, 2 for bf16; plus 4*M of indices) and does no
// arithmetic; gather_rows_dq reads M*D int8 bytes and 8*M bytes of index
// and scale and writes 4*M*D bytes, one multiply per element. Design: one
// warp per output row, 8 rows per 256-thread CTA. The row copy moves 16
// bytes per lane (4 f32 or 8 bf16) when the row's bytes and both buffers
// allow, so a warp moves 512 contiguous bytes per instruction; the
// dequant reads 4 codes per lane (char4) and writes a float4 when D % 4
// == 0 and the buffers are aligned. The ragged edge is masked in the loop
// bound, so no caller pads the table to a tile width. The index is read
// in the kernel; callers pre-clip it to [0, N). The dequant is one
// IEEE-rounded multiply per element (__fmul_rn, never contracted into
// anything), so the result is bitwise the plain version's and the
// reference's `dequantize_rows`.
//
// gather_rows_vq reads S code bytes and 8 bytes of index and scale per row
// and writes 4*S*8 bytes, one multiply per element: bound by bytes (the
// codebook, S*256*8*4 bytes, <= 256 KB at d = 256, is read once from
// device memory and then from L2). Design: one warp per output row, each
// lane a 4-wide half of one subvector: it reads the row's code for that
// subvector, one float4 of the codebook entry and writes one float4, so
// a warp writes 512 contiguous bytes; the codebook stays in L2 and no
// shared memory is staged, whatever S. The output is exactly S*8 wide
// (the reference pads it to 128 lanes and its callers slice). Each
// element is one IEEE multiply (__fmul_rn), bitwise `vq_decode_rows`.
//
// gather_rows_raw: out[i, :] = table[clip(idx[i], 0, N-1), :], the raw
// storage bits of a row of any width (f32, bf16, int8 codes, vq's uint8
// codes, and the [N] f32 scale tables as 1-wide rows). It replaces no
// Pallas kernel: the reference's `HistoryStore.prefetch`
// (src/repro/core/history.py:596-600) gathers the raw rows and scales
// with `jnp.take(..., mode="clip")`, which XLA lowers itself, and streams
// them device-ward with `jax.device_put`. The port needs a kernel of its
// own there because a history table may live in pinned host memory
// (`history_storage="host"`), which no PyTorch gather reads with a CUDA
// index: the table pointer is the pinned buffer's unified address, so
// each load crosses the host link, and only the pulled rows ever reach
// the card. Every pull of a host store and every prefetch of the epoch
// pipeline (any store) goes through it. Bound: bytes, M*R read (R the
// row's bytes; over the host link for a pinned table, over HBM for a
// device one) plus M*R written and 4*M of index; no arithmetic. Design:
// the output is cut into 16-byte units where the row's bytes and both
// buffers allow (else 8, 4, 2 or 1), one thread per unit, so that a
// narrow row (a 4-byte scale) does not idle a warp and a wide one is read
// by neighbouring threads at neighbouring addresses; every unit is an
// independent load, so a warp keeps many link reads in flight. The table
// is read with plain loads (no read-only cache path for host memory), the
// index through __ldg and clipped in the kernel.
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

// A row copy of `elem`-byte elements: 16-byte lanes (uint4) where the
// row's bytes and both buffers allow, else one element (E) per lane.
template <typename E>
int launch_row_copy(const void* table, const int32_t* idx, void* out,
                    int64_t m, int64_t d, void* stream) {
  if (m == 0 || d == 0) return 0;
  const dim3 grid(static_cast<unsigned>((m + kRowsPerCta - 1) / kRowsPerCta));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int64_t kPerVec = sizeof(uint4) / sizeof(E);
  const bool vec = d % kPerVec == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    gather_rows_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), m,
        d / kPerVec);
  } else {
    gather_rows_kernel<E><<<grid, kThreads, 0, s>>>(
        static_cast<const E*>(table), idx, static_cast<E*>(out), m, d);
  }
  REPRO_CHECK_LAUNCH();
  return 0;
}

__global__ void __launch_bounds__(kThreads)
gather_rows_dq_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, int64_t m, int64_t d,
                      bool vec) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / 32;
  if (row >= m) return;
  const int lane = threadIdx.x % 32;
  const int64_t t = __ldg(idx + row);
  const float s = __ldg(scales + t);
  const int8_t* src = q + t * d;
  float* dst = out + row * d;
  if (vec) {
    const char4* src4 = reinterpret_cast<const char4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int64_t c = lane; c < d / 4; c += 32) {
      const char4 v = __ldg(src4 + c);
      dst4[c] = make_float4(__fmul_rn(static_cast<float>(v.x), s),
                            __fmul_rn(static_cast<float>(v.y), s),
                            __fmul_rn(static_cast<float>(v.z), s),
                            __fmul_rn(static_cast<float>(v.w), s));
    }
  } else {
    for (int64_t c = lane; c < d; c += 32)
      dst[c] = __fmul_rn(static_cast<float>(__ldg(src + c)), s);
  }
}

// codes [N, S] uint8, codebook [S, 256, 8] f32, out [M, S*8] f32
__global__ void __launch_bounds__(kThreads)
gather_rows_vq_kernel(const uint8_t* __restrict__ codes,
                      const float* __restrict__ codebook,
                      const float* __restrict__ scales,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, int64_t m, int64_t s_n,
                      int64_t n_codes) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / 32;
  if (row >= m) return;
  const int lane = threadIdx.x % 32;
  const int64_t t = __ldg(idx + row);
  const float s = __ldg(scales + t);
  const uint8_t* src = codes + t * s_n;
  float4* dst = reinterpret_cast<float4*>(out + row * s_n * 8);
  const float4* cb = reinterpret_cast<const float4*>(codebook);
  for (int64_t q = lane; q < 2 * s_n; q += 32) {
    const int64_t sub = q / 2;
    const int64_t code = __ldg(src + sub);
    const float4 v = __ldg(cb + (sub * n_codes + code) * 2 + q % 2);
    dst[q] = make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s),
                         __fmul_rn(v.z, s), __fmul_rn(v.w, s));
  }
}

// one thread per V-sized unit of the output; `per_row` units a row
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_raw_kernel(const V* table, const int32_t* __restrict__ idx,
                       V* __restrict__ out, int64_t total, int64_t per_row,
                       int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       u < total; u += stride) {
    const int64_t row = u / per_row;
    int64_t t = __ldg(idx + row);
    t = t < 0 ? 0 : (t >= n ? n - 1 : t);
    out[u] = table[t * per_row + (u - row * per_row)];
  }
}

template <typename V>
int launch_raw(const void* table, const int32_t* idx, void* out, int64_t m,
               int64_t n, int64_t row_bytes, cudaStream_t s) {
  const int64_t per_row = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t total = m * per_row;
  // enough CTAs to cover the output once, at most 16 a SM's worth of 132
  const int64_t ctas = (total + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(ctas < 132 * 16 ? ctas : 132 * 16));
  gather_rows_raw_kernel<V><<<grid, kThreads, 0, s>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), total,
      per_row, n);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

REPRO_API int repro_gather_rows_raw(const void* table, const int32_t* idx,
                                    void* out, int64_t m, int64_t n,
                                    int64_t row_bytes, void* stream) {
  if (m == 0 || row_bytes == 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest unit that divides the row and both buffers' alignment
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch_raw<uint4>(table, idx, out, m, n,
                                                row_bytes, s);
  if (align % 8 == 0) return launch_raw<uint2>(table, idx, out, m, n,
                                               row_bytes, s);
  if (align % 4 == 0) return launch_raw<uint32_t>(table, idx, out, m, n,
                                                  row_bytes, s);
  if (align % 2 == 0) return launch_raw<uint16_t>(table, idx, out, m, n,
                                                  row_bytes, s);
  return launch_raw<uint8_t>(table, idx, out, m, n, row_bytes, s);
}

REPRO_API int repro_gather_rows_f32(const float* table, const int32_t* idx,
                                    float* out, int64_t m, int64_t d,
                                    void* stream) {
  return launch_row_copy<float>(table, idx, out, m, d, stream);
}

REPRO_API int repro_gather_rows_bf16(const uint16_t* table,
                                     const int32_t* idx, uint16_t* out,
                                     int64_t m, int64_t d, void* stream) {
  return launch_row_copy<uint16_t>(table, idx, out, m, d, stream);
}

REPRO_API int repro_gather_rows_dq(const int8_t* q, const float* scales,
                                   const int32_t* idx, float* out, int64_t m,
                                   int64_t d, void* stream) {
  if (m == 0 || d == 0) return 0;
  const dim3 grid(static_cast<unsigned>((m + kRowsPerCta - 1) / kRowsPerCta));
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gather_rows_dq_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      q, scales, idx, out, m, d, vec);
  REPRO_CHECK_LAUNCH();
  return 0;
}

REPRO_API int repro_gather_rows_vq(const uint8_t* codes,
                                   const float* codebook,
                                   const float* scales, const int32_t* idx,
                                   float* out, int64_t m, int64_t s_n,
                                   int64_t n_codes, void* stream) {
  if (m == 0 || s_n == 0) return 0;
  // float4 lanes: the wrapper hands 16-byte aligned codebook and output
  if (reinterpret_cast<uintptr_t>(codebook) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid(static_cast<unsigned>((m + kRowsPerCta - 1) / kRowsPerCta));
  gather_rows_vq_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      codes, codebook, scales, idx, out, m, s_n, n_codes);
  REPRO_CHECK_LAUNCH();
  return 0;
}
