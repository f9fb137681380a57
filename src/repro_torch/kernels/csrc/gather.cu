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
// and scale and writes 4*M*D bytes, one multiply per element. Design (both
// kernels, on a launch plan the wrapper makes, kernels/gather.py
// `row_plan`): a row is cut into units, for the copy the widest of 16, 8,
// 4, 2 or 1 bytes that divides the row and both buffers' alignment, for
// the dequant 4 codes (one char4 load, one float4 store) where D % 4 == 0
// and the buffers allow, else 1; 2^shift lanes take a row, the least
// power of two (at most 32) that covers its units, so rows of fewer than
// 32 units share a warp (32 >> shift consecutive rows: no lane idles at
// d = 64 int8 or bf16); a lane holds `unroll` (1, 2 or 4) units of its
// row in registers and issues all their loads before any store, so a warp
// has up to 32 x 4 x 16 = 2 KB in flight (a 2,000-byte f32 row of D = 500
// is one warp's single pass). Each lane loads its own row's index (the
// lanes of a warp load their rows' indices in one coalesced instruction),
// and the dequant its row's scale once; the grid is one warp per row
// group. Measured on an H100 and left out (PERF.md, section 6): 16 codes
// a lane for the dequant (one 16-byte load, four float4 stores 64 bytes
// apart; slower), a grid sized from the SM count with a grid stride and
// a warp's indices loaded together and handed out by __shfl_sync
// (slower), streaming stores (no faster) and, for the copy, whole rows
// through shared memory by Hopper's bulk asynchronous copies (slower). The
// ragged edge is masked, so no caller pads the table to a tile width.
// The index is read in the kernel; callers pre-clip it to [0, N). The
// dequant is one IEEE-rounded multiply per element (__fmul_rn, never
// contracted into anything), so the result is bitwise the plain
// version's and the reference's `dequantize_rows`.
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
constexpr int kWarps = kThreads / 32;

// The output row of this lane: warp w of the grid takes rows [w << (5 -
// shift), (w + 1) << (5 - shift)), 2^shift lanes a row; lane_col is the
// lane's place in its row.
__device__ __forceinline__ int64_t lane_row(int shift) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  return (warp << (5 - shift)) + ((threadIdx.x % 32) >> shift);
}

__device__ __forceinline__ int lane_col(int shift) {
  return threadIdx.x & ((1 << shift) - 1);
}

// out[row] = table[t], `nu` units V a row
template <typename V, int kUnroll>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table,
                   const int32_t* __restrict__ idx, V* __restrict__ out,
                   int64_t m, int64_t nu, int shift) {
  const int64_t row = lane_row(shift);
  if (row >= m) return;
  const int lanes = 1 << shift;
  const V* src = table + static_cast<int64_t>(__ldg(idx + row)) * nu;
  V* dst = out + row * nu;
  for (int64_t c = lane_col(shift); c < nu; c += lanes * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (c + k * lanes < nu) v[k] = __ldg(src + c + k * lanes);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (c + k * lanes < nu) dst[c + k * lanes] = v[k];
  }
}

template <typename V>
int launch_row_copy(const void* table, const int32_t* idx, void* out,
                    int64_t m, int64_t nu, int shift, int unroll, int ctas,
                    cudaStream_t s) {
  const V* tv = static_cast<const V*>(table);
  V* ov = static_cast<V*>(out);
  if (unroll == 1)
    gather_rows_kernel<V, 1><<<ctas, kThreads, 0, s>>>(tv, idx, ov, m, nu,
                                                       shift);
  else if (unroll == 2)
    gather_rows_kernel<V, 2><<<ctas, kThreads, 0, s>>>(tv, idx, ov, m, nu,
                                                       shift);
  else
    gather_rows_kernel<V, 4><<<ctas, kThreads, 0, s>>>(tv, idx, ov, m, nu,
                                                       shift);
  REPRO_CHECK_LAUNCH();
  return 0;
}

// a unit of C int8 codes (4 or 1), loaded as one V
template <int C> struct CodeUnit;
template <> struct CodeUnit<4> { using V = uint32_t; };
template <> struct CodeUnit<1> { using V = uint8_t; };

// code b of word w (a signed byte) times the row's scale, IEEE-rounded
__device__ __forceinline__ float dq(uint32_t w, int b, float s) {
  return __fmul_rn(static_cast<float>(static_cast<int8_t>(
                       static_cast<uint8_t>(w >> (8 * b)))), s);
}

// out[row] = float(q[t]) * scales[t], `d / C` units of C codes a row
template <int C, int kUnroll>
__global__ void __launch_bounds__(kThreads)
gather_rows_dq_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, int64_t m, int64_t d,
                      int shift) {
  using V = typename CodeUnit<C>::V;
  const int64_t row = lane_row(shift);
  if (row >= m) return;
  const int lanes = 1 << shift;
  const int64_t nu = d / C;
  const int64_t t = __ldg(idx + row);
  const float s = __ldg(scales + t);
  const V* src = reinterpret_cast<const V*>(q + t * d);
  float* dst = out + row * d;
  for (int64_t c = lane_col(shift); c < nu; c += lanes * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (c + k * lanes < nu) v[k] = __ldg(src + c + k * lanes);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (c + k * lanes >= nu) continue;
      float* o = dst + (c + k * lanes) * C;
      const uint32_t w = v[k];
      if constexpr (C == 1)
        *o = dq(w, 0, s);
      else
        *reinterpret_cast<float4*>(o) = make_float4(
            dq(w, 0, s), dq(w, 1, s), dq(w, 2, s), dq(w, 3, s));
    }
  }
}

template <int C>
int launch_dq(const int8_t* q, const float* scales, const int32_t* idx,
              float* out, int64_t m, int64_t d, int shift, int unroll,
              int ctas, cudaStream_t s) {
  if (unroll == 1)
    gather_rows_dq_kernel<C, 1><<<ctas, kThreads, 0, s>>>(q, scales, idx,
                                                          out, m, d, shift);
  else if (unroll == 2)
    gather_rows_dq_kernel<C, 2><<<ctas, kThreads, 0, s>>>(q, scales, idx,
                                                          out, m, d, shift);
  else
    gather_rows_dq_kernel<C, 4><<<ctas, kThreads, 0, s>>>(q, scales, idx,
                                                          out, m, d, shift);
  REPRO_CHECK_LAUNCH();
  return 0;
}

// a plan (kernels/gather.py `row_plan`) the kernels can run: 1 to 32
// lanes a row, an unroll of 1, 2 or 4, and a grid of at most 2^31 - 1
// CTAs whose warps cover the m rows
bool plan_ok(int64_t m, int64_t shift, int64_t unroll, int64_t ctas) {
  return shift >= 0 && shift <= 5 &&
         (unroll == 1 || unroll == 2 || unroll == 4) && ctas >= 1 &&
         ctas <= 0x7fffffff && ((ctas * kWarps) << (5 - shift)) >= m;
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

// out [M, row_bytes] = table[idx] for an f32 or bf16 table: the row copy
// in `unit`-byte units (16, 8, 4, 2 or 1; it must divide the row and both
// buffers' alignment) on the wrapper's plan
REPRO_API int repro_gather_rows(const void* table, const int32_t* idx,
                                void* out, int64_t m, int64_t row_bytes,
                                int64_t unit, int64_t shift, int64_t unroll,
                                int64_t ctas, void* stream) {
  if (m == 0 || row_bytes == 0) return 0;
  if (!plan_ok(m, shift, unroll, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (unit <= 0 || align % static_cast<uintptr_t>(unit) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nu = row_bytes / unit;
  const int sh = static_cast<int>(shift), un = static_cast<int>(unroll);
  const int g = static_cast<int>(ctas);
  switch (unit) {
    case 16: return launch_row_copy<uint4>(table, idx, out, m, nu, sh, un,
                                           g, s);
    case 8: return launch_row_copy<uint2>(table, idx, out, m, nu, sh, un, g,
                                          s);
    case 4: return launch_row_copy<uint32_t>(table, idx, out, m, nu, sh, un,
                                             g, s);
    case 2: return launch_row_copy<uint16_t>(table, idx, out, m, nu, sh, un,
                                             g, s);
    case 1: return launch_row_copy<uint8_t>(table, idx, out, m, nu, sh, un,
                                            g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [M, D] f32 = float(q[idx]) * scales[idx][:, None] in `unit`-code
// units (4: it must divide D and q's alignment, and out must be 16-byte
// aligned; or 1) on the wrapper's plan
REPRO_API int repro_gather_rows_dq(const int8_t* q, const float* scales,
                                   const int32_t* idx, float* out, int64_t m,
                                   int64_t d, int64_t unit, int64_t shift,
                                   int64_t unroll, int64_t ctas,
                                   void* stream) {
  if (m == 0 || d == 0) return 0;
  if (!plan_ok(m, shift, unroll, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          static_cast<uintptr_t>(d);
  if (unit == 4 && (align % 4 != 0 ||
                    reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sh = static_cast<int>(shift), un = static_cast<int>(unroll);
  const int g = static_cast<int>(ctas);
  switch (unit) {
    case 4: return launch_dq<4>(q, scales, idx, out, m, d, sh, un, g, s);
    case 1: return launch_dq<1>(q, scales, idx, out, m, d, sh, un, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
