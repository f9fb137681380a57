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
// Every pull's kernel reads its row's index and clips it to [0, N - 1]
// itself (the reference's `pull_rows` clips with `jnp.clip`), so a pull
// is one launch with no clamp before it. The dequant is one IEEE-rounded
// multiply per element (__fmul_rn, never contracted into anything), so
// the result is bitwise the plain version's and the reference's
// `dequantize_rows`.
//
// gather_rows_vq reads S code bytes and 8 bytes of index and scale per row
// and writes 4*S*8 bytes, one multiply per element: bound by bytes (the
// codebook, S*256*8*4 bytes, <= 256 KB at d = 256, is read once from
// device memory and then from L2). At the training pulls (GAT's: 274
// rows of S = 8) it is latency, not bytes: each output float4 ends a
// chain of dependent reads, index -> code byte -> codebook float4.
// Design: the row copy's launch plan (kernels/gather.py `vq_plan`) over
// 2*S float4 units a row, unit u the half u % 2 of subvector u / 2:
// 2^shift lanes a row, so rows of fewer than 32 units share a warp (S = 8
// takes 16 lanes, two rows a warp: no lane idles); a lane holds up to 4
// units and issues all its code loads, then all its codebook loads,
// before any store, so its chains overlap; each lane loads its row's
// index and scale once. The codebook stays in L2 and no shared memory is
// staged, whatever S: a CTA would read S*8 KB of codebook to write a few
// KB of rows. The output is exactly S*8 wide (the reference pads it to
// 128 lanes and its callers slice). Each element is one IEEE multiply
// (__fmul_rn), bitwise `vq_decode_rows`.
//
// gather_rows_raw: rows_j[i, :] = table_j[clip(idx[i], 0, N_j - 1), :] for
// every table j of a call under one index, the raw storage bits of rows
// of any width (f32, bf16, int8 codes, vq's uint8 codes, and the [N] f32
// scale tables as 1-wide rows). It replaces no Pallas kernel: the
// reference's `HistoryStore.prefetch` (src/repro/core/history.py:595-601)
// takes every layer's raw rows and scales with `jnp.take(...,
// mode="clip")`, which XLA lowers itself and is free to fuse, and streams
// them device-ward with `jax.device_put`; its serving backend's pull
// (src/repro/core/serve_service.py:255-298) does the same. The port needs
// a kernel of its own there because a history table may live in pinned
// host memory (`history_storage="host"`), which no PyTorch gather reads
// with a CUDA index: the table pointer is the pinned buffer's unified
// address, so each load crosses the host link, and only the pulled rows
// ever reach the card. Every prefetch of the epoch pipeline (any store),
// every read of a host store and every `_op_pull` of the split backend
// goes through it, one call over every layer's table and scale table.
// Bound: bytes, M*R read (R the row's bytes summed over the tables; over
// the host link for a pinned table, over HBM for a device one) plus M*R
// written and 4*M of index; no arithmetic. Design: one launch moves up to
// kRawMaxTables (64) tables: the C entry plans it (each table's unit, the
// widest of 16, 8, 4, 2 or 1 bytes that divides its row's bytes and both
// of its buffers' addresses) into a descriptor passed to the kernel by
// value (csrc/common.cuh RawTables: no device buffer, no copy, no sync);
// more tables are ceil(T / 64) launches, and a launch over at most 8
// tables takes a descriptor of 8 (288 bytes, not 2,304: a launch's
// parameters take time to send), over one table a descriptor of one.
// blockIdx.y is the table, so the unit's branch is uniform within a CTA;
// blockIdx.x strides over its units, one thread a unit, so that a narrow
// row (a 4-byte scale) does not idle a warp and a wide one is read by
// neighbouring threads at neighbouring addresses. Where one unit a thread
// would launch more than kRawSpreadCtas (528) CTAs, a thread holds
// kRawUnroll (4) units kThreads apart and issues all their loads, each an
// independent read of the table, before any store; a smaller pull keeps
// one unit a thread, so it spreads over as many SMs as it can (each SM
// keeps only so many link reads in flight: 4 units a thread on 5 CTAs
// took 0.0121 ms for a 314-row pinned pull that 20 CTAs took in 0.0097 on
// an H100: PERF.md, row 18).
// Each unit's row index is read through __ldg (an L1 hit for its row's
// other units) and clipped in the kernel; the table is read with plain
// loads (no read-only cache path for host memory). So a prefetch pays one
// launch floor and one link round trip for all its tables, where one
// launch a table paid both per table (PERF.md section 6, rows 18 and 19,
// with the units in flight, grids and descriptor sizes measured beside
// this design: see kRawUnroll below).
#include "common.cuh"


namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// a pull's row index clipped to a table of n rows, as `jnp.clip` does
__device__ __forceinline__ int64_t clip_row(int64_t t, int64_t n) {
  return t < 0 ? 0 : (t >= n ? n - 1 : t);
}

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

// out[row] = table[t], `nu` units V a row, t = idx[row] clipped to n rows
template <typename V, int kUnroll>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table,
                   const int32_t* __restrict__ idx, V* __restrict__ out,
                   int64_t m, int64_t n, int64_t nu, int shift) {
  const int64_t row = lane_row(shift);
  if (row >= m) return;
  const int lanes = 1 << shift;
  const V* src = table + clip_row(__ldg(idx + row), n) * nu;
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
                    int64_t m, int64_t n, int64_t nu, int shift, int unroll,
                    int ctas, cudaStream_t s) {
  const V* tv = static_cast<const V*>(table);
  V* ov = static_cast<V*>(out);
  if (unroll == 1)
    gather_rows_kernel<V, 1><<<ctas, kThreads, 0, s>>>(tv, idx, ov, m, n,
                                                       nu, shift);
  else if (unroll == 2)
    gather_rows_kernel<V, 2><<<ctas, kThreads, 0, s>>>(tv, idx, ov, m, n,
                                                       nu, shift);
  else
    gather_rows_kernel<V, 4><<<ctas, kThreads, 0, s>>>(tv, idx, ov, m, n,
                                                       nu, shift);
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

// out[row] = float(q[t]) * scales[t], `d / C` units of C codes a row,
// t = idx[row] clipped to n rows
template <int C, int kUnroll>
__global__ void __launch_bounds__(kThreads)
gather_rows_dq_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, int64_t m, int64_t n,
                      int64_t d, int shift) {
  using V = typename CodeUnit<C>::V;
  const int64_t row = lane_row(shift);
  if (row >= m) return;
  const int lanes = 1 << shift;
  const int64_t nu = d / C;
  const int64_t t = clip_row(__ldg(idx + row), n);
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
              float* out, int64_t m, int64_t n, int64_t d, int shift,
              int unroll, int ctas, cudaStream_t s) {
  if (unroll == 1)
    gather_rows_dq_kernel<C, 1><<<ctas, kThreads, 0, s>>>(
        q, scales, idx, out, m, n, d, shift);
  else if (unroll == 2)
    gather_rows_dq_kernel<C, 2><<<ctas, kThreads, 0, s>>>(
        q, scales, idx, out, m, n, d, shift);
  else
    gather_rows_dq_kernel<C, 4><<<ctas, kThreads, 0, s>>>(
        q, scales, idx, out, m, n, d, shift);
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

// out[row] = decode(codes[t]) * scales[t], t = idx[row] clipped to n
// rows: codes [N, S] uint8, the codebook [S, n_codes, 8] f32 read as
// float4 halves, out [M, S*8] f32 written as 2*S float4 units a row, unit
// u the half u % 2 of subvector u / 2
template <int kUnroll>
__global__ void __launch_bounds__(kThreads)
gather_rows_vq_kernel(const uint8_t* __restrict__ codes,
                      const float4* __restrict__ codebook,
                      const float* __restrict__ scales,
                      const int32_t* __restrict__ idx,
                      float4* __restrict__ out, int64_t m, int64_t n,
                      int64_t s_n, int64_t n_codes, int shift) {
  const int64_t row = lane_row(shift);
  if (row >= m) return;
  const int lanes = 1 << shift;
  const int64_t nu = 2 * s_n;
  const int64_t t = clip_row(__ldg(idx + row), n);
  const float s = __ldg(scales + t);
  const uint8_t* src = codes + t * s_n;
  float4* dst = out + row * nu;
  for (int64_t c = lane_col(shift); c < nu; c += lanes * kUnroll) {
    int64_t code[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      code[k] = c + k * lanes < nu ? __ldg(src + (c + k * lanes) / 2) : 0;
    float4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t u = c + k * lanes;
      if (u < nu)
        v[k] = __ldg(codebook + ((u / 2) * n_codes + code[k]) * 2 + u % 2);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (c + k * lanes < nu)
        dst[c + k * lanes] = make_float4(
            __fmul_rn(v[k].x, s), __fmul_rn(v[k].y, s),
            __fmul_rn(v[k].z, s), __fmul_rn(v[k].w, s));
  }
}

// The raw pull's units in flight a thread where its grid would fill the
// card, and the most CTAs a launch may have at one unit a thread before
// it takes kRawUnroll units a thread instead (4 CTAs an SM of a 132-SM
// card). A small pull spreads over as many SMs as it can: each SM keeps
// only so many host-link reads in flight. (GCNII-32L's 31-table pinned
// pull on an H100: 0.5701 ms at 4 units, 0.5969 at 2, 0.5952 at 8, 0.6196
// at one unit a thread whatever the grid; the GCN quickstart's 1-table
// pull 0.0117 ms unrolled whatever the grid against 0.0089 spread: PERF.md
// section 6, PR 32.)
constexpr int kRawUnroll = 4;
constexpr int64_t kRawSpreadCtas = 528;

// u / d for u, d >= 0, in 32 bits where both fit (a 64-bit division is
// tens of instructions)
__device__ __forceinline__ int64_t div_units(int64_t u, int64_t d) {
  if ((u | d) < (int64_t{1} << 32))
    return static_cast<uint32_t>(u) / static_cast<uint32_t>(d);
  return u / d;
}

// rows[u] = table[t * per_row + u % per_row], t = idx[u / per_row] clipped
// to n rows: one thread per V-sized unit of the output, kU units a thread
// kThreads apart, every load issued before any store
template <int kU, typename V>
__device__ __forceinline__ void raw_gather_table(
    const V* table, V* __restrict__ rows, const int32_t* __restrict__ idx,
    int64_t m, int64_t n, int64_t per_row) {
  const int64_t total = m * per_row;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kU;
  for (int64_t u0 = static_cast<int64_t>(blockIdx.x) * kThreads * kU +
                    threadIdx.x;
       u0 < total; u0 += step) {
    V v[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int64_t u = u0 + k * kThreads;
      if (u < total) {
        const int64_t row = div_units(u, per_row);
        v[k] = table[clip_row(__ldg(idx + row), n) * per_row +
                     (u - row * per_row)];
      }
    }
#pragma unroll
    for (int k = 0; k < kU; ++k)
      if (u0 + k * kThreads < total) rows[u0 + k * kThreads] = v[k];
  }
}

// table blockIdx.y of `p`, its unit width uniform within the CTA
template <int kU, int K>
__global__ void __launch_bounds__(kThreads)
gather_rows_raw_kernel(const RawTables<K> p,
                       const int32_t* __restrict__ idx, int64_t m) {
  const int j = blockIdx.y;
  const int64_t n = p.n[j], nu = p.units[j];
  void* out = p.rows[j];
  const void* in = p.table[j];
  switch (p.unit_log[j]) {
    case 4:
      raw_gather_table<kU>(static_cast<const uint4*>(in),
                           static_cast<uint4*>(out), idx, m, n, nu);
      break;
    case 3:
      raw_gather_table<kU>(static_cast<const uint2*>(in),
                           static_cast<uint2*>(out), idx, m, n, nu);
      break;
    case 2:
      raw_gather_table<kU>(static_cast<const uint32_t*>(in),
                           static_cast<uint32_t*>(out), idx, m, n, nu);
      break;
    case 1:
      raw_gather_table<kU>(static_cast<const uint16_t*>(in),
                           static_cast<uint16_t*>(out), idx, m, n, nu);
      break;
    default:
      raw_gather_table<kU>(static_cast<const uint8_t*>(in),
                           static_cast<uint8_t*>(out), idx, m, n, nu);
  }
}

// One launch over the next tables with bytes to move, at most K (*next
// moves past them; *done once none is left): one unit a thread while the
// grid stays within kRawSpreadCtas, else kRawUnroll units a thread. With
// `ctas` set, nothing is launched: the launch's CTAs are added to *ctas.
template <int K>
int launch_raw_gather(void* const* tables, void* const* rows_out,
                      const int64_t* rows_n, const int64_t* row_bytes,
                      int64_t count, const int32_t* idx, int64_t m,
                      cudaStream_t s, int64_t* next, bool* done,
                      int64_t* ctas) {
  RawTables<K> p{};
  int64_t most = 0;
  const int k = raw_tables_next(p, tables, rows_out, rows_n, row_bytes, count,
                                next, &most);
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) {
    *done = true;
    return 0;
  }
  const int64_t units = m * most;
  int64_t x = (units + kThreads - 1) / kThreads;
  const bool spread = x * k <= kRawSpreadCtas;
  if (!spread) {
    x = (units + kThreads * kRawUnroll - 1) / (kThreads * kRawUnroll);
    if (x > 0x7fffffff) x = 0x7fffffff;
  }
  if (ctas != nullptr) {
    *ctas += x * k;
    return 0;
  }
  const dim3 grid(static_cast<unsigned>(x), k);
  if (spread)
    gather_rows_raw_kernel<1, K><<<grid, kThreads, 0, s>>>(p, idx, m);
  else
    gather_rows_raw_kernel<kRawUnroll, K><<<grid, kThreads, 0, s>>>(p, idx, m);
  REPRO_CHECK_LAUNCH();
  return 0;
}

// The raw pull's launches, one for every kRawMaxTables tables, the last on
// a descriptor of kRawSmallTables where that few are left and of one where
// one is left (a one-table pull's parameters are 36 bytes, as the
// one-table kernel's were); with `ctas` set, their CTAs are counted
// instead
int gather_rows_raw_calls(void* const* tables, void* const* rows_out,
                          const int64_t* rows_n, const int64_t* row_bytes,
                          int64_t count, const int32_t* idx, int64_t m,
                          cudaStream_t s, int64_t* ctas) {
  int64_t next = 0;
  bool done = false;
  while (!done) {
    const int64_t left = count - next;
    const int rc =
        left <= 1 ? launch_raw_gather<1>(tables, rows_out, rows_n, row_bytes,
                                         count, idx, m, s, &next, &done, ctas)
        : left <= kRawSmallTables
            ? launch_raw_gather<kRawSmallTables>(tables, rows_out, rows_n,
                                                 row_bytes, count, idx, m, s,
                                                 &next, &done, ctas)
            : launch_raw_gather<kRawMaxTables>(tables, rows_out, rows_n,
                                               row_bytes, count, idx, m, s,
                                               &next, &done, ctas);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace

// rows_out[j] [M, row_bytes[j]] = tables[j][clip(idx, 0, rows_n[j] - 1)]
// for each of `count` tables under one index: one launch for every
// kRawMaxTables tables, each table's rows in its own widest unit (the plan
// is made here, from the addresses and sizes)
REPRO_API int repro_gather_rows_raw_many(void* const* tables,
                                         void* const* rows_out,
                                         const int64_t* rows_n,
                                         const int64_t* row_bytes,
                                         int64_t count, const int32_t* idx,
                                         int64_t m, void* stream) {
  if (m == 0) return 0;
  return gather_rows_raw_calls(tables, rows_out, rows_n, row_bytes, count,
                               idx, m, static_cast<cudaStream_t>(stream),
                               nullptr);
}

// *ctas = the CTAs, summed over its launches, that repro_gather_rows_raw_many
// would launch for the same tables, outputs and M (on the same plan; for
// the launch floor an empty kernel takes on that grid)
REPRO_API int repro_gather_rows_raw_many_ctas(void* const* tables,
                                              void* const* rows_out,
                                              const int64_t* rows_n,
                                              const int64_t* row_bytes,
                                              int64_t count, int64_t m,
                                              int64_t* ctas) {
  *ctas = 0;
  if (m == 0) return 0;
  return gather_rows_raw_calls(tables, rows_out, rows_n, row_bytes, count,
                               nullptr, m, nullptr, ctas);
}

// out [M, row_bytes] = table[clip(idx, 0, n - 1)] for an f32 or bf16 table
// of n rows: the row copy in `unit`-byte units (16, 8, 4, 2 or 1; it must
// divide the row and both buffers' alignment) on the wrapper's plan
REPRO_API int repro_gather_rows(const void* table, const int32_t* idx,
                                void* out, int64_t m, int64_t n,
                                int64_t row_bytes, int64_t unit,
                                int64_t shift, int64_t unroll, int64_t ctas,
                                void* stream) {
  if (m == 0 || row_bytes == 0) return 0;
  if (n <= 0 || !plan_ok(m, shift, unroll, ctas))
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
    case 16: return launch_row_copy<uint4>(table, idx, out, m, n, nu, sh,
                                           un, g, s);
    case 8: return launch_row_copy<uint2>(table, idx, out, m, n, nu, sh, un,
                                          g, s);
    case 4: return launch_row_copy<uint32_t>(table, idx, out, m, n, nu, sh,
                                             un, g, s);
    case 2: return launch_row_copy<uint16_t>(table, idx, out, m, n, nu, sh,
                                             un, g, s);
    case 1: return launch_row_copy<uint8_t>(table, idx, out, m, n, nu, sh,
                                            un, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [M, D] f32 = float(q[t]) * scales[t][:, None], t = clip(idx, 0,
// n - 1), in `unit`-code units (4: it must divide D and q's alignment, and
// out must be 16-byte aligned; or 1) on the wrapper's plan
REPRO_API int repro_gather_rows_dq(const int8_t* q, const float* scales,
                                   const int32_t* idx, float* out, int64_t m,
                                   int64_t n, int64_t d, int64_t unit,
                                   int64_t shift, int64_t unroll,
                                   int64_t ctas, void* stream) {
  if (m == 0 || d == 0) return 0;
  if (n <= 0 || !plan_ok(m, shift, unroll, ctas))
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
    case 4: return launch_dq<4>(q, scales, idx, out, m, n, d, sh, un, g,
                                s);
    case 1: return launch_dq<1>(q, scales, idx, out, m, n, d, sh, un, g,
                                s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [M, S*8] f32 = decode(codes[t]) * scales[t][:, None], t = clip(idx,
// 0, n - 1), in float4 units (the codebook and out 16-byte aligned) on the
// wrapper's plan (kernels/gather.py `vq_plan`)
REPRO_API int repro_gather_rows_vq(const uint8_t* codes,
                                   const float* codebook,
                                   const float* scales, const int32_t* idx,
                                   float* out, int64_t m, int64_t n,
                                   int64_t s_n, int64_t n_codes,
                                   int64_t shift, int64_t unroll,
                                   int64_t ctas, void* stream) {
  if (m == 0 || s_n == 0) return 0;
  if (n <= 0 || !plan_ok(m, shift, unroll, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(codebook) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* cb = reinterpret_cast<const float4*>(codebook);
  float4* o = reinterpret_cast<float4*>(out);
  const int sh = static_cast<int>(shift), g = static_cast<int>(ctas);
  if (unroll == 1)
    gather_rows_vq_kernel<1><<<g, kThreads, 0, s>>>(
        codes, cb, scales, idx, o, m, n, s_n, n_codes, sh);
  else if (unroll == 2)
    gather_rows_vq_kernel<2><<<g, kThreads, 0, s>>>(
        codes, cb, scales, idx, o, m, n, s_n, n_codes, sh);
  else
    gather_rows_vq_kernel<4><<<g, kThreads, 0, s>>>(
        codes, cb, scales, idx, o, m, n, s_n, n_codes, sh);
  REPRO_CHECK_LAUNCH();
  return 0;
}
