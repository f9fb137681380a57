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
// scales with XLA) and scatter.py:141 scatter_rows_vq (the same grid, the
// nearest-entry search of `jnp.sum(jnp.square(u - cb), -1)` and
// `jnp.argmin` over the VMEM-resident codebook in the kernel, s_i again
// from outside).
//
// Semantics: rows whose index lies outside [0, N) are dropped; duplicate
// valid indices resolve to the LAST occurrence in row order. The TPU
// grid gets that for free by running in order; CTAs here run in no
// order, so the winner of each target row is resolved before any row is
// written, in one of two ways.
//
// scatter_rows (f32 and bf16 tables), pushes of at most kScanMax rows:
// one kernel, no scratch, no atomics in global memory. A CTA takes 8 rows
// (a warp each) and decides which are their targets' last writers by
// reading every later index once and comparing it with its rows'
// targets (scatter_rows_last_kernel below); only those rows are copied.
// Nothing serialises on a target, so the ~1,100 padding rows of a serving
// push that all land on the sentinel row cost nothing extra (all but the
// last of a run are dropped before the scan), and the result is the same
// in any order. The scan compares up to M^2 / 2 pairs (~8.4 M at the
// serving push's M = 4,096); past kScanMax rows it costs more than the
// claim passes, and the wrapper hands a winner scratch for them instead.
//
// The claim passes (scatter_rows past kScanMax rows, scatter_rows_q and
// scatter_rows_vq): pass 1 resets winner[t] = -1 for every target t named
// in idx, pass 2 takes winner[t] = max position naming t (atomicMax),
// pass 3 writes row i only if winner[idx[i]] == i. The three passes run
// in stream order; `winner` is caller-allocated scratch of N int32 whose
// untouched entries are never read. In scatter_rows_q the winner writes
// both the code row and the scale, so a target's codes and its scale
// always come from the same pushed row.
//
// Bound: bytes. scatter_rows reads M*D*E bytes of values and writes M*D*E
// bytes of table rows (E = 4 for f32, 2 for bf16; the push rounds f32 to
// bf16 before the copy, in PyTorch); scatter_rows_q reads M*D*4 bytes and
// writes M*D int8 bytes plus 4*M of scales and 4*M of errors (plus, for
// the claim passes, the index vector three times and 8*M bytes of winner
// traffic; the one-launch scan reads the later indices once per CTA, from
// L2, its own cost).
// Design: the copy is the gather's layout — one warp per row, 16-byte
// lanes where the row's bytes and the buffers allow, ragged edge masked
// in the loop bound.
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
//
// scatter_rows_vq: bound by operations at the serving refresh shape. Per
// pushed row and subvector every one of the 256 entries costs 8 rounded
// subtracts, 8 multiplies and 7 adds (24 f32 operations counted), so a
// row of d = 256 needs 32 * 256 * 24 = 196,608 operations against 1 KB of
// values. Design: a CTA of 256 threads takes a group of up to 8 pushed
// rows (fewer for wide rows: their normalized values sit in dynamic
// shared memory, at most 48 KB); thread c is codebook entry c. The CTA
// reduces each row's max (a max is exact in any order, so s_i is bitwise
// `vq_row_scales`), stores u = v / s_i (__fdiv_rn, the reference
// divides), then per subvector each thread loads its entry's 8 values
// once (two float4 reads, adjacent threads on adjacent entries, from L2)
// and scores all the group's rows against it: the distance is summed
// left to right with __fsub_rn, __fmul_rn and __fadd_rn, so that the
// build's FMA contraction cannot fuse a square into the sum, exactly as
// XLA and the plain version sum it. The argmin reduces (distance, index)
// pairs, a smaller index winning a tie, across the warp with shuffles and
// across the 8 warps in shared memory, so the first minimum wins, as in
// jnp.argmin. One thread per row then writes the code of every pushed row
// (codes_out, for the codebook statistics) and, if the row is its
// target's last writer (the claim passes above), the table's code and the
// scale; it also decodes the code (one __fmul_rn, as the pull) and sums
// the squared error and the squared values for the row's relative error.
// The codebook is read from L2 once per group and subvector; the tensor
// cores are not used (the distances are summed in this order on purpose).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;
// the most rows scatter_rows decides by the one-launch scan (the
// wrapper's SCAN_MAX_ROWS); its later-index loads a thread has in flight;
// the vectors of a candidate's value row a lane loads before the scan
constexpr int64_t kScanMax = 4096;
constexpr int kScanLoads = 8;
constexpr int kRowVecs = 2;
constexpr int32_t kNone = INT32_MIN;  // no candidate's target

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

// One launch, a warp per row. Each warp reads its row's target and the
// next row's: a row is a candidate unless its target is out of range or
// the next row names the same one (then it is surely overwritten: the
// padding runs of a push all land on the sentinel row). A candidate's
// value row is requested at once, so its latency overlaps the scan, and a
// CTA without a candidate stops at the first barrier. Otherwise the CTA's
// 256 threads read every later index once (kScanLoads in flight each) and
// compare it with the candidates' targets, one independent flag per row;
// the flags are OR-reduced over the CTA, and a candidate that no later
// row names writes its row.
template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_rows_last_kernel(V* __restrict__ table,
                         const int32_t* __restrict__ idx,
                         const V* __restrict__ vals, int64_t m, int64_t n,
                         int64_t dv) {
  __shared__ int32_t tgt_s[kRowsPerCta];  // a candidate's target, else kNone
  __shared__ uint32_t later_s;  // bit r: a later row names row r's target
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerCta;
  const int64_t row = row0 + warp;
  const int32_t t = row < m ? __ldg(idx + row) : -1;
  const int32_t t_next = row + 1 < m ? __ldg(idx + row + 1) : -1;
  const bool cand = t >= 0 && t < n && t != t_next;
  const V* src = vals + row * dv;
  V head[kRowVecs];
#pragma unroll
  for (int u = 0; u < kRowVecs; ++u)
    if (cand && lane + u * 32 < dv) head[u] = __ldg(src + lane + u * 32);
  if (lane == 0) tgt_s[warp] = cand ? t : kNone;
  if (tid == 0) later_s = 0u;
  if (!__syncthreads_or(lane == 0 && cand)) return;
  int32_t tgt[kRowsPerCta];
#pragma unroll
  for (int r = 0; r < kRowsPerCta; ++r) tgt[r] = tgt_s[r];
  // a later row of this CTA: a non-candidate's run of equal targets ends
  // at a candidate here or at a row past the CTA, which the scan reads
  uint32_t later = 0u;
  if (tid < kRowsPerCta)
    for (int r = tid + 1; r < kRowsPerCta; ++r)
      if (tgt_s[r] == tgt_s[tid]) later |= 1u << tid;
  bool hit[kRowsPerCta];
#pragma unroll
  for (int r = 0; r < kRowsPerCta; ++r) hit[r] = false;
  for (int64_t j = row0 + kRowsPerCta + tid; j < m;
       j += kScanLoads * kThreads) {
    int32_t x[kScanLoads];  // -1 past m: no candidate's target
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u)
      x[u] = j + u * kThreads < m ? __ldg(idx + j + u * kThreads) : -1;
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u)
#pragma unroll
      for (int r = 0; r < kRowsPerCta; ++r) hit[r] |= x[u] == tgt[r];
  }
#pragma unroll
  for (int r = 0; r < kRowsPerCta; ++r)
    later |= static_cast<uint32_t>(hit[r]) << r;
  later = __reduce_or_sync(0xffffffffu, later);
  if (lane == 0 && later != 0u) atomicOr(&later_s, later);
  __syncthreads();
  if (!cand || ((later_s >> warp) & 1u)) return;
  V* dst = table + static_cast<int64_t>(t) * dv;
#pragma unroll
  for (int u = 0; u < kRowVecs; ++u)
    if (lane + u * 32 < dv) dst[lane + u * 32] = head[u];
  for (int64_t c = lane + kRowVecs * 32; c < dv; c += 32)
    dst[c] = __ldg(src + c);
}

// the copy after the claim passes, or the one-launch scan without them
template <typename V>
void launch_copy(V* table, const int32_t* idx, const V* vals,
                 const int32_t* winner, int64_t m, int64_t n, int64_t dv,
                 cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + kRowsPerCta - 1) / kRowsPerCta));
  if (winner != nullptr)
    scatter_rows_kernel<V><<<grid, kThreads, 0, s>>>(table, idx, vals, winner,
                                                     m, n, dv);
  else
    scatter_rows_last_kernel<V><<<grid, kThreads, 0, s>>>(table, idx, vals, m,
                                                          n, dv);
}

template <typename E>
int launch_scatter(void* table, const int32_t* idx, const void* vals,
                   int32_t* winner, int64_t m, int64_t n, int64_t d,
                   void* stream) {
  if (m == 0 || d == 0) return 0;
  // no winner scratch: the one-launch scan, which takes at most kScanMax
  if (winner == nullptr && m > kScanMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (winner != nullptr) {
    if (int rc = claim(idx, winner, m, n, s)) return rc;
  }
  constexpr int64_t kPerVec = sizeof(uint4) / sizeof(E);
  const bool vec = d % kPerVec == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  if (vec)
    launch_copy(static_cast<uint4*>(table), idx,
                static_cast<const uint4*>(vals), winner, m, n, d / kPerVec,
                s);
  else
    launch_copy(static_cast<E*>(table), idx, static_cast<const E*>(vals),
                winner, m, n, d, s);
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

constexpr int kCodes = 256;    // codebook entries: one per thread
constexpr int kSub = 8;        // subvector width
constexpr int kVqRows = 8;     // pushed rows per CTA (at most)
constexpr int kVqSmem = 48 * 1024;

__device__ __forceinline__ void argmin_pair(float& d, int& i, float od,
                                            int oi) {
  if (od < d || (od == d && oi < i)) {
    d = od;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_vq_kernel(uint8_t* __restrict__ table, float* __restrict__ scales,
                       uint8_t* __restrict__ codes_out,
                       float* __restrict__ err,
                       const int32_t* __restrict__ idx,
                       const float* __restrict__ vals,
                       const float* __restrict__ codebook,
                       const int32_t* __restrict__ winner, int64_t m,
                       int64_t n, int64_t s_n, int rows) {
  extern __shared__ float u_s[];             // [rows][d]
  __shared__ float red_d[kVqRows][kThreads / 32];
  __shared__ int red_i[kVqRows][kThreads / 32];
  __shared__ float scale_s[kVqRows];
  __shared__ int64_t tgt_s[kVqRows];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t d = s_n * kSub;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nr = m - row0 < rows ? static_cast<int>(m - row0) : rows;

  // the rows' max |v| (a block reduction per row)
  for (int r = 0; r < nr; ++r) {
    const float* src = vals + (row0 + r) * d;
    float amax = 0.f;
    for (int64_t j = tid; j < d; j += kThreads)
      amax = fmaxf(amax, fabsf(__ldg(src + j)));
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) red_d[r][warp] = amax;
  }
  __syncthreads();
  if (tid < nr) {
    float amax = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) amax = fmaxf(amax, red_d[tid][w]);
    scale_s[tid] = amax > 0.f ? amax : 1.f;
    const int64_t row = row0 + tid;
    const int32_t t = idx[row];
    tgt_s[tid] = (t >= 0 && t < n && winner[t] == static_cast<int32_t>(row))
                     ? t : -1;
  }
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    const float* src = vals + (row0 + r) * d;
    for (int64_t j = tid; j < d; j += kThreads)
      u_s[r * d + j] = __fdiv_rn(__ldg(src + j), scale_s[r]);
  }
  __syncthreads();

  float num = 0.f, den = 0.f;                // thread r < nr: row r's sums
  for (int64_t sub = 0; sub < s_n; ++sub) {
    const float4* e4 = reinterpret_cast<const float4*>(
        codebook + (sub * kCodes + tid) * kSub);
    const float4 lo = __ldg(e4), hi = __ldg(e4 + 1);
    const float e[kSub] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    for (int r = 0; r < nr; ++r) {
      const float* u = u_s + r * d + sub * kSub;
      float diff = __fsub_rn(u[0], e[0]);
      float acc = __fmul_rn(diff, diff);
#pragma unroll
      for (int j = 1; j < kSub; ++j) {
        diff = __fsub_rn(u[j], e[j]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      int best = tid;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        argmin_pair(acc, best, __shfl_xor_sync(0xffffffffu, acc, off),
                    __shfl_xor_sync(0xffffffffu, best, off));
      if (lane == 0) {
        red_d[r][warp] = acc;
        red_i[r][warp] = best;
      }
    }
    __syncthreads();
    if (tid < nr) {
      float bd = red_d[tid][0];
      int bi = red_i[tid][0];
      for (int w = 1; w < kThreads / 32; ++w)
        argmin_pair(bd, bi, red_d[tid][w], red_i[tid][w]);
      const int64_t row = row0 + tid;
      const uint8_t code = static_cast<uint8_t>(bi);
      codes_out[row * s_n + sub] = code;
      if (tgt_s[tid] >= 0) table[tgt_s[tid] * s_n + sub] = code;
      const float* ent = codebook + (sub * kCodes + bi) * kSub;
      const float* src = vals + row * d + sub * kSub;
      for (int j = 0; j < kSub; ++j) {
        const float v = __ldg(src + j);
        const float diff = __fsub_rn(v, __fmul_rn(__ldg(ent + j), scale_s[tid]));
        num = __fadd_rn(num, __fmul_rn(diff, diff));
        den = __fadd_rn(den, __fmul_rn(v, v));
      }
    }
    __syncthreads();  // red_* are reused by the next subvector
  }
  if (tid < nr) {
    if (tgt_s[tid] >= 0) scales[tgt_s[tid]] = scale_s[tid];
    err[row0 + tid] =
        __fdiv_rn(__fsqrt_rn(num), __fadd_rn(__fsqrt_rn(den), 1e-12f));
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

REPRO_API int repro_scatter_rows_vq(uint8_t* table, float* scales,
                                    uint8_t* codes_out, float* err,
                                    const int32_t* idx, const float* vals,
                                    const float* codebook, int32_t* winner,
                                    int64_t m, int64_t n, int64_t s_n,
                                    int64_t n_codes, void* stream) {
  if (m == 0 || s_n == 0) return 0;
  // one thread per entry, float4 reads of the entries: the wrapper hands a
  // [S, 256, 8] codebook, 16-byte aligned
  if (n_codes != kCodes) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(codebook) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // static and dynamic shared memory together stay within the 48 KB a
  // launch may take without an opt-in
  static int64_t static_smem = -1;
  if (static_smem < 0) {
    cudaFuncAttributes attr;
    if (cudaError_t e = cudaFuncGetAttributes(&attr, scatter_rows_vq_kernel))
      return static_cast<int>(e);
    static_smem = static_cast<int64_t>(attr.sharedSizeBytes);
  }
  const int64_t row_bytes = s_n * kSub * static_cast<int64_t>(sizeof(float));
  const int64_t fit = (kVqSmem - static_smem) / row_bytes;
  const int rows = fit < kVqRows ? static_cast<int>(fit) : kVqRows;
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int rc = claim(idx, winner, m, n, s)) return rc;
  const dim3 grid(static_cast<unsigned>((m + rows - 1) / rows));
  scatter_rows_vq_kernel<<<grid, kThreads, rows * row_bytes, s>>>(
      table, scales, codes_out, err, idx, vals, codebook, winner, m, n, s_n,
      rows);
  REPRO_CHECK_LAUNCH();
  return 0;
}
