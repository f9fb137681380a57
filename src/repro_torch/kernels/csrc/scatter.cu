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
// scatter_rows (f32 and bf16 tables), scatter_rows_q and
// scatter_rows_vq, pushes of at most kScanMax rows: one kernel, no
// scratch, no atomics in global memory. A CTA takes a few consecutive
// rows (scatter_rows and scatter_rows_q 8, a warp each) and decides which
// are their targets' last writers by reading every later index once and
// comparing it with its rows' targets
// (last_writers below); only those rows write. Nothing serialises on a
// target, so the ~1,100 padding rows of a serving push that all land on
// the sentinel row cost nothing extra (all but the last of a run are
// dropped before the scan), and the result is the same in any order. The
// scan compares up to M^2 / 2 pairs (~8.4 M at the serving push's M =
// 4,096); past kScanMax rows it costs more than the claim passes, and the
// wrapper hands a winner scratch for them instead.
//
// The claim passes (all three pushes past kScanMax rows): pass 1 resets
// winner[t] = -1 for every target t named in idx, pass 2 takes winner[t]
// = max position naming t (atomicMax),
// pass 3 writes row i only if winner[idx[i]] == i. The three passes run
// in stream order; `winner` is caller-allocated scratch of N int32 whose
// untouched entries are never read. In scatter_rows_q and
// scatter_rows_vq, on either path, the last writer writes both the code
// row and the scale, so a target's codes and its scale always come from
// the same pushed row.
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
// The quantizing push keeps the warp per row: a warp reduction of
// fabsf takes the row max (a max is exact in any order, so s_i is bitwise
// `row_scales`), then each element is divided with IEEE rounding
// (__fdiv_rn: the reference divides, and the build uses no fast math) and
// rounded half to even (__float2int_rn, as jnp.round; roundf would round
// half away from zero), so the codes are bitwise the plain version's.
// The same pass dequantizes each code (one IEEE multiply, as the pull)
// and sums the squares of the differences and of the values in the
// warp, so the error costs no second read of the row; its sums are taken
// in another order than the plain version's, so it agrees to rounding.
// Both paths of scatter_rows_q run that pass (quantize_row) once per
// row; only the decision of which rows write differs, so the one-launch
// path's codes, scales and errors are the claim passes' bit for bit.
//
// scatter_rows_vq: bound by operations at the serving refresh shape. Per
// pushed row and subvector every one of the 256 entries costs 8 rounded
// subtracts, 8 multiplies and 7 adds (24 f32 operations counted, as
// chip_smoke.py's bound does: 805 M at M = 4,096, S = 32, 0.012 ms at the
// 67 TFLOP/s that counts an FMA as two). None of them may fuse: the
// distance must round as the plain version's, summed left to right with
// __fsub_rn, __fmul_rn and __fadd_rn. Issued one instruction each they
// need 805 M lane-instructions, >= 0.024 ms at 128 lanes per SM and clock
// (132 SMs, 1.98 GHz): the floor this design works against.
// Design: one launch, the search as a sequential scan per (row, subvector)
// with no shuffle and no barrier inside it.
// - A CTA takes 32 / L consecutive pushed rows and all S subvectors, with
//   `warps` warps (min(S, 16), from the wrapper's plan); warp w takes
//   subvectors w, w + warps, ... one at a time. Lane l of a warp holds
//   (row l / L, split l % L) of its subvector: L = 1 at the serving push
//   (32 rows a warp, 128 CTAs of 16 warps on 132 SMs) and the refit push,
//   L = 8 where the push is too small to fill the card (a training push:
//   194 x 8 pairs, 49 CTAs); the split is the plan's, chosen on the host
//   from M, S and the SM count (kernels/scatter.py: scatter_rows_vq_plan;
//   2 and 4 lanes lost to 1 or 8 at every push of the main path).
// - The CTA first takes each row's s_i = max|v_i| (16 lanes a row, every
//   row's loads in flight together; fabsf and fmaxf: a max is exact in
//   any order, so s_i is bitwise `vq_row_scales` on finite rows) and, on
//   the one-launch path, its rows' last writers (last_writers above, its
//   first later indices loaded with the row maxes); past kScanMax rows
//   the wrapper hands a winner scratch and the claim passes run first.
// - Each warp stages its subvector's codebook slice (8 KB) in its own
//   shared memory with cp.async, in two halves (the first half of each
//   lane's range, then the second); each half is restaged with the next
//   subvector's as soon as every lane has passed it, so the 128 KB a CTA
//   reads from L2 per round arrive while the search runs (4% at the
//   refresh push). Each lane holds its subvector's u = v / s_i
//   (__fdiv_rn, the reference divides) in registers and walks its
//   entries in increasing index, the even and the odd ones in two
//   independent chains (23% at the refresh push): lanes of one split read
//   the same entry at once (a broadcast), and the splits' ranges are each
//   followed by 16 bytes of padding so that their reads fall in distinct
//   banks (36% at a training push). Each chain keeps its running minimum with a strict <, so its
//   result is the first minimum of its entries; the chains and then the
//   L lanes of a pair (one (distance, index) shuffle per step) merge on
//   the smaller distance, a tie going to the smaller index, so the first
//   minimum wins over all 256 entries, as in jnp.argmin and
//   `vq_encode_rows`.
// - The split-0 lane of each pair writes the code of every pushed row
//   (codes_out, for the codebook statistics) and, for its target's last
//   writer, the table's code; it decodes the code (the entry read from
//   L2, its slice being restaged; one __fmul_rn, as the pull) and sums the
//   squared error and the squared values of its subvectors. After the
//   search (one CTA barrier) a thread per row sums those over the warps,
//   writes the relative error and, for the last writer, the scale, so a
//   target's codes and scale come from the same pushed row and every
//   output has one owner. The errors' sums run in another order than the
//   plain version's, so they agree to rounding.
// - A non-finite value: fmaxf skips a NaN (the plain version's amax does
//   not, and its scale is then 1), so a row holding a NaN takes the max of
//   its other values, as the three-launch kernel before this design did;
//   a subvector whose u holds a NaN scores NaN against every entry, never
//   below the running minimum, and takes code 0 (so does the plain
//   version's argmin).
// The tensor cores are not used (the distances are summed in this order
// on purpose).
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

// The scan of the later indices behind both one-launch pushes
// (scatter_rows_last_kernel and scatter_rows_vq_kernel): which of a CTA's
// rows [row0, row0 + kR) (kR <= 32) are their targets' last writers. A
// row is a candidate unless its target is out of range or the next row
// names the same one (then it is surely overwritten: the padding runs of
// a push all land on the sentinel row). Every thread of the CTA reads its
// share of the later indices, kScanLoads in flight, and compares each
// with the rows' targets, one independent flag per row; the flags are
// OR-reduced over the CTA. The result is the same in any order.
//
// scan_first: the thread's first kScanLoads later indices (-1 past m: no
// candidate's target), loaded by the caller early so that their latency
// overlaps its other loads.
template <int kR>
__device__ __forceinline__ void scan_first(const int32_t* __restrict__ idx,
                                           int64_t m, int64_t row0,
                                           int32_t (&x)[kScanLoads]) {
  const int64_t j = row0 + kR + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kScanLoads; ++u)
    x[u] = j + u * blockDim.x < m ? __ldg(idx + j + u * blockDim.x) : -1;
}

// last_writers: by every thread once tgt_s (each row's target where it is
// a candidate, kNone elsewhere) is written, *later_s = 0 and the CTA
// synchronised; one CTA barrier inside. Returns, to every thread, bit r
// set for each candidate that no later row names.
template <int kR>
__device__ __forceinline__ uint32_t last_writers(
    const int32_t* __restrict__ idx, int64_t m, int64_t row0,
    const int32_t* tgt_s, uint32_t* later_s, int32_t (&x)[kScanLoads]) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  int32_t tgt[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) tgt[r] = tgt_s[r];
  // a later row of this CTA: a non-candidate's run of equal targets ends
  // at a candidate here or at a row past the CTA, which the scan reads
  uint32_t later = 0u;
  if (tid < kR)
    for (int r = tid + 1; r < kR; ++r)
      if (tgt_s[r] == tgt_s[tid]) later |= 1u << tid;
  bool hit[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) hit[r] = false;
  for (int64_t j = row0 + kR + tid; j < m; j += kScanLoads * nthreads) {
    if (j > row0 + kR + tid) {  // past the caller's first batch
#pragma unroll
      for (int u = 0; u < kScanLoads; ++u)
        x[u] = j + u * nthreads < m ? __ldg(idx + j + u * nthreads) : -1;
    }
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u)
#pragma unroll
      for (int r = 0; r < kR; ++r) hit[r] |= x[u] == tgt[r];
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
    later |= static_cast<uint32_t>(hit[r]) << r;
  later = __reduce_or_sync(0xffffffffu, later);
  if (tid % 32 == 0 && later != 0u) atomicOr(later_s, later);
  __syncthreads();
  uint32_t cand = 0u;
#pragma unroll
  for (int r = 0; r < kR; ++r)
    cand |= static_cast<uint32_t>(tgt[r] != kNone) << r;
  return cand & ~*later_s;
}

// One launch, a warp per row. Each warp reads its row's target and the
// next row's (a candidate or not, last_writers above); a candidate's value
// row is requested at once, so its latency overlaps the scan, and a CTA
// without a candidate stops at the first barrier. Otherwise the scan
// decides the last writers, and each writes its row.
template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_rows_last_kernel(V* __restrict__ table,
                         const int32_t* __restrict__ idx,
                         const V* __restrict__ vals, int64_t m, int64_t n,
                         int64_t dv) {
  __shared__ int32_t tgt_s[kRowsPerCta];  // a candidate's target, else kNone
  __shared__ uint32_t later_s;  // last_writers' flags
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
  int32_t x[kScanLoads];
  scan_first<kRowsPerCta>(idx, m, row0, x);
  if (!__syncthreads_or(lane == 0 && cand)) return;
  const uint32_t last =
      last_writers<kRowsPerCta>(idx, m, row0, tgt_s, &later_s, x);
  if (!((last >> warp) & 1u)) return;
  V* dst = table + static_cast<int64_t>(t) * dv;
#pragma unroll
  for (int u = 0; u < kRowVecs; ++u)
    if (lane + u * 32 < dv) dst[lane + u * 32] = head[u];
  for (int64_t c = lane + kRowVecs * 32; c < dv; c += 32)
    dst[c] = __ldg(src + c);
}

// the copy after the claim passes, or the one-launch scan without them
// the CTAs of a push of m rows, kRowsPerCta rows a CTA (the copy's and
// the raw push's grid)
inline int64_t copy_ctas(int64_t m) {
  return (m + kRowsPerCta - 1) / kRowsPerCta;
}

template <typename V>
void launch_copy(V* table, const int32_t* idx, const V* vals,
                 const int32_t* winner, int64_t m, int64_t n, int64_t dv,
                 cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(copy_ctas(m)));
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

// One warp's quantizing push of pushed row `row` (target t): the row max,
// the scale, every code and the row's relative error, read from the row
// twice (the second pass from L1); the codes and the scale are written to
// table row t only where `write`.
__device__ __forceinline__ void quantize_row(int8_t* __restrict__ q,
                                             float* __restrict__ scales,
                                             float* __restrict__ err,
                                             const float* __restrict__ vals,
                                             int64_t row, int32_t t,
                                             bool write, int64_t d) {
  const int lane = threadIdx.x % 32;
  const float* src = vals + row * d;
  float amax = 0.f;
  for (int64_t c = lane; c < d; c += 32)
    amax = fmaxf(amax, fabsf(__ldg(src + c)));
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

// After the claim passes: every row is quantized for its error; only the
// winner writes.
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
  quantize_row(q, scales, err, vals, row, t,
               t >= 0 && t < n && winner[t] == static_cast<int32_t>(row), d);
}

// One launch, a warp per row. Each warp reads its row's target and the
// next row's (a candidate or not, last_writers above); a CTA without a
// candidate skips the scan (the condition is the CTA's, so every thread
// reaches the scan's barrier or none does). Then every row is quantized
// for its error, and only the last writers write their codes and scale.
__global__ void __launch_bounds__(kThreads)
scatter_rows_q_last_kernel(int8_t* __restrict__ q,
                           float* __restrict__ scales,
                           float* __restrict__ err,
                           const int32_t* __restrict__ idx,
                           const float* __restrict__ vals, int64_t m,
                           int64_t n, int64_t d) {
  __shared__ int32_t tgt_s[kRowsPerCta];  // a candidate's target, else kNone
  __shared__ uint32_t later_s;  // last_writers' flags
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerCta;
  const int64_t row = row0 + warp;
  const int32_t t = row < m ? __ldg(idx + row) : -1;
  const int32_t t_next = row + 1 < m ? __ldg(idx + row + 1) : -1;
  const bool cand = t >= 0 && t < n && t != t_next;
  if (lane == 0) tgt_s[warp] = cand ? t : kNone;
  if (tid == 0) later_s = 0u;
  int32_t x[kScanLoads];
  scan_first<kRowsPerCta>(idx, m, row0, x);
  const bool write =
      __syncthreads_or(lane == 0 && cand) &&
      ((last_writers<kRowsPerCta>(idx, m, row0, tgt_s, &later_s, x) >>
        warp) & 1u);
  if (row >= m) return;
  quantize_row(q, scales, err, vals, row, t, write, d);
}

constexpr int kCodes = 256;      // codebook entries per subvector
constexpr int kSub = 8;          // subvector width
constexpr int kVqMaxWarps = 16;  // warps per CTA: subvectors in flight

// The search's mechanisms, each on by default; `chip_smoke.py
// --vq-ablation` builds the library once with each turned off and times
// the pushes of the main path on every build (PERF.md): the independent
// chains a lane keeps its minimum in (1: one chain), the slice restaged
// in halves as each is passed (0: the whole slice after the scan), a
// float4 of padding after each lane's range (0: none).
#ifndef REPRO_VQ_CHAINS
#define REPRO_VQ_CHAINS 2
#endif
#ifndef REPRO_VQ_HALVES
#define REPRO_VQ_HALVES 1
#endif
#ifndef REPRO_VQ_PAD
#define REPRO_VQ_PAD 1
#endif
constexpr int kChains = REPRO_VQ_CHAINS;
constexpr int kPad = REPRO_VQ_PAD;

// float4s a warp's staged slice takes: two per entry, and kPad of padding
// after each of the L lanes' ranges
template <int L>
constexpr int kSliceVecs = 2 * kCodes + L * kPad;

// 16 bytes of shared memory at a shared-window address
__device__ __forceinline__ float4 lds16(unsigned addr) {
  return *static_cast<const float4*>(__cvta_shared_to_generic(addr));
}

// Half h of a warp's codebook slice of one subvector into shared memory
// at `slice` (a shared-window address): of each of the L lanes' ranges of
// kPer entries, the first (h = 0) or the second (h = 1) kPer / 2, entry c
// at float4 2c + kPad * (c / kPer); one cp.async group of this lane (empty past the
// last subvector, so that every round commits the same groups).
template <int kPer>
__device__ __forceinline__ void stage_half(unsigned slice,
                                           const float* codebook,
                                           int64_t sub, int64_t s_n,
                                           int lane, int h) {
  if (sub < s_n) {
    const float4* src =
        reinterpret_cast<const float4*>(codebook + sub * kCodes * kSub);
    for (int v = lane; v < kCodes; v += 32) {  // 2 float4 of 128 entries
      const int i = v / 2;
      const int c = i / (kPer / 2) * kPer + h * (kPer / 2) + i % (kPer / 2);
      const unsigned dst = slice + 16u * (2 * c + v % 2 + c / kPer * kPad);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   ::"r"(dst), "l"(src + 2 * c + v % 2));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The 8 values of one subvector of a pushed row (16-byte aligned).
__device__ __forceinline__ void load_sub(float (&v)[kSub], const float* src) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// The squared distance of u to one codebook entry (two float4), summed
// left to right, every operation rounded on its own (no FMA), as the plain
// version sums it.
__device__ __forceinline__ float distance(const float (&u)[kSub], float4 lo,
                                          float4 hi) {
  const float e[kSub] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  float diff = __fsub_rn(u[0], e[0]);
  float dist = __fmul_rn(diff, diff);
#pragma unroll
  for (int j = 1; j < kSub; ++j) {
    diff = __fsub_rn(u[j], e[j]);
    dist = __fadd_rn(dist, __fmul_rn(diff, diff));
  }
  return dist;
}

// (best, at) takes (dist, c) where dist is smaller, or equal and c is
// smaller: the first minimum of the entries seen, in any order of merging
__device__ __forceinline__ void keep_first_min(float& best, int& at,
                                               float dist, int c) {
  if (dist < best || (dist == best && c < at)) {
    best = dist;
    at = c;
  }
}

// The lane's entries [kFrom, kTo) of its range (at `mine`), in increasing
// order, entry c in chain c % kChains, the chains independent, each
// keeping its first minimum with a strict <.
template <int kFrom, int kTo>
__device__ __forceinline__ void scan_entries(unsigned mine,
                                             const float (&u)[kSub],
                                             float (&best)[kChains],
                                             int (&at)[kChains]) {
#pragma unroll (8 / kChains)
  for (int c = kFrom; c < kTo; c += kChains) {
    float dist[kChains];
#pragma unroll
    for (int h = 0; h < kChains; ++h) {
      const unsigned e = mine + 32u * (c + h);
      dist[h] = distance(u, lds16(e), lds16(e + 16u));
    }
#pragma unroll
    for (int h = 0; h < kChains; ++h) {
      if (dist[h] < best[h]) {
        best[h] = dist[h];
        at[h] = c + h;
      }
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kVqMaxWarps * 32)
scatter_rows_vq_kernel(uint8_t* __restrict__ table, float* __restrict__ scales,
                       uint8_t* __restrict__ codes_out,
                       float* __restrict__ err,
                       const int32_t* __restrict__ idx,
                       const float* __restrict__ vals,
                       const float* __restrict__ codebook,
                       const int32_t* __restrict__ winner, int64_t m,
                       int64_t n, int64_t s_n) {
  constexpr int kR = 32 / L;        // pushed rows per CTA
  constexpr int kPer = kCodes / L;  // entries a lane scans
  extern __shared__ float4 cb_s[];  // [warps][kSliceVecs<L>]
  __shared__ float scale_s[kR];
  __shared__ int32_t tgt_s[kR];     // a candidate's target, else kNone
  __shared__ uint32_t later_s;      // last_writers' flags
  __shared__ float num_s[kVqMaxWarps][kR], den_s[kVqMaxWarps][kR];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warps = blockDim.x / 32;
  const int64_t d = s_n * kSub;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kR;
  const int nr = m - row0 < kR ? static_cast<int>(m - row0) : kR;
  const int r = lane / L;   // the lane's row and split
  const int k = lane % L;
  const bool live = r < nr;
  const int64_t row = row0 + (live ? r : 0);
  const float* src = vals + row * d;
  // the warp's slice, a shared-window address
  const unsigned slice = static_cast<unsigned>(__cvta_generic_to_shared(
      cb_s + warp * kSliceVecs<L>));

  // every global load of the prologue in flight together: the rows'
  // targets, the scan's first later indices, the lane's first subvector
  // and the rows' max |v|; the codebook slice after them
  if (tid < kR) {
    const int64_t i = row0 + tid;
    const int32_t t = i < m ? __ldg(idx + i) : -1;
    bool own = t >= 0 && t < n;
    if (winner != nullptr)  // the claim's winners
      own = own && winner[t] == static_cast<int32_t>(i);
    else                    // the scan's candidates
      own = own && (i + 1 >= m || __ldg(idx + i + 1) != t);
    tgt_s[tid] = own ? t : kNone;
  }
  if (tid == 0) later_s = 0u;
  int32_t x[kScanLoads];
  if (winner == nullptr) scan_first<kR>(idx, m, row0, x);
  float v[kSub];
  if (warp < s_n) load_sub(v, src + warp * kSub);
  // s_i: 16 lanes a row, as many rows at once as the CTA has lanes / 16
  for (int q0 = 0; q0 < nr; q0 += blockDim.x / 16) {
    const int q = q0 + tid / 16;
    const float4* xq = reinterpret_cast<const float4*>(vals + (row0 + q) * d);
    float amax = 0.f;
#pragma unroll 4
    for (int64_t c = tid % 16; q < nr && c < d / 4; c += 16) {
      const float4 t = __ldg(xq + c);
      amax = fmaxf(fmaxf(amax, fmaxf(fabsf(t.x), fabsf(t.y))),
                   fmaxf(fabsf(t.z), fabsf(t.w)));
    }
#pragma unroll
    for (int off = 8; off > 0; off /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (q < nr && tid % 16 == 0) scale_s[q] = amax > 0.f ? amax : 1.f;
  }
  stage_half<kPer>(slice, codebook, warp, s_n, lane, 0);
  stage_half<kPer>(slice, codebook, warp, s_n, lane, 1);
  __syncthreads();
  uint32_t last = 0u;  // bit q: row q writes its target
  if (winner == nullptr) {
    last = last_writers<kR>(idx, m, row0, tgt_s, &later_s, x);
  } else {
#pragma unroll
    for (int q = 0; q < kR; ++q)
      last |= static_cast<uint32_t>(tgt_s[q] != kNone) << q;
  }

  const float s_i = scale_s[live ? r : 0];
  // this split's entries [k * kPer, (k + 1) * kPer), after k paddings
  const unsigned mine = slice + 16u * (2 * k * kPer + k * kPad);
  float num = 0.f, den = 0.f;  // the split-0 lane's sums over its subvectors
  for (int64_t sub = warp; sub < s_n; sub += warps) {
    float u[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) u[j] = __fdiv_rn(v[j], s_i);
    // the first minimum of this split's entries. Each half of the slice is
    // restaged with the next subvector's as soon as every lane has passed
    // it, so the next round finds its first half staged; the groups in
    // flight are always this round's newest half and the one after it.
    float best[kChains];
    int at[kChains];
#pragma unroll
    for (int h = 0; h < kChains; ++h) {
      best[h] = __int_as_float(0x7f800000);  // +inf: NaN never wins
      at[h] = h;
    }
#if REPRO_VQ_HALVES
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();  // the first half is staged
    scan_entries<0, kPer / 2>(mine, u, best, at);
    __syncwarp();  // every lane has passed the first half
    stage_half<kPer>(slice, codebook, sub + warps, s_n, lane, 0);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();  // the second half is staged
    scan_entries<kPer / 2, kPer>(mine, u, best, at);
    __syncwarp();  // every lane has passed the second half
    stage_half<kPer>(slice, codebook, sub + warps, s_n, lane, 1);
#else
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();  // the slice is staged
    scan_entries<0, kPer>(mine, u, best, at);
    __syncwarp();  // every lane has passed it
    stage_half<kPer>(slice, codebook, sub + warps, s_n, lane, 0);
    stage_half<kPer>(slice, codebook, sub + warps, s_n, lane, 1);
#endif
#pragma unroll
    for (int h = 1; h < kChains; ++h)
      keep_first_min(best[0], at[0], best[h], at[h]);
    int code = k * kPer + at[0];
    // the pair's L lanes: the smaller distance, a tie to the smaller index
#pragma unroll
    for (int off = 1; off < L; off *= 2)
      keep_first_min(best[0], code,
                     __shfl_xor_sync(0xffffffffu, best[0], off),
                     __shfl_xor_sync(0xffffffffu, code, off));
    // the entry, from the codebook in L2 (its slice is being restaged)
    const float4* ent = reinterpret_cast<const float4*>(
        codebook + (sub * kCodes + code) * kSub);
    const float4 lo = __ldg(ent), hi = __ldg(ent + 1);
    float w[kSub];  // this subvector's values, the next one's in flight
#pragma unroll
    for (int j = 0; j < kSub; ++j) w[j] = v[j];
    if (sub + warps < s_n) load_sub(v, src + (sub + warps) * kSub);
    if (live && k == 0) {
      codes_out[row * s_n + sub] = static_cast<uint8_t>(code);
      if ((last >> r) & 1u)
        table[static_cast<int64_t>(tgt_s[r]) * s_n + sub] =
            static_cast<uint8_t>(code);
      const float e[kSub] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float diff = __fsub_rn(w[j], __fmul_rn(e[j], s_i));
        num = __fadd_rn(num, __fmul_rn(diff, diff));
        den = __fadd_rn(den, __fmul_rn(w[j], w[j]));
      }
    }
  }
  if (live && k == 0) {
    num_s[warp][r] = num;
    den_s[warp][r] = den;
  }
  __syncthreads();
  if (tid < nr) {
    float nu = 0.f, de = 0.f;
    for (int w = 0; w < warps; ++w) {
      nu = __fadd_rn(nu, num_s[w][tid]);
      de = __fadd_rn(de, den_s[w][tid]);
    }
    if ((last >> tid) & 1u) scales[tgt_s[tid]] = scale_s[tid];
    err[row0 + tid] =
        __fdiv_rn(__fsqrt_rn(nu), __fadd_rn(__fsqrt_rn(de), 1e-12f));
  }
}

// One launch of the encoding push, L lanes per (row, subvector) pair.
template <int L>
int launch_vq(uint8_t* table, float* scales, uint8_t* codes_out, float* err,
              const int32_t* idx, const float* vals, const float* codebook,
              const int32_t* winner, int64_t m, int64_t n, int64_t s_n,
              int warps, cudaStream_t s) {
  constexpr int64_t kSlice = kSliceVecs<L> * sizeof(float4);
  // the most dynamic shared memory a launch takes (past the 48 KB a launch
  // may take without this opt-in), set once per instantiation
  static cudaError_t opted = cudaFuncSetAttribute(
      scatter_rows_vq_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kVqMaxWarps * kSlice));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  constexpr int kR = 32 / L;
  const dim3 grid(static_cast<unsigned>((m + kR - 1) / kR));
  scatter_rows_vq_kernel<L><<<grid, warps * 32, warps * kSlice, s>>>(
      table, scales, codes_out, err, idx, vals, codebook, winner, m, n, s_n);
  REPRO_CHECK_LAUNCH();
  return 0;
}

// scatter_rows_raw: table_j[idx[i], :] = rows_j[i, :] bit for bit for
// every table j of a call under one index, the rows already in storage
// precision (f32 or bf16 rows, int8 or vq codes, and the [N] f32 scale
// tables as 4-byte rows), indices outside [0, N_j) dropped, the last
// writer winning. It replaces no Pallas kernel: the reference's serving
// backend lands a frontend's encoded push with `.at[].set` of every
// layer's table and scale table (src/repro/core/serve_service.py:255-298).
// The port needs it because a history table may live in pinned host
// memory (`history_storage="host"`), which no PyTorch scatter writes with
// a CUDA index, and a host-side index_put_ would race the refresh step's
// kernel writes still queued on the stream; through the buffer's unified
// address the rows are written in stream order, with no host sync. The
// split backend's `_op_push` (`HistoryStore.push_raw`, one call over
// every table) and the distributed exchange's unpack go through it. It is
// the mirror of gather_rows_raw (csrc/gather.cu). Bound: bytes, M*R read
// and M*R written (R the row's bytes summed over the tables; over the
// host link for a pinned table) plus 4*M of index. Design: one launch for
// up to kRawMaxTables tables, planned in the C entry as the pull's
// (csrc/common.cuh RawTables, each table's widest unit). A CTA takes
// kRowsPerCta pushed rows and decides once which are their targets' last
// writers, by the one-launch scan of the later indices up to kScanMax rows
// (last_writers above) or from the claim passes past it (run once for
// all the tables); then the CTA's threads, in as many groups as tables (a
// power of two, at most 8), write those rows into their tables, each
// group's threads over the unit columns, a thread loading its column of
// all 8 rows before it stores any (no division), each unit moved through
// a uint4 register whatever its width, and each thread's first column
// requested before the scan so that its latency overlaps it (as the
// one-table copy loads its row's head). A call with one table to move (a
// `scatter_rows_raw`, the distributed exchange's unpack) runs that
// one-table copy itself, which was 1.2-1.7 us faster on one table. So a
// target's rows in every table (an int8 layer's codes and its scale) come
// from the same pushed row, as scatter_rows_q and scatter_rows_vq
// guarantee, and a push pays one launch floor for all its tables
// (PERF.md section 6, row 19).
//
// One unit of 2^lg bytes (16, 8, 4, 2 or 1) at unit index `at`, through
// a uint4 register whatever its width; `lg` is uniform within a thread
// group, so the switch does not diverge.
__device__ __forceinline__ uint4 load_unit(const void* base, int64_t at,
                                           int lg) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  switch (lg) {
    case 4:
      v = __ldg(static_cast<const uint4*>(base) + at);
      break;
    case 3: {
      const uint2 w = __ldg(static_cast<const uint2*>(base) + at);
      v.x = w.x;
      v.y = w.y;
      break;
    }
    case 2:
      v.x = __ldg(static_cast<const uint32_t*>(base) + at);
      break;
    case 1:
      v.x = __ldg(static_cast<const uint16_t*>(base) + at);
      break;
    default:
      v.x = __ldg(static_cast<const uint8_t*>(base) + at);
  }
  return v;
}

__device__ __forceinline__ void store_unit(void* base, int64_t at, int lg,
                                           const uint4& v) {
  switch (lg) {
    case 4:
      static_cast<uint4*>(base)[at] = v;
      break;
    case 3:
      static_cast<uint2*>(base)[at] = make_uint2(v.x, v.y);
      break;
    case 2:
      static_cast<uint32_t*>(base)[at] = v.x;
      break;
    case 1:
      static_cast<uint16_t*>(base)[at] = static_cast<uint16_t>(v.x);
      break;
    default:
      static_cast<uint8_t*>(base)[at] = static_cast<uint8_t>(v.x);
  }
}

// One table's part of the raw push by one thread of a group of
// `threads`: unit columns c = c0, c0 + threads, ... of its CTA's
// kRowsPerCta pushed rows (`per_row` units of 2^lg bytes a row), every
// row's unit loaded before any is stored (kRowsPerCta loads in flight,
// and no division: a 64-bit one is tens of instructions). Row r writes
// table row tgt[r] where bit r of `last` is set and the target lies within
// the table's n rows.
__device__ __forceinline__ void raw_push_cols(void* table, const void* rows,
                                              int64_t n, int64_t per_row,
                                              int lg, const int32_t* tgt,
                                              uint32_t last, int64_t row0,
                                              int64_t c0, int threads) {
  uint32_t live = 0u;
#pragma unroll
  for (int r = 0; r < kRowsPerCta; ++r)
    live |= static_cast<uint32_t>(((last >> r) & 1u) && tgt[r] < n) << r;
  for (int64_t c = c0; c < per_row; c += threads) {
    uint4 v[kRowsPerCta];
#pragma unroll
    for (int r = 0; r < kRowsPerCta; ++r)
      if ((live >> r) & 1u)
        v[r] = load_unit(rows, (row0 + r) * per_row + c, lg);
#pragma unroll
    for (int r = 0; r < kRowsPerCta; ++r)
      if ((live >> r) & 1u) store_unit(table, tgt[r] * per_row + c, lg, v[r]);
  }
}

// The raw push into the `count` tables of `p`, one launch. A CTA takes
// kRowsPerCta consecutive pushed rows and decides once which are their
// targets' last writers: by the scan of the later indices (last_writers
// above), or from the claim passes' `winner` past kScanMax rows; a target
// must lie in [0, n_max), n_max the most rows of any table. The CTA's
// threads split into `groups` groups, the least power of two at or above
// the table count (at most one a warp), and group g writes those rows
// into tables g, g + groups, ... in turn, so a target's rows in every
// table (an int8 layer's codes and its scale) come from the same pushed
// row, and a push of one or two wide tables still has every warp of the
// CTA copying. Each thread loads its first column of its first table
// before the scan, as the one-table copy loads its row's head.
template <int K>
__global__ void __launch_bounds__(kThreads)
scatter_rows_raw_kernel(const RawTables<K> p, int count,
                        const int32_t* __restrict__ idx,
                        const int32_t* __restrict__ winner, int64_t m,
                        int64_t n_max) {
  __shared__ int32_t tgt_s[kRowsPerCta];  // a candidate's target, else kNone
  __shared__ uint32_t later_s;  // last_writers' flags
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerCta;
  const int64_t row = row0 + warp;
  int groups = 1;
  while (groups < count && groups < kRowsPerCta) groups *= 2;
  const int threads = kThreads / groups;
  const int j0 = tid / threads, q_lane = tid % threads;
  const int32_t t = row < m ? __ldg(idx + row) : -1;
  bool cand = t >= 0 && t < n_max;
  if (winner != nullptr)
    cand = cand && winner[t] == static_cast<int32_t>(row);
  else
    cand = cand && t != (row + 1 < m ? __ldg(idx + row + 1) : -1);
  if (lane == 0) tgt_s[warp] = cand ? t : kNone;
  if (tid == 0) later_s = 0u;
  int32_t x[kScanLoads];
  if (winner == nullptr) scan_first<kRowsPerCta>(idx, m, row0, x);
  // this thread's first column of its group's first table, every pushed
  // row's unit, is requested now, so that its latency overlaps the scan
  uint4 head[kRowsPerCta];
  if (j0 < count && q_lane < p.units[j0]) {
#pragma unroll
    for (int r = 0; r < kRowsPerCta; ++r)
      if (row0 + r < m)
        head[r] = load_unit(p.rows[j0], (row0 + r) * p.units[j0] + q_lane,
                            p.unit_log[j0]);
  }
  if (!__syncthreads_or(lane == 0 && cand)) return;
  uint32_t last = 0u;
  if (winner == nullptr) {
    last = last_writers<kRowsPerCta>(idx, m, row0, tgt_s, &later_s, x);
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerCta; ++r)
      last |= static_cast<uint32_t>(tgt_s[r] != kNone) << r;
  }
  if (j0 >= count) return;
  const int64_t per_row = p.units[j0], n = p.n[j0];
  const int lg = p.unit_log[j0];
  void* table = p.table[j0];
  if (q_lane < per_row) {
#pragma unroll
    for (int r = 0; r < kRowsPerCta; ++r) {
      const int32_t tr = tgt_s[r];
      if (((last >> r) & 1u) && tr < n)
        store_unit(table, tr * per_row + q_lane, lg, head[r]);
    }
  }
  raw_push_cols(table, p.rows[j0], n, per_row, lg, tgt_s, last, row0,
                q_lane + threads, threads);
  for (int j = j0 + groups; j < count; j += groups)
    raw_push_cols(p.table[j], p.rows[j], p.n[j], p.units[j], p.unit_log[j],
                  tgt_s, last, row0, q_lane, threads);
}

// One launch of the raw push over the next tables with bytes to move, at
// most K (*next moves past them; *done once none is left). With `ctas`
// set, nothing is launched: the launch's CTAs are added to *ctas.
template <int K>
int launch_raw_push(void* const* tables, void* const* rows,
                    const int64_t* rows_n, const int64_t* row_bytes,
                    int64_t count, const int32_t* idx, const int32_t* winner,
                    int64_t m, int64_t n_max, cudaStream_t s, int64_t* next,
                    bool* done, int64_t* ctas) {
  RawTables<K> p{};
  int64_t most = 0;
  const int k = raw_tables_next(p, tables, rows, rows_n, row_bytes, count,
                                next, &most);
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) {
    *done = true;
    return 0;
  }
  if (ctas != nullptr) {
    *ctas += copy_ctas(m);
    return 0;
  }
  const dim3 grid(static_cast<unsigned>(copy_ctas(m)));
  scatter_rows_raw_kernel<K><<<grid, kThreads, 0, s>>>(p, k, idx, winner, m,
                                                       n_max);
  REPRO_CHECK_LAUNCH();
  return 0;
}

// The raw push's launches after the claim passes (run by the caller where
// it hands a winner scratch): a call with one table to move runs
// scatter_rows' one-table copy, a warp a row with its head loaded before
// the scan (0.0059-0.0062 ms on an H100 where the many-table kernel over
// one table took 0.0071-0.0077: PERF.md, row 19); otherwise one launch for
// every kRawMaxTables tables, the last on a descriptor of kRawSmallTables
// where that few are left. With `ctas` set, their CTAs are counted
// instead.
int scatter_rows_raw_calls(void* const* tables, void* const* rows,
                           const int64_t* rows_n, const int64_t* row_bytes,
                           int64_t count, const int32_t* idx,
                           const int32_t* winner, int64_t m, cudaStream_t s,
                           int64_t* ctas) {
  int64_t n_max = 0, live = 0, only = 0;
  for (int64_t j = 0; j < count; ++j) {
    if (row_bytes[j] <= 0) continue;
    ++live;
    only = j;
    if (rows_n[j] > n_max) n_max = rows_n[j];
  }
  if (n_max == 0) return 0;
  if (live == 1 && ctas != nullptr) {
    *ctas += copy_ctas(m);
    return 0;
  }
  if (live == 1) {
    const int64_t rb = row_bytes[only];
    void* t = tables[only];
    const void* r = rows[only];
    const int64_t n = rows_n[only];
    switch (raw_unit_log(t, r, rb)) {
      case 4:
        launch_copy(static_cast<uint4*>(t), idx, static_cast<const uint4*>(r),
                    winner, m, n, rb / 16, s);
        break;
      case 3:
        launch_copy(static_cast<uint2*>(t), idx, static_cast<const uint2*>(r),
                    winner, m, n, rb / 8, s);
        break;
      case 2:
        launch_copy(static_cast<uint32_t*>(t), idx,
                    static_cast<const uint32_t*>(r), winner, m, n, rb / 4, s);
        break;
      case 1:
        launch_copy(static_cast<uint16_t*>(t), idx,
                    static_cast<const uint16_t*>(r), winner, m, n, rb / 2, s);
        break;
      default:
        launch_copy(static_cast<uint8_t*>(t), idx,
                    static_cast<const uint8_t*>(r), winner, m, n, rb, s);
    }
    REPRO_CHECK_LAUNCH();
    return 0;
  }
  int64_t next = 0;
  bool done = false;
  while (!done) {
    const int rc =
        count - next <= kRawSmallTables
            ? launch_raw_push<kRawSmallTables>(tables, rows, rows_n,
                                               row_bytes, count, idx, winner,
                                               m, n_max, s, &next, &done,
                                               ctas)
            : launch_raw_push<kRawMaxTables>(tables, rows, rows_n, row_bytes,
                                             count, idx, winner, m, n_max, s,
                                             &next, &done, ctas);
    if (rc) return rc;
  }
  return 0;
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

// tables[j][idx[i]] = rows[j][i] bit for bit for each of `count` tables
// under one index, indices outside a table's rows_n[j] dropped, the last
// writer winning in every table alike: the claim passes first where the
// caller hands a winner scratch (more than kScanMax rows; rows_n's largest
// entries), then one launch for every kRawMaxTables tables (a call with
// one table to move, scatter_rows' one-table copy), each table's rows in
// its own widest unit (the plan is made here)
REPRO_API int repro_scatter_rows_raw_many(void* const* tables,
                                          void* const* rows,
                                          const int64_t* rows_n,
                                          const int64_t* row_bytes,
                                          int64_t count, const int32_t* idx,
                                          int32_t* winner, int64_t m,
                                          void* stream) {
  if (m == 0) return 0;
  // no winner scratch: the one-launch scan, which takes at most kScanMax
  if (winner == nullptr && m > kScanMax)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t n_max = 0;
  for (int64_t j = 0; j < count; ++j)
    if (row_bytes[j] > 0 && rows_n[j] > n_max) n_max = rows_n[j];
  if (n_max == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (winner != nullptr) {
    if (int rc = claim(idx, winner, m, n_max, s)) return rc;
  }
  return scatter_rows_raw_calls(tables, rows, rows_n, row_bytes, count, idx,
                                winner, m, s, nullptr);
}

// *ctas = the CTAs, summed over its copy launches (not the claim passes),
// that repro_scatter_rows_raw_many would launch for the same tables, rows
// and M (on the same plan; for the launch floor an empty kernel takes on
// that grid)
REPRO_API int repro_scatter_rows_raw_many_ctas(void* const* tables,
                                               void* const* rows,
                                               const int64_t* rows_n,
                                               const int64_t* row_bytes,
                                               int64_t count, int64_t m,
                                               int64_t* ctas) {
  *ctas = 0;
  if (m == 0) return 0;
  return scatter_rows_raw_calls(tables, rows, rows_n, row_bytes, count,
                                nullptr, nullptr, m, nullptr, ctas);
}

REPRO_API int repro_scatter_rows_q(int8_t* q, float* scales, float* err,
                                   const int32_t* idx, const float* vals,
                                   int32_t* winner, int64_t m, int64_t n,
                                   int64_t d, void* stream) {
  if (m == 0 || d == 0) return 0;
  // no winner scratch: the one-launch scan, which takes at most kScanMax
  if (winner == nullptr && m > kScanMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((m + kRowsPerCta - 1) / kRowsPerCta));
  if (winner != nullptr) {
    if (int rc = claim(idx, winner, m, n, s)) return rc;
    scatter_rows_q_kernel<<<grid, kThreads, 0, s>>>(q, scales, err, idx,
                                                    vals, winner, m, n, d);
  } else {
    scatter_rows_q_last_kernel<<<grid, kThreads, 0, s>>>(q, scales, err, idx,
                                                         vals, m, n, d);
  }
  REPRO_CHECK_LAUNCH();
  return 0;
}

REPRO_API int repro_scatter_rows_vq(uint8_t* table, float* scales,
                                    uint8_t* codes_out, float* err,
                                    const int32_t* idx, const float* vals,
                                    const float* codebook, int32_t* winner,
                                    int64_t m, int64_t n, int64_t s_n,
                                    int64_t n_codes, int64_t lanes,
                                    int64_t warps, void* stream) {
  if (m == 0 || s_n == 0) return 0;
  // a [S, 256, 8] codebook, staged 16 bytes at a time
  if (n_codes != kCodes || warps < 1 || warps > kVqMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(codebook) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // no winner scratch: the one-launch scan, which takes at most kScanMax
  if (winner == nullptr && m > kScanMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (winner != nullptr) {
    if (int rc = claim(idx, winner, m, n, s)) return rc;
  }
  const int w = static_cast<int>(warps);
  switch (lanes) {
    case 1: return launch_vq<1>(table, scales, codes_out, err, idx, vals,
                                codebook, winner, m, n, s_n, w, s);
    case 8: return launch_vq<8>(table, scales, codes_out, err, idx, vals,
                                codebook, winner, m, n, s_n, w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
