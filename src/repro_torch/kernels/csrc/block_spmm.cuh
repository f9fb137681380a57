// The block-CSR contraction shared by bcsr_spmm.cu and fused.cu:
//
//   out[r*128 + a, c] = sum_k sum_b vals[r, k, a, b] * rows_k[b, c]
//
// where rows_k[b, :] is the b-th staged row of column block k. The
// kernels differ only in where a staged row comes from and how its
// elements become f32 (the RowSrc functor): bcsr_spmm reads
// x[cols[r, k]*128 + b]; gather_spmm routes the row through the gather
// plan to x_in, the history table or zeros, and its bodies read an f32
// table, a bf16 table (upcast exactly), an int8 table with its per-row
// scale (one multiply per element, as the reference's dequant) or a vq
// code table decoded against its codebook (one lookup and the same one
// multiply). A RowSrc has a `Row` type (a small handle, e.g. a pointer,
// or a pointer and a scale), `row(r, k, b)` returning the handle of
// staged row b of block (r, k), and `load(handle, c)` returning element
// c of that row as f32 (zero, with no memory read, for a handle that
// names no row).
//
// Bound: bytes. The function's inputs are the blocks as the reference
// stores them, R*K*64 KB of f32 values, and it needs 2*D f32 operations
// per nonzero entry. A serving refresh batch's blocks hold about one
// nonzero in two thousand stored values (a training batch's one in two
// hundred), so reading the blocks once bounds it: at the PubMed-shaped
// refresh batch their 159 MB alone take 0.048 ms at 3.35 TB/s (with the
// rows reached and the output, chip_smoke.py's bound is 0.056 ms).
//
// Design: a sparse stream over dense storage, in two parts per warp.
// - A warp per output row. A CTA holds kRowsPerCta warps for as many
//   consecutive rows a of one row block r; the grid is (R*128 /
//   kRowsPerCta, ceil(D / D_tile)), D_tile = 32*J columns, J (columns
//   per lane) the least power of two that covers D, at most 16: every
//   width in the repo (D <= 500) takes one column tile, and a wider D
//   re-reads the blocks once per 512-column tile. Lane l owns columns
//   l + 32j, so a staged row's elements are read coalesced.
// - The stream. For k = 0..K-1 the warp reads vals[r, k, a, :] (512 B,
//   16 bytes a lane), so each block byte is read by one warp once per
//   column tile. The reads go through a ring of kDepth slots a warp in
//   shared memory (cp.async, the next kDepth - 1 in flight, holding no
//   registers: the accumulators and the drain's loads need them), with an
//   L2 evict-first policy: the blocks pass through L2 once and would
//   otherwise evict the staged rows the nonzeros read (without it the
//   contractions took 1.08-1.23x as long on the H100). The policy is a
//   template switch: csrc/edge_softmax.cu streams inside a loop over
//   tiles, and there nvcc 12.9's sm_90a code with the policy raised an
//   illegal instruction on the H100, made inside the loop or ahead of it;
//   its blocks are a few hundred KB, so it streams with the default
//   policy. Four ballots find a block row's nonzeros; each lane appends
//   its own to the warp's queue in shared memory after the lower lanes',
//   so the queue holds (value, k, b) in (k, b) ascending order. A block
//   row with no nonzero costs its 512 B and a few instructions (empty
//   blocks, padding row blocks).
// - The nonzeros. When the queue would overflow, and after the stream,
//   the warp drains it in order, kBatch entries at a time: it makes their
//   staged rows' handles (RowSrc::row: column id or plan entry, then
//   scale), issues all their row loads, then does each lane's J fmaf's
//   per entry into its register accumulators. A staged row is a chain of
//   dependent loads (plan, then row, then for vq the codebook); walked
//   where the stream finds it, each nonzero would stall the stream on
//   that chain. Deferred and batched, the chains overlap one another and
//   no longer hold the stream. A staged row of zeros (past x's rows, sel == 2) is
//   never read.
// - The stream (ring, ballots, queue) is `stream_block_row`, which
//   csrc/edge_softmax.cu's three passes share; the drain is each
//   kernel's own.
// - No tensor cores: at these densities wgmma would multiply the zeros
//   again, and the reference contracts in f32. Fully dense blocks run at
//   the CUDA cores' rate, a queue drain per block row and one L1 read
//   per FMA; their time is recorded beside the sparse ones in PERF.md
//   and is not optimised here (no GAS path makes dense blocks).
//
// Order and exactness. Each output element is one chain of fmaf's over
// (k ascending, b ascending) from +0, the dense product's chain in that
// order minus the terms whose block value is zero: fmaf(0, x, acc)
// returns acc for finite x (up to the sign of a zero sum), so for finite
// inputs the result equals the dense chain's, deterministic, with no
// atomics and no split over k. The staged operands are exactly the plain
// version's (RowSrc).
//
// The one departure from the reference: it computes 0 * inf = NaN for a
// zero entry against a non-finite x row; this kernel skips zero entries,
// so a non-finite row that only zero entries reach does not spread into
// the output. No GAS path feeds non-finite rows (features, tables and
// padding are finite). A non-finite block value is multiplied like any
// other nonzero.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kBn = 128;          // adjacency block edge
constexpr int kWarp = 32;
constexpr int kRowsPerCta = 8;    // one warp per output row
constexpr int kMaxCols = 16;      // columns per lane: D_tile <= 512
constexpr int kDepth = 4;         // ring slots a warp: block rows in flight
constexpr int kQueue = 128;       // queued nonzeros a warp
constexpr int kBatch = 2;         // staged rows loaded together in a drain
constexpr unsigned kAll = 0xffffffffu;

// A queued nonzero entry: its value and its place, k * 128 + b.
struct Entry {
  float w;
  int32_t kb;
};

// Stream row a of block row r of vals [R, K, 128, 128] for one warp.
// For k = 0..K-1 the warp reads vals[r, k, a, :] through its ring (`ring`
// at the lane's float4 of slot 0, kDepth slots kWarp apart) and queues the
// block row's nonzeros as (value, k * 128 + b) in (k, b) order; drain(n)
// takes the n queued entries in queue order whenever the next block row's
// would overflow the queue, and once after the stream (n may be 0 there).
// kEvictFirst reads the block rows with an L2 evict-first policy.
// The queue is warp-synchronised around each drain.
template <bool kEvictFirst, class Drain>
__device__ __forceinline__ void stream_block_row(const float* __restrict__ vals,
                                                 int64_t r, int a, int64_t K,
                                                 float4* ring, Entry* queue,
                                                 Drain&& drain) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;  // the lanes below this one
  auto flush = [&](int n) {
    __syncwarp();  // every lane's entries are in the queue
    drain(n);
    __syncwarp();  // the queue may be refilled
  };

  // queue block row (r, k, a)'s nonzeros; v is this lane's 4 values
  int n = 0;  // queued entries (warp-uniform)
  auto enqueue = [&](int64_t k, const float4 v) {
    const unsigned m0 = __ballot_sync(kAll, v.x != 0.f);
    const unsigned m1 = __ballot_sync(kAll, v.y != 0.f);
    const unsigned m2 = __ballot_sync(kAll, v.z != 0.f);
    const unsigned m3 = __ballot_sync(kAll, v.w != 0.f);
    const int total = __popc(m0) + __popc(m1) + __popc(m2) + __popc(m3);
    if (total == 0) return;
    if (n + total > kQueue) {
      flush(n);
      n = 0;
    }
    int at = n + __popc(m0 & below) + __popc(m1 & below) +
             __popc(m2 & below) + __popc(m3 & below);
    const int kb = static_cast<int>(k) * kBn + 4 * lane;
    if (v.x != 0.f) queue[at++] = {v.x, kb};
    if (v.y != 0.f) queue[at++] = {v.y, kb + 1};
    if (v.z != 0.f) queue[at++] = {v.z, kb + 2};
    if (v.w != 0.f) queue[at++] = {v.w, kb + 3};
    n += total;
  };

  // this lane's 16 bytes of row a of block (r, k) into ring slot k % kDepth
  // (one commit group per k, empty past K)
  const float4* blk =
      reinterpret_cast<const float4*>(vals + (r * K * kBn + a) * kBn) + lane;
  uint64_t evict_first = 0;
  if constexpr (kEvictFirst)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(evict_first));
  auto issue = [&](int64_t k) {
    if (k < K) {
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(ring + (k % kDepth) * kWarp));
      const float4* src = blk + k * (kBn * kBn / 4);
      if constexpr (kEvictFirst)
        asm volatile(
            "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
            ::"r"(dst), "l"(src), "l"(evict_first));
      else
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     ::"r"(dst), "l"(src));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

#pragma unroll
  for (int p = 0; p < kDepth - 1; ++p) issue(p);
  for (int64_t k = 0; k < K; ++k) {
    // groups 0..k are complete: slot k holds this lane's 16 bytes
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 2));
    const float4 v = ring[(k % kDepth) * kWarp];
    issue(k + kDepth - 1);  // into the slot read one step ago
    enqueue(k, v);
  }
  flush(n);
}

template <int J, class RowSrc>
__global__ void __launch_bounds__(kWarp * kRowsPerCta)
block_spmm_kernel(const float* __restrict__ vals, int64_t K, int64_t d,
                  float* __restrict__ out, const RowSrc src) {
  __shared__ __align__(16) float4 ring_s[kRowsPerCta][kDepth][kWarp];
  __shared__ Entry queue_s[kRowsPerCta][kQueue];

  const int lane = threadIdx.x;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.y;
  const int64_t r = row / kBn;
  const int a = static_cast<int>(row % kBn);
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * J * kWarp + lane;
  // this lane's columns c0 + 32j that lie below D: j < jn
  const int64_t left = d - c0;
  const int jn = left <= 0 ? 0
                 : left > (J - 1) * kWarp
                     ? J
                     : static_cast<int>((left + kWarp - 1) / kWarp);
  const Entry* queue = queue_s[threadIdx.y];

  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;

  // multiply the n queued entries, in queue order
  auto drain = [&](int n) {
    for (int i = 0; i < n; i += kBatch) {
      float w[kBatch];
      typename RowSrc::Row h[kBatch];
      float x[kBatch][J];
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        if (i + p < n) {
          const Entry e = queue[i + p];
          w[p] = e.w;
          h[p] = src.row(r, e.kb / kBn, e.kb % kBn);
        }
      }
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        if (i + p < n) {
#pragma unroll
          for (int j = 0; j < J; ++j)
            x[p][j] = j < jn ? src.load(h[p], c0 + j * kWarp) : 0.f;
        }
      }
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        if (i + p < n) {
#pragma unroll
          for (int j = 0; j < J; ++j) acc[j] = fmaf(w[p], x[p][j], acc[j]);
        }
      }
    }
  };
  stream_block_row<true>(vals, r, a, K, &ring_s[threadIdx.y][0][lane],
                         queue_s[threadIdx.y], drain);

#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < jn) out[row * d + c0 + j * kWarp] = acc[j];
}

template <int J, class RowSrc>
void launch_tiles(const float* vals, int64_t R, int64_t K, int64_t d,
                  float* out, const RowSrc& src, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(R * kBn / kRowsPerCta),
                  static_cast<unsigned>((d + J * kWarp - 1) / (J * kWarp)));
  block_spmm_kernel<J, RowSrc><<<grid, dim3(kWarp, kRowsPerCta), 0,
                                 stream>>>(vals, K, d, out, src);
}

// J, the columns per lane, is the least power of two with 32*J >= D,
// capped at kMaxCols (then D takes ceil(D / 512) column tiles). A queue
// entry keeps k * 128 + b in 32 bits.
template <class RowSrc>
int launch_block_spmm(const float* vals, int64_t R, int64_t K, int64_t d,
                      float* out, const RowSrc& src, void* stream) {
  if (R == 0 || d == 0) return 0;
  if (K * kBn > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (d <= 1 * kWarp) launch_tiles<1>(vals, R, K, d, out, src, s);
  else if (d <= 2 * kWarp) launch_tiles<2>(vals, R, K, d, out, src, s);
  else if (d <= 4 * kWarp) launch_tiles<4>(vals, R, K, d, out, src, s);
  else if (d <= 8 * kWarp) launch_tiles<8>(vals, R, K, d, out, src, s);
  else launch_tiles<kMaxCols>(vals, R, K, d, out, src, s);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace repro
