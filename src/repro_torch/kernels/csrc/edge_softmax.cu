// GAT's edge softmax over unit-weight (multiplicity) BCSR blocks: the
// forward aggregation and the two backward passes.
//
// Replaces src/repro/kernels/edge_softmax.py:
//   92  edge_softmax_fwd      -> repro_edge_softmax_fwd_f32
//   189 edge_softmax_bwd_row  -> repro_edge_softmax_bwd_row_f32
//   276 edge_softmax_bwd_col  -> repro_edge_softmax_bwd_col_f32
//
// For destination i, head h, over the edges j -> i (block entry mult_ij is
// the edge multiplicity, 0 = no edge):
//   z_ij = ad[i,h] + as_[j,h],  s_ij = leaky_relu(z_ij)  (NEG where mult == 0)
//   M_i = max_j s_ij,  L_i = sum_j mult_ij exp(s_ij - M_i)
//   alpha_ij = mult_ij exp(s_ij - M_i) / max(L_i, TINY),
//   alpha'_ij = alpha_ij * lrelu'(z_ij)
//   out_i = sum_j alpha_ij wx_j                                  (fwd)
//   dad_i = sum_j alpha'_ij (g_i . wx_j) - delta_i sum_j alpha'_ij (row)
//   dwx_j = sum_i alpha_ij g_i,
//   das_j = sum_i alpha'_ij (g_i . wx_j - delta_i)                 (col)
// with delta_i = g_i . out_i computed by the caller.
//
// Layouts are node-major and unpadded: ad [n_dst, H], as_ [n_src, H],
// wx [n_src, H, F], g/out [n_dst, H, F], M/L/delta/dad [n_dst, H],
// dwx [n_src, H, F], das [n_src, H]. Destination rows past n_dst are
// never written, and source rows past n_src inside a reached block read
// as zeros, as the reference pads rows to whole blocks (and F to 128
// lanes: 16x at F = 8, 18x at F = 7).
//
// Bound on the H100 (the larger of three): the blocks as stored, all
// R*K*128*128 f32 values read once, plus every other operand read or
// written once, at 3.35 TB/s; the f32 FMAs the nonzero entries need (F
// per entry and head in the forward and the row pass, 2F in the column
// pass) at 67 TFLOP/s; one exponential per nonzero entry and head at 16
// results per clock per SM (132 SMs, the clock from nvidia-smi). A GAT
// batch's multiplicity blocks are sparse (572-1,037 edges in 131,072
// stored values at the Cora shape, [2, 4, 128, 128] and transposed [4, 2,
// 128, 128]), so the block bytes bound all three passes at both layers'
// widths: ~0.2 us, below one launch. What bounds a call in practice is the
// chain of dependent latencies one row's warp walks (block rows, then
// column ids, then the edges' far rows), which the design keeps short and
// overlapped.
//
// Design of all three passes: a warp per row of their blocks
// (csrc/pna_reduce.cu's shape) on block_spmm.cuh's stream; the forward and
// the row pass own destination rows of the forward blocks, the column pass
// source rows of the transposed ones.
// - A CTA holds kRowsPerCta = 8 warps for 8 consecutive rows of one
//   row block (25 CTAs for a Cora-shaped batch's 194 rows, where a CTA per
//   128-row block row would run 2). Lane l holds the flattened (head,
//   feature) pairs q = h*F + f = 64t + l and 64t + 32 + l of tile t, so a
//   source row's values wx[j, q] are one coalesced read and each lane
//   computes its own heads' scores (ad and as_ are a few floats a row). H*F
//   past 64 takes more tiles, a loop in the warp, each re-streaming the
//   blocks. At F = 0 each head still takes a pair (stride 1), so M, L and
//   dad = -delta sum alpha' are written and out, empty, is not.
// - The stream (`stream_block_row`): for k = 0..K-1 the warp reads its
//   512-byte block row vals[r, k, a, :] coalesced through a 4-slot
//   cp.async ring, and four ballots queue its nonzeros in (k, b) order in
//   the warp's 128-entry queue in shared memory. An empty block row
//   costs its 512 B and a few instructions. The ring reads with the
//   default L2 policy, not the contraction's evict-first (block_spmm.cuh
//   says why).
// - The forward drains the queue in two passes: the max of the queued
//   edges' scores first, so M is final, then p = mult exp(s - M) once per
//   edge and pair, L and acc = sum p wx_j, and one division at the end
//   (the plain version's two-pass structure). A row with more edges than
//   the queue holds drains it in batches (the overflow branch): a batch
//   whose max exceeds the running M rescales L and acc by expf(M - M_new)
//   first. M is exact on both branches (a max is independent of order).
// - The row pass recomputes alpha' per queued edge from (ad, as_, M, L)
//   and accumulates per pair sum_j alpha'_ij wx_j[q] and per head sum_j
//   alpha'_ij; at the end, dad_i[h] = sum_f g_i[h, f] (sum_j alpha'_ij
//   wx_j[h, f]) - delta_i[h] sum_j alpha'_ij, the plain version's sum
//   regrouped, one pass over the blocks at every F. The per-head sum over
//   f runs in f order through shared memory (F need not be a power of
//   two); a head whose features straddle two tiles carries its partial
//   sum to the next, so dad[h] has one owner, written once.
// - Each drain walks its queued entries in order, kEdges at a time
//   (`for_edges`): their far rows, col(k) * 128 + b (sources in the
//   forward and the row pass, destinations in the column pass), take the
//   block's column id through the read-only cache (as block_spmm.cuh and
//   pna_reduce.cu do, at any K), and the far rows' operands of the kEdges
//   edges (as_ and wx; or ad, M, L, delta and g) are loaded at once, so
//   their latencies overlap. Masked entries are never queued, so values on
//   rows that no edge reaches never leak whatever their size; each
//   duplicate edge counts with its multiplicity.
// - No tensor cores: at 0.5-0.8% density mma would multiply the zeros
//   again, and the reference computes in f32.
// - The column pass is the row pass over the transposed blocks vals_t
//   [R_t, K_t, 128, 128], whose rows are sources: a warp owns source row
//   j = c * 128 + a (~60 CTAs for a Cora-shaped batch's ~480 sources,
//   where a CTA per 128-row block row ran 4), its lanes hold the same 64-pair
//   tiles, and the stream queues the row's edges j -> i. Per queued edge,
//   destination i = cols_t[c, k] * 128 + b, the drain loads ad, M, L and
//   delta [i, h] per lane's head and g[i, q] per pair, recomputes alpha
//   and alpha' as the row pass does, and accumulates dwx[j, q] += alpha
//   g[i, q], gacc[q] += alpha' g[i, q] and sad[h] += alpha' delta[i, h]
//   in registers. At the end of a tile das[j, h] = sum_f wx[j, h, f]
//   gacc[h, f] - sad[h] (the plain version's sum regrouped) is folded in
//   f order through shared memory with a straddling head carried across
//   tiles, as the row pass folds dad, so every output has one owner and
//   is written once. A hub source row with more edges than the queue
//   drains in batches with nothing to rescale (the pass only sums); at F
//   = 0 das = -sad.
// Shared memory per CTA: the ring 16,384 B and the queues 8,192 B
// (forward, 24,576 B), plus 4,128 B of per-head sums and carries (row and
// column passes, 28,704 B), all static.
//
// Exactness, all three passes: z is one IEEE add and leaky_relu's product
// is unfused (__fmul_rn), so the scores round as the plain version's and
// M is bitwise its max; expf, not __expf, and no fast-math; L is floored
// at TINY in the divisions, so a row without edges gives out = 0, M =
// NEG, L = 0 and dad = 0. Every output has one owner and no atomics, so a
// repeat is bit-identical; only the order of the sums differs from the
// plain version's.
#include "block_spmm.cuh"

namespace {

using repro::Entry;
using repro::kBn;
using repro::kDepth;
using repro::kQueue;
using repro::kRowsPerCta;
using repro::kWarp;
using repro::stream_block_row;

constexpr int kPairs = 2;                // (head, feature) pairs per lane
constexpr int kTile = kWarp * kPairs;    // pairs per warp and tile
constexpr int kEdges = 4;                // queued edges loaded together
constexpr float kNeg = -1e30f;   // the reference's NEG
constexpr float kTiny = 1e-30f;  // the reference's TINY

struct Dims {
  int64_t n_dst, n_src, H, F, R, K;
  float slope;

  // a head's stride in the lanes' (head, feature) pairs: F, and 1 at F = 0
  // (H * fp() < 2^31, checked at launch)
  __device__ int fp() const { return F > 0 ? static_cast<int>(F) : 1; }
};

// __fmul_rn keeps the product from being contracted into a later add, so
// the scores round as the plain version's do
__device__ __forceinline__ float lrelu(float z, float slope) {
  return z > 0.f ? z : __fmul_rn(slope, z);
}

// The warp's row (row a of block row r of its blocks) and its lane's
// pairs of tile t: q = h * fp + f = 64t + 32p + lane, live below H * fp;
// `feat` where f < F too (the pair has a feature: false at F = 0).
struct Lane {
  int64_t r;
  int a;
  int q[kPairs], h[kPairs], f[kPairs];
  bool live[kPairs], feat[kPairs];
};

__device__ __forceinline__ Lane lane_of(const Dims& d, int64_t row, int t) {
  Lane w;
  w.r = row / kBn;
  w.a = static_cast<int>(row % kBn);
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    w.q[p] = t * kTile + p * kWarp + threadIdx.x;
    w.live[p] = w.q[p] < d.H * d.fp();
    w.h[p] = w.q[p] / d.fp();
    w.f[p] = w.q[p] % d.fp();
    w.feat[p] = w.live[p] && w.f[p] < d.F;
  }
  return w;
}

// The far ends of a drain's edges: rows [0, n) (zeros past n) with kN
// operands [n, H] read at the lane's pairs' heads and, unless `pair` is
// null, one [n, H, F] read at its pairs. The forward and the row pass
// reach source rows (as_; wx), the column pass destination rows (ad, M, L,
// delta; g).
template <int kN>
struct Far {
  const float* head[kN];
  const float* pair;
  int64_t n;
};

// body(mu, hv, xv) over a drain's queued entries [0, n), kEdges at a time
// in queue order: mu is the multiplicity (0 past n and where masked: the
// plain version's mask is mult > 0, so a masked entry reads nothing), and
// hv[e][c][p] = far.head[c][j, h] and xv[e][p] = far.pair[j, q] for the
// lane's pairs are loaded together on the kEdges far rows j = col(k) * 128
// + b (zeros past far.n). cols_r is the row block's column ids.
using Edges = const float (&)[kEdges];          // body's mu
using Rows = const float (&)[kEdges][kPairs];   // body's xv
template <int kN>
using Heads = const float (&)[kEdges][kN][kPairs];  // body's hv

template <int kN, class Body>
__device__ __forceinline__ void for_edges(const Entry* queue, int n,
                                          const int32_t* cols_r,
                                          const Lane& w, const Dims& d,
                                          const Far<kN>& far, Body&& body) {
  for (int i = 0; i < n; i += kEdges) {
    float mu[kEdges], hv[kEdges][kN][kPairs], xv[kEdges][kPairs];
    int32_t j[kEdges];
#pragma unroll
    for (int e = 0; e < kEdges; ++e) {
      const Entry en = i + e < n ? queue[i + e] : Entry{0.f, 0};
      mu[e] = en.w > 0.f ? en.w : 0.f;
      j[e] = en.w > 0.f ? __ldg(cols_r + en.kb / kBn) * kBn + en.kb % kBn
                        : 0;
    }
#pragma unroll
    for (int e = 0; e < kEdges; ++e) {
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const bool ok = mu[e] > 0.f && w.live[p] && j[e] < far.n;
#pragma unroll
        for (int c = 0; c < kN; ++c)
          hv[e][c][p] = ok ? __ldg(far.head[c] + j[e] * d.H + w.h[p]) : 0.f;
        xv[e][p] = ok && w.feat[p] && far.pair != nullptr
                       ? __ldg(far.pair + j[e] * d.H * d.F + w.q[p]) : 0.f;
      }
    }
    body(mu, hv, xv);
  }
}

// The per-head outputs of tile t of a warp's pairs (dad in the row pass,
// das in the column pass): for each head h whose pairs end in this tile,
// finish(h, s, c) with s = sum_f prod[h, f] summed in f order and c the
// head's per-head sum (`per_head`, the same at each of its pairs, read at
// its first pair in the tile). A head that began in the tile before takes
// its sum so far from `carry`; a head that goes on past the tile leaves
// its sum there. `sum_s` is two kTile rows of the warp's shared memory.
template <class Finish>
__device__ __forceinline__ void fold_heads(const float (&prod)[kPairs],
                                           const float (&per_head)[kPairs],
                                           int t, int HF, int F,
                                           float (*sum_s)[kTile],
                                           float* carry, Finish&& finish) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    sum_s[0][p * kWarp + threadIdx.x] = prod[p];
    sum_s[1][p * kWarp + threadIdx.x] = per_head[p];
  }
  // the previous tile's straddling head, read before this tile writes it
  const float before = t > 0 ? *carry : 0.f;
  __syncwarp();
  const int q0 = t * kTile;
  const int q1 = q0 + kTile < HF ? q0 + kTile : HF;
  for (int h = q0 / F + threadIdx.x; h * F < q1; h += kWarp) {
    const int lo = h * F > q0 ? h * F : q0;
    const int end = h * F + F;
    const int hi = end < q1 ? end : q1;
    float s = h * F < q0 ? before : 0.f;
    for (int q = lo; q < hi; ++q) s += sum_s[0][q - q0];
    if (end <= q1)
      finish(h, s, sum_s[1][lo - q0]);
    else
      *carry = s;  // the tile's last head goes on
  }
  __syncwarp();  // the sums are read before the next tile writes them
}

__global__ void __launch_bounds__(kWarp * kRowsPerCta)
es_fwd_kernel(const float* __restrict__ ad, const float* __restrict__ as_,
              const float* __restrict__ wx, const float* __restrict__ vals,
              const int32_t* __restrict__ cols, const Dims d,
              float* __restrict__ out, float* __restrict__ mmax,
              float* __restrict__ lsum) {
  __shared__ __align__(16) float4 ring_s[kRowsPerCta][kDepth][kWarp];
  __shared__ Entry queue_s[kRowsPerCta][kQueue];
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.y;
  if (row >= d.n_dst) return;  // the whole warp; no CTA barrier follows
  const Entry* queue = queue_s[threadIdx.y];
  const int32_t* cols_r = cols + row / kBn * d.K;
  const Far<1> scores{{as_}, nullptr, d.n_src};  // pass 1 reads no wx
  const Far<1> sources{{as_}, wx, d.n_src};

  for (int t = 0; t * kTile < d.H * d.fp(); ++t) {
    const Lane w = lane_of(d, row, t);
    float adv[kPairs], m[kPairs], l[kPairs], acc[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      adv[p] = w.live[p] ? __ldg(ad + row * d.H + w.h[p]) : 0.f;
      m[p] = kNeg;
      l[p] = 0.f;
      acc[p] = 0.f;
    }

    auto drain = [&](int n) {
      // pass 1: the queued edges' max score, so m is final for them
      float top[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) top[p] = m[p];
      auto max_of = [&](Edges mu, Heads<1> av, Rows) {
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (mu[e] > 0.f) {
#pragma unroll
            for (int p = 0; p < kPairs; ++p)
              top[p] = fmaxf(top[p], lrelu(adv[p] + av[e][0][p], d.slope));
          }
        }
      };
      for_edges(queue, n, cols_r, w, d, scores, max_of);
      // the overflow branch: edges drained before were weighed against a
      // smaller max (on the first drain l and acc are 0 and stay 0)
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        if (top[p] != m[p]) {
          const float scale = expf(m[p] - top[p]);
          l[p] *= scale;
          acc[p] *= scale;
          m[p] = top[p];
        }
      }
      // pass 2: p = mult * exp(s - M) once per edge and pair
      auto add = [&](Edges mu, Heads<1> av, Rows xv) {
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (mu[e] > 0.f) {
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              const float s = lrelu(adv[p] + av[e][0][p], d.slope);
              const float pe = mu[e] * expf(s - m[p]);
              l[p] += pe;
              acc[p] = fmaf(pe, xv[e][p], acc[p]);
            }
          }
        }
      };
      for_edges(queue, n, cols_r, w, d, sources, add);
    };
    stream_block_row<false>(vals, w.r, w.a, d.K,
                            &ring_s[threadIdx.y][0][threadIdx.x],
                            queue_s[threadIdx.y], drain);

#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (w.feat[p])
        out[row * d.H * d.F + w.q[p]] = acc[p] / fmaxf(l[p], kTiny);
      if (w.live[p] && w.f[p] == 0) {  // one owner per head
        mmax[row * d.H + w.h[p]] = m[p];
        lsum[row * d.H + w.h[p]] = l[p];
      }
    }
  }
}

__global__ void __launch_bounds__(kWarp * kRowsPerCta)
es_bwd_row_kernel(const float* __restrict__ ad,
                  const float* __restrict__ as_,
                  const float* __restrict__ wx, const float* __restrict__ g,
                  const float* __restrict__ mmax,
                  const float* __restrict__ lsum,
                  const float* __restrict__ delta,
                  const float* __restrict__ vals,
                  const int32_t* __restrict__ cols, const Dims d,
                  float* __restrict__ dad) {
  __shared__ __align__(16) float4 ring_s[kRowsPerCta][kDepth][kWarp];
  __shared__ Entry queue_s[kRowsPerCta][kQueue];
  __shared__ float sum_s[kRowsPerCta][2][kTile];  // g * acc, sum alpha'
  __shared__ float carry_s[kRowsPerCta];          // a straddling head's
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.y;
  if (row >= d.n_dst) return;  // the whole warp; no CTA barrier follows
  const int F = d.fp();  // the pairs' stride per head
  const int HF = static_cast<int>(d.H) * F;
  const Entry* queue = queue_s[threadIdx.y];
  const int32_t* cols_r = cols + row / kBn * d.K;
  const Far<1> sources{{as_}, wx, d.n_src};

  for (int t = 0; t * kTile < HF; ++t) {
    const Lane w = lane_of(d, row, t);
    float adv[kPairs], mv[kPairs], den[kPairs], gv[kPairs], acc[kPairs],
        sap[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int64_t o = row * d.H + w.h[p];
      adv[p] = w.live[p] ? __ldg(ad + o) : 0.f;
      mv[p] = w.live[p] ? __ldg(mmax + o) : 0.f;
      den[p] = w.live[p] ? fmaxf(__ldg(lsum + o), kTiny) : 1.f;
      gv[p] = w.feat[p] ? __ldg(g + row * d.H * d.F + w.q[p]) : 0.f;
      acc[p] = 0.f;
      sap[p] = 0.f;
    }

    auto drain = [&](int n) {
      auto add = [&](Edges mu, Heads<1> av, Rows xv) {
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (mu[e] > 0.f) {
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              const float z = adv[p] + av[e][0][p];
              const float pe = mu[e] * expf(lrelu(z, d.slope) - mv[p]);
              const float ap = (pe / den[p]) * (z > 0.f ? 1.f : d.slope);
              acc[p] = fmaf(ap, xv[e][p], acc[p]);
              sap[p] += ap;
            }
          }
        }
      };
      for_edges(queue, n, cols_r, w, d, sources, add);
    };
    stream_block_row<false>(vals, w.r, w.a, d.K,
                            &ring_s[threadIdx.y][0][threadIdx.x],
                            queue_s[threadIdx.y], drain);

    // dad[h] = sum_f g[h, f] acc[h, f] - delta[h] sap[h]
    float gacc[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) gacc[p] = gv[p] * acc[p];
    fold_heads(gacc, sap, t, HF, F, sum_s[threadIdx.y], &carry_s[threadIdx.y],
               [&](int h, float s, float sap_h) {
                 dad[row * d.H + h] =
                     s - __ldg(delta + row * d.H + h) * sap_h;
               });
  }
}

__global__ void __launch_bounds__(kWarp * kRowsPerCta)
es_bwd_col_kernel(const float* __restrict__ ad,
                  const float* __restrict__ as_,
                  const float* __restrict__ wx, const float* __restrict__ g,
                  const float* __restrict__ mmax,
                  const float* __restrict__ lsum,
                  const float* __restrict__ delta,
                  const float* __restrict__ vals_t,
                  const int32_t* __restrict__ cols_t, const Dims d,
                  float* __restrict__ dwx, float* __restrict__ das) {
  __shared__ __align__(16) float4 ring_s[kRowsPerCta][kDepth][kWarp];
  __shared__ Entry queue_s[kRowsPerCta][kQueue];
  __shared__ float sum_s[kRowsPerCta][2][kTile];  // wx * gacc, sad
  __shared__ float carry_s[kRowsPerCta];          // a straddling head's
  const int64_t row =   // the warp's source row j
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.y;
  if (row >= d.n_src) return;  // the whole warp; no CTA barrier follows
  const int F = d.fp();  // the pairs' stride per head
  const int HF = static_cast<int>(d.H) * F;
  const Entry* queue = queue_s[threadIdx.y];
  const int32_t* cols_r = cols_t + row / kBn * d.K;
  const Far<4> dests{{ad, mmax, lsum, delta}, g, d.n_dst};

  for (int t = 0; t * kTile < HF; ++t) {
    const Lane w = lane_of(d, row, t);
    float asv[kPairs], wv[kPairs], dw[kPairs], gacc[kPairs], sad[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      asv[p] = w.live[p] ? __ldg(as_ + row * d.H + w.h[p]) : 0.f;
      wv[p] = w.feat[p] ? __ldg(wx + row * d.H * d.F + w.q[p]) : 0.f;
      dw[p] = 0.f;
      gacc[p] = 0.f;
      sad[p] = 0.f;
    }

    // hv[e]: the destination's ad, M, L and delta; xv[e]: its g
    auto drain = [&](int n) {
      auto add = [&](Edges mu, Heads<4> hv, Rows xv) {
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (mu[e] > 0.f) {
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              const float z = hv[e][0][p] + asv[p];
              const float pe =
                  mu[e] * expf(lrelu(z, d.slope) - hv[e][1][p]);
              const float alpha = pe / fmaxf(hv[e][2][p], kTiny);
              const float ap = alpha * (z > 0.f ? 1.f : d.slope);
              dw[p] = fmaf(alpha, xv[e][p], dw[p]);
              gacc[p] = fmaf(ap, xv[e][p], gacc[p]);
              sad[p] = fmaf(ap, hv[e][3][p], sad[p]);
            }
          }
        }
      };
      for_edges(queue, n, cols_r, w, d, dests, add);
    };
    stream_block_row<false>(vals_t, w.r, w.a, d.K,
                            &ring_s[threadIdx.y][0][threadIdx.x],
                            queue_s[threadIdx.y], drain);

#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      if (w.feat[p]) dwx[row * d.H * d.F + w.q[p]] = dw[p];
      gacc[p] *= wv[p];
    }
    // das[h] = sum_f wx[h, f] gacc[h, f] - sad[h]
    fold_heads(gacc, sad, t, HF, F, sum_s[threadIdx.y], &carry_s[threadIdx.y],
               [&](int h, float s, float sad_h) {
                 das[row * d.H + h] = s - sad_h;
               });
  }
}

unsigned row_grid(int64_t rows) {
  return static_cast<unsigned>((rows + kRowsPerCta - 1) / kRowsPerCta);
}

const dim3 kRowBlock(kWarp, kRowsPerCta);

}  // namespace

REPRO_API int repro_edge_softmax_fwd_f32(
    const float* ad, const float* as_, const float* wx, int64_t n_dst,
    int64_t n_src, int64_t H, int64_t F, const float* vals,
    const int32_t* cols, int64_t R, int64_t K, float slope, float* out,
    float* mmax, float* lsum, void* stream) {
  if (R == 0 || H == 0 || n_dst == 0) return 0;
  if (K * kBn > INT32_MAX || n_src > INT32_MAX - kBn ||
      H * (F > 0 ? F : 1) > INT32_MAX - kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{n_dst, n_src, H, F, R, K, slope};
  es_fwd_kernel<<<row_grid(n_dst), kRowBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      ad, as_, wx, vals, cols, d, out, mmax, lsum);
  REPRO_CHECK_LAUNCH();
  return 0;
}

REPRO_API int repro_edge_softmax_bwd_row_f32(
    const float* ad, const float* as_, const float* wx, const float* g,
    const float* mmax, const float* lsum, const float* delta, int64_t n_dst,
    int64_t n_src, int64_t H, int64_t F, const float* vals,
    const int32_t* cols, int64_t R, int64_t K, float slope, float* dad,
    void* stream) {
  if (R == 0 || H == 0 || n_dst == 0) return 0;
  if (K * kBn > INT32_MAX || n_src > INT32_MAX - kBn ||
      H * (F > 0 ? F : 1) > INT32_MAX - kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{n_dst, n_src, H, F, R, K, slope};
  es_bwd_row_kernel<<<row_grid(n_dst), kRowBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      ad, as_, wx, g, mmax, lsum, delta, vals, cols, d, dad);
  REPRO_CHECK_LAUNCH();
  return 0;
}

REPRO_API int repro_edge_softmax_bwd_col_f32(
    const float* ad, const float* as_, const float* wx, const float* g,
    const float* mmax, const float* lsum, const float* delta, int64_t n_dst,
    int64_t n_src, int64_t H, int64_t F, const float* vals_t,
    const int32_t* cols_t, int64_t R_t, int64_t K_t, float slope,
    float* dwx, float* das, void* stream) {
  if (R_t == 0 || H == 0 || n_src == 0) return 0;
  if (K_t * kBn > INT32_MAX || n_dst > INT32_MAX - kBn ||
      H * (F > 0 ? F : 1) > INT32_MAX - kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{n_dst, n_src, H, F, R_t, K_t, slope};
  es_bwd_col_kernel<<<row_grid(n_src), kRowBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      ad, as_, wx, g, mmax, lsum, delta, vals_t, cols_t, d, dwx, das);
  REPRO_CHECK_LAUNCH();
  return 0;
}
