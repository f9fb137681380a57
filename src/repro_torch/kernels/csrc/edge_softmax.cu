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
// batch's multiplicity blocks are sparse (645-1,037 edges in 131,072
// stored values at the Cora shape, [2, 4, 128, 128]), so the block bytes
// bound all three passes at both layers' widths: ~0.2 us, below one
// launch. What bounds a call in practice is the chain of dependent
// latencies one row's warp walks (block rows, then column ids, then the
// edges' source rows), which the design keeps short and overlapped.
//
// Design of the forward and the row pass: a warp per destination row
// (csrc/pna_reduce.cu's shape) on block_spmm.cuh's stream.
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
// - Each drain walks its queued entries in order, kEdges at a time: their
//   source rows, col(k) * 128 + b, take the block's column id through the
//   read-only cache (as block_spmm.cuh and pna_reduce.cu do, at any K),
//   and the source rows' values (as_, wx) of the kEdges edges are loaded
//   at once, so their latencies overlap. Masked entries are never queued,
//   so values on sources that no edge reaches never leak whatever their
//   size; each duplicate edge counts with its multiplicity.
// - No tensor cores: at 0.5-0.8% density mma would multiply the zeros
//   again, and the reference computes in f32.
// Shared memory per CTA: the ring 16,384 B and the queues 8,192 B
// (forward, 24,576 B), plus 4,128 B of per-head sums and carries (row
// pass, 28,704 B), all static.
//
// Design of the column pass: over the transposed blocks, one CTA per source
// block row (blockDim = 128 rows x up to 8 heads, one thread per (row,
// head)), looping over K itself with its state in registers; each K step's
// block is staged in shared memory in 32-column chunks once for all heads,
// with the chunk's logit halves and an 8-feature tile of values beside it.
// Features past 8 run as a loop in the thread, so the pass folds -delta *
// sum alpha' in once per K step (on the first tile). Every row of dwx and
// das has exactly one owner thread.
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
constexpr int kCb = 32;          // block columns staged per chunk (col)
constexpr int kFt = 8;           // features per register tile (col)
constexpr int kMaxHeads = 8;     // heads per CTA (col, blockDim.y)
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

// The warp's destination row (row a of row block r) and its lane's
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

// body(mu, av, xv) over a drain's queued entries [0, n), kEdges at a time
// in queue order: mu is the multiplicity (0 past n and where masked: the
// plain version's mask is mult > 0, so a masked entry reads nothing), and
// the lane's pairs' halves as_[j, h] and, with `wx`, values wx[j, q] on
// the kEdges source rows j = col(k) * 128 + b are loaded together (zeros
// past n_src). cols_r is the row block's column ids.
using Edges = const float (&)[kEdges];          // body's mu
using Rows = const float (&)[kEdges][kPairs];   // body's av and xv

template <class Body>
__device__ __forceinline__ void for_edges(const Entry* queue, int n,
                                          const int32_t* cols_r,
                                          const Lane& w, const Dims& d,
                                          const float* __restrict__ as_,
                                          const float* __restrict__ wx,
                                          Body&& body) {
  for (int i = 0; i < n; i += kEdges) {
    float mu[kEdges], av[kEdges][kPairs], xv[kEdges][kPairs];
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
        const bool ok = mu[e] > 0.f && w.live[p] && j[e] < d.n_src;
        av[e][p] = ok ? __ldg(as_ + j[e] * d.H + w.h[p]) : 0.f;
        xv[e][p] = ok && w.feat[p] && wx != nullptr
                       ? __ldg(wx + j[e] * d.H * d.F + w.q[p]) : 0.f;
      }
    }
    body(mu, av, xv);
  }
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
      auto max_of = [&](Edges mu, Rows av, Rows) {
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (mu[e] > 0.f) {
#pragma unroll
            for (int p = 0; p < kPairs; ++p)
              top[p] = fmaxf(top[p], lrelu(adv[p] + av[e][p], d.slope));
          }
        }
      };
      for_edges(queue, n, cols_r, w, d, as_, nullptr, max_of);
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
      auto add = [&](Edges mu, Rows av, Rows xv) {
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (mu[e] > 0.f) {
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              const float s = lrelu(adv[p] + av[e][p], d.slope);
              const float pe = mu[e] * expf(s - m[p]);
              l[p] += pe;
              acc[p] = fmaf(pe, xv[e][p], acc[p]);
            }
          }
        }
      };
      for_edges(queue, n, cols_r, w, d, as_, wx, add);
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
  float* gacc = sum_s[threadIdx.y][0];
  float* sap_h = sum_s[threadIdx.y][1];

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
      auto add = [&](Edges mu, Rows av, Rows xv) {
#pragma unroll
        for (int e = 0; e < kEdges; ++e) {
          if (mu[e] > 0.f) {
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              const float z = adv[p] + av[e][p];
              const float pe = mu[e] * expf(lrelu(z, d.slope) - mv[p]);
              const float ap = (pe / den[p]) * (z > 0.f ? 1.f : d.slope);
              acc[p] = fmaf(ap, xv[e][p], acc[p]);
              sap[p] += ap;
            }
          }
        }
      };
      for_edges(queue, n, cols_r, w, d, as_, wx, add);
    };
    stream_block_row<false>(vals, w.r, w.a, d.K,
                            &ring_s[threadIdx.y][0][threadIdx.x],
                            queue_s[threadIdx.y], drain);

    // dad[h] = sum_f g[h, f] acc[h, f] - delta[h] sap[h], the head's pairs
    // summed in f order, across tiles through the carry
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      gacc[p * kWarp + threadIdx.x] = gv[p] * acc[p];
      sap_h[p * kWarp + threadIdx.x] = sap[p];
    }
    // the previous tile's straddling head, read before this tile writes it
    const float carry = t > 0 ? carry_s[threadIdx.y] : 0.f;
    __syncwarp();
    const int q0 = t * kTile;
    const int q1 = q0 + kTile < HF ? q0 + kTile : HF;
    for (int h = q0 / F + threadIdx.x; h * F < q1; h += kWarp) {
      const int lo = h * F > q0 ? h * F : q0;
      const int end = h * F + F;
      const int hi = end < q1 ? end : q1;
      float s = h * F < q0 ? carry : 0.f;
      for (int q = lo; q < hi; ++q) s += gacc[q - q0];
      if (end <= q1)
        dad[row * d.H + h] =
            s - __ldg(delta + row * d.H + h) * sap_h[lo - q0];
      else
        carry_s[threadIdx.y] = s;  // the tile's last head goes on
    }
    __syncwarp();  // the sums are read before the next tile writes them
  }
}

// The column pass's staged chunk.
struct Smem {
  float mult[kCb][kBn + 1];            // mult[b][a] = block[a][b0 + b]
  float key[kCb][kMaxHeads];           // the destinations' logit halves
  float val[kCb][kMaxHeads][kFt];      // a feature tile of g
  float stat[3][kCb][kMaxHeads];       // M, L, delta
};

// Stage columns [b0, b0 + kCb) of one 128x128 block, transposed so that a
// warp's threads (consecutive rows) read consecutive banks.
__device__ __forceinline__ void stage_mult(Smem& sm, const float* blk,
                                           int b0, int tid, int nthreads) {
  for (int i = tid; i < kBn * kCb; i += nthreads) {
    const int a = i / kCb;
    const int b = i % kCb;
    sm.mult[b][a] = __ldg(blk + a * kBn + b0 + b);
  }
}

// Stage the chunk's rows of a [rows, H] half and a feature tile of a
// [rows, H, F] operand (zeros past `rows`, past H and past F).
__device__ __forceinline__ void stage_rows(
    Smem& sm, const float* key, const float* val, int64_t base,
    int64_t rows, const Dims& d, int64_t h0, int hpb, int64_t f0, int tid,
    int nthreads) {
  for (int i = tid; i < kCb * hpb; i += nthreads) {
    const int b = i / hpb;
    const int hh = i % hpb;
    const int64_t j = base + b;
    const int64_t h = h0 + hh;
    const bool ok = j < rows && h < d.H;
    sm.key[b][hh] = ok ? __ldg(key + j * d.H + h) : 0.f;
  }
  for (int i = tid; i < kCb * hpb * kFt; i += nthreads) {
    const int b = i / (hpb * kFt);
    const int hh = (i / kFt) % hpb;
    const int f = i % kFt;
    const int64_t j = base + b;
    const int64_t h = h0 + hh;
    const bool ok = j < rows && h < d.H && f0 + f < d.F;
    sm.val[b][hh][f] = ok ? __ldg(val + (j * d.H + h) * d.F + f0 + f) : 0.f;
  }
}

__global__ void __launch_bounds__(kBn * kMaxHeads)
es_bwd_col_kernel(const float* __restrict__ ad,
                  const float* __restrict__ as_,
                  const float* __restrict__ wx, const float* __restrict__ g,
                  const float* __restrict__ mmax,
                  const float* __restrict__ lsum,
                  const float* __restrict__ delta,
                  const float* __restrict__ vals_t,
                  const int32_t* __restrict__ cols_t, const Dims d,
                  float* __restrict__ dwx, float* __restrict__ das) {
  __shared__ Smem sm;
  const int j = threadIdx.x;
  const int hh = threadIdx.y;
  const int hpb = blockDim.y;
  const int tid = hh * kBn + j;
  const int nthreads = kBn * hpb;
  const int64_t c = blockIdx.x;                 // source block
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * hpb;
  const int64_t h = h0 + hh;
  const int64_t row = c * kBn + j;              // source row
  const bool live = row < d.n_src && h < d.H;
  const int64_t o = row * d.H + h;
  const float asv = live ? __ldg(as_ + o) : 0.f;

  float acc_s = 0.f;
  for (int64_t f0 = 0; f0 < d.F; f0 += kFt) {
    float wt[kFt];
    float dw[kFt];
#pragma unroll
    for (int f = 0; f < kFt; ++f) {
      wt[f] = (live && f0 + f < d.F) ? __ldg(wx + o * d.F + f0 + f) : 0.f;
      dw[f] = 0.f;
    }
    for (int64_t k = 0; k < d.K; ++k) {
      const int64_t col = __ldg(cols_t + c * d.K + k);   // dest block
      const float* blk = vals_t + (c * d.K + k) * kBn * kBn;
      float sad = 0.f;
      for (int a0 = 0; a0 < kBn; a0 += kCb) {
        __syncthreads();
        stage_mult(sm, blk, a0, tid, nthreads);
        const int64_t base = col * kBn + a0;
        stage_rows(sm, ad, g, base, d.n_dst, d, h0, hpb, f0, tid,
                   nthreads);
        for (int i = tid; i < kCb * hpb; i += nthreads) {
          const int aa = i / hpb;
          const int q = i % hpb;
          const int64_t dst = base + aa;
          const bool ok = dst < d.n_dst && h0 + q < d.H;
          const int64_t od = dst * d.H + h0 + q;
          sm.stat[0][aa][q] = ok ? __ldg(mmax + od) : 0.f;
          sm.stat[1][aa][q] = ok ? __ldg(lsum + od) : 0.f;
          sm.stat[2][aa][q] = ok ? __ldg(delta + od) : 0.f;
        }
        __syncthreads();
        if (!live) continue;
        for (int aa = 0; aa < kCb; ++aa) {
          const float mu = sm.mult[aa][j];
          if (mu > 0.f) {
            const float z = asv + sm.key[aa][hh];
            const float p = mu * expf(lrelu(z, d.slope) - sm.stat[0][aa][hh]);
            const float alpha = p / fmaxf(sm.stat[1][aa][hh], kTiny);
            const float ap = alpha * (z > 0.f ? 1.f : d.slope);
            float gv = 0.f;
#pragma unroll
            for (int f = 0; f < kFt; ++f) {
              dw[f] = fmaf(alpha, sm.val[aa][hh][f], dw[f]);
              gv = fmaf(wt[f], sm.val[aa][hh][f], gv);
            }
            acc_s = fmaf(ap, gv, acc_s);
            sad = fmaf(ap, sm.stat[2][aa][hh], sad);
          }
        }
      }
      if (f0 == 0) acc_s -= sad;  // the delta term, once per K step
    }
    if (live) {
#pragma unroll
      for (int f = 0; f < kFt; ++f)
        if (f0 + f < d.F) dwx[o * d.F + f0 + f] = dw[f];
    }
  }
  if (live) das[o] = acc_s;
}

dim3 block_dims(int64_t H) {
  return dim3(kBn, static_cast<unsigned>(H < kMaxHeads ? H : kMaxHeads));
}

unsigned head_groups(int64_t H) {
  return static_cast<unsigned>((H + kMaxHeads - 1) / kMaxHeads);
}

unsigned row_grid(int64_t n_dst) {
  return static_cast<unsigned>((n_dst + kRowsPerCta - 1) / kRowsPerCta);
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
  if (R_t == 0 || H == 0) return 0;
  const Dims d{n_dst, n_src, H, F, R_t, K_t, slope};
  const dim3 grid(static_cast<unsigned>(R_t), head_groups(H));
  es_bwd_col_kernel<<<grid, block_dims(H), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      ad, as_, wx, g, mmax, lsum, delta, vals_t, cols_t, d, dwx, das);
  REPRO_CHECK_LAUNCH();
  return 0;
}
