// PNA's multi-aggregator reduction over unit-weight (multiplicity) BCSR
// blocks: the forward and the two backward passes.
//
// Replaces src/repro/kernels/pna_reduce.py:
//   98  pna_reduce_fwd      -> repro_pna_reduce_fwd_f32
//   194 pna_reduce_bwd_row  -> repro_pna_reduce_bwd_row_f32
//   254 pna_reduce_bwd_col  -> repro_pna_reduce_bwd_col_f32
//
// For destination i, feature f, over the edges j -> i (block entry mu_ij
// is the edge multiplicity, 0 = no edge):
//   z_ij = xd[i,f] + xs[j,f],  msg_ij = max(z_ij, 0)
//   s_i = sum_j mu_ij msg_ij,  cnt_i = sum_j mu_ij,
//   mn_i / mx_i = min / max_j msg_ij (0 on rows without edges),
//   cmin_i / cmax_i = sum of mu_ij over the j with msg_ij == mn_i / mx_i
//                                                                  (fwd)
//   dmsg_ij = [z_ij > 0] mu_ij (gs_i + [msg_ij == mn_i] gmn_i / max(cmin_i, 1)
//                                    + [msg_ij == mx_i] gmx_i / max(cmax_i, 1))
//   dxd_i = sum_j dmsg_ij                                          (row)
//   dxs_j = sum_i dmsg_ij                                          (col)
// the even split of the min/max cotangents across ties that
// jax.ops.segment_min / segment_max apply.
//
// Layouts are node-major and unpadded: xd [n_dst, F], xs [n_src, F], the
// stats and cotangents [n_dst, F], cnt [n_dst], dxd [n_dst, F], dxs
// [n_src, F]. Rows past n_dst / n_src read as zeros (the reference pads
// with zeros to whole blocks and F to 128 lanes: 2.7x at F = 48).
//
// Design. The TPU kernels walk (K, destination row) as sequential grid
// axes and keep the running (s, mn, mx, cnt, cmin, cmax) in VMEM scratch,
// reducing a whole [128, 128-lane] message tile per step. A GAS batch's
// blocks are sparse (1,449 edges in 344,064 stored values at the table-5
// shape), so here one warp owns one row of the block structure (a
// destination row in the forward and the row pass, a source row of the
// transposed blocks in the column pass) and lane l holds features l and
// l + 32 of a 64-feature tile (one coalesced read per operand row); every
// output has one owner lane, so there are no atomics and a repeat is
// bit-identical. A row's warp waits on latencies, not on bytes (each
// pass runs at ~15-20x its byte bound): one warp's walk of a table-5 row
// is a chain of dependent memory reads and dependent instructions behind
// a launch (chip_smoke.py prints the launch floor beside the passes), so
// the walk is laid out to keep both chains short.
// - Every pass walks its row the same way (`queue_edges`, then
//   `for_queued`). The warp first issues its own row's operands (xd in
//   the forward, the eight destination-side rows in the row pass, xs in
//   the column pass) and the row block's column ids (lane k holds
//   cols[r, k] for k < 32; past 32 through the read-only cache), then
//   reads kChunk = 8 block rows at once (K = 7 forward and 3 transposed
//   at the table-5 shape: every block row in flight together; past 8
//   chunk by chunk) and queues all of their edges with no chain from one
//   block row to the next: 4 ballots a block row, each lane's place from
//   the counts below it, and each edge's far row j = cols[r, k] * 128 + b
//   computed by the lane that holds it, into the warp's 128-entry queue
//   in shared memory, in (k, b) order. The drain takes kEdges = 4 queued
//   edges at a time and loads every operand of every one of them before
//   any is used (xs[j] in the forward and the row pass; all eight
//   destination-side rows xd, gs, mn, mx, gmn, cmin, gmx, cmax of
//   destination j in the column pass, so no load waits on a tie
//   compare), the next batch's before this one is folded (two register
//   buffers). Offsets are 32-bit. The folds select where they can: the
//   forward keeps s, mn, mx, cnt and the tie counts in registers, and a
//   tie count's reset or add is a select, not a branch. A tie's share
//   divides only where the tie count is above 1 (dividing by 1 gives the
//   cotangent exactly): each __fdiv_rn carries a branch to a slow path
//   that the scheduler cannot move work across, and computed for every
//   edge, feature and extreme they made the column pass slower than the
//   walk it replaced. A row with at most 4 edges waits on about three
//   memory latencies: its block rows, its edges' operands, its store. A
//   chunk whose edges would overflow the queue (a hub row) is queued
//   block row by block row, draining in order between; the forward's
//   running stats carry across the drains.
// (A thread per row of a 128-row block row, the Pallas tile's shape,
// spends a warp's divergent pass on every edge of any of its 32 rows:
// such designs took 0.09-0.29 ms a pass at the table-5 shape on an H100,
// slower than a composition of PyTorch calls.)
//
// Exactness. msg is one IEEE add and a max, so mn and mx are bitwise the
// plain version's and the Pallas kernel's. The tie counts stream edge by
// edge: a strictly better value resets the count to its multiplicity, an
// equal one adds it; the final count is the multiplicity sum of the edges
// equal to the final extreme, as the reference's per-block update gives,
// in exact small-integer f32 sums; s and cnt are one chain each over the
// edges in (k ascending, b ascending) order from +0. The queue keeps that
// order, so the forward's six outputs are those of a walk that takes one
// edge after the other. The backward passes recompute msg with
// the same add and compare it with the saved mn / mx for equality. Each
// backward output is one chain over its edges in (k ascending, b
// ascending) order from +0, __fadd_rn(acc, __fmul_rn(mu, g)), g the
// cotangent with each tie's share __fdiv_rn(gmn, max(cmin, 1)) added where
// the message ties (g itself where the count is at most 1, the same
// bits); an entry is an edge where its multiplicity is > 0. No fast math:
// the divisions round as the reference's.
//
// Bound on the H100 (the larger of two): the blocks as stored, all
// R*K*128*128 f32 values read once, plus every other operand read or
// written once, at 3.35 TB/s; the f32 operations the edges need (a few
// per edge and feature) at 67 TFLOP/s. The block bytes bound all three
// passes. The kernels read each block once per 64-feature tile (once at
// F = 48), and the other side's rows once per edge (from L2 after the
// first).
#include "common.cuh"

// Queued edges whose operands a drain loads together (a build switch, so
// chip_smoke.py can time the neighbouring sizes).
#ifndef REPRO_PNA_EDGES
#define REPRO_PNA_EDGES 4
#endif

namespace {

constexpr int kBn = 128;                // adjacency block edge
constexpr int kWarp = 32;
constexpr int kFw = 2;                  // features per lane
constexpr int kTileF = kWarp * kFw;     // features per warp and tile
constexpr int kRowsPerCta = 8;          // one warp per row
constexpr unsigned kAll = 0xffffffffu;
constexpr int kChunk = 8;               // block rows a warp reads at once
constexpr int kQueue = 128;             // queued edges a warp
constexpr int kEdges = REPRO_PNA_EDGES;
static_assert(kEdges >= 1 && kEdges <= kQueue, "a drain batch");
constexpr float kBig = 1e30f;           // the reference's BIG

struct Dims {
  int64_t n_rows;   // rows of the side the blocks' rows run over
  int64_t n_cols;   // rows of the side the blocks' columns reach
  int64_t F, R, K;
};

// A warp's row of the block structure and its lane's features.
struct Row {
  int64_t row, r, la;      // global row, block row, row within the block
  int64_t f[kFw];          // the lane's features
  bool live;

  __device__ bool ok(int p, int64_t F) const { return f[p] < F; }
  __device__ int64_t at(int64_t i, int p, int64_t F) const {
    return i * F + f[p];
  }
};

__device__ __forceinline__ Row warp_row(const Dims& d) {
  Row w;
  w.row = static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.y;
  w.r = w.row / kBn;
  w.la = w.row % kBn;
#pragma unroll
  for (int p = 0; p < kFw; ++p)
    w.f[p] = static_cast<int64_t>(blockIdx.y) * kTileF + p * kWarp +
             threadIdx.x;
  w.live = w.row < d.n_rows;
  return w;
}

// The lane's features of row i of a [rows, F] operand (zeros past `rows`
// and past F).
__device__ __forceinline__ void load(float (&v)[kFw], const float* src,
                                     int64_t i, int64_t rows, const Row& w,
                                     int64_t F) {
#pragma unroll
  for (int p = 0; p < kFw; ++p)
    v[p] = (i < rows && w.ok(p, F)) ? __ldg(src + w.at(i, p, F)) : 0.f;
}

dim3 grid_for(int64_t n_rows, int64_t F) {
  const int64_t tiles = F > 0 ? (F + kTileF - 1) / kTileF : 1;
  return dim3(static_cast<unsigned>((n_rows + kRowsPerCta - 1) / kRowsPerCta),
              static_cast<unsigned>(tiles));
}

const dim3 kBlock(kWarp, kRowsPerCta);

// The lane's column id of block k = lane of the warp's row block (0 past
// K): `queue_edges`' colv, issued before the block rows are read.
__device__ __forceinline__ int32_t lane_col(const int32_t* cols_r,
                                            const Dims& d) {
  return threadIdx.x < d.K ? __ldg(cols_r + threadIdx.x) : 0;
}

// A queued edge: its multiplicity (> 0) and its far row j = cols[r, k] *
// 128 + b.
struct Edge {
  float mu;
  int32_t j;
};

// Queue the edges of the warp's row of the blocks `vals` [R, K, 128, 128]
// in (k, b) order and call drain(n) on the n queued ones whenever the next
// block row's would overflow the queue, and once at the end (n may be 0
// there). The warp reads kChunk block rows at once (lane l 16 bytes of
// each, one coalesced 512-byte read a block row) and their column ids
// (lane k holds cols_r[k] for k < 32; past 32 through the read-only
// cache), then queues all of their edges with no chain from one block row
// to the next: 4 ballots a block row, each lane's place from the counts
// below it, its edges' far rows computed by the lane that holds them. A
// chunk whose edges overflow the queue is queued block row by block row,
// draining between (its block rows are read again, from L2). An entry is
// an edge where its multiplicity is > 0.
template <class Drain>
__device__ __forceinline__ void queue_edges(const float* __restrict__ vals,
                                            const int32_t* __restrict__ cols_r,
                                            int32_t colv, const Row& w,
                                            int64_t K, Edge* queue,
                                            Drain&& drain) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const float4* blk = reinterpret_cast<const float4*>(
                          vals + (w.r * K * kBn + w.la) * kBn) + lane;
  auto flush = [&](int n) {
    __syncwarp();  // every lane's entries are in the queue
    drain(n);
    __syncwarp();  // the queue may be refilled
  };
  // a block row's edges (tot) and those of the lanes below this one (pre)
  auto count = [&](const float4& v, int& tot, int& pre) {
    const unsigned m0 = __ballot_sync(kAll, v.x > 0.f);
    const unsigned m1 = __ballot_sync(kAll, v.y > 0.f);
    const unsigned m2 = __ballot_sync(kAll, v.z > 0.f);
    const unsigned m3 = __ballot_sync(kAll, v.w > 0.f);
    tot = __popc(m0) + __popc(m1) + __popc(m2) + __popc(m3);
    pre = __popc(m0 & below) + __popc(m1 & below) + __popc(m2 & below) +
          __popc(m3 & below);
  };
  // the lane's edges of a block row from queue position `at`
  auto put = [&](const float4& v, int32_t jb, int at) {
    if (v.x > 0.f) queue[at++] = Edge{v.x, jb};
    if (v.y > 0.f) queue[at++] = Edge{v.y, jb + 1};
    if (v.z > 0.f) queue[at++] = Edge{v.z, jb + 2};
    if (v.w > 0.f) queue[at] = Edge{v.w, jb + 3};
  };
  // the lane's first far row in block row k
  auto far_row = [&](int64_t k) {
    const int32_t c = k < kWarp ? __shfl_sync(kAll, colv, static_cast<int>(k))
                                : (k < K ? __ldg(cols_r + k) : 0);
    return c * kBn + 4 * lane;
  };
  int n = 0;  // queued entries (warp-uniform)
  for (int64_t k0 = 0; k0 < K; k0 += kChunk) {
    float4 v[kChunk];
    int32_t jb[kChunk];
    int tot[kChunk], pre[kChunk];
    const int m = K - k0 < kChunk ? static_cast<int>(K - k0) : kChunk;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (q == m) break;
      v[q] = __ldg(blk + (k0 + q) * (kBn * kBn / 4));
      jb[q] = far_row(k0 + q);
    }
    int all = 0;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (q == m) break;
      count(v[q], tot[q], pre[q]);
      all += tot[q];
    }
    if (n + all <= kQueue) {
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (q == m) break;
        put(v[q], jb[q], n + pre[q]);
        n += tot[q];
      }
      continue;
    }
    // a hub row: its block rows one at a time (read again), draining
    // whenever the next one's edges would not fit
    for (int64_t k = k0; k < K && k < k0 + kChunk; ++k) {
      const float4 vk = __ldg(blk + k * (kBn * kBn / 4));
      int t, b;
      count(vk, t, b);
      if (n + t > kQueue) {
        flush(n);
        n = 0;
      }
      put(vk, far_row(k), n + b);
      n += t;
    }
  }
  flush(n);
}

// A pass's far side: kN operands [n, F] read at each queued edge's far
// row (zeros past n and past F).
template <int kN>
struct Far {
  const float* op[kN];
  int32_t n;
};

// fold(mu, v) over the queued edges [0, n) in queue order, kEdges at a
// time: all kN operands of all of a batch's edges at the lane's features
// are loaded before any is used, and the next batch's before this one is
// folded (two register buffers), so a row's loads overlap one another and
// its folds; v[c][p] is operand c at feature p of the edge's far row.
// Offsets are 32-bit (the launchers check n * F). Warp-uniform, as the
// queue is.
template <int kN, class Fold>
__device__ __forceinline__ void for_queued(const Edge* queue, int n,
                                           const Row& w, const Dims& d,
                                           const Far<kN>& far, Fold&& fold) {
  const int F = static_cast<int>(d.F);
  int fo[kFw];  // the lane's features, or -1 past F
#pragma unroll
  for (int p = 0; p < kFw; ++p)
    fo[p] = w.ok(p, d.F) ? static_cast<int>(w.f[p]) : -1;
  struct Batch {
    float mu[kEdges];
    float v[kEdges][kN][kFw];
  };
  // issue the loads of the batch at queue position i (zeros past n)
  auto load_batch = [&](Batch& b, int i) {
#pragma unroll
    for (int e = 0; e < kEdges; ++e) {
      const Edge ed = i + e < n ? queue[i + e] : Edge{0.f, far.n};
      b.mu[e] = ed.mu;
      const bool in = ed.j < far.n;
#pragma unroll
      for (int o = 0; o < kN; ++o)
#pragma unroll
        for (int p = 0; p < kFw; ++p)
          b.v[e][o][p] = in && fo[p] >= 0
                             ? __ldg(far.op[o] + ed.j * F + fo[p]) : 0.f;
    }
  };
  auto fold_batch = [&](const Batch& b, int i) {
#pragma unroll
    for (int e = 0; e < kEdges; ++e)
      if (i + e < n) fold(b.mu[e], b.v[e]);
  };
  if (n == 0) return;
  Batch a, b;
  load_batch(a, 0);
  for (int i = 0; i < n; i += 2 * kEdges) {
    if (i + kEdges < n) load_batch(b, i + kEdges);
    fold_batch(a, i);
    if (i + kEdges >= n) break;
    if (i + 2 * kEdges < n) load_batch(a, i + 2 * kEdges);
    fold_batch(b, i + kEdges);
  }
}

// The forward: the running stats of the warp's row in registers, folded
// edge by edge in queue order. A strictly smaller (larger) message resets
// its tie count to the edge's multiplicity, an equal one adds it; selects,
// so no lane branches.
__global__ void __launch_bounds__(kWarp * kRowsPerCta)
pna_fwd_kernel(const float* __restrict__ xd, const float* __restrict__ xs,
               const float* __restrict__ vals,
               const int32_t* __restrict__ cols, const Dims d,
               float* __restrict__ s_out, float* __restrict__ mn_out,
               float* __restrict__ mx_out, float* __restrict__ cnt_out,
               float* __restrict__ cmin_out, float* __restrict__ cmax_out) {
  __shared__ Edge queue_s[kRowsPerCta][kQueue];
  const Row w = warp_row(d);
  if (!w.live) return;                  // the whole warp: one row
  const int32_t* cols_r = cols + w.r * d.K;
  const int32_t colv = lane_col(cols_r, d);
  float xdv[kFw], s[kFw], mn[kFw], mx[kFw], cmin[kFw], cmax[kFw];
  load(xdv, xd, w.row, d.n_rows, w, d.F);
#pragma unroll
  for (int p = 0; p < kFw; ++p) {
    s[p] = 0.f;
    mn[p] = kBig;
    mx[p] = -kBig;
    cmin[p] = 0.f;
    cmax[p] = 0.f;
  }
  float cnt = 0.f;
  const Far<1> far{{xs}, static_cast<int32_t>(d.n_cols)};
  Edge* queue = queue_s[threadIdx.y];
  queue_edges(vals, cols_r, colv, w, d.K, queue, [&](int n) {
    for_queued(queue, n, w, d, far,
               [&](float mu, const float (&v)[1][kFw]) {
      cnt = __fadd_rn(cnt, mu);
#pragma unroll
      for (int p = 0; p < kFw; ++p) {
        const float m = fmaxf(__fadd_rn(xdv[p], v[0][p]), 0.f);
        s[p] = __fadd_rn(s[p], __fmul_rn(mu, m));
        const bool lo = m < mn[p], lo_eq = m == mn[p];
        cmin[p] = lo ? mu : (lo_eq ? __fadd_rn(cmin[p], mu) : cmin[p]);
        mn[p] = lo ? m : mn[p];
        const bool hi = m > mx[p], hi_eq = m == mx[p];
        cmax[p] = hi ? mu : (hi_eq ? __fadd_rn(cmax[p], mu) : cmax[p]);
        mx[p] = hi ? m : mx[p];
      }
    });
  });
  const bool has = cnt > 0.f;
#pragma unroll
  for (int p = 0; p < kFw; ++p) {
    if (!w.ok(p, d.F)) continue;
    const int64_t o = w.at(w.row, p, d.F);
    s_out[o] = s[p];
    mn_out[o] = has ? mn[p] : 0.f;
    mx_out[o] = has ? mx[p] : 0.f;
    cmin_out[o] = cmin[p];
    cmax_out[o] = cmax[p];
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) cnt_out[w.row] = cnt;
}

// A min/max cotangent's share per tie: __fdiv_rn(g, fmaxf(c, 1)). A count
// of at most 1 (or NaN) divides by 1, which gives g exactly, so only a
// count above 1 runs the division: a tie of several edges, or one edge of
// multiplicity above 1.
__device__ __forceinline__ float share(float g, float c) {
  return c > 1.f ? __fdiv_rn(g, c) : g;
}

__global__ void __launch_bounds__(kWarp * kRowsPerCta)
pna_bwd_row_kernel(const float* __restrict__ xd, const float* __restrict__ xs,
                   const float* __restrict__ gs, const float* __restrict__ gmn,
                   const float* __restrict__ gmx, const float* __restrict__ mn,
                   const float* __restrict__ mx,
                   const float* __restrict__ cmin,
                   const float* __restrict__ cmax,
                   const float* __restrict__ vals,
                   const int32_t* __restrict__ cols, const Dims d,
                   float* __restrict__ dxd) {
  __shared__ Edge queue_s[kRowsPerCta][kQueue];
  const Row w = warp_row(d);
  if (!w.live) return;                  // the whole warp: one row
  const int32_t* cols_r = cols + w.r * d.K;
  const int32_t colv = lane_col(cols_r, d);
  float xdv[kFw], gsv[kFw], mnv[kFw], mxv[kFw], gnv[kFw], cnv[kFw],
      gxv[kFw], cxv[kFw], acc[kFw];
  load(xdv, xd, w.row, d.n_rows, w, d.F);
  load(gsv, gs, w.row, d.n_rows, w, d.F);
  load(mnv, mn, w.row, d.n_rows, w, d.F);
  load(mxv, mx, w.row, d.n_rows, w, d.F);
  load(gnv, gmn, w.row, d.n_rows, w, d.F);
  load(cnv, cmin, w.row, d.n_rows, w, d.F);
  load(gxv, gmx, w.row, d.n_rows, w, d.F);
  load(cxv, cmax, w.row, d.n_rows, w, d.F);
#pragma unroll
  for (int p = 0; p < kFw; ++p) acc[p] = 0.f;
  const Far<1> far{{xs}, static_cast<int32_t>(d.n_cols)};
  Edge* queue = queue_s[threadIdx.y];
  queue_edges(vals, cols_r, colv, w, d.K, queue, [&](int n) {
    // the shares, once the row's operands have long arrived; an edge
    // adds one only where its message z > 0 equals the extreme, so an
    // extreme of at most 0 (or NaN) never uses its share, and skips the
    // division
    float gn[kFw], gx[kFw];
#pragma unroll
    for (int p = 0; p < kFw; ++p) {
      gn[p] = mnv[p] > 0.f ? share(gnv[p], cnv[p]) : 0.f;
      gx[p] = mxv[p] > 0.f ? share(gxv[p], cxv[p]) : 0.f;
    }
    for_queued(queue, n, w, d, far,
               [&](float mu, const float (&v)[1][kFw]) {
#pragma unroll
      for (int p = 0; p < kFw; ++p) {
        // relu'(z) = [z > 0], msg = z; selects, so no lane branches
        const float z = __fadd_rn(xdv[p], v[0][p]);
        float g = gsv[p];
        g = z == mnv[p] ? __fadd_rn(g, gn[p]) : g;
        g = z == mxv[p] ? __fadd_rn(g, gx[p]) : g;
        acc[p] = z > 0.f ? __fadd_rn(acc[p], __fmul_rn(mu, g)) : acc[p];
      }
    });
  });
#pragma unroll
  for (int p = 0; p < kFw; ++p)
    if (w.ok(p, d.F)) dxd[w.at(w.row, p, d.F)] = acc[p];
}

// Over the transposed blocks: rows are sources, columns destinations, and
// every destination-side operand is read at the queued edges' far rows.
enum { kXd, kGs, kMn, kMx, kGmn, kCmin, kGmx, kCmax, kDstOps };

__global__ void __launch_bounds__(kWarp * kRowsPerCta)
pna_bwd_col_kernel(const float* __restrict__ xd, const float* __restrict__ xs,
                   const float* __restrict__ gs, const float* __restrict__ gmn,
                   const float* __restrict__ gmx, const float* __restrict__ mn,
                   const float* __restrict__ mx,
                   const float* __restrict__ cmin,
                   const float* __restrict__ cmax,
                   const float* __restrict__ vals_t,
                   const int32_t* __restrict__ cols_t, const Dims d,
                   float* __restrict__ dxs) {
  __shared__ Edge queue_s[kRowsPerCta][kQueue];
  const Row w = warp_row(d);
  if (!w.live) return;
  const int32_t* cols_r = cols_t + w.r * d.K;
  const int32_t colv = lane_col(cols_r, d);
  float xsv[kFw], acc[kFw];
  load(xsv, xs, w.row, d.n_rows, w, d.F);
#pragma unroll
  for (int p = 0; p < kFw; ++p) acc[p] = 0.f;
  const Far<kDstOps> far{{xd, gs, mn, mx, gmn, cmin, gmx, cmax},
                         static_cast<int32_t>(d.n_cols)};
  Edge* queue = queue_s[threadIdx.y];
  queue_edges(vals_t, cols_r, colv, w, d.K, queue, [&](int n) {
    for_queued(queue, n, w, d, far,
               [&](float mu, const float (&v)[kDstOps][kFw]) {
#pragma unroll
      for (int p = 0; p < kFw; ++p) {
        const float z = __fadd_rn(xsv[p], v[kXd][p]);
        float t = v[kGs][p];
        if (z == v[kMn][p]) t = __fadd_rn(t, share(v[kGmn][p], v[kCmin][p]));
        if (z == v[kMx][p]) t = __fadd_rn(t, share(v[kGmx][p], v[kCmax][p]));
        acc[p] = z > 0.f ? __fadd_rn(acc[p], __fmul_rn(mu, t)) : acc[p];
      }
    });
  });
#pragma unroll
  for (int p = 0; p < kFw; ++p)
    if (w.ok(p, d.F)) dxs[w.at(w.row, p, d.F)] = acc[p];
}

// The launchers' limits: a queued far row and its 32-bit offset j * F + f
// (j below n_cols + 128, padding columns included).
bool fits(int64_t n_cols, int64_t F, int64_t K) {
  return K * kBn <= INT32_MAX &&
         (n_cols + kBn) * (F > 0 ? F : 1) <= INT32_MAX;
}

}  // namespace

REPRO_API int repro_pna_reduce_fwd_f32(
    const float* xd, const float* xs, int64_t n_dst, int64_t n_src,
    int64_t F, const float* vals, const int32_t* cols, int64_t R, int64_t K,
    float* s, float* mn, float* mx, float* cnt, float* cmin, float* cmax,
    void* stream) {
  if (R == 0 || n_dst == 0) return 0;
  if (!fits(n_src, F, K)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{n_dst, n_src, F, R, K};
  pna_fwd_kernel<<<grid_for(n_dst, F), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      xd, xs, vals, cols, d, s, mn, mx, cnt, cmin, cmax);
  REPRO_CHECK_LAUNCH();
  return 0;
}

REPRO_API int repro_pna_reduce_bwd_row_f32(
    const float* xd, const float* xs, const float* gs, const float* gmn,
    const float* gmx, const float* mn, const float* mx, const float* cmin,
    const float* cmax, int64_t n_dst, int64_t n_src, int64_t F,
    const float* vals, const int32_t* cols, int64_t R, int64_t K,
    float* dxd, void* stream) {
  if (R == 0 || n_dst == 0 || F == 0) return 0;
  if (!fits(n_src, F, K)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{n_dst, n_src, F, R, K};
  pna_bwd_row_kernel<<<grid_for(n_dst, F), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      xd, xs, gs, gmn, gmx, mn, mx, cmin, cmax, vals, cols, d, dxd);
  REPRO_CHECK_LAUNCH();
  return 0;
}

REPRO_API int repro_pna_reduce_bwd_col_f32(
    const float* xd, const float* xs, const float* gs, const float* gmn,
    const float* gmx, const float* mn, const float* mx, const float* cmin,
    const float* cmax, int64_t n_dst, int64_t n_src, int64_t F,
    const float* vals_t, const int32_t* cols_t, int64_t R_t, int64_t K_t,
    float* dxs, void* stream) {
  if (R_t == 0 || n_src == 0 || F == 0) return 0;
  if (!fits(n_dst, F, K_t))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{n_src, n_dst, F, R_t, K_t};
  pna_bwd_col_kernel<<<grid_for(n_src, F), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      xd, xs, gs, gmn, gmx, mn, mx, cmin, cmax, vals_t, cols_t, d, dxs);
  REPRO_CHECK_LAUNCH();
  return 0;
}
