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
// shape), so here one warp owns one row of the block structure and walks
// its K blocks itself: each lane reads 4 consecutive multiplicities of the
// row (one coalesced 512-byte read per block, the next block's issued
// before the current one is walked), a ballot finds the columns with an
// edge, and for each edge the warp reads the other side's row at its
// features (lane l holds features l and l + 32 of a 64-feature tile; one
// coalesced read) and updates the running stats in registers. The
// multiplicity is uniform across the warp, so no lane diverges on the
// mask, and masked entries are skipped, never multiplied. Every output has
// one owner lane: no atomics, so a repeat is bit-identical. The column
// pass walks the transposed blocks (rows are sources) and reads the
// destination-side stats and cotangents through the transposed column
// ids, dividing a min/max cotangent by its tie count only where a message
// ties. (A thread per row of a 128-row block row, the Pallas tile's
// shape, spends a warp's divergent pass on every edge of any of its 32
// rows: such designs took 0.09-0.29 ms a pass at the table-5 shape on an
// H100, slower than a composition of PyTorch calls.)
//
// Exactness. msg is one IEEE add and a max, so mn and mx are bitwise the
// plain version's and the Pallas kernel's. The tie counts stream edge by
// edge: a strictly better value resets the count to its multiplicity, an
// equal one adds it; the final count is the multiplicity sum of the edges
// equal to the final extreme, as the reference's per-block update gives,
// in exact small-integer f32 sums. The backward passes recompute msg with
// the same add and compare it with the saved mn / mx for equality. No
// fast math: the divisions round as the reference's.
//
// Bound on the H100 (the larger of two): the blocks as stored, all
// R*K*128*128 f32 values read once, plus every other operand read or
// written once, at 3.35 TB/s; the f32 operations the edges need (a few
// per edge and feature) at 67 TFLOP/s. The block bytes bound all three
// passes. The kernels read each block once per 64-feature tile (once at
// F = 48), and the other side's rows once per edge (from L2 after the
// first); a warp's K reads and per-edge reads are a chain of dependent
// latencies, which is what bounds these small shapes.
#include "common.cuh"

namespace {

constexpr int kBn = 128;                // adjacency block edge
constexpr int kWarp = 32;
constexpr int kFw = 2;                  // features per lane
constexpr int kTileF = kWarp * kFw;     // features per warp and tile
constexpr int kRowsPerCta = 8;          // one warp per row
constexpr unsigned kAll = 0xffffffffu;
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

// Walk the edges of the warp's row: fn(j, mu) for each column of each of
// its K blocks with multiplicity mu > 0, j the global row on the column
// side. Warp-uniform: every lane calls fn with the same (j, mu).
template <typename Fn>
__device__ __forceinline__ void for_each_edge(const float* vals,
                                              const int32_t* cols,
                                              const Dims& d, const Row& w,
                                              Fn fn) {
  auto block_row = [&](int64_t k) {
    return __ldg(reinterpret_cast<const float4*>(
                     vals + ((w.r * d.K + k) * kBn + w.la) * kBn) +
                 threadIdx.x);
  };
  float4 next = d.K > 0 ? block_row(0) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t k = 0; k < d.K; ++k) {
    const float4 m = next;
    if (k + 1 < d.K) next = block_row(k + 1);
    const int64_t base = static_cast<int64_t>(__ldg(cols + w.r * d.K + k)) *
                         kBn;
    unsigned mask = __ballot_sync(
        kAll, m.x > 0.f || m.y > 0.f || m.z > 0.f || m.w > 0.f);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float mv[4] = {__shfl_sync(kAll, m.x, src),
                           __shfl_sync(kAll, m.y, src),
                           __shfl_sync(kAll, m.z, src),
                           __shfl_sync(kAll, m.w, src)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (mv[e] > 0.f) fn(base + 4 * src + e, mv[e]);
    }
  }
}

dim3 grid_for(int64_t n_rows, int64_t F) {
  const int64_t tiles = F > 0 ? (F + kTileF - 1) / kTileF : 1;
  return dim3(static_cast<unsigned>((n_rows + kRowsPerCta - 1) / kRowsPerCta),
              static_cast<unsigned>(tiles));
}

const dim3 kBlock(kWarp, kRowsPerCta);

__global__ void __launch_bounds__(kWarp * kRowsPerCta)
pna_fwd_kernel(const float* __restrict__ xd, const float* __restrict__ xs,
               const float* __restrict__ vals,
               const int32_t* __restrict__ cols, const Dims d,
               float* __restrict__ s_out, float* __restrict__ mn_out,
               float* __restrict__ mx_out, float* __restrict__ cnt_out,
               float* __restrict__ cmin_out, float* __restrict__ cmax_out) {
  const Row w = warp_row(d);
  if (!w.live) return;                  // the whole warp: one row
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
  for_each_edge(vals, cols, d, w, [&](int64_t j, float mu) {
    float x[kFw];
    load(x, xs, j, d.n_cols, w, d.F);
    cnt += mu;
#pragma unroll
    for (int p = 0; p < kFw; ++p) {
      const float m = fmaxf(__fadd_rn(xdv[p], x[p]), 0.f);
      s[p] = __fadd_rn(s[p], __fmul_rn(mu, m));
      if (m < mn[p]) {
        mn[p] = m;
        cmin[p] = mu;
      } else if (m == mn[p]) {
        cmin[p] += mu;
      }
      if (m > mx[p]) {
        mx[p] = m;
        cmax[p] = mu;
      } else if (m == mx[p]) {
        cmax[p] += mu;
      }
    }
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

// A min/max cotangent's share per tie.
__device__ __forceinline__ float share(float g, float c) {
  return __fdiv_rn(g, fmaxf(c, 1.f));
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
  const Row w = warp_row(d);
  if (!w.live) return;
  float xdv[kFw], gsv[kFw], mnv[kFw], mxv[kFw], gn[kFw], cn[kFw], gx[kFw],
      cx[kFw], acc[kFw];
  load(xdv, xd, w.row, d.n_rows, w, d.F);
  load(gsv, gs, w.row, d.n_rows, w, d.F);
  load(mnv, mn, w.row, d.n_rows, w, d.F);
  load(mxv, mx, w.row, d.n_rows, w, d.F);
  load(gn, gmn, w.row, d.n_rows, w, d.F);
  load(cn, cmin, w.row, d.n_rows, w, d.F);
  load(gx, gmx, w.row, d.n_rows, w, d.F);
  load(cx, cmax, w.row, d.n_rows, w, d.F);
#pragma unroll
  for (int p = 0; p < kFw; ++p) {
    gn[p] = share(gn[p], cn[p]);
    gx[p] = share(gx[p], cx[p]);
    acc[p] = 0.f;
  }
  for_each_edge(vals, cols, d, w, [&](int64_t j, float mu) {
    float x[kFw];
    load(x, xs, j, d.n_cols, w, d.F);
#pragma unroll
    for (int p = 0; p < kFw; ++p) {
      const float z = __fadd_rn(xdv[p], x[p]);
      if (!(z > 0.f)) continue;         // relu'(z) = [z > 0]; msg = z
      float g = gsv[p];
      if (z == mnv[p]) g = __fadd_rn(g, gn[p]);
      if (z == mxv[p]) g = __fadd_rn(g, gx[p]);
      acc[p] = __fadd_rn(acc[p], __fmul_rn(mu, g));
    }
  });
#pragma unroll
  for (int p = 0; p < kFw; ++p)
    if (w.ok(p, d.F)) dxd[w.at(w.row, p, d.F)] = acc[p];
}

// Over the transposed blocks: rows are sources, columns destinations, and
// every destination-side operand is read through the transposed column
// ids.
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
  const Row w = warp_row(d);
  if (!w.live) return;
  float xsv[kFw], acc[kFw];
  load(xsv, xs, w.row, d.n_rows, w, d.F);
#pragma unroll
  for (int p = 0; p < kFw; ++p) acc[p] = 0.f;
  for_each_edge(vals_t, cols_t, d, w, [&](int64_t i, float mu) {
    float x[kFw], g[kFw], lo[kFw], hi[kFw];
    load(x, xd, i, d.n_cols, w, d.F);
    load(g, gs, i, d.n_cols, w, d.F);
    load(lo, mn, i, d.n_cols, w, d.F);
    load(hi, mx, i, d.n_cols, w, d.F);
#pragma unroll
    for (int p = 0; p < kFw; ++p) {
      const float z = __fadd_rn(xsv[p], x[p]);
      if (!(z > 0.f)) continue;
      float t = g[p];
      const int64_t o = w.at(i, p, d.F);
      if (z == lo[p]) t = __fadd_rn(t, share(__ldg(gmn + o), __ldg(cmin + o)));
      if (z == hi[p]) t = __fadd_rn(t, share(__ldg(gmx + o), __ldg(cmax + o)));
      acc[p] = __fadd_rn(acc[p], __fmul_rn(mu, t));
    }
  });
#pragma unroll
  for (int p = 0; p < kFw; ++p)
    if (w.ok(p, d.F)) dxs[w.at(w.row, p, d.F)] = acc[p];
}

}  // namespace

REPRO_API int repro_pna_reduce_fwd_f32(
    const float* xd, const float* xs, int64_t n_dst, int64_t n_src,
    int64_t F, const float* vals, const int32_t* cols, int64_t R, int64_t K,
    float* s, float* mn, float* mx, float* cnt, float* cmin, float* cmax,
    void* stream) {
  if (R == 0 || n_dst == 0) return 0;
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
  const Dims d{n_src, n_dst, F, R_t, K_t};
  pna_bwd_col_kernel<<<grid_for(n_src, F), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      xd, xs, gs, gmn, gmx, mn, mx, cmin, cmax, vals_t, cols_t, d, dxs);
  REPRO_CHECK_LAUNCH();
  return 0;
}
