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
// dwx [n_src, H, F], das [n_src, H]. Destination rows past n_dst and
// source rows past n_src are masked in the loops (the reference pads rows
// to whole blocks and F to 128 lanes: 16x at F = 8, 18x at F = 7).
//
// Design. The TPU kernels walk K as a sequential grid axis and carry the
// online-softmax state (m, l, acc) in VMEM scratch, reading each 64 KB
// multiplicity block once per head and per 128-lane feature tile. Here
// one CTA owns a 128-row block for all heads (blockDim = 128 rows x up to
// 8 heads, one thread per (row, head)), loops over K itself and keeps its
// state in registers; each K step's block is staged in shared memory in
// 32-column chunks once for all heads, with the chunk's logit halves and
// an 8-feature tile of values beside it. The forward updates its online
// softmax once per chunk (chunk max first, then the exponentials), so M
// is bitwise the plain version's max. Features past 8 run in further
// tiles: the forward as a grid dimension, the backward passes as a loop
// in the thread, so the row pass folds -delta * sum alpha' in once per K
// step (on the first tile) and each output has one owner. The column pass
// runs over the transposed blocks, one CTA per source block: every row of
// dwx and das has exactly one owner thread, so there are no atomics and a
// repeat is bit-identical. Masked entries are skipped, never multiplied,
// so values on masked sources do not leak whatever their size. expf, not
// __expf, and no fast-math.
//
// Bound on the H100 (the larger of three): the blocks as stored, all
// R*K*128*128 f32 values read once, plus every other operand read or
// written once, at 3.35 TB/s; the f32 FMAs the nonzero entries need (F
// per entry and head in the forward and the row pass, 2F in the column
// pass) at 67 TFLOP/s; one exponential per nonzero entry and head at 16
// results per clock per SM (132 SMs, the clock from nvidia-smi). A GAT
// batch's multiplicity blocks are sparse (fewer than one stored value in
// a hundred is an edge at the Cora shape), so the block bytes bound all
// three passes at both layers' widths. What the design does about it:
// each block is read once per CTA for all heads (the Pallas grid reads it
// once per head and feature tile), and each pass takes one exponential
// per nonzero entry and head (the backward passes recompute alpha from M
// and L instead of reading per-edge values back). The 128 threads of a
// head each walk their own row, so the chunk's values are shared-memory
// broadcasts; making it fast (fewer, fuller CTAs at small R, skipping
// empty columns) is later work.
#include "common.cuh"

namespace {

constexpr int kBn = 128;         // adjacency block edge
constexpr int kCb = 32;          // block columns staged per chunk
constexpr int kFt = 8;           // features per register tile
constexpr int kMaxHeads = 8;     // heads per CTA (blockDim.y)
constexpr float kNeg = -1e30f;   // the reference's NEG
constexpr float kTiny = 1e-30f;  // the reference's TINY

struct Dims {
  int64_t n_dst, n_src, H, F, R, K;
  float slope;
};

struct Smem {
  float mult[kCb][kBn + 1];            // mult[b][a] = block[a][b0 + b]
  float key[kCb][kMaxHeads];           // the other side's logit halves
  float val[kCb][kMaxHeads][kFt];      // wx (fwd, row) or g (col) tile
  float stat[3][kCb][kMaxHeads];       // M, L, delta (col pass)
};

// __fmul_rn keeps the product from being contracted into a later add, so
// the scores round as the plain version's do
__device__ __forceinline__ float lrelu(float z, float slope) {
  return z > 0.f ? z : __fmul_rn(slope, z);
}

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
es_fwd_kernel(const float* __restrict__ ad, const float* __restrict__ as_,
              const float* __restrict__ wx, const float* __restrict__ vals,
              const int32_t* __restrict__ cols, const Dims d,
              float* __restrict__ out, float* __restrict__ mmax,
              float* __restrict__ lsum) {
  __shared__ Smem sm;
  const int a = threadIdx.x;
  const int hh = threadIdx.y;
  const int hpb = blockDim.y;
  const int tid = hh * kBn + a;
  const int nthreads = kBn * hpb;
  const int64_t r = blockIdx.x;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * hpb;
  const int64_t h = h0 + hh;
  const int64_t f0 = static_cast<int64_t>(blockIdx.z) * kFt;
  const int64_t row = r * kBn + a;
  const bool live = row < d.n_dst && h < d.H;
  const float adv = live ? __ldg(ad + row * d.H + h) : 0.f;

  float m = kNeg;
  float l = 0.f;
  float acc[kFt];
#pragma unroll
  for (int f = 0; f < kFt; ++f) acc[f] = 0.f;

  for (int64_t k = 0; k < d.K; ++k) {
    const int64_t col = __ldg(cols + r * d.K + k);
    const float* blk = vals + (r * d.K + k) * kBn * kBn;
    for (int b0 = 0; b0 < kBn; b0 += kCb) {
      __syncthreads();  // the previous chunk is consumed
      stage_mult(sm, blk, b0, tid, nthreads);
      stage_rows(sm, as_, wx, col * kBn + b0, d.n_src, d, h0, hpb, f0, tid,
                 nthreads);
      __syncthreads();  // the chunk is staged
      if (!live) continue;
      float cmax = kNeg;
      for (int b = 0; b < kCb; ++b) {
        if (sm.mult[b][a] > 0.f)
          cmax = fmaxf(cmax, lrelu(adv + sm.key[b][hh], d.slope));
      }
      const float m_new = fmaxf(m, cmax);
      const float scale = expf(m - m_new);
      l *= scale;
#pragma unroll
      for (int f = 0; f < kFt; ++f) acc[f] *= scale;
      for (int b = 0; b < kCb; ++b) {
        const float mu = sm.mult[b][a];
        if (mu > 0.f) {
          const float s = lrelu(adv + sm.key[b][hh], d.slope);
          const float p = mu * expf(s - m_new);
          l += p;
#pragma unroll
          for (int f = 0; f < kFt; ++f)
            acc[f] = fmaf(p, sm.val[b][hh][f], acc[f]);
        }
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float den = fmaxf(l, kTiny);
#pragma unroll
  for (int f = 0; f < kFt; ++f)
    if (f0 + f < d.F) out[(row * d.H + h) * d.F + f0 + f] = acc[f] / den;
  if (blockIdx.z == 0) {
    mmax[row * d.H + h] = m;
    lsum[row * d.H + h] = l;
  }
}

__global__ void __launch_bounds__(kBn * kMaxHeads)
es_bwd_row_kernel(const float* __restrict__ ad,
                  const float* __restrict__ as_,
                  const float* __restrict__ wx, const float* __restrict__ g,
                  const float* __restrict__ mmax,
                  const float* __restrict__ lsum,
                  const float* __restrict__ delta,
                  const float* __restrict__ vals,
                  const int32_t* __restrict__ cols, const Dims d,
                  float* __restrict__ dad) {
  __shared__ Smem sm;
  const int a = threadIdx.x;
  const int hh = threadIdx.y;
  const int hpb = blockDim.y;
  const int tid = hh * kBn + a;
  const int nthreads = kBn * hpb;
  const int64_t r = blockIdx.x;
  const int64_t h0 = static_cast<int64_t>(blockIdx.y) * hpb;
  const int64_t h = h0 + hh;
  const int64_t row = r * kBn + a;
  const bool live = row < d.n_dst && h < d.H;
  const int64_t o = row * d.H + h;
  const float adv = live ? __ldg(ad + o) : 0.f;
  const float mv = live ? __ldg(mmax + o) : 0.f;
  const float den = live ? fmaxf(__ldg(lsum + o), kTiny) : 1.f;
  const float dv = live ? __ldg(delta + o) : 0.f;

  float acc = 0.f;
  for (int64_t f0 = 0; f0 < d.F; f0 += kFt) {
    float gt[kFt];
#pragma unroll
    for (int f = 0; f < kFt; ++f)
      gt[f] = (live && f0 + f < d.F) ? __ldg(g + o * d.F + f0 + f) : 0.f;
    for (int64_t k = 0; k < d.K; ++k) {
      const int64_t col = __ldg(cols + r * d.K + k);
      const float* blk = vals + (r * d.K + k) * kBn * kBn;
      float sap = 0.f;
      for (int b0 = 0; b0 < kBn; b0 += kCb) {
        __syncthreads();
        stage_mult(sm, blk, b0, tid, nthreads);
        stage_rows(sm, as_, wx, col * kBn + b0, d.n_src, d, h0, hpb, f0,
                   tid, nthreads);
        __syncthreads();
        if (!live) continue;
        for (int b = 0; b < kCb; ++b) {
          const float mu = sm.mult[b][a];
          if (mu > 0.f) {
            const float z = adv + sm.key[b][hh];
            const float p = mu * expf(lrelu(z, d.slope) - mv);
            const float ap = (p / den) * (z > 0.f ? 1.f : d.slope);
            float gv = 0.f;
#pragma unroll
            for (int f = 0; f < kFt; ++f) gv = fmaf(gt[f], sm.val[b][hh][f], gv);
            acc = fmaf(ap, gv, acc);
            sap += ap;
          }
        }
      }
      if (f0 == 0) acc -= sap * dv;  // the delta term, once per K step
    }
  }
  if (live) dad[o] = acc;
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

}  // namespace

REPRO_API int repro_edge_softmax_fwd_f32(
    const float* ad, const float* as_, const float* wx, int64_t n_dst,
    int64_t n_src, int64_t H, int64_t F, const float* vals,
    const int32_t* cols, int64_t R, int64_t K, float slope, float* out,
    float* mmax, float* lsum, void* stream) {
  if (R == 0 || H == 0 || F == 0) return 0;
  const Dims d{n_dst, n_src, H, F, R, K, slope};
  const dim3 grid(static_cast<unsigned>(R), head_groups(H),
                  static_cast<unsigned>((F + kFt - 1) / kFt));
  es_fwd_kernel<<<grid, block_dims(H), 0,
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
  if (R == 0 || H == 0) return 0;
  const Dims d{n_dst, n_src, H, F, R, K, slope};
  const dim3 grid(static_cast<unsigned>(R), head_groups(H));
  es_bwd_row_kernel<<<grid, block_dims(H), 0,
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
