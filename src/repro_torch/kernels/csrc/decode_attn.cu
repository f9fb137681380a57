// GQA decode attention for one token over a KV cache (flash-decode).
//
// Replaces src/repro/kernels/decode_attn.py:67 flash_decode (kernel body
// _kernel, :26-63) -> repro_flash_decode_f32 / repro_flash_decode_bf16.
//
// For batch row b, KV head h and group member g (query head h*G + g):
//   s_j = (q[b,h,g,:] . k[b,j,h,:]) * scale          j < n_valid
//   m = max_j s_j,  p_j = exp(s_j - m),  l = sum_j p_j
//   out[b,h,g,:] = (sum_j round_v(p_j) v[b,j,h,:]) / max(l, 1e-30)
// with n_valid = S if pos >= S (a rolling buffer: every slot live), else
// pos + 1. Layouts as the reference's: q and out [B, Kh, G, Dh], k and v
// [B, S, Kh, Dh], all of one type (f32 or bf16). The arithmetic contract
// is the Pallas kernel's: scores in f32 from exact products, multiplied by
// the scale after the dot; p rounded to v's type (round_v) before it
// weighs v, while l sums the unrounded p; the running max, normalizer and
// accumulator in f32; the output rounded once to q's type.
//
// Design. The TPU kernel walks the S axis as the innermost sequential
// grid dimension, carrying (m, l, acc) in VMEM scratch from one 256-slot
// block to the next, and masks slots past pos inside each block (a block
// wholly past pos adds exp(-1e30 - m) = 0 terms). On the H100 nothing
// carries between CTAs, and B * Kh (64 at the serving cell) CTAs would
// leave half of the 132 SMs idle, so the valid slots are cut into chunks
// (flash-decoding): one CTA per (b, h, group tile, chunk) writes its
// chunk's folded (m, l, acc) per group member to a scratch [pairs,
// n_splits, GT, 2 + Dh] f32, and a second small kernel folds the chunks:
// M = max_i m_i, out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i -
// M), 1e-30). It is launched as a programmatic dependent of the first, so
// its launch overlaps the first one's tail; from 16 chunks up it reads
// their states 16 at a time, every load of a batch in flight at once (one
// chunk's loads at a time cost an L2 round trip a chunk, slow past a few
// dozen chunks: the Dh-256 lines of PERF.md row 17). Only slots below
// n_valid are
// read: the grid covers the valid slots alone (the wrapper sizes it from
// pos), so a masked slot, or a chunk past pos, contributes nothing and is
// never loaded, and perturbing the masked tail leaves the output bitwise
// unchanged. Any S is taken (the TPU kernel needs S % 256 == 0), any G >=
// 1 and Dh in {32, 64, 128, 256} (256: recurrentgemma-9b's heads).
//
// Bound on the H100: bytes. One step reads each valid k and v row once
// (2 * B * n_valid * Kh * Dh elements) and q, and writes out; the
// operations, 4 * B * Kh * G * n_valid * Dh flops, are G per byte in
// bf16 (G/2 in f32), far below the ~20 f32 flops per byte at which the
// card turns compute-bound. Holding the card's 3.35 TB/s takes ~20 KB in
// flight on every SM without a break.
//
// bf16 (the serving path). The chunks are long: the wrapper sizes their
// number from the SM count so that the CTAs, one on each SM, fill the card
// in one wave (2 splits of 16,384 slots at B = 8, Kh = 8 and 32,768
// slots), and the fold and scratch write happen once per chunk. A CTA of
// 4 warps streams its chunk through a ring of 64-slot tiles of k and v in
// shared memory, filled with 16-byte cp.async copies: 4 stages (128 KB at
// Dh = 128; three tiles, 96 KB, in flight while one is scored) up to Dh =
// 128, 3 stages at Dh = 256 (192 KB; 4 would take 256 KB, past the 227 KB
// a block may have); rows past the chunk's end are zero-filled, never
// read. At Dh = 256 a lane holds q's fragments (64 registers) and the
// accumulator (128): `-Xptxas -v` (nvcc 12.9, sm_90a) reports 255
// registers and 0 bytes of spills for both Dh-256 instances (164 at Dh =
// 128). Each warp scores 16 slots of a tile on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 out): the group tile of up to 16
// members is M (rows past G carry a zero query), the slots are N, Dh is
// K; q's fragments stay in registers.
// A bf16 product is exact in f32, so the scores keep the contract; only
// the order of the f32 sums differs. p is rounded to bf16 and fed back as
// the A fragment of p . v (ldmatrix.trans reads v's tile as B), while l
// sums the f32 p. The tiles are stored with an XOR swizzle of their
// 16-byte chunks, so ldmatrix reads eight rows without bank conflicts.
// Each warp keeps an online (m, l, acc) per member (acc rescaled only
// when a member's max moved); the CTA folds its 4 warps through shared
// memory.
//
// f32 (the f32 decode of every config: recurrentgemma-9b's exact path
// at its published widths, qwen3's f32 comparison, any `dtype="float32"`
// caller; held at 1e-5). The same split as bf16: the wrapper sizes the
// chunks from the SM count so that the CTAs fill the card in one wave
// (its F32_CTAS_PER_SM a SM: 1 at Dh = 256, 2 at 128, 4 at 64, 8 at 32,
// which the static_asserts below check against the shared memory; the
// launch checks only what the kernel needs of a plan), each chunk
// whole 32-slot tiles, and the group in one tile of up to 16 members
// (tiles of 16 past that), so each k and v row is read from device
// memory once a step for G <= 16. A CTA of Dh / 32 warps streams its
// chunk through a 2-stage ring of 32-slot k and v tiles (16-byte cp.async
// copies; 64 KB a stage at Dh = 256, so one tile is in flight while the
// other is scored, ~64 KB on every SM; rows past the chunk's end
// zero-filled, never read). A tile takes three steps, each closed by a
// barrier:
//   scores: warp w takes the 32 features 32w..32w+31 of every slot and
//     member; lane (gg = lane / 8, jj = lane % 8) sums exact f32 products
//     for members gg + 4i (i < MP, MP = ceil(members / 4)) and slots jj +
//     8b (b < 4), an outer product of 4-float chunks: per chunk MP q
//     loads (rows padded by 16 bytes) and 4 k loads (chunk c of row r
//     stored at c ^ (r % 8), so the 8 rows a load reads hit 8 bank
//     groups) feed 16 MP FMAs. The partial scores go to shared memory.
//   softmax: 2W lanes a member row sum the W partials in order, scale
//     them after the dot, mask slots past s1, and keep the row's online
//     (m, l) (l from the unrounded p: f32 needs no rounding of p); p and
//     the rescale exp(m_old - m_new) go to shared memory.
//   p . v: lane (pg = lane / 8, dg = lane % 8) of warp w holds the 4
//     columns of chunk 8w + dg for members pg + 4i: acc is MP x 4
//     registers, rescaled, then 4 MP FMAs a slot from one v load and one
//     p load. The warps own disjoint columns, so nothing is folded across
//     them: each lane writes its acc to the chunk's partial state.
// No warp sum a slot: a tile's scores cost one barrier-separated pass
// through 2.5 KB of shared memory a warp. `-Xptxas -v` (nvcc 12.9,
// sm_90a) reports, for (Dh, MP): 128 registers at MP 4 (every Dh), 114 /
// 74 / 71 at Dh 256 and MP 3 / 2 / 1, 72-136 at the other Dh; no spill
// but 12 bytes at (128, 3) and 8 at (64, 3), instances no config's main
// path takes (G 9-12). The fold: 95 registers, no spill.
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

namespace {

// f32 as float, bf16 as its raw 16 bits, from f32
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ uint16_t from_f<uint16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// ---- bf16: a ring of k / v tiles, scored on the tensor cores ----------

constexpr int kTile = 64;           // slots per ring stage (the wrapper's TILE)
// ring depth: three tiles in flight, two at Dh = 256 (the ring's bytes,
// kStages * 2 * kTile * DH * 2, within a block's 227 KB)
template <int DH>
constexpr int kStages = DH >= 256 ? 3 : 4;
constexpr int kWarps16 = kTile / 16;  // each warp scores 16 slots of a tile
constexpr int kThreads16 = kWarps16 * 32;
constexpr int kMaxGroupTile = 16;   // the M of m16n8k16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// A tile row holds CH = Dh / 8 chunks of 16 bytes; chunk c of row r is
// stored at chunk c ^ f(r), so that the eight rows an ldmatrix reads at
// one logical chunk fall in eight distinct 16-byte bank groups
template <int CH>
__device__ __forceinline__ int swizzle(int r, int c) {
  return CH >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

// one CTA per (pair = (b, h, group tile), chunk); writes the chunk's
// folded (m, l, acc) per member of the group tile. HI: the tile has more
// than 8 members (rows 8-15 of the mma's M)
template <int DH, bool HI>
__global__ void __launch_bounds__(kThreads16, 1)
    flash_decode_bf16_kernel(const uint16_t* __restrict__ q,
                             const uint16_t* __restrict__ k,
                             const uint16_t* __restrict__ v,
                             float* __restrict__ part, int64_t S, int Kh,
                             int G, int n_gt, int gt_size, int64_t n_valid,
                             int64_t chunk, float scale) {
  static_assert(DH == 32 || DH == 64 || DH == 128 || DH == 256, "Dh");
  constexpr int kSt = kStages<DH>;
  constexpr int CH = DH / 8;                 // 16-byte chunks of a row
  constexpr int kRowBytes = DH * 2;
  constexpr int kTileBytes = kTile * kRowBytes;  // k (or v) of one stage
  constexpr int kStageBytes = 2 * kTileBytes;
  constexpr int kRowsPerPass = kThreads16 / CH;
  constexpr int kPasses = kTile / kRowsPerPass;
  extern __shared__ __align__(128) unsigned char smem[];

  const int pair = blockIdx.x;
  const int split = blockIdx.y;
  const int gt = pair % n_gt;
  const int64_t bh = pair / n_gt;
  const int64_t h = bh % Kh;
  const int64_t b = bh / Kh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int64_t s0 = split * chunk;
  const int64_t s1 = min(s0 + chunk, n_valid);
  const int64_t n_tiles = (s1 - s0 + kTile - 1) / kTile;
  const int64_t slot_stride = static_cast<int64_t>(Kh) * DH;
  const uint16_t* kb = k + (b * S * Kh + h) * DH;
  const uint16_t* vb = v + (b * S * Kh + h) * DH;

  // tile t into ring stage t % kSt: thread tid copies chunk tid % CH
  // of every kRowsPerPass-th row (one commit group per tile, empty past
  // the chunk); a row past s1 is zero-filled from a valid address
  const int cc = tid % CH;
  const int cr = tid / CH;
  auto load_tile = [&](int64_t t) {
    if (t < n_tiles) {
      unsigned char* st = smem + (t % kSt) * kStageBytes;
      const int64_t base = s0 + t * kTile;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int r = cr + p * kRowsPerPass;
        const bool ok = base + r < s1;
        const int64_t off = (ok ? base + r : s0) * slot_stride + cc * 8;
        const uint32_t dst = smem_addr(st + r * kRowBytes +
                                       (swizzle<CH>(r, cc) << 4));
        cp_async16(dst, kb + off, ok ? 16 : 0);
        cp_async16(dst + kTileBytes, vb + off, ok ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int t = 0; t < kSt - 1; ++t) load_tile(t);

  // q as the A fragments of the scores (rows past the tile's members
  // zero): row g0 = lane / 4 and g0 + 8, columns cq, cq + 1 of each half
  const int g0 = lane >> 2;
  const int cq = (lane & 3) * 2;
  const uint16_t* qp = q + (bh * G + static_cast<int64_t>(gt) * gt_size) * DH;
  auto q2 = [&](int g, int col) -> uint32_t {
    if (g >= gt_size || gt * gt_size + g >= G) return 0u;
    return *reinterpret_cast<const uint32_t*>(qp + g * DH + col);
  };
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    qa[ks][0] = q2(g0, 16 * ks + cq);
    qa[ks][1] = HI ? q2(g0 + 8, 16 * ks + cq) : 0u;
    qa[ks][2] = q2(g0, 16 * ks + 8 + cq);
    qa[ks][3] = HI ? q2(g0 + 8, 16 * ks + 8 + cq) : 0u;
  }

  // this lane's online state: rows g0 (index 0) and g0 + 8 (index 1);
  // acc[n] holds columns 8n + cq, +1 of both rows
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int wrow = warp * 16;  // this warp's first row of each tile
  for (int64_t t = 0; t < n_tiles; ++t) {
    // tile t has landed (this thread's copies; the barrier: everyone's),
    // and every warp is done with the stage the next load refills
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kSt - 2) : "memory");
    __syncthreads();
    load_tile(t + kSt - 1);
    const unsigned char* st = smem + (t % kSt) * kStageBytes;
    const int64_t base = s0 + t * kTile + wrow;

    // scores of 16 slots: two n-tiles of 8, Dh / 16 k-steps each
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int r = wrow + nt * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < DH / 32; ++kk) {
        uint32_t bf[4];
        ldsm_x4(smem_addr(st + r * kRowBytes +
                          (swizzle<CH>(r, 4 * kk + (lane >> 3)) << 4)),
                bf);
        mma_bf16(sc[nt], qa[2 * kk], bf[0], bf[1]);
        mma_bf16(sc[nt], qa[2 * kk + 1], bf[2], bf[3]);
      }
    }

    // scaled after the dot; slots past s1 (zero rows) masked out
    const bool ragged = base + 16 > s1;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nt][i] *= scale;
        if (ragged && base + nt * 8 + cq + (i & 1) >= s1) sc[nt][i] = -INFINITY;
      }

    // per row: the tile's max over the 4 lanes that hold the row, the
    // rescale of the state, p, and l from the unrounded p
    float alpha[2] = {1.f, 1.f};
    float pr[2][4];
#pragma unroll
    for (int hi = 0; hi < (HI ? 2 : 1); ++hi) {
      float mx = fmaxf(fmaxf(sc[0][2 * hi], sc[0][2 * hi + 1]),
                       fmaxf(sc[1][2 * hi], sc[1][2 * hi + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hi], mx);
      // a row with no valid slot yet keeps m = -inf: p = 0, alpha = 0 on
      // a zero state
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[hi] = expf(m_r[hi] - m_use);
      m_r[hi] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pv = expf(sc[nt][2 * hi + j] - m_use);
          pr[nt][2 * hi + j] = pv;
          sum += pv;
        }
      l_r[hi] = fmaf(l_r[hi], alpha[hi], sum);
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        if (HI) {
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
      }
    }

    // p (bf16) as the A fragment of p . v: n-tile 0 is k 0-7, n-tile 1 k 8-15
    uint32_t pa[4];
    pa[0] = pack_bf16(pr[0][0], pr[0][1]);
    pa[1] = HI ? pack_bf16(pr[0][2], pr[0][3]) : 0u;
    pa[2] = pack_bf16(pr[1][0], pr[1][1]);
    pa[3] = HI ? pack_bf16(pr[1][2], pr[1][3]) : 0u;
    // v's 16 x Dh tile as B, two 8-column d-tiles per ldmatrix.trans
    const int vr = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int n2 = 0; n2 < DH / 16; ++n2) {
      uint32_t bf[4];
      ldsm_x4_trans(smem_addr(st + kTileBytes + vr * kRowBytes +
                              (swizzle<CH>(vr, 2 * n2 + (lane >> 4)) << 4)),
                    bf);
      mma_bf16(acc[2 * n2], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * n2 + 1], pa, bf[2], bf[3]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the fold kernel may launch now: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();  // every warp is done with the ring: it holds the fold

  // fold the warps' states; a warp that drew no valid slot holds m = -inf,
  // l = 0, acc = 0 and weighs exp(-inf) = 0 (warp 0 always draws one: the
  // wrapper leaves no chunk empty, so M is finite)
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l_r[hi] += __shfl_xor_sync(0xffffffffu, l_r[hi], 1);
    l_r[hi] += __shfl_xor_sync(0xffffffffu, l_r[hi], 2);
  }
  float* f_m = reinterpret_cast<float*>(smem);   // [warps][16]
  float* f_l = f_m + kWarps16 * 16;              // [warps][16]
  float* f_acc = f_l + kWarps16 * 16;            // [warps][16][DH]
  if ((lane & 3) == 0) {
    f_m[wrow + g0] = m_r[0];
    f_l[wrow + g0] = l_r[0];
    if (HI) {
      f_m[wrow + g0 + 8] = m_r[1];
      f_l[wrow + g0 + 8] = l_r[1];
    }
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    float* row = f_acc + (wrow + g0) * DH + 8 * n + cq;
    row[0] = acc[n][0];
    row[1] = acc[n][1];
    if (HI) {
      row[8 * DH] = acc[n][2];
      row[8 * DH + 1] = acc[n][3];
    }
  }
  __syncthreads();
  const int members = min(gt_size, G - gt * gt_size);
  for (int e = tid; e < members * DH; e += kThreads16) {
    const int g = e / DH;
    const int d = e % DH;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps16; ++w) M = fmaxf(M, f_m[w * 16 + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps16; ++w) {
      const float ew = expf(f_m[w * 16 + g] - M);
      L = fmaf(f_l[w * 16 + g], ew, L);
      A = fmaf(f_acc[(w * 16 + g) * DH + d], ew, A);
    }
    float* dst = part + ((static_cast<int64_t>(pair) * gridDim.y + split) *
                             gt_size + g) * (DH + 2);
    if (d == 0) {
      dst[0] = M;
      dst[1] = L;
    }
    dst[2 + d] = A;
  }
}

template <int DH, bool HI>
int launch_partial_bf16(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, float* part, int64_t n_pairs,
                        int64_t S, int64_t Kh, int64_t G, int64_t n_gt,
                        int64_t gt, int64_t n_valid, int64_t n_splits,
                        int64_t chunk, float scale, cudaStream_t stream) {
  constexpr int kSmem = kStages<DH> * 2 * kTile * DH * 2;
  static_assert(kSmem <= 227 * 1024, "the ring fits a block");
  static_assert(kSmem >= kWarps16 * 16 * (DH + 2) * 4, "fold fits the ring");
  static bool ready = false;  // the opt-in above 48 KB, once per instance
  if (!ready) {
    if (cudaError_t e = cudaFuncSetAttribute(
            flash_decode_bf16_kernel<DH, HI>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem))
      return static_cast<int>(e);
    ready = true;
  }
  flash_decode_bf16_kernel<DH, HI>
      <<<dim3(static_cast<unsigned>(n_pairs), static_cast<unsigned>(n_splits)),
         kThreads16, kSmem, stream>>>(
          q, k, v, part, S, static_cast<int>(Kh), static_cast<int>(G),
          static_cast<int>(n_gt), static_cast<int>(gt), n_valid, chunk, scale);
  REPRO_CHECK_LAUNCH();
  return 0;
}

template <int DH>
int dispatch_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                  float* part, int64_t n_pairs, int64_t S, int64_t Kh,
                  int64_t G, int64_t n_gt, int64_t gt, int64_t n_valid,
                  int64_t n_splits, int64_t chunk, float scale,
                  cudaStream_t stream) {
  if (gt > 8)
    return launch_partial_bf16<DH, true>(q, k, v, part, n_pairs, S, Kh, G,
                                         n_gt, gt, n_valid, n_splits, chunk,
                                         scale, stream);
  return launch_partial_bf16<DH, false>(q, k, v, part, n_pairs, S, Kh, G,
                                        n_gt, gt, n_valid, n_splits, chunk,
                                        scale, stream);
}

// one CTA of Dh threads per (pair, group member): folds the chunks. It
// runs as a programmatic dependent of the partial kernel and reads the
// scratch only after that grid has finished and flushed. From kFoldBatch
// chunks up, their states are read kFoldBatch at a time, every load of a
// batch issued before the first is used (one L2 round trip a batch, not
// one a chunk). Fewer (qwen3's 2-4) are read one by one, where the batch,
// mostly predicated off, was slower. On an H100 (700 W, `chip_smoke.py
// --parent-csrc`, PERF.md row 17): recurrentgemma's 16-chunk bf16 lines
// 0.0190 / 0.0166 ms batched against 0.0216 / 0.0194 one chunk at a
// time; qwen3's 2-chunk bf16 lines 0.0420 / 0.0532 batched against
// 0.0412 / 0.0524. Either way the chunks fold in order, so the output's
// bits do not depend on the path
constexpr int kFoldBatch = 16;

template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ part,
                                            T* __restrict__ out, int n_splits,
                                            int G, int n_gt, int gt_size) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int pair = blockIdx.x;
  const int g = blockIdx.y;
  const int Dh = blockDim.x;
  const int t = threadIdx.x;
  const int gg = (pair % n_gt) * gt_size + g;
  if (gg >= G) return;
  const int64_t bh = pair / n_gt;
  const int64_t stride = static_cast<int64_t>(gt_size) * (Dh + 2);
  const float* src =
      part + (static_cast<int64_t>(pair) * n_splits * gt_size + g) * (Dh + 2);
  float M = -INFINITY, L = 0.f, A = 0.f;
  if (n_splits < kFoldBatch) {
    for (int i = 0; i < n_splits; ++i) M = fmaxf(M, src[i * stride]);
    for (int i = 0; i < n_splits; ++i) {
      const float e = expf(src[i * stride] - M);
      L = fmaf(src[i * stride + 1], e, L);
      A = fmaf(src[i * stride + 2 + t], e, A);
    }
  } else {
    for (int i0 = 0; i0 < n_splits; i0 += kFoldBatch) {
      float mb[kFoldBatch];
#pragma unroll
      for (int j = 0; j < kFoldBatch; ++j)
        mb[j] = i0 + j < n_splits ? src[(i0 + j) * stride] : -INFINITY;
#pragma unroll
      for (int j = 0; j < kFoldBatch; ++j) M = fmaxf(M, mb[j]);
    }
    for (int i0 = 0; i0 < n_splits; i0 += kFoldBatch) {
      float mb[kFoldBatch], lb[kFoldBatch], ab[kFoldBatch];
#pragma unroll
      for (int j = 0; j < kFoldBatch; ++j) {
        if (i0 + j < n_splits) {
          const float* s = src + (i0 + j) * stride;
          mb[j] = s[0];
          lb[j] = s[1];
          ab[j] = s[2 + t];
        }
      }
#pragma unroll
      for (int j = 0; j < kFoldBatch; ++j) {
        if (i0 + j < n_splits) {
          const float e = expf(mb[j] - M);
          L = fmaf(lb[j], e, L);
          A = fmaf(ab[j], e, A);
        }
      }
    }
  }
  out[(bh * G + gg) * Dh + t] = from_f<T>(A / fmaxf(L, 1e-30f));
}

template <typename T>
int launch_combine(const float* part, T* out, int64_t n_pairs, int64_t G,
                   int64_t n_gt, int64_t gt, int64_t Dh, int64_t n_splits,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_pairs), static_cast<unsigned>(gt));
  cfg.blockDim = dim3(static_cast<unsigned>(Dh));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t e = cudaLaunchKernelEx(
          &cfg, flash_decode_combine_kernel<T>, part, out,
          static_cast<int>(n_splits), static_cast<int>(G),
          static_cast<int>(n_gt), static_cast<int>(gt)))
    return static_cast<int>(e);
  REPRO_CHECK_LAUNCH();
  return 0;
}

// ---- f32: a ring of k / v tiles, scored in f32 on the CUDA cores ------

constexpr int kTileF32 = 32;  // slots per ring stage (the wrapper's TILE_F32)
constexpr int kStagesF32 = 2;     // one tile in flight while one is scored
constexpr int kSlotsF32 = kTileF32 / 8;  // slots a lane scores
constexpr int kMaxGroupF32 = 16;  // members one CTA takes: 4 x MP a lane
constexpr int kRedStride = 40;    // a member's partial scores, padded so
                                  // that the 4 rows a store hits differ
template <int DH>
constexpr int f32_smem_bytes() {
  return (kStagesF32 * 2 * kTileF32 * DH             // the ring
          + kMaxGroupF32 * (DH + 4)              // q
          + DH / 32 * kMaxGroupF32 * kRedStride  // partial scores
          + kTileF32 * kMaxGroupF32              // p
          + kMaxGroupF32) * 4;                   // the rescale
}

// component i of v (i a constant once the loops are unrolled, so no
// local array)
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// one CTA of DH threads per (pair = (b, h, group tile), chunk); writes the
// chunk's (m, l, acc) per member of the group tile. MP: ceil(members / 4)
template <int DH, int MP>
__global__ void __launch_bounds__(DH)
    flash_decode_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ part, int64_t S, int Kh,
                            int G, int n_gt, int gt_size, int64_t n_valid,
                            int64_t chunk, float scale) {
  static_assert(DH == 32 || DH == 64 || DH == 128 || DH == 256, "Dh");
  constexpr int W = DH / 32;              // warps
  constexpr int CH = DH / 4;              // 16-byte chunks of a row
  constexpr int kTileFloats = kTileF32 * DH;
  constexpr int kQStride = DH + 4;
  constexpr int kRowsPerPass = DH / CH;   // 4 rows a copy pass
  constexpr int kPasses = kTileF32 / kRowsPerPass;
  constexpr int LPM = 2 * W;              // softmax lanes a member row
  constexpr int SPL = kTileF32 / LPM;     // slots a softmax lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* qs = ring + kStagesF32 * 2 * kTileFloats;
  float* red = qs + kMaxGroupF32 * kQStride;
  float* ps = red + W * kMaxGroupF32 * kRedStride;
  float* alpha_s = ps + kTileF32 * kMaxGroupF32;

  const int pair = blockIdx.x;
  const int split = blockIdx.y;
  const int gt = pair % n_gt;
  const int64_t bh = pair / n_gt;
  const int64_t h = bh % Kh;
  const int64_t b = bh / Kh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int members = min(gt_size, G - gt * gt_size);

  const int64_t s0 = split * chunk;
  const int64_t s1 = min(s0 + chunk, n_valid);
  const int64_t n_tiles = (s1 - s0 + kTileF32 - 1) / kTileF32;
  const int64_t slot_stride = static_cast<int64_t>(Kh) * DH;
  const float* kb = k + (b * S * Kh + h) * DH;
  const float* vb = v + (b * S * Kh + h) * DH;

  // tile t into ring stage t % kStagesF32: thread tid copies chunk tid % CH
  // of every 4th row (one commit group per tile, empty past the chunk); a
  // row past s1 is zero-filled from a valid address. k's chunks swizzled
  const int cc = tid % CH;
  const int cr = tid / CH;
  auto load_tile = [&](int64_t t) {
    if (t < n_tiles) {
      float* st = ring + (t % kStagesF32) * 2 * kTileFloats;
      const int64_t base = s0 + t * kTileF32;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int r = cr + p * kRowsPerPass;
        const bool ok = base + r < s1;
        const int64_t off = (ok ? base + r : s0) * slot_stride + cc * 4;
        cp_async16(smem_addr(st + r * DH + ((cc ^ (r & 7)) << 2)), kb + off,
                   ok ? 16 : 0);
        cp_async16(smem_addr(st + kTileFloats + r * DH + (cc << 2)),
                   vb + off, ok ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int t = 0; t < kStagesF32 - 1; ++t) load_tile(t);

  // the tile's q rows, rows past its members zero (the first barrier
  // below publishes them)
  const float* qp = q + (bh * G + static_cast<int64_t>(gt) * gt_size) * DH;
  for (int e = tid; e < 4 * MP * CH; e += DH) {
    const int g = e / CH;
    const int c = e % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < members) x = *reinterpret_cast<const float4*>(qp + g * DH + 4 * c);
    *reinterpret_cast<float4*>(qs + g * kQStride + 4 * c) = x;
  }

  const int gg = lane >> 3;  // scores: members gg + 4i; p . v: the same
  const int jj = lane & 7;   // scores: slots jj + 8b; p . v: column chunk
  const int sg = tid / LPM;  // softmax: member row sg, slots sr + LPM s
  const int sr = tid % LPM;
  const int pslot = (sg & 3) * 4 + (sg >> 2);  // p's column of member sg
  const int vc = warp * 8 + jj;                // p . v's column chunk
  float m_run = -INFINITY, l_run = 0.f;        // member sg's online state
  float acc[MP][4];
#pragma unroll
  for (int i = 0; i < MP; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int64_t t = 0; t < n_tiles; ++t) {
    // tile t has landed (this thread's copies; the barrier: everyone's),
    // and every warp is done with the stage the next load refills
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStagesF32 - 2)
                 : "memory");
    __syncthreads();
    load_tile(t + kStagesF32 - 1);
    const float* kt = ring + (t % kStagesF32) * 2 * kTileFloats;
    const float* vt = kt + kTileFloats;
    const int64_t base = s0 + t * kTileF32;

    // scores over this warp's 32 features
    float sc[MP][kSlotsF32];
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < kSlotsF32; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int c = warp * 8 + c8;
      float4 qv[MP], kv[kSlotsF32];
#pragma unroll
      for (int i = 0; i < MP; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (gg + 4 * i) * kQStride +
                                                 4 * c);
#pragma unroll
      for (int j = 0; j < kSlotsF32; ++j)  // row jj + 8j: chunk c at c ^ jj
        kv[j] = *reinterpret_cast<const float4*>(kt + (jj + 8 * j) * DH +
                                                 4 * (c ^ jj));
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int j = 0; j < kSlotsF32; ++j) fma4(sc[i][j], qv[i], kv[j]);
    }
    float* rw = red + warp * kMaxGroupF32 * kRedStride;
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < kSlotsF32; ++j)
        rw[(gg + 4 * i) * kRedStride + jj + 8 * j] = sc[i][j];
    __syncthreads();

    // softmax: every thread runs it (the shuffles take whole warps); rows
    // past 4 MP are never written, and neither are their p
    float x[SPL];
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int j = sr + LPM * s;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w)
        a += red[(w * kMaxGroupF32 + sg) * kRedStride + j];
      a *= scale;
      if (base + j >= s1) a = -INFINITY;
      x[s] = a;
      mx = fmaxf(mx, a);
    }
#pragma unroll
    for (int o = LPM / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    // finite: every tile holds a valid slot (the chunks are whole tiles,
    // none empty); the first tile has m_run = -inf, so alpha = 0
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      x[s] = expf(x[s] - m_new);
      sum += x[s];
    }
    l_run = fmaf(l_run, alpha, sum);
    m_run = m_new;
    if (sg < 4 * MP) {
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        ps[(sr + LPM * s) * kMaxGroupF32 + pslot] = x[s];
      if (sr == 0) alpha_s[pslot] = alpha;
    }
    __syncthreads();

    // p . v: members gg + 4i at columns 4 vc .. 4 vc + 3
    const float4 al = *reinterpret_cast<const float4*>(alpha_s + 4 * gg);
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= comp(al, i);
#pragma unroll
    for (int j = 0; j < kTileF32; ++j) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(ps + j * kMaxGroupF32 + 4 * gg);
      const float4 v4 = *reinterpret_cast<const float4*>(vt + j * DH + 4 * vc);
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        const float p = comp(p4, i);
        acc[i][0] = fmaf(p, v4.x, acc[i][0]);
        acc[i][1] = fmaf(p, v4.y, acc[i][1]);
        acc[i][2] = fmaf(p, v4.z, acc[i][2]);
        acc[i][3] = fmaf(p, v4.w, acc[i][3]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the fold kernel may launch now: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the chunk's state: l summed over the row's LPM lanes, m and l from
  // its first lane, acc from every lane (the warps' columns disjoint)
#pragma unroll
  for (int o = LPM / 2; o > 0; o >>= 1)
    l_run += __shfl_xor_sync(0xffffffffu, l_run, o);
  float* dst = part + (static_cast<int64_t>(pair) * gridDim.y + split) *
                          gt_size * (DH + 2);
  if (sr == 0 && sg < members) {
    dst[sg * (DH + 2)] = m_run;
    dst[sg * (DH + 2) + 1] = l_run;
  }
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    const int g = gg + 4 * i;
    if (g < members) {
      float* d = dst + g * (DH + 2) + 2 + 4 * vc;
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = acc[i][e];
    }
  }
}

template <int DH, int MP>
int launch_partial_f32(const float* q, const float* k, const float* v,
                       float* part, int64_t n_pairs, int64_t S, int64_t Kh,
                       int64_t G, int64_t n_gt, int64_t gt, int64_t n_valid,
                       int64_t n_splits, int64_t chunk, float scale,
                       cudaStream_t stream) {
  constexpr int kSmem = f32_smem_bytes<DH>();
  static_assert(kSmem <= 227 * 1024, "the ring fits a block");
  static bool ready = false;  // the opt-in above 48 KB, once per instance
  if (!ready) {
    if (cudaError_t e = cudaFuncSetAttribute(
            flash_decode_f32_kernel<DH, MP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem))
      return static_cast<int>(e);
    // the whole of the SM's 228 KB as shared memory, for the wrapper's
    // F32_CTAS_PER_SM CTAs
    if (cudaError_t e = cudaFuncSetAttribute(
            flash_decode_f32_kernel<DH, MP>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared))
      return static_cast<int>(e);
    ready = true;
  }
  flash_decode_f32_kernel<DH, MP>
      <<<dim3(static_cast<unsigned>(n_pairs), static_cast<unsigned>(n_splits)),
         DH, kSmem, stream>>>(
          q, k, v, part, S, static_cast<int>(Kh), static_cast<int>(G),
          static_cast<int>(n_gt), static_cast<int>(gt), n_valid, chunk, scale);
  REPRO_CHECK_LAUNCH();
  return 0;
}

// the SM's 228 KB of shared memory hold the wrapper's F32_CTAS_PER_SM
// CTAs (1 / 2 / 4 / 8 at Dh 256 / 128 / 64 / 32), 1 KB each
// reserved beside their own
static_assert(1 * (f32_smem_bytes<256>() + 1024) <= 228 * 1024, "Dh 256");
static_assert(2 * (f32_smem_bytes<128>() + 1024) <= 228 * 1024, "Dh 128");
static_assert(4 * (f32_smem_bytes<64>() + 1024) <= 228 * 1024, "Dh 64");
static_assert(8 * (f32_smem_bytes<32>() + 1024) <= 228 * 1024, "Dh 32");

template <int DH>
int dispatch_f32(const float* q, const float* k, const float* v,
                 float* part, int64_t n_pairs, int64_t S, int64_t Kh,
                 int64_t G, int64_t n_gt, int64_t gt, int64_t n_valid,
                 int64_t n_splits, int64_t chunk, float scale,
                 cudaStream_t stream) {
  switch ((gt + 3) / 4) {
    case 1:
      return launch_partial_f32<DH, 1>(q, k, v, part, n_pairs, S, Kh, G,
                                       n_gt, gt, n_valid, n_splits, chunk,
                                       scale, stream);
    case 2:
      return launch_partial_f32<DH, 2>(q, k, v, part, n_pairs, S, Kh, G,
                                       n_gt, gt, n_valid, n_splits, chunk,
                                       scale, stream);
    case 3:
      return launch_partial_f32<DH, 3>(q, k, v, part, n_pairs, S, Kh, G,
                                       n_gt, gt, n_valid, n_splits, chunk,
                                       scale, stream);
    default:
      return launch_partial_f32<DH, 4>(q, k, v, part, n_pairs, S, Kh, G,
                                       n_gt, gt, n_valid, n_splits, chunk,
                                       scale, stream);
  }
}

// The checks both instances share: the chunks non-empty and covering
// exactly the valid slots, the grid within its limits, the group tile.
int check_plan(int64_t S, int64_t gt, int64_t max_gt, int64_t n_pairs,
               int64_t n_valid, int64_t n_splits, int64_t chunk) {
  if (n_valid < 1 || n_valid > S || n_splits < 1 || chunk < 1 ||
      (n_splits - 1) * chunk >= n_valid || n_splits * chunk < n_valid ||
      n_pairs > 0x7fffffff || n_splits > 65535 || gt < 1 || gt > max_gt)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int launch_flash_decode(const float* q, const float* k, const float* v,
                        float* part, float* out, int64_t B, int64_t S,
                        int64_t Kh, int64_t G, int64_t Dh, int64_t gt,
                        int64_t n_valid, int64_t n_splits, int64_t chunk,
                        float scale, void* stream) {
  if (B == 0 || Kh == 0 || G == 0) return 0;
  const int64_t n_gt = (G + gt - 1) / gt;
  const int64_t n_pairs = B * Kh * n_gt;
  if (int rc = check_plan(S, gt, kMaxGroupF32, n_pairs, n_valid, n_splits,
                          chunk))
    return rc;
  // chunks of whole tiles, as bf16's (the plan's split count is the
  // wrapper's choice; any cut that meets these checks is computed right)
  if (chunk % kTileF32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte q loads and cp.async rows
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (Dh) {
    case 32:
      rc = dispatch_f32<32>(q, k, v, part, n_pairs, S, Kh, G, n_gt, gt,
                            n_valid, n_splits, chunk, scale, st);
      break;
    case 64:
      rc = dispatch_f32<64>(q, k, v, part, n_pairs, S, Kh, G, n_gt, gt,
                            n_valid, n_splits, chunk, scale, st);
      break;
    case 128:
      rc = dispatch_f32<128>(q, k, v, part, n_pairs, S, Kh, G, n_gt, gt,
                             n_valid, n_splits, chunk, scale, st);
      break;
    case 256:
      rc = dispatch_f32<256>(q, k, v, part, n_pairs, S, Kh, G, n_gt, gt,
                             n_valid, n_splits, chunk, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return launch_combine<float>(part, out, n_pairs, G, n_gt, gt, Dh, n_splits,
                               st);
}

int launch_flash_decode(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, float* part, uint16_t* out,
                        int64_t B, int64_t S, int64_t Kh, int64_t G,
                        int64_t Dh, int64_t gt, int64_t n_valid,
                        int64_t n_splits, int64_t chunk, float scale,
                        void* stream) {
  if (B == 0 || Kh == 0 || G == 0) return 0;
  const int64_t n_gt = (G + gt - 1) / gt;
  const int64_t n_pairs = B * Kh * n_gt;
  // chunks of whole tiles: only the last one's last tile is ragged
  if (int rc = check_plan(S, gt, kMaxGroupTile, n_pairs, n_valid, n_splits,
                          chunk))
    return rc;
  if (chunk % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  // 4-byte q fragments, 16-byte cp.async rows
  if (reinterpret_cast<uintptr_t>(q) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (Dh) {
    case 32:
      rc = dispatch_bf16<32>(q, k, v, part, n_pairs, S, Kh, G, n_gt, gt,
                             n_valid, n_splits, chunk, scale, st);
      break;
    case 64:
      rc = dispatch_bf16<64>(q, k, v, part, n_pairs, S, Kh, G, n_gt, gt,
                             n_valid, n_splits, chunk, scale, st);
      break;
    case 128:
      rc = dispatch_bf16<128>(q, k, v, part, n_pairs, S, Kh, G, n_gt, gt,
                              n_valid, n_splits, chunk, scale, st);
      break;
    case 256:
      rc = dispatch_bf16<256>(q, k, v, part, n_pairs, S, Kh, G, n_gt, gt,
                              n_valid, n_splits, chunk, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return launch_combine<uint16_t>(part, out, n_pairs, G, n_gt, gt, Dh,
                                  n_splits, st);
}

}  // namespace

REPRO_API int repro_flash_decode_f32(const float* q, const float* k,
                                     const float* v, float* part, float* out,
                                     int64_t B, int64_t S, int64_t Kh,
                                     int64_t G, int64_t Dh, int64_t gt,
                                     int64_t n_valid, int64_t n_splits,
                                     int64_t chunk, float scale,
                                     void* stream) {
  return launch_flash_decode(q, k, v, part, out, B, S, Kh, G, Dh, gt,
                             n_valid, n_splits, chunk, scale, stream);
}

REPRO_API int repro_flash_decode_bf16(const uint16_t* q, const uint16_t* k,
                                      const uint16_t* v, float* part,
                                      uint16_t* out, int64_t B, int64_t S,
                                      int64_t Kh, int64_t G, int64_t Dh,
                                      int64_t gt, int64_t n_valid,
                                      int64_t n_splits, int64_t chunk,
                                      float scale, void* stream) {
  return launch_flash_decode(q, k, v, part, out, B, S, Kh, G, Dh, gt,
                             n_valid, n_splits, chunk, scale, stream);
}
