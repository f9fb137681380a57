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
// multiply). A RowSrc
// has a `Row` type (a small handle, e.g. a pointer, or a pointer and a
// scale), `row(r, k, b)` returning the handle of staged row b of block
// (r, k), and `load(handle, c)` returning element c of that row as f32
// (zero for a handle that names no row).
//
// One CTA per (row block r, 64-column tile of D). The TPU kernels walk K
// as a sequential grid axis and keep the sum in VMEM; here the loop over
// k runs inside the CTA and the 128x64 output tile stays in registers
// (256 threads, 8 rows x 4 columns each), so the sum over k is taken in
// order and the result is deterministic. For each k the 128x128 block is
// staged in 32-column chunks: the vals chunk (16 KB, stored transposed so
// a thread's 8 rows are contiguous) and the matching 32 staged rows cut
// to the CTA's 64 columns (8 KB). Columns past D and rows past the
// source's end read as zeros, so callers pass ragged D and unpadded row
// counts. Padding blocks (column 0, all-zero values) are multiplied like
// any other, as the reference does.
//
// Bound: bytes. The function needs 2*D f32 operations per nonzero block
// entry and reads the blocks as stored, R*K*64 KB; a refresh batch's
// blocks hold about one nonzero in two thousand stored values, so the
// block bytes bound it. This simple kernel multiplies every stored
// value, zeros included (2*R*K*128*128*D f32 operations on the CUDA
// cores, no tensor cores: the reference contracts in f32), and re-reads
// each block once per 64-column tile, so it runs far above that bound;
// skipping empty blocks and chunks, wgmma on tf32-split operands, TMA
// rings and split-K across CTAs are later work.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kBn = 128;       // adjacency block edge
constexpr int kTd = 64;        // output columns per CTA
constexpr int kBk = 32;        // block columns staged per step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTm = 8;         // output rows per thread
constexpr int kTn = 4;         // output columns per thread

template <class RowSrc>
__global__ void __launch_bounds__(kThreads)
block_spmm_kernel(const float* __restrict__ vals, int64_t K, int64_t d,
                  float* __restrict__ out, const RowSrc src) {
  __shared__ __align__(16) float a_s[kBk][kBn];   // a_s[b][a] = vals[a, b]
  __shared__ __align__(16) float b_s[kBk][kTd];
  __shared__ typename RowSrc::Row rows[kBk];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t r = blockIdx.x;
  const int64_t d0 = static_cast<int64_t>(blockIdx.y) * kTd;

  float acc[kTm][kTn];
#pragma unroll
  for (int i = 0; i < kTm; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j) acc[i][j] = 0.f;

  for (int64_t k = 0; k < K; ++k) {
    const float* blk = vals + (r * K + k) * kBn * kBn;
    for (int b0 = 0; b0 < kBn; b0 += kBk) {
      if (tid < kBk) rows[tid] = src.row(r, k, b0 + tid);
      for (int i = tid; i < kBn * kBk / 4; i += kThreads) {
        const int a = i / (kBk / 4);
        const int c = (i % (kBk / 4)) * 4;
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(blk + a * kBn + b0 + c));
        a_s[c + 0][a] = v.x;
        a_s[c + 1][a] = v.y;
        a_s[c + 2][a] = v.z;
        a_s[c + 3][a] = v.w;
      }
      __syncthreads();  // rows[] and a_s are complete
      for (int i = tid; i < kBk * kTd; i += kThreads) {
        const int b = i / kTd;
        const int c = i % kTd;
        b_s[b][c] = d0 + c < d ? src.load(rows[b], d0 + c) : 0.f;
      }
      __syncthreads();  // b_s is complete
#pragma unroll
      for (int b = 0; b < kBk; ++b) {
        float af[kTm];
        float bf[kTn];
#pragma unroll
        for (int i = 0; i < kTm; ++i) af[i] = a_s[b][ty * kTm + i];
#pragma unroll
        for (int j = 0; j < kTn; ++j) bf[j] = b_s[b][tx * kTn + j];
#pragma unroll
        for (int i = 0; i < kTm; ++i)
#pragma unroll
          for (int j = 0; j < kTn; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
      }
      __syncthreads();  // the next chunk may overwrite rows[], a_s, b_s
    }
  }

#pragma unroll
  for (int i = 0; i < kTm; ++i) {
    const int64_t row = r * kBn + ty * kTm + i;
#pragma unroll
    for (int j = 0; j < kTn; ++j) {
      const int64_t col = d0 + tx * kTn + j;
      if (col < d) out[row * d + col] = acc[i][j];
    }
  }
}

template <class RowSrc>
int launch_block_spmm(const float* vals, int64_t R, int64_t K, int64_t d,
                      float* out, const RowSrc& src, void* stream) {
  if (R == 0 || d == 0) return 0;
  const dim3 grid(static_cast<unsigned>(R),
                  static_cast<unsigned>((d + kTd - 1) / kTd));
  block_spmm_kernel<RowSrc><<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      vals, K, d, out, src);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace repro
