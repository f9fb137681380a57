// bcsr_spmm: out[r*128 : (r+1)*128] = sum_k vals[r, k] @ x[cols[r, k]*128 : +128]
// (the layer-0 GAS aggregation over the batch's BCSR blocks).
//
// Replaces src/repro/kernels/bcsr_spmm.py:42 bcsr_spmm (Pallas, grid
// (R, D/128, K) with K innermost accumulating into the VMEM output tile,
// one 128x128 @ 128x128 MXU matmul per step). The contraction (a warp
// per output row streaming its block rows once and multiplying only the
// nonzeros), its bound and its one departure from the reference (a
// non-finite x row reached only by zero entries does not spread) are
// described in block_spmm.cuh; this file supplies the staged rows: row b
// of column block k is x[cols[r, k]*128 + b], or zeros past x's n_x rows
// (the reference pads x to whole blocks; the port does not).
#include "block_spmm.cuh"

namespace {

struct BlockRows {
  const float* x;
  int64_t n_x;
  int64_t d;
  const int32_t* cols;
  int64_t K;

  using Row = const float*;

  __device__ __forceinline__ Row row(int64_t r, int64_t k, int b) const {
    const int64_t i = static_cast<int64_t>(__ldg(cols + r * K + k)) *
                          repro::kBn + b;
    return (i >= 0 && i < n_x) ? x + i * d : nullptr;
  }

  __device__ __forceinline__ float load(Row p, int64_t c) const {
    return p != nullptr ? __ldg(p + c) : 0.f;
  }
};

}  // namespace

REPRO_API int repro_bcsr_spmm_f32(const float* x, int64_t n_x, int64_t d,
                                  const float* vals, const int32_t* cols,
                                  int64_t R, int64_t K, float* out,
                                  void* stream) {
  const BlockRows src{x, n_x, d, cols, K};
  return repro::launch_block_spmm(vals, R, K, d, out, src, stream);
}
