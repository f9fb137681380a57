// gather_spmm (f32): out = A @ [x_in ; table[halo] * mask ; 0] without
// building the bracket (the fused history-gather aggregation of layers
// >= 1).
//
// Replaces the f32 body of src/repro/kernels/fused.py:203 gather_spmm
// (`_make_kernel` :172 over `_pipelined_block` :107): per grid step the
// TPU kernel DMAs the 128 rows of block (r, k) one by one into a VMEM
// slot, double-buffered against the previous block's MXU contraction,
// and routes them through a `gx` scratch. Here the same routing picks the
// staged rows of the shared contraction (block_spmm.cuh, which also
// states the bound): row b of block (r, k) is x_in[xrow] where
// sel == 0, table[trow] where sel == 1, zeros where sel == 2 — the
// gather plan of kernels/fused.py:gather_plan, computed on the device
// before the launch. The `gx` rounding barrier of the reference is the
// identity in f32 and has no counterpart; neither has its DMA
// double-buffering (each CTA stages its rows through shared memory, and
// the other resident CTAs hide the load latency).
#include "block_spmm.cuh"

namespace {

struct PlanRows {
  const float* x_in;
  int64_t n_in;
  const float* table;
  int64_t n_table;
  int64_t d;
  const int32_t* sel;
  const int32_t* xrow;
  const int32_t* trow;
  int64_t K;

  __device__ __forceinline__ const float* row(int64_t r, int64_t k,
                                              int b) const {
    const int64_t p = (r * K + k) * repro::kBn + b;
    const int32_t s = __ldg(sel + p);
    if (s == 0) {
      const int64_t i = __ldg(xrow + p);
      return (i >= 0 && i < n_in) ? x_in + i * d : nullptr;
    }
    if (s == 1) {
      const int64_t i = __ldg(trow + p);
      return (i >= 0 && i < n_table) ? table + i * d : nullptr;
    }
    return nullptr;
  }
};

}  // namespace

REPRO_API int repro_gather_spmm_f32(const float* x_in, int64_t n_in,
                                    const float* table, int64_t n_table,
                                    int64_t d, const float* vals,
                                    const int32_t* sel, const int32_t* xrow,
                                    const int32_t* trow, int64_t R, int64_t K,
                                    float* out, void* stream) {
  const PlanRows src{x_in, n_in, table, n_table, d, sel, xrow, trow, K};
  return repro::launch_block_spmm(vals, R, K, d, out, src, stream);
}
