// gather_spmm: out = A @ [x_in ; dequant(table)[halo] * mask ; 0] without
// building the bracket (the fused history-gather aggregation of layers
// >= 1), over an f32, a bf16, an int8 or a vq history table.
//
// Replaces src/repro/kernels/fused.py:203 gather_spmm: its f32 body
// (`_make_kernel` :172, which also runs the reference's bf16 tables), its
// int8 body (`_make_kernel_dq` :181) and its vq body (`_make_kernel_vq`
// :191, the vq branch of `_pipelined_block` :149-160: whole code rows
// staged, decoded by one one-hot matmul per subvector against the
// VMEM-resident codebook, then times the row's scale), all over
// `_pipelined_block` :107: per grid step the TPU kernel DMAs the 128 rows
// of block (r, k)
// one by one into a VMEM slot, double-buffered against the previous
// block's MXU contraction, dequantizes the staged table rows (int8 times
// the pre-gathered per-plan-row scale `rscl = scales[trow]`, bf16 upcast)
// and routes them through a `gx` scratch. Here the same routing picks the
// staged rows of the shared contraction (block_spmm.cuh, which also
// states the bound): row b of block (r, k) is x_in[xrow] where sel == 0,
// the table row trow where sel == 1, zeros where sel == 2 — the gather
// plan of kernels/fused.py:gather_plan, computed on the device before the
// launch. A table row becomes f32 as it is staged: bf16 exactly
// (__bfloat162float), int8 as float(q) * scales[trow] with one IEEE
// multiply (__fmul_rn, never contracted into the FMAs that follow), so
// the staged operand is bitwise the plain version's. The vq body decodes
// element c of a staged code row as codebook[c / 8, code[c / 8], c % 8]
// times the row's scale, the same one multiply, so the staged operand is
// bitwise `vq_decode_rows`. Its codebook ([S, 256, 8] f32, 256 KB at
// d = 256, more than a CTA's 227 KB of shared memory) is not staged: the
// element is read through L2 (and L1), where the whole codebook stays
// resident, so the launch needs no dynamic shared memory at any width.
// The int8 body reads
// scales[trow] once per staged row where the row handle is made, instead
// of pre-gathering the reference's [R, K, 128] rscl operand: the same
// value, without a second plan-sized array in device memory. The `gx`
// rounding barrier of the reference is the identity in f32 and has no
// counterpart; neither has its DMA double-buffering: the shared core
// streams the block rows with the next few in flight, queues their
// nonzero entries and stages a row only for a queued entry, making its
// handle once for the whole warp (sel, xrow and trow are read together,
// the scale after them) and loading two entries' rows at a time. As
// bcsr_spmm, it skips zero entries, so a non-finite row that only zero
// entries reach does not spread (block_spmm.cuh).
#include <cuda_bf16.h>

#include <type_traits>

#include "block_spmm.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

constexpr int kVqCodes = 256;  // codebook entries per subvector
constexpr int kVqSub = 8;      // subvector width

// T: the table's element type (float, bf16 bits as uint16_t, int8_t, or
// uint8_t vq codes, one per 8-wide subvector); kScaled: a per-row f32
// scale table (int8 and vq).
template <typename T, bool kScaled>
struct PlanRows {
  const float* x_in;
  int64_t n_in;
  const T* table;
  const float* scales;
  const float* codebook;  // vq: [d / 8, 256, 8]
  int64_t n_table;
  int64_t d;
  const int32_t* sel;
  const int32_t* xrow;
  const int32_t* trow;
  int64_t K;

  // An f32 table's rows read as in-batch rows do, so the f32 body stages
  // through a plain pointer (null: zeros). The other bodies' handle names
  // an in-batch row, or a table row with its scale, or neither.
  static constexpr bool kPlain = std::is_same_v<T, float> && !kScaled;
  static constexpr bool kVq = std::is_same_v<T, uint8_t>;
  struct Mixed {
    const float* x;
    const T* t;
    float s;
  };
  using Row = std::conditional_t<kPlain, const float*, Mixed>;

  __device__ __forceinline__ Row row(int64_t r, int64_t k, int b) const {
    const int64_t p = (r * K + k) * repro::kBn + b;
    const int32_t s = __ldg(sel + p);
    const int64_t xi = __ldg(xrow + p);
    const int64_t ti = __ldg(trow + p);
    if (s == 0) {
      if (xi >= 0 && xi < n_in) {
        if constexpr (kPlain) return x_in + xi * d;
        else return {x_in + xi * d, nullptr, 1.f};
      }
    } else if (s == 1) {
      if (ti >= 0 && ti < n_table) {
        const int64_t width = kVq ? d / kVqSub : d;
        if constexpr (kPlain) return table + ti * width;
        else return {nullptr, table + ti * width,
                     kScaled ? __ldg(scales + ti) : 1.f};
      }
    }
    if constexpr (kPlain) return nullptr;
    else return {nullptr, nullptr, 1.f};
  }

  __device__ __forceinline__ float load(const Row& h, int64_t c) const {
    if constexpr (kPlain) {
      return h != nullptr ? __ldg(h + c) : 0.f;
    } else {
      if (h.x != nullptr) return __ldg(h.x + c);
      if (h.t == nullptr) return 0.f;
      if constexpr (kVq) {
        const int64_t sub = c / kVqSub;
        const int code = __ldg(h.t + sub);
        return __fmul_rn(
            __ldg(codebook + (sub * kVqCodes + code) * kVqSub + c % kVqSub),
            h.s);
      } else {
        const float v = to_f32(__ldg(h.t + c));
        return kScaled ? __fmul_rn(v, h.s) : v;
      }
    }
  }
};

template <typename T, bool kScaled>
int launch(const float* x_in, int64_t n_in, const T* table,
           const float* scales, const float* codebook, int64_t n_table,
           int64_t d, const float* vals, const int32_t* sel,
           const int32_t* xrow, const int32_t* trow, int64_t R, int64_t K,
           float* out, void* stream) {
  const PlanRows<T, kScaled> src{x_in, n_in,  table, scales, codebook,
                                 n_table, d, sel, xrow, trow, K};
  return repro::launch_block_spmm(vals, R, K, d, out, src, stream);
}

}  // namespace

REPRO_API int repro_gather_spmm_f32(const float* x_in, int64_t n_in,
                                    const float* table, int64_t n_table,
                                    int64_t d, const float* vals,
                                    const int32_t* sel, const int32_t* xrow,
                                    const int32_t* trow, int64_t R, int64_t K,
                                    float* out, void* stream) {
  return launch<float, false>(x_in, n_in, table, nullptr, nullptr, n_table,
                              d, vals, sel, xrow, trow, R, K, out, stream);
}

REPRO_API int repro_gather_spmm_bf16(const float* x_in, int64_t n_in,
                                     const uint16_t* table, int64_t n_table,
                                     int64_t d, const float* vals,
                                     const int32_t* sel, const int32_t* xrow,
                                     const int32_t* trow, int64_t R,
                                     int64_t K, float* out, void* stream) {
  return launch<uint16_t, false>(x_in, n_in, table, nullptr, nullptr,
                                 n_table, d, vals, sel, xrow, trow, R, K, out,
                                 stream);
}

REPRO_API int repro_gather_spmm_dq(const float* x_in, int64_t n_in,
                                   const int8_t* table, const float* scales,
                                   int64_t n_table, int64_t d,
                                   const float* vals, const int32_t* sel,
                                   const int32_t* xrow, const int32_t* trow,
                                   int64_t R, int64_t K, float* out,
                                   void* stream) {
  return launch<int8_t, true>(x_in, n_in, table, scales, nullptr, n_table,
                              d, vals, sel, xrow, trow, R, K, out, stream);
}

// table [n_table, d / 8] uint8 codes, codebook [d / 8, 256, 8] f32
REPRO_API int repro_gather_spmm_vq(const float* x_in, int64_t n_in,
                                   const uint8_t* table, const float* scales,
                                   const float* codebook, int64_t n_table,
                                   int64_t d, const float* vals,
                                   const int32_t* sel, const int32_t* xrow,
                                   const int32_t* trow, int64_t R, int64_t K,
                                   float* out, void* stream) {
  if (d % kVqSub != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<uint8_t, true>(x_in, n_in, table, scales, codebook, n_table,
                               d, vals, sel, xrow, trow, R, K, out, stream);
}
