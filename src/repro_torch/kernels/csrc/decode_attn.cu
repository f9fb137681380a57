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
// leave most of the 132 SMs idle, so the valid slots are cut into chunks
// of 256 (flash-decoding): one CTA per (b, h, group tile, chunk), eight
// warps, each warp walking runs of U slots, 8 * U apart, with the next
// run's k and v rows loaded while the current one is scored. A lane holds
// DPL = Dh / 32 consecutive features of q, of the k and v rows (one
// coalesced row read per slot) and of the accumulator, for GT group
// members at once, so each k and v row is read once for the whole group;
// a slot's score is a warp sum. Each warp keeps its own online (m, l,
// acc); the CTA folds its warps' states through shared memory into one
// partial state per group member, written to a scratch [pairs, n_splits,
// GT, 2 + Dh] f32, and a second small kernel folds the chunks: M = max_i
// m_i, out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30).
// Only slots below n_valid are read: the grid covers the valid slots
// alone (the wrapper sizes it from pos), so a masked slot, or a chunk past
// pos, contributes nothing and is never loaded, and perturbing the masked
// tail leaves the output bitwise unchanged. Any S is taken (the TPU
// kernel needs S % 256 == 0). Any G >= 1: group tiles of GT in {1, 2, 4,
// 8} members (the wrapper picks the smallest power of two >= min(G, 8));
// members past G compute on zero queries and are not written. Dh in {32,
// 64, 128}.
//
// Bound on the H100: bytes. One step reads each valid k and v row once
// (2 * B * n_valid * Kh * Dh elements) and q, and writes out; the
// operations, 4 * B * Kh * G * n_valid * Dh flops, are G per byte in
// bf16 (G/2 in f32), far below the ~20 f32 flops per byte at which the
// card turns compute-bound.
// The scratch ((2 + Dh) f32 per group member and chunk of 256 slots) is
// this kernel's own cost, ~1% of the cache bytes in bf16.
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// element types: f32 as float, bf16 as its raw 16 bits
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ uint16_t from_f<uint16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// p as v's type holds it (the Pallas kernel's p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// N consecutive elements (one vector load) widened to f32
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(x.v[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// one CTA per (pair = (b, h, group tile), chunk); writes the chunk's
// folded (m, l, acc) per group member of the tile
template <typename T, int DPL, int GT>
__global__ void __launch_bounds__(kThreads)
    flash_decode_partial_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                float* __restrict__ part, int64_t S, int Kh,
                                int G, int n_gt, int64_t n_valid,
                                int64_t chunk, float scale) {
  constexpr int Dh = DPL * 32;
  // slots a warp scores per step: more loads in flight where the
  // registers allow it
  constexpr int U = GT * DPL >= 32 ? 1 : (GT * DPL >= 16 ? 2 : 4);
  const int pair = blockIdx.x;
  const int split = blockIdx.y;
  const int gt = pair % n_gt;
  const int64_t bh = pair / n_gt;
  const int64_t h = bh % Kh;
  const int64_t b = bh / Kh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qr[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const int gg = gt * GT + g;
    if (gg < G) {
      load_row<T, DPL>(q + (bh * G + gg) * Dh + lane * DPL, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) qr[g][i] = 0.f;
    }
  }

  float m[GT], l[GT], acc[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const int64_t s0 = split * chunk;
  const int64_t s1 = min(s0 + chunk, n_valid);
  const int64_t slot_stride = static_cast<int64_t>(Kh) * Dh;
  const T* kb = k + (b * S * Kh + h) * Dh + lane * DPL;
  const T* vb = v + (b * S * Kh + h) * Dh + lane * DPL;

  // each warp walks runs of U slots, kWarps * U apart; the next run's
  // rows are loaded while this one is scored (slots past s1 read as 0)
  using Row = Vec<T, DPL>;
  auto fetch = [&](int64_t at, Row (&kn)[U], Row (&vn)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (at + u < s1) {
        kn[u] = *reinterpret_cast<const Row*>(kb + (at + u) * slot_stride);
        vn[u] = *reinterpret_cast<const Row*>(vb + (at + u) * slot_stride);
      } else {
        kn[u] = Row{};
        vn[u] = Row{};
      }
    }
  };
  constexpr int kStep = kWarps * U;
  Row kc[U], vc[U];
  fetch(s0 + warp * U, kc, vc);
  for (int64_t base = s0 + warp * U; base < s1; base += kStep) {
    Row kn[U], vn[U];
    fetch(base + kStep, kn, vn);
    float kr[U][DPL], vr[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[u][i] = to_f(kc[u].v[i]);
        vr[u][i] = to_f(vc[u].v[i]);
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float sc[U];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) d = fmaf(qr[g][i], kr[u][i], d);
        sc[u] = warp_sum(d) * scale;
        if (base + u < s1) mx = fmaxf(mx, sc[u]);
      }
      // the first step of a warp has m = -inf: alpha = 0 on zero state
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + u < s1) {
          const float p = expf(sc[u] - mx);
          l[g] += p;
          const float pr = round_to<T>(p);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pr, vr[u][i], acc[g][i]);
        }
      }
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
    }
  }

  // fold the warps' states; a warp that drew no slot holds m = -inf,
  // l = 0, acc = 0 and weighs exp(-inf) = 0 (warp 0 always draws one: the
  // wrapper leaves no chunk empty, so M is finite)
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][Dh];
  const int t = threadIdx.x;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_m[warp] = m[g];
      sm_l[warp] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][lane * DPL + i] = acc[g][i];
    __syncthreads();
    if (t < Dh) {
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(sm_m[w] - M);
        L = fmaf(sm_l[w], e, L);
        A = fmaf(sm_acc[w][t], e, A);
      }
      float* dst = part + ((static_cast<int64_t>(pair) * gridDim.y + split) *
                               GT + g) * (Dh + 2);
      if (t == 0) {
        dst[0] = M;
        dst[1] = L;
      }
      dst[2 + t] = A;
    }
    __syncthreads();
  }
}

// one CTA of Dh threads per (pair, group member): folds the chunks
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ part,
                                            T* __restrict__ out, int n_splits,
                                            int G, int n_gt, int gt_size) {
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
  float M = -INFINITY;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, src[i * stride]);
  float L = 0.f, A = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const float e = expf(src[i * stride] - M);
    L = fmaf(src[i * stride + 1], e, L);
    A = fmaf(src[i * stride + 2 + t], e, A);
  }
  out[(bh * G + gg) * Dh + t] = from_f<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int DPL, int GT>
int launch_partial(const T* q, const T* k, const T* v, float* part,
                   int64_t n_pairs, int64_t S, int64_t Kh, int64_t G,
                   int64_t n_gt, int64_t n_valid, int64_t n_splits,
                   int64_t chunk, float scale, cudaStream_t stream) {
  flash_decode_partial_kernel<T, DPL, GT>
      <<<dim3(static_cast<unsigned>(n_pairs), static_cast<unsigned>(n_splits)),
         kThreads, 0, stream>>>(q, k, v, part, S, static_cast<int>(Kh),
                                static_cast<int>(G), static_cast<int>(n_gt),
                                n_valid, chunk, scale);
  REPRO_CHECK_LAUNCH();
  return 0;
}

template <typename T, int DPL>
int dispatch_gt(int64_t gt, const T* q, const T* k, const T* v, float* part,
                int64_t n_pairs, int64_t S, int64_t Kh, int64_t G,
                int64_t n_gt, int64_t n_valid, int64_t n_splits,
                int64_t chunk, float scale, cudaStream_t stream) {
  switch (gt) {
    case 1:
      return launch_partial<T, DPL, 1>(q, k, v, part, n_pairs, S, Kh, G, n_gt,
                                       n_valid, n_splits, chunk, scale,
                                       stream);
    case 2:
      return launch_partial<T, DPL, 2>(q, k, v, part, n_pairs, S, Kh, G, n_gt,
                                       n_valid, n_splits, chunk, scale,
                                       stream);
    case 4:
      return launch_partial<T, DPL, 4>(q, k, v, part, n_pairs, S, Kh, G, n_gt,
                                       n_valid, n_splits, chunk, scale,
                                       stream);
    case 8:
      return launch_partial<T, DPL, 8>(q, k, v, part, n_pairs, S, Kh, G, n_gt,
                                       n_valid, n_splits, chunk, scale,
                                       stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_flash_decode(const T* q, const T* k, const T* v, float* part,
                        T* out, int64_t B, int64_t S, int64_t Kh, int64_t G,
                        int64_t Dh, int64_t gt, int64_t n_valid,
                        int64_t n_splits, int64_t chunk, float scale,
                        void* stream) {
  if (B == 0 || Kh == 0 || G == 0) return 0;
  const int64_t n_gt = (G + gt - 1) / gt;
  const int64_t n_pairs = B * Kh * n_gt;
  // every chunk non-empty and the chunks covering exactly the valid slots
  if (n_valid < 1 || n_valid > S || n_splits < 1 || chunk < 1 ||
      (n_splits - 1) * chunk >= n_valid || n_splits * chunk < n_valid ||
      n_pairs > 0x7fffffff || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = sizeof(T) * (Dh / 32);
  if (reinterpret_cast<uintptr_t>(q) % align != 0 ||
      reinterpret_cast<uintptr_t>(k) % align != 0 ||
      reinterpret_cast<uintptr_t>(v) % align != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (Dh) {
    case 32:
      rc = dispatch_gt<T, 1>(gt, q, k, v, part, n_pairs, S, Kh, G, n_gt,
                             n_valid, n_splits, chunk, scale, st);
      break;
    case 64:
      rc = dispatch_gt<T, 2>(gt, q, k, v, part, n_pairs, S, Kh, G, n_gt,
                             n_valid, n_splits, chunk, scale, st);
      break;
    case 128:
      rc = dispatch_gt<T, 4>(gt, q, k, v, part, n_pairs, S, Kh, G, n_gt,
                             n_valid, n_splits, chunk, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  flash_decode_combine_kernel<T>
      <<<dim3(static_cast<unsigned>(n_pairs), static_cast<unsigned>(gt)),
         static_cast<unsigned>(Dh), 0, st>>>(part, out,
                                             static_cast<int>(n_splits),
                                             static_cast<int>(G),
                                             static_cast<int>(n_gt),
                                             static_cast<int>(gt));
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

REPRO_API int repro_flash_decode_f32(const float* q, const float* k,
                                     const float* v, float* part, float* out,
                                     int64_t B, int64_t S, int64_t Kh,
                                     int64_t G, int64_t Dh, int64_t gt,
                                     int64_t n_valid, int64_t n_splits,
                                     int64_t chunk, float scale,
                                     void* stream) {
  return launch_flash_decode<float>(q, k, v, part, out, B, S, Kh, G, Dh, gt,
                                    n_valid, n_splits, chunk, scale, stream);
}

REPRO_API int repro_flash_decode_bf16(const uint16_t* q, const uint16_t* k,
                                      const uint16_t* v, float* part,
                                      uint16_t* out, int64_t B, int64_t S,
                                      int64_t Kh, int64_t G, int64_t Dh,
                                      int64_t gt, int64_t n_valid,
                                      int64_t n_splits, int64_t chunk,
                                      float scale, void* stream) {
  return launch_flash_decode<uint16_t>(q, k, v, part, out, B, S, Kh, G, Dh,
                                       gt, n_valid, n_splits, chunk, scale,
                                       stream);
}
