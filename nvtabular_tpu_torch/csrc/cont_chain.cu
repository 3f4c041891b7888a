// Fused continuous chain for Hopper (sm_90a): kernel K5.
//
// Replaces the XLA-fused chain of the JAX package's continuous ops:
//   FillMissing / FillMedian  nvtabular_tpu/ops/fill.py:22-35 (_fill_column),
//                :121-130 (the fitted median), and the `_filled` indicator
//                columns (:54, :129)
//   Clip         nvtabular_tpu/ops/clip.py:27 (jnp.clip(x, lo, hi))
//   LogOp        nvtabular_tpu/ops/logop.py:22 (log1p in float32)
//   Normalize    nvtabular_tpu/ops/normalize.py:59-73 ((x - mean) / std,
//                or x - mean when std == 0: div is 1 then)
//   NormalizeMinMax  normalize.py:132-150 ((x - min) / span; zeros when
//                span == 0, NaN included: the ZERO flag)
//   out_dtype    normalize.py:61,67 and :134,140: a float16 or bfloat16 store
// over the stacked float32 columns x [C, N] (row-major), with per-column
// parameters params [C, 5] = (fill, lo, hi, sub, div) and flags [C]
// selecting the stages present. One pass, one read and one write per element.
//
// Store kinds (one a launch): 0 float32; 1 float16; 2 bfloat16. In a 16-bit
// store the normalize stage follows the reference's casts: x is rounded to
// the 16-bit type first (its constants were rounded on the host), and the
// subtraction and the division each round to it again, as numpy does for
// 16-bit arrays. Each is computed in float32 and then rounded, which gives
// the correctly rounded 16-bit result (float32 has more than 2p + 2 bits).
//
// `mask`, when not null, receives is_null of the input (validity 0 or NaN)
// as one byte per element: the `_filled` columns of a fill that ends its
// branch.
//
// Bound: bytes (4 B read and 4 or 2 B written per element, plus 1 B of
// validity and 1 B of mask where given); the arithmetic is a few flops and
// one log1pf. One thread per element keeps every warp's loads and stores
// coalesced.
//
// Semantics held to the reference:
//   fill where validity is 0 or the value is NaN (is_null);
//   clip keeps NaN (jnp.clip propagates it), hence compares, not fmaxf;
//   IEEE division (__fdiv_rn); the file must not be built with fast math.
// The output carries no validity: the fills drop the mask.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFill = 1, kLo = 2, kHi = 4, kLog = 8, kNorm = 16, kZero = 32;

template <int kKind>
__device__ __forceinline__ float round_store(float v) {
  if constexpr (kKind == 1) return __half2float(__float2half_rn(v));
  if constexpr (kKind == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <int kKind, typename OutT>
__device__ __forceinline__ OutT to_out(float v) {
  if constexpr (kKind == 1) {
    return __float2half_rn(v);
  } else if constexpr (kKind == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

template <int kKind, typename OutT>
__global__ void __launch_bounds__(kThreads)
cont_chain_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
                  const float* __restrict__ params, const int32_t* __restrict__ flags,
                  OutT* __restrict__ out, uint8_t* __restrict__ mask, int64_t n) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int c = blockIdx.y;
  const int64_t i = static_cast<int64_t>(c) * n + r;
  const int f = flags[c];
  const float* p = params + 5 * c;
  float v = x[i];
  const bool null = isnan(v) || (valid != nullptr && valid[i] == 0);
  if (mask != nullptr) mask[i] = null ? 1 : 0;
  if ((f & kFill) && null) v = p[0];
  if ((f & kLo) && v < p[1]) v = p[1];
  if ((f & kHi) && v > p[2]) v = p[2];
  if (f & kLog) v = log1pf(v);
  if (f & kNorm) {
    v = round_store<kKind>(v);
    v = round_store<kKind>(__fsub_rn(v, p[3]));
    v = __fdiv_rn(v, p[4]);
  }
  if (f & kZero) v = 0.0f;
  out[i] = to_out<kKind, OutT>(v);
}

template <int kKind, typename OutT>
int launch(const float* x, const uint8_t* valid, const float* params, const int32_t* flags, void* out,
           uint8_t* mask, int num_cols, int64_t n, void* stream) {
  dim3 grid(static_cast<unsigned int>((n + kThreads - 1) / kThreads), num_cols);
  cont_chain_kernel<kKind, OutT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, valid, params, flags, static_cast<OutT*>(out), mask, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_kind: 0 float32, 1 float16, 2 bfloat16; mask may be null. Returns a
// cudaError_t.
extern "C" int nvt_cont_chain(const float* x, const uint8_t* valid, const float* params,
                              const int32_t* flags, void* out, uint8_t* mask, int num_cols, int64_t n,
                              int out_kind, void* stream) {
  if (num_cols == 0 || n == 0) return 0;
  switch (out_kind) {
    case 0: return launch<0, float>(x, valid, params, flags, out, mask, num_cols, n, stream);
    case 1: return launch<1, __half>(x, valid, params, flags, out, mask, num_cols, n, stream);
    case 2: return launch<2, __nv_bfloat16>(x, valid, params, flags, out, mask, num_cols, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
