// Fused continuous chain for Hopper (sm_90a): kernel K5.
//
// Replaces the XLA-fused chain of the JAX package's continuous ops:
//   FillMissing  nvtabular_tpu/ops/fill.py:22-35 (_fill_column)
//   Clip         nvtabular_tpu/ops/clip.py:27 (jnp.clip(x, lo, hi))
//   LogOp        nvtabular_tpu/ops/logop.py:22 (log1p in float32)
//   Normalize    nvtabular_tpu/ops/normalize.py:67-73 ((x - mean) / std,
//                or x - mean when std == 0: div is 1 then)
// over the stacked float32 columns x [C, N] (row-major), with per-column
// parameters params [C, 5] = (fill, lo, hi, sub, div) and flags [C]
// selecting the stages present. One pass, one read and one write per element.
//
// Bound: bytes (4 B read + 4 B written per element, plus 1 B of validity
// when a mask is given); the arithmetic is a few flops and one log1pf. One
// thread per element keeps every warp's loads and stores coalesced.
//
// Semantics held to the reference:
//   fill where validity is 0 or the value is NaN (is_null);
//   clip keeps NaN (jnp.clip propagates it), hence compares, not fmaxf;
//   IEEE division (__fdiv_rn); the file must not be built with fast math.
// The output carries no validity: FillMissing drops the mask.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFill = 1, kLo = 2, kHi = 4, kLog = 8, kNorm = 16;

__global__ void __launch_bounds__(kThreads)
cont_chain_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
                  const float* __restrict__ params, const int32_t* __restrict__ flags,
                  float* __restrict__ out, int64_t n) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int c = blockIdx.y;
  const int64_t i = static_cast<int64_t>(c) * n + r;
  const int f = flags[c];
  const float* p = params + 5 * c;
  float v = x[i];
  if ((f & kFill) && (isnan(v) || (valid != nullptr && valid[i] == 0))) v = p[0];
  if ((f & kLo) && v < p[1]) v = p[1];
  if ((f & kHi) && v > p[2]) v = p[2];
  if (f & kLog) v = log1pf(v);
  if (f & kNorm) v = __fdiv_rn(__fsub_rn(v, p[3]), p[4]);
  out[i] = v;
}

}  // namespace

extern "C" int nvt_cont_chain(const float* x, const uint8_t* valid, const float* params,
                              const int32_t* flags, float* out, int num_cols, int64_t n,
                              void* stream) {
  if (num_cols == 0 || n == 0) return 0;
  dim3 grid(static_cast<unsigned int>((n + kThreads - 1) / kThreads), num_cols);
  cont_chain_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, valid, params, flags, out, n);
  return static_cast<int>(cudaGetLastError());
}
