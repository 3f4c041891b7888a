// The training loss and its gradient for Hopper (sm_90a): kernel K20.
//
// Replaces nvtabular_tpu/models/layers.py:144-150 (bce_with_logits), one
// fused reduction of the jitted train step, and the transpose jax.grad
// derives for it: the mean over the batch of
//
//   max(l, 0) - l * y + log1p(exp(-|l|))
//
// nvt_bce_fwd: each element's term in float32, rounded as the plain
// PyTorch expression rounds it (kernels/bce.py bce_fwd_plain), summed in
// float64 in a fixed order: a thread's elements in order, a fixed tree over
// the block in shared memory, a partial a block, and the last block to
// arrive (an integer ticket, no float atomics) sums the partials in order
// and divides by B. One launch; the same bits from run to run. torch.mean
// sums in float32 in another order and multiplies by 1 / B, so the loss is
// held to a relative tolerance, not to bits.
//
// nvt_bce_bwd: dloss/dl for the output gradient read on the device (no
// host sync), JAX's backward pass term by term and in its order:
//
//   g = gout / B (a division: B need not be a power of two)
//   e = exp(-|l|),  c = g / (e + 1) * e          (log1p's term, then exp's)
//   s = l >= 0 ? -c : 0 + c                      (abs's gradient: +1 at 0)
//   w = l > 0 ? 1 : l == 0 ? 0.5 : 0             (maximum's: a tie splits it)
//   d = (s + (-g) * y) + g * w
//
// each operation rounded on its own (__fdiv_rn, __fmul_rn, __fadd_rn;
// expf as ATen's exp), as kernels/bce.py bce_bwd_plain computes it on the
// card, so that the two agree bit for bit.
//
// Bound: bytes. The forward reads l and y (8 B an element), the backward
// reads them and writes d (12 B); about 20 operations an element, below
// the float32 rate at these byte counts. At DLRM's batch of 65,536 both are
// a few hundred KB: launch latency, not the bound, sets their time.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // kernels/bce.py ITEMS: elements a thread loads before it uses any
constexpr int kMaxBlocks = 264;  // kernels/bce.py MAX_BLOCKS

__device__ __forceinline__ float loss_term(float l, float y) {
  const float m = l != l ? l : (l > 0.0f ? l : 0.0f);  // torch.maximum(l, 0): NaN stays
  return __fadd_rn(__fsub_rn(m, __fmul_rn(l, y)), log1pf(expf(-fabsf(l))));
}

__global__ void __launch_bounds__(kThreads)
bce_fwd_kernel(const float* __restrict__ l, int64_t ls, const float* __restrict__ y, int64_t ys, int64_t B,
               double* __restrict__ partial, int* __restrict__ ticket, float* __restrict__ loss) {
  __shared__ double part[kThreads];
  __shared__ bool last;
  const int t = threadIdx.x;
  double acc = 0.0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kItems;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kItems + t; base < B; base += step) {
    float lv[kItems], yv[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + k * kThreads;
      if (i < B) lv[k] = l[i * ls], yv[k] = y[i * ys];
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (base + k * kThreads < B) acc += static_cast<double>(loss_term(lv[k], yv[k]));
  }
  part[t] = acc;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) part[t] += part[t + h];
    __syncthreads();
  }
  if (t == 0) {
    partial[blockIdx.x] = part[0];
    __threadfence();
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  for (int p = t; p < static_cast<int>(gridDim.x); p += kThreads) s += __ldcg(partial + p);
  part[t] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) part[t] += part[t + h];
    __syncthreads();
  }
  if (t == 0) {
    *loss = static_cast<float>(part[0] / static_cast<double>(B));
    *ticket = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
bce_bwd_kernel(const float* __restrict__ l, int64_t ls, const float* __restrict__ y, int64_t ys,
               const float* __restrict__ gout, int64_t B, float* __restrict__ d) {
  const float g = __fdiv_rn(*gout, static_cast<float>(B));
  const float ng = -g;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < B; i += step) {
    const float li = l[i * ls], yi = y[i * ys];
    const float e = expf(-fabsf(li));
    const float c = __fmul_rn(__fdiv_rn(g, __fadd_rn(e, 1.0f)), e);
    const float s = li >= 0.0f ? -c : __fadd_rn(c, 0.0f);
    const float w = li > 0.0f ? 1.0f : (li == 0.0f ? 0.5f : 0.0f);
    d[i] = __fadd_rn(__fadd_rn(s, __fmul_rn(ng, yi)), __fmul_rn(g, w));
  }
}

}  // namespace

// The mean loss of l [B] and y [B] (float32, element strides ls and ys)
// into loss (one float32): blocks as kernels/bce.py loss_blocks gives them
// (1 to kMaxBlocks), partial [blocks] float64 scratch, ticket one int32
// counter at zero (the kernel leaves it so).
extern "C" int nvt_bce_fwd(const float* l, int64_t ls, const float* y, int64_t ys, int64_t B, double* partial,
                           int* ticket, float* loss, int blocks, void* stream) {
  if (B < 1 || !l || !y || !partial || !ticket || !loss || blocks < 1 || blocks > kMaxBlocks ||
      static_cast<int64_t>(blocks - 1) * kThreads * kItems >= B)
    return static_cast<int>(cudaErrorInvalidValue);
  bce_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(l, ls, y, ys, B, partial, ticket,
                                                                            loss);
  return static_cast<int>(cudaGetLastError());
}

// dloss/dl [B] (contiguous) for the output gradient *gout (one float32 on
// the card).
extern "C" int nvt_bce_bwd(const float* l, int64_t ls, const float* y, int64_t ys, const float* gout, int64_t B,
                           float* d, void* stream) {
  if (B < 1 || !l || !y || !gout || !d) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (B + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  bce_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(l, ls, y, ys, gout, B, d);
  return static_cast<int>(cudaGetLastError());
}
