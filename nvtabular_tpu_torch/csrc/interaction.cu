// DLRM dot interaction and its gradient for Hopper (sm_90a): kernel K13b.
//
// Replaces nvtabular_tpu/models/layers.py:97-117 (dot_product_interaction):
// the batched [B, F, D] x [B, D, F] dot_general, then the gather of the
// strict lower triangle in np.tril_indices(F, -1) order (flat index
// rows * F + cols, pair k = i * (i - 1) / 2 + j for i > j), and the
// transpose XLA derives for it. With self_mode (self_interaction=True) the
// triangle keeps its diagonal, np.tril_indices(F, 0): P = F (F + 1) / 2
// pairs, k = i * (i + 1) / 2 + j for i >= j; the mode is a template
// parameter, so the strict kernels compile as they would without it. DLRM
// concatenates the bottom output in front of the result
// (nvtabular_tpu/models/dlrm.py:135); the forward writes straight into that
// [B, D + P] buffer through a row stride.
//
// A block stages G samples' [F, D] rows in shared memory.
//
// nvt_interaction_fwd: out[b, k] = sum_d X[b, i, d] * X[b, j, d] for the
// P pairs only (not the F x F product). Rows are padded to D + 1 floats, so
// the lanes of a warp, which read rows j, j + 1, ..., hit distinct banks.
// Consecutive threads take consecutive pairs of a sample and write
// consecutive outputs; the sum runs over d in order with fmaf.
//
// nvt_interaction_bwd: dX[b, i, d] = sum_{j != i} g[b, pair(i, j)] X[b, j, d]
// (pair(i, j) = pair(j, i), both of X's operands being X); in self_mode the
// diagonal pair adds 2 g[b, pair(i, i)] X[b, i, d], its product's two
// factors both being X[b, i]. The block also stages the G samples' P
// gradient values. One thread accumulates one float4 of a row i when
// D % 4 == 0 (rows padded to D + 4 floats, 16-byte aligned), else one float
// (rows padded to D + 1), over j in order with fmaf; the g values of j < i
// (j <= i in self_mode) are the contiguous segment row_base(i) + j of the
// sample's gradient. Threads of one sample read the same row j: broadcast.
//
// The plain versions (kernels/interaction.py) compute the same fmaf steps
// in the same order, each exactly (the product and the sum in float64,
// rounded once to float32), so a model step through the kernels and
// through the plain versions sees the same float32 values before its
// bfloat16 casts, where a last-bit difference would become a bfloat16 step.
//
// Bound: bytes. The forward reads X (F * D * 4 B a sample) and writes P * 4
// B; its 2 * P * D flops a sample are ~1/6 of the byte time at the float32
// rate without tensor cores. The backward reads X and g and writes dX.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 48 * 1024;

// Shared-memory row stride of the backward (the forward pads to D + 1).
__host__ __device__ __forceinline__ int bwd_row_stride(int D) { return D % 4 == 0 ? D + 4 : D + 1; }

// The pair index of the triangle's row i: i (i - 1) / 2, or i (i + 1) / 2
// with the diagonal.
__host__ __device__ __forceinline__ int row_base(int i, int self_mode) {
  return self_mode ? i * (i + 1) / 2 : i * (i - 1) / 2;
}

__host__ __device__ __forceinline__ int num_pairs(int F, int self_mode) { return row_base(F, self_mode); }

__device__ __forceinline__ void pair_of(int k, int self_mode, int* i, int* j) {
  int r = static_cast<int>((1.0f + sqrtf(1.0f + 8.0f * static_cast<float>(k))) * 0.5f);
  while (row_base(r, self_mode) > k) --r;
  while (row_base(r + 1, self_mode) <= k) ++r;
  *i = r;
  *j = k - row_base(r, self_mode);
}

// Copies samples [b0, b0 + ns) of X [B, F, D] into xs [ns * F][stride].
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, int64_t b0, int ns, int F,
                                           int D, int stride, float* xs) {
  const int per_sample = F * D;
  const float* src = x + b0 * per_sample;
  for (int e = threadIdx.x; e < ns * per_sample; e += blockDim.x) {
    const int row = e / D;  // sample * F + feature
    xs[row * stride + (e - row * D)] = src[e];
  }
}

template <int SELF>
__global__ void __launch_bounds__(kThreads)
interaction_fwd_kernel(const float* __restrict__ x, int64_t B, int F, int D, int G,
                       float* __restrict__ out, int64_t out_row_stride) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int stride = D + 1;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * G;
  const int ns = static_cast<int>(B - b0 < G ? B - b0 : G);
  stage_rows(x, b0, ns, F, D, stride, xs);
  __syncthreads();
  const int P = num_pairs(F, SELF);
  for (int e = threadIdx.x; e < ns * P; e += blockDim.x) {
    const int s = e / P;
    const int k = e - s * P;
    int i, j;
    pair_of(k, SELF, &i, &j);
    const float* xi = xs + (s * F + i) * stride;
    const float* xj = xs + (s * F + j) * stride;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) acc = fmaf(xi[d], xj[d], acc);
    out[(b0 + s) * out_row_stride + k] = acc;
  }
}

template <int VEC, int SELF>
__global__ void __launch_bounds__(kThreads)
interaction_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       int64_t g_row_stride, int64_t B, int F, int D, int G,
                       float* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int stride = bwd_row_stride(D);
  const int P = num_pairs(F, SELF);
  float* gs = xs + G * F * stride;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * G;
  const int ns = static_cast<int>(B - b0 < G ? B - b0 : G);
  stage_rows(x, b0, ns, F, D, stride, xs);
  for (int e = threadIdx.x; e < ns * P; e += blockDim.x) {
    const int s = e / P;
    gs[e] = g[(b0 + s) * g_row_stride + (e - s * P)];
  }
  __syncthreads();
  const int per_row = D / VEC;
  for (int e = threadIdx.x; e < ns * F * per_row; e += blockDim.x) {
    const int si = e / per_row;  // sample * F + i
    const int q = e - si * per_row;
    const int s = si / F;
    const int i = si - s * F;
    const float* xsamp = xs + s * F * stride + q * VEC;
    const float* gsamp = gs + s * P;
    const int below = row_base(i, SELF);  // g of pairs (i, j < i), and (i, i) in self_mode
    float* dst = dx + (b0 + s) * F * D + i * D + q * VEC;
    if constexpr (VEC == 4) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < F; ++j) {
        if (j == i && !SELF) continue;
        const float w = j == i ? 2.0f * gsamp[below + i] : gsamp[j < i ? below + j : row_base(j, SELF) + i];
        const float4 v = *reinterpret_cast<const float4*>(xsamp + j * stride);
        acc.x = fmaf(w, v.x, acc.x);
        acc.y = fmaf(w, v.y, acc.y);
        acc.z = fmaf(w, v.z, acc.z);
        acc.w = fmaf(w, v.w, acc.w);
      }
      *reinterpret_cast<float4*>(dst) = acc;
    } else {
      float acc = 0.0f;
      for (int j = 0; j < F; ++j) {
        if (j == i && !SELF) continue;
        const float w = j == i ? 2.0f * gsamp[below + i] : gsamp[j < i ? below + j : row_base(j, SELF) + i];
        acc = fmaf(w, xsamp[j * stride], acc);
      }
      *dst = acc;
    }
  }
}

// Shared memory of one block: G samples' padded rows, and their gradient
// values in the backward. The wrapper picks G so that this fits 48 KB.
int64_t smem_bytes(int F, int D, int G, bool backward, int self_mode) {
  const int64_t per_sample = backward ? F * bwd_row_stride(D) + num_pairs(F, self_mode) : F * (D + 1);
  return G * per_sample * 4;
}

bool bad_shape(int64_t B, int F, int D, int G, bool backward, int self_mode) {
  return B < 0 || F < (self_mode ? 1 : 2) || D <= 0 || G <= 0 || (self_mode != 0 && self_mode != 1) ||
         smem_bytes(F, D, G, backward, self_mode) > kSmemLimit;
}

}  // namespace

extern "C" int nvt_interaction_fwd(const float* x, int64_t B, int F, int D, int G, int self_mode, float* out,
                                   int64_t out_row_stride, void* stream) {
  if (bad_shape(B, F, D, G, false, self_mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((B + G - 1) / G);
  const size_t smem = static_cast<size_t>(smem_bytes(F, D, G, false, self_mode));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (self_mode) {
    interaction_fwd_kernel<1><<<blocks, kThreads, smem, s>>>(x, B, F, D, G, out, out_row_stride);
  } else {
    interaction_fwd_kernel<0><<<blocks, kThreads, smem, s>>>(x, B, F, D, G, out, out_row_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_interaction_bwd(const float* x, const float* g, int64_t g_row_stride, int64_t B,
                                   int F, int D, int G, int self_mode, float* dx, void* stream) {
  if (bad_shape(B, F, D, G, true, self_mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((B + G - 1) / G);
  const size_t smem = static_cast<size_t>(smem_bytes(F, D, G, true, self_mode));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && self_mode) {
    interaction_bwd_kernel<4, 1><<<blocks, kThreads, smem, s>>>(x, g, g_row_stride, B, F, D, G, dx);
  } else if (D % 4 == 0) {
    interaction_bwd_kernel<4, 0><<<blocks, kThreads, smem, s>>>(x, g, g_row_stride, B, F, D, G, dx);
  } else if (self_mode) {
    interaction_bwd_kernel<1, 1><<<blocks, kThreads, smem, s>>>(x, g, g_row_stride, B, F, D, G, dx);
  } else {
    interaction_bwd_kernel<1, 0><<<blocks, kThreads, smem, s>>>(x, g, g_row_stride, B, F, D, G, dx);
  }
  return static_cast<int>(cudaGetLastError());
}
