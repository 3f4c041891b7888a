// DLRM dot interaction and its gradient for Hopper (sm_90a): kernel K13b.
//
// Replaces nvtabular_tpu/models/layers.py:97-117 (dot_product_interaction):
// the batched [B, F, D] x [B, D, F] dot_general, then the gather of the
// strict lower triangle in np.tril_indices(F, -1) order (flat index
// rows * F + cols, pair k = i * (i - 1) / 2 + j for i > j), and the
// transpose XLA derives for it. DLRM concatenates the bottom output in
// front of the result (nvtabular_tpu/models/dlrm.py:135); the forward
// writes straight into that [B, D + P] buffer through a row stride.
//
// A block stages G samples' [F, D] rows in shared memory.
//
// nvt_interaction_fwd: out[b, k] = sum_d X[b, i, d] * X[b, j, d] for the
// P = F (F - 1) / 2 pairs only (not the F x F product). Rows are padded to
// D + 1 floats, so the lanes of a warp, which read rows j, j + 1, ..., hit
// distinct banks. Consecutive threads take consecutive pairs of a sample
// and write consecutive outputs; the sum runs over d in order with fmaf.
//
// nvt_interaction_bwd: dX[b, i, d] = sum_{j != i} g[b, pair(i, j)] X[b, j, d]
// (pair(i, j) = pair(j, i), both of X's operands being X). The block also
// stages the G samples' P gradient values. One thread accumulates one
// float4 of a row i when D % 4 == 0 (rows padded to D + 4 floats, 16-byte
// aligned), else one float (rows padded to D + 1), over j in order; the g
// values of j < i are the contiguous segment i (i - 1) / 2 + j of the
// sample's gradient. Threads of one sample read the same row j: broadcast.
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

__device__ __forceinline__ void pair_of(int k, int* i, int* j) {
  int r = static_cast<int>((1.0f + sqrtf(1.0f + 8.0f * static_cast<float>(k))) * 0.5f);
  while (r * (r - 1) / 2 > k) --r;
  while ((r + 1) * r / 2 <= k) ++r;
  *i = r;
  *j = k - r * (r - 1) / 2;
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
  const int P = F * (F - 1) / 2;
  for (int e = threadIdx.x; e < ns * P; e += blockDim.x) {
    const int s = e / P;
    const int k = e - s * P;
    int i, j;
    pair_of(k, &i, &j);
    const float* xi = xs + (s * F + i) * stride;
    const float* xj = xs + (s * F + j) * stride;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) acc = fmaf(xi[d], xj[d], acc);
    out[(b0 + s) * out_row_stride + k] = acc;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
interaction_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       int64_t g_row_stride, int64_t B, int F, int D, int G,
                       float* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int stride = bwd_row_stride(D);
  const int P = F * (F - 1) / 2;
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
    const int below = i * (i - 1) / 2;  // g of pairs (i, j < i)
    float* dst = dx + (b0 + s) * F * D + i * D + q * VEC;
    if constexpr (VEC == 4) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < F; ++j) {
        if (j == i) continue;
        const float w = gsamp[j < i ? below + j : j * (j - 1) / 2 + i];
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
        if (j == i) continue;
        acc = fmaf(gsamp[j < i ? below + j : j * (j - 1) / 2 + i], xsamp[j * stride], acc);
      }
      *dst = acc;
    }
  }
}

// Shared memory of one block: G samples' padded rows, and their gradient
// values in the backward. The wrapper picks G so that this fits 48 KB.
int64_t smem_bytes(int F, int D, int G, bool backward) {
  const int64_t per_sample = backward ? F * bwd_row_stride(D) + F * (F - 1) / 2 : F * (D + 1);
  return G * per_sample * 4;
}

bool bad_shape(int64_t B, int F, int D, int G, bool backward) {
  return B < 0 || F < 2 || D <= 0 || G <= 0 || smem_bytes(F, D, G, backward) > kSmemLimit;
}

}  // namespace

extern "C" int nvt_interaction_fwd(const float* x, int64_t B, int F, int D, int G, float* out,
                                   int64_t out_row_stride, void* stream) {
  if (bad_shape(B, F, D, G, false)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((B + G - 1) / G);
  const size_t smem = static_cast<size_t>(smem_bytes(F, D, G, false));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  interaction_fwd_kernel<<<blocks, kThreads, smem, s>>>(x, B, F, D, G, out, out_row_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_interaction_bwd(const float* x, const float* g, int64_t g_row_stride, int64_t B,
                                   int F, int D, int G, float* dx, void* stream) {
  if (bad_shape(B, F, D, G, true)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((B + G - 1) / G);
  const size_t smem = static_cast<size_t>(smem_bytes(F, D, G, true));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0) {
    interaction_bwd_kernel<4><<<blocks, kThreads, smem, s>>>(x, g, g_row_stride, B, F, D, G, dx);
  } else {
    interaction_bwd_kernel<1><<<blocks, kThreads, smem, s>>>(x, g, g_row_stride, B, F, D, G, dx);
  }
  return static_cast<int>(cudaGetLastError());
}
