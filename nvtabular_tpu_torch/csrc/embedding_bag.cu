// Multihot embedding bag and its transpose for Hopper (sm_90a): kernel K13c.
//
// Replaces nvtabular_tpu/models/layers.py:75-94 (multihot_embedding_lookup,
// the same function as nvtabular_tpu/kernels/ragged.py:73-83
// padded_embedding_bag), which the tabular MLP runs once per multihot
// column (nvtabular_tpu/models/tabular_mlp.py:59-66), and the transpose XLA
// derives for it.
//
// Inputs: a float32 table [V, D], int32 values [B, L] and float32 mask
// [B, L] (1 = a real value) from DeviceLoader's padding. Ids follow
// jnp.take's defaults, as kernel K13a does: a negative id wraps once (id +
// V); an id still outside [0, V) reads a NaN row, and NaN * 0 is NaN, so a
// masked slot holding such an id poisons its row, as in the reference.
//
// nvt_embedding_bag_fwd: out[b] = sum_l table[v[b, l]] * m[b, l], summed in
// l order, divided by max(sum_l m[b, l], 1) for "mean". `out` may be a
// strided view (row stride out_row_stride floats): the tabular MLP passes
// its slot of the MLP's input. One thread owns VEC floats of one row (a
// float4 when D % 4 == 0 and the pointers are 16-byte aligned), so D / 4
// threads share a row. The products and sums are rounded one by one
// (__fmul_rn, __fadd_rn, __fdiv_rn), as the plain version's separate
// PyTorch operations round them: the two agree bit for bit.
//
// nvt_embedding_bag_bwd: dtable[v[b, l]] += (g[b] / cnt[b]) * m[b, l] (g[b]
// * m[b, l] for "sum"), for in-range ids, into a gradient the wrapper has
// zeroed. Every one of the B * L * D terms lands on one of V * D addresses
// — 368 for the genres table of 23 rows and 16 dims, against 4.2M terms a
// step — so global atomics would serialize in L2. When the table fits in
// shared memory (V * D * 4 <= 48 KB), a fixed grid of blocks each sums its
// share of the terms into a shared copy of the table (consecutive threads on
// consecutive dims, so a warp's atomics hit distinct banks) and adds that
// copy to the gradient once: V * D global atomics per block. A larger table
// takes one float4 global atomic per term group, as K13a's scatter does.
// Atomics make the summation order, and so the last bits, vary from run to
// run.
//
// Bound: bytes. Forward: the values and mask (8 B a slot), the distinct
// table rows touched and the output once. Backward: the same inputs, the
// output gradient, and the dense table gradient written once. Both are a few
// MB at the training shapes: launch-scale.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBlocks = 264;  // two blocks of kThreads on each of the H100's 132 SMs
constexpr int64_t kSharedBytes = 48 * 1024;

// The table row of an id after jnp.take's wrap of negatives, or -1.
__device__ __forceinline__ int64_t bag_row(int32_t id, int64_t V) {
  const int64_t row = id < 0 ? static_cast<int64_t>(id) + V : static_cast<int64_t>(id);
  return (row >= 0 && row < V) ? row : -1;
}

// max(sum_l m[l], 1), summed in l order as the forward sums it.
__device__ __forceinline__ float bag_count(const float* __restrict__ m, int L) {
  float cnt = 0.0f;
  for (int l = 0; l < L; ++l) cnt = __fadd_rn(cnt, m[l]);
  return fmaxf(cnt, 1.0f);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bag_fwd_kernel(const float* __restrict__ table, int64_t V, int D, const int32_t* __restrict__ values,
               const float* __restrict__ mask, int B, int L, int mean, float* __restrict__ out,
               int64_t out_row_stride) {
  const int per_row = D / VEC;
  const int t = blockIdx.x * kThreads + threadIdx.x;  // the wrapper keeps B * D < 2^31
  if (t >= B * per_row) return;
  const int b = t / per_row;
  const int q = t - b * per_row;
  const float nan = __int_as_float(0x7fc00000);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  float cnt = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int64_t row = bag_row(values[static_cast<int64_t>(b) * L + l], V);
    const float m = mask[static_cast<int64_t>(b) * L + l];
    float v[VEC];
    if constexpr (VEC == 4) {
      float4 x = make_float4(nan, nan, nan, nan);
      if (row >= 0) x = *reinterpret_cast<const float4*>(table + row * D + q * 4);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      v[0] = row >= 0 ? table[row * D + q] : nan;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], m));
    cnt = __fadd_rn(cnt, m);
  }
  if (mean) {
    cnt = fmaxf(cnt, 1.0f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fdiv_rn(acc[k], cnt);
  }
  float* dst = out + b * out_row_stride + q * VEC;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    *dst = acc[0];
  }
}

// One term (b, l, d) per loop step, d fastest; a grid of kSharedBlocks
// blocks strides over all B * L * D of them.
__global__ void __launch_bounds__(kThreads)
bag_bwd_shared_kernel(const float* __restrict__ grad, int64_t grad_row_stride, const int32_t* __restrict__ values,
                      const float* __restrict__ mask, int B, int L, int D, int64_t V, int mean,
                      float* __restrict__ dtable) {
  extern __shared__ float acc[];  // [V, D]
  const int cells = static_cast<int>(V) * D;
  for (int i = threadIdx.x; i < cells; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  const int total = B * L * D;  // the wrapper keeps it < 2^31
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < total; t += gridDim.x * kThreads) {
    const int bl = t / D;
    const int d = t - bl * D;
    const int64_t row = bag_row(values[bl], V);
    if (row < 0) continue;
    const int b = bl / L;
    float g = grad[b * grad_row_stride + d];
    if (mean) g = __fdiv_rn(g, bag_count(mask + static_cast<int64_t>(b) * L, L));
    atomicAdd(&acc[row * D + d], __fmul_rn(g, mask[bl]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kThreads) atomicAdd(&dtable[i], acc[i]);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bag_bwd_global_kernel(const float* __restrict__ grad, int64_t grad_row_stride, const int32_t* __restrict__ values,
                      const float* __restrict__ mask, int B, int L, int D, int64_t V, int mean,
                      float* __restrict__ dtable) {
  const int per_row = D / VEC;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= B * L * per_row) return;
  const int bl = t / per_row;
  const int q = t - bl * per_row;
  const int64_t row = bag_row(values[bl], V);
  if (row < 0) return;
  const int b = bl / L;
  const float m = mask[bl];
  const float cnt = mean ? bag_count(mask + static_cast<int64_t>(b) * L, L) : 1.0f;
  const float* src = grad + b * grad_row_stride + q * VEC;
  float term[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) term[k] = __fmul_rn(mean ? __fdiv_rn(src[k], cnt) : src[k], m);
  float* dst = dtable + row * D + q * VEC;
  if constexpr (VEC == 4) {
    // one vector reduction (red.global.add.v4.f32, compute capability 9.x)
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(term[0], term[1], term[2], term[3]));
  } else {
    atomicAdd(dst, term[0]);
  }
}

bool bad_shape(int64_t V, int D, int64_t B, int L, int vec) {
  return V < 0 || D <= 0 || B < 0 || L < 0 || (vec != 1 && vec != 4) || D % vec != 0 ||
         B * L * D > INT32_MAX || B * D > INT32_MAX;
}

}  // namespace

extern "C" int nvt_embedding_bag_fwd(const float* table, int64_t V, int D, const int32_t* values,
                                     const float* mask, int64_t B, int L, int mean, float* out,
                                     int64_t out_row_stride, int vec, void* stream) {
  if (bad_shape(V, D, B, L, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = B * (D / vec);
  if (total == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    bag_fwd_kernel<4><<<blocks, kThreads, 0, s>>>(table, V, D, values, mask, static_cast<int>(B), L, mean, out,
                                                  out_row_stride);
  } else {
    bag_fwd_kernel<1><<<blocks, kThreads, 0, s>>>(table, V, D, values, mask, static_cast<int>(B), L, mean, out,
                                                  out_row_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_embedding_bag_bwd(const float* grad, int64_t grad_row_stride, const int32_t* values,
                                     const float* mask, int64_t B, int L, int D, int64_t V, int mean,
                                     float* dtable, int vec, void* stream) {
  if (bad_shape(V, D, B, L, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = B * L * D;
  if (total == 0 || V == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t shared = V * D * static_cast<int64_t>(sizeof(float));
  if (shared <= kSharedBytes) {
    const int64_t needed = (total + kThreads - 1) / kThreads;
    const unsigned int blocks = static_cast<unsigned int>(needed < kSharedBlocks ? needed : kSharedBlocks);
    bag_bwd_shared_kernel<<<blocks, kThreads, static_cast<size_t>(shared), s>>>(
        grad, grad_row_stride, values, mask, static_cast<int>(B), L, D, V, mean, dtable);
  } else {
    const int64_t threads = B * L * (D / vec);
    const unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
    if (vec == 4) {
      bag_bwd_global_kernel<4><<<blocks, kThreads, 0, s>>>(grad, grad_row_stride, values, mask,
                                                          static_cast<int>(B), L, D, V, mean, dtable);
    } else {
      bag_bwd_global_kernel<1><<<blocks, kThreads, 0, s>>>(grad, grad_row_stride, values, mask,
                                                          static_cast<int>(B), L, D, V, mean, dtable);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
