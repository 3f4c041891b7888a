// Bucketize for Hopper (sm_90a): kernel K12b.
//
// Replaces the device branch of nvtabular_tpu/ops/bucketize.py:35-52:
//   jnp.searchsorted(bounds cast to the column's dtype, x, side="right")
// i.e. out[r] = the number of bounds b with b <= x[r] (bounds ascending), as
// int32. NaN compares below no bound and lands past the last one, where
// jnp.searchsorted and np.digitize put it.
//
// Bound: bytes. Each value is read once and its int32 bucket written once;
// the few bounds (a handful for a real Bucketize) are staged in shared memory
// by each block and searched with <= log2(B) + 1 compares a value. The host
// plans the chunk of bounds a block stages at once (kernels/bucketize.py
// bound_chunk: all of them up to kMaxBounds), which sizes the dynamic shared
// memory. Past one chunk the one launch walks the bounds chunk by chunk: each
// block stages a chunk, every value adds the chunk's count of bounds it is
// not below (the first chunk stores it), then the next chunk. The count over
// all bounds is the sum over the chunks, NaN's included (each chunk counts
// all of its bounds for NaN, which is below none); x is read once a chunk.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBounds = 4096;
constexpr int kMaxBlocks = 4096;  // the grid-stride loop covers the rest

// The count of bounds of s_bounds[0, m) that v is not below.
template <typename T>
__device__ __forceinline__ int bounds_not_above(const T* s_bounds, int m, T v) {
  int lo = 0, hi = m;  // first bound with v < bound
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v < s_bounds[mid]) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucketize_kernel(const T* __restrict__ x, const T* __restrict__ bounds, int nb, int chunk, int64_t n,
                 int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_bounds = reinterpret_cast<T*>(smem);  // chunk bounds
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  if (nb <= chunk) {  // all of them staged at once
    for (int j = threadIdx.x; j < nb; j += kThreads) s_bounds[j] = bounds[j];
    __syncthreads();
    for (int64_t r = r0; r < n; r += stride) out[r] = bounds_not_above(s_bounds, nb, x[r]);
    return;
  }
  for (int c0 = 0; c0 < nb; c0 += chunk) {  // uniform across the block: every thread takes each barrier
    const int m = nb - c0 < chunk ? nb - c0 : chunk;
    if (c0 > 0) __syncthreads();  // every value is done with the chunk before
    for (int j = threadIdx.x; j < m; j += kThreads) s_bounds[j] = bounds[c0 + j];
    __syncthreads();
    for (int64_t r = r0; r < n; r += stride) {
      const int lo = bounds_not_above(s_bounds, m, x[r]);
      out[r] = c0 == 0 ? lo : out[r] + lo;
    }
  }
}

template <typename T>
int launch(const void* x, const void* bounds, int nb, int chunk, int64_t n, int32_t* out, cudaStream_t s) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(chunk) * sizeof(T);  // at most 32 KB
  bucketize_kernel<T><<<static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(bounds), nb, chunk, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 float32, 1 float64, 2 int32, 3 int64 (of x and of bounds alike);
// chunk: the bounds a block stages at once, 1 to kMaxBounds (0 for none).
extern "C" int nvt_bucketize(const void* x, const void* bounds, int nb, int chunk, int64_t n, int kind,
                             int32_t* out, void* stream) {
  if (nb < 0 || n < 0 || chunk < (nb > 0 ? 1 : 0) || chunk > kMaxBounds) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch<float>(x, bounds, nb, chunk, n, out, s);
    case 1: return launch<double>(x, bounds, nb, chunk, n, out, s);
    case 2: return launch<int32_t>(x, bounds, nb, chunk, n, out, s);
    case 3: return launch<int64_t>(x, bounds, nb, chunk, n, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
