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
// by each block and searched with <= log2(B) + 1 compares a value.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBounds = 4096;
constexpr int kMaxBlocks = 4096;  // the grid-stride loop covers the rest

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucketize_kernel(const T* __restrict__ x, const T* __restrict__ bounds, int nb, int64_t n,
                 int32_t* __restrict__ out) {
  __shared__ T s_bounds[kMaxBounds];
  for (int j = threadIdx.x; j < nb; j += kThreads) s_bounds[j] = bounds[j];
  __syncthreads();
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < n;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    const T v = x[r];
    int lo = 0, hi = nb;  // first bound with v < bound
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (v < s_bounds[mid]) hi = mid; else lo = mid + 1;
    }
    out[r] = lo;
  }
}

template <typename T>
int launch(const void* x, const void* bounds, int nb, int64_t n, int32_t* out, cudaStream_t s) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  bucketize_kernel<T><<<static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(bounds), nb, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 float32, 1 float64, 2 int32, 3 int64 (of x and of bounds alike)
extern "C" int nvt_bucketize(const void* x, const void* bounds, int nb, int64_t n, int kind,
                             int32_t* out, void* stream) {
  if (nb < 0 || nb > kMaxBounds || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch<float>(x, bounds, nb, n, out, s);
    case 1: return launch<double>(x, bounds, nb, n, out, s);
    case 2: return launch<int32_t>(x, bounds, nb, n, out, s);
    case 3: return launch<int64_t>(x, bounds, nb, n, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
