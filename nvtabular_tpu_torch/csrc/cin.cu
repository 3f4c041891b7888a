// The xDeepFM Compressed Interaction Network layer and its gradient for
// Hopper (sm_90a): kernel K13d.
//
// Replaces nvtabular_tpu/models/layers.py:120-141 (xdeepfm_outer_product):
// for x_k float32 [B, Hk, D], x_0 float32 [B, F, D] and w float32
// [Hk * F, Hn],
//
//   out[b, h, d] = sum_{i, j} w[i * F + j, h] * x_k[b, i, d] * x_0[b, j, d],
//
// the outer product z[b, i * F + j, d] = x_k[b, i, d] * x_0[b, j, d] (pair
// index i-major, as the reference's reshape) compressed by w, and the
// transpose XLA derives for it. With the pair index k = i * F + j and the
// column n = b * D + d, the layer is one matrix product
//
//   out[h, n] = sum_k w[k, h] * z[k, n]
//
// of M = Hn rows, depth K = Hk * F and N = B * D columns, whose right
// operand z is never stored: each block builds its tile of z in shared
// memory from x_k and x_0 as it goes (the reference materialises all of z,
// 21.8 GB at [65536, 200 * 26, 16]).
//
// All three kernels are one tiled SIMT product: a block of 256 threads owns
// a 64 x 64 tile of the result, steps through the depth 16 at a time with
// both operands' tiles in shared memory, and each thread keeps a 4 x 4
// register tile (float4 reads of shared memory). Each z value is rounded
// once (__fmul_rn), as the reference's separate product rounds it; the sums
// run in float32 with fmaf, in another order than XLA's.
//
// nvt_cin_fwd: out[b, h, d]. Grid: one block per (column tile, row tile),
// the row tiles of one column tile adjacent, so x_k and x_0 of a column tile
// are read from device memory once and from L2 for the other row tiles.
//
// nvt_cin_bwd, for the output gradient g [B, Hn, D] (two kernels):
//   * cin_bwd_x: dz[k, n] = sum_h w[k, h] * g[h, n] tile by tile over all of
//     K for one 64-column tile, then dx_k[i, n] += dz * x_0[j, n] and
//     dx_0[j, n] += dz * x_k[i, n] into shared-memory sums (shared atomics;
//     a thread first sums its consecutive k of one i in registers), written
//     to dx_k and dx_0 once: every column belongs to one block.
//   * cin_bwd_w: dw[k, h] = sum_n z[k, n] * g[h, n], the reduction over the
//     B * D columns that JAX computes inside this function. Each block sums
//     a 64 x 64 tile of dw over one split of the columns, then adds it to dw
//     (zeroed first) with one global atomic per entry.
// Shared and global atomics make the summation order, and so the last bits,
// vary from run to run.
//
// Bound: operations. The product is 2 * Hn * K * N flops (forward; the
// backward twice that), against float32 outside the tensor cores (67
// TFLOP/s): 283 GFLOP, 4.2 ms, at layer 1 of xDeepFM's Criteo setting
// ([65536, 26, 16] x [65536, 26, 16] -> 200), against 0.4 GB of bytes.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 64;     // rows and columns of a block's tile
constexpr int kDepth = 16;    // depth of one step
constexpr int kThreads = 256; // 16 x 16 threads, a 4 x 4 register tile each
constexpr int kPad = 68;      // shared row stride where a tile is stored transposed (16-byte aligned rows)
constexpr int kTargetBlocks = 132 * 8;

struct Shape {
  int64_t B;
  int Hk, F, D, Hn;
  __host__ __device__ int64_t N() const { return B * D; }
  __host__ __device__ int K() const { return Hk * F; }
};

// acc[r][c] += a[ty * 4 + r] * b[tx * 4 + c] over one step held in shared memory.
template <int SA, int SB>
__device__ __forceinline__ void mma_step(const float* __restrict__ as, const float* __restrict__ bs, int ty, int tx,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(as + kk * SA + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bs + kk * SB + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// z[k, n] for k < K, n < N (else 0), given n's sample b and dimension d.
__device__ __forceinline__ float z_at(const float* __restrict__ xk, const float* __restrict__ x0, const Shape& s,
                                      int k, int64_t b, int d) {
  const int i = k / s.F;
  const int j = k - i * s.F;
  return __fmul_rn(xk[(b * s.Hk + i) * s.D + d], x0[(b * s.F + j) * s.D + d]);
}

__global__ void __launch_bounds__(kThreads)
cin_fwd_kernel(const float* __restrict__ xk, const float* __restrict__ x0, const float* __restrict__ w, Shape s,
               float* __restrict__ out) {
  __shared__ __align__(16) float ws[kDepth * kTile];  // ws[kk][m] = w[k0 + kk, h0 + m]
  __shared__ __align__(16) float zs[kDepth * kTile];  // zs[kk][c] = z[k0 + kk, n0 + c]
  const int h_tiles = (s.Hn + kTile - 1) / kTile;
  const int h0 = static_cast<int>(blockIdx.x % h_tiles) * kTile;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x / h_tiles) * kTile;
  const int64_t N = s.N();
  const int K = s.K();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the column this thread stages (fixed over the depth): 4 rows of it, kk = row0 + 4 * t
  const int col = threadIdx.x % kTile, row0 = threadIdx.x / kTile;
  const int64_t n = n0 + col;
  const int64_t b = n / s.D;
  const int d = static_cast<int>(n - b * s.D);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kDepth) {
#pragma unroll
    for (int t = 0; t < kDepth / 4; ++t) {
      const int kk = row0 + 4 * t;
      const int k = k0 + kk;
      ws[kk * kTile + col] = (k < K && h0 + col < s.Hn) ? w[static_cast<int64_t>(k) * s.Hn + h0 + col] : 0.0f;
      zs[kk * kTile + col] = (k < K && n < N) ? z_at(xk, x0, s, k, b, d) : 0.0f;
    }
    __syncthreads();
    mma_step<kTile, kTile>(ws, zs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int h = h0 + ty * 4 + r;
    if (h >= s.Hn) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t nc = n0 + tx * 4 + c;
      if (nc >= N) continue;
      const int64_t bc = nc / s.D;
      out[(bc * s.Hn + h) * s.D + (nc - bc * s.D)] = acc[r][c];
    }
  }
}

// Shared memory of cin_bwd_x: the two operand tiles, then x_k, x_0, dx_k
// and dx_0 of the block's columns ([Hk or F][kTile] each).
size_t bwd_x_smem(const Shape& s) {
  return (2 * kDepth * kPad + 2 * static_cast<size_t>(s.Hk + s.F) * kTile) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
cin_bwd_x_kernel(const float* __restrict__ xk, const float* __restrict__ x0, const float* __restrict__ w,
                 const float* __restrict__ g, Shape s, float* __restrict__ dxk, float* __restrict__ dx0) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // ws[hh][m] = w[k0 + m, h0 + hh], rows kPad apart
  float* gs = ws + kDepth * kPad;               // gs[hh][c] = g[h0 + hh, n0 + c]
  float* xks = gs + kDepth * kPad;              // [Hk][kTile]
  float* x0s = xks + s.Hk * kTile;              // [F][kTile]
  float* dxks = x0s + s.F * kTile;              // [Hk][kTile]
  float* dx0s = dxks + s.Hk * kTile;            // [F][kTile]
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t N = s.N();
  const int K = s.K();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int col = threadIdx.x % kTile, row0 = threadIdx.x / kTile;
  const int64_t n = n0 + col;
  const int64_t b = n / s.D;
  const int d = static_cast<int>(n - b * s.D);
  for (int i = row0; i < s.Hk; i += kThreads / kTile) {
    xks[i * kTile + col] = n < N ? xk[(b * s.Hk + i) * s.D + d] : 0.0f;
    dxks[i * kTile + col] = 0.0f;
  }
  for (int j = row0; j < s.F; j += kThreads / kTile) {
    x0s[j * kTile + col] = n < N ? x0[(b * s.F + j) * s.D + d] : 0.0f;
    dx0s[j * kTile + col] = 0.0f;
  }
  // the w element this thread stages: row m_w of the tile, depth hh_w (16 threads read one row's 16 h)
  const int hh_w = threadIdx.x % kDepth, m_w = threadIdx.x / kDepth;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    float acc[4][4] = {};
    for (int h0 = 0; h0 < s.Hn; h0 += kDepth) {
#pragma unroll
      for (int t = 0; t < kTile / (kThreads / kDepth); ++t) {
        const int m = m_w + t * (kThreads / kDepth);
        const int k = k0 + m;
        const int h = h0 + hh_w;
        ws[hh_w * kPad + m] = (k < K && h < s.Hn) ? w[static_cast<int64_t>(k) * s.Hn + h] : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < kDepth / 4; ++t) {
        const int hh = row0 + 4 * t;
        const int h = h0 + hh;
        gs[hh * kPad + col] = (h < s.Hn && n < N) ? g[(b * s.Hn + h) * s.D + d] : 0.0f;
      }
      __syncthreads();
      mma_step<kPad, kPad>(ws, gs, ty, tx, acc);
      __syncthreads();
    }
    // acc[r][c] = dz[k0 + ty * 4 + r, n0 + tx * 4 + c]
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cc = tx * 4 + c;
      int run_i = -1;
      float run = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + ty * 4 + r;
        if (k >= K) break;
        const int i = k / s.F;
        const int j = k - i * s.F;
        if (i != run_i) {
          if (run_i >= 0) atomicAdd(&dxks[run_i * kTile + cc], run);
          run_i = i;
          run = 0.0f;
        }
        run = fmaf(acc[r][c], x0s[j * kTile + cc], run);
        atomicAdd(&dx0s[j * kTile + cc], __fmul_rn(acc[r][c], xks[i * kTile + cc]));
      }
      if (run_i >= 0) atomicAdd(&dxks[run_i * kTile + cc], run);
    }
  }
  __syncthreads();
  if (n < N) {
    for (int i = row0; i < s.Hk; i += kThreads / kTile) dxk[(b * s.Hk + i) * s.D + d] = dxks[i * kTile + col];
    for (int j = row0; j < s.F; j += kThreads / kTile) dx0[(b * s.F + j) * s.D + d] = dx0s[j * kTile + col];
  }
}

__global__ void __launch_bounds__(kThreads)
cin_bwd_w_kernel(const float* __restrict__ xk, const float* __restrict__ x0, const float* __restrict__ g, Shape s,
                 int64_t cols_per_split, float* __restrict__ dw) {
  __shared__ __align__(16) float zs[kDepth * kPad];  // zs[nn][m] = z[k0 + m, n0 + nn]
  __shared__ __align__(16) float gs[kDepth * kPad];  // gs[nn][c] = g[h0 + c, n0 + nn]
  const int h_tiles = (s.Hn + kTile - 1) / kTile;
  const int k_tiles = (s.K() + kTile - 1) / kTile;
  const int h0 = static_cast<int>(blockIdx.x % h_tiles) * kTile;
  const int k0 = static_cast<int>((blockIdx.x / h_tiles) % k_tiles) * kTile;
  const int64_t split = blockIdx.x / (static_cast<int64_t>(h_tiles) * k_tiles);
  const int64_t N = s.N();
  const int K = s.K();
  const int64_t lo = split * cols_per_split;
  const int64_t hi = lo + cols_per_split < N ? lo + cols_per_split : N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // this thread stages column nn of rows m0 + 16 t (16 threads read 16 consecutive columns)
  const int nn = threadIdx.x % kDepth, m0 = threadIdx.x / kDepth;
  float acc[4][4] = {};
  for (int64_t c0 = lo; c0 < hi; c0 += kDepth) {
    const int64_t n = c0 + nn;
    const bool live = n < hi;
    const int64_t b = live ? n / s.D : 0;
    const int d = live ? static_cast<int>(n - b * s.D) : 0;
#pragma unroll
    for (int t = 0; t < kTile / (kThreads / kDepth); ++t) {
      const int m = m0 + t * (kThreads / kDepth);
      const int k = k0 + m;
      const int h = h0 + m;
      zs[nn * kPad + m] = (live && k < K) ? z_at(xk, x0, s, k, b, d) : 0.0f;
      gs[nn * kPad + m] = (live && h < s.Hn) ? g[(b * s.Hn + h) * s.D + d] : 0.0f;
    }
    __syncthreads();
    mma_step<kPad, kPad>(zs, gs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + ty * 4 + r;
    if (k >= K) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int h = h0 + tx * 4 + c;
      if (h < s.Hn) atomicAdd(&dw[static_cast<int64_t>(k) * s.Hn + h], acc[r][c]);
    }
  }
}

bool bad_shape(const Shape& s) {
  return s.B < 0 || s.Hk < 1 || s.F < 1 || s.D < 1 || s.Hn < 1 ||
         static_cast<int64_t>(s.Hk) * s.F > INT32_MAX / 2;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// x_k float32 [B, Hk, D], x_0 float32 [B, F, D], w float32 [Hk * F, Hn],
// all contiguous → out float32 [B, Hn, D], contiguous.
extern "C" int nvt_cin_fwd(const float* xk, const float* x0, const float* w, int64_t B, int Hk, int F, int D,
                           int Hn, float* out, void* stream_ptr) {
  const Shape s{B, Hk, F, D, Hn};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int64_t blocks = ceil_div(s.N(), kTile) * ceil_div(Hn, kTile);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cin_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      xk, x0, w, s, out);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory cin_bwd_x needs for Hk and F (the wrapper refuses above
// the card's 227 KB a block).
extern "C" int64_t nvt_cin_bwd_smem(int Hk, int F) {
  const Shape s{0, Hk, F, 1, 1};
  return static_cast<int64_t>(bwd_x_smem(s));
}

// g float32 [B, Hn, D], contiguous → dxk [B, Hk, D], dx0 [B, F, D] (every
// entry written) and dw [Hk * F, Hn] (zeroed here, then summed into).
extern "C" int nvt_cin_bwd(const float* xk, const float* x0, const float* w, const float* g, int64_t B, int Hk,
                           int F, int D, int Hn, float* dxk, float* dx0, float* dw, void* stream_ptr) {
  const Shape s{B, Hk, F, D, Hn};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t dw_bytes = static_cast<size_t>(s.K()) * Hn * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dw, 0, dw_bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t N = s.N();
  if (N == 0) return 0;
  const size_t smem = bwd_x_smem(s);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cin_bwd_x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t col_tiles = ceil_div(N, kTile);
  if (col_tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cin_bwd_x_kernel<<<static_cast<unsigned>(col_tiles), kThreads, smem, stream>>>(xk, x0, w, g, s, dxk, dx0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dw: enough column splits to fill the card, each at least 256 columns
  const int64_t tiles = ceil_div(s.K(), kTile) * ceil_div(Hn, kTile);
  int64_t splits = kTargetBlocks / tiles;
  if (splits < 1) splits = 1;
  if (splits > ceil_div(N, 256)) splits = ceil_div(N, 256);
  const int64_t cols = ceil_div(ceil_div(N, splits), kDepth) * kDepth;
  splits = ceil_div(N, cols);
  cin_bwd_w_kernel<<<static_cast<unsigned>(tiles * splits), kThreads, 0, stream>>>(xk, x0, g, s, cols, dw);
  return static_cast<int>(cudaGetLastError());
}
