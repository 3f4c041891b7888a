// The DCN-v2 cross layer's epilogue and its gradient for Hopper (sm_90a):
// kernel K17.
//
// Replaces nvtabular_tpu/models/deepfm.py:126-134 (dcn_forward's cross
// loop) after its product: x_{l+1} = x0 * (xw + b) + x_l over [B, N]
// float32, where xw = bf16(x_l) . bf16(W) accumulated in float32 comes from
// a plain matrix product (torch.matmul, as the JAX package leaves it to
// XLA), and the transpose XLA derives for it.
//
// nvt_cross_fwd: out = (x0 * (xw + b)) + x, each operation rounded on its
// own (__fadd_rn / __fmul_rn: no fused multiply-add), as the JAX expression
// and the plain PyTorch version round, so the three agree bit for bit.
//
// nvt_cross_bwd, given g = d x_{l+1}: dxw = g * x0, dx0 = g * (xw + b)
// (xw + b recomputed as the forward rounded it), db = sum over rows of g *
// x0; the direct gradient d x_l = g needs no kernel. db is a column
// reduction over B rows: each thread keeps its column's partial sum over
// the rows it visits in a register, a block adds its 8 warps' partials in
// shared memory, and one atomic per block and column adds that into db
// (which the wrapper zeroed): B / 256 atomics a column, not one a row. The
// atomics' order, and so db's last bits, vary from run to run.
//
// Layout: a block is 32 columns (a warp's lanes, consecutive addresses of
// a row) by 8 warps, each warp walking the rows of the block's row ranges
// of 256 rows with stride 8. Row range y takes block y, y + gridDim.y, ..,
// so that a batch of more than 65,535 ranges (gridDim.y's limit; 16,776,960
// rows) takes the ranges past it in the same launch; the host plans
// gridDim.y (kernels/cross.py row_blocks). Every input may be a strided view
// (row stride given, each row contiguous: DCN's last layer receives g as a
// slice of the gradient of its [B, N + H] concatenation); outputs are
// contiguous [B, N].
//
// Bound: bytes. The forward reads xw, x0 and x and writes out (4 B N
// floats); the backward reads g, xw and x0 and writes dxw and dx0 (5 B N
// floats). Both do 2-3 flops a float read, far below the float32 rate.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kCols = 32;
constexpr int kRowWarps = 8;
constexpr int64_t kRowsPerBlock = 256;

struct Strided {
  const float* p;
  int64_t row_stride;
  __device__ __forceinline__ float at(int64_t r, int c) const { return p[r * row_stride + c]; }
};

// Rows [r0, r0 + kRowsPerBlock) of column c: out = x0 * (xw + b) + x.
__device__ __forceinline__ void cross_fwd_rows(const Strided& xw, float bc, const Strided& x0, const Strided& x,
                                               int64_t r0, int64_t B, int N, int c, float* __restrict__ out) {
  const int64_t r1 = r0 + kRowsPerBlock < B ? r0 + kRowsPerBlock : B;
  for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowWarps) {
    const float t = __fadd_rn(xw.at(r, c), bc);
    out[r * N + c] = __fadd_rn(__fmul_rn(x0.at(r, c), t), x.at(r, c));
  }
}

__global__ void __launch_bounds__(kCols * kRowWarps)
cross_fwd_kernel(Strided xw, const float* __restrict__ bias, Strided x0, Strided x, int64_t B, int N,
                 float* __restrict__ out) {
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= N) return;  // no barrier below
  const float bc = bias[c];
  const int64_t step = static_cast<int64_t>(gridDim.y) * kRowsPerBlock;
  cross_fwd_rows(xw, bc, x0, x, static_cast<int64_t>(blockIdx.y) * kRowsPerBlock, B, N, c, out);
  for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRowsPerBlock + step; r0 < B; r0 += step)
    cross_fwd_rows(xw, bc, x0, x, r0, B, N, c, out);  // the ranges past gridDim.y's
}

// kPastGridY: the batch has more row ranges than gridDim.y's blocks, which
// walk every gridDim.y-th range; without it (every batch up to 16,776,960
// rows) a block takes its one range as the kernel always has.
template <bool kPastGridY>
__global__ void __launch_bounds__(kCols * kRowWarps)
cross_bwd_kernel(Strided g, Strided xw, const float* __restrict__ bias, Strided x0, int64_t B, int N,
                 float* __restrict__ dxw, float* __restrict__ dx0, float* __restrict__ dbias) {
  __shared__ float part[kRowWarps][kCols];
  const int c = blockIdx.x * kCols + threadIdx.x;
  float acc = 0.0f;
  if (c < N) {
    const float bc = bias[c];
    const int64_t step = static_cast<int64_t>(gridDim.y) * kRowsPerBlock;
    for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRowsPerBlock; r0 < B; r0 += step) {
      const int64_t r1 = r0 + kRowsPerBlock < B ? r0 + kRowsPerBlock : B;
      for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowWarps) {
        const float gr = g.at(r, c);
        const float d = __fmul_rn(gr, x0.at(r, c));
        dxw[r * N + c] = d;
        dx0[r * N + c] = __fmul_rn(gr, __fadd_rn(xw.at(r, c), bc));
        acc += d;
      }
      if constexpr (!kPastGridY) break;
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < N) {
    float s = 0.0f;
    for (int k = 0; k < kRowWarps; ++k) s += part[k][threadIdx.x];
    atomicAdd(dbias + c, s);
  }
}

constexpr int64_t kMaxRowBlocks = 65535;  // gridDim.y's limit: the row ranges past it loop

// row_blocks: gridDim.y, 1 to kMaxRowBlocks; any such value covers every
// range.
bool bad_shape(int64_t B, int N, int64_t row_blocks) {
  return B < 0 || N <= 0 || row_blocks < 1 || row_blocks > kMaxRowBlocks;
}

dim3 grid_for(int N, int64_t row_blocks) {
  return dim3(static_cast<unsigned int>((N + kCols - 1) / kCols), static_cast<unsigned int>(row_blocks));
}

}  // namespace

extern "C" int nvt_cross_fwd(const float* xw, int64_t xw_row_stride, const float* bias,
                             const float* x0, int64_t x0_row_stride, const float* x,
                             int64_t x_row_stride, int64_t B, int N, int64_t row_blocks, float* out,
                             void* stream) {
  if (bad_shape(B, N, row_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cross_fwd_kernel<<<grid_for(N, row_blocks), dim3(kCols, kRowWarps), 0, s>>>(
      Strided{xw, xw_row_stride}, bias, Strided{x0, x0_row_stride}, Strided{x, x_row_stride}, B, N, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_cross_bwd(const float* g, int64_t g_row_stride, const float* xw,
                             int64_t xw_row_stride, const float* bias, const float* x0,
                             int64_t x0_row_stride, int64_t B, int N, int64_t row_blocks, float* dxw,
                             float* dx0, float* dbias, void* stream) {
  if (bad_shape(B, N, row_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(N, row_blocks);
  if ((B + kRowsPerBlock - 1) / kRowsPerBlock > row_blocks)
    cross_bwd_kernel<true><<<grid, dim3(kCols, kRowWarps), 0, s>>>(
        Strided{g, g_row_stride}, Strided{xw, xw_row_stride}, bias, Strided{x0, x0_row_stride}, B, N, dxw, dx0,
        dbias);
  else
    cross_bwd_kernel<false><<<grid, dim3(kCols, kRowWarps), 0, s>>>(
        Strided{g, g_row_stride}, Strided{xw, xw_row_stride}, bias, Strided{x0, x0_row_stride}, B, N, dxw, dx0,
        dbias);
  return static_cast<int>(cudaGetLastError());
}
