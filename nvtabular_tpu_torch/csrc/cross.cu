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
// a row) by 8 warps, each warp walking the rows of the block's row range
// with stride 8. Every input may be a strided view (row stride given, each
// row contiguous: DCN's last layer receives g as a slice of the gradient of
// its [B, N + H] concatenation); outputs are contiguous [B, N].
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

__global__ void __launch_bounds__(kCols * kRowWarps)
cross_fwd_kernel(Strided xw, const float* __restrict__ bias, Strided x0, Strided x, int64_t B, int N,
                 float* __restrict__ out) {
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= N) return;  // no barrier below
  const float bc = bias[c];
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRowsPerBlock;
  const int64_t r1 = r0 + kRowsPerBlock < B ? r0 + kRowsPerBlock : B;
  for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowWarps) {
    const float t = __fadd_rn(xw.at(r, c), bc);
    out[r * N + c] = __fadd_rn(__fmul_rn(x0.at(r, c), t), x.at(r, c));
  }
}

__global__ void __launch_bounds__(kCols * kRowWarps)
cross_bwd_kernel(Strided g, Strided xw, const float* __restrict__ bias, Strided x0, int64_t B, int N,
                 float* __restrict__ dxw, float* __restrict__ dx0, float* __restrict__ dbias) {
  __shared__ float part[kRowWarps][kCols];
  const int c = blockIdx.x * kCols + threadIdx.x;
  float acc = 0.0f;
  if (c < N) {
    const float bc = bias[c];
    const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRowsPerBlock;
    const int64_t r1 = r0 + kRowsPerBlock < B ? r0 + kRowsPerBlock : B;
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowWarps) {
      const float gr = g.at(r, c);
      const float d = __fmul_rn(gr, x0.at(r, c));
      dxw[r * N + c] = d;
      dx0[r * N + c] = __fmul_rn(gr, __fadd_rn(xw.at(r, c), bc));
      acc += d;
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

bool bad_shape(int64_t B, int N) {
  return B < 0 || N <= 0 || (B + kRowsPerBlock - 1) / kRowsPerBlock > 65535;  // gridDim.y's limit
}

dim3 grid_for(int64_t B, int N) {
  return dim3(static_cast<unsigned int>((N + kCols - 1) / kCols),
              static_cast<unsigned int>((B + kRowsPerBlock - 1) / kRowsPerBlock));
}

}  // namespace

extern "C" int nvt_cross_fwd(const float* xw, int64_t xw_row_stride, const float* bias,
                             const float* x0, int64_t x0_row_stride, const float* x,
                             int64_t x_row_stride, int64_t B, int N, float* out, void* stream) {
  if (bad_shape(B, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cross_fwd_kernel<<<grid_for(B, N), dim3(kCols, kRowWarps), 0, s>>>(
      Strided{xw, xw_row_stride}, bias, Strided{x0, x0_row_stride}, Strided{x, x_row_stride}, B, N, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_cross_bwd(const float* g, int64_t g_row_stride, const float* xw,
                             int64_t xw_row_stride, const float* bias, const float* x0,
                             int64_t x0_row_stride, int64_t B, int N, float* dxw, float* dx0,
                             float* dbias, void* stream) {
  if (bad_shape(B, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cross_bwd_kernel<<<grid_for(B, N), dim3(kCols, kRowWarps), 0, s>>>(
      Strided{g, g_row_stride}, Strided{xw, xw_row_stride}, bias, Strided{x0, x0_row_stride}, B, N, dxw,
      dx0, dbias);
  return static_cast<int>(cudaGetLastError());
}
