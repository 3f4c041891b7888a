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
// operand z is never stored: each block builds its tiles of z in shared
// memory as it goes (the reference materialises all of z, 21.8 GB at
// [65536, 200 * 26, 16]). Each z value is rounded once (__fmul_rn), as the
// reference's separate product rounds it; the sums run in float32 with fmaf,
// in another order than XLA's.
//
// Bound: operations. The forward is 2 * Hn * K * N flops (the backward twice
// that), against float32 outside the tensor cores (67 TFLOP/s): 283 GFLOP,
// 4.2 ms, at layer 1 of xDeepFM's Criteo setting ([65536, 26, 16] x
// [65536, 26, 16] -> 200), against 0.4 GB of bytes.
//
// nvt_cin_fwd (cin_fwd_kernel): a block owns kFwdCols = 64 columns and every
// output row, so each z tile is built once. Hn is cut into passes of at most
// 256 rows (one pass up to Hn = 256; 200 rows stay 200, a multiple of 8),
// and the block has 8 threads for each 8 rows: a thread keeps an 8 x 8
// register tile (rows 8 ty .. 8 ty + 7; columns 4 tx .. 4 tx + 3 and 32 + 4
// tx .. 32 + 4 tx + 3, so a quarter-warp's float4 reads of z are 128
// consecutive bytes), 4 float4 reads of shared memory for 64 fmaf. At the
// start the block stages x_k[b, :, d] and x_0[b, :, d] of its columns in
// shared memory (Hk + F rows of 64), so a step's z tile is __fmul_rn of two
// shared values: a step is one i and up to kFwdDepth consecutive j, and its
// w rows k = i * F + j .. are one contiguous run of w. The w tiles are double
// buffered and copied with cp.async: step s + 1's tile arrives while step s
// multiplies, behind one __syncthreads a step. Shared memory: (Hk + F) * 256
// B of staged inputs and 2 * 16 * rows * 4 B of w (91 KB at layer 2: two
// blocks an SM).
//
// nvt_cin_bwd, for the output gradient g [B, Hn, D] (two kernels, one tiled
// SIMT product each: a block of 256 threads owns a 64 x 64 tile of the
// result, steps through the depth 16 at a time with both operands' tiles in
// shared memory, and each thread keeps a 4 x 4 register tile):
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

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// the backward's tiles
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

// --- the forward ----------------------------------------------------------------------
constexpr int kFwdCols = 64;          // columns (b, d) of a block
constexpr int kFwdDepth = 16;         // pairs k of a step: one i, up to 16 consecutive j
constexpr int kFwdMaxGroups = 32;     // 8-row groups of a pass: at most 256 rows, 256 threads

// Rows a pass covers (8 for each thread group of 8) and the block's shared memory.
struct FwdLayout {
  int rows;
  size_t smem;
};

FwdLayout fwd_layout(const Shape& s) {
  int groups = (s.Hn + 7) / 8;
  if (groups > kFwdMaxGroups) groups = kFwdMaxGroups;
  const int rows = 8 * groups;
  const size_t smem = 3 * kFwdCols * sizeof(int64_t) +
                      (static_cast<size_t>(s.Hk + s.F) * kFwdCols + 2 * kFwdDepth * (rows + kFwdCols)) * sizeof(float);
  return {rows, smem};
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// dst[kk][m] = w[k0 + kk, h0 + m] for kk < depth and m < live, 0 for live
// <= m < rows: a step's w tile, copied asynchronously. kVec: 16-byte copies
// (Hn a multiple of 4, w 16-byte aligned); a thread copies chunk q of rows
// kk0, kk0 + kk_step, ...; else 4-byte copies, a thread column m = q.
template <bool kVec>
__device__ __forceinline__ void load_w_tile(const float* __restrict__ w, int Hn, int k0, int depth, int h0,
                                            int rows, int live, int q, int kk0, int kk_step,
                                            float* __restrict__ dst) {
  const int m = kVec ? 4 * q : q;
  const float* src = w + static_cast<int64_t>(k0) * Hn + h0 + m;
  for (int kk = kk0; kk < depth; kk += kk_step) {
    float* d = dst + kk * rows + m;
    if (kVec) {
      if (m < live) cp_async16(d, src + static_cast<int64_t>(kk) * Hn);
      else *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      if (m < live) cp_async4(d, src + static_cast<int64_t>(kk) * Hn);
      else *d = 0.0f;
    }
  }
  cp_async_commit();
}

template <bool kVec>
__global__ void __launch_bounds__(256, 2)
cin_fwd_kernel(const float* __restrict__ xk, const float* __restrict__ x0, const float* __restrict__ w, Shape s,
               int rows, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  int64_t* base_xk = reinterpret_cast<int64_t*>(smem4);  // [kFwdCols]: a column's offset in x_k, -1 past N
  int64_t* base_x0 = base_xk + kFwdCols;                  // ... in x_0
  int64_t* base_out = base_x0 + kFwdCols;                 // ... in out
  float* xks = reinterpret_cast<float*>(base_out + kFwdCols);  // [Hk][kFwdCols]
  float* x0s = xks + s.Hk * kFwdCols;                          // [F][kFwdCols]
  float* ws = x0s + s.F * kFwdCols;                            // [2][kFwdDepth][rows]
  float* zs = ws + 2 * kFwdDepth * rows;                       // [2][kFwdDepth][kFwdCols]
  const int T = blockDim.x, tid = threadIdx.x;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kFwdCols;
  const int64_t N = s.N();
  for (int c = tid; c < kFwdCols; c += T) {
    const int64_t n = n0 + c;
    if (n < N) {
      const int64_t b = n / s.D;
      const int64_t d = n - b * s.D;
      base_xk[c] = b * s.Hk * s.D + d;
      base_x0[c] = b * s.F * s.D + d;
      base_out[c] = b * s.Hn * s.D + d;
    } else {
      base_xk[c] = base_x0[c] = base_out[c] = -1;
    }
  }
  __syncthreads();
  for (int e = tid; e < s.Hk * kFwdCols; e += T) {
    const int64_t o = base_xk[e % kFwdCols];
    xks[e] = o >= 0 ? xk[o + static_cast<int64_t>(e / kFwdCols) * s.D] : 0.0f;
  }
  for (int e = tid; e < s.F * kFwdCols; e += T) {
    const int64_t o = base_x0[e % kFwdCols];
    x0s[e] = o >= 0 ? x0[o + static_cast<int64_t>(e / kFwdCols) * s.D] : 0.0f;
  }
  __syncthreads();

  const int tx = tid % 8, ty = tid / 8;  // columns 4 tx + {0..3}, 32 + 4 tx + {0..3}; rows 8 ty + {0..7}
  // this thread's share of a w tile's copy
  const int chunks = kVec ? rows / 4 : rows;
  const int q = tid % chunks, kk0 = tid / chunks, kk_step = T / chunks;
  const int steps = s.Hk * ((s.F + kFwdDepth - 1) / kFwdDepth);
  for (int h0 = 0; h0 < s.Hn; h0 += rows) {
    const int live = s.Hn - h0 < rows ? s.Hn - h0 : rows;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    int i = 0, j0 = 0;  // the step's pairs: i, j0 .. j0 + depth - 1
    load_w_tile<kVec>(w, s.Hn, 0, s.F < kFwdDepth ? s.F : kFwdDepth, h0, rows, live, q, kk0, kk_step, ws);
    for (int step = 0; step < steps; ++step) {
      const int buf = step & 1;
      const int depth = s.F - j0 < kFwdDepth ? s.F - j0 : kFwdDepth;
      float* zb = zs + buf * kFwdDepth * kFwdCols;
      const float* xi = xks + i * kFwdCols;
      const float* xj = x0s + j0 * kFwdCols;
      for (int e = tid; e < depth * kFwdCols; e += T) zb[e] = __fmul_rn(xi[e % kFwdCols], xj[e]);
      cp_async_wait_all();
      __syncthreads();  // z and w of this step in place; every thread done with the other buffers
      int ni = i, nj = j0 + kFwdDepth;
      if (nj >= s.F) {
        nj = 0;
        ++ni;
      }
      if (step + 1 < steps)
        load_w_tile<kVec>(w, s.Hn, ni * s.F + nj, s.F - nj < kFwdDepth ? s.F - nj : kFwdDepth, h0, rows, live, q,
                          kk0, kk_step, ws + (buf ^ 1) * kFwdDepth * rows);
      const float* wb = ws + buf * kFwdDepth * rows + ty * 8;
      const float* zt = zb + tx * 4;
#pragma unroll 2
      for (int kk = 0; kk < depth; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(wb + kk * rows);
        const float4 a1 = *reinterpret_cast<const float4*>(wb + kk * rows + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(zt + kk * kFwdCols);
        const float4 b1 = *reinterpret_cast<const float4*>(zt + kk * kFwdCols + 32);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      i = ni;
      j0 = nj;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int h = h0 + ty * 8 + r;
      if (h >= s.Hn) break;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int64_t o = base_out[(c < 4 ? 0 : 32) + tx * 4 + (c & 3)];
        if (o >= 0) out[o + static_cast<int64_t>(h) * s.D] = acc[r][c];
      }
    }
    __syncthreads();  // the next pass refills both buffers
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

// Shared memory the forward needs for Hk, F and Hn (the wrapper refuses
// above the card's 227 KB a block).
extern "C" int64_t nvt_cin_fwd_smem(int Hk, int F, int Hn) {
  const Shape s{0, Hk, F, 1, Hn};
  return static_cast<int64_t>(fwd_layout(s).smem);
}

// x_k float32 [B, Hk, D], x_0 float32 [B, F, D], w float32 [Hk * F, Hn],
// all contiguous → out float32 [B, Hn, D], contiguous.
extern "C" int nvt_cin_fwd(const float* xk, const float* x0, const float* w, int64_t B, int Hk, int F, int D,
                           int Hn, float* out, void* stream_ptr) {
  const Shape s{B, Hk, F, D, Hn};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int64_t blocks = ceil_div(s.N(), kFwdCols);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const FwdLayout layout = fwd_layout(s);
  const bool vec = Hn % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const void* kernel = vec ? reinterpret_cast<const void*>(cin_fwd_kernel<true>)
                           : reinterpret_cast<const void*>(cin_fwd_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(layout.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned threads = static_cast<unsigned>(layout.rows);  // 8 threads for each 8 rows
  if (vec)
    cin_fwd_kernel<true><<<static_cast<unsigned>(blocks), threads, layout.smem, stream>>>(xk, x0, w, s, layout.rows,
                                                                                          out);
  else
    cin_fwd_kernel<false><<<static_cast<unsigned>(blocks), threads, layout.smem, stream>>>(xk, x0, w, s, layout.rows,
                                                                                           out);
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
