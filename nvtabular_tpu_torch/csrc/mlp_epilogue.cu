// The MLP layer epilogue, its gradient and the compute-dtype rounds for
// Hopper (sm_90a): kernel K19.
//
// Replaces the fusions XLA makes around each jnp.dot of mlp_apply,
// nvtabular_tpu/models/layers.py:56-66: the casts of the input and of each
// weight to compute_dtype, and the transposes of those casts and of the
// bias add, ReLU and the hidden layer's cast in the jitted train step; and
// DCN's operand casts before each cross product
// (nvtabular_tpu/models/deepfm.py:126-131) and their transposes.
// The products are kernel K21 (mlp_mm.cu), whose store runs the layer's
// forward epilogue: round_c(relu(y + b)) and, where ReLU applies, the byte
// mask z > 0 of the pre-activation z = y + b that the backward below reads
// (relu is jax.nn.relu's: z <= 0 gives +0.0, also for z = -0.0, and NaN
// stays NaN; the mask comes from z, never from the rounded output). Its
// plain version is kernels/mlp_epilogue.py mlp_epilogue_fwd_plain.
//
// nvt_mlp_epilogue_bwd, given the output gradient g [B, N] (rows may be
// strided, each row contiguous): dz = mask ? round_c(g) : 0 (a cast's
// transpose rounds the gradient, and ReLU's is jax.nn.relu's select: a NaN
// z takes no gradient, an infinite g stays out of a masked element) and db
// = the column sums of dz. Without ReLU and round, dz is g itself and only
// db is computed. db is deterministic: each block sums its rows into a
// partial in a fixed order (a thread's rows in order, then a fixed tree
// over the block's rows in shared memory), writes it to partial[block],
// and the last block of its column tile to arrive (an integer ticket, no
// float atomics) sums the tile's partials in order: the same bits from run
// to run. ATen's sum(0) adds in another order, so db is held to a
// tolerance, not to bits.
//
// Layout: a block's kThreads threads are tx lanes across a tile of
// tx * V columns (tx a power of two up to a warp, so that N = 16 or N = 1
// does not leave a warp's lanes idle) by kThreads / tx rows; V = 4 (float4
// and 4-byte mask accesses) where N and every row start are 16-byte
// aligned, else 1 (DLRM's last layer, N = 1). blockIdx.x is the column
// tile; the gridDim.y blocks of a tile take its steps of kThreads / tx rows
// in turn (block y: y, y + gridDim.y, ..), kSteps steps' loads issued
// before any is used. The host plans tx, the tiles and gridDim.y
// (kernels/mlp_epilogue.py epilogue_plan: about 1,056 blocks in all, a
// number fixed by B and N so that db's partials are too).
//
// nvt_round_group rounds up to kMaxSegments tensors in one launch (the
// input and every weight of an MLP, a cross layer's x and W; their
// gradients in the backward): a persistent grid over 4-float units of the
// outputs, the segment table by value with a 64-bit unit prefix (K18's
// plan, kernels/adagrad.py adagrad_plan). A segment is contiguous (float4
// where both ends are 16-byte aligned) or a 2-D view with strided rows (the
// tabular MLP's input, x[:, :1041] of a [B, 1044] buffer), read float by
// float at its row stride; the output is always contiguous.
//
// Bound: bytes. The backward reads g and the mask and writes dz (9 B, or 4 B for the bias alone); the round reads
// and writes 8 B a float. A few operations a float, far below the float32
// rate.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "chunks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kSteps = 4;  // row steps a thread loads before it uses any
constexpr int kMaxRowBlocks = 65535;
constexpr int kMaxSegments = 64;  // kernels/adagrad.py MAX_SEGMENTS
constexpr int kRoundThreads = 256;

template <int kRound>
__device__ __forceinline__ float round_c(float x) {
  if constexpr (kRound == 1) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (kRound == 2) return __half2float(__float2half_rn(x));
  else return x;
}

template <int V>
__device__ __forceinline__ void load_f(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_f(float* p, const float (&v)[V]) {
  if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}

template <int V>
__device__ __forceinline__ unsigned load_m(const unsigned char* p) {
  if constexpr (V == 4) return *reinterpret_cast<const unsigned*>(p);
  else return *p;
}

struct Layout {
  int64_t B;
  int N;
  int tx_shift;  // log2 of the lanes across a tile
  __device__ __forceinline__ int tx() const { return threadIdx.x & ((1 << tx_shift) - 1); }
  __device__ __forceinline__ int ty() const { return threadIdx.x >> tx_shift; }
  __device__ __forceinline__ int rows() const { return kThreads >> tx_shift; }
  __device__ __forceinline__ int64_t steps() const { return (B + rows() - 1) / rows(); }
};

// part[ty][col] summed over ty into part[0][col] by a fixed tree; every
// thread of the block takes part.
template <int V>
__device__ __forceinline__ void tree_over_rows(float* part, const float (&acc)[V], const Layout& L) {
  const int tile = V << L.tx_shift;
  float* mine = part + L.ty() * tile + L.tx() * V;
#pragma unroll
  for (int j = 0; j < V; ++j) mine[j] = acc[j];
  __syncthreads();
  for (int h = L.rows() >> 1; h > 0; h >>= 1) {
    if (L.ty() < h) {
#pragma unroll
      for (int j = 0; j < V; ++j) mine[j] = __fadd_rn(mine[j], mine[h * tile + j]);
    }
    __syncthreads();
  }
}

template <int V, int kRound, bool kRelu, bool kWriteDz>
__global__ void __launch_bounds__(kThreads)
epilogue_bwd_kernel(const float* __restrict__ g, int64_t gs, const unsigned char* __restrict__ mask,
                    float* __restrict__ dz, float* __restrict__ partial, int* __restrict__ tickets,
                    float* __restrict__ db, Layout L) {
  __shared__ float part[kThreads * V];
  __shared__ bool last;
  const int c = (blockIdx.x << L.tx_shift) * V + L.tx() * V;
  const bool live = c < L.N;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (live) {
    const int64_t steps = L.steps(), G = gridDim.y;
    for (int64_t s0 = blockIdx.y; s0 < steps; s0 += G * kSteps) {
      float v[kSteps][V];
      unsigned m[kSteps];
      int64_t r[kSteps];
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        r[k] = (s0 + k * G) * L.rows() + L.ty();
        if (r[k] < L.B) {
          load_f<V>(g + r[k] * gs + c, v[k]);
          if constexpr (kRelu) m[k] = load_m<V>(mask + r[k] * L.N + c);
        }
      }
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if (r[k] >= L.B) continue;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float d = round_c<kRound>(v[k][j]);
          if constexpr (kRelu) d = (m[k] >> (8 * j)) & 0xffu ? d : 0.0f;
          v[k][j] = d;
          acc[j] = __fadd_rn(acc[j], d);
        }
        if constexpr (kWriteDz) store_f<V>(dz + r[k] * L.N + c, v[k]);
      }
    }
  }
  tree_over_rows<V>(part, acc, L);
  if (L.ty() == 0 && live) {
#pragma unroll
    for (int j = 0; j < V; ++j) partial[blockIdx.y * static_cast<int64_t>(L.N) + c + j] = part[L.tx() * V + j];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.x, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last) return;
  // the tile's last block: its partials over the row blocks, each thread's in order, then the tree
  __threadfence();
  float sum[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sum[j] = 0.0f;
  if (live) {
    for (int p = L.ty(); p < static_cast<int>(gridDim.y); p += L.rows()) {
      float q[V];
      if constexpr (V == 4) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(partial + p * static_cast<int64_t>(L.N) + c));
        q[0] = t.x, q[1] = t.y, q[2] = t.z, q[3] = t.w;
      } else {
        q[0] = __ldcg(partial + p * static_cast<int64_t>(L.N) + c);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sum[j] = __fadd_rn(sum[j], q[j]);
    }
  }
  __syncthreads();  // every thread is past its read of part[0] above
  tree_over_rows<V>(part, sum, L);
  if (L.ty() == 0 && live) {
#pragma unroll
    for (int j = 0; j < V; ++j) db[c + j] = part[L.tx() * V + j];
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

// --- dispatch: (vec, round kind, relu, dz written) to a template case -------------------
struct Launch {
  dim3 grid;
  cudaStream_t stream;
};

struct BwdArgs {
  const float* g;
  int64_t gs;
  const unsigned char* mask;
  float* dz;
  float* partial;
  int* tickets;
  float* db;
  Layout L;
};

template <int V, int R, bool Relu>
int bwd(const Launch& k, const BwdArgs& a) {
  if (a.dz)
    epilogue_bwd_kernel<V, R, Relu, true><<<k.grid, kThreads, 0, k.stream>>>(a.g, a.gs, a.mask, a.dz, a.partial,
                                                                              a.tickets, a.db, a.L);
  else
    epilogue_bwd_kernel<V, R, Relu, false><<<k.grid, kThreads, 0, k.stream>>>(a.g, a.gs, a.mask, a.dz, a.partial,
                                                                               a.tickets, a.db, a.L);
  return static_cast<int>(cudaGetLastError());
}

// fn<V, R, Relu>(k, a) for the mode's round kind (bits 1-2) and ReLU (bit 0)
template <int V, template <int, int, bool> class F, class Args>
int by_mode(int mode, const Launch& k, const Args& a) {
  const bool relu = mode & 1;
  switch (mode >> 1) {
    case 0: return relu ? F<V, 0, true>::run(k, a) : F<V, 0, false>::run(k, a);
    case 1: return relu ? F<V, 1, true>::run(k, a) : F<V, 1, false>::run(k, a);
    case 2: return relu ? F<V, 2, true>::run(k, a) : F<V, 2, false>::run(k, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int V, int R, bool Relu>
struct Bwd {
  static int run(const Launch& k, const BwdArgs& a) { return bwd<V, R, Relu>(k, a); }
};

bool aligned(const void* q, unsigned bytes) { return reinterpret_cast<uintptr_t>(q) % bytes == 0; }

int log2_exact(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return (1 << s) == v ? s : -1;
}

// The plan's checks (kernels/mlp_epilogue.py epilogue_plan): tx a power of
// two up to a warp, col_tiles the tiles of tx * vec columns that cover N,
// row_blocks in [1, kMaxRowBlocks]. Returns log2(tx), or -1.
int check_plan(int64_t B, int N, int mode, int vec, int tx, int col_tiles, int row_blocks) {
  const int shift = log2_exact(tx);
  if (B < 0 || N < 1 || (vec != 1 && vec != 4) || N % vec || shift < 0 || tx > kWarp || mode < 0 || mode > 5)
    return -1;
  const int64_t tile = static_cast<int64_t>(tx) * vec;
  if (col_tiles != (N + tile - 1) / tile || row_blocks < 1 || row_blocks > kMaxRowBlocks) return -1;
  return shift;
}

// --- the grouped round ------------------------------------------------------------------------
struct RoundSegments {
  const float* src[kMaxSegments];
  float* dst[kMaxSegments];
  uint64_t n[kMaxSegments];           // floats, >= 1
  uint64_t cols[kMaxSegments];        // 0: contiguous; else the row width of a strided 2-D view
  uint64_t stride[kMaxSegments];      // that view's row stride, in floats
  uint64_t start[kMaxSegments + 1];   // the prefix of ceil(n / 4) units
  unsigned char vec[kMaxSegments];    // contiguous, src and dst 16-byte aligned
};

__device__ __forceinline__ int segment_of(const RoundSegments& s, int m, uint64_t u) {
  int lo = 0, hi = m - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s.start[mid] <= u) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <int kRound>
__global__ void __launch_bounds__(kRoundThreads)
round_kernel(const __grid_constant__ RoundSegments s, int m, uint64_t total) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kRoundThreads;
  uint64_t u = static_cast<uint64_t>(blockIdx.x) * kRoundThreads + threadIdx.x;
  if (u >= total) return;
  int k = segment_of(s, m, u);
  for (; u < total; u += stride) {
    while (k + 1 < m && s.start[k + 1] <= u) ++k;
    const uint64_t off = (u - s.start[k]) * 4;
    const uint64_t left = s.n[k] - off;
    const int cnt = left < 4 ? static_cast<int>(left) : 4;
    float* dst = s.dst[k] + off;
    if (!s.cols[k]) {
      const float* src = s.src[k] + off;
      if (cnt == 4 && s.vec[k]) {
        const float4 t = __ldcs(reinterpret_cast<const float4*>(src));
        *reinterpret_cast<float4*>(dst) =
            make_float4(round_c<kRound>(t.x), round_c<kRound>(t.y), round_c<kRound>(t.z), round_c<kRound>(t.w));
      } else {
        for (int j = 0; j < cnt; ++j) dst[j] = round_c<kRound>(__ldcs(src + j));
      }
    } else {
      const uint64_t cols = s.cols[k];
      uint64_t row, col;
      if (off < (1ull << 32) && cols < (1ull << 32)) {  // 32-bit division where it suffices
        row = static_cast<uint32_t>(off) / static_cast<uint32_t>(cols);
        col = static_cast<uint32_t>(off) - static_cast<uint32_t>(row) * static_cast<uint32_t>(cols);
      } else {
        row = off / cols;
        col = off - row * cols;
      }
      for (int j = 0; j < cnt; ++j) {
        dst[j] = round_c<kRound>(__ldcs(s.src[k] + row * s.stride[k] + col));
        if (++col == cols) col = 0, ++row;
      }
    }
  }
}

template <int kRound>
int launch_round(const RoundSegments& s, int m, uint64_t total, cudaStream_t stream) {
  static nvt::ResidentCache cache;
  const uint64_t units = total;
  unsigned blocks = 0;
  const uint64_t want = (units + kRoundThreads - 1) / kRoundThreads;
  if (int rc = nvt::cached_resident_blocks(cache, round_kernel<kRound>, kRoundThreads, 0,
                                           want > INT64_MAX ? INT64_MAX : static_cast<int64_t>(want), &blocks))
    return rc;
  round_kernel<kRound><<<blocks, kRoundThreads, 0, stream>>>(s, m, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward for the output gradient g [B, N] (row stride gs floats, each
// row contiguous): dz [B, N] contiguous (null only for mode 0: dz is g),
// db [N]; partial is [row_blocks, N] float32 scratch and tickets at least
// col_tiles int32 counters, all zero (the kernel leaves them so).
extern "C" int nvt_mlp_epilogue_bwd(const float* g, int64_t gs, const unsigned char* mask, float* dz, float* partial,
                                    int* tickets, float* db, int64_t B, int N, int mode, int vec, int tx, int col_tiles,
                                    int row_blocks, void* stream) {
  const int shift = check_plan(B, N, mode, vec, tx, col_tiles, row_blocks);
  if (shift < 0 || !g || gs < 0 || !partial || !tickets || !db || ((mode & 1) && !mask) || (!dz && mode != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && !(aligned(g, 16) && gs % 4 == 0 && (!dz || aligned(dz, 16)) && aligned(partial, 16) &&
                    (!(mode & 1) || aligned(mask, 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Launch k{dim3(col_tiles, row_blocks), static_cast<cudaStream_t>(stream)};
  const BwdArgs a{g, gs, mask, dz, partial, tickets, db, Layout{B, N, shift}};
  return vec == 4 ? by_mode<4, Bwd>(mode, k, a) : by_mode<1, Bwd>(mode, k, a);
}

// One launch over m (1 to kMaxSegments) tensors: src and dst their
// pointers (float32, 4-byte aligned, none null; dst contiguous), n their
// lengths (>= 1 floats), cols / row_stride 0 for a contiguous src or the
// row width and row stride of a strided 2-D view, start the prefix of
// their 4-float units (m + 1 entries: 0, then start[k] + ceil(n[k] / 4)),
// kind the round (1 bfloat16, 2 float16).
extern "C" int nvt_round_group(const float* const* src, float* const* dst, const int64_t* n, const int64_t* cols,
                               const int64_t* row_stride, const uint64_t* start, int m, int kind, void* stream) {
  if (m < 1 || m > kMaxSegments || start[0] != 0 || (kind != 1 && kind != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  RoundSegments s;
  s.start[0] = 0;
  for (int k = 0; k < m; ++k) {
    if (n[k] < 1 || !src[k] || !dst[k] || !aligned(src[k], 4) || !aligned(dst[k], 4) || cols[k] < 0 ||
        (cols[k] > 0 && (row_stride[k] < cols[k] || n[k] % cols[k])))
      return static_cast<int>(cudaErrorInvalidValue);
    const uint64_t len = static_cast<uint64_t>(n[k]);
    if (start[k + 1] < start[k] || start[k + 1] - start[k] != (len + 3) / 4)
      return static_cast<int>(cudaErrorInvalidValue);
    s.src[k] = src[k];
    s.dst[k] = dst[k];
    s.n[k] = len;
    s.cols[k] = static_cast<uint64_t>(cols[k]);
    s.stride[k] = static_cast<uint64_t>(row_stride[k]);
    s.start[k + 1] = start[k + 1];
    s.vec[k] = !cols[k] && aligned(src[k], 16) && aligned(dst[k], 16);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == 1 ? launch_round<1>(s, m, start[m], st) : launch_round<2>(s, m, start[m], st);
}
