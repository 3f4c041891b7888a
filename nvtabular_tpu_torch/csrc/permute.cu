// Row permutation for Hopper (sm_90a): kernel K14.
//
// Replaces the one jitted program of the JAX package's training feed,
//   nvtabular_tpu/loader/device_loader.py:21-31 (_permute_tree):
//   {k: jnp.take(v, perm, axis=0) for k, v in arrays.items()}
// which gathers every array of a chunk (26 int32 code columns, the [n, 13]
// float32 dense block, the float32 label; int8 or int16 codes after
// ReduceDtypeSize; the multihot feed's [n, 4] lists and masks) by one
// permutation of its rows.
//
// Bound: bytes. Each array is read once and written once, and the
// permutation (4 or 8 bytes a row) is read once: for the Criteo chunk,
// 160 B a row read + 160 B written + 8 B of int64 permutation. A random
// 4-byte read still moves a 32-byte sector from L2 to the SM, which the
// byte bound does not count.
//
// Design:
// * An array's element is the widest of 4, 2 or 1 bytes that divides its
//   row and both its addresses (the wrapper's choice): int8 and int16 codes
//   move in their own width, with no widening on the host.
// * A persistent grid (the blocks the card holds at once) walks tiles of
//   kTileRows consecutive output rows; a thread takes kRows of them and
//   reads their permutation entries once for every array of the launch (one
//   16-byte vector of int32, two of int64, where aligned).
// * An array of one element a row: a thread's kRows random loads, then one
//   store of its kRows consecutive outputs (16 bytes of 4-byte elements, 8
//   of int16, 4 of int8).
// * An array of wider rows (the dense [n, 13] float32 block, the multihot
//   [n, 4] lists) is copied by the whole block over the tile's flat
//   elements, consecutive threads on consecutive elements of a row, the
//   source rows read from shared memory; the element's row and place
//   advance by the fixed step kThreads / w and kThreads % w (no division an
//   element), 16 loads in flight.
// * Outputs are stored evict-first (st.global.cs), so that they do not push
//   the sources out of L2.
//
// A call of more arrays launches once for each chunk of kMaxArrays, and a
// call whose rows times the widest row's elements would pass int32 launches
// once for each chunk of rows (chunks.cuh), the permutation and the outputs
// moved to the chunk's first row; every launch is counted.
//
// A permutation entry outside [0, n) writes zeros instead of reading out
// of bounds (the plain version v[perm] raises for it).

#include <cuda_runtime.h>
#include <cstdint>

#include "chunks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // consecutive output rows a thread
constexpr int kTileRows = kThreads * kRows;
constexpr int kMaxArrays = 64;

struct Arrays {
  const void* src[kMaxArrays];
  void* dst[kMaxArrays];
  int64_t width[kMaxArrays];         // row width in elements
  unsigned step_rows[kMaxArrays];    // wide rows: kThreads / width
  unsigned step_elems[kMaxArrays];   // and kThreads % width
  unsigned char shift[kMaxArrays];   // log2 of the element's bytes: 2, 1 or 0
  unsigned char packed[kMaxArrays];  // the output aligned for one store of a thread's rows
};

// A thread's kRows output rows [r, r + cnt): their source rows, -1 where
// the row is past the launch or its entry lies outside [0, n).
template <typename Idx>
__device__ __forceinline__ void source_rows(const Idx* __restrict__ perm, int64_t r, int cnt, int64_t n, bool vec,
                                            int64_t (&p)[kRows]) {
  int64_t v[kRows];
  if (cnt == kRows && vec) {
    if constexpr (sizeof(Idx) == 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(perm + r));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      const longlong2 q0 = __ldg(reinterpret_cast<const longlong2*>(perm + r));
      const longlong2 q1 = __ldg(reinterpret_cast<const longlong2*>(perm + r + 2));
      v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) v[j] = j < cnt ? static_cast<int64_t>(perm[r + j]) : -1;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) p[j] = j < cnt && v[j] >= 0 && v[j] < n ? v[j] : -1;
}

// One store of a thread's kRows consecutive elements (aligned to kRows *
// sizeof(T) bytes).
__device__ __forceinline__ void pack_store(uint8_t* d, const uint8_t (&v)[kRows]) {
  __stcs(reinterpret_cast<unsigned int*>(d), v[0] | (v[1] << 8) | (v[2] << 16) | (static_cast<unsigned>(v[3]) << 24));
}
__device__ __forceinline__ void pack_store(uint16_t* d, const uint16_t (&v)[kRows]) {
  __stcs(reinterpret_cast<uint2*>(d), make_uint2(v[0] | (static_cast<unsigned>(v[1]) << 16),
                                                 v[2] | (static_cast<unsigned>(v[3]) << 16)));
}
__device__ __forceinline__ void pack_store(uint32_t* d, const uint32_t (&v)[kRows]) {
  __stcs(reinterpret_cast<uint4*>(d), make_uint4(v[0], v[1], v[2], v[3]));
}

// Array k, one element a row of T: the thread's kRows loads, then its store.
template <typename T>
__device__ __forceinline__ void copy_one(const Arrays& a, int k, const int64_t (&p)[kRows], int64_t r, int cnt) {
  const T* __restrict__ s = static_cast<const T*>(a.src[k]);
  T v[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) v[j] = p[j] >= 0 ? __ldg(s + p[j]) : T{};
  T* d = static_cast<T*>(a.dst[k]) + r;
  if (cnt == kRows && a.packed[k]) {
    pack_store(d, v);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (j < cnt) __stcs(d + j, v[j]);
  }
}

// Array k, rows of w > 1 elements of T, over the tile's rows [t0, t0 +
// tile_rows): the block's threads walk its flat elements.
template <typename T>
__device__ __forceinline__ void copy_wide(const Arrays& a, int k, int64_t t0, int64_t tile_rows,
                                          const int64_t* s_src) {
  const T* __restrict__ src = static_cast<const T*>(a.src[k]);
  const int64_t w = a.width[k];
  T* __restrict__ d = static_cast<T*>(a.dst[k]) + t0 * w;
  const unsigned step_rows = a.step_rows[k], step_elems = a.step_elems[k];
  int64_t row = w > kThreads ? 0 : threadIdx.x / static_cast<unsigned>(w);  // one division a thread a tile
  int64_t e = threadIdx.x - row * w;
  const int64_t total = tile_rows * w;
#pragma unroll 16
  for (int64_t f = threadIdx.x; f < total; f += kThreads) {  // 16 loads in flight
    const int64_t p = s_src[row];
    __stcs(d + f, p >= 0 ? __ldg(src + p * w + e) : T{});
    row += step_rows;
    e += step_elems;
    if (e >= w) {
      e -= w;
      ++row;
    }
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
permute_rows_kernel(const __grid_constant__ Arrays a, int m, const Idx* __restrict__ perm, int64_t rows, int64_t n,
                    bool perm_vec) {
  __shared__ int64_t s_src[kTileRows];
  const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t t0 = tile * kTileRows;
    const int64_t tile_rows = rows - t0 < kTileRows ? rows - t0 : kTileRows;
    const int64_t r = t0 + static_cast<int64_t>(threadIdx.x) * kRows;
    const int cnt = rows - r >= kRows ? kRows : (rows > r ? static_cast<int>(rows - r) : 0);
    int64_t p[kRows];
    source_rows(perm, r, cnt, n, perm_vec, p);
    __syncthreads();  // the previous tile's wide copies are done with s_src
#pragma unroll
    for (int j = 0; j < kRows; ++j) s_src[threadIdx.x * kRows + j] = p[j];
    __syncthreads();
    for (int k = 0; k < m; ++k) {  // uniform across the block
      if (a.width[k] == 1) {
        switch (a.shift[k]) {
          case 0: copy_one<uint8_t>(a, k, p, r, cnt); break;
          case 1: copy_one<uint16_t>(a, k, p, r, cnt); break;
          default: copy_one<uint32_t>(a, k, p, r, cnt);
        }
      } else {
        switch (a.shift[k]) {
          case 0: copy_wide<uint8_t>(a, k, t0, tile_rows, s_src); break;
          case 1: copy_wide<uint16_t>(a, k, t0, tile_rows, s_src); break;
          default: copy_wide<uint32_t>(a, k, t0, tile_rows, s_src);
        }
      }
    }
  }
}

}  // namespace

// src, dst: num_arrays pointers; row_bytes: each array's row width in bytes
// (> 0); elem_bytes: the element each copies, 4, 2 or 1, dividing its row
// and both its addresses; rows_per_launch: the rows of a launch, whose
// widest row's elements times rows stay within int32. *launches: the kernel
// launches made, one for each chunk of kMaxArrays arrays and of rows.
extern "C" int nvt_permute_rows(const void* const* src, void* const* dst, const int64_t* row_bytes,
                                const int* elem_bytes, int num_arrays, const void* perm, int perm_is_int64,
                                int64_t n, int64_t rows_per_launch, int* launches, void* stream) {
  if (num_arrays < 0 || n < 0 || rows_per_launch < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < num_arrays; ++k) {
    const int e = elem_bytes[k];
    if (row_bytes[k] <= 0 || !(e == 4 || e == 2 || e == 1) || row_bytes[k] % e != 0 ||
        reinterpret_cast<uintptr_t>(src[k]) % e != 0 || reinterpret_cast<uintptr_t>(dst[k]) % e != 0 ||
        row_bytes[k] / e > INT32_MAX / rows_per_launch)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_arrays == 0 || n == 0) return 0;
  static nvt::ResidentCache cache[2];  // by the permutation's type
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int isz = perm_is_int64 ? 8 : 4;
  return nvt::for_each_chunk(num_arrays, kMaxArrays, [&](int k0, int m) {
    Arrays a;
    for (int k = 0; k < m; ++k) {
      const int e = elem_bytes[k0 + k];
      a.width[k] = row_bytes[k0 + k] / e;
      a.step_rows[k] = static_cast<unsigned>(kThreads / a.width[k]);
      a.step_elems[k] = static_cast<unsigned>(kThreads % a.width[k]);
      a.shift[k] = static_cast<unsigned char>(e == 4 ? 2 : e == 2 ? 1 : 0);
      a.src[k] = src[k0 + k];
    }
    return nvt::for_each_chunk(n, rows_per_launch, [&](int64_t r0, int64_t rows) {
      for (int k = 0; k < m; ++k) {
        a.dst[k] = static_cast<char*>(dst[k0 + k]) + r0 * row_bytes[k0 + k];
        const int e = elem_bytes[k0 + k];
        a.packed[k] = reinterpret_cast<uintptr_t>(a.dst[k]) % (kRows * e) == 0;
      }
      const char* p = static_cast<const char*>(perm) + r0 * isz;
      const bool vec = reinterpret_cast<uintptr_t>(p) % 16 == 0;
      const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
      unsigned blocks = 0;
      if (perm_is_int64) {
        if (int rc = nvt::cached_resident_blocks(cache[1], permute_rows_kernel<int64_t>, kThreads, 0, tiles, &blocks))
          return rc;
        permute_rows_kernel<int64_t><<<blocks, kThreads, 0, s>>>(a, m, reinterpret_cast<const int64_t*>(p), rows, n,
                                                                 vec);
      } else {
        if (int rc = nvt::cached_resident_blocks(cache[0], permute_rows_kernel<int32_t>, kThreads, 0, tiles, &blocks))
          return rc;
        permute_rows_kernel<int32_t><<<blocks, kThreads, 0, s>>>(a, m, reinterpret_cast<const int32_t*>(p), rows, n,
                                                                 vec);
      }
      return nvt::launched(launches);
    });
  });
}
