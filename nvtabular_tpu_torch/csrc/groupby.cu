// Group-stat joins for Hopper (sm_90a): kernel K10a.
//
// A fitted TargetEncoding or JoinGroupby holds, for each key group, stat
// arrays over its fitted groups with a pad slot at index num_groups. The
// group index of each row (its stat row, num_groups for a miss or a null key)
// comes from the Categorify lookup kernels (lookup.cu, K1-K3). These kernels
// then read the stats at that index:
//
// te_encode replaces the TargetEncoding device epilogue
//   nvtabular_tpu/ops/target_encoding.py:307-362 (_transform_device):
//     s = sum[idx] - fold_sum[fold, idx];  c = count[idx] - fold_count[fold, idx]
//     te = c + p > 0 ? (s + p * mean) / max(c + p, 1e-12) : mean
//   in float32, for every group g and target t, into out[g * T + t]. The fold
//   of each row is hashed inside the kernel from its global row index
//   (hash.cuh, the reference's _fold_ids_dev at :39-50), so no fold array goes
//   through memory. Products and sums are rounded one by one (__fmul_rn,
//   __fadd_rn, never an FMA), as the plain PyTorch version on the CPU rounds
//   them, so the two agree bit for bit.
//
// stat_gather replaces JoinGroupby's device gathers
//   nvtabular_tpu/ops/join_groupby.py:255-282 (_transform_device) and
//   groupby_stats.py:646-660 (padded_stat): int32 `__rows` counts and float32
//   stats at each row's group index, every output column in one launch.
//
// Bound: bytes. Each group index is read once and each output written once;
// each gathered stat is a random 4-byte read (one 32-byte sector) from a
// table of a few MB that stays in the 50 MB L2. One thread per (row, group)
// or (row, output column); the few stat offsets are read through the
// constant path of __ldg.

#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
te_encode_kernel(const int32_t* __restrict__ gidx, int T, int64_t n,
                 const float* __restrict__ sums, const float* __restrict__ counts,
                 const int64_t* __restrict__ stat_off, const float* __restrict__ fsums,
                 const float* __restrict__ fcnts, const int64_t* __restrict__ fold_off,
                 const int64_t* __restrict__ strides, const float* __restrict__ means,
                 float p_smooth, uint32_t kfold, uint32_t seed, uint64_t row_offset,
                 float* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int g = blockIdx.y;
  const int64_t idx = gidx[static_cast<int64_t>(g) * n + r];
  const int64_t fold_row =
      kfold > 1 ? nvt::fold_id(row_offset + static_cast<uint64_t>(r), seed, kfold) * __ldg(strides + g) : 0;
  for (int t = 0; t < T; ++t) {
    const int j = g * T + t;
    const int64_t at = __ldg(stat_off + j) + idx;
    float s = __ldg(sums + at);
    float c = __ldg(counts + at);
    if (kfold > 1) {
      const int64_t f = __ldg(fold_off + j) + fold_row + idx;
      s = __fsub_rn(s, __ldg(fsums + f));
      c = __fsub_rn(c, __ldg(fcnts + f));
    }
    const float mean = __ldg(means + t);
    const float denom = __fadd_rn(c, p_smooth);
    const float te = denom > 0.0f
                         ? __fdiv_rn(__fadd_rn(s, __fmul_rn(p_smooth, mean)), fmaxf(denom, 1e-12f))
                         : mean;
    out[static_cast<int64_t>(j) * n + r] = te;
  }
}

// grid.y = ki + kf output columns: the first ki are int32 (from itable), the
// rest float32 (from ftable); column k reads group index row groups[k] at
// offset offs[k] of its table
__global__ void __launch_bounds__(kThreads)
stat_gather_kernel(const int32_t* __restrict__ gidx, int64_t n, const int32_t* __restrict__ itable,
                   const float* __restrict__ ftable, const int32_t* __restrict__ groups,
                   const int64_t* __restrict__ offs, int ki, int32_t* __restrict__ iout,
                   float* __restrict__ fout) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int k = blockIdx.y;
  const int64_t at = __ldg(offs + k) + gidx[static_cast<int64_t>(__ldg(groups + k)) * n + r];
  if (k < ki) {
    iout[static_cast<int64_t>(k) * n + r] = __ldg(itable + at);
  } else {
    fout[static_cast<int64_t>(k - ki) * n + r] = __ldg(ftable + at);
  }
}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int nvt_te_encode(const int32_t* gidx, int G, int T, int64_t n, const float* sums,
                             const float* counts, const int64_t* stat_off, const float* fsums,
                             const float* fcnts, const int64_t* fold_off, const int64_t* strides,
                             const float* means, float p_smooth, uint32_t kfold, uint32_t seed,
                             uint64_t row_offset, float* out, void* stream) {
  if (G < 0 || T < 0 || n < 0 || kfold == 0 || G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || T == 0 || n == 0) return 0;
  dim3 grid(blocks_for(n), G);
  te_encode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gidx, T, n, sums, counts, stat_off, fsums, fcnts, fold_off, strides, means, p_smooth, kfold,
      seed, row_offset, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_stat_gather(const int32_t* gidx, int64_t n, const int32_t* itable,
                               const float* ftable, const int32_t* groups, const int64_t* offs,
                               int ki, int kf, int32_t* iout, float* fout, void* stream) {
  if (ki < 0 || kf < 0 || n < 0 || ki + kf > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (ki + kf == 0 || n == 0) return 0;
  dim3 grid(blocks_for(n), ki + kf);
  stat_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gidx, n, itable, ftable, groups, offs, ki, iout, fout);
  return static_cast<int>(cudaGetLastError());
}
