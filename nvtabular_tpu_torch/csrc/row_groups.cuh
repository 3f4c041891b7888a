// Equal rows of a warp's 32 lanes, for kernels that add many terms into a
// few hot rows of a gradient (sharded_embedding.cu's range_scatter_grad,
// fm.cu's linear gradient). A warp takes 32 consecutive ids of one column,
// groups the lanes whose ids fall on the same row with __match_any_sync, and
// sums each group's terms into its leader (its lowest lane) by a shuffle
// tree of log2 of the group's size steps, so that a group makes one
// reduction, not one a lane. A warp also carries one hot row's sum across
// its tiles (carry_keeper): the first group of two or more equal rows it
// meets, and after that the largest group of a tile that has none of the
// carried row (the carry is then added to the gradient and restarts). A
// column whose ids fall on one row then costs one reduction per warp, not
// per tile.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace nvt {

constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kTreeSteps = 5;  // log2(32): the most a warp's group of equal rows takes

struct RowGroups {
  unsigned peers;  // the lanes whose row is this lane's (every lane that holds none, for those)
  bool leader;     // a held row's lowest lane: it makes its group's reduction
  // The tree's schedule: at step s a lane adds the partial sum of from[s],
  // its next higher peer still live (-1: none); the lanes of odd rank among
  // the live ones are then done, their sums taken by the lane below.
  int from[kTreeSteps];
  int steps;

  // held: the lane holds a row of the gradient (row >= 0).
  __device__ __forceinline__ RowGroups(bool held, int64_t row, int lane) {
    peers = __match_any_sync(kAllLanes, held ? row : int64_t{-1});
    const unsigned lower = peers & ((1u << lane) - 1u);
    leader = held && lower == 0;
    steps = 0;
    unsigned rest = held ? peers & (0xfffffffeu << lane) : 0u;
    unsigned rank = __popc(lower);
#pragma unroll
    for (int s = 0; s < kTreeSteps; ++s) {
      if (!__any_sync(kAllLanes, rest != 0)) break;
      from[s] = __ffs(rest) - 1;
      rest &= ~__ballot_sync(kAllLanes, held && (rank & 1u));
      rank >>= 1;
      steps = s + 1;
    }
  }

  // Each group's sum of v into its leader (the other lanes' values are then
  // partial sums), the same schedule for every entry of v.
  template <int K, int E>
  __device__ __forceinline__ void sum(float (&v)[K][E], int lane) const {
#pragma unroll
    for (int s = 0; s < kTreeSteps; ++s) {
      if (s < steps) {
        const int f = from[s];
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float t = __shfl_sync(kAllLanes, v[k][e], f < 0 ? lane : f);
            if (f >= 0) v[k][e] += t;
          }
        }
      }
    }
  }
};

// Which group joins the warp's carried row this tile.
struct Carry {
  int lane;         // the leader whose group's sum joins the carry (-1: none)
  int64_t row;      // the carried row from this tile on (-1: none)
  bool restart;     // the carry moved: its old sum is added to the gradient first
};

// carry_row: the warp's carried row (-1: none), the same in every lane.
__device__ __forceinline__ Carry carry_keeper(const RowGroups& g, int64_t row, int lane, int64_t carry_row) {
  const unsigned match = __ballot_sync(kAllLanes, g.leader && row == carry_row);
  Carry c{__ffs(match) - 1, carry_row, false};
  if (match == 0) {
    const unsigned best = __reduce_max_sync(kAllLanes, g.leader ? (__popc(g.peers) << 5) | lane : 0u);
    if ((best >> 5) >= 2) {
      c.restart = carry_row >= 0;
      c.lane = static_cast<int>(best & 31u);
      c.row = __shfl_sync(kAllLanes, row, c.lane);
    }
  }
  return c;
}

}  // namespace nvt
