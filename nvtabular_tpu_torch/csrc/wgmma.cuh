// Hopper's warpgroup matrix products (wgmma, sm_90a only), shared by the
// kernels that run on the tensor cores: K13d's 16-bit CIN kernels (cin.cu)
// and the MLP and cross-layer products K21 (mlp_mm.cu).
//
// K13d's operands lie in shared memory as the canonical no-swizzle layout:
// 8 x 8 core matrices of 128 contiguous bytes (8 rows of 16 bytes), those
// along K `lead` bytes apart (the descriptor's leading offset) and those
// along M or N `stride` bytes apart (its stride offset); K21's in the
// 128-byte swizzle (gmma_desc_sw128). The encodings were checked on the card
// against plain products (cin.cu's kernels, K21's tests).
//
// The accumulator of m64nNk16 in float32: a thread of the warpgroup holds
// N / 2 sums, d[4 j + e] at row 16 (warp % 4) + lane / 4 + 8 (e / 2) and
// column 8 j + 2 (lane % 4) + e % 2 of the 64 x N tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "async.cuh"

namespace nvt {

// The matrix descriptor of an operand tile at p in shared memory (no swizzle).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lead = 128, uint32_t stride = 512) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) | (static_cast<uint64_t>(stride >> 4) << 32);
}

// The matrix descriptor of an operand tile at p in the 128-byte swizzle (p 1024-byte aligned or a k16 slice's
// offset from such a tile). K-major: lead 16 (unused), stride 1024 between 8-row atoms. MN-major: lead between
// 64-wide atoms along MN, stride between 8-deep groups along K (CUTLASS's canonical layouts).
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* p, uint32_t lead, uint32_t stride) {
  return gmma_desc(p, lead, stride) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
// waits until at most N of the warpgroup's product groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// this thread's writes to shared memory (stores and landed cp.async copies) visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// keeps the compiler from moving the sums' registers while a product is in flight
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define NVT_WGMMA_REGS                                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "  \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define NVT_WGMMA_OUTS                                                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),         \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),          \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),         \
      "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),         \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),         \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),         \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d += A B over one k16 slice: A 64 x 16 (kTransA: MN-major), B 16 x 128 (kTransB: MN-major), T bfloat16 or
// float16, d in float32
template <class T, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NVT_WGMMA_REGS
                 ", %64, %65, p, 1, 1, %66, %67;\n}\n"
                 : NVT_WGMMA_OUTS
                 : "l"(da), "l"(db), "n"(kTransA), "n"(kTransB));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " NVT_WGMMA_REGS
                 ", %64, %65, p, 1, 1, %66, %67;\n}\n"
                 : NVT_WGMMA_OUTS
                 : "l"(da), "l"(db), "n"(kTransA), "n"(kTransB));
  }
}

// d += A B over one k16 slice in bfloat16: A 64 x 16 (kTA: MN-major), B 16 x 64 (kTB: MN-major)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma64_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
               "%32, %33, p, 1, 1, %34, %35;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
               : "l"(da), "l"(db), "n"(kTA), "n"(kTB));
}

// d += A B over one k16 slice in bfloat16: A 64 x 16 (kTA: MN-major), B 16 x 256 (kTB: MN-major)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma256_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
               "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
               "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
               "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
               "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
               "%128, %129, p, 1, 1, %130, %131;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
                 "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
                 "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
                 "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
                 "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
                 "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
                 "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
                 "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
                 "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
                 "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
                 "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
                 "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
                 "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
               : "l"(da), "l"(db), "n"(kTA), "n"(kTB));
}

}  // namespace nvt
