// Pieces shared by the flash forward (flash_fwd.cu, flash_fwd_bf16.cuh),
// backward (flash_bwd.cu) and lab (flash_lab.cu) kernels: constants, bf16
// packing, accumulators as A fragments, exp2.
//
// Head widths: the kernels take every D = 128 n up to the type's
// MAX_HEAD_DIM.  Each
// kernel has its width as a template parameter or a constant of its own
// design (the shared-memory layouts and accumulator sizes follow from it);
// the C entries take D at run time and pick the instance.  D = 128 and 256
// have instances of their own; wider heads run clusters that sum the
// products over D across the cluster (hopper.cuh): the bf16 kernels as
// ceil(D / 256) CTAs of their D = 256 designs (their WIDE instances, up to
// 16 CTAs at D = 4096), the f32 forward and backward as wide kernels of
// their own, D / 128 CTAs of 128 columns (up to 16 at D = 2048).  16 CTAs
// is H100's largest cluster (a non-portable size), hence the limits.
//
// Fragment layout of a warp's 16 rows (g = lane / 4, t = lane % 4), the
// mma.sync m16n8k16 one, which wgmma keeps for its accumulators and for A
// from registers:
//   A 16x16 row-major: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                      a3 = A[g+8][2t+8..]
//   C 16x8:            c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pbt {

constexpr float NEG_INF = -1e30f;
// the widest head of each type, 16 CTAs a cluster: bf16 of 256 columns,
// f32 of 128
constexpr int MAX_HEAD_DIM_BF16 = 4096;
constexpr int MAX_HEAD_DIM_F32 = 2048;

// D = 128 n with n = 1 .. 32 (bf16, dtype 1) or 1 .. 16 (f32, dtype 0)
inline bool head_dim_taken(int D, int dtype) {
  return D % 128 == 0 && D >= 128 && D <= (dtype == 1 ? MAX_HEAD_DIM_BF16 : MAX_HEAD_DIM_F32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment from f32 accumulators c[2kk], c[2kk+1] (a 16x16 slab of C),
// rounded to bf16: the product C . X with C kept in registers.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The n-th 128-column half of a 64-row wgmma accumulator of N/2 columns
// (d[4j + e] holds column 8j + 2t + (e & 1), so each 128 columns are a
// contiguous run of 64): the accumulator of one m64n128 product of a
// 256-wide result.
template <int N>
__device__ __forceinline__ float (&acc_half(float (&acc)[N], int n))[64] {
  return *reinterpret_cast<float(*)[64]>(acc + 64 * n);
}

// 2^x by the special-function unit (ex2.approx, flush-to-zero): the
// exp2-domain softmax's one instruction per score after the FFMA.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace pbt
