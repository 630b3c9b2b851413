// Pieces shared by the flash forward (flash_fwd.cu), backward (flash_bwd.cu)
// and lab (flash_lab.cu) kernels: constants, bf16 packing, accumulators as
// A fragments, exp2, and the lab's mma.sync m16n8k16 product, 16-byte tile
// load into padded shared memory and transposed fragment load.
//
// mma.sync.m16n8k16 fragment layout (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                      a3 = A[g+8][2t+8..]
//   B 16x8 col-major:  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C 16x8:            c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pbt {

constexpr int HEAD_DIM = 128;
constexpr float NEG_INF = -1e30f;
constexpr int LDS = HEAD_DIM + 8;   // smem row pitch (bf16): no bank conflicts

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of a row-major smem tile T (pitch LDS); p = &T[row0 + g][k0 + 2t]
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* p) {
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
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

// B = T^T for a row-major smem tile T whose rows are B's columns (n) and
// whose columns are B's k: p = &T[n0 + g][k0 + 2t]
__device__ __forceinline__ void mma_bt(float c[4], const uint32_t a[4],
                                       const __nv_bfloat16* p) {
  mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(p),
           *reinterpret_cast<const uint32_t*>(p + 8));
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way:
// lane l gives the address of row l % 8 of matrix l / 8 (16 B aligned), and
// r[i] receives M_i[2t][g] (low half) and M_i[2t+1][g] of matrix i.  For a
// row-major smem tile T whose rows are a product's k and whose columns are
// its n, that is the mma.sync B fragment (b0 or b1) of an 8-wide n slice.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 2^x by the special-function unit (ex2.approx, flush-to-zero): the
// exp2-domain softmax's one instruction per score after the FFMA.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows x 128 bf16 tile from (row stride ss) global memory into smem, 16 B a thread
template <int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long ss, int rows) {
  constexpr int CHUNKS = HEAD_DIM / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDS + c) =
        *reinterpret_cast<const uint4*>(src + r * ss + c);
  }
}

}  // namespace pbt
