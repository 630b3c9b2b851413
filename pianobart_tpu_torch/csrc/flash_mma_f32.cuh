// The f32 flash kernels at head width 256 (flash_fwd.cu, flash_bwd.cu):
// 3xTF32 products by mma.sync m16n8k8 on f32 tiles in shared memory.
//
// At D = 256 the 3xTF32 wgmma designs of D = 128 do not fit a CTA (an
// operand's hi and lo planes take 128 KB at 64 rows), so these kernels
// keep plain f32 rows in shared memory and split each fragment into tf32
// hi and lo as a warp loads it (hopper.cuh:tf32_split): no prep, and every
// product is lo.hi' + hi.lo' + hi.hi' into a zeroed partial that is added
// to its sum in f32.  A warp owns 16 rows; the fragments are mma.sync's:
//   A (16 x 8)  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8)   b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8)  c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// (g = lane / 4, t = lane % 4): C is a wgmma accumulator's 8-column slice,
// so the wgmma kernels' softmax and split_acc_tf32's fragment order apply.
// Rows are M_LD = 260 floats apart, so that the loads of a fragment fall
// in 32 distinct banks: 4g + t where a row is indexed by g, 8t + g where by
// 2t (the rows of a B read in split_acc_tf32's k order).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace pbt {

constexpr int M_D = 256;                 // the head width of these designs
constexpr int M_LD = M_D + 4;            // floats per row in shared memory

// D[16 x 8] += A[16 x 8] . B[8 x 8] in tf32 by mma.sync m16n8k8 (the
// pre-wgmma tensor-core product; per warp, fragments in registers): A
// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; B
// b0 = B[t][g], b1 = B[t+4][g]; C as a wgmma accumulator's 8-column slice.
__device__ __forceinline__ void mma_tf32_m16n8k8(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A . B at f32 accuracy (3xTF32) from A's hi and lo fragments and
// B's (hi, lo) pairs: lo.hi' + hi.lo' + hi.hi' into a zeroed partial (the
// small terms first), which is then added to acc in f32, so the tensor
// cores' rounding never sees more than one k8 step of a long sum.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_m16n8k8(p, al, bh0, bh1);
  mma_tf32_m16n8k8(p, ah, bl0, bl1);
  mma_tf32_m16n8k8(p, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += p[i];
}

// rows r0 .. r0 + n - 1 of one head of a (B, S, H, 256) f32 array (`src` at
// its (b, h), rows `ss` apart) into `dst` (rows M_LD apart); rows past S
// as zeros.  16 bytes a thread a step, all `nthreads` threads.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src,
                                              long long ss, int r0, int n, int S,
                                              int nthreads) {
  for (int i = threadIdx.x; i < n * (M_D / 4); i += nthreads) {
    const int r = i / (M_D / 4), c = 4 * (i % (M_D / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = *reinterpret_cast<const float4*>(src + (r0 + r) * ss + c);
    *reinterpret_cast<float4*>(dst + r * M_LD + c) = x;
  }
}

// tf32 hi and lo of the A fragment of rows g, g + 8 and k columns t, t + 4
// of a row-major tile in shared memory (a points at row g, column t)
__device__ __forceinline__ void a_frag_3x(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                          const float* a) {
  tf32_split(a[0], hi[0], lo[0]);
  tf32_split(a[8 * M_LD], hi[1], lo[1]);
  tf32_split(a[4], hi[2], lo[2]);
  tf32_split(a[8 * M_LD + 4], hi[3], lo[3]);
}

// acc[nt] += A . B^T for NT n8 tiles, B row-major with the product's k
// along its rows (b at row g of the first tile, column t): b0 = B[n=g][k=t],
// b1 = B[g][t + 4]
template <int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const float* b) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t h0, l0, h1, l1;
    tf32_split(b[nt * 8 * M_LD], h0, l0);
    tf32_split(b[nt * 8 * M_LD + 4], h1, l1);
    mma_3xtf32(acc[nt], ah, al, h0, h1, l0, l1);
  }
}

// acc[nt] += X . B for NT n8 tiles of B (k rows, n columns, row-major in
// shared memory), X's k8 slice given as one 8-column slice x of an
// accumulator (this thread's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1)) and split here into hi and lo A fragments as split_acc_tf32
// does: fragment column t is the accumulator's 2t, t + 4 its 2t + 1, so
// B's rows are read in that order (b points at row 2t, column g).
template <int NT>
__device__ __forceinline__ void mma_acc_b(float (&acc)[NT][4], const float (&x)[4],
                                          const float* b) {
  uint32_t xh[4], xl[4];
  tf32_split(x[0], xh[0], xl[0]);
  tf32_split(x[2], xh[1], xl[1]);
  tf32_split(x[1], xh[2], xl[2]);
  tf32_split(x[3], xh[3], xl[3]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t h0, l0, h1, l1;
    tf32_split(b[nt * 8], h0, l0);
    tf32_split(b[nt * 8 + M_LD], h1, l1);
    mma_3xtf32(acc[nt], xh, xl, h0, h1, l0, l1);
  }
}

}  // namespace pbt
