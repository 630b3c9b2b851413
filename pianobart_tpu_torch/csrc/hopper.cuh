// Hopper (sm_90a) building blocks for the port's kernels: mbarriers, a CTA
// pair's distributed shared memory (cluster rank, mapa, remote stores and
// arrivals, the pair's sum), TMA tensor loads, wgmma shared-memory
// descriptors and products (bf16 and tf32), the 3xTF32 split, setmaxnreg,
// the async-proxy fence and named barriers, and on the host the tensor maps
// the flash kernels load through.
//
// Shared-memory tiles here are what a TMA load with 128-byte swizzle leaves:
// rows of 128 bytes (64 bf16), 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), 8-row atoms of 1024 bytes.  A tile that starts on a 1024-byte
// boundary is read by wgmma through a descriptor (smem_desc_sw128):
//   K-major (the product's k along the row): SBO = 1024 (the next 8 rows),
//     LBO unused; a k16 step adds 32 bytes to the start address.
//   MN-major (k down the rows, n along them; transpose bit set): SBO = 1024
//     (the next 8 k rows), LBO = the distance to the next 64 n columns (the
//     next 128-byte-wide box); a k16 step adds 16 rows = 2048 bytes.
//
// wgmma accumulator layout, per warp w of the warpgroup (rows 16w..16w+15),
// g = lane / 4, t = lane % 4: d[4j + e] is row g + 8 * (e >= 2), column
// 8j + 2t + (e & 1), the mma.sync C layout for each 8-column slice.  A from
// registers takes the mma.sync m16n8k16 A fragment of the warp's 16 rows
// (bf16) or the m16n8k8 one (tf32: a0 = A[g][t], a1 = A[g+8][t],
// a2 = A[g][t+4], a3 = A[g+8][t+4]).
//
// tf32 products (the f32 kernels, 3xTF32): wgmma reads tf32 operands from
// shared memory K-major only (the transpose bits are for 16-bit types), so
// an f32 tile is 128-byte rows of 32 values, a k8 step adding 32 bytes as a
// bf16 k16 step does.  Each f32 operand x is split into hi = x rounded to
// tf32 and lo = x - hi (exact in f32), and a product is three:
// hi.hi' + hi.lo' + lo.hi' (lo.lo' is below 2^-22 of it, and so is what
// the tensor cores drop of lo's own low 13 bits).
#pragma once
#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "flash_common.cuh"

namespace pbt {

constexpr int BOX = 64;                 // bf16 columns per 128-byte TMA box
constexpr int ROW = 2 * BOX;            // bytes per row of a box
constexpr int FBOX = 32;                // f32 columns per 128-byte TMA box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ clusters
// A cluster of two CTAs (the f32 kernels at D = 256 run one per 128-column
// half of the head): each CTA reaches the other's shared memory through
// shared::cluster addresses (mapa) and arrives on the other's mbarriers.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; orders shared-memory writes
// (the barriers' initialisation) before the other CTAs' later accesses
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// the shared::cluster address of the byte at `addr` (a shared::cta address
// of this CTA's layout) in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float a, float b, float c,
                                              float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

// arrive on an mbarrier of another CTA (addr from mapa), releasing this
// thread's earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(addr) : "memory");
}

// mbar_wait that acquires at cluster scope: what the other CTA wrote before
// its arrival is visible after
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// The sum across a CTA pair of accumulator parts that both CTAs hold for the
// same elements (each its own 128 columns' share of a product over D),
// through one 32 KB ring slot of each CTA that the products have finished
// reading (`slot`, at the same offset in both).  Thread `tid` of `threads`
// writers owns 16-byte chunks k * threads + tid (a warp's stores are
// consecutive), the same in both CTAs.  pair_open tells the peer that this
// CTA's slot is free (one arrival per warp on the peer's `ready`), waits for
// the peer's word and returns the peer slot's address; pair_put stores
// parts there; pair_close arrives on the peer's `full` (every writer) and
// waits on this CTA's; pair_add then adds the peer's parts.  Both CTAs add
// the same two numbers, so both hold the same sums to the bit.  `parity`
// is that of the exchange's index.
__device__ __forceinline__ uint32_t pair_open(unsigned char* slot, uint64_t* ready,
                                              uint32_t peer, uint32_t parity, bool lane0) {
  if (lane0) mbar_arrive_cluster(mapa(smem_u32(ready), peer));
  mbar_wait_cluster(ready, parity);
  return mapa(smem_u32(slot), peer);
}

template <int N>
__device__ __forceinline__ void pair_put(uint32_t dst, const float (&v)[N], int k0,
                                         int threads, int tid) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    st_cluster_v4(dst + ((k0 + k) * threads + tid) * 16, v[4 * k], v[4 * k + 1], v[4 * k + 2],
                  v[4 * k + 3]);
}

__device__ __forceinline__ void pair_close(uint64_t* full, uint32_t peer, uint32_t parity) {
  mbar_arrive_cluster(mapa(smem_u32(full), peer));
  mbar_wait_cluster(full, parity);
}

template <int N>
__device__ __forceinline__ void pair_add(float (&v)[N], const unsigned char* slot, int k0,
                                         int threads, int tid) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 w = *reinterpret_cast<const float4*>(slot + ((k0 + k) * threads + tid) * 16);
    v[4 * k] += w.x;
    v[4 * k + 1] += w.y;
    v[4 * k + 2] += w.z;
    v[4 * k + 3] += w.w;
  }
}

// ----------------------------------------------------------------------- TMA
// A box of a 4-D tensor map at coordinates (c0 innermost .. c3) into shared
// memory, completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// --------------------------------------------------------------------- wgmma
// Descriptor of a 128-byte-swizzled shared-memory operand (see the header).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p, uint32_t lbo_bytes) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;          // start address
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;   // leading byte offset
  d |= (uint64_t)(1024 >> 4) << 32;                   // stride byte offset
  d |= 1ull << 62;                                    // layout: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The same for A fragments in registers: fenced before the products that
// read them and again after the wait, so the compiler neither computes them
// late nor reuses their registers while a product still reads them.
template <int KS>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

// this thread's generic-proxy writes to shared memory made visible to the
// async proxy (wgmma's operand reads, TMA): after writing a tile that a
// product reads, before the barrier that hands it over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier ID (1..15; 0 is __syncthreads) over `threads` threads; the
// ID an immediate, so that ptxas reserves only the barriers a kernel names
template <int ID>
__device__ __forceinline__ void named_barrier_sync(int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "n"(ID), "r"(threads) : "memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A and B from shared memory, both
// K-major; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with B MN-major (the transpose bit: B's k runs down the rows, its
// n along them), as K^T lands for S = Q K^T
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A and B from shared memory, both
// K-major; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]; A from registers (per warp of 16
// rows, the mma.sync A fragment layout), B from shared memory MN-major (the
// transpose bit: B's k runs down the rows, its n along them)
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] (+)= A[64 x 8] . B[8 x 64] in tf32; A and B from shared memory,
// both K-major; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_tf32_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 8] . B[8 x 128] in tf32; A from registers (per warp
// of 16 rows, the m16n8k8 tf32 A fragment), B from shared memory K-major
__device__ __forceinline__ void wgmma_rs_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------------ 3xTF32
// x rounded to tf32 (10 mantissa bits, ties away from zero): the low 13
// bits of the result are 0.  ops/flash.py:_tf32_round is the same bit rule.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo exactly: hi = x rounded to tf32, lo = x - hi
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// f32 accumulators of a 64 x 8KS product (this thread's part, in the
// accumulator layout) as tf32 A fragments of hi and lo, k8 slice kk from
// v[4kk .. 4kk+3].  The accumulator holds columns 2t and 2t+1 of a slice,
// the A fragment columns t and t+4: column 2t is given as k = t and column
// 2t+1 as k = t+4, so within each 8 the fragment's k order is the columns
// 0 2 4 6 1 3 5 7, and the B operand's rows must come in that order too
// (pbt_tf32_split's transposed planes do).
template <int KS>
__device__ __forceinline__ void split_acc_tf32(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4],
                                               const float (&v)[4 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    tf32_split(v[4 * kk], hi[kk][0], lo[kk][0]);       // (g, 2t)     as k = t
    tf32_split(v[4 * kk + 2], hi[kk][1], lo[kk][1]);   // (g + 8, 2t)
    tf32_split(v[4 * kk + 1], hi[kk][2], lo[kk][2]);   // (g, 2t + 1) as k = t + 4
    tf32_split(v[4 * kk + 3], hi[kk][3], lo[kk][3]);   // (g + 8, 2t + 1)
  }
}

// split_acc_tf32's inverse: v = hi + lo, which is exactly the f32 value
// that was split
template <int KS>
__device__ __forceinline__ void join_acc_tf32(float (&v)[4 * KS], const uint32_t (&hi)[KS][4],
                                              const uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    v[4 * kk] = __uint_as_float(hi[kk][0]) + __uint_as_float(lo[kk][0]);
    v[4 * kk + 2] = __uint_as_float(hi[kk][1]) + __uint_as_float(lo[kk][1]);
    v[4 * kk + 1] = __uint_as_float(hi[kk][2]) + __uint_as_float(lo[kk][2]);
    v[4 * kk + 3] = __uint_as_float(hi[kk][3]) + __uint_as_float(lo[kk][3]);
  }
}

// ------------------------------------------------------- host: tensor maps
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// what a C entry returns for a tensor map the driver refused: this plus its
// CUresult (this alone where the driver offers no encoder)
constexpr int TMAP_ERROR = 1000;

// cuTensorMapEncodeTiled lives in the driver (libcuda); the runtime hands
// out its address, so a library links nothing beyond the runtime.
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, H, D) bf16 at element strides (sb, ss, sh) as a 4-D map over
// (D, H, S, B); a box is 64 columns of `rows` rows of one head, swizzled (a
// row of D columns takes D / 64 boxes).  Rows past S arrive as zeros.
inline CUresult qkv_map(EncodeTiled enc, CUtensorMap* m, const void* p, int B, int S, int H,
                        long long sb, long long ss, long long sh, int rows, int D) {
  if (H == 1) sh = D;          // an axis of size 1 is addressed by no stride:
  if (B == 1) sb = ss * S;     // give it the packed one
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// K^T, (B, H*D, Skv) bf16 with Skv contiguous, at element strides (sb,
// sh, sd) for the batch, the head (D d rows) and the d row, as a 4-D map
// over (Skv, D, H, B); a box is 64 kv columns of the D d rows of one head
// (D <= 256, TMA's longest box side), swizzled.  Keys past Skv arrive as
// zeros.
inline CUresult kt_map(EncodeTiled enc, CUtensorMap* m, const void* p, int B, int Skv, int H,
                       long long sb, long long sh, long long sd, int D) {
  if (H == 1) sh = sd * D;   // axes of size 1: the packed stride
  if (B == 1) sb = sh * H;
  const cuuint64_t dims[4] = {(cuuint64_t)Skv, (cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sd * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {BOX, (cuuint32_t)D, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A packed (rows_total, n) array of 4-byte elements as a 2-D map; a box is
// `box` consecutive elements of one row.  The (B, Skv) int32 kv mask (rows =
// samples) and the (B, H, Sq) f32 lse and delta (rows = (b, h) pairs).
inline CUresult rows_map(EncodeTiled enc, CUtensorMap* m, const void* p, int rows_total,
                         int n, int box, CUtensorMapDataType type) {
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows_total};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t boxes[2] = {(cuuint32_t)box, 1};
  const cuuint32_t one[2] = {1, 1};
  return enc(m, type, 2, const_cast<void*>(p), dims, strides, boxes, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The split planes of pbt_tf32_split, (2, B*H, rows, cols) f32 packed
// (hi, then lo), as a 4-D map over (cols, rows, B*H, 2); a box is 32
// columns of `box_rows` rows of one (b, h) and one plane, swizzled.
// Natural planes: rows = S, cols = D; transposed: rows = D, cols = S.
// Rows past `rows` arrive as zeros.
inline CUresult plane_map(EncodeTiled enc, CUtensorMap* m, const void* p, int BH, int rows,
                          int cols, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)BH, 2};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 4, (cuuint64_t)rows * cols * 4,
                                 (cuuint64_t)BH * rows * cols * 4};
  const cuuint32_t box[4] = {FBOX, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(p), dims, strides, box,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

inline CUresult mask_map(EncodeTiled enc, CUtensorMap* m, const void* p, int B, int Skv,
                         int box) {
  return rows_map(enc, m, p, B, Skv, box, CU_TENSOR_MAP_DATA_TYPE_INT32);
}

// ------------------------------------------------------ host: a pair launch
// `kernel` on `grid` (gridDim.x even) as clusters of two CTAs along x, so
// that CTAs 2i and 2i + 1 run at once, on SMs of one GPC, with each other's
// shared memory in reach; returns the launch's error.
template <typename... Params, typename... Args>
inline cudaError_t launch_pair(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                               cudaStream_t st, Args&&... args) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();   // also clears e, reported here
  return e != cudaSuccess ? e : last;
}

}  // namespace pbt
