// K1's bf16 flash forward for Hopper (sm_90a) as one kernel template,
// flash_fwd_wgmma_kernel<KT, SPLIT_P, D>: K1 itself (flash_fwd.cu) is
// <false, false, 128>, and the kernel lab (flash_lab.cu) changes one option
// of it at a time, so that the lab measures the option and nothing else.
// The template is at head width D = 128; K1 at D = 256 is a kernel of its
// own design, flash_fwd_d256.cuh, which also runs D = 384 .. 1024 as
// clusters of its CTAs.
//
// Contract (K1's): q, k, v (B, S, H, D) bf16 through their strides, q
// pre-scaled by the caller; kv_mask (B, Skv) int32, nonzero = attend; causal
// keeps row >= col; o (B, Sq, H, D) bf16 contiguous; lse (B, H, Sq) f32.
// Masked scores are the finite -1e30 (not -inf), so fully masked rows stay
// finite; l == 0 is guarded (l_safe).
//
// Design: one CTA per (128-row q tile, head, batch) with two consumer
// warpgroups of 64 q rows each and one producer warpgroup.  One producer
// thread loads Q once and K, V and the kv mask tile by tile with TMA
// (cp.async.bulk.tensor over 4-D maps with the caller's strides, 128-byte
// swizzle, each 128-wide tile as two 64-column boxes) into a ring of 3
// stages of 128 kv rows (225 KB of shared memory with Q); per stage one
// mbarrier reports K and the mask, one V, and one collects the consumer
// warps' release.  The consumers run S = Q K^T as wgmma m64n128k16 with both
// operands in shared memory, mask with selects (the causal mask only on
// tiles the diagonal crosses) and update the online softmax in registers
// (exp2 by FFMA + ex2, the max kept in the score domain so the -1e30
// sentinel cancels exactly), turn P into bf16 A fragments and run O += P V
// as wgmma m64n128k16 with P from registers and V from shared memory
// through the transpose bit.  Inside a warpgroup, S of tile j is issued
// before O += P V of tile j-1, so tile j's softmax runs under that product.
// setmaxnreg moves registers from the producer (24) to the consumers (240).
// Keys past Skv in a ragged last tile arrive as TMA's zeros and take p = 0;
// rows past Sq are not stored.  No atomics: the same inputs give the same
// bits.
//
// The template's options (the TPU lab's, scripts/kernel_lab.py):
//   KT       K arrives as K^T, (B, H*128, Skv) with Skv contiguous (the
//            lab's L1).  A stage is two boxes of 64 kv columns by the 128 d
//            rows of one head, and S = Q K^T reads it MN-major through the
//            transpose bit, as O += P V reads V: SBO 1024, LBO 16 KB to the
//            next box, 2048 bytes (16 d rows) a k16 step.  The stage is 32 KB
//            as K's is; a box wholly past Skv (Skv 64 past a multiple of
//            128) is not loaded, and the mask's zero fill masks its keys.
//   SPLIT_P  "f32 operands" (L2, and L1 with upcast).  bf16 x bf16 products
//            are exact in f32, so Q K^T already equals the upcast product up
//            to summation order; only P V differs, where the upcast keeps P
//            in f32.  P is split into hi = bf16(p) and lo = bf16(p - hi), and
//            each k16 step of O += P V issues two wgmma, hi then lo, into the
//            same accumulator: about 16 bits of P.  Without it P rounds to
//            bf16 as in K1.
// and at run time (SoftmaxUnits):
//   c        scores times c are in log2 units: log2 e, or 1 where Q is
//            scaled so.  p = 2^(s*c - m*c), the max m kept in the score
//            domain; while a row has no kept key (m = -1e30) c is 0 there,
//            so that p = 1 as in the plain version (s*c - round(m*c) would
//            leave the product's rounding, ~1e23 at that size, in the
//            exponent).
//   lse_log2 the lse as m*c + log2 l, with a fully masked row's m left at
//            the -1e30 sentinel (the lab's exp2-domain softmax); else, as
//            K1, m + ln l.
//   q_log2e_bf16  the TPU lab's bf16 log2(e) under exp2 without upcast:
//            log2 e rounds to bf16 1.4453125 and q * that to bf16.  Each
//            consumer warpgroup scales its 64 rows of the Q tile so in
//            shared memory (one rounding: the f32 product of two bf16 values
//            is exact), then fences the async proxy and meets its 128
//            threads at a named barrier before its first wgmma; c = 1.  That
//            variant computes a softmax of 1.0018*s, as the reference lab
//            does.
//
// Bound at B=32, S=1024, H=8 (the smoke run's pad tail): 4*B*H*Sq*Skv*D
// FLOPs over the kept (row, key) pairs at 989 TFLOP/s bf16, 0.1381 ms; the
// q/k/v/o bytes take a fifth of that at 3.35 TB/s, so the kernel is bound
// by operations, i.e. by how fully it keeps the tensor cores busy.  SPLIT_P's
// third product is its own extra cost, not the function's.  Left on the
// table: ping-pong scheduling of the two consumer warpgroups, a persistent
// schedule, a TMA store of O, clusters with TMA multicast of K and V.
#pragma once
#include "flash_common.cuh"
#include "hopper.cuh"

namespace pbt {

constexpr int K1_WG = 2;                // consumer warpgroups, 64 q rows each
constexpr int K1_BM = 64 * K1_WG;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LOG2E_BF16 = 1.4453125f;   // bf16(log2 e)

// kv rows per stage and stages at head width D
template <int D>
struct K1Tiles {
  static_assert(D == 128, "the template's head width; D = 256 is flash_fwd_d256.cuh");
  static constexpr int BN = 128;
  static constexpr int STAGES = 3;
};
constexpr int K1_BN = K1Tiles<128>::BN;   // the lab's (D = 128) kv rows per stage

// Shared memory, in bytes from a 1024-aligned base (the swizzle atom).
template <int D>
struct K1Smem {
  static constexpr int BM = K1_BM, BN = K1Tiles<D>::BN, NS = K1Tiles<D>::STAGES;
  static constexpr int Q = 0;                                   // D/64 boxes of BM rows
  static constexpr int K = Q + BM * 2 * D;                      // per stage D/64 boxes of BN rows
  static constexpr int V = K + NS * BN * 2 * D;
  static constexpr int MASK = V + NS * BN * 2 * D;              // per stage BN int32
  static constexpr int BAR = MASK + NS * BN * 4;                // Q, K[S], V[S], free[S]
  static constexpr int ALLOC = BAR + (1 + 3 * NS) * 8 + 1024;
};

// The run-time options of the lab's instances (see the header); K1's
// instance <false, false> runs with K1_UNITS, folded in at compile time.
struct SoftmaxUnits {
  float c;             // scores times c are in log2 units
  int lse_log2;        // lse = m*c + log2 l (else m + ln l)
  int q_log2e_bf16;    // Q scaled to bf16(q * 1.4453125) in shared memory
};
constexpr SoftmaxUnits K1_UNITS = {LOG2E, 0, 0};

// P's A fragments: hi = bf16(p) always, lo = bf16(p - hi) under SPLIT_P
template <bool SPLIT_P, int BN>
struct PFrags {
  uint32_t hi[BN / 16][4];
  uint32_t lo[SPLIT_P ? BN / 16 : 1][4];
};

// S = Q K^T for one kv tile: D/16 k16 steps over the head dim, one
// m64n128k16 each, issued and committed, not waited for.  K: K-major, 4
// steps in each 64-column box; K^T (KT): MN-major, 16 d rows a step.
template <bool KT, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[K1Tiles<D>::BN / 2], uint64_t dq,
                                         const unsigned char* kt) {
  constexpr int BN = K1Tiles<D>::BN;
  const uint64_t dk = smem_desc_sw128(kt, KT ? D * ROW : 16);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = dq + ((kk / 4) * K1_BM * ROW + (kk % 4) * 32) / 16;
    if constexpr (KT)
      wgmma_ss_n128_tb(sc, da, dk + kk * 16 * ROW / 16, kk > 0);
    else
      wgmma_ss_n128(sc, da, dk + ((kk / 4) * BN * ROW + (kk % 4) * 32) / 16, kk > 0);
  }
  wgmma_commit();
}

// O += P V for one kv tile (hi, then lo under SPLIT_P, at each k16 step);
// V's tile is MN-major for this product (d along its rows), one m64n128k16
// for each 128 columns of the head (its two boxes: LBO to the next box);
// issued and committed, not waited for
template <bool SPLIT_P, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const PFrags<SPLIT_P, K1Tiles<D>::BN>& p,
                                         const unsigned char* vt) {
  constexpr int BN = K1Tiles<D>::BN;
  const uint64_t dv = smem_desc_sw128(vt, BN * ROW);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < D / 128; ++n) {
      const uint64_t db = dv + (n * 2 * BN * ROW + kk * 16 * ROW) / 16;
      wgmma_rs_n128_tb(acc_half(acc, n), p.hi[kk], db);
      if constexpr (SPLIT_P) wgmma_rs_n128_tb(acc_half(acc, n), p.lo[kk], db);
    }
  }
  wgmma_commit();
}

// Masks (the causal one, DIAG, only where the diagonal crosses the
// warpgroup's rows; selects, no branches), then the online-softmax update
// of rows `row` and `row + 8`: sc becomes p, and corr the factor for the O
// accumulated so far.
template <bool DIAG, int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], const int* mk,
                                             float (&m_i)[2], float (&l_i)[2],
                                             float (&corr)[2], int row, int kv0, int Skv,
                                             int t, float c) {
  const bool ragged = kv0 + BN > Skv;               // keys past Skv: TMA's zeros
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    const int2 keep = *reinterpret_cast<const int2*>(mk + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool kp = ((e & 1) ? keep.y : keep.x) != 0;
      if (DIAG) kp &= row + (e >= 2 ? 8 : 0) - (kv0 + col + (e & 1)) >= 0;
      sc[4 * nt + e] = kp ? sc[4 * nt + e] : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * nt + e]);
    }
  }
  float cl[2], ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_i[r], mx[r]);
    corr[r] = exp2_approx((m_i[r] - m_new) * c);
    // p = 2^(s*c - m*c): with no kept key so far (m_new the sentinel)
    // c = 0 gives p = 1 exactly, as exp(s - m) does in the reference
    cl[r] = m_new == NEG_INF ? 0.f : c;
    ml[r] = m_new * cl[r];
    m_i[r] = m_new;
    l_i[r] *= corr[r];
  }
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = sc[4 * nt + e];
      x = exp2_approx(fmaf(x, cl[e >> 1], -ml[e >> 1]));
      if (ragged && kv0 + nt * 8 + 2 * t + (e & 1) >= Skv) x = 0.f;
      l_i[e >> 1] += x;
    }
  }
}

// (hi, lo) bf16 pairs of two f32 values: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo, float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// p as the A fragments of O += P V: rounded to bf16, or split (SPLIT_P)
template <bool SPLIT_P, int BN>
__device__ __forceinline__ void pack_p(PFrags<SPLIT_P, BN>& p, const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const float* lo = &sc[8 * kk];
    const float* hi = &sc[8 * kk + 4];
    if constexpr (SPLIT_P) {
      split_bf16(p.hi[kk][0], p.lo[kk][0], lo[0], lo[1]);
      split_bf16(p.hi[kk][1], p.lo[kk][1], lo[2], lo[3]);
      split_bf16(p.hi[kk][2], p.lo[kk][2], hi[0], hi[1]);
      split_bf16(p.hi[kk][3], p.lo[kk][3], hi[2], hi[3]);
    } else {
      acc_to_a(p.hi[kk], lo, hi);
    }
  }
}

// bf16(q * 1.4453125) in place over this warpgroup's 64 rows of both of
// Q's boxes (the lab's, D = 128) (16 bytes a thread per step; elementwise, so the swizzle does
// not matter), then visible to wgmma: the async-proxy fence and the
// warpgroup's 128 threads at named barrier 1 + wg
__device__ __forceinline__ void scale_q_log2e_bf16(unsigned char* q_tile, int wg, int tid) {
  constexpr int CHUNKS = 64 * ROW / 16;   // per box and warpgroup
#pragma unroll
  for (int n = 0; n < 2 * CHUNKS / 128; ++n) {
    const int i = tid + 128 * n;
    uint4* chunk = reinterpret_cast<uint4*>(q_tile + (i / CHUNKS) * K1_BM * ROW +
                                            wg * 64 * ROW) + i % CHUNKS;
    uint4 x = *chunk;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * LOG2E_BF16, f.y * LOG2E_BF16);
    }
    *chunk = x;
  }
  fence_proxy_async();
  static_assert(K1_WG == 2, "one named barrier per consumer warpgroup");
  if (wg == 0)
    named_barrier_sync<1>(128);
  else
    named_barrier_sync<2>(128);
}

template <bool KT, bool SPLIT_P, int D>
__global__ void __launch_bounds__(128 * (K1_WG + 1), 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tm,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Skv, int H, int causal, SoftmaxUnits u) {
  using L = K1Smem<D>;
  constexpr int NWG = K1_WG;
  constexpr int BM = L::BM, BN = L::BN, NS = L::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* bar_k = bar_q + 1;          // K tile and mask of stage s landed
  uint64_t* bar_v = bar_k + NS;         // V tile of stage s landed
  uint64_t* bar_free = bar_v + NS;      // stage s read by every consumer warp

  // K1's own instance takes K1_UNITS as constants, so that its code is the
  // one it had before the lab shared it (the run-time units cost it 2-4%)
  constexpr bool LAB = KT || SPLIT_P;
  const float c = LAB ? u.c : LOG2E;
  const bool lse_log2 = LAB && u.lse_log2;
  const bool q_log2e_bf16 = LAB && u.q_log2e_bf16;
  static_assert(!LAB || D == 128, "the lab's instances are at D = 128");
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  int n_tiles = (Skv + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);  // skip tiles above the diagonal

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_k + s, 1);
      mbar_init(bar_v + s, 1);
      mbar_init(bar_free + s, 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * NWG) {
      mbar_arrive_expect_tx(bar_q, BM * 2 * D);
#pragma unroll
      for (int x = 0; x < D / BOX; ++x)
        tma_load_4d(sm + L::Q + x * BM * ROW, &tq, bar_q, x * BOX, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS, kv0 = j * BN;
        mbar_wait(bar_free + s, ((j / NS) & 1) ^ 1);   // the first round passes
        unsigned char* kt = sm + L::K + s * BN * 2 * D;
        unsigned char* vt = sm + L::V + s * BN * 2 * D;
        if constexpr (KT) {
          // K^T: 64 kv columns of the 128 d rows a box.  A box wholly past
          // Skv is not loaded: its columns of S are masked (the mask's zero
          // fill) and take p = 0 whatever they hold.
          const bool second = kv0 + BOX < Skv;
          mbar_arrive_expect_tx(bar_k + s, (second ? 2 : 1) * D * ROW + BN * 4);
          tma_load_4d(kt, &tk, bar_k + s, kv0, 0, h, b);
          if (second) tma_load_4d(kt + D * ROW, &tk, bar_k + s, kv0 + BOX, 0, h, b);
        } else {                      // K: 64 d columns of the BN kv rows a box
          mbar_arrive_expect_tx(bar_k + s, BN * 2 * D + BN * 4);
#pragma unroll
          for (int x = 0; x < D / BOX; ++x)
            tma_load_4d(kt + x * BN * ROW, &tk, bar_k + s, x * BOX, h, kv0, b);
        }
        tma_load_2d(sm + L::MASK + s * BN * 4, &tm, bar_k + s, kv0, b);
        mbar_arrive_expect_tx(bar_v + s, BN * 2 * D);
#pragma unroll
        for (int x = 0; x < D / BOX; ++x)
          tma_load_4d(vt + x * BN * ROW, &tv, bar_v + s, x * BOX, h, kv0, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64*wg .. +63.  S of tile j is
    // issued before O += P V of tile j-1, so tile j's softmax runs while
    // the tensor cores do tile j-1's second product.
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int wrow0 = q0 + wg * 64;
    const int row = wrow0 + warp * 16 + lane / 4;   // this thread's rows: row, row + 8
    const uint64_t dq = smem_desc_sw128(sm + L::Q + wg * 64 * ROW, 16);
    auto k_tile = [&](int s) { return sm + L::K + s * BN * 2 * D; };
    auto v_tile = [&](int s) { return sm + L::V + s * BN * 2 * D; };
    auto m_tile = [&](int s) { return reinterpret_cast<const int*>(sm + L::MASK + s * BN * 4); };

    float acc[D / 2];                                // O, 64 rows x D per warpgroup
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_i[2] = {NEG_INF, NEG_INF};               // score domain
    float l_i[2] = {0.f, 0.f};                       // this thread's partial row sums
    float sc[BN / 2], corr[2];
    PFrags<SPLIT_P, BN> pa;                          // P as A fragments

    mbar_wait(bar_q, 0);
    if constexpr (LAB)
      if (q_log2e_bf16) scale_q_log2e_bf16(sm + L::Q, wg, tid);
    mbar_wait(bar_k, 0);
    issue_qk<KT, D>(sc, dq, k_tile(0));
    wgmma_wait<0>();
    fence_regs(sc);
    // the causal mask where the diagonal crosses this warpgroup's rows
    auto softmax = [&](int s, int kv0) {
      if (causal && kv0 + BN - 1 > wrow0)
        softmax_tile<true, BN>(sc, m_tile(s), m_i, l_i, corr, row, kv0, Skv, t, c);
      else
        softmax_tile<false, BN>(sc, m_tile(s), m_i, l_i, corr, row, kv0, Skv, t, c);
    };
    softmax(0, 0);
    pack_p(pa, sc);
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % NS, sp = (j - 1) % NS;
      mbar_wait(bar_k + s, (j / NS) & 1);
      issue_qk<KT, D>(sc, dq, k_tile(s));
      mbar_wait(bar_v + sp, ((j - 1) / NS) & 1);
      fence_regs(acc);
      issue_pv<SPLIT_P, D>(acc, pa, v_tile(sp));
      wgmma_wait<1>();                               // S of tile j is in
      fence_regs(sc);
      softmax(s, j * BN);
      fence_regs(sc);                                // p computed before the wait
      wgmma_wait<0>();                               // O of tile j-1 is in
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bar_free + sp);     // stage j-1 may be refilled
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[4 * dt] *= corr[0]; acc[4 * dt + 1] *= corr[0];
        acc[4 * dt + 2] *= corr[1]; acc[4 * dt + 3] *= corr[1];
      }
      pack_p(pa, sc);
    }
    const int last = (n_tiles - 1) % NS;
    mbar_wait(bar_v + last, ((n_tiles - 1) / NS) & 1);
    fence_regs(acc);
    issue_pv<SPLIT_P, D>(acc, pa, v_tile(last));
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: full row sums, normalise, store O and lse for rows < Sq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
      if (l_i[r] == 0.f) l_i[r] = 1.f;  // l_safe
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      if (rr >= Sq) continue;
      __nv_bfloat16* orow = o + (((long long)b * Sq + rr) * H + h) * D;
      const float inv = 1.f / l_i[r];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
            pack_bf16(acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
      if (t == 0) {   // a fully masked row keeps the -1e30 sentinel under lse_log2
        const float m = lse_log2 && m_i[r] != NEG_INF ? m_i[r] * c : m_i[r];
        lse[((long long)b * H + h) * Sq + rr] = m + (lse_log2 ? log2f(l_i[r]) : logf(l_i[r]));
      }
    }
  }
}

// One launch of flash_fwd_wgmma_kernel<KT, SPLIT_P, D> over the maps of q
// (boxes of K1_BM rows), k or K^T, v (K1Tiles<D>::BN rows) and the mask
// (K1Tiles<D>::BN keys); returns cudaGetLastError().
template <bool KT, bool SPLIT_P, int D = 128>
inline int launch_fwd_bf16(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                           const CUtensorMap& tm, void* o, void* lse, int B, int Sq, int Skv,
                           int H, int causal, SoftmaxUnits u, cudaStream_t st) {
  auto kernel = flash_fwd_wgmma_kernel<KT, SPLIT_P, D>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K1Smem<D>::ALLOC);
  dim3 grid((Sq + K1_BM - 1) / K1_BM, H, B);
  kernel<<<grid, 128 * (K1_WG + 1), K1Smem<D>::ALLOC, st>>>(
      tq, tk, tv, tm, (__nv_bfloat16*)o, (float*)lse, Sq, Skv, H, causal, u);
  return (int)cudaGetLastError();
}

}  // namespace pbt
