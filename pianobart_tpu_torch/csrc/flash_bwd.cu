// Flash attention backward for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces three Pallas TPU kernels of pianobart_tpu/ops/flash.py, one C
// entry each, all running the two CUDA kernels below:
//   pbt_flash_bwd  K2, :351 _bwd_fused_kernel (launched by _bwd_fused_call
//                  where S <= 1024): the dK/dV kernel, then the dQ kernel;
//   pbt_flash_dq   K3a, :276 _dq_kernel (launched by _dq_call where S > 1024
//                  and by the ring backward): the dQ kernel;
//   pbt_flash_dkv  K3b, :312 _dkv_kernel (_dkv_call): the dK/dV kernel.
// Same contract as the Pallas calls:
//   q, k, v, dO  (B, S, H, D) bf16 or f32, read through their strides; q is
//                already scaled by D**-0.5 by the caller.
//   kv_mask      (B, Skv) int32, nonzero = attend.  causal: keep row >= col.
//   lse, delta   (B, H, Sq) f32: the forward's row logsumexp (or a merged
//                one) and delta = rowsum(dO * O), computed by the caller.
//   dq, dk, dv   (B, S, H, D) contiguous, input dtype.
// P = exp(s - lse) with masked scores at the finite -1e30 of the forward, so
// P is the forward's softmax exactly; dS = P * (dP - delta), dP = dO V^T;
// dV = P^T dO, dK = dS^T Q, dQ = dS K.
//
// Bound at the flagship train shape (B=32, S=1024, H=8, D=128, bf16):
// 10*S^2*D FLOPs per (b, h) when no key is masked (five S x S x D products),
// 3.44e11 FLOP per call = 0.347 ms at 989 TFLOP/s, about half that causal;
// the seven (B, S, H, D) arrays (64 MiB each) take about 0.14 ms at
// 3.35 TB/s, so the kernel is bound by operations.  The two kernels below do
// seven products (S and dP twice), so they cannot beat 0.49 ms there.  At the
// long-context shape (B=16, S=2048) K3a does 3 of those products (0.417 ms)
// and K3b 4 (0.556 ms), both bound by operations.
//
// The TPU kernel held one (b, h)'s whole 1024 x 1024 block in VMEM and
// computed S, P, dP and dS once; a CTA has 227 KB, so here the backward is
// tiled and split into two kernels with no atomics and a deterministic
// result: the dK/dV kernel owns kv rows and sweeps q tiles, the dQ kernel
// owns q rows and sweeps kv tiles.  Both are one template (DKV):
//
//   one CTA per (128 fixed rows, head, batch): kv rows for dK/dV, q rows for
//   dQ.  A producer warpgroup, whose one thread loads by TMA (4-D maps of
//   (D, H, S, B) with the caller's strides, 128-byte swizzle, each 128-wide
//   row as two 64-column boxes): the fixed operands once (K and V with the
//   kv mask rows; or Q and dO with their lse and delta rows) and the swept
//   operands tile by tile (Q, dO and their 64 lse and delta entries; or K,
//   V and their 64 mask entries) into a ring of 4 stages of 64 rows (201 KB
//   of shared memory in all), one full and one free mbarrier per stage.
//   Two consumer warpgroups of 64 fixed rows each run, per swept tile:
//     dK/dV: S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 from shared
//            memory (K or V as A, Q or dO as B, all K-major); P^T and dS^T
//            in registers; dV += P^T dO and dK += dS^T Q as wgmma m64n128k16
//            with P^T and dS^T as A fragments from registers and dO and Q
//            read MN-major through the transpose bit (the same swizzled box
//            as the first two products read K-major);
//     dQ:    S = Q K^T and dP = dO V^T the same way; dQ += dS K with K
//            MN-major.
//   The swept tile is 64 rows because a dK/dV warpgroup holds dK and dV (64
//   + 64 f32 a thread) beside S^T and dP^T (32 + 32); 128 would pass the
//   240 registers setmaxnreg gives a consumer (the producer keeps 24).
//   P = 2^((s - lse) log2 e), the difference taken in the score domain, so
//   a row with no kept key (lse the -1e30 sentinel) gets p = 1 exactly, as
//   the plain version does.  P and dS are rounded to bf16 as operands, as
//   the TPU's single-pass bf16 dots did; hence the stated bf16 tolerance.
//   Masks are selects, the causal test only on the one tile the diagonal
//   crosses in each warpgroup, and swept tiles wholly on the masked side of
//   the diagonal are skipped (a warpgroup waits for them and releases the
//   stage).  S is a multiple of 64, so a warpgroup's fixed rows lie all
//   below S or all past it (TMA's zeros): one past it does no work and
//   stores nothing, and a swept tile is never ragged.
//
//   In the dQ kernel a warpgroup issues S and dP of tile i before dQ += dS K
//   of tile i-1, so its elementwise work runs under that product.  The
//   dK/dV kernel cannot: S^T and dP^T of the next tile beside dK, dV and
//   the fragments in flight pass 240 registers (ptxas spilled 200 bytes and
//   the kernel ran slower), so its tiles run one after the other and the
//   other warpgroup fills the tensor cores' gaps.
//
// Left on the table: a persistent schedule (each CTA loads 64 KB of fixed
// operands and stores its results with nothing to overlap them, which
// costs most where a CTA sweeps few tiles: S=1024 runs at a lower share of
// the bound than S=2048); S and dP computed twice (the one-pass
// five-product schedule needs dQ summed across CTAs, by atomics or a second
// pass); ping-pong of the consumer warpgroups; 4-byte stores of the results.
//
// delta = rowsum(dO * O), which both kernels read, comes from the small
// delta kernel below: the reference leaves it to XLA, which fuses it into
// one pass, and the plain PyTorch version takes five.
//
// The f32 kernels do the same algorithm with FMAs on the CUDA cores, for
// checks where the point is the algorithm.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace pbt;

// ------------------------------------------------------------ bf16 / wgmma
constexpr int NWG = 2;                  // consumer warpgroups, 64 fixed rows each
constexpr int FIX = 64 * NWG;           // fixed rows per CTA
constexpr int TILE = 64;                // swept rows per stage
constexpr int STAGES = 4;
constexpr int OPND = 2 * HEAD_DIM;      // bytes per row of a (rows, 128) bf16 operand
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-aligned base (the swizzle atom).
struct BwdSmem {
  static constexpr int A1 = 0;                          // fixed: K (dK/dV) or Q (dQ)
  static constexpr int A2 = A1 + FIX * OPND;            // fixed: V or dO
  static constexpr int B = A2 + FIX * OPND;             // per stage: B1 (Q or K), B2 (dO or V)
  static constexpr int STAGE = 2 * TILE * OPND;
  static constexpr int FIXV = B + STAGES * STAGE;       // fixed rows' mask, or lse and delta
  static constexpr int STV = FIXV + 2 * FIX * 4;        // per stage: lse and delta, or mask
  static constexpr int STV_STAGE = 2 * TILE * 4;
  static constexpr int BAR = STV + STAGES * STV_STAGE;  // fix, full[S], free[S]
  static constexpr int ALLOC = BAR + (1 + 2 * STAGES) * 8 + 1024;
};

// acc = A B^T over the head dim: A the warpgroup's 64 fixed rows, B a swept
// tile, both K-major (the head dim along their rows): 8 k16 steps, 4 in
// each 64-column box.  Issued, not fenced or committed.
__device__ __forceinline__ void issue_ss(float (&d)[TILE / 2], const unsigned char* a,
                                         const unsigned char* b) {
  const uint64_t da = smem_desc_sw128(a, 16), db = smem_desc_sw128(b, 16);
#pragma unroll
  for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
    wgmma_ss_n64(d, da + ((kk / 4) * FIX * ROW + (kk % 4) * 32) / 16,
                 db + ((kk / 4) * TILE * ROW + (kk % 4) * 32) / 16, kk > 0);
}

// acc += X B: X (64 x TILE) as A fragments from registers, B a swept tile
// read MN-major (its rows are the product's k, the head dim its n) through
// the transpose bit.  Issued, not fenced or committed.
__device__ __forceinline__ void issue_rs(float (&acc)[HEAD_DIM / 2],
                                         const uint32_t (&x)[TILE / 16][4],
                                         const unsigned char* b) {
  const uint64_t db = smem_desc_sw128(b, TILE * ROW);
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) wgmma_rs_n128_tb(acc, x[kk], db + kk * 16 * ROW / 16);
}

// f32 accumulators of a 64 x TILE product, rounded to bf16, as A fragments
__device__ __forceinline__ void pack_a(uint32_t (&x)[TILE / 16][4], const float (&v)[TILE / 2]) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) acc_to_a(x[kk], &v[8 * kk], &v[8 * kk + 4]);
}

// dK/dV, one q tile at q0: s holds S^T (this thread's kv rows `kvrow` and
// kvrow + 8, q columns 8j + 2t + {0, 1}), dp holds dP^T; they become P^T and
// dS^T.  lse and delta are the tile's 64 entries; keep the rows' mask.
template <bool DIAG>
__device__ __forceinline__ void probs_t(float (&s)[TILE / 2], float (&dp)[TILE / 2],
                                        const float* lse, const float* delta,
                                        const bool (&keep)[2], int kvrow, int q0, int t) {
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse + c);
    const float2 d = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool kp = keep[e >> 1];
      if (DIAG) kp &= q0 + c + (e & 1) >= kvrow + (e >= 2 ? 8 : 0);
      const float x = kp ? s[4 * j + e] : NEG_INF;
      const float p = exp2_approx((x - ((e & 1) ? l.y : l.x)) * LOG2E);
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
    }
  }
}

// dQ, one kv tile at kv0: s holds S (this thread's q rows `row` and row + 8,
// kv columns 8j + 2t + {0, 1}), dp holds dP; they become P and dS.  mk is
// the tile's 64 mask entries; lse and delta the rows'.
template <bool DIAG>
__device__ __forceinline__ void probs(float (&s)[TILE / 2], float (&dp)[TILE / 2],
                                      const int* mk, const float (&lse)[2],
                                      const float (&delta)[2], int row, int kv0, int t) {
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const int2 keep = *reinterpret_cast<const int2*>(mk + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool kp = ((e & 1) ? keep.y : keep.x) != 0;
      if (DIAG) kp &= row + (e >= 2 ? 8 : 0) >= kv0 + c + (e & 1);
      const float x = kp ? s[4 * j + e] : NEG_INF;
      const float p = exp2_approx((x - lse[e >> 1]) * LOG2E);
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - delta[e >> 1]);
    }
  }
}

// DKV: dK (out1) and dV (out2) of 128 kv rows; else dQ (out1) of 128 q
// rows.  Tensor maps: q and dO in boxes of TILE rows (DKV) or FIX, k and v
// in FIX (DKV) or TILE, the mask in boxes of FIX (DKV) or TILE keys, lse and
// delta in boxes of TILE (DKV) or FIX entries.
template <bool DKV>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const __grid_constant__ CUtensorMap tm,
                       const __grid_constant__ CUtensorMap tl,
                       const __grid_constant__ CUtensorMap td,
                       __nv_bfloat16* __restrict__ out1, __nv_bfloat16* __restrict__ out2,
                       int Sq, int Skv, int H, int causal) {
  using L = BwdSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_fix = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* bar_full = bar_fix + 1;     // stage s landed
  uint64_t* bar_free = bar_full + STAGES;  // stage s read by every consumer warp

  const int f0 = blockIdx.x * FIX, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int wg = threadIdx.x / 128;
  const int s_fixed = DKV ? Skv : Sq;
  // swept tiles i0 .. n-1: under causal, dK/dV starts at the first q tile
  // with a row >= f0, dQ ends at the last kv tile with a key <= f0 + FIX - 1
  int i0 = 0, n = (DKV ? Sq : Skv) / TILE;
  if (causal) {
    if (DKV) i0 = min(f0 / TILE, n);
    else n = min(n, (f0 + FIX - 1) / TILE + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_fix, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + s, 1);
      mbar_init(bar_free + s, 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * NWG) {
      const CUtensorMap* ta1 = DKV ? &tk : &tq;
      const CUtensorMap* ta2 = DKV ? &tv : &to;
      const CUtensorMap* tb1 = DKV ? &tq : &tk;
      const CUtensorMap* tb2 = DKV ? &to : &tv;
      mbar_arrive_expect_tx(bar_fix, 2 * FIX * OPND + (DKV ? FIX * 4 : 2 * FIX * 4));
      tma_load_4d(sm + L::A1, ta1, bar_fix, 0, h, f0, b);
      tma_load_4d(sm + L::A1 + FIX * ROW, ta1, bar_fix, BOX, h, f0, b);
      tma_load_4d(sm + L::A2, ta2, bar_fix, 0, h, f0, b);
      tma_load_4d(sm + L::A2 + FIX * ROW, ta2, bar_fix, BOX, h, f0, b);
      if (DKV) {
        tma_load_2d(sm + L::FIXV, &tm, bar_fix, f0, b);
      } else {
        tma_load_2d(sm + L::FIXV, &tl, bar_fix, f0, bh);
        tma_load_2d(sm + L::FIXV + FIX * 4, &td, bar_fix, f0, bh);
      }
      for (int i = i0; i < n; ++i) {
        const int j = i - i0, s = j % STAGES, r0 = i * TILE;
        mbar_wait(bar_free + s, ((j / STAGES) & 1) ^ 1);   // the first round passes
        unsigned char* st = sm + L::B + s * L::STAGE;
        unsigned char* sv = sm + L::STV + s * L::STV_STAGE;
        mbar_arrive_expect_tx(bar_full + s, L::STAGE + (DKV ? 2 * TILE * 4 : TILE * 4));
        tma_load_4d(st, tb1, bar_full + s, 0, h, r0, b);
        tma_load_4d(st + TILE * ROW, tb1, bar_full + s, BOX, h, r0, b);
        tma_load_4d(st + TILE * OPND, tb2, bar_full + s, 0, h, r0, b);
        tma_load_4d(st + TILE * OPND + TILE * ROW, tb2, bar_full + s, BOX, h, r0, b);
        if (DKV) {
          tma_load_2d(sv, &tl, bar_full + s, r0, bh);
          tma_load_2d(sv + TILE * 4, &td, bar_full + s, r0, bh);
        } else {
          tma_load_2d(sv, &tm, bar_full + s, r0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: fixed rows w0 .. w0 + 63
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int w0 = f0 + wg * 64;
    const int fr = wg * 64 + warp * 16 + lane / 4;   // this thread's rows: fr, fr + 8 of the CTA
    const int row = f0 + fr;
    // S is a multiple of 64: the warpgroup's rows lie all below S or all past it
    const bool active = w0 < s_fixed;
    // the swept tiles it works on, ib .. ie-1; it only releases the others
    int ib = i0, ie = n;
    if (!active) {
      ib = n;
    } else if (causal) {
      if (DKV) ib = max(i0, min(w0 / TILE, n));
      else ie = min(n, (w0 + 63) / TILE + 1);
    }
    const unsigned char* a1 = sm + L::A1 + wg * 64 * ROW;
    const unsigned char* a2 = sm + L::A2 + wg * 64 * ROW;

    float acc1[HEAD_DIM / 2], acc2[HEAD_DIM / 2];   // dK and dV, or dQ alone
#pragma unroll
    for (int i = 0; i < HEAD_DIM / 2; ++i) acc1[i] = acc2[i] = 0.f;

    mbar_wait(bar_fix, 0);
    bool keep[2];
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (DKV) {
        keep[r] = reinterpret_cast<const int*>(sm + L::FIXV)[fr + 8 * r] != 0;
      } else {
        lse_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[fr + 8 * r];
        dl_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[FIX + fr + 8 * r];
      }
    }

    // per swept tile i: S and dP (the first two products), P and dS in
    // registers, then the last one or two products.
    typedef float Scores[TILE / 2];
    typedef uint32_t Frags[TILE / 16][4];             // P or dS as A fragments
    auto swept = [&](int i) { return sm + L::B + ((i - i0) % STAGES) * L::STAGE; };
    auto wait_full = [&](int i) {
      mbar_wait(bar_full + (i - i0) % STAGES, ((i - i0) / STAGES) & 1);
    };
    auto release = [&](int i) {                       // stage of tile i may be refilled
      if (lane == 0) mbar_arrive(bar_free + (i - i0) % STAGES);
    };
    auto issue_first = [&](int i, Scores& sc, Scores& dp) {
      wgmma_fence();
      issue_ss(sc, a1, swept(i));                     // S^T = K Q^T, or S = Q K^T
      issue_ss(dp, a2, swept(i) + TILE * OPND);       // dP^T = V dO^T, or dP = dO V^T
      wgmma_commit();
    };
    auto issue_last = [&](int i, const Frags& xs, const Frags& xd) {
      fence_regs(acc1);
      if (DKV) fence_regs(acc2);
      wgmma_fence();
      if (DKV) issue_rs(acc2, xs, swept(i) + TILE * OPND);   // dV += P^T dO
      issue_rs(acc1, xd, swept(i));                   // dK += dS^T Q, or dQ += dS K
      wgmma_commit();
    };
    // sc and dp (S and dP of tile i, in) become P and dS
    auto elementwise = [&](int i, Scores& sc, Scores& dp) {
      const int r0 = i * TILE;
      const unsigned char* sv = sm + L::STV + ((i - i0) % STAGES) * L::STV_STAGE;
      if (DKV) {
        const float* lv = reinterpret_cast<const float*>(sv);
        if (causal && r0 < w0 + 63)
          probs_t<true>(sc, dp, lv, lv + TILE, keep, row, r0, t);
        else
          probs_t<false>(sc, dp, lv, lv + TILE, keep, row, r0, t);
      } else {
        const int* mk = reinterpret_cast<const int*>(sv);
        if (causal && r0 + 63 > w0)
          probs<true>(sc, dp, mk, lse_r, dl_r, row, r0, t);
        else
          probs<false>(sc, dp, mk, lse_r, dl_r, row, r0, t);
      }
      fence_regs(sc);                                 // computed before any wait
      fence_regs(dp);
    };

    if constexpr (DKV) {
      // The dK/dV kernel runs its tiles one after the other: its warpgroup
      // holds dK and dV, and the next tile's S^T and dP^T beside them and
      // the fragments in flight spill (see the header).
      for (int i = i0; i < n; ++i) {
        wait_full(i);
        if (i >= ib && i < ie) {
          Scores sc, dp;
          Frags xs, xd;
          issue_first(i, sc, dp);
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
          elementwise(i, sc, dp);
          pack_a(xs, sc);
          pack_a(xd, dp);
          issue_last(i, xs, xd);
          wgmma_wait<0>();
          fence_regs(acc1);
          fence_regs(acc2);
        }
        release(i);
      }
    } else {
      // The dQ kernel issues S and dP of tile i before dQ += dS K of tile
      // i-1, so tile i's elementwise work runs under that product.
      Scores sc, dp;
      Frags xd;                                       // dS of the last tile elementwise
      for (int i = i0; i < ib; ++i) {
        wait_full(i);
        release(i);
      }
      if (ib < ie) {
        wait_full(ib);
        issue_first(ib, sc, dp);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        elementwise(ib, sc, dp);
        pack_a(xd, dp);
        for (int i = ib + 1; i < ie; ++i) {
          wait_full(i);
          issue_first(i, sc, dp);
          issue_last(i - 1, xd, xd);
          wgmma_wait<1>();                            // S and dP of tile i are in
          fence_regs(sc);
          fence_regs(dp);
          elementwise(i, sc, dp);
          wgmma_wait<0>();                            // tile i-1's product is in
          fence_regs(acc1);
          release(i - 1);
          pack_a(xd, dp);                             // its fragments are free now
        }
        issue_last(ie - 1, xd, xd);
        wgmma_wait<0>();
        fence_regs(acc1);
        release(ie - 1);
      }
      for (int i = ie; i < n; ++i) {
        wait_full(i);
        release(i);
      }
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = (((long long)b * s_fixed + row + 8 * r) * H + h) * HEAD_DIM;
#pragma unroll
        for (int dt = 0; dt < HEAD_DIM / 8; ++dt) {
          *reinterpret_cast<uint32_t*>(out1 + at + dt * 8 + 2 * t) =
              pack_bf16(acc1[4 * dt + 2 * r], acc1[4 * dt + 2 * r + 1]);
          if (DKV)
            *reinterpret_cast<uint32_t*>(out2 + at + dt * 8 + 2 * t) =
                pack_bf16(acc2[4 * dt + 2 * r], acc2[4 * dt + 2 * r + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- delta
// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] in f32, the rows both
// kernels read: 16 lanes per (b, s, h) row, 8 elements each, h fastest
// across the rows of a block.  Bound by bytes (it reads dO and O once).
constexpr int DELTA_ROWS = 16;          // rows per 256-thread block

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}

template <typename T>
__global__ void __launch_bounds__(16 * DELTA_ROWS)
flash_delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                   float* __restrict__ delta, int S, int H, long long rows,
                   long long osb, long long oss, long long osh,
                   long long tsb, long long tss, long long tsh) {
  const long long r = (long long)blockIdx.x * DELTA_ROWS + threadIdx.x / 16;
  const int l = threadIdx.x % 16;
  const int h = (int)(r % H), s = (int)((r / H) % S);
  const long long b = r / H / S;
  float acc = 0.f;
  if (r < rows) {
    float x[8], y[8];
    load8(dout + b * osb + s * oss + h * osh + l * 8, x);
    load8(out + b * tsb + s * tss + h * tsh + l * 8, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(x[i], y[i], acc);
  }
#pragma unroll
  for (int o = 8; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (r < rows && l == 0) delta[(b * H + h) * S + s] = acc;
}

// ------------------------------------------------------------------ f32 / FMA
// Thread tid owns output column d = tid for FR rows; scores are computed one
// (row, column) pair per thread into padded smem.
constexpr int THREADS = 128;
constexpr int FR = 16;               // rows per CTA (q rows for dq, kv rows for dkv)
constexpr int FT = 64;               // rows per swept tile
constexpr int KP = HEAD_DIM + 1;     // tile pitch: column reads hit distinct banks
constexpr int PP = FT + 1;           // score pitch
constexpr size_t F32_SMEM =
    (2 * FR * HEAD_DIM + 2 * FT * KP + 2 * FR * PP + 2 * FT) * sizeof(float) +
    FT * sizeof(int);

__global__ void __launch_bounds__(THREADS)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const int* __restrict__ mask, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Skv, int H, int causal,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long osb, long long oss, long long osh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // FR x HEAD_DIM
  float* Vs = Ks + FR * HEAD_DIM;
  float* Qs = Vs + FR * HEAD_DIM;                    // FT x KP
  float* Os = Qs + FT * KP;
  float* Ps = Os + FT * KP;                          // FR x PP
  float* Gs = Ps + FR * PP;                          // dS
  float* Ls = Gs + FR * PP;
  float* Ds = Ls + FT;
  int* Mk = reinterpret_cast<int*>(Ds + FT);

  const int kv0 = blockIdx.x * FR, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  load_tile_f32<THREADS>(Ks, k + b * ksb + (long long)kv0 * kss + h * ksh, kss, FR, HEAD_DIM);
  load_tile_f32<THREADS>(Vs, v + b * vsb + (long long)kv0 * vss + h * vsh, vss, FR, HEAD_DIM);
  if (tid < FR) Mk[tid] = mask[(long long)b * Skv + kv0 + tid];
  float acc_k[FR], acc_v[FR];
#pragma unroll
  for (int r = 0; r < FR; ++r) acc_k[r] = acc_v[r] = 0.f;

  const float* lse_bh = lse + ((long long)b * H + h) * Sq;
  const float* dl_bh = delta + ((long long)b * H + h) * Sq;
  const int i0 = causal ? kv0 / FT : 0;
  for (int i = i0; i < Sq / FT; ++i) {
    const int q0 = i * FT;
    __syncthreads();
    load_tile_f32<THREADS>(Qs, q + b * qsb + (long long)q0 * qss + h * qsh, qss, FT, KP);
    load_tile_f32<THREADS>(Os, dout + b * osb + (long long)q0 * oss + h * osh, oss, FT, KP);
    if (tid < FT) { Ls[tid] = lse_bh[q0 + tid]; Ds[tid] = dl_bh[q0 + tid]; }
    __syncthreads();
    {
      const int c = tid % FT, r0 = (tid / FT) * (FR / 2);   // q column c
      for (int r = r0; r < r0 + FR / 2; ++r) {
        float sc = 0.f, dpv = 0.f;
#pragma unroll 8
        for (int d = 0; d < HEAD_DIM; ++d) {
          sc = fmaf(Ks[r * HEAD_DIM + d], Qs[c * KP + d], sc);
          dpv = fmaf(Vs[r * HEAD_DIM + d], Os[c * KP + d], dpv);
        }
        const bool keep = Mk[r] != 0 && (!causal || q0 + c >= kv0 + r);
        const float p = expf((keep ? sc : NEG_INF) - Ls[c]);
        Ps[r * PP + c] = p;
        Gs[r * PP + c] = p * (dpv - Ds[c]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < FR; ++r) {
      float av = acc_v[r], ak = acc_k[r];
      for (int c = 0; c < FT; ++c) {
        av = fmaf(Ps[r * PP + c], Os[c * KP + tid], av);
        ak = fmaf(Gs[r * PP + c], Qs[c * KP + tid], ak);
      }
      acc_v[r] = av;
      acc_k[r] = ak;
    }
  }
#pragma unroll
  for (int r = 0; r < FR; ++r) {
    const long long at = (((long long)b * Skv + kv0 + r) * H + h) * HEAD_DIM + tid;
    dk[at] = acc_k[r];
    dv[at] = acc_v[r];
  }
}

__global__ void __launch_bounds__(THREADS)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const int* __restrict__ mask, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Skv, int H, int causal,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh,
                    long long osb, long long oss, long long osh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // FR x HEAD_DIM
  float* Os = Qs + FR * HEAD_DIM;
  float* Ks = Os + FR * HEAD_DIM;                    // FT x KP
  float* Vs = Ks + FT * KP;
  float* Gs = Vs + FT * KP;                          // dS, FR x PP
  float* Ls = Gs + FR * PP;
  float* Ds = Ls + FT;
  int* Ms = reinterpret_cast<int*>(Ds + FT);

  const int q0 = blockIdx.x * FR, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  load_tile_f32<THREADS>(Qs, q + b * qsb + (long long)q0 * qss + h * qsh, qss, FR, HEAD_DIM);
  load_tile_f32<THREADS>(Os, dout + b * osb + (long long)q0 * oss + h * osh, oss, FR, HEAD_DIM);
  if (tid < FR) {
    const long long at = ((long long)b * H + h) * Sq + q0 + tid;
    Ls[tid] = lse[at];
    Ds[tid] = delta[at];
  }
  float acc[FR];
#pragma unroll
  for (int r = 0; r < FR; ++r) acc[r] = 0.f;

  int n_tiles = Skv / FT;
  if (causal) n_tiles = min(n_tiles, (q0 + FR - 1) / FT + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * FT;
    __syncthreads();
    load_tile_f32<THREADS>(Ks, k + b * ksb + (long long)kv0 * kss + h * ksh, kss, FT, KP);
    load_tile_f32<THREADS>(Vs, v + b * vsb + (long long)kv0 * vss + h * vsh, vss, FT, KP);
    if (tid < FT) Ms[tid] = mask[(long long)b * Skv + kv0 + tid];
    __syncthreads();
    {
      const int c = tid % FT, r0 = (tid / FT) * (FR / 2);   // kv column c
      for (int r = r0; r < r0 + FR / 2; ++r) {
        float sc = 0.f, dpv = 0.f;
#pragma unroll 8
        for (int d = 0; d < HEAD_DIM; ++d) {
          sc = fmaf(Qs[r * HEAD_DIM + d], Ks[c * KP + d], sc);
          dpv = fmaf(Os[r * HEAD_DIM + d], Vs[c * KP + d], dpv);
        }
        const bool keep = Ms[c] != 0 && (!causal || q0 + r >= kv0 + c);
        const float p = expf((keep ? sc : NEG_INF) - Ls[r]);
        Gs[r * PP + c] = p * (dpv - Ds[r]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < FR; ++r) {
      float a = acc[r];
      for (int c = 0; c < FT; ++c) a = fmaf(Gs[r * PP + c], Ks[c * KP + tid], a);
      acc[r] = a;
    }
  }
#pragma unroll
  for (int r = 0; r < FR; ++r)
    dq[(((long long)b * Sq + q0 + r) * H + h) * HEAD_DIM + tid] = acc[r];
}

typedef long long ll;
#define PBT_STRIDES ll qsb, ll qss, ll qsh, ll ksb, ll kss, ll ksh, \
                    ll vsb, ll vss, ll vsh, ll osb, ll oss, ll osh
#define PBT_STRIDE_ARGS qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh


// The bf16 kernel of one pass (DKV: dK and dV into out1, out2; else dQ into
// out1) on `st`; returns 1000 + the CUresult of a refused tensor map, or
// cudaGetLastError().
template <bool DKV>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const void* mask, const void* lse, const void* delta, void* out1,
                 void* out2, int B, int Sq, int Skv, int H, int causal, PBT_STRIDES,
                 cudaStream_t st) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return TMAP_ERROR;
  const int q_rows = DKV ? TILE : FIX, kv_rows = DKV ? FIX : TILE;
  CUtensorMap tq, tk, tv, to, tm, tl, td;
  CUresult r = qkv_map(enc, &tq, q, B, Sq, H, qsb, qss, qsh, q_rows);
  if (r == CUDA_SUCCESS) r = qkv_map(enc, &to, dout, B, Sq, H, osb, oss, osh, q_rows);
  if (r == CUDA_SUCCESS) r = qkv_map(enc, &tk, k, B, Skv, H, ksb, kss, ksh, kv_rows);
  if (r == CUDA_SUCCESS) r = qkv_map(enc, &tv, v, B, Skv, H, vsb, vss, vsh, kv_rows);
  if (r == CUDA_SUCCESS) r = mask_map(enc, &tm, mask, B, Skv, kv_rows);
  if (r == CUDA_SUCCESS)
    r = rows_map(enc, &tl, lse, B * H, Sq, q_rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r == CUDA_SUCCESS)
    r = rows_map(enc, &td, delta, B * H, Sq, q_rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r != CUDA_SUCCESS) return TMAP_ERROR + (int)r;
  cudaFuncSetAttribute(flash_bwd_wgmma_kernel<DKV>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem::ALLOC);
  dim3 grid(((DKV ? Skv : Sq) + FIX - 1) / FIX, H, B);
  flash_bwd_wgmma_kernel<DKV><<<grid, 128 * (NWG + 1), BwdSmem::ALLOC, st>>>(
      tq, tk, tv, to, tm, tl, td, (__nv_bfloat16*)out1, (__nv_bfloat16*)out2, Sq, Skv, H,
      causal);
  return (int)cudaGetLastError();
}

// The dK/dV kernel on `st`.
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* mask, const void* lse, const void* delta, void* dk,
               void* dv, int B, int Sq, int Skv, int H, int dtype, int causal,
               PBT_STRIDES, cudaStream_t st) {
  if (dtype == 1)
    return launch_wgmma<true>(q, k, v, dout, mask, lse, delta, dk, dv, B, Sq, Skv, H,
                              causal, PBT_STRIDE_ARGS, st);
  cudaFuncSetAttribute(flash_dkv_f32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
  flash_dkv_f32_kernel<<<dim3(Skv / FR, H, B), THREADS, F32_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const int*)mask, (const float*)lse, (const float*)delta, (float*)dk,
      (float*)dv, Sq, Skv, H, causal, PBT_STRIDE_ARGS);
  return (int)cudaGetLastError();
}

// The dQ kernel on `st`.
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* mask, const void* lse, const void* delta, void* dq,
              int B, int Sq, int Skv, int H, int dtype, int causal, PBT_STRIDES,
              cudaStream_t st) {
  if (dtype == 1)
    return launch_wgmma<false>(q, k, v, dout, mask, lse, delta, dq, nullptr, B, Sq, Skv,
                               H, causal, PBT_STRIDE_ARGS, st);
  cudaFuncSetAttribute(flash_dq_f32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
  flash_dq_f32_kernel<<<dim3(Sq / FR, H, B), THREADS, F32_SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const int*)mask, (const float*)lse, (const float*)delta, (float*)dq,
      Sq, Skv, H, causal, PBT_STRIDE_ARGS);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// (B, S, H) axes of q, k, v and dO; the D axis must be contiguous.  Each
// entry launches on `stream` and returns the first nonzero of its kernels'
// codes: cudaGetLastError(), or 1000 + the CUresult of a tensor map the
// driver refused (1000 alone where the driver offers no encoder).

// K2: the dK/dV kernel, then the dQ kernel.
extern "C" int pbt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* mask, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int B, int Sq, int Skv, int H, int dtype, int causal,
                             PBT_STRIDES, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int rc = launch_dkv(q, k, v, dout, mask, lse, delta, dk, dv, B, Sq, Skv, H,
                      dtype, causal, PBT_STRIDE_ARGS, st);
  if (rc != 0) return rc;
  return launch_dq(q, k, v, dout, mask, lse, delta, dq, B, Sq, Skv, H, dtype,
                   causal, PBT_STRIDE_ARGS, st);
}

// K3a: dQ alone.
extern "C" int pbt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* mask, const void* lse,
                            const void* delta, void* dq, int B, int Sq, int Skv,
                            int H, int dtype, int causal, PBT_STRIDES,
                            void* stream) {
  return launch_dq(q, k, v, dout, mask, lse, delta, dq, B, Sq, Skv, H, dtype,
                   causal, PBT_STRIDE_ARGS, reinterpret_cast<cudaStream_t>(stream));
}

// K3b: dK and dV alone.
extern "C" int pbt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* mask, const void* lse,
                             const void* delta, void* dk, void* dv, int B, int Sq,
                             int Skv, int H, int dtype, int causal, PBT_STRIDES,
                             void* stream) {
  return launch_dkv(q, k, v, dout, mask, lse, delta, dk, dv, B, Sq, Skv, H,
                    dtype, causal, PBT_STRIDE_ARGS,
                    reinterpret_cast<cudaStream_t>(stream));
}

// delta = rowsum(dO * O) into (B, H, S) f32; dO's and O's strides in
// elements for the (B, S, H) axes.
extern "C" int pbt_flash_delta(const void* dout, const void* out, void* delta, int B,
                               int S, int H, int dtype, long long osb, long long oss,
                               long long osh, long long tsb, long long tss,
                               long long tsh, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * S * H;
  const dim3 grid((unsigned)((rows + DELTA_ROWS - 1) / DELTA_ROWS));
  if (dtype == 1)
    flash_delta_kernel<__nv_bfloat16><<<grid, 16 * DELTA_ROWS, 0, st>>>(
        (const __nv_bfloat16*)dout, (const __nv_bfloat16*)out, (float*)delta, S, H, rows,
        osb, oss, osh, tsb, tss, tsh);
  else
    flash_delta_kernel<float><<<grid, 16 * DELTA_ROWS, 0, st>>>(
        (const float*)dout, (const float*)out, (float*)delta, S, H, rows, osb, oss, osh,
        tsb, tss, tsh);
  return (int)cudaGetLastError();
}
