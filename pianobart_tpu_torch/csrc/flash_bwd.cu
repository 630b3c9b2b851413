// Flash attention backward for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces three Pallas TPU kernels of pianobart_tpu/ops/flash.py, one C
// entry each, all running the two CUDA kernels below:
//   pbt_flash_bwd  K2, :351 _bwd_fused_kernel (launched by _bwd_fused_call
//                  where S <= 1024): the dK/dV kernel, then the dQ kernel;
//   pbt_flash_dq   K3a, :276 _dq_kernel (launched by _dq_call where S > 1024
//                  and by the ring backward): the dQ kernel;
//   pbt_flash_dkv  K3b, :312 _dkv_kernel (_dkv_call): the dK/dV kernel.
// Same contract as the Pallas calls, at head width D = 128 or 256:
//   q, k, v, dO  (B, S, H, D) bf16 or f32, read through their strides (f32
//                at D = 128: by the prep); q is already scaled by D**-0.5 by
//                the caller.
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
// f32 (3xTF32, the default PianoBartConfig's path): flash_bwd_tf32_kernel
// below, the same schedule on the tensor cores at f32 accuracy from the
// planes of the prep kernel (pbt_tf32_split), every product three tf32
// wgmma.  Bound: 3 x the bf16 FLOPs at 495 TFLOP/s tf32.
//
// At D = 256 neither layout fits a CTA.  The bf16 kernels of that width are
// flash_bwd_d256_wgmma_kernel (64 fixed rows, dK and dV in warpgroups of
// their own, dQ's kv tiles alternating between the warpgroups); the f32 ones
// are flash_bwd_tf32_kernel<DKV, 256>, the D = 128 kernel run as a cluster
// of two CTAs, one per 128-column half of the head, that sum S and dP
// across the pair (described where it is defined).  Bounds at the --heads 4
// shapes equal the D = 128 ones above (H*D = 1024 in both): K2 0.3421 ms at
// B=32, S=1024; K3a 0.4105 and K3b 0.5474 ms at B=16, S=2048.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace pbt;

// ------------------------------------------------------------ bf16 / wgmma
constexpr int BWD_D = 128;              // the head width of this design
constexpr int NWG = 2;                  // consumer warpgroups, 64 fixed rows each
constexpr int FIX = 64 * NWG;           // fixed rows per CTA
constexpr int TILE = 64;                // swept rows per stage
constexpr int STAGES = 4;
constexpr int OPND = 2 * BWD_D;         // bytes per row of a (rows, 128) bf16 operand
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

// acc = A B^T over the head dim D: A the warpgroup's 64 fixed rows (its
// boxes A_ROWS rows apart), B a swept tile, both K-major (the head dim
// along their rows): D/16 k16 steps, 4 in each 64-column box.  Issued, not
// fenced or committed.
template <int D, int A_ROWS>
__device__ __forceinline__ void issue_ss(float (&d)[TILE / 2], const unsigned char* a,
                                         const unsigned char* b) {
  const uint64_t da = smem_desc_sw128(a, 16), db = smem_desc_sw128(b, 16);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(d, da + ((kk / 4) * A_ROWS * ROW + (kk % 4) * 32) / 16,
                 db + ((kk / 4) * TILE * ROW + (kk % 4) * 32) / 16, kk > 0);
}

// acc += X B: X (64 x TILE) as A fragments from registers, B a swept tile
// read MN-major (its rows are the product's k, the head dim its n) through
// the transpose bit, one m64n128k16 for each 128 columns of the head (two
// boxes).  Issued, not fenced or committed.
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&x)[TILE / 16][4],
                                         const unsigned char* b) {
  const uint64_t db = smem_desc_sw128(b, TILE * ROW);
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
    for (int n = 0; n < D / 128; ++n)
      wgmma_rs_n128_tb(acc_half(acc, n), x[kk], db + (n * 2 * TILE * ROW + kk * 16 * ROW) / 16);
}

// f32 accumulators of a 64 x TILE product, rounded to bf16, as A fragments
__device__ __forceinline__ void pack_a(uint32_t (&x)[TILE / 16][4], const float (&v)[TILE / 2]) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) acc_to_a(x[kk], &v[8 * kk], &v[8 * kk + 4]);
}

// dK/dV, one q tile at q0: s holds S^T (this thread's kv rows `kvrow` and
// kvrow + 8, q columns 8j + 2t + {0, 1}), dp holds dP^T; they become P^T and
// dS^T.  lse and delta are the tile's N entries; keep the rows' mask.
template <bool DIAG, int N = TILE>
__device__ __forceinline__ void probs_t(float (&s)[N / 2], float (&dp)[N / 2],
                                        const float* lse, const float* delta,
                                        const bool (&keep)[2], int kvrow, int q0, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
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

// P^T alone (the dV warps at D = 256): probs_t without dP^T
template <bool DIAG, int N = TILE>
__device__ __forceinline__ void probs_t_p(float (&s)[N / 2], const float* lse,
                                          const bool (&keep)[2], int kvrow, int q0, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool kp = keep[e >> 1];
      if (DIAG) kp &= q0 + c + (e & 1) >= kvrow + (e >= 2 ? 8 : 0);
      const float x = kp ? s[4 * j + e] : NEG_INF;
      s[4 * j + e] = exp2_approx((x - ((e & 1) ? l.y : l.x)) * LOG2E);
    }
  }
}

// dS^T from P^T in p and dP^T in dp (dK/dV, one q tile): dp becomes
// P^T (dP^T - delta), probs_t's arithmetic, with the tile's N delta entries
template <int N = TILE>
__device__ __forceinline__ void ds_t(float (&dp)[N / 2], const float (&p)[N / 2],
                                     const float* delta, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
  }
}

// dQ, one kv tile at kv0: s holds S (this thread's q rows `row` and row + 8,
// kv columns 8j + 2t + {0, 1}), dp holds dP; they become P and dS.  mk is
// the tile's N mask entries; lse and delta the rows'.
template <bool DIAG, int N = TILE>
__device__ __forceinline__ void probs(float (&s)[N / 2], float (&dp)[N / 2],
                                      const int* mk, const float (&lse)[2],
                                      const float (&delta)[2], int row, int kv0, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
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

    float acc1[BWD_D / 2], acc2[BWD_D / 2];         // dK and dV, or dQ alone
#pragma unroll
    for (int i = 0; i < BWD_D / 2; ++i) acc1[i] = acc2[i] = 0.f;

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
      issue_ss<BWD_D, FIX>(sc, a1, swept(i));         // S^T = K Q^T, or S = Q K^T
      issue_ss<BWD_D, FIX>(dp, a2, swept(i) + TILE * OPND);  // dP^T = V dO^T, or dP = dO V^T
      wgmma_commit();
    };
    auto issue_last = [&](int i, const Frags& xs, const Frags& xd) {
      fence_regs(acc1);
      if (DKV) fence_regs(acc2);
      wgmma_fence();
      if (DKV) issue_rs<BWD_D>(acc2, xs, swept(i) + TILE * OPND);   // dV += P^T dO
      issue_rs<BWD_D>(acc1, xd, swept(i));            // dK += dS^T Q, or dQ += dS K
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
        const long long at = (((long long)b * s_fixed + row + 8 * r) * H + h) * BWD_D;
#pragma unroll
        for (int dt = 0; dt < BWD_D / 8; ++dt) {
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

// ------------------------------------------------ bf16 / wgmma at D = 256
// The products above at head width 256, where their layout does not fit:
// a thread's dK and dV would take 256 registers (setmaxnreg gives 240), and
// the fixed K and V of 128 rows with 4 stages of 64 would take 512 KB.  One
// CTA per (64 fixed rows, head, batch), two consumer warpgroups and the
// producer; the fixed operands loaded once (64 rows x 256: 32 KB each), the
// swept ones through 2 stages of 64 rows (64 KB a stage): 193 KB in all.
// Each 256-wide row is four 64-column boxes; S and dP are m64n64k16 over
// 16 k16 steps, the last product two m64n128k16 a k16 step (one for each
// half of the head).
//   dK/dV: both warpgroups read every swept tile.  Warpgroup 0 owns dV
//     (S^T = K Q^T, P^T, dV += P^T dO), warpgroup 1 dK (S^T and
//     dP^T = V dO^T, dS^T, dK += dS^T Q): S^T is computed twice (five
//     products a tile where four are needed) so that a thread holds one
//     64 x 256 accumulator (128 f32) beside S^T and dP^T (32 + 32).
//   dQ: the swept kv tiles alternate between the warpgroups (tile i in
//     stage i % 2, read by warpgroup i % 2 alone), each running S, dP, dS
//     and dQ += dS K into a dQ of its own: three products a tile.  At the
//     end warpgroup 1 hands its dQ to warpgroup 0 through the stages, idle
//     by then, which adds it in f32 and stores.
// A warpgroup's tiles run one after the other.  No atomics.
constexpr int W_D = 256;
constexpr int W_FIX = 64;               // fixed rows per CTA
constexpr int W_STAGES = 2;
constexpr int W_OPND = 2 * W_D;         // bytes per row of a (rows, 256) bf16 operand

struct Bwd256Smem {
  static constexpr int A1 = 0;                          // fixed: K (dK/dV) or Q (dQ)
  static constexpr int A2 = A1 + W_FIX * W_OPND;        // fixed: V or dO
  static constexpr int B = A2 + W_FIX * W_OPND;         // per stage: B1 (Q or K), B2 (dO or V)
  static constexpr int STAGE = 2 * TILE * W_OPND;
  static constexpr int FIXV = B + W_STAGES * STAGE;     // fixed rows' mask, or lse and delta
  static constexpr int STV = FIXV + 2 * W_FIX * 4;      // per stage: lse and delta, or mask
  static constexpr int STV_STAGE = 2 * TILE * 4;
  static constexpr int BAR = STV + W_STAGES * STV_STAGE;  // fix, full[S], free[S]
  static constexpr int ALLOC = BAR + (1 + 2 * W_STAGES) * 8 + 1024;
};

// DKV: dK (out1) and dV (out2) of 64 kv rows; else dQ (out1) of 64 q rows.
// Tensor maps: q, k, v, dO in boxes of 64 rows, the mask, lse and delta in
// boxes of 64 entries.
template <bool DKV>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_bwd_d256_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to,
                            const __grid_constant__ CUtensorMap tm,
                            const __grid_constant__ CUtensorMap tl,
                            const __grid_constant__ CUtensorMap td,
                            __nv_bfloat16* __restrict__ out1,
                            __nv_bfloat16* __restrict__ out2,
                            int Sq, int Skv, int H, int causal) {
  using L = Bwd256Smem;
  constexpr int NS = W_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_fix = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* bar_full = bar_fix + 1;     // stage s landed
  uint64_t* bar_free = bar_full + NS;   // stage s read by its consumer warps

  const int f0 = blockIdx.x * W_FIX, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int wg = threadIdx.x / 128;
  const int s_fixed = DKV ? Skv : Sq;
  // swept tiles i0 .. n-1: under causal, dK/dV starts at the q tile of row
  // f0, dQ ends at the kv tile of key f0 (tiles and fixed rows both 64)
  int i0 = 0, n = (DKV ? Sq : Skv) / TILE;
  if (causal) {
    if (DKV) i0 = min(f0 / TILE, n);
    else n = min(n, f0 / TILE + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_fix, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + s, 1);
      mbar_init(bar_free + s, DKV ? 4 * NWG : 4);   // dQ: one warpgroup a stage
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
      mbar_arrive_expect_tx(bar_fix, 2 * W_FIX * W_OPND + (DKV ? W_FIX * 4 : 2 * W_FIX * 4));
#pragma unroll
      for (int x = 0; x < W_D / BOX; ++x) {
        tma_load_4d(sm + L::A1 + x * W_FIX * ROW, ta1, bar_fix, x * BOX, h, f0, b);
        tma_load_4d(sm + L::A2 + x * W_FIX * ROW, ta2, bar_fix, x * BOX, h, f0, b);
      }
      if (DKV) {
        tma_load_2d(sm + L::FIXV, &tm, bar_fix, f0, b);
      } else {
        tma_load_2d(sm + L::FIXV, &tl, bar_fix, f0, bh);
        tma_load_2d(sm + L::FIXV + W_FIX * 4, &td, bar_fix, f0, bh);
      }
      for (int i = i0; i < n; ++i) {
        const int j = i - i0, s = j % NS, r0 = i * TILE;
        mbar_wait(bar_free + s, ((j / NS) & 1) ^ 1);   // the first round passes
        unsigned char* st = sm + L::B + s * L::STAGE;
        unsigned char* sv = sm + L::STV + s * L::STV_STAGE;
        mbar_arrive_expect_tx(bar_full + s, L::STAGE + (DKV ? 2 * TILE * 4 : TILE * 4));
#pragma unroll
        for (int x = 0; x < W_D / BOX; ++x) {
          tma_load_4d(st + x * TILE * ROW, tb1, bar_full + s, x * BOX, h, r0, b);
          tma_load_4d(st + TILE * W_OPND + x * TILE * ROW, tb2, bar_full + s, x * BOX, h, r0,
                      b);
        }
        if (DKV) {
          tma_load_2d(sv, &tl, bar_full + s, r0, bh);
          tma_load_2d(sv + TILE * 4, &td, bar_full + s, r0, bh);
        } else {
          tma_load_2d(sv, &tm, bar_full + s, r0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: the CTA's 64 fixed rows f0 .. f0 + 63
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int fr = warp * 16 + lane / 4;             // this thread's rows: fr, fr + 8 of the CTA
    const int row = f0 + fr;
    const unsigned char* a1 = sm + L::A1;
    const unsigned char* a2 = sm + L::A2;

    float acc[W_D / 2];                              // dV (wg 0) or dK (wg 1); or a dQ
#pragma unroll
    for (int i = 0; i < W_D / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_fix, 0);
    bool keep[2];
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (DKV) {
        keep[r] = reinterpret_cast<const int*>(sm + L::FIXV)[fr + 8 * r] != 0;
      } else {
        lse_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[fr + 8 * r];
        dl_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[W_FIX + fr + 8 * r];
      }
    }
    auto swept = [&](int i) { return sm + L::B + ((i - i0) % NS) * L::STAGE; };
    auto side = [&](int i) { return sm + L::STV + ((i - i0) % NS) * L::STV_STAGE; };
    auto wait_full = [&](int i) { mbar_wait(bar_full + (i - i0) % NS, ((i - i0) / NS) & 1); };
    auto release = [&](int i) {                      // stage of tile i may be refilled
      if (lane == 0) mbar_arrive(bar_free + (i - i0) % NS);
    };
    // acc += X B for the tile's last product, then wait for it
    auto last = [&](const uint32_t (&x)[TILE / 16][4], const unsigned char* bt) {
      fence_regs(acc);
      wgmma_fence();
      issue_rs<W_D>(acc, x, bt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    };

    if constexpr (DKV) {
      for (int i = i0; i < n; ++i) {
        wait_full(i);
        const int r0 = i * TILE;
        const bool diag = causal && r0 < f0 + W_FIX - 1;
        const float* lv = reinterpret_cast<const float*>(side(i));
        float sc[TILE / 2];
        uint32_t x[TILE / 16][4];
        if (wg == 0) {                               // dV += P^T dO
          wgmma_fence();
          issue_ss<W_D, W_FIX>(sc, a1, swept(i));   // S^T = K Q^T
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          if (diag)
            probs_t_p<true>(sc, lv, keep, row, r0, t);
          else
            probs_t_p<false>(sc, lv, keep, row, r0, t);
          fence_regs(sc);
          pack_a(x, sc);
          last(x, swept(i) + TILE * W_OPND);
        } else {                                     // dK += dS^T Q
          float dp[TILE / 2];
          wgmma_fence();
          issue_ss<W_D, W_FIX>(sc, a1, swept(i));   // S^T = K Q^T
          issue_ss<W_D, W_FIX>(dp, a2, swept(i) + TILE * W_OPND);   // dP^T = V dO^T
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
          if (diag)
            probs_t<true>(sc, dp, lv, lv + TILE, keep, row, r0, t);
          else
            probs_t<false>(sc, dp, lv, lv + TILE, keep, row, r0, t);
          fence_regs(dp);
          pack_a(x, dp);
          last(x, swept(i));
        }
        release(i);
      }
    } else {
      for (int i = wg; i < n; i += NWG) {            // i0 = 0: tile i in stage i % 2
        wait_full(i);
        const int r0 = i * TILE;
        const int* mk = reinterpret_cast<const int*>(side(i));
        float sc[TILE / 2], dp[TILE / 2];
        uint32_t x[TILE / 16][4];
        wgmma_fence();
        issue_ss<W_D, W_FIX>(sc, a1, swept(i));     // S = Q K^T
        issue_ss<W_D, W_FIX>(dp, a2, swept(i) + TILE * W_OPND);   // dP = dO V^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (causal && r0 + TILE - 1 > f0)
          probs<true>(sc, dp, mk, lse_r, dl_r, row, r0, t);
        else
          probs<false>(sc, dp, mk, lse_r, dl_r, row, r0, t);
        fence_regs(dp);
        pack_a(x, dp);
        last(x, swept(i));                           // dQ += dS K
        release(i);
      }
      // warpgroup 1's dQ into warpgroup 0's through the stages: every tile
      // was consumed before the first barrier, so no load lands there
      float* red = reinterpret_cast<float*>(sm + L::B);
      named_barrier_sync<1>(128 * NWG);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < W_D / 2; ++i) red[i * 128 + tid] = acc[i];
      }
      named_barrier_sync<2>(128 * NWG);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < W_D / 2; ++i) acc[i] += red[i * 128 + tid];
      }
    }

    if (DKV || wg == 0) {
      __nv_bfloat16* out = DKV && wg == 0 ? out2 : out1;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = (((long long)b * s_fixed + row + 8 * r) * H + h) * W_D;
#pragma unroll
        for (int dt = 0; dt < W_D / 8; ++dt)
          *reinterpret_cast<uint32_t*>(out + at + dt * 8 + 2 * t) =
              pack_bf16(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------- delta
// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] in f32, the rows both
// kernels read: D/8 lanes per (b, s, h) row (16 at D = 128, 32 at 256), 8
// elements each, h fastest across the rows of a 256-thread block.  Bound by
// bytes (it reads dO and O once).
constexpr int DELTA_THREADS = 256;

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

template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                   float* __restrict__ delta, int S, int H, long long rows,
                   long long osb, long long oss, long long osh,
                   long long tsb, long long tss, long long tsh) {
  constexpr int LANES = D / 8, ROWS = DELTA_THREADS / LANES;
  const long long r = (long long)blockIdx.x * ROWS + threadIdx.x / LANES;
  const int l = threadIdx.x % LANES;
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
  for (int o = LANES / 2; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (r < rows && l == 0) delta[(b * H + h) * S + s] = acc;
}

// ------------------------------------------------------------- tf32 prep
// The f32 kernels' operands, made once per call: x (B, S, H, D) f32 read
// through its strides becomes hi = x rounded to tf32 and lo = x - hi
// (exact), as natural planes nat (2, B, H, S, D) and/or
// transposed planes tr (2, B, H, D, S) (hi, then lo; tr's s runs in the
// order 0 2 4 6 1 3 5 7 within each 8, the k order of a tf32 A fragment
// made from accumulators: hopper.cuh:split_acc_tf32).  One launch takes
// every operand of a call (up to SPLIT_MAX, all (B, *, H, D)); one CTA
// per 32 rows of one (b, h) of one operand; bound by bytes (x read once,
// each plane written once).  D = 128 or 256 (a CTA pair of the f32
// kernels reads its 128-column half of each plane); the transposing tile is
// static shared memory, 33 KB at D = 256.
constexpr int SPLIT_ROWS = 32;
constexpr int SPLIT_MAX = 4;

// The operands of one launch: null nat or tr where not asked for.  The
// host fills it (ops/flash.py:_SplitArgs mirrors it field by field).
struct SplitArgs {
  const float* x[SPLIT_MAX];
  float* nat[SPLIT_MAX];
  float* tr[SPLIT_MAX];
  long long sb[SPLIT_MAX], ss[SPLIT_MAX], sh[SPLIT_MAX];   // x's strides in elements
  int S[SPLIT_MAX];
};

template <int D>
__global__ void __launch_bounds__(256)
tf32_split_kernel(const SplitArgs a, int B, int H) {
  __shared__ float tile[SPLIT_ROWS][D + 1];
  const int op = blockIdx.z / B, b = blockIdx.z % B, h = blockIdx.y;
  const int s0 = blockIdx.x * SPLIT_ROWS, S = a.S[op];
  if (s0 >= S) return;
  const float* __restrict__ x = a.x[op];
  float* __restrict__ nat = a.nat[op];
  float* __restrict__ tr = a.tr[op];
  const long long sb = a.sb[op], ss = a.ss[op], sh = a.sh[op];
  const long long plane = (long long)B * H * S * D;
  const long long bh = (long long)b * H + h;
  for (int i = threadIdx.x; i < SPLIT_ROWS * D / 4; i += 256) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    const float4 v = *reinterpret_cast<const float4*>(x + b * sb + (s0 + r) * ss + h * sh + c);
    if (nat) {
      uint32_t hi[4], lo[4];
      tf32_split(v.x, hi[0], lo[0]);
      tf32_split(v.y, hi[1], lo[1]);
      tf32_split(v.z, hi[2], lo[2]);
      tf32_split(v.w, hi[3], lo[3]);
      const long long at = (bh * S + s0 + r) * D + c;
      *reinterpret_cast<uint4*>(nat + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(nat + plane + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (tr) {
      tile[r][c] = v.x;
      tile[r][c + 1] = v.y;
      tile[r][c + 2] = v.z;
      tile[r][c + 3] = v.w;
    }
  }
  if (!tr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < D * SPLIT_ROWS; i += 256) {
    const int d = i / SPLIT_ROWS, j = i % SPLIT_ROWS, k = j % 8;
    uint32_t hi, lo;
    tf32_split(tile[j - k + (k < 4 ? 2 * k : 2 * k - 7)][d], hi, lo);
    const long long at = (bh * D + d) * S + s0 + j;
    tr[at] = __uint_as_float(hi);
    tr[plane + at] = __uint_as_float(lo);
  }
}

// ----------------------------------------------------- f32 / 3xTF32 wgmma
// The f32 dK/dV (DKV) and dQ kernels: the bf16 template's schedule with one
// consumer warpgroup of 64 fixed rows, every operand from the prep's hi
// and lo planes, every product three tf32 wgmma (hi.hi', hi.lo', lo.hi').
// The fixed operands' four planes take 128 KB, so a CTA holds one consumer
// warpgroup (and, with 256 threads, up to 255 registers a thread with no
// setmaxnreg); the swept operands stream through a ring of 3 slots of one
// 64-row plane each (32 KB), their lse and delta (or mask) through a ring
// of 2 per tile.  Per swept tile the planes come in the order the products
// read them: DKV Q hi, lo, dO hi, lo (S^T = K Q^T and dP^T = V dO^T from
// shared memory), dO^T hi, lo (dV += P^T dO, P^T from registers), Q^T hi,
// lo (dK += dS^T Q); dQ K hi, lo, V hi, lo (S and dP), K^T hi, lo
// (dQ += dS K).  The products run one after another.
//
// At D = 256 (DW = 256) the fixed operands' planes alone would take 256 KB,
// so the kernel runs as a cluster of two CTAs along x (blockIdx.x / 2 the
// fixed tile, the cluster rank the half of D), each the D = 128 kernel on
// its 128 columns of every plane: the fixed operands' halves, the swept
// ones' halves (natural: columns c0 .. c0 + 127; transposed: d rows c0 ..
// c0 + 127), its halves of dK and dV (or dQ) stored.  S^T and dP^T (S and
// dP) sum over all of D, so a CTA stores its partials into the peer's slot
// of a lo plane the peer has just finished reading, and adds the peer's
// from its own (hopper.cuh:pair_open .. pair_add): the dQ pair both at once
// after both products (V lo's slot, 32 KB each way a tile), the dK/dV pair
// each after its product (Q lo's and dO lo's slots, 16 KB each way).  P and
// dS are then the same in both CTAs to the bit.  The dK/dV pair takes its
// planes in the order Q, dO^T, dO, Q^T and runs dV += P^T dO before dP^T =
// V dO^T: P^T is its hi and lo fragments during that product (hi + lo is
// P^T exactly again after it), so the warpgroup never holds dK, dV, S^T,
// dP^T and fragments at once, and holds no more than 192 accumulator and
// fragment floats at an exchange (the D = 128 order peaks at 224 and
// spills).  A pair reads what one D = 128 CTA reads: the same L2 traffic,
// the same FLOPs and the same bound at the same B.
constexpr int T_D = 128;                // the head width of this design
constexpr int T_SLOTS = 3;
constexpr int T_PLANE = TILE * 4 * T_D;  // 64 rows x 128 f32 (or 128 x 64): 32 KB
// The tensor cores round each accumulation step toward zero, by up to an
// ulp of the running sum: over the 24 steps of a tile times the 16-32
// tiles of S = 1024-2048 that bias reaches 2-4e-5 of dQ, dK and dV, past
// the f32 tolerance.  So the accumulators go to the output every T_FLUSH
// tiles (stored, then added in f32 by the thread that owns the elements)
// and start again from zero: 48 steps a chain.
constexpr int T_FLUSH = 2;

// acc (this thread's part of 64 rows x 128, rows `row` and row + 8) into
// columns c0 .. c0 + 127 of the (B, S, H, DW) output: stored (add = false)
// or added to it; acc is zeroed.
template <int DW>
__device__ __forceinline__ void flush_rows(float* __restrict__ out, float (&acc)[T_D / 2],
                                           int b, int S, int row, int H, int h, int t,
                                           bool add, int c0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* at = out + (((long long)b * S + row + 8 * r) * H + h) * DW + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < T_D / 8; ++dt) {
      float2 v = make_float2(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
      if (add) {
        const float2 o = *reinterpret_cast<const float2*>(at + dt * 8);
        v.x += o.x;
        v.y += o.y;
      }
      *reinterpret_cast<float2*>(at + dt * 8) = v;
    }
  }
#pragma unroll
  for (int i = 0; i < T_D / 2; ++i) acc[i] = 0.f;
}

struct BwdTf32Smem {
  static constexpr int A1H = 0;                      // fixed: K (dK/dV) or Q (dQ), hi
  static constexpr int A1L = A1H + T_PLANE;          //   and lo
  static constexpr int A2H = A1L + T_PLANE;          // fixed: V or dO
  static constexpr int A2L = A2H + T_PLANE;
  static constexpr int SLOT = A2L + T_PLANE;         // ring of planes
  static constexpr int FIXV = SLOT + T_SLOTS * T_PLANE;   // fixed rows' mask, or lse and delta
  static constexpr int SIDE = FIXV + 2 * TILE * 4;   // 2 per-tile entries: lse and delta, or mask
  static constexpr int SIDE_STAGE = 2 * TILE * 4;
  // fix, full[S], free[S], sfull[2], sfree[2], and for a pair the exchange's
  // ready and full
  static constexpr int BAR = SIDE + 2 * SIDE_STAGE;
  static constexpr int ALLOC = BAR + (1 + 2 * T_SLOTS + 4 + 2) * 8 + 1024;
};

// Tensor maps: tq, tk, tv, to the natural planes of q, k, v, dO in boxes of
// TILE rows; tt1, tt2 transposed planes in boxes of 128 rows (DKV: dO^T, Q^T;
// dQ: K^T, K^T); tm the mask in boxes of TILE keys; tl, td lse and delta in
// boxes of TILE entries.  DKV: dK into out1, dV into out2; else dQ into out1.
// DW, the head width: 128, or 256 as CTA pairs (see above).
template <bool DKV, int DW>
__global__ void __launch_bounds__(256, 1)
flash_bwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      const __grid_constant__ CUtensorMap tt1,
                      const __grid_constant__ CUtensorMap tt2,
                      const __grid_constant__ CUtensorMap tm,
                      const __grid_constant__ CUtensorMap tl,
                      const __grid_constant__ CUtensorMap td,
                      float* __restrict__ out1, float* __restrict__ out2,
                      int Sq, int Skv, int H, int causal) {
  using L = BwdTf32Smem;
  constexpr bool PAIR = DW == 2 * T_D;
  constexpr int NP = DKV ? 8 : 6;       // planes per swept tile
  constexpr int NS = T_SLOTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_fix = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* bar_full = bar_fix + 1;     // plane of slot s landed
  uint64_t* bar_free = bar_full + NS;   // slot s read by every consumer warp
  uint64_t* side_full = bar_free + NS;  // side entry e landed
  uint64_t* side_free = side_full + 2;  // side entry e read
  uint64_t* x_ready = side_free + 2;    // pair: the peer's slot takes this CTA's S, dP
  uint64_t* x_full = x_ready + 1;       // pair: the peer's S, dP landed in this CTA's slot

  uint32_t rank = 0;                    // pair: which half of D
  if constexpr (PAIR) rank = cluster_ctarank();
  const int c0 = rank * T_D;            // this CTA's first column of the head
  const int f0 = (PAIR ? blockIdx.x >> 1 : blockIdx.x) * TILE, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int s_fixed = DKV ? Skv : Sq;
  // swept tiles i0 .. n-1, as in the bf16 kernel (64 fixed rows here)
  int i0 = 0, n = (DKV ? Sq : Skv) / TILE;
  if (causal) {
    if (DKV) i0 = min(f0 / TILE, n);
    else n = min(n, f0 / TILE + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_fix, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + s, 1);
      mbar_init(bar_free + s, 4);
    }
    for (int e = 0; e < 2; ++e) {
      mbar_init(side_full + e, 1);
      mbar_init(side_free + e, 4);
    }
    if constexpr (PAIR) {
      mbar_init(x_ready, 4);              // each of the peer's consumer warps
      mbar_init(x_full, 128);             // each of the peer's consumer threads
    }
    mbar_fence_init();
  }
  if constexpr (PAIR) cluster_sync();     // both CTAs' barriers ready
  else __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warpgroup: one thread keeps the rings full
    if (threadIdx.x == 128) {
      const CUtensorMap* ta1 = DKV ? &tk : &tq;
      const CUtensorMap* ta2 = DKV ? &tv : &to;
      mbar_arrive_expect_tx(bar_fix, 4 * T_PLANE + (DKV ? TILE * 4 : 2 * TILE * 4));
      for (int pl = 0; pl < 2; ++pl)
        for (int x = 0; x < 4; ++x) {
          tma_load_4d(sm + (pl ? L::A1L : L::A1H) + x * TILE * ROW, ta1, bar_fix,
                      c0 + FBOX * x, f0, bh, pl);
          tma_load_4d(sm + (pl ? L::A2L : L::A2H) + x * TILE * ROW, ta2, bar_fix,
                      c0 + FBOX * x, f0, bh, pl);
        }
      if (DKV) {
        tma_load_2d(sm + L::FIXV, &tm, bar_fix, f0, b);
      } else {
        tma_load_2d(sm + L::FIXV, &tl, bar_fix, f0, bh);
        tma_load_2d(sm + L::FIXV + TILE * 4, &td, bar_fix, f0, bh);
      }
      for (int i = i0; i < n; ++i) {
        const int j = i - i0, e = j % 2, r0 = i * TILE;
        mbar_wait(side_free + e, ((j / 2) & 1) ^ 1);
        unsigned char* sv = sm + L::SIDE + e * L::SIDE_STAGE;
        if (DKV) {
          mbar_arrive_expect_tx(side_full + e, 2 * TILE * 4);
          tma_load_2d(sv, &tl, side_full + e, r0, bh);
          tma_load_2d(sv + TILE * 4, &td, side_full + e, r0, bh);
        } else {
          mbar_arrive_expect_tx(side_full + e, TILE * 4);
          tma_load_2d(sv, &tm, side_full + e, r0, b);
        }
        for (int q = 0; q < NP; ++q) {
          const int p = j * NP + q, s = p % NS;
          // the plane's kind in the order above (the dK/dV pair takes dO^T
          // before dO)
          const int k = PAIR && DKV && q >= 2 && q < 6 ? q ^ 6 : q;
          mbar_wait(bar_free + s, ((p / NS) & 1) ^ 1);   // the first round passes
          unsigned char* dst = sm + L::SLOT + s * T_PLANE;
          mbar_arrive_expect_tx(bar_full + s, T_PLANE);
          if (k < 4) {                                   // natural: 4 boxes of TILE rows
            const CUtensorMap* m = k < 2 ? (DKV ? &tq : &tk) : (DKV ? &to : &tv);
            for (int x = 0; x < 4; ++x)
              tma_load_4d(dst + x * TILE * ROW, m, bar_full + s, c0 + FBOX * x, r0, bh, q % 2);
          } else {                                       // transposed: 2 boxes of 128 rows
            const CUtensorMap* m = k < 6 && DKV ? &tt1 : &tt2;
            for (int x = 0; x < 2; ++x)
              tma_load_4d(dst + x * T_D * ROW, m, bar_full + s, r0 + FBOX * x, c0, bh,
                          q % 2);
          }
        }
      }
    }
  } else {
    // ---- the consumer warpgroup: fixed rows f0 .. f0 + 63
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int fr = warp * 16 + lane / 4;             // this thread's rows: fr, fr + 8
    const int row = f0 + fr;
    const uint64_t da1h = smem_desc_sw128(sm + L::A1H, 16), da1l = smem_desc_sw128(sm + L::A1L, 16);
    const uint64_t da2h = smem_desc_sw128(sm + L::A2H, 16), da2l = smem_desc_sw128(sm + L::A2L, 16);
    auto plane = [&](int p) { return sm + L::SLOT + (p % NS) * T_PLANE; };
    auto wait_plane = [&](int p) { mbar_wait(bar_full + p % NS, (p / NS) & 1); };
    auto release = [&](int p) { if (lane == 0) mbar_arrive(bar_free + p % NS); };

    float acc1[T_D / 2], acc2[T_D / 2];             // dK and dV, or dQ alone
#pragma unroll
    for (int i = 0; i < T_D / 2; ++i) acc1[i] = acc2[i] = 0.f;

    mbar_wait(bar_fix, 0);
    bool keep[2];
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (DKV) {
        keep[r] = reinterpret_cast<const int*>(sm + L::FIXV)[fr + 8 * r] != 0;
      } else {
        lse_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[fr + 8 * r];
        dl_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[TILE + fr + 8 * r];
      }
    }

    // d = A B^T over the head dim, A fixed (planes ah, al), B the planes p,
    // p + 1: 16 k8 steps of three products; then the planes are released
    // (p + 1 only if rel2)
    auto first = [&](float (&d)[TILE / 2], uint64_t ah, uint64_t al, int p, bool rel2) {
      wait_plane(p);
      wait_plane(p + 1);
      const uint64_t dbh = smem_desc_sw128(plane(p), 16);
      const uint64_t dbl = smem_desc_sw128(plane(p + 1), 16);
      wgmma_fence();
      // the small terms first, while the accumulator is small (see below)
#pragma unroll
      for (int kk = 0; kk < T_D / 8; ++kk) {
        const uint32_t o = ((kk / 4) * TILE * ROW + (kk % 4) * 32) / 16;
        wgmma_ss_tf32_n64(d, ah + o, dbl + o, kk > 0);
        wgmma_ss_tf32_n64(d, al + o, dbh + o, 1);
      }
#pragma unroll
      for (int kk = 0; kk < T_D / 8; ++kk) {
        const uint32_t o = ((kk / 4) * TILE * ROW + (kk % 4) * 32) / 16;
        wgmma_ss_tf32_n64(d, ah + o, dbh + o, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      release(p);
      if (rel2) release(p + 1);
    };
    // acc += X B with X (64 x TILE) from registers as hi and lo fragments,
    // B the transposed planes p, p + 1: 8 k8 steps of three products
    auto last = [&](float (&acc)[T_D / 2], uint32_t (&xh)[TILE / 8][4],
                    uint32_t (&xl)[TILE / 8][4], int p) {
      wait_plane(p);
      wait_plane(p + 1);
      const uint64_t dbh = smem_desc_sw128(plane(p), 16);
      const uint64_t dbl = smem_desc_sw128(plane(p + 1), 16);
      fence_regs(acc);
      fence_regs(xh);
      fence_regs(xl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 8; ++kk) {
        const uint32_t o = ((kk / 4) * T_D * ROW + (kk % 4) * 32) / 16;
        wgmma_rs_tf32_n128(acc, xh[kk], dbh + o);
        wgmma_rs_tf32_n128(acc, xh[kk], dbl + o);
        wgmma_rs_tf32_n128(acc, xl[kk], dbh + o);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(xh);
      fence_regs(xl);
      release(p);
      release(p + 1);
    };

    // pair: the `parts` (TILE / 2 floats of this thread each) over this
    // CTA's half of D go to the peer's slot of plane ps, the peer's parts
    // come into this CTA's and are added, so each holds the sum over all of
    // D; the slot goes back to the ring.  x counts the exchanges (parity).
    auto pair_sum = [&](int ps, int x, auto&... parts) {
      unsigned char* xs = plane(ps);
      const uint32_t peer = cluster_ctarank() ^ 1;
      const uint32_t dst = pair_open(xs, x_ready, peer, x & 1, lane == 0);
      int k0 = 0;
      ((pair_put(dst, parts, k0, 128, threadIdx.x), k0 += TILE / 8), ...);
      pair_close(x_full, peer, x & 1);
      k0 = 0;
      ((pair_add(parts, xs, k0, 128, threadIdx.x), k0 += TILE / 8), ...);
      fence_proxy_async();                           // read before the slot's next TMA write
      __syncwarp();
      release(ps);
    };

    for (int i = i0; i < n; ++i) {
      const int j = i - i0, p = j * NP, r0 = i * TILE, e = j % 2;
      float sc[TILE / 2], dp[TILE / 2];
      uint32_t xh[TILE / 8][4], xl[TILE / 8][4];
      if constexpr (PAIR && DKV) {
        first(sc, da1h, da1l, p, false);             // S^T = K Q^T over this half
        pair_sum(p + 1, 2 * j, sc);
        mbar_wait(side_full + e, (j / 2) & 1);
        const float* lv = reinterpret_cast<const float*>(sm + L::SIDE + e * L::SIDE_STAGE);
        if (causal && r0 < f0 + 63)
          probs_t_p<true>(sc, lv, keep, row, r0, t);
        else
          probs_t_p<false>(sc, lv, keep, row, r0, t);
        split_acc_tf32(xh, xl, sc);
        last(acc2, xh, xl, p + 2);                   // dV += P^T dO
        join_acc_tf32(sc, xh, xl);                   // P^T, exactly
        first(dp, da2h, da2l, p + 4, false);         // dP^T = V dO^T over this half
        pair_sum(p + 5, 2 * j + 1, dp);
        ds_t(dp, sc, lv + TILE, t);
        if (lane == 0) mbar_arrive(side_free + e);
        split_acc_tf32(xh, xl, dp);
        last(acc1, xh, xl, p + 6);                   // dK += dS^T Q
      } else {
        first(sc, da1h, da1l, p, true);                // S^T = K Q^T, or S = Q K^T
        first(dp, da2h, da2l, p + 2, !PAIR);           // dP^T = V dO^T, or dP = dO V^T
        if constexpr (PAIR) pair_sum(p + 3, j, sc, dp);   // dQ: over this half, then all of D
        mbar_wait(side_full + e, (j / 2) & 1);
        const unsigned char* sv = sm + L::SIDE + e * L::SIDE_STAGE;
        if (DKV) {
          const float* lv = reinterpret_cast<const float*>(sv);
          if (causal && r0 < f0 + 63)
            probs_t<true>(sc, dp, lv, lv + TILE, keep, row, r0, t);
          else
            probs_t<false>(sc, dp, lv, lv + TILE, keep, row, r0, t);
        } else {
          const int* mk = reinterpret_cast<const int*>(sv);
          if (causal && r0 + 63 > f0)
            probs<true>(sc, dp, mk, lse_r, dl_r, row, r0, t);
          else
            probs<false>(sc, dp, mk, lse_r, dl_r, row, r0, t);
        }
        if (lane == 0) mbar_arrive(side_free + e);
        if (DKV) {
          split_acc_tf32(xh, xl, sc);
          last(acc2, xh, xl, p + 4);                   // dV += P^T dO
        }
        split_acc_tf32(xh, xl, dp);
        last(acc1, xh, xl, p + NP - 2);                // dK += dS^T Q, or dQ += dS K
      }
      if (j % T_FLUSH == T_FLUSH - 1 || i == n - 1) {
        flush_rows<DW>(out1, acc1, b, s_fixed, row, H, h, t, j >= T_FLUSH, c0);
        if (DKV) flush_rows<DW>(out2, acc2, b, s_fixed, row, H, h, t, j >= T_FLUSH, c0);
      }
    }
    if (i0 == n) {                                   // no tile: zero gradients
      flush_rows<DW>(out1, acc1, b, s_fixed, row, H, h, t, false, c0);
      if (DKV) flush_rows<DW>(out2, acc2, b, s_fixed, row, H, h, t, false, c0);
    }
  }
  if constexpr (PAIR) cluster_sync();     // no CTA leaves while its peer may reach it
}

typedef long long ll;
#define PBT_STRIDES ll qsb, ll qss, ll qsh, ll ksb, ll kss, ll ksh, \
                    ll vsb, ll vss, ll vsh, ll osb, ll oss, ll osh
#define PBT_STRIDE_ARGS qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh


// The bf16 kernel of one pass at head width D (DKV: dK and dV into out1,
// out2; else dQ into out1) on `st`; returns 1000 + the CUresult of a
// refused tensor map, or cudaGetLastError().
template <bool DKV, int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const void* mask, const void* lse, const void* delta, void* out1,
                 void* out2, int B, int Sq, int Skv, int H, int causal, PBT_STRIDES,
                 cudaStream_t st) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return TMAP_ERROR;
  // D = 128: 128 fixed rows, 64 swept; D = 256: 64 and 64
  const int fix = D == 128 ? FIX : W_FIX;
  const int q_rows = DKV ? TILE : fix, kv_rows = DKV ? fix : TILE;
  CUtensorMap tq, tk, tv, to, tm, tl, td;
  CUresult r = qkv_map(enc, &tq, q, B, Sq, H, qsb, qss, qsh, q_rows, D);
  if (r == CUDA_SUCCESS) r = qkv_map(enc, &to, dout, B, Sq, H, osb, oss, osh, q_rows, D);
  if (r == CUDA_SUCCESS) r = qkv_map(enc, &tk, k, B, Skv, H, ksb, kss, ksh, kv_rows, D);
  if (r == CUDA_SUCCESS) r = qkv_map(enc, &tv, v, B, Skv, H, vsb, vss, vsh, kv_rows, D);
  if (r == CUDA_SUCCESS) r = mask_map(enc, &tm, mask, B, Skv, kv_rows);
  if (r == CUDA_SUCCESS)
    r = rows_map(enc, &tl, lse, B * H, Sq, q_rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r == CUDA_SUCCESS)
    r = rows_map(enc, &td, delta, B * H, Sq, q_rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r != CUDA_SUCCESS) return TMAP_ERROR + (int)r;
  dim3 grid(((DKV ? Skv : Sq) + fix - 1) / fix, H, B);
  if constexpr (D == 128) {
    cudaFuncSetAttribute(flash_bwd_wgmma_kernel<DKV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem::ALLOC);
    flash_bwd_wgmma_kernel<DKV><<<grid, 128 * (NWG + 1), BwdSmem::ALLOC, st>>>(
        tq, tk, tv, to, tm, tl, td, (__nv_bfloat16*)out1, (__nv_bfloat16*)out2, Sq, Skv, H,
        causal);
  } else {
    cudaFuncSetAttribute(flash_bwd_d256_wgmma_kernel<DKV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd256Smem::ALLOC);
    flash_bwd_d256_wgmma_kernel<DKV><<<grid, 128 * (NWG + 1), Bwd256Smem::ALLOC, st>>>(
        tq, tk, tv, to, tm, tl, td, (__nv_bfloat16*)out1, (__nv_bfloat16*)out2, Sq, Skv, H,
        causal);
  }
  return (int)cudaGetLastError();
}

// The f32 kernel of one pass at width D from the prep's planes: q, k, v,
// dout natural, qt, kt, ot transposed (those the pass reads; the others
// may be null).
template <bool DKV>
int launch_tf32(const void* q, const void* k, const void* v, const void* dout,
                const void* qt, const void* kt, const void* ot, const void* mask,
                const void* lse, const void* delta, void* out1, void* out2, int B, int Sq,
                int Skv, int H, int D, int causal, cudaStream_t st) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return TMAP_ERROR;
  const int BH = B * H;
  const void* t1 = DKV ? ot : kt;
  const void* t2 = DKV ? qt : kt;
  const int t_cols = DKV ? Sq : Skv;
  CUtensorMap tq, tk, tv, to, tt1, tt2, tm, tl, td;
  CUresult r = plane_map(enc, &tq, q, BH, Sq, D, TILE);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &to, dout, BH, Sq, D, TILE);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &tk, k, BH, Skv, D, TILE);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &tv, v, BH, Skv, D, TILE);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &tt1, t1, BH, D, t_cols, T_D);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &tt2, t2, BH, D, t_cols, T_D);
  if (r == CUDA_SUCCESS) r = mask_map(enc, &tm, mask, B, Skv, TILE);
  if (r == CUDA_SUCCESS)
    r = rows_map(enc, &tl, lse, BH, Sq, TILE, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r == CUDA_SUCCESS)
    r = rows_map(enc, &td, delta, BH, Sq, TILE, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r != CUDA_SUCCESS) return TMAP_ERROR + (int)r;
  const int tiles = (DKV ? Skv : Sq) / TILE;
  if (D == 256)
    return (int)launch_pair(flash_bwd_tf32_kernel<DKV, 256>, dim3(2 * tiles, H, B), 256,
                            BwdTf32Smem::ALLOC, st, tq, tk, tv, to, tt1, tt2, tm, tl, td,
                            (float*)out1, (float*)out2, Sq, Skv, H, causal);
  cudaFuncSetAttribute(flash_bwd_tf32_kernel<DKV, 128>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, BwdTf32Smem::ALLOC);
  dim3 grid(tiles, H, B);
  flash_bwd_tf32_kernel<DKV, 128><<<grid, 256, BwdTf32Smem::ALLOC, st>>>(
      tq, tk, tv, to, tt1, tt2, tm, tl, td, (float*)out1, (float*)out2, Sq, Skv, H, causal);
  return (int)cudaGetLastError();
}

// One pass (DKV: the dK/dV kernel, else the dQ kernel) at width D and type
// `dtype` on `st`.
template <bool DKV>
int launch_pass(const void* q, const void* k, const void* v, const void* dout,
                const void* qt, const void* kt, const void* ot, const void* mask,
                const void* lse, const void* delta, void* out1, void* out2, int B, int Sq,
                int Skv, int H, int D, int dtype, int causal, PBT_STRIDES, cudaStream_t st) {
  if (D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 128)
      return launch_wgmma<DKV, 128>(q, k, v, dout, mask, lse, delta, out1, out2, B, Sq, Skv, H,
                                    causal, PBT_STRIDE_ARGS, st);
    return launch_wgmma<DKV, 256>(q, k, v, dout, mask, lse, delta, out1, out2, B, Sq, Skv, H,
                                  causal, PBT_STRIDE_ARGS, st);
  }
  return launch_tf32<DKV>(q, k, v, dout, DKV ? qt : nullptr, DKV ? nullptr : kt,
                          DKV ? ot : nullptr, mask, lse, delta, out1, out2, B, Sq, Skv, H, D,
                          causal, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 128 or 256.  bf16: q, k, v, dO (B,
// S, H, D) at element strides for their (B, S, H) axes (the D axis
// contiguous); qt, kt, ot are not read.  f32: q, k, v, dO are the natural
// split planes of pbt_tf32_split and qt, kt, ot
// the transposed planes of q, k and dO (each entry reads the ones its
// kernels use: K2 qt, kt, ot; K3a kt; K3b qt, ot); the strides are not
// read.  Each entry launches on `stream` and returns the first nonzero of
// its kernels' codes: cudaGetLastError(), 1000 + the CUresult of a tensor
// map the driver refused (1000 alone where the driver offers no encoder),
// or cudaErrorInvalidValue for another D.

// K2: the dK/dV kernel, then the dQ kernel.
extern "C" int pbt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* qt, const void* kt,
                             const void* ot, const void* mask, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int B, int Sq, int Skv, int H, int D, int dtype, int causal,
                             PBT_STRIDES, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int rc = launch_pass<true>(q, k, v, dout, qt, kt, ot, mask, lse, delta, dk, dv, B, Sq, Skv,
                             H, D, dtype, causal, PBT_STRIDE_ARGS, st);
  if (rc != 0) return rc;
  return launch_pass<false>(q, k, v, dout, qt, kt, ot, mask, lse, delta, dq, nullptr, B, Sq,
                            Skv, H, D, dtype, causal, PBT_STRIDE_ARGS, st);
}

// K3a: dQ alone.
extern "C" int pbt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* qt, const void* kt,
                            const void* ot, const void* mask, const void* lse,
                            const void* delta, void* dq, int B, int Sq, int Skv,
                            int H, int D, int dtype, int causal, PBT_STRIDES,
                            void* stream) {
  return launch_pass<false>(q, k, v, dout, qt, kt, ot, mask, lse, delta, dq, nullptr, B, Sq,
                            Skv, H, D, dtype, causal, PBT_STRIDE_ARGS,
                            reinterpret_cast<cudaStream_t>(stream));
}

// K3b: dK and dV alone.
extern "C" int pbt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* qt, const void* kt,
                             const void* ot, const void* mask, const void* lse,
                             const void* delta, void* dk, void* dv, int B, int Sq,
                             int Skv, int H, int D, int dtype, int causal, PBT_STRIDES,
                             void* stream) {
  return launch_pass<true>(q, k, v, dout, qt, kt, ot, mask, lse, delta, dk, dv, B, Sq, Skv,
                           H, D, dtype, causal, PBT_STRIDE_ARGS,
                           reinterpret_cast<cudaStream_t>(stream));
}

// delta = rowsum(dO * O) into (B, H, S) f32; dO's and O's strides in
// elements for the (B, S, H) axes; D 128 or 256.
extern "C" int pbt_flash_delta(const void* dout, const void* out, void* delta, int B,
                               int S, int H, int D, int dtype, long long osb, long long oss,
                               long long osh, long long tsb, long long tss,
                               long long tsh, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S * H;
  const int per_block = DELTA_THREADS / (D / 8);
  const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
  auto bf16 = [&](auto kernel) {
    kernel<<<grid, DELTA_THREADS, 0, st>>>(
        (const __nv_bfloat16*)dout, (const __nv_bfloat16*)out, (float*)delta, S, H, rows,
        osb, oss, osh, tsb, tss, tsh);
  };
  auto f32 = [&](auto kernel) {
    kernel<<<grid, DELTA_THREADS, 0, st>>>(
        (const float*)dout, (const float*)out, (float*)delta, S, H, rows, osb, oss, osh,
        tsb, tss, tsh);
  };
  if (dtype == 1)
    D == 128 ? bf16(flash_delta_kernel<__nv_bfloat16, 128>)
             : bf16(flash_delta_kernel<__nv_bfloat16, 256>);
  else
    D == 128 ? f32(flash_delta_kernel<float, 128>) : f32(flash_delta_kernel<float, 256>);
  return (int)cudaGetLastError();
}

// The f32 prep, one launch for the n (<= SPLIT_MAX) operands that `args`
// (a host SplitArgs) describes: each x (B, S, H, D) f32 at element strides
// for its (B, S, H) axes (the D axis contiguous, 16-byte aligned rows) into
// natural planes nat (2, B, H, S, D) and transposed planes tr (2, B, H, D,
// S), either of which may be null.  Each S a multiple of 32; D 128 or 256.
extern "C" int pbt_tf32_split(const void* args, int n, int B, int H, int D, void* stream) {
  if (D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  const SplitArgs a = *reinterpret_cast<const SplitArgs*>(args);
  int s_max = 0;
  for (int i = 0; i < n; ++i) s_max = max(s_max, a.S[i]);
  const dim3 grid(s_max / SPLIT_ROWS, H, B * n);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 128)
    tf32_split_kernel<128><<<grid, 256, 0, st>>>(a, B, H);
  else
    tf32_split_kernel<256><<<grid, 256, 0, st>>>(a, B, H);
  return (int)cudaGetLastError();
}
