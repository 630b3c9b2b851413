// Flash attention backward for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces three Pallas TPU kernels of pianobart_tpu/ops/flash.py, one C
// entry each, all running the two CUDA kernels below:
//   pbt_flash_bwd  K2, :351 _bwd_fused_kernel (launched by _bwd_fused_call
//                  where S <= 1024): the dK/dV kernel, then the dQ kernel;
//   pbt_flash_dq   K3a, :276 _dq_kernel (launched by _dq_call where S > 1024
//                  and by the ring backward): the dQ kernel;
//   pbt_flash_dkv  K3b, :312 _dkv_kernel (_dkv_call): the dK/dV kernel.
// Same contract as the Pallas calls, at head width D = 128 n up to 4096 in
// bf16 and 2048 in f32:
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
// flash_bwd_d256_wgmma_kernel<DKV> (dK/dV: 64 kv rows a CTA, S^T computed
// once by one warpgroup, which hands P^T to the other, dV in the first and
// dK in the second; dQ: 128 q rows a CTA, 64 a warpgroup, K and V through
// three 32 KB slots); the f32 ones are flash_bwd_tf32_kernel<DKV, 256>, the
// D = 128 kernel run as a cluster of two CTAs, one per 128-column half of
// the head, that sum S and dP across the pair (both described where they
// are defined).  Bounds at the --heads 4 shapes equal the D = 128 ones above
// (H*D = 1024 in both): K2 0.3421 ms at B=32, S=1024; K3a 0.4105 and K3b
// 0.5474 ms at B=16, S=2048.
//
// At D = 384 .. 4096 (bf16) and 384 .. 2048 (f32) both types run as
// clusters that sum S and dP across the cluster through distributed shared
// memory: bf16 flash_bwd_d256_wgmma_kernel<DKV, true>, clusters of
// ceil(D / 256) CTAs of the D = 256 design, 256 columns each (up to 8, the
// card's largest portable cluster, to D = 2048; 9 .. 16, non-portable, to
// D = 4096); f32 flash_bwd_wide_tf32_kernel<DKV>, clusters of D / 128
// CTAs (9 .. 16 past D = 1024, the non-portable sizes H100 allows), two
// consumer warpgroups on alternate swept tiles of 32 rows over the fixed
// rows' planes (both described where they are defined); the delta kernel a
// warp a row and the prep 8 rows and up to 1024 columns a CTA.  Bounds at
// --heads 2 (D = 512, H = 2) equal the D = 128 ones above, and so do those
// of --hs 2048 --heads 1 (D = 2048, H = 1) at half the batch and of
// --hs 4096 --heads 1 (D = 4096) at a quarter.
#include <type_traits>

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
// delta in boxes of TILE (DKV) or FIX entries.  D: the head width, 128.
template <bool DKV, int D>
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
  static_assert(D == BWD_D, "the D = 128 design");
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
// the fixed K and V of 128 rows with 4 stages of 64 would take 512 KB.  Each
// 256-wide row is four 64-column boxes; S and dP are m64n64k16 over 16 k16
// steps, the last products m64n128k16 (one for each 128-column half of the
// head).  Two consumer warpgroups and the producer, as above.
//
// What bounds these kernels on the card is not the tensor cores alone: an
// m64n64k16 product from shared memory reads its 2 KB of A and 2 KB of B in
// the 32 cycles the tensor cores take for it, the SM's whole shared-memory
// bandwidth (128 bytes a cycle), beside the TMA writes of the swept tiles.
// And the rings have room for 2 tiles of 64 KB only, so a tile's load hides
// under the tile before it only if each tile is released as soon as it is
// done with: issuing the next tile's score products before this tile's last
// product (as the D = 128 dQ kernel does) holds two tiles and leaves the
// third's load exposed (it cost these kernels 25-50%).  What overlaps
// instead is a tile's own elementwise work and its last product: both run in
// two parts of 32 columns (the product's k16 steps 0-1 and 2-3), part 0's
// half of the product issued before part 1's elementwise work.
//
//   dK/dV: one CTA per (64 kv rows, head, batch); K and V loaded once (32 KB
//     each), Q, dO and their lse and delta rows through 2 stages of 64 q rows
//     (64 KB a stage).  Warpgroup 0 runs S^T = K Q^T, makes P^T in f32 and
//     hands it to warpgroup 1 through shared memory (16 KB, two buffers so
//     that it can run a tile ahead), and runs dV += P^T dO; warpgroup 1 runs
//     dP^T = V dO^T meanwhile, forms dS^T = P^T (dP^T - delta) from the P^T
//     it is handed and runs dK += dS^T Q.  Four products a tile where computing
//     S^T in both warpgroups runs five, two in each warpgroup; each
//     thread holds one 64 x 256 accumulator (128 f32) beside one score tile
//     (32).  P^T is the value warpgroup 1 would have computed itself, and
//     the products sum in the same order, so dK and dV are those of the
//     five-product schedule to the bit.
//   dQ: one CTA per (128 q rows, head, batch), each warpgroup 64 of them
//     with its own 64 x 256 dQ (128 f32), so a warpgroup runs S = Q K^T,
//     dP = dO V^T, P and dS in registers and dQ += dS K on its rows with no
//     handoff; Q and dO loaded once (64 KB each), the kv tiles' V and K
//     (with its 64 mask entries) through a ring of 3 slots of 32 KB, in the
//     order V0 K0 V1 K1 ...: V's slot is free once dP has read it and K's
//     once dQ += dS K has, so both of the next tile's operands load under
//     this tile.  Both warpgroups read every tile, which so feeds twice the
//     rows a CTA of 64 q rows would (whose two warpgroups would take the
//     tiles in turn, each waiting out its own stage's reload: on the card
//     ~1,200 cycles a tile).
// A handoff is a pair of named barriers per buffer: the writer arrives on
// "full" after its stores, the reader syncs on it; the reader arrives on
// "empty" after its loads, the writer syncs on it before it writes the
// buffer again.  A thread's values sit at 16-byte chunk k * 128 + tid, so a
// warp's accesses are consecutive and the reader's thread tid, whose
// accumulator layout is the writer's, reads what thread tid wrote.  A
// product's fence, issue and commit stay on one path: a wgmma whose
// warpgroup-arrive ptxas must place on a divergent path makes it serialize
// every product of the kernel.  No atomics.
constexpr int W_D = 256;
constexpr int W_FIX = 64;               // dK/dV: fixed kv rows per CTA
constexpr int W_STAGES = 2;
constexpr int W_OPND = 2 * W_D;         // bytes per row of a (rows, 256) bf16 operand
constexpr int W_SCORES = TILE * TILE * 4;   // a 64 x 64 f32 score tile: 16 KB
constexpr int Q_FIX = 128;              // dQ: fixed q rows per CTA
constexpr int Q_SLOTS = 3;

struct Dkv256Smem {
  static constexpr int A1 = 0;                          // K, fixed
  static constexpr int A2 = A1 + W_FIX * W_OPND;        // V, fixed
  static constexpr int B = A2 + W_FIX * W_OPND;         // per stage: Q, then dO
  static constexpr int STAGE = 2 * TILE * W_OPND;
  static constexpr int HAND = B + W_STAGES * STAGE;     // P^T, two buffers
  static constexpr int FIXV = HAND + 2 * W_SCORES;      // the kv rows' mask
  static constexpr int STV = FIXV + W_FIX * 4;          // per stage: lse and delta
  static constexpr int STV_STAGE = 2 * TILE * 4;
  static constexpr int BAR = STV + W_STAGES * STV_STAGE;  // fix, full[S], free[S]
  static constexpr int ALLOC = BAR + (1 + 2 * W_STAGES) * 8 + 1024;
};

struct Dq256Smem {
  static constexpr int A1 = 0;                          // Q, fixed: boxes of 128 rows
  static constexpr int A2 = A1 + Q_FIX * W_OPND;        // dO, fixed
  static constexpr int RING = A2 + Q_FIX * W_OPND;      // slots of one 64-row K or V tile
  static constexpr int SLOT = TILE * W_OPND;
  static constexpr int SIDE = RING + Q_SLOTS * SLOT;    // per slot: a K tile's mask entries
  static constexpr int SIDE_SLOT = TILE * 4;
  static constexpr int FIXV = SIDE + Q_SLOTS * SIDE_SLOT;   // the q rows' lse, then delta
  static constexpr int BAR = FIXV + 2 * Q_FIX * 4;      // fix, full[SLOTS], free[SLOTS]
  static constexpr int ALLOC = BAR + (1 + 2 * Q_SLOTS) * 8 + 1024;
};
static_assert(Dkv256Smem::ALLOC <= 232448 && Dq256Smem::ALLOC <= 232448,
              "a CTA's shared memory");

// A cluster's CTA (WIDE, D = 384 .. 4096; see the kernel's comment).  Each
// consumer warpgroup sums one 64 x 64 f32 score tile at a time across the
// cluster, through a 16 KB region of its own.
constexpr int W_SLOT = TILE * W_OPND;   // a 64-row tile of a 256-column operand: 32 KB
constexpr int X_UNITS = TILE / 8 * 128; // a score tile over a warpgroup in 16-byte units
constexpr int X_REGION = X_UNITS * 16;
static_assert(X_UNITS >= cluster_region_units(X_UNITS, 16), "cluster_sum's region, n = 3 .. 15");
// barriers of a consumer warpgroup's exchange: cluster_sum_init's four, or
// pair_sum_init's for up to four rounds (16 CTAs: the other choice there,
// which scripts/cluster_probe.py times)
constexpr int XB = 5;

// dK/dV: Q and dO through a ring of three 32 KB slots, Q_i then dO_i, lse
// beside Q and delta beside dO, where the D = 256 kernel keeps two 64 KB
// stages; the 32 KB so freed holds the two regions.
struct Dkv256WideSmem {
  static constexpr int A1 = 0;                          // K, fixed
  static constexpr int A2 = A1 + W_FIX * W_OPND;        // V, fixed
  static constexpr int RING = A2 + W_FIX * W_OPND;      // slots of one 64-row Q or dO tile
  static constexpr int HAND = RING + Q_SLOTS * W_SLOT;  // P^T, two buffers
  static constexpr int FIXV = HAND + 2 * W_SCORES;      // the kv rows' mask
  static constexpr int SIDE = FIXV + W_FIX * 4;         // per slot: lse (Q) or delta (dO)
  static constexpr int X = SIDE + Q_SLOTS * TILE * 4;   // a region a consumer warpgroup
  // fix, full[3], free[3]; XB a warpgroup's exchange
  static constexpr int BAR = X + NWG * X_REGION;
  static constexpr int ALLOC = BAR + (1 + 2 * Q_SLOTS + XB * NWG) * 8 + 1024;
};

// dQ: V and K through two slots, where the D = 256 kernel keeps three; the
// 32 KB so freed holds the two regions, through which a warpgroup sums dP,
// then S.
struct Dq256WideSmem {
  static constexpr int NS = 2;
  static constexpr int A1 = 0;                          // Q, fixed: boxes of 128 rows
  static constexpr int A2 = A1 + Q_FIX * W_OPND;        // dO, fixed
  static constexpr int RING = A2 + Q_FIX * W_OPND;      // V_i in slot 0, K_i in slot 1
  static constexpr int SIDE = RING + NS * W_SLOT;       // per slot: a K tile's mask entries
  static constexpr int FIXV = SIDE + NS * TILE * 4;     // the q rows' lse, then delta
  static constexpr int X = FIXV + 2 * Q_FIX * 4;        // a region a consumer warpgroup
  static constexpr int BAR = X + NWG * X_REGION;        // fix, full[2], free[2]; XB a warpgroup
  static constexpr int ALLOC = BAR + (1 + 2 * NS + XB * NWG) * 8 + 1024;
};
static_assert(Dkv256WideSmem::ALLOC <= 232448 && Dq256WideSmem::ALLOC <= 232448,
              "a CTA's shared memory");

// The cluster sizes at which a warpgroup sums by pair rounds
// (hopper.cuh:pair_rounds), the others by cluster_sum: 2 and 4 in both
// kernels, 8 in dQ alone.  At 8 (D = 1920, 2048) the dK/dV kernel took
// 1.48-1.51 ms by cluster_sum and 1.58-1.59 by pair rounds, the dQ kernel
// 1.41-1.45 either way (B=16, S=1024, H=1, D=2048; scripts/cluster_probe.py,
// three calls, H100 at 700 W); at 16 (D = 4096) cluster_sum took 1.819-1.823
// ms in dQ and 1.985-1.993 in dK/dV, four pair rounds 1.951-1.952 and
// 2.158-2.172 (B=8, S=1024, H=1; the same script, H100 at 700 W).
// The barriers' setup and the exchange read one mask, so they agree at
// every n.
template <bool DKV>
constexpr uint32_t BWD_PAIRS = DKV ? (1u << 2) | (1u << 4) : (1u << 2) | (1u << 4) | (1u << 8);

// A warpgroup's 64 x 64 f32 score tile over its CTA's 256 columns becomes
// the tile over all of D, the same in every CTA to the bit: a pair adds the
// two in one round (hopper.cuh:pair_sum), four CTAs (p0 + p1) + (p2 + p3)
// in two, eight in dQ in three, other n in rank order (cluster_sum).  x
// counts the warpgroup's exchanges.  The cluster's
// shape is read anew at each exchange, so that no register holds it across
// the products.
template <bool DKV>
__device__ __forceinline__ void sum_scores(float (&v)[TILE / 2], unsigned char* region,
                                           uint64_t* xb, uint32_t x, int tid) {
  constexpr uint32_t PAIRS = BWD_PAIRS<DKV>;
  const uint32_t n = cluster_nctarank();
  const int rounds = pair_rounds<PAIRS>(n);
  if (rounds) pair_sum(v, region, xb, cluster_ctarank(), x, rounds, 128, tid);
  else cluster_sum(cluster_sum_shape(X_UNITS, 128, tid), region, xb, x & 1, 128, tid, true, v);
}

// this thread's 32 scores (a 64 x 64 f32 accumulator) into a handoff buffer
__device__ __forceinline__ void put_scores(float* buf, const float (&v)[TILE / 2], int tid) {
#pragma unroll
  for (int k = 0; k < TILE / 8; ++k)
    reinterpret_cast<float4*>(buf)[k * 128 + tid] =
        make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// A tile's elementwise work and its last product run in two parts: part h
// is the tile's columns 32 h .. 32 h + 31 (8-column groups 4 h .. 4 h + 3
// of the accumulator), which are the last product's k16 steps 2 h, 2 h + 1.
// Part 0's half of the product is issued before part 1's elementwise work,
// and runs under it.
constexpr int PART_J = TILE / 16;       // 8-column groups a part
constexpr int PART_K = TILE / 32;       // k16 steps a part

// dK/dV, part h of one q tile: s holds S^T and becomes P^T (probs_t's
// arithmetic without dP^T); lse the tile's 64 entries
template <bool DIAG>
__device__ __forceinline__ void probs_t_p_part(float (&s)[TILE / 2], const float* lse,
                                               const bool (&keep)[2], int kvrow, int q0, int t,
                                               int h) {
#pragma unroll
  for (int jj = 0; jj < PART_J; ++jj) {
    const int j = PART_J * h + jj, c = 8 * j + 2 * t;
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

// dQ, part h of one kv tile: probs' arithmetic (s becomes P, dp dS)
template <bool DIAG>
__device__ __forceinline__ void probs_part(float (&s)[TILE / 2], float (&dp)[TILE / 2],
                                           const int* mk, const float (&lse)[2],
                                           const float (&delta)[2], int row, int kv0, int t,
                                           int h) {
#pragma unroll
  for (int jj = 0; jj < PART_J; ++jj) {
    const int j = PART_J * h + jj, c = 8 * j + 2 * t;
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

// dK/dV, part h of one q tile: dp holds dP^T and becomes dS^T = P^T (dP^T -
// delta), P^T read from warpgroup 0's handoff buffer (ds_t's arithmetic),
// with the tile's 64 delta entries
__device__ __forceinline__ void ds_t_handed(float (&dp)[TILE / 2], const float* pt,
                                            const float* delta, int t, int tid, int h) {
#pragma unroll
  for (int jj = 0; jj < PART_J; ++jj) {
    const int j = PART_J * h + jj;
    const float4 p = reinterpret_cast<const float4*>(pt)[j * 128 + tid];
    const float2 d = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
    dp[4 * j] = p.x * (dp[4 * j] - d.x);
    dp[4 * j + 1] = p.y * (dp[4 * j + 1] - d.y);
    dp[4 * j + 2] = p.z * (dp[4 * j + 2] - d.x);
    dp[4 * j + 3] = p.w * (dp[4 * j + 3] - d.y);
  }
}

// part h of pack_a: the A fragments of k16 steps 2 h, 2 h + 1
__device__ __forceinline__ void pack_a_part(uint32_t (&x)[TILE / 16][4], const float (&v)[TILE / 2],
                                            int h) {
#pragma unroll
  for (int kk = PART_K * h; kk < PART_K * h + PART_K; ++kk)
    acc_to_a(x[kk], &v[8 * kk], &v[8 * kk + 4]);
}

// part h of issue_rs: acc += X B over k16 steps 2 h, 2 h + 1.  Issued, not
// fenced or committed.
template <int D>
__device__ __forceinline__ void issue_rs_part(float (&acc)[D / 2],
                                              const uint32_t (&x)[TILE / 16][4],
                                              const unsigned char* b, int h) {
  const uint64_t db = smem_desc_sw128(b, TILE * ROW);
#pragma unroll
  for (int kk = PART_K * h; kk < PART_K * h + PART_K; ++kk)
#pragma unroll
    for (int n = 0; n < D / 128; ++n)
      wgmma_rs_n128_tb(acc_half(acc, n), x[kk], db + (n * 2 * TILE * ROW + kk * 16 * ROW) / 16);
}

// DKV: dK (out1) and dV (out2) of 64 kv rows; else dQ (out1) of 128 q rows.
// Tensor maps: k, v in boxes of 64 rows; q, dO in boxes of 64 (DKV) or 128
// rows; the mask in boxes of 64 keys; lse and delta in boxes of 64 (DKV) or
// 128 entries.
//
// Wide heads (WIDE, D = 384 .. 4096; dw the head width, which D = 256 does
// not read): clusters of n = ceil(D / 256) of these CTAs along x
// (blockIdx.x / n the fixed tile, the cluster rank r the columns 256 r ..
// 256 r + 255 of the head), each the design above on its columns of every
// operand, storing its columns of dK and dV (or dQ); where D is not a
// multiple of 256 (384, 640, .., 3968) the last CTA's upper 128 columns lie
// past D, TMA fills them with zeros and nothing is stored there; past 8 CTAs
// (D = 2176 .. 4096) the clusters are H100's non-portable sizes.  S^T and
// dP^T (S and dP) run over all of D: each warpgroup sums its one 64 x 64 f32
// tile across the cluster right after its product (sum_scores: one pair
// round at n = 2, two at n = 4, three at n = 8 in dQ, cluster_sum at the
// other n, 16 too), 16 KB an exchange, so
// every CTA holds the same P^T and dS^T (P and dS) to the bit and dK, dV and
// dQ stay column-local, with no atomics.  In dK/dV the two warpgroups
// exchange at once, S^T and dP^T; in dQ a warpgroup sums dP while its S
// = Q K^T runs, then S.  Clusters of D / 128 CTAs of the D = 128 kernel,
// the design this one replaced, summed both tiles at once by reduce-scatter
// and all-gather, with no product in flight and 1.5x the partials a round
// trip; here a CTA does the products of 256 columns for each exchange, and
// a pair exchanges in one round.
//
// The exchanges' 2 x 16 KB regions do not fit beside the D = 256 layouts
// (0.7 and 0.2 KB left): the dK/dV kernel streams Q and dO through a ring of
// three 32 KB slots (Q_i, then dO_i) where it keeps two 64 KB stages, and
// the dQ kernel V and K through two slots where it keeps three.  So in
// dK/dV, Q_i+1 lands as soon as warpgroup 0 is done with tile i-1 (its S^T
// leads), and only dO_i+1 waits for the end of tile i, under the other
// warpgroup's products; in dQ, V_i+1 lands under tile i and K_i+1 under the
// dP exchange of tile i+1.  The other candidates (64 fixed q rows a dQ CTA;
// one region a CTA with S and dP summed in turn in dK/dV too) hold the same
// bytes with fewer rows a load or more exchanges in series; not measured.
template <bool DKV, bool WIDE>
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
                            int Sq, int Skv, int H, int causal, int dw) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;

  if constexpr (WIDE) {
    // ---- a cluster's CTA: the D = 256 design (below) on its 256 columns
    const uint32_t n_cta = cluster_nctarank();
    using L = std::conditional_t<DKV, Dkv256WideSmem, Dq256WideSmem>;
    constexpr int NS = DKV ? Q_SLOTS : Dq256WideSmem::NS;
    uint64_t* bar_fix = reinterpret_cast<uint64_t*>(sm + L::BAR);
    uint64_t* bar_full = bar_fix + 1;     // slot s landed
    uint64_t* bar_free = bar_full + NS;   // slot s read by every consumer warp
    uint64_t* bar_x = bar_free + NS;      // XB a consumer warpgroup's exchange
    const int f0 = (blockIdx.x / n_cta) * (DKV ? W_FIX : Q_FIX);
    // swept tiles i0 .. n-1: under causal, dK/dV from the tile of row f0,
    // dQ to the tile of key f0 + 127; tile i is items 2 (i - i0) and
    // 2 (i - i0) + 1 of the ring: Q (with lse) then dO (with delta), or V
    // then K (with the mask entries)
    int i0 = 0, n = (DKV ? Sq : Skv) / TILE;
    if (causal) {
      if (DKV) i0 = min(f0 / TILE, n);
      else n = min(n, (f0 + Q_FIX - 1) / TILE + 1);
    }
    if (threadIdx.x == 0) {
      mbar_init(bar_fix, 1);
      for (int s = 0; s < NS; ++s) {
        mbar_init(bar_full + s, 1);
        mbar_init(bar_free + s, 4 * NWG);
      }
      for (int g = 0; g < NWG; ++g)
        score_sum_init(bar_x + XB * g, n_cta, pair_rounds<BWD_PAIRS<DKV>>(n_cta));
      mbar_fence_init();
    }
    cluster_sync();                     // every CTA's barriers ready
    auto slot = [&](int k) { return sm + L::RING + (k % NS) * W_SLOT; };
    auto side = [&](int k) { return sm + L::SIDE + (k % NS) * (TILE * 4); };

    if (wg == NWG) {
      // ---- producer warpgroup: one thread keeps the ring full
      setmaxnreg_dec<24>();
      if (threadIdx.x == 128 * NWG) {
        const int c0 = (int)cluster_ctarank() * W_D;   // the CTA's first column of the head
        const int fix = DKV ? W_FIX : Q_FIX;
        mbar_arrive_expect_tx(bar_fix, 2 * fix * W_OPND + (DKV ? 1 : 2) * fix * 4);
#pragma unroll
        for (int x = 0; x < W_D / BOX; ++x) {
          tma_load_4d(sm + L::A1 + x * fix * ROW, DKV ? &tk : &tq, bar_fix, c0 + x * BOX, h, f0,
                      b);
          tma_load_4d(sm + L::A2 + x * fix * ROW, DKV ? &tv : &to, bar_fix, c0 + x * BOX, h, f0,
                      b);
        }
        if (DKV) {
          tma_load_2d(sm + L::FIXV, &tm, bar_fix, f0, b);
        } else {
          tma_load_2d(sm + L::FIXV, &tl, bar_fix, f0, bh);
          tma_load_2d(sm + L::FIXV + Q_FIX * 4, &td, bar_fix, f0, bh);
        }
        for (int k = 0; k < 2 * (n - i0); ++k) {
          const int s = k % NS, r0 = (i0 + k / 2) * TILE;
          const bool second = (k & 1) == 1;   // dO or K
          const CUtensorMap* map = DKV ? (second ? &to : &tq) : (second ? &tk : &tv);
          mbar_wait(bar_free + s, ((k / NS) & 1) ^ 1);   // the first round passes
          mbar_arrive_expect_tx(bar_full + s, W_SLOT + (DKV || second ? TILE * 4 : 0));
#pragma unroll
          for (int x = 0; x < W_D / BOX; ++x)
            tma_load_4d(slot(k) + x * TILE * ROW, map, bar_full + s, c0 + x * BOX, h, r0, b);
          if (DKV) tma_load_2d(side(k), second ? &td : &tl, bar_full + s, r0, bh);
          else if (second) tma_load_2d(side(k), &tm, bar_full + s, r0, b);
        }
      }
    } else {
      // ---- consumer warpgroup wg
      setmaxnreg_inc<240>();
      unsigned char* region = sm + L::X + wg * X_REGION;
      uint64_t* xb = bar_x + XB * wg;
      auto wait_item = [&](int k) { mbar_wait(bar_full + k % NS, (k / NS) & 1); };
      auto release = [&](int k) {       // item k's slot may be refilled
        if (lane == 0) mbar_arrive(bar_free + k % NS);
      };
      float acc[W_D / 2];               // dV (wg 0) or dK (wg 1); or dQ
#pragma unroll
      for (int i = 0; i < W_D / 2; ++i) acc[i] = 0.f;
      mbar_wait(bar_fix, 0);
      int fr, s_fixed;                  // this thread's rows fr, fr + 8 of the CTA
      bool active;                      // the warpgroup's rows lie below S
      if constexpr (DKV) {
        // the CTA's 64 kv rows f0 .. f0 + 63.  Warpgroup 0 reads Q_i first
        // (S^T, with lse for P^T) and dO_i last (dV); warpgroup 1 dO_i first
        // (dP^T, with delta for dS^T) and Q_i last (dK).  Each releases its
        // first item once its elementwise work is done and its last once
        // its last product is in, so Q_i+1 loads as soon as warpgroup 0 is
        // done with tile i-1 and only dO_i+1 waits for the end of tile i.
        fr = warp * 16 + lane / 4;
        s_fixed = Skv;
        active = true;
        const int row = f0 + fr;
        bool keep[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          keep[r] = reinterpret_cast<const int*>(sm + L::FIXV)[fr + 8 * r] != 0;
        // P^T of the j-th tile in buffer j % 2; named barriers 1 + j % 2
        // ("full") and 3 + j % 2 ("empty") over both warpgroups
        float* hand = reinterpret_cast<float*>(sm + L::HAND);
        const int count = n - i0;
        for (int i = i0; i < n; ++i) {
          const int j = i - i0, r0 = i * TILE;
          const int k1 = 2 * j + wg, k2 = 2 * j + 1 - wg;   // the first and last items
          float* pt = hand + (j & 1) * (TILE * TILE);
          float sc[TILE / 2];
          uint32_t x[TILE / 16][4];
          wait_item(k1);
          // S^T = K Q^T (wg 0) or dP^T = V dO^T (wg 1), over the CTA's columns
          wgmma_fence();
          issue_ss<W_D, W_FIX>(sc, sm + (wg == 0 ? L::A1 : L::A2), slot(k1));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          sum_scores<DKV>(sc, region, xb, j, tid);      // over all of D
          const float* lv = reinterpret_cast<const float*>(side(k1));   // lse or delta
          const unsigned char* bt = slot(k2);
          auto last_part = [&](int h) {                  // part h of dV += P^T dO, or dK += dS^T Q
            fence_regs(sc);
            pack_a_part(x, sc, h);
            fence_regs(acc);
            fence_regs(x);
            wgmma_fence();
            issue_rs_part<W_D>(acc, x, bt, h);
            wgmma_commit();
          };
          if (wg == 0) {                                 // P^T, handed over
            const bool dg = causal && r0 < f0 + W_FIX - 1;
            if (dg) probs_t_p_part<true>(sc, lv, keep, row, r0, t, 0);
            else probs_t_p_part<false>(sc, lv, keep, row, r0, t, 0);
            wait_item(k2);
            last_part(0);
            if (dg) probs_t_p_part<true>(sc, lv, keep, row, r0, t, 1);
            else probs_t_p_part<false>(sc, lv, keep, row, r0, t, 1);
            release(k1);
            if (j >= 2) {
              if (j & 1) named_barrier_sync<4>(128 * NWG);
              else named_barrier_sync<3>(128 * NWG);
            }
            put_scores(pt, sc, tid);
            if (j & 1) named_barrier_arrive<2>(128 * NWG);
            else named_barrier_arrive<1>(128 * NWG);
          } else {                                       // dS^T from the P^T handed over
            if (j & 1) named_barrier_sync<2>(128 * NWG);
            else named_barrier_sync<1>(128 * NWG);
            ds_t_handed(sc, pt, lv, t, tid, 0);
            wait_item(k2);
            last_part(0);
            ds_t_handed(sc, pt, lv, t, tid, 1);
            release(k1);
            if (j + 2 < count) {
              if (j & 1) named_barrier_arrive<4>(128 * NWG);
              else named_barrier_arrive<3>(128 * NWG);
            }
          }
          last_part(1);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(x);
          release(k2);
        }
      } else {
        // q rows w0 .. w0 + 63.  dP is issued first (V_i lands under tile
        // i-1, K_i only once tile i-1's dQ += dS K is in) and summed across
        // the cluster while S = Q K^T runs; then S is summed.
        const int w0 = f0 + wg * 64;
        fr = wg * 64 + warp * 16 + lane / 4;
        s_fixed = Sq;
        active = w0 < Sq;
        const int row = f0 + fr;
        int ie = active ? n : 0;
        if (causal && active) ie = min(n, w0 / TILE + 1);
        float lse_r[2], dl_r[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lse_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[fr + 8 * r];
          dl_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[Q_FIX + fr + 8 * r];
        }
        const unsigned char* a1 = sm + L::A1 + wg * 64 * ROW;
        const unsigned char* a2 = sm + L::A2 + wg * 64 * ROW;
        for (int i = 0; i < n; ++i) {
          const int kv = 2 * i, kk = 2 * i + 1, r0 = i * TILE;
          if (i >= ie) {
            wait_item(kv);
            release(kv);
            wait_item(kk);
            release(kk);
            continue;
          }
          float sc[TILE / 2], dp[TILE / 2];
          uint32_t x[TILE / 16][4];
          wait_item(kv);
          wgmma_fence();
          issue_ss<W_D, Q_FIX>(dp, a2, slot(kv));       // dP = dO V^T
          wgmma_commit();
          wait_item(kk);
          wgmma_fence();
          issue_ss<W_D, Q_FIX>(sc, a1, slot(kk));       // S = Q K^T
          wgmma_commit();
          wgmma_wait<1>();                              // dP is in
          fence_regs(dp);
          release(kv);
          sum_scores<DKV>(dp, region, xb, 2 * i, tid);
          wgmma_wait<0>();
          fence_regs(sc);
          sum_scores<DKV>(sc, region, xb, 2 * i + 1, tid);
          const int* mk = reinterpret_cast<const int*>(side(kk));
          const bool dg = causal && r0 + TILE - 1 > w0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {                  // dQ += dS K, part by part
            if (dg) probs_part<true>(sc, dp, mk, lse_r, dl_r, row, r0, t, h);
            else probs_part<false>(sc, dp, mk, lse_r, dl_r, row, r0, t, h);
            fence_regs(dp);
            pack_a_part(x, dp, h);
            fence_regs(acc);
            fence_regs(x);
            wgmma_fence();
            issue_rs_part<W_D>(acc, x, slot(kk), h);
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(x);
          release(kk);
        }
      }
      if (active) {                     // dV (wg 0) and dK (wg 1), or dQ
        __nv_bfloat16* out = DKV && wg == 0 ? out2 : out1;
        const int c0 = (int)cluster_ctarank() * W_D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long at =
              (((long long)b * s_fixed + (f0 + fr) + 8 * r) * H + h) * dw + c0;
#pragma unroll
          for (int dt = 0; dt < W_D / 8; ++dt)
            if (c0 + dt * 8 < dw)       // columns past D: TMA's zeros
              *reinterpret_cast<uint32_t*>(out + at + dt * 8 + 2 * t) =
                  pack_bf16(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
        }
      }
    }
    cluster_sync();                     // no CTA leaves while a peer may reach it
  } else if constexpr (DKV) {
    using L = Dkv256Smem;
    constexpr int NS = W_STAGES;
    uint64_t* bar_fix = reinterpret_cast<uint64_t*>(sm + L::BAR);
    uint64_t* bar_full = bar_fix + 1;     // stage s landed
    uint64_t* bar_free = bar_full + NS;   // stage s read by every consumer warp
    const int f0 = blockIdx.x * W_FIX;
    // q tiles i0 .. n-1: under causal, from the tile of row f0
    const int n = Sq / TILE;
    const int i0 = causal ? min(f0 / TILE, n) : 0;

    if (threadIdx.x == 0) {
      mbar_init(bar_fix, 1);
      for (int s = 0; s < NS; ++s) {
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
        mbar_arrive_expect_tx(bar_fix, 2 * W_FIX * W_OPND + W_FIX * 4);
#pragma unroll
        for (int x = 0; x < W_D / BOX; ++x) {
          tma_load_4d(sm + L::A1 + x * W_FIX * ROW, &tk, bar_fix, x * BOX, h, f0, b);
          tma_load_4d(sm + L::A2 + x * W_FIX * ROW, &tv, bar_fix, x * BOX, h, f0, b);
        }
        tma_load_2d(sm + L::FIXV, &tm, bar_fix, f0, b);
        for (int i = i0; i < n; ++i) {
          const int j = i - i0, s = j % NS, r0 = i * TILE;
          mbar_wait(bar_free + s, ((j / NS) & 1) ^ 1);   // the first round passes
          unsigned char* st = sm + L::B + s * L::STAGE;
          unsigned char* sv = sm + L::STV + s * L::STV_STAGE;
          mbar_arrive_expect_tx(bar_full + s, L::STAGE + 2 * TILE * 4);
#pragma unroll
          for (int x = 0; x < W_D / BOX; ++x) {
            tma_load_4d(st + x * TILE * ROW, &tq, bar_full + s, x * BOX, h, r0, b);
            tma_load_4d(st + TILE * W_OPND + x * TILE * ROW, &to, bar_full + s, x * BOX, h,
                        r0, b);
          }
          tma_load_2d(sv, &tl, bar_full + s, r0, bh);
          tma_load_2d(sv + TILE * 4, &td, bar_full + s, r0, bh);
        }
      }
      return;
    }
    // ---- consumer warpgroup wg: the CTA's 64 kv rows f0 .. f0 + 63
    setmaxnreg_inc<240>();
    const int fr = warp * 16 + lane / 4;             // this thread's rows: fr, fr + 8 of the CTA
    const int row = f0 + fr;
    float acc[W_D / 2];                              // dV (wg 0) or dK (wg 1)
#pragma unroll
    for (int i = 0; i < W_D / 2; ++i) acc[i] = 0.f;
    mbar_wait(bar_fix, 0);
    bool keep[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      keep[r] = reinterpret_cast<const int*>(sm + L::FIXV)[fr + 8 * r] != 0;

    // P^T of the j-th tile in buffer j % 2; named barriers 1 + j % 2
    // ("full") and 3 + j % 2 ("empty") over both warpgroups
    float* hand = reinterpret_cast<float*>(sm + L::HAND);
    const int count = n - i0;
    for (int i = i0; i < n; ++i) {
      const int j = i - i0, s = j % NS, r0 = i * TILE;
      const unsigned char* st = sm + L::B + s * L::STAGE;
      const float* lv = reinterpret_cast<const float*>(sm + L::STV + s * L::STV_STAGE);
      float* pt = hand + (j & 1) * (TILE * TILE);
      float sc[TILE / 2];
      uint32_t x[TILE / 16][4];
      mbar_wait(bar_full + s, (j / NS) & 1);
      // S^T = K Q^T (wg 0) or dP^T = V dO^T (wg 1)
      wgmma_fence();
      issue_ss<W_D, W_FIX>(sc, sm + (wg == 0 ? L::A1 : L::A2), st + wg * TILE * W_OPND);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      const unsigned char* bt = st + (wg == 0 ? TILE * W_OPND : 0);
      auto last_part = [&](int h) {                  // part h of dV += P^T dO, or dK += dS^T Q
        fence_regs(sc);
        pack_a_part(x, sc, h);
        fence_regs(acc);
        fence_regs(x);
        wgmma_fence();
        issue_rs_part<W_D>(acc, x, bt, h);
        wgmma_commit();
      };
      if (wg == 0) {                                 // P^T, handed over
        const bool dg = causal && r0 < f0 + W_FIX - 1;
        if (dg) probs_t_p_part<true>(sc, lv, keep, row, r0, t, 0);
        else probs_t_p_part<false>(sc, lv, keep, row, r0, t, 0);
        last_part(0);
        if (dg) probs_t_p_part<true>(sc, lv, keep, row, r0, t, 1);
        else probs_t_p_part<false>(sc, lv, keep, row, r0, t, 1);
        if (j >= 2) {
          if (j & 1) named_barrier_sync<4>(128 * NWG);
          else named_barrier_sync<3>(128 * NWG);
        }
        put_scores(pt, sc, tid);
        if (j & 1) named_barrier_arrive<2>(128 * NWG);
        else named_barrier_arrive<1>(128 * NWG);
      } else {                                       // dS^T from the P^T handed over
        if (j & 1) named_barrier_sync<2>(128 * NWG);
        else named_barrier_sync<1>(128 * NWG);
        ds_t_handed(sc, pt, lv + TILE, t, tid, 0);
        last_part(0);
        ds_t_handed(sc, pt, lv + TILE, t, tid, 1);
        if (j + 2 < count) {
          if (j & 1) named_barrier_arrive<4>(128 * NWG);
          else named_barrier_arrive<3>(128 * NWG);
        }
      }
      last_part(1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(x);
      if (lane == 0) mbar_arrive(bar_free + s);      // stage s may be refilled
    }
    __nv_bfloat16* out = wg == 0 ? out2 : out1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = (((long long)b * Skv + row + 8 * r) * H + h) * W_D;
#pragma unroll
      for (int dt = 0; dt < W_D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(out + at + dt * 8 + 2 * t) =
            pack_bf16(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
    }
  } else {
    using L = Dq256Smem;
    uint64_t* bar_fix = reinterpret_cast<uint64_t*>(sm + L::BAR);
    uint64_t* bar_full = bar_fix + 1;         // slot s landed
    uint64_t* bar_free = bar_full + Q_SLOTS;  // slot s read by every consumer warp
    const int f0 = blockIdx.x * Q_FIX;
    // kv tiles 0 .. n-1 (under causal, to the tile of key f0 + 127), tile i
    // as items 2i (K and its mask entries) and 2i + 1 (V) of the ring
    int n = Skv / TILE;
    if (causal) n = min(n, (f0 + Q_FIX - 1) / TILE + 1);

    if (threadIdx.x == 0) {
      mbar_init(bar_fix, 1);
      for (int s = 0; s < Q_SLOTS; ++s) {
        mbar_init(bar_full + s, 1);
        mbar_init(bar_free + s, 4 * NWG);
      }
      mbar_fence_init();
    }
    __syncthreads();

    if (wg == NWG) {
      setmaxnreg_dec<24>();
      if (threadIdx.x == 128 * NWG) {
        mbar_arrive_expect_tx(bar_fix, 2 * Q_FIX * W_OPND + 2 * Q_FIX * 4);
#pragma unroll
        for (int x = 0; x < W_D / BOX; ++x) {
          tma_load_4d(sm + L::A1 + x * Q_FIX * ROW, &tq, bar_fix, x * BOX, h, f0, b);
          tma_load_4d(sm + L::A2 + x * Q_FIX * ROW, &to, bar_fix, x * BOX, h, f0, b);
        }
        tma_load_2d(sm + L::FIXV, &tl, bar_fix, f0, bh);
        tma_load_2d(sm + L::FIXV + Q_FIX * 4, &td, bar_fix, f0, bh);
        for (int k = 0; k < 2 * n; ++k) {
          const int s = k % Q_SLOTS, r0 = (k / 2) * TILE;
          const bool is_k = (k & 1) == 1;
          mbar_wait(bar_free + s, ((k / Q_SLOTS) & 1) ^ 1);   // the first round passes
          unsigned char* st = sm + L::RING + s * L::SLOT;
          mbar_arrive_expect_tx(bar_full + s, L::SLOT + (is_k ? TILE * 4 : 0));
#pragma unroll
          for (int x = 0; x < W_D / BOX; ++x)
            tma_load_4d(st + x * TILE * ROW, is_k ? &tk : &tv, bar_full + s, x * BOX, h, r0, b);
          if (is_k) tma_load_2d(sm + L::SIDE + s * L::SIDE_SLOT, &tm, bar_full + s, r0, b);
        }
      }
      return;
    }
    // ---- consumer warpgroup wg: q rows w0 .. w0 + 63
    setmaxnreg_inc<240>();
    const int w0 = f0 + wg * 64;
    const int fr = wg * 64 + warp * 16 + lane / 4;   // this thread's rows: fr, fr + 8 of the CTA
    const int row = f0 + fr;
    // S is a multiple of 64: the warpgroup's rows lie all below S or all
    // past it (TMA's zeros); it works on tiles 0 .. ie-1 and only waits for
    // and releases the others
    int ie = w0 < Sq ? n : 0;
    if (causal && w0 < Sq) ie = min(n, w0 / TILE + 1);
    float acc[W_D / 2];
#pragma unroll
    for (int i = 0; i < W_D / 2; ++i) acc[i] = 0.f;
    mbar_wait(bar_fix, 0);
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[fr + 8 * r];
      dl_r[r] = reinterpret_cast<const float*>(sm + L::FIXV)[Q_FIX + fr + 8 * r];
    }
    const unsigned char* a1 = sm + L::A1 + wg * 64 * ROW;
    const unsigned char* a2 = sm + L::A2 + wg * 64 * ROW;
    auto slot = [&](int k) { return sm + L::RING + (k % Q_SLOTS) * L::SLOT; };
    auto wait_item = [&](int k) { mbar_wait(bar_full + k % Q_SLOTS, (k / Q_SLOTS) & 1); };
    auto release = [&](int k) {                      // item k's slot may be refilled
      if (lane == 0) mbar_arrive(bar_free + k % Q_SLOTS);
    };
    for (int i = 0; i < n; ++i) {
      const int kv = 2 * i, kk = 2 * i + 1, r0 = i * TILE;
      if (i >= ie) {
        wait_item(kv);
        release(kv);
        wait_item(kk);
        release(kk);
        continue;
      }
      float sc[TILE / 2], dp[TILE / 2];
      uint32_t x[TILE / 16][4];
      wait_item(kk);
      wgmma_fence();
      issue_ss<W_D, Q_FIX>(sc, a1, slot(kk));       // S = Q K^T
      wgmma_commit();
      wait_item(kv);
      wgmma_fence();
      issue_ss<W_D, Q_FIX>(dp, a2, slot(kv));       // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      release(kv);
      const int* mk = reinterpret_cast<const int*>(sm + L::SIDE + (kk % Q_SLOTS) * L::SIDE_SLOT);
      const bool dg = causal && r0 + TILE - 1 > w0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {                  // dQ += dS K, part by part
        if (dg) probs_part<true>(sc, dp, mk, lse_r, dl_r, row, r0, t, h);
        else probs_part<false>(sc, dp, mk, lse_r, dl_r, row, r0, t, h);
        fence_regs(dp);
        pack_a_part(x, dp, h);
        fence_regs(acc);
        fence_regs(x);
        wgmma_fence();
        issue_rs_part<W_D>(acc, x, slot(kk), h);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(x);
      release(kk);
    }
    if (w0 < Sq) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = (((long long)b * Sq + row + 8 * r) * H + h) * W_D;
#pragma unroll
        for (int dt = 0; dt < W_D / 8; ++dt)
          *reinterpret_cast<uint32_t*>(out1 + at + dt * 8 + 2 * t) =
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

// The same at D = 384 .. 4096 (f32 to 2048): a warp a row, each lane 8
// elements of every 256 columns.
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_delta_wide_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                        float* __restrict__ delta, int S, int H, int D, long long rows,
                        long long osb, long long oss, long long osh,
                        long long tsb, long long tss, long long tsh) {
  const long long r = (long long)blockIdx.x * (DELTA_THREADS / 32) + threadIdx.x / 32;
  const int l = threadIdx.x % 32;
  const int h = (int)(r % H), s = (int)((r / H) % S);
  const long long b = r / H / S;
  float acc = 0.f;
  if (r < rows) {
    for (int c = l * 8; c < D; c += 256) {
      float x[8], y[8];
      load8(dout + b * osb + s * oss + h * osh + c, x);
      load8(out + b * tsb + s * tss + h * tsh + c, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(x[i], y[i], acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
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
// static shared memory, 33 KB at D = 256.  D = 384 .. 2048 (a cluster's
// CTA reads its 128 columns): tf32_split_wide_kernel, D at run time and 8
// rows a CTA (one k group of the transposed order) of W = D / ceil(D /
// 1024) columns (all of D up to 1024, half past it), a tile of at most 32 KB
// under the 48 KB of static shared memory.
constexpr int SPLIT_ROWS = 32;
constexpr int SPLIT_WIDE_ROWS = 8;
constexpr int SPLIT_WIDE_COLS = 1024;
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

// W columns from cw = (blockIdx.x % (D / W)) W of rows s0 .. s0 + 7
__global__ void __launch_bounds__(256)
tf32_split_wide_kernel(const SplitArgs a, int B, int H, int D, int W) {
  constexpr int R = SPLIT_WIDE_ROWS;
  __shared__ float tile[R][SPLIT_WIDE_COLS + 1];
  const int chunks = D / W;
  const int op = blockIdx.z / B, b = blockIdx.z % B, h = blockIdx.y;
  const int s0 = blockIdx.x / chunks * R, S = a.S[op], cw = blockIdx.x % chunks * W;
  if (s0 >= S) return;
  const float* __restrict__ x = a.x[op];
  float* __restrict__ nat = a.nat[op];
  float* __restrict__ tr = a.tr[op];
  const long long sb = a.sb[op], ss = a.ss[op], sh = a.sh[op];
  const long long plane = (long long)B * H * S * D;
  const long long bh = (long long)b * H + h;
  for (int i = threadIdx.x; i < R * W / 4; i += 256) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    const float4 v =
        *reinterpret_cast<const float4*>(x + b * sb + (s0 + r) * ss + h * sh + cw + c);
    if (nat) {
      uint32_t hi[4], lo[4];
      tf32_split(v.x, hi[0], lo[0]);
      tf32_split(v.y, hi[1], lo[1]);
      tf32_split(v.z, hi[2], lo[2]);
      tf32_split(v.w, hi[3], lo[3]);
      const long long at = (bh * S + s0 + r) * D + cw + c;
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
  for (int i = threadIdx.x; i < W * R; i += 256) {
    const int d = i / R, k = i % R;
    uint32_t hi, lo;
    tf32_split(tile[k < 4 ? 2 * k : 2 * k - 7][d], hi, lo);
    const long long at = (bh * D + cw + d) * S + s0 + k;
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

// ------------------------------------------- f32 / 3xTF32 at D = 384 .. 2048
// The f32 dK/dV (DKV) and dQ kernels at D = 128 n, n = 3..16, as clusters of
// n CTAs along x (blockIdx.x / n the fixed tile of 64 rows, the cluster
// rank r the columns 128 r .. 128 r + 127 of the head), each CTA the
// products of the kernel above on its 128 columns of every plane, S^T and
// dP^T (S and dP) summed over all of D across the cluster by
// hopper.cuh:cluster_sum, so that every CTA holds the same P and dS to the
// bit, and its columns of dK and dV (or dQ) stored.
//
// What held the kernel above when run at these widths (one consumer warpgroup,
// 64-row swept tiles) at 2x SDPA: its one warpgroup waited out every
// exchange (two a tile in dK/dV, 8,118 cycles each at D = 512; one of
// 9,421 in dQ) and, with 3 slots of which each product reads 2, the load of
// nearly every plane; the tensor cores had nothing else to do.  So here two
// consumer warpgroups share the fixed rows' four planes (128 KB) and take
// alternate swept tiles of 32 rows (TW_ROWS), each with a ring of its own
// (3 slots of 16 KB, fed by a producer thread of its own), side entries and
// exchange barriers of its own: one warpgroup's exchanges and loads run
// under the other's products.  Half-height swept tiles are what lets the
// second ring fit beside the fixed planes (227 KB in all); the score
// products become m64n32k8, and per swept row the exchanges move what they
// moved.  At 32 rows a warpgroup holds both score tiles (16 + 16 floats a
// thread) beside dK and dV, so dK/dV exchanges S^T and dP^T at once, as dQ
// exchanges S and dP: one exchange a tile where the kernel above takes two.  Per tile:
// S^T = K Q^T and dP^T = V dO^T (S = Q K^T and dP = dO V^T), one exchange of
// both through dO lo's (V lo's) slot, then dV += P^T dO and dK += dS^T Q
// (dQ += dS K), planes in that order: Q, dO, dO^T, Q^T (K, V, K^T).
//
// Both warpgroups accumulate the same fixed rows: each flushes its dK and dV
// (or dQ) into the output every TW_FLUSH of its tiles (48 steps a chain, as
// T_FLUSH's) at the end of each window of 2 TW_FLUSH swept tiles, in two
// phases, each warpgroup on one accumulator (dQ: one 64-column half) at a
// time, the other's in the other phase: dV warpgroup 0 then 1, dK 1 then 0
// (dQ's halves likewise), ordered by named barriers 1 and 2, so every sum
// is taken in one order every run.  The first writer of the first window
// stores; every later add is a reduction in L2 (red.global.add), which
// returns nothing, so a flush waits for no load: the kernel above's load,
// add and store took ~10,000 cycles a tile here (clock64 counters, D=512),
// a third of the dK/dV kernel's time.  A warpgroup without a tile in a
// window flushes its zeros.  A cluster reads what n CTAs of the D = 128 kernel read at the same
// H * D, does their FLOPs, and has the same bound.
constexpr int TW_ROWS = 32;                      // swept rows a tile
constexpr int TW_PLANE = TW_ROWS * 4 * T_D;      // 32 rows x 128 f32 (or 128 x 32): 16 KB
constexpr int TW_SLOTS = 3;                      // a consumer warpgroup's ring
constexpr int TW_FLUSH = 4;                      // own tiles a chain: 4 x 12 steps

// acc (this thread's part of 64 rows x 128, rows `row` and row + 8), or its
// 64-column half `half` (0, 1; -1 for all), into columns c0 .. of the (B, S,
// H, dw) output: stored, or added by reductions in L2 (add), 16 bytes each:
// of two 8-column slices, the even lane of a pair (t, t ^ 1) takes 4
// columns of the first and the odd lane 4 of the second, swapping halves
// with its partner; those entries of acc are zeroed.
__device__ __forceinline__ void flush_red(float* __restrict__ out, float (&acc)[T_D / 2],
                                          int b, int S, int row, int H, int h, int t,
                                          bool add, int c0, int dw, int half) {
  const bool odd = t & 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* at = out + (((long long)b * S + row + 8 * r) * H + h) * dw + c0 + 2 * (t & ~1);
#pragma unroll
    for (int m = 0; m < T_D / 16; ++m) {
      if (half >= 0 && m / (T_D / 32) != half) continue;
      const int i = 8 * m + 2 * r;                  // columns 16 m + 2 t, + 1; then 8 on
      const float sx = __shfl_xor_sync(0xffffffffu, odd ? acc[i] : acc[i + 4], 1);
      const float sy = __shfl_xor_sync(0xffffffffu, odd ? acc[i + 1] : acc[i + 5], 1);
      const float4 v = odd ? make_float4(sx, sy, acc[i + 4], acc[i + 5])
                           : make_float4(acc[i], acc[i + 1], sx, sy);
      float4* dst = reinterpret_cast<float4*>(at + 16 * m + (odd ? 8 : 0));
      if (add)
        atomicAdd(dst, v);
      else
        *dst = v;
      acc[i] = acc[i + 1] = acc[i + 4] = acc[i + 5] = 0.f;
    }
  }
}

struct BwdTf32WideSmem {
  static constexpr int A1H = 0;                      // fixed: K (dK/dV) or Q (dQ), hi
  static constexpr int A1L = A1H + T_PLANE;          //   and lo
  static constexpr int A2H = A1L + T_PLANE;          // fixed: V or dO
  static constexpr int A2L = A2H + T_PLANE;
  static constexpr int RING = A2L + T_PLANE;         // warpgroup w's slots at RING + w RING_BYTES
  static constexpr int RING_BYTES = TW_SLOTS * TW_PLANE;
  static constexpr int FIXV = RING + 2 * RING_BYTES; // fixed rows' mask, or lse and delta
  static constexpr int SIDE = FIXV + 2 * TILE * 4;   // warpgroup w's 2 stages at SIDE + 2 w SIDE_STAGE
  static constexpr int SIDE_STAGE = 2 * TW_ROWS * 4; // lse and delta, or the mask, of a tile
  // a warpgroup's full[S], free[S], sfull[2], sfree[2] and the exchange's four
  static constexpr int WG_BARS = 2 * TW_SLOTS + 4 + 4;
  static constexpr int BAR = SIDE + 4 * SIDE_STAGE;  // fix, then each warpgroup's
  static constexpr int ALLOC = BAR + (1 + 2 * WG_BARS) * 8 + 1024;
  static_assert(ALLOC <= 232448, "a CTA's shared memory");
};

// Tensor maps: the fixed operands' natural planes (DKV tk, tv; dQ tq, to)
// in boxes of TILE rows, the swept ones' (DKV tq, to; dQ tk, tv) in boxes of
// TW_ROWS; tt1, tt2 transposed planes in boxes of 128 rows (DKV: dO^T, Q^T;
// dQ: K^T, K^T); tm the mask and tl, td lse and delta in boxes of TILE
// (fixed) or TW_ROWS (swept) entries.  DKV: dK into out1, dV into out2; else
// dQ into out1.
template <bool DKV>
__global__ void __launch_bounds__(384, 1)
flash_bwd_wide_tf32_kernel(const __grid_constant__ CUtensorMap tq,
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
  using L = BwdTf32WideSmem;
  constexpr int NP = DKV ? 8 : 6;       // planes per swept tile
  constexpr int NS = TW_SLOTS, TR = TW_ROWS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_fix = reinterpret_cast<uint64_t*>(sm + L::BAR);

  // a warpgroup's exchange: S and dP, or S^T and dP^T (32 floats a thread),
  // through a slot of its ring
  constexpr int X_UNITS = 2 * TR / 8 * 128;
  static_assert(cluster_region_units(X_UNITS, 16) * 16 <= TW_PLANE,
                "the exchange fits a slot, n = 3 .. 16");
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const ClusterSum cs = cluster_sum_shape(X_UNITS, 128, tid);
  const int c0 = cs.rank * T_D, dw = cs.n * T_D;   // this CTA's columns, the head's
  const int f0 = blockIdx.x / cs.n * TILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int s_fixed = DKV ? Skv : Sq;
  // swept tiles i0 .. n-1 (skipped as in the kernel above, at 32 rows);
  // warpgroup w takes the j-th of them for j = w, w + 2, ...
  int i0 = 0, n = (DKV ? Sq : Skv) / TR;
  if (causal) {
    if (DKV) i0 = min(f0 / TR, n);
    else n = min(n, (f0 + TILE - 1) / TR + 1);
  }
  const int N = n - i0;
  const int windows = max(1, (N + 2 * TW_FLUSH - 1) / (2 * TW_FLUSH));

  if (threadIdx.x == 0) {
    mbar_init(bar_fix, 1);
    for (int w = 0; w < 2; ++w) {
      uint64_t* wb = bar_fix + 1 + w * L::WG_BARS;
      for (int s = 0; s < NS; ++s) {
        mbar_init(wb + s, 1);
        mbar_init(wb + NS + s, 4);
      }
      for (int e = 0; e < 2; ++e) {
        mbar_init(wb + 2 * NS + e, 1);
        mbar_init(wb + 2 * NS + 2 + e, 4);
      }
      cluster_sum_init(wb + 2 * NS + 4, cs.n, 128);
    }
    mbar_fence_init();
  }
  cluster_sync();                       // every CTA's barriers ready

  if (wg == 2) {
    // ---- producer warpgroup: thread 32 w (lane 0 of warp w) keeps
    // warpgroup w's ring full; warp 0's also loads the fixed rows
    setmaxnreg_dec<24>();
    const int w = tid / 32;
    if (tid % 32 == 0 && w < 2) {
      uint64_t* wb = bar_fix + 1 + w * L::WG_BARS;
      uint64_t* full = wb;
      uint64_t* free_ = wb + NS;
      uint64_t* sfull = wb + 2 * NS;
      uint64_t* sfree = sfull + 2;
      unsigned char* ring = sm + L::RING + w * L::RING_BYTES;
      unsigned char* side = sm + L::SIDE + w * 2 * L::SIDE_STAGE;
      if (w == 0) {
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
      }
      for (int c = 0, j = w; j < N; ++c, j += 2) {
        const int e = c % 2, r0 = (i0 + j) * TR;
        mbar_wait(sfree + e, ((c / 2) & 1) ^ 1);
        unsigned char* sv = side + e * L::SIDE_STAGE;
        if (DKV) {
          mbar_arrive_expect_tx(sfull + e, 2 * TR * 4);
          tma_load_2d(sv, &tl, sfull + e, r0, bh);
          tma_load_2d(sv + TR * 4, &td, sfull + e, r0, bh);
        } else {
          mbar_arrive_expect_tx(sfull + e, TR * 4);
          tma_load_2d(sv, &tm, sfull + e, r0, b);
        }
        for (int q = 0; q < NP; ++q) {
          const int p = c * NP + q, s = p % NS;
          mbar_wait(free_ + s, ((p / NS) & 1) ^ 1);     // the first round passes
          unsigned char* dst = ring + s * TW_PLANE;
          mbar_arrive_expect_tx(full + s, TW_PLANE);
          if (q < 4) {                                   // natural: 4 boxes of TR rows
            const CUtensorMap* m = q < 2 ? (DKV ? &tq : &tk) : (DKV ? &to : &tv);
            for (int x = 0; x < 4; ++x)
              tma_load_4d(dst + x * TR * ROW, m, full + s, c0 + FBOX * x, r0, bh, q % 2);
          } else {                                       // transposed: a box of 128 rows
            tma_load_4d(dst, q < 6 && DKV ? &tt1 : &tt2, full + s, r0, c0, bh, q % 2);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: fixed rows f0 .. f0 + 63, swept tiles
    // j = wg, wg + 2, ... (c counts them)
    setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int fr = warp * 16 + lane / 4;             // this thread's rows: fr, fr + 8
    const int row = f0 + fr;
    uint64_t* wb = bar_fix + 1 + wg * L::WG_BARS;
    uint64_t* full = wb;
    uint64_t* free_ = wb + NS;
    uint64_t* sfull = wb + 2 * NS;
    uint64_t* sfree = sfull + 2;
    uint64_t* xb = sfree + 2;
    unsigned char* ring = sm + L::RING + wg * L::RING_BYTES;
    const unsigned char* side = sm + L::SIDE + wg * 2 * L::SIDE_STAGE;
    const uint64_t da1h = smem_desc_sw128(sm + L::A1H, 16), da1l = smem_desc_sw128(sm + L::A1L, 16);
    const uint64_t da2h = smem_desc_sw128(sm + L::A2H, 16), da2l = smem_desc_sw128(sm + L::A2L, 16);
    auto plane = [&](int p) { return ring + (p % NS) * TW_PLANE; };
    auto wait_plane = [&](int p) { mbar_wait(full + p % NS, (p / NS) & 1); };
    auto release = [&](int p) { if (lane == 0) mbar_arrive(free_ + p % NS); };

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

    // d = A B^T over this CTA's 128 columns, A fixed (planes ah, al), B the
    // swept planes p, p + 1 (TR rows): 16 k8 steps of three m64n32k8, the
    // small terms first; then p is released (p + 1 only if rel2)
    auto first = [&](float (&d)[TR / 2], uint64_t ah, uint64_t al, int p, bool rel2) {
      wait_plane(p);
      wait_plane(p + 1);
      const uint64_t dbh = smem_desc_sw128(plane(p), 16);
      const uint64_t dbl = smem_desc_sw128(plane(p + 1), 16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T_D / 8; ++kk) {
        const uint32_t oa = ((kk / 4) * TILE * ROW + (kk % 4) * 32) / 16;
        const uint32_t ob = ((kk / 4) * TR * ROW + (kk % 4) * 32) / 16;
        wgmma_ss_tf32_n32(d, ah + oa, dbl + ob, kk > 0);
        wgmma_ss_tf32_n32(d, al + oa, dbh + ob, 1);
      }
#pragma unroll
      for (int kk = 0; kk < T_D / 8; ++kk) {
        const uint32_t oa = ((kk / 4) * TILE * ROW + (kk % 4) * 32) / 16;
        const uint32_t ob = ((kk / 4) * TR * ROW + (kk % 4) * 32) / 16;
        wgmma_ss_tf32_n32(d, ah + oa, dbh + ob, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      release(p);
      if (rel2) release(p + 1);
    };
    // acc += X B with X (64 x TR) from registers as hi and lo fragments, B
    // the transposed planes p, p + 1 (one box of 128 rows): 4 k8 steps of
    // three m64n128k8
    auto last = [&](float (&acc)[T_D / 2], uint32_t (&xh)[TR / 8][4],
                    uint32_t (&xl)[TR / 8][4], int p) {
      wait_plane(p);
      wait_plane(p + 1);
      const uint64_t dbh = smem_desc_sw128(plane(p), 16);
      const uint64_t dbl = smem_desc_sw128(plane(p + 1), 16);
      fence_regs(acc);
      fence_regs(xh);
      fence_regs(xl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TR / 8; ++kk) {
        wgmma_rs_tf32_n128(acc, xh[kk], dbh + kk * 2);
        wgmma_rs_tf32_n128(acc, xh[kk], dbl + kk * 2);
        wgmma_rs_tf32_n128(acc, xl[kk], dbh + kk * 2);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(xh);
      fence_regs(xl);
      release(p);
      release(p + 1);
    };
    // the `parts` over this CTA's columns become their sums over all of D,
    // through the slot of plane ps, which then goes back to the ring; x
    // counts this warpgroup's exchanges (cluster_sum fences each thread's
    // reads of the slot before its warp's arrivals give the slot back)
    auto sum = [&](int ps, int x, auto&... parts) {
      cluster_sum(cs, plane(ps), xb, x & 1, 128, tid, false, parts...);
      fence_proxy_async();                           // read before the slot's next TMA write
      __syncwarp();
      release(ps);
    };
    // window w's flush, in two phases: warpgroup wg ^ phase's accumulator
    // (dK/dV: 0 dV, 1 dK; dQ: the half); acc1 and acc2 are zeroed
    auto flush = [&](int w) {
      if (w > 0) named_barrier_sync<1>(256);         // both warpgroups' window w - 1 is in
#pragma unroll
      for (int phase = 0; phase < 2; ++phase) {
        const int which = wg ^ phase;
        const bool add = w > 0 || phase == 1;
        if (!DKV)
          flush_red(out1, acc1, b, s_fixed, row, H, h, t, add, c0, dw, which);
        else if (which)
          flush_red(out1, acc1, b, s_fixed, row, H, h, t, add, c0, dw, -1);
        else
          flush_red(out2, acc2, b, s_fixed, row, H, h, t, add, c0, dw, -1);
        __threadfence();                             // performed in L2 before the other's
        if (phase == 0) named_barrier_sync<2>(256);
      }
    };

    int c = 0;
    for (int j = wg; j < N; j += 2, ++c) {
      const int p = c * NP, r0 = (i0 + j) * TR, e = c % 2;
      float sc[TR / 2], dp[TR / 2];
      uint32_t xh[TR / 8][4], xl[TR / 8][4];
      first(sc, da1h, da1l, p, true);                // S^T = K Q^T, or S = Q K^T
      first(dp, da2h, da2l, p + 2, false);           // dP^T = V dO^T, or dP = dO V^T
      sum(p + 3, c, sc, dp);                         // both over all of D
      mbar_wait(sfull + e, (c / 2) & 1);
      const unsigned char* sv = side + e * L::SIDE_STAGE;
      if (DKV) {
        const float* lv = reinterpret_cast<const float*>(sv);
        if (causal && r0 < f0 + TILE - 1)
          probs_t<true, TR>(sc, dp, lv, lv + TR, keep, row, r0, t);
        else
          probs_t<false, TR>(sc, dp, lv, lv + TR, keep, row, r0, t);
      } else {
        const int* mk = reinterpret_cast<const int*>(sv);
        if (causal && r0 + TR - 1 > f0)
          probs<true, TR>(sc, dp, mk, lse_r, dl_r, row, r0, t);
        else
          probs<false, TR>(sc, dp, mk, lse_r, dl_r, row, r0, t);
      }
      if (lane == 0) mbar_arrive(sfree + e);
      if (DKV) {
        split_acc_tf32(xh, xl, sc);
        last(acc2, xh, xl, p + 4);                   // dV += P^T dO
      }
      split_acc_tf32(xh, xl, dp);
      last(acc1, xh, xl, p + NP - 2);                // dK += dS^T Q, or dQ += dS K
      if (c % TW_FLUSH == TW_FLUSH - 1 || j + 2 >= N) flush(c / TW_FLUSH);
    }
    for (int w = (c + TW_FLUSH - 1) / TW_FLUSH; w < windows; ++w) flush(w);
  }
  cluster_sync();                       // no CTA leaves while a peer may reach it
}

typedef long long ll;
#define PBT_STRIDES ll qsb, ll qss, ll qsh, ll ksb, ll kss, ll ksh, \
                    ll vsb, ll vss, ll vsh, ll osb, ll oss, ll osh
#define PBT_STRIDE_ARGS qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh


// The bf16 kernel of one pass at head width D (DKV: dK and dV into out1,
// out2; else dQ into out1) on `st`; returns 1000 + the CUresult of a
// refused tensor map, launch_cluster's code past D = 256 (clusters of
// ceil(D / 256) CTAs of the D = 256 design), or cudaGetLastError().
template <bool DKV>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const void* mask, const void* lse, const void* delta, void* out1,
                 void* out2, int B, int Sq, int Skv, int H, int D, int causal, PBT_STRIDES,
                 cudaStream_t st) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return TMAP_ERROR;
  // fixed rows a CTA (swept tiles are 64): D = 128 128; D >= 256 (and a
  // cluster's CTA) 64 kv rows (dK/dV) or 128 q rows (dQ)
  const int fix = D == 128 ? FIX : DKV ? W_FIX : Q_FIX;
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
  if (D > W_D) {
    const int n = (D + W_D - 1) / W_D;
    grid.x *= n;
    constexpr int smem = DKV ? Dkv256WideSmem::ALLOC : Dq256WideSmem::ALLOC;
    return launch_cluster(flash_bwd_d256_wgmma_kernel<DKV, true>, n, grid, 128 * (NWG + 1),
                          smem, st, tq, tk, tv, to, tm, tl, td, (__nv_bfloat16*)out1,
                          (__nv_bfloat16*)out2, Sq, Skv, H, causal, D);
  }
  if (D == 128) {
    cudaFuncSetAttribute(flash_bwd_wgmma_kernel<DKV, 128>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem::ALLOC);
    flash_bwd_wgmma_kernel<DKV, 128><<<grid, 128 * (NWG + 1), BwdSmem::ALLOC, st>>>(
        tq, tk, tv, to, tm, tl, td, (__nv_bfloat16*)out1, (__nv_bfloat16*)out2, Sq, Skv, H,
        causal);
  } else {
    constexpr int smem = DKV ? Dkv256Smem::ALLOC : Dq256Smem::ALLOC;
    cudaFuncSetAttribute(flash_bwd_d256_wgmma_kernel<DKV, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_bwd_d256_wgmma_kernel<DKV, false><<<grid, 128 * (NWG + 1), smem, st>>>(
        tq, tk, tv, to, tm, tl, td, (__nv_bfloat16*)out1, (__nv_bfloat16*)out2, Sq, Skv, H,
        causal, D);
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
  // rows a box: TILE, but the swept operands' TW_ROWS past D = 256
  const int swept = D > 256 ? TW_ROWS : TILE;
  const int q_rows = DKV ? swept : TILE, kv_rows = DKV ? TILE : swept;
  CUtensorMap tq, tk, tv, to, tt1, tt2, tm, tl, td;
  CUresult r = plane_map(enc, &tq, q, BH, Sq, D, q_rows);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &to, dout, BH, Sq, D, q_rows);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &tk, k, BH, Skv, D, kv_rows);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &tv, v, BH, Skv, D, kv_rows);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &tt1, t1, BH, D, t_cols, T_D);
  if (r == CUDA_SUCCESS) r = plane_map(enc, &tt2, t2, BH, D, t_cols, T_D);
  if (r == CUDA_SUCCESS) r = mask_map(enc, &tm, mask, B, Skv, kv_rows);
  if (r == CUDA_SUCCESS)
    r = rows_map(enc, &tl, lse, BH, Sq, q_rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r == CUDA_SUCCESS)
    r = rows_map(enc, &td, delta, BH, Sq, q_rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (r != CUDA_SUCCESS) return TMAP_ERROR + (int)r;
  const int tiles = (DKV ? Skv : Sq) / TILE;
  const dim3 grid(D / T_D * tiles, H, B);
  if (D > 256)    // a cluster of D / 128 CTAs
    return launch_cluster(flash_bwd_wide_tf32_kernel<DKV>, D / T_D, grid, 384,
                          BwdTf32WideSmem::ALLOC, st, tq, tk, tv, to, tt1, tt2, tm, tl, td,
                          (float*)out1, (float*)out2, Sq, Skv, H, causal);
  if (D == 256)   // a pair
    return launch_cluster(flash_bwd_tf32_kernel<DKV, 256>, 2, grid, 256, BwdTf32Smem::ALLOC,
                          st, tq, tk, tv, to, tt1, tt2, tm, tl, td, (float*)out1, (float*)out2,
                          Sq, Skv, H, causal);
  cudaFuncSetAttribute(flash_bwd_tf32_kernel<DKV, 128>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, BwdTf32Smem::ALLOC);
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
  if (!head_dim_taken(D, dtype)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_wgmma<DKV>(q, k, v, dout, mask, lse, delta, out1, out2, B, Sq, Skv, H, D,
                             causal, PBT_STRIDE_ARGS, st);
  return launch_tf32<DKV>(q, k, v, dout, DKV ? qt : nullptr, DKV ? nullptr : kt,
                          DKV ? ot : nullptr, mask, lse, delta, out1, out2, B, Sq, Skv, H, D,
                          causal, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 128 n, n = 1..32 (bf16) or 1..16
// (f32).  bf16: q, k, v, dO (B,
// S, H, D) at element strides for their (B, S, H) axes (the D axis
// contiguous); qt, kt, ot are not read.  f32: q, k, v, dO are the natural
// split planes of pbt_tf32_split and qt, kt, ot
// the transposed planes of q, k and dO (each entry reads the ones its
// kernels use: K2 qt, kt, ot; K3a kt; K3b qt, ot); the strides are not
// read.  Each entry launches on `stream` and returns the first nonzero of
// its kernels' codes: cudaGetLastError(), 1000 + the CUresult of a tensor
// map the driver refused (1000 alone where the driver offers no encoder),
// CLUSTER_ERROR + n where the card cannot hold a cluster of n CTAs of a
// kernel (D >= 256: bf16 n = ceil(D / 256), f32 n = D / 128), or
// cudaErrorInvalidValue for another D.

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
// elements for the (B, S, H) axes; D 128 n, n = 1..32 (bf16) or 1..16 (f32).
extern "C" int pbt_flash_delta(const void* dout, const void* out, void* delta, int B,
                               int S, int H, int D, int dtype, long long osb, long long oss,
                               long long osh, long long tsb, long long tss,
                               long long tsh, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!head_dim_taken(D, dtype)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S * H;
  if (D > 256) {
    const dim3 grid((unsigned)((rows + DELTA_THREADS / 32 - 1) / (DELTA_THREADS / 32)));
    if (dtype == 1)
      flash_delta_wide_kernel<__nv_bfloat16><<<grid, DELTA_THREADS, 0, st>>>(
          (const __nv_bfloat16*)dout, (const __nv_bfloat16*)out, (float*)delta, S, H, D, rows,
          osb, oss, osh, tsb, tss, tsh);
    else
      flash_delta_wide_kernel<float><<<grid, DELTA_THREADS, 0, st>>>(
          (const float*)dout, (const float*)out, (float*)delta, S, H, D, rows, osb, oss, osh,
          tsb, tss, tsh);
    return (int)cudaGetLastError();
  }
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
// S), either of which may be null.  Each S a multiple of 32; D 128 n, n =
// 1..16.
extern "C" int pbt_tf32_split(const void* args, int n, int B, int H, int D, void* stream) {
  if (!head_dim_taken(D, 0)) return (int)cudaErrorInvalidValue;
  const SplitArgs a = *reinterpret_cast<const SplitArgs*>(args);
  int s_max = 0;
  for (int i = 0; i < n; ++i) s_max = max(s_max, a.S[i]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D > 256) {
    const int chunks = (D + SPLIT_WIDE_COLS - 1) / SPLIT_WIDE_COLS;
    tf32_split_wide_kernel<<<dim3(s_max / SPLIT_WIDE_ROWS * chunks, H, B * n), 256, 0, st>>>(
        a, B, H, D, D / chunks);
    return (int)cudaGetLastError();
  }
  const dim3 grid(s_max / SPLIT_ROWS, H, B * n);
  if (D == 128)
    tf32_split_kernel<128><<<grid, 256, 0, st>>>(a, B, H);
  else
    tf32_split_kernel<256><<<grid, 256, 0, st>>>(a, B, H);
  return (int)cudaGetLastError();
}

// How many clusters of the backward's dK/dV (which = 1) or dQ (which = 0)
// kernel at head width D (256 .. 4096 bf16, .. 2048 f32) and type `dtype`
// the card holds at once (cudaOccupancyMaxActiveClusters, 0 where it holds none); the
// cluster's size into *size (1 where the kernel runs no cluster, and the
// answer is then 0): bf16 ceil(D / 256) CTAs past D = 256, f32 D / 128.
extern "C" int pbt_cluster_occupancy(int D, int dtype, int which, void* size) {
  int* n = static_cast<int*>(size);
  *n = 1;
  if (!head_dim_taken(D, dtype) || D < 256 || (dtype == 1 && D == 256)) return 0;
  *n = dtype == 1 ? (D + W_D - 1) / W_D : D / T_D;
  auto ask = [&](auto kernel, int threads, int smem) {
    return max_active_clusters(kernel, *n, threads, smem);
  };
  if (dtype == 1)
    return which ? ask(flash_bwd_d256_wgmma_kernel<true, true>, 128 * (NWG + 1),
                       Dkv256WideSmem::ALLOC)
                 : ask(flash_bwd_d256_wgmma_kernel<false, true>, 128 * (NWG + 1),
                       Dq256WideSmem::ALLOC);
  if (D == 256)
    return which ? ask(flash_bwd_tf32_kernel<true, 256>, 256, BwdTf32Smem::ALLOC)
                 : ask(flash_bwd_tf32_kernel<false, 256>, 256, BwdTf32Smem::ALLOC);
  return which ? ask(flash_bwd_wide_tf32_kernel<true>, 384, BwdTf32WideSmem::ALLOC)
               : ask(flash_bwd_wide_tf32_kernel<false>, 384, BwdTf32WideSmem::ALLOC);
}
