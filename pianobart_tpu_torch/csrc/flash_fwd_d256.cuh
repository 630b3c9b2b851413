// K1's bf16 flash forward at head width 256 for Hopper (sm_90a):
// flash_fwd_d256_wgmma_kernel, launched by flash_fwd.cu:pbt_flash_fwd for
// bf16 at D = 256 (the --heads 4 model's width).  Contract as K1's
// (flash_fwd_bf16.cuh): q pre-scaled by the caller, an int32 kv mask
// (nonzero = attend), causal keeps row >= col, masked scores the finite
// -1e30, l == 0 guarded (l_safe), O (B, Sq, H, 256) bf16, lse (B, H, Sq) f32
// natural log; no atomics, so the same inputs give the same bits.
//
// What bounds it: 4*B*H*Sq*Skv*D FLOPs over the kept pairs at 989 TFLOP/s
// bf16 (0.1381 ms at B=32, S=1024, H=4 with the smoke run's pad tail; the
// bytes take a fifth of that), so the tensor cores, and what feeds them:
// the SM's shared memory, 128 bytes a cycle.  A product m64nNk16 with both
// operands in shared memory reads (64 + N) * 32 bytes for 64*N*16 MACs.
// K1's D = 128 layout (3 stages of 128 kv rows) would take 448 KB here; with
// that schedule re-tiled to 64 kv rows in 2 stages, S = Q K^T is m64n64, and
// one tile's traffic (both warpgroups' Q and K reads for S, V for P V, TMA's
// K and V writes: 256 KB) over its 2,048 tensor cycles is 125 bytes a cycle,
// so the tensor cores were busy only while shared memory ran at 98%.
//
// Design: one CTA per (128-row q tile, head, batch), two consumer
// warpgroups of 64 q rows and one producer warpgroup.  kv tiles of 128
// rows: S = Q K^T is m64n128k16 (16 k16 steps), O += P V two m64n128k16 a
// k16 step (one per 128-column half of O, P from registers, V through the
// transpose bit), which is 448 KB a tile over 4,096 tensor cycles, 109
// bytes a cycle, the ratio of the D = 128 kernel.  A 128-row tile of K and
// V is 128 KB, so K and V stream through a ring of 32 KB half-D slots
// (K1D256Smem: Q's 64 KB, 4 slots, 192 KB with the mask): per tile K lo,
// K hi, V lo, V hi (128 kv rows x 128 d columns each, as two 64-column
// TMA boxes with 128-byte swizzle), the tile's mask entries with K lo into
// a ring of two.  S's k16 steps 0-7 read K lo, 8-15 K hi; O's two halves
// read V lo and V hi.  Each slot is released when all 8 consumer warps
// have read it (K's after S, V's after P V).
//
// A warpgroup's registers hold O (128 f32 a thread) and S (64); P's bf16
// fragments (32) take S's registers once the softmax has read S, so a
// warpgroup does not issue tile j+1's S while its P V of tile j runs, as
// the D = 128 kernel does (O + S + P = 224 of setmaxnreg's 240 would
// spill).  Instead the two warpgroups ping-pong: each issues S = Q K^T only
// in its turn, passed between them by named barriers 1 and 2, so that one
// warpgroup's softmax (8k exp2 a tile) runs under the other's products.
// The order the tensor cores see is S of warpgroup 0, S of warpgroup 1,
// P V of 0, P V of 1, and so on: warpgroup 0's softmax runs under
// warpgroup 1's S (1,024 tensor cycles at the bound's rate), and whatever
// it takes beyond that the tensor cores wait.
//
// The softmax is K1's (flash_fwd_bf16.cuh:softmax_tile): masks by select
// (the causal one only where the diagonal crosses the warpgroup's rows;
// tiles wholly above it are skipped), the max kept in the score domain,
// exp2 by FFMA + ex2 with log2 e, p = 1 on a row with no kept key so far,
// keys past Skv in a ragged last tile (TMA's zeros) p = 0, l summed from
// the f32 p, P rounded to bf16.  With K1's code it took ~2,350 cycles a
// tile (clock() counters on an H100), so softmax_d256 shortens it: the
// mask as bits read before the warpgroup's turn, no selects on tiles the
// warp keeps whole, and O rescaled only when a row's max grows by more than
// 2^8.  Rows past Sq are not stored.  PERF.md (section 6) has the variants
// measured and dropped.
//
// Wide heads (D = 384 .. 4096): the instance <true>, clusters of
// n = ceil(D / 256) of these CTAs along x (blockIdx.x / n the q tile, the
// cluster rank r the columns 256 r .. 256 r + 255 of the head), each the
// design above on its columns of Q, K and V, storing its columns of O.
// S = Q K^T sums over all of D: once a warpgroup's S of a tile is in, it
// releases K's slots and sums its 64 x 128 f32 S (32 KB) across the
// cluster with the same warpgroup of every peer, through a 32 KB region of
// its own: a pair (D = 384, 512) in one round, each CTA storing all its S
// into the other's region (hopper.cuh:pair_sum), four CTAs (896, 1024) in
// two such rounds, with rank ^ 1 then rank ^ 2, eight (1920, 2048) in
// three, sixteen (3968, 4096) in four, the other n (3, 5 .. 7, 9 .. 15:
// 640 .. 768, 1152 .. 1792, 2176 .. 3840) as a reduce-scatter then an
// all-gather (cluster_sum); so every CTA holds
// the same S, softmax, P, l and lse to the bit; rank 0 stores lse.  Clusters
// of D / 128 CTAs of the D = 128 design move 1.5x S through
// distributed shared memory for every 128 columns of products (n = 4 at
// D = 512), in two rounds; here a CTA does the products of 256 columns for
// each exchange, and at n = 2 an exchange moves 1.0x S in one round: a third
// of the bytes a FLOP at D = 512, 1.75x / (1.5x / 2) = 2.3x fewer at
// D = 1024.  Where D is not a multiple of 256 (384, 640, .., 3968) the last
// CTA's upper 128 columns lie past D: TMA fills its Q, K and V boxes there
// with zeros, so every CTA runs the same code, those columns add nothing to
// S, and their O is not stored (at D = 384, 4/3 of the products the function
// needs; 1152, 2176 and 3968 likewise).  Past 8 CTAs (D = 2176 .. 4096) the
// clusters are H100's non-portable sizes (hopper.cuh:max_active_clusters).
// The two 32 KB
// regions take the room of one ring slot: the ring keeps 3 (K lo, K hi,
// V lo; V hi lands in K lo's slot once both warpgroups' S of the tile is
// in).  A cluster reads what ceil(D / 256) CTAs at D = 256 read at the same
// H, and does their FLOPs: at H * D = 1024 the bound is the D = 256 one.
#pragma once
#include "flash_common.cuh"
#include "flash_fwd_bf16.cuh"
#include "hopper.cuh"

namespace pbt {

constexpr int K1W_D = 256;              // the head width of this design
constexpr int K1W_BN = 128;             // kv rows a tile
constexpr int K1W_SLOT = K1W_BN * 2 * 128;   // 128 kv rows x 128 d columns: 32 KB
// The cluster sizes at which a warpgroup sums S by pair rounds (2, 4, 8
// and 16: hopper.cuh:pair_rounds); the others (3, 5 .. 7, 9 .. 15) by
// cluster_sum.  At 8 (D = 1920, 2048) three pair rounds took 0.823-0.875 ms
// and cluster_sum 1.232-1.251 (B=16, S=1024, H=1; scripts/cluster_probe.py,
// three calls, H100 at 700 W); at 16 (D = 4096) four pair rounds 1.088-1.090
// and cluster_sum 1.414-1.420 (B=8; the same script, H100 at 700 W).  The
// barriers' setup and the exchange read this one mask, so they agree at
// every n.
constexpr uint32_t K1W_PAIRS = (1u << 2) | (1u << 4) | (1u << 8) | (1u << 16);

// This thread's keep bits of a tile's BN mask entries: bit 2*nt + e is
// column 8*nt + 2*t + e, the columns of its accumulator entries.  Read while
// the warpgroup waits for its turn, so that no shared-memory load sits in
// the softmax, which runs under the other warpgroup's products.  BN <= 128
// (the f32 K1's clusters take it at 64).
template <int BN = K1W_BN>
__device__ __forceinline__ uint32_t keep_bits(const int* mk, int t) {
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int2 keep = *reinterpret_cast<const int2*>(mk + nt * 8 + 2 * t);
    bits |= (keep.x != 0 ? 1u : 0u) << (2 * nt);
    bits |= (keep.y != 0 ? 1u : 0u) << (2 * nt + 1);
  }
  return bits;
}

// K1's softmax_tile (flash_fwd_bf16.cuh) over a tile of BN keys, sc
// becoming p and corr the factor for the O accumulated so far, with three
// changes that shorten it (it must fit under the other warpgroup's
// products): the keep bits come in a register; MASK = false, for a tile
// whose keys the whole warp keeps (hence not ragged either), skips the
// selects; and the running max m_i, from which p = 2^((s - m_i) log2 e)
// is taken, moves only when a row's max grows by more than 2^8, so that
// most tiles leave O unscaled (corr 1; p < 2^8 then, and O, l and lse are
// the same function of the scores: lse = m_i + ln l for any m_i).  The f32
// K1's clusters take it at BN = 64 (flash_fwd.cu).
template <bool DIAG, bool MASK = true, int BN = K1W_BN>
__device__ __forceinline__ void softmax_d256(float (&sc)[BN / 2], uint32_t keep,
                                             float (&m_i)[2], float (&l_i)[2],
                                             float (&corr)[2], int row, int kv0, int Skv,
                                             int t) {
  constexpr int NT = BN / 8;
  const bool ragged = kv0 + BN > Skv;               // keys past Skv: TMA's zeros
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool kp = (keep >> (2 * nt + (e & 1))) & 1u;
      if (DIAG) kp &= row + (e >= 2 ? 8 : 0) - (kv0 + nt * 8 + 2 * t + (e & 1)) >= 0;
      float& x = sc[4 * nt + e];
      if (MASK) x = kp ? x : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float cl[2], ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float m_new = fmaxf(m_i[r], m);
    const bool move = (m_new - m_i[r]) * LOG2E > 8.f;
    corr[r] = move ? exp2_approx((m_i[r] - m_new) * LOG2E) : 1.f;
    if (!move) m_new = m_i[r];
    // p = 2^(s*c - m*c): with no kept key so far (m_new the sentinel)
    // c = 0 gives p = 1 exactly, as exp(s - m) does in the reference
    cl[r] = m_new == NEG_INF ? 0.f : LOG2E;
    ml[r] = m_new * cl[r];
    m_i[r] = m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = sc[4 * nt + e];
      x = exp2_approx(fmaf(x, cl[e >> 1], -ml[e >> 1]));
      if (MASK && ragged && kv0 + nt * 8 + 2 * t + (e & 1) >= Skv) x = 0.f;
      ls[e >> 1] += x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * corr[r] + ls[r];
}

// Shared memory, in bytes from a 1024-aligned base (the swizzle atom); WIDE,
// a cluster's CTA.
template <bool WIDE>
struct K1D256Smem {
  static constexpr int NS = WIDE ? 3 : 4;                     // ring of half-D slots
  static_assert(NS >= 3 && NS <= 6,
                "a tile's K fits the ring beside one more slot, and tile j+2's mask "
                "entries land only after tile j's softmax has read them (with its K lo, "
                "in the slot of K hi j+1, K lo j+1 or V lo j)");
  static constexpr int Q = 0;                                 // 4 boxes of K1_BM rows
  static constexpr int RING = Q + K1_BM * 2 * K1W_D;          // slots of 2 boxes of BN rows
  static constexpr int MASK = RING + NS * K1W_SLOT;           // two tiles' BN int32
  // a cluster's exchange: per consumer warpgroup a region of its S (64 x BN f32)
  static constexpr int X_UNITS = K1W_BN / 8 * 128;
  static constexpr int X = MASK + 2 * K1W_BN * 4;
  static constexpr int X_REGION = X_UNITS * 16;      // all of S: pair_sum's
  static_assert(X_UNITS >= cluster_region_units(X_UNITS, 16), "cluster_sum's, n = 3 .. 15");
  // Q, full[S], free[S]; a cluster's five a warpgroup (pair_sum_init's for
  // up to four rounds, or cluster_sum_init's four)
  static constexpr int XB = 5;
  static constexpr int BAR = X + (WIDE ? K1_WG * X_REGION : 0);
  static constexpr int ALLOC = BAR + (1 + 2 * NS + (WIDE ? XB * K1_WG : 0)) * 8 + 1024;
  static_assert(ALLOC <= 232448, "a CTA's shared memory");
};

// The tensor maps: q in boxes of K1_BM rows, k and v of K1W_BN rows (each
// box 64 d columns), the mask in boxes of K1W_BN keys.  WIDE: a cluster's
// CTA (see the header), dw the head width (D = 256 reads none).
template <bool WIDE>
__global__ void __launch_bounds__(128 * (K1_WG + 1), 1)
flash_fwd_d256_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tm,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                            int Sq, int Skv, int H, int causal, int dw) {
  using L = K1D256Smem<WIDE>;
  constexpr int NWG = K1_WG, BM = K1_BM, BN = K1W_BN, D = K1W_D, NS = L::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* bar_full = bar_q + 1;       // slot s landed
  uint64_t* bar_free = bar_full + NS;   // slot s read by every consumer warp

  ClusterSum cs = {1, 0, 0, 0};
  if constexpr (WIDE) cs = cluster_sum_shape(L::X_UNITS, 128, threadIdx.x % 128);
  const int c0 = cs.rank * D;                       // a cluster's CTA: its first column
  const int q0 = (WIDE ? blockIdx.x / cs.n : blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  int n_tiles = (Skv + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, q0 / BN + 1);  // skip tiles above the diagonal
  const int n_items = 4 * n_tiles;                  // K lo, K hi, V lo, V hi a tile

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + s, 1);
      mbar_init(bar_free + s, 4 * NWG);
    }
    if constexpr (WIDE)
      for (int g = 0; g < NWG; ++g)
        score_sum_init(bar_free + NS + L::XB * g, cs.n, pair_rounds<K1W_PAIRS>(cs.n));
    mbar_fence_init();
  }
  if constexpr (WIDE) cluster_sync();    // every CTA's barriers ready
  else __syncthreads();

  if (wg == NWG) {
    // ---- producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * NWG) {
      mbar_arrive_expect_tx(bar_q, BM * 2 * D);
#pragma unroll
      for (int x = 0; x < D / BOX; ++x)
        tma_load_4d(sm + L::Q + x * BM * ROW, &tq, bar_q, c0 + x * BOX, h, q0, b);
      for (int it = 0; it < n_items; ++it) {
        const int s = it % NS, j = it / 4, kind = it % 4, kv0 = j * BN;
        const int c = c0 + (kind & 1) * (D / 2);    // lo or hi half of the CTA's columns
        const void* map = kind < 2 ? &tk : &tv;
        mbar_wait(bar_free + s, ((it / NS) & 1) ^ 1);   // the first round passes
        unsigned char* dst = sm + L::RING + s * K1W_SLOT;
        mbar_arrive_expect_tx(bar_full + s, K1W_SLOT + (kind == 0 ? BN * 4 : 0));
        tma_load_4d(dst, map, bar_full + s, c, h, kv0, b);
        tma_load_4d(dst + BN * ROW, map, bar_full + s, c + BOX, h, kv0, b);
        if (kind == 0) tma_load_2d(sm + L::MASK + (j & 1) * BN * 4, &tm, bar_full + s, kv0, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64*wg .. +63
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int wrow0 = q0 + wg * 64;
    const int row = wrow0 + warp * 16 + lane / 4;   // this thread's rows: row, row + 8
    const uint64_t dq = smem_desc_sw128(sm + L::Q + wg * 64 * ROW, 16);
    auto slot = [&](int it) { return sm + L::RING + (it % NS) * K1W_SLOT; };
    auto wait_item = [&](int it) { mbar_wait(bar_full + it % NS, (it / NS) & 1); };
    auto release = [&](int it) { if (lane == 0) mbar_arrive(bar_free + it % NS); };

    float acc[D / 2];                                // O, 64 rows x 256 per warpgroup
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_i[2] = {NEG_INF, NEG_INF};               // score domain
    float l_i[2] = {0.f, 0.f};                       // this thread's partial row sums

    // the turn to issue S starts with warpgroup 0: named barrier 1 + wg is
    // this warpgroup's, on which the other arrives once it has issued its S
    static_assert(NWG == 2, "two consumer warpgroups in ping-pong");
    if (wg == 1) named_barrier_arrive<1>(128 * NWG);
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int it = 4 * j, kv0 = j * BN;
      float sc[BN / 2];                              // S, then P's fragments in its place
      uint32_t pa[BN / 16][4];
      wait_item(it);
      const uint32_t keep = keep_bits(
          reinterpret_cast<const int*>(sm + L::MASK + (j & 1) * BN * 4), t);
      wait_item(it + 1);
      if (wg == 0) named_barrier_sync<1>(128 * NWG);
      else named_barrier_sync<2>(128 * NWG);
      // S = Q K^T: k16 steps 0-7 over K lo, 8-15 over K hi
      const uint64_t dk[2] = {smem_desc_sw128(slot(it), 16), smem_desc_sw128(slot(it + 1), 16)};
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = dq + ((kk / 4) * BM * ROW + (kk % 4) * 32) / 16;
        const uint64_t db = dk[kk / 8] + (((kk % 8) / 4) * BN * ROW + (kk % 4) * 32) / 16;
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      if (wg == 0) named_barrier_arrive<2>(128 * NWG);
      else if (j + 1 < n_tiles) named_barrier_arrive<1>(128 * NWG);
      wgmma_wait<0>();
      fence_regs(sc);
      release(it);
      release(it + 1);
      if constexpr (WIDE) {   // S over all of D; j counts this warpgroup's exchanges
        unsigned char* region = sm + L::X + wg * L::X_REGION;
        uint64_t* xb = bar_free + NS + L::XB * wg;
        const int rounds = pair_rounds<K1W_PAIRS>(cs.n);
        if (rounds)
          pair_sum(sc, region, xb, cs.rank, j, rounds, 128, tid);
        else
          cluster_sum(cs, region, xb, j & 1, 128, tid, true, sc);
      }
      float corr[2];
      if (causal && kv0 + BN - 1 > wrow0)
        softmax_d256<true>(sc, keep, m_i, l_i, corr, row, kv0, Skv, t);
      else if (__all_sync(0xffffffffu, keep == 0xffffffffu))
        softmax_d256<false, false>(sc, keep, m_i, l_i, corr, row, kv0, Skv, t);
      else
        softmax_d256<false>(sc, keep, m_i, l_i, corr, row, kv0, Skv, t);
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {   // warp-uniform
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          acc[4 * dt] *= corr[0]; acc[4 * dt + 1] *= corr[0];
          acc[4 * dt + 2] *= corr[1]; acc[4 * dt + 3] *= corr[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa[kk], &sc[8 * kk], &sc[8 * kk + 4]);
      // O += P V: each 128-column half of O from its own V slot
      wait_item(it + 2);
      wait_item(it + 3);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint64_t dv = smem_desc_sw128(slot(it + 2 + n), BN * ROW);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs_n128_tb(acc_half(acc, n), pa[kk], dv + kk * 16 * ROW / 16);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(it + 2);
      release(it + 3);
    }

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
      __nv_bfloat16* orow = o + (((long long)b * Sq + rr) * H + h) * (WIDE ? dw : D) + c0;
      const float inv = 1.f / l_i[r];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        if (!WIDE || c0 + dt * 8 < dw)               // columns past D: TMA's zeros
          *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
              pack_bf16(acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
      if (t == 0 && cs.rank == 0) lse[((long long)b * H + h) * Sq + rr] = m_i[r] + logf(l_i[r]);
    }
  }
  if constexpr (WIDE) cluster_sync();    // no CTA leaves while a peer may reach it
}

// One launch over the maps of q (boxes of K1_BM rows), k and v (K1W_BN
// rows) and the mask (K1W_BN keys) at head width D: D = 256 returns
// cudaGetLastError(), D = 384 .. 4096 (clusters of ceil(D / 256) CTAs)
// launch_cluster's code.
inline int launch_fwd_d256(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                           const CUtensorMap& tm, void* o, void* lse, int B, int Sq, int Skv,
                           int H, int D, int causal, cudaStream_t st) {
  dim3 grid((Sq + K1_BM - 1) / K1_BM, H, B);
  if (D > K1W_D) {
    const int n = (D + K1W_D - 1) / K1W_D;
    grid.x *= n;
    return launch_cluster(flash_fwd_d256_wgmma_kernel<true>, n, grid, 128 * (K1_WG + 1),
                          K1D256Smem<true>::ALLOC, st, tq, tk, tv, tm, (__nv_bfloat16*)o,
                          (float*)lse, Sq, Skv, H, causal, D);
  }
  cudaFuncSetAttribute(flash_fwd_d256_wgmma_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, K1D256Smem<false>::ALLOC);
  flash_fwd_d256_wgmma_kernel<false><<<grid, 128 * (K1_WG + 1), K1D256Smem<false>::ALLOC, st>>>(
      tq, tk, tv, tm, (__nv_bfloat16*)o, (float*)lse, Sq, Skv, H, causal, D);
  return (int)cudaGetLastError();
}

}  // namespace pbt
