// Flash attention forward for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces the Pallas TPU kernel pianobart_tpu/ops/flash.py:_fwd_kernel
// (launched by _fwd). Same contract, at head width D = 128 or 256:
//   q, k, v   (B, S, H, D) bf16 or f32, read through their strides (f32 at
//             D = 128: by the prep); q is already scaled by D**-0.5 by the
//             caller.
//   kv_mask   (B, Skv) int32, nonzero = attend.  causal: keep row >= col.
//   o         (B, Sq, H, D) contiguous, input dtype.
//   lse       (B, H, Sq) f32 row logsumexp (natural log).
// Online softmax with f32 running max m, sum l and accumulator.  Masked
// scores are the finite -1e30 (not -inf) so fully masked rows stay finite;
// l == 0 is guarded as in the reference (l_safe).
//
// Bound: 4*B*H*Sq*Skv*D FLOPs over the kept (row, key) pairs against
// 989 TFLOP/s bf16 (0.1381 ms at B=32, S=1024, H=8 with the smoke run's pad
// tail); the q/k/v/o bytes take a fifth of that at 3.35 TB/s, so the kernel
// is bound by operations, i.e. by how fully it keeps the tensor cores busy.
//
// bf16 design (Hopper): flash_fwd_bf16.cuh, the kernel template K1 shares
// with the kernel lab; K1 is its instance <false, false> (K read K-major, P
// rounded to bf16) with K1_UNITS (p = 2^(s log2 e - m log2 e), lse natural):
// one CTA per (128-row q tile, head, batch), a producer warpgroup keeping a
// 3-stage TMA ring of 128 kv rows full, two consumer warpgroups running
// S = Q K^T and O += P V as wgmma, tile j's softmax under tile j-1's P V.
//
// f32 design (3xTF32, the default PianoBartConfig's path): the same
// schedule on the tensor cores at f32 accuracy.  tf32 wgmma reads its
// shared-memory operands K-major only, so the wrapper's prep
// (flash_bwd.cu:pbt_tf32_split) hands the kernel Q's and K's planes of
// hi = x rounded to tf32 and lo = x - hi, and V's transposed (d along the
// rows, the kv index within each 8 in the k order of an A fragment made
// from accumulators).  Every product is three tf32 wgmma, hi.hi' + hi.lo' +
// lo.hi', about 2^-22 relative: S = Q K^T as m64n64k8 from shared memory,
// O += P V as m64n128k8 with P split into hi and lo in registers.  An f32
// plane is four times a bf16 tile, so Q's two planes take 128 KB and the kv
// tiles (64 rows) stream through a ring of 3 slots of one 32 KB plane each
// (K hi, K lo, V^T hi, V^T lo in turn, the mask with K hi); the products of
// a tile run one after the other in each of the two consumer warpgroups.
// Bound: 3 x 4*B*H*Sq*Skv*D FLOPs at 495 TFLOP/s tf32 (0.047 ms at B=2,
// S=1024, H=8 with the smoke run's pad tail).
//
// At D = 256 the bf16 kernel is the same template's instance <false,
// false, 256> (flash_fwd_bf16.cuh: kv tiles of 64 rows in 2 stages).  The
// f32 layout above does not fit there (Q's two planes alone would take
// 256 KB), so f32 at D = 256 is a simpler kernel at the same accuracy,
// flash_fwd_d256_mma_kernel: 3xTF32 by mma.sync m16n8k8, the pre-Hopper
// tensor-core product, with no prep.  One CTA of 8 warps per (128 q rows,
// head, batch), each warp 16 rows; the CTA copies Q (128 x 256 f32) once and
// K and V 32 rows at a time into shared memory (rows padded to 260 floats,
// so every fragment load is free of bank conflicts), and each warp splits
// its fragments into tf32 hi and lo as it loads them, runs S = Q K^T
// (16 x 32, 32 k8 steps) and O += P V (16 x 256, 4 k8 steps, P split from
// its accumulators) as three mma each, hi.hi' + hi.lo' + lo.hi', every k8
// step's three into a zeroed partial added to the sum in f32.  The online
// softmax is K1's.  Simple before fast: one buffer, loads by the threads,
// a barrier a tile; 8 warps an SM (200 KB of shared memory a CTA).
#include "flash_common.cuh"
#include "flash_fwd_bf16.cuh"
#include "flash_mma_f32.cuh"
#include "hopper.cuh"

namespace {

using namespace pbt;

// ----------------------------------------------------- f32 / 3xTF32 wgmma
constexpr int F_D = 128;                 // the head width of this design
constexpr int F_BN = 64;                 // kv rows per tile
constexpr int F_SLOTS = 3;               // ring of plane tiles
constexpr int F_PLANE = F_BN * 4 * F_D;  // 64 rows x 128 f32 (or 128 x 64): 32 KB

// Shared memory, in bytes from a 1024-aligned base.  Q's hi and lo planes
// (4 boxes of 128 rows each), then the ring: per kv tile four planes go
// through it in turn, K hi, K lo (4 boxes of 64 kv rows), V^T hi, V^T lo
// (2 boxes of 128 d rows); the kv mask rides with K hi.
struct K1F32Smem {
  static constexpr int QHI = 0;
  static constexpr int QLO = QHI + K1_BM * 4 * F_D;
  static constexpr int SLOT = QLO + K1_BM * 4 * F_D;
  static constexpr int MASK = SLOT + F_SLOTS * F_PLANE;         // per slot F_BN int32
  static constexpr int BAR = MASK + F_SLOTS * F_BN * 4;         // Q, full[S], free[S]
  static constexpr int ALLOC = BAR + (1 + 2 * F_SLOTS) * 8 + 1024;
};

// Masks (the causal one, DIAG, only where the diagonal crosses the
// rows; mk the tile's BN mask entries), then the online-softmax update of
// rows `row` and `row + 8` as in softmax_tile.
template <bool DIAG, int BN>
__device__ __forceinline__ void softmax_tile_f32(float (&sc)[BN / 2], const int* mk,
                                                 float (&m_i)[2], float (&l_i)[2],
                                                 float (&corr)[2], int row, int kv0, int t) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    const int2 keep = *reinterpret_cast<const int2*>(mk + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool kp = ((e & 1) ? keep.y : keep.x) != 0;
      if (DIAG) kp &= row + (e >= 2 ? 8 : 0) - (kv0 + c + (e & 1)) >= 0;
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
    corr[r] = exp2_approx((m_i[r] - m_new) * LOG2E);
    cl[r] = m_new == NEG_INF ? 0.f : LOG2E;      // no kept key yet: p = 1
    ml[r] = m_new * cl[r];
    m_i[r] = m_new;
    l_i[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], cl[(i >> 1) & 1], -ml[(i >> 1) & 1]));
    l_i[(i >> 1) & 1] += sc[i];
  }
}

// The f32 forward: O and lse at f32 accuracy on the tensor cores.  The
// wrapper's prep (pbt_tf32_split) hands it Q's and K's hi and lo planes and
// V's transposed ones.  tq: Q planes in boxes of K1_BM rows; tk: K planes in
// boxes of F_BN rows; tv: V^T planes in boxes of 128 d rows; tm: the mask in
// boxes of F_BN keys.
__global__ void __launch_bounds__(128 * (K1_WG + 1), 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tm,
                      float* __restrict__ o, float* __restrict__ lse,
                      int Sq, int Skv, int H, int causal) {
  using L = K1F32Smem;
  constexpr int NWG = K1_WG;
  constexpr int BM = K1_BM, BN = F_BN, NS = F_SLOTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* bar_full = bar_q + 1;       // plane of slot s landed
  uint64_t* bar_free = bar_full + NS;   // slot s read by every consumer warp

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int wg = threadIdx.x / 128;
  int n_tiles = Skv / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);
  const int n_planes = 4 * n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
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
      mbar_arrive_expect_tx(bar_q, 2 * BM * 4 * F_D);
      for (int pl = 0; pl < 2; ++pl)
        for (int x = 0; x < 4; ++x)
          tma_load_4d(sm + (pl ? L::QLO : L::QHI) + x * BM * ROW, &tq, bar_q, FBOX * x, q0,
                      bh, pl);
      for (int p = 0; p < n_planes; ++p) {
        const int s = p % NS, kv0 = (p / 4) * BN, kind = p % 4;
        mbar_wait(bar_free + s, ((p / NS) & 1) ^ 1);   // the first round passes
        unsigned char* dst = sm + L::SLOT + s * F_PLANE;
        if (kind < 2) {                                  // K hi or lo: 4 boxes of BN rows
          mbar_arrive_expect_tx(bar_full + s, F_PLANE + (kind == 0 ? BN * 4 : 0));
          for (int x = 0; x < 4; ++x)
            tma_load_4d(dst + x * BN * ROW, &tk, bar_full + s, FBOX * x, kv0, bh, kind);
          if (kind == 0) tma_load_2d(sm + L::MASK + s * BN * 4, &tm, bar_full + s, kv0, b);
        } else {                                         // V^T hi or lo: 2 boxes of 128 rows
          mbar_arrive_expect_tx(bar_full + s, F_PLANE);
          for (int x = 0; x < 2; ++x)
            tma_load_4d(dst + x * F_D * ROW, &tv, bar_full + s, kv0 + FBOX * x, 0, bh,
                        kind - 2);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64*wg .. +63.  Per kv tile:
    // S = Q K^T (3 x 16 k8 steps from shared memory), softmax, P split in
    // registers, O += P V (3 x 8 k8 steps, P from registers).
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int wrow0 = q0 + wg * 64;
    const int row = wrow0 + warp * 16 + lane / 4;   // this thread's rows: row, row + 8
    const uint64_t dqh = smem_desc_sw128(sm + L::QHI + wg * 64 * ROW, 16);
    const uint64_t dql = smem_desc_sw128(sm + L::QLO + wg * 64 * ROW, 16);
    auto plane = [&](int p) { return sm + L::SLOT + (p % NS) * F_PLANE; };
    auto wait_plane = [&](int p) { mbar_wait(bar_full + p % NS, (p / NS) & 1); };
    auto release = [&](int p) { if (lane == 0) mbar_arrive(bar_free + p % NS); };

    float acc[F_D / 2];                              // O, 64 rows x 128 per warpgroup
#pragma unroll
    for (int i = 0; i < F_D / 2; ++i) acc[i] = 0.f;
    float m_i[2] = {NEG_INF, NEG_INF};               // score domain
    float l_i[2] = {0.f, 0.f};                       // this thread's partial row sums
    float sc[BN / 2], corr[2];
    uint32_t ph[BN / 8][4], pl[BN / 8][4];           // P's hi and lo as A fragments

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int p = 4 * j, kv0 = j * BN;
      wait_plane(p);
      wait_plane(p + 1);
      const uint64_t dkh = smem_desc_sw128(plane(p), 16);
      const uint64_t dkl = smem_desc_sw128(plane(p + 1), 16);
      wgmma_fence();
      // the small terms first, while the accumulator is small: the tensor
      // cores round each step toward zero, by up to an ulp of the sum
#pragma unroll
      for (int kk = 0; kk < F_D / 8; ++kk) {
        const uint32_t qo = ((kk / 4) * BM * ROW + (kk % 4) * 32) / 16;
        const uint32_t ko = ((kk / 4) * BN * ROW + (kk % 4) * 32) / 16;
        wgmma_ss_tf32_n64(sc, dqh + qo, dkl + ko, kk > 0);
        wgmma_ss_tf32_n64(sc, dql + qo, dkh + ko, 1);
      }
#pragma unroll
      for (int kk = 0; kk < F_D / 8; ++kk) {
        const uint32_t qo = ((kk / 4) * BM * ROW + (kk % 4) * 32) / 16;
        const uint32_t ko = ((kk / 4) * BN * ROW + (kk % 4) * 32) / 16;
        wgmma_ss_tf32_n64(sc, dqh + qo, dkh + ko, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      const int* mk = reinterpret_cast<const int*>(sm + L::MASK + (p % NS) * BN * 4);
      if (causal && kv0 + BN - 1 > wrow0)
        softmax_tile_f32<true, BN>(sc, mk, m_i, l_i, corr, row, kv0, t);
      else
        softmax_tile_f32<false, BN>(sc, mk, m_i, l_i, corr, row, kv0, t);
      fence_regs(sc);                                // p computed before the release
      release(p);
      release(p + 1);
#pragma unroll
      for (int dt = 0; dt < F_D / 8; ++dt) {
        acc[4 * dt] *= corr[0]; acc[4 * dt + 1] *= corr[0];
        acc[4 * dt + 2] *= corr[1]; acc[4 * dt + 3] *= corr[1];
      }
      split_acc_tf32(ph, pl, sc);
      wait_plane(p + 2);
      wait_plane(p + 3);
      const uint64_t dvh = smem_desc_sw128(plane(p + 2), 16);
      const uint64_t dvl = smem_desc_sw128(plane(p + 3), 16);
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const uint32_t vo = ((kk / 4) * F_D * ROW + (kk % 4) * 32) / 16;
        wgmma_rs_tf32_n128(acc, ph[kk], dvh + vo);
        wgmma_rs_tf32_n128(acc, ph[kk], dvl + vo);
        wgmma_rs_tf32_n128(acc, pl[kk], dvh + vo);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      release(p + 2);
      release(p + 3);
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
      float* orow = o + (((long long)b * Sq + rr) * H + h) * F_D;
      const float inv = 1.f / l_i[r];
#pragma unroll
      for (int dt = 0; dt < F_D / 8; ++dt)
        *reinterpret_cast<float2*>(orow + dt * 8 + 2 * t) =
            make_float2(acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
      if (t == 0) lse[((long long)b * H + h) * Sq + rr] = m_i[r] + logf(l_i[r]);
    }
  }
}

// ------------------------------------------- f32 at D = 256 / 3xTF32 mma.sync
constexpr int M_WARPS = 8;               // 16 q rows each
constexpr int M_BM = 16 * M_WARPS;       // q rows per CTA
constexpr int M_BN = 32;                 // kv rows per tile
constexpr int M_SMEM = (M_BM + 2 * M_BN) * M_LD * 4 + M_BN * 4;

// The f32 forward at D = 256 (see the header): q, k, v read through their
// strides, o (B, Sq, H, 256) f32 contiguous, lse (B, H, Sq).
__global__ void __launch_bounds__(32 * M_WARPS, 1)
flash_fwd_d256_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ mask,
                          float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv,
                          int H, int causal, long long qsb, long long qss, long long qsh,
                          long long ksb, long long kss, long long ksh, long long vsb,
                          long long vss, long long vsh) {
  extern __shared__ float4 smem_f4[];
  float* sq = reinterpret_cast<float*>(smem_f4);
  float* sk = sq + M_BM * M_LD;
  float* sv = sk + M_BN * M_LD;
  int* smk = reinterpret_cast<int*>(sv + M_BN * M_LD);
  const int q0 = blockIdx.x * M_BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp * 16;                       // the warp's rows in the tile
  const int row = q0 + wr + g;                    // this thread's rows: row, row + 8
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  load_rows_f32(sq, q + b * qsb + h * qsh, qss, q0, M_BM, Sq, 32 * M_WARPS);

  float acc[M_D / 8][4];                          // O: 16 rows x 256 a warp
#pragma unroll
  for (int i = 0; i < M_D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};
  int n_tiles = Skv / M_BN;
  if (causal) n_tiles = min(n_tiles, (q0 + M_BM - 1) / M_BN + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * M_BN;
    __syncthreads();                              // the last tile's reads are done
    load_rows_f32(sk, kb, kss, kv0, M_BN, Skv, 32 * M_WARPS);
    load_rows_f32(sv, vb, vss, kv0, M_BN, Skv, 32 * M_WARPS);
    if (threadIdx.x < M_BN) smk[threadIdx.x] = mask[(long long)b * Skv + kv0 + threadIdx.x];
    __syncthreads();
    float sc[M_BN / 8][4];                        // S: 16 x 32 a warp
#pragma unroll
    for (int i = 0; i < M_BN / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < M_D / 8; ++kk) {
      uint32_t ah[4], al[4];
      a_frag_3x(ah, al, sq + (wr + g) * M_LD + kk * 8 + t);
      mma_abt(sc, ah, al, sk + g * M_LD + kk * 8 + t);
    }
    float(&s)[M_BN / 2] = *reinterpret_cast<float(*)[M_BN / 2]>(&sc[0][0]);
    float corr[2];
    if (causal && kv0 + M_BN - 1 > q0 + wr)
      softmax_tile_f32<true, M_BN>(s, smk, m_i, l_i, corr, row, kv0, t);
    else
      softmax_tile_f32<false, M_BN>(s, smk, m_i, l_i, corr, row, kv0, t);
#pragma unroll
    for (int nt = 0; nt < M_D / 8; ++nt) {
      acc[nt][0] *= corr[0]; acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1]; acc[nt][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < M_BN / 8; ++kk)      // O += P V, P split a slice at a time
      mma_acc_b(acc, sc[kk], sv + (kk * 8 + 2 * t) * M_LD + g);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    if (l_i[r] == 0.f) l_i[r] = 1.f;   // l_safe
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= Sq) continue;
    float* orow = o + (((long long)b * Sq + rr) * H + h) * M_D;
    const float inv = 1.f / l_i[r];
#pragma unroll
    for (int nt = 0; nt < M_D / 8; ++nt)
      *reinterpret_cast<float2*>(orow + nt * 8 + 2 * t) =
          make_float2(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
    if (t == 0) lse[((long long)b * H + h) * Sq + rr] = m_i[r] + logf(l_i[r]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 128 or 256.  bf16, and f32 at
// D = 256: q, k, v (B, S, H, D) at element strides for the (B, S, H) axes
// (the D axis contiguous).  f32 at D = 128: q and k are the natural split
// planes of pbt_tf32_split (flash_bwd.cu) and v its transposed planes; the
// strides are not read.  Returns cudaGetLastError(), 1000 + the CUresult of
// a tensor map the driver refused (1000 alone where the driver offers no
// encoder), or cudaErrorInvalidValue for another D.
extern "C" int pbt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* lse,
                             int B, int Sq, int Skv, int H, int D, int dtype, int causal,
                             long long qsb, long long qss, long long qsh,
                             long long ksb, long long kss, long long ksh,
                             long long vsb, long long vss, long long vsh,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == M_D) {
    cudaFuncSetAttribute(flash_fwd_d256_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         M_SMEM);
    dim3 grid((Sq + M_BM - 1) / M_BM, H, B);
    flash_fwd_d256_mma_kernel<<<grid, 32 * M_WARPS, M_SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)mask, (float*)o,
        (float*)lse, Sq, Skv, H, causal, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh);
    return (int)cudaGetLastError();
  }
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return TMAP_ERROR;
  CUtensorMap tq, tk, tv, tm;
  if (dtype == 1) {
    const int bn = D == 128 ? K1Tiles<128>::BN : K1Tiles<256>::BN;
    CUresult r = qkv_map(enc, &tq, q, B, Sq, H, qsb, qss, qsh, K1_BM, D);
    if (r == CUDA_SUCCESS) r = qkv_map(enc, &tk, k, B, Skv, H, ksb, kss, ksh, bn, D);
    if (r == CUDA_SUCCESS) r = qkv_map(enc, &tv, v, B, Skv, H, vsb, vss, vsh, bn, D);
    if (r == CUDA_SUCCESS) r = mask_map(enc, &tm, mask, B, Skv, bn);
    if (r != CUDA_SUCCESS) return TMAP_ERROR + (int)r;
    if (D == 256)
      return launch_fwd_bf16<false, false, 256>(tq, tk, tv, tm, o, lse, B, Sq, Skv, H, causal,
                                                K1_UNITS, st);
    return launch_fwd_bf16<false, false, 128>(tq, tk, tv, tm, o, lse, B, Sq, Skv, H, causal,
                                              K1_UNITS, st);
  } else {
    CUresult r = plane_map(enc, &tq, q, B * H, Sq, F_D, K1_BM);
    if (r == CUDA_SUCCESS) r = plane_map(enc, &tk, k, B * H, Skv, F_D, F_BN);
    if (r == CUDA_SUCCESS) r = plane_map(enc, &tv, v, B * H, F_D, Skv, F_D);
    if (r == CUDA_SUCCESS) r = mask_map(enc, &tm, mask, B, Skv, F_BN);
    if (r != CUDA_SUCCESS) return TMAP_ERROR + (int)r;
    cudaFuncSetAttribute(flash_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         K1F32Smem::ALLOC);
    dim3 grid((Sq + K1_BM - 1) / K1_BM, H, B);
    flash_fwd_tf32_kernel<<<grid, 128 * (K1_WG + 1), K1F32Smem::ALLOC, st>>>(
        tq, tk, tv, tm, (float*)o, (float*)lse, Sq, Skv, H, causal);
  }
  return (int)cudaGetLastError();
}
