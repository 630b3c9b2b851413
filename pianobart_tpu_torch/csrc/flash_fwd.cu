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
// f32 design (3xTF32, the default PianoBartConfig's path, D = 128): the
// same schedule on the tensor cores at f32 accuracy.  tf32 wgmma reads its
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
// 256 KB), so the f32 kernel runs at D = 256 as a cluster of two CTAs, one
// per 128-column half of the head (flash_fwd_tf32_kernel<256>): each CTA is
// the D = 128 kernel on its half of the planes (Q's half fixed, K's and
// V^T's halves streamed, O's half stored), and S = Q K^T, which sums over
// all of D, is summed across the pair: after its S products a CTA releases
// K hi's slot to the ring, stores its partial S into the peer's K lo slot
// (distributed shared memory; the peer's warps have said that slot is free)
// and adds the peer's partial from its own (hopper.cuh:pair_open .. pair_add;
// 32 KB each way a tile).  Both CTAs add the same two numbers, so both hold
// the same S, softmax, P and lse to the bit; rank 0 stores lse.  The pair
// reads what one D = 128 CTA reads, so the L2 traffic and the FLOPs a CTA
// equal the D = 128 kernel's at the same B, and so does the bound.
#include "flash_common.cuh"
#include "flash_fwd_bf16.cuh"
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
  // Q, full[S], free[S], and for a pair the exchange's ready and full
  static constexpr int BAR = MASK + F_SLOTS * F_BN * 4;
  static constexpr int ALLOC = BAR + (1 + 2 * F_SLOTS + 2) * 8 + 1024;
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
// boxes of F_BN keys.  DW, the head width: 128, or 256 as CTA pairs along x
// (blockIdx.x / 2 the q tile, the cluster rank the half of D).
template <int DW>
__global__ void __launch_bounds__(128 * (K1_WG + 1), 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tm,
                      float* __restrict__ o, float* __restrict__ lse,
                      int Sq, int Skv, int H, int causal) {
  using L = K1F32Smem;
  constexpr bool PAIR = DW == 2 * F_D;
  constexpr int NWG = K1_WG;
  constexpr int BM = K1_BM, BN = F_BN, NS = F_SLOTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* bar_full = bar_q + 1;       // plane of slot s landed
  uint64_t* bar_free = bar_full + NS;   // slot s read by every consumer warp
  uint64_t* x_ready = bar_free + NS;    // pair: the peer's slot takes this CTA's S
  uint64_t* x_full = x_ready + 1;       // pair: the peer's S landed in this CTA's slot

  uint32_t rank = 0;                    // pair: which half of D
  if constexpr (PAIR) rank = cluster_ctarank();
  const int c0 = rank * F_D;            // this CTA's first column of the head
  const int q0 = (PAIR ? blockIdx.x >> 1 : blockIdx.x) * BM, h = blockIdx.y, b = blockIdx.z;
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
    if constexpr (PAIR) {
      mbar_init(x_ready, 4 * NWG);        // each of the peer's consumer warps
      mbar_init(x_full, 128 * NWG);       // each of the peer's consumer threads
    }
    mbar_fence_init();
  }
  if constexpr (PAIR) cluster_sync();     // both CTAs' barriers ready
  else __syncthreads();

  if (wg == NWG) {
    // ---- producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * NWG) {
      mbar_arrive_expect_tx(bar_q, 2 * BM * 4 * F_D);
      for (int pl = 0; pl < 2; ++pl)
        for (int x = 0; x < 4; ++x)
          tma_load_4d(sm + (pl ? L::QLO : L::QHI) + x * BM * ROW, &tq, bar_q, c0 + FBOX * x,
                      q0, bh, pl);
      for (int p = 0; p < n_planes; ++p) {
        const int s = p % NS, kv0 = (p / 4) * BN, kind = p % 4;
        mbar_wait(bar_free + s, ((p / NS) & 1) ^ 1);   // the first round passes
        unsigned char* dst = sm + L::SLOT + s * F_PLANE;
        if (kind < 2) {                                  // K hi or lo: 4 boxes of BN rows
          mbar_arrive_expect_tx(bar_full + s, F_PLANE + (kind == 0 ? BN * 4 : 0));
          for (int x = 0; x < 4; ++x)
            tma_load_4d(dst + x * BN * ROW, &tk, bar_full + s, c0 + FBOX * x, kv0, bh, kind);
          if (kind == 0) tma_load_2d(sm + L::MASK + s * BN * 4, &tm, bar_full + s, kv0, b);
        } else {                                         // V^T hi or lo: 2 boxes of 128 rows
          mbar_arrive_expect_tx(bar_full + s, F_PLANE);
          for (int x = 0; x < 2; ++x)
            tma_load_4d(dst + x * F_D * ROW, &tv, bar_full + s, kv0 + FBOX * x, c0, bh,
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
      if constexpr (PAIR) {
        // S over this CTA's half of D: K hi's slot goes back to the ring, K
        // lo's takes the peer's partial S, and the sum is S over all of D
        release(p);
        const uint32_t dst = pair_open(plane(p + 1), x_ready, rank ^ 1, j & 1, lane == 0);
        pair_put(dst, sc, 0, 128 * NWG, threadIdx.x);
        pair_close(x_full, rank ^ 1, j & 1);
        pair_add(sc, plane(p + 1), 0, 128 * NWG, threadIdx.x);
        fence_proxy_async();               // read before the slot's next TMA write
        __syncwarp();
        release(p + 1);
      }
      const int* mk = reinterpret_cast<const int*>(sm + L::MASK + (p % NS) * BN * 4);
      if (causal && kv0 + BN - 1 > wrow0)
        softmax_tile_f32<true, BN>(sc, mk, m_i, l_i, corr, row, kv0, t);
      else
        softmax_tile_f32<false, BN>(sc, mk, m_i, l_i, corr, row, kv0, t);
      fence_regs(sc);                                // p computed before the release
      if constexpr (!PAIR) {
        release(p);
        release(p + 1);
      }
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
      float* orow = o + (((long long)b * Sq + rr) * H + h) * DW + c0;
      const float inv = 1.f / l_i[r];
#pragma unroll
      for (int dt = 0; dt < F_D / 8; ++dt)
        *reinterpret_cast<float2*>(orow + dt * 8 + 2 * t) =
            make_float2(acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
      if (t == 0 && rank == 0) lse[((long long)b * H + h) * Sq + rr] = m_i[r] + logf(l_i[r]);
    }
  }
  if constexpr (PAIR) cluster_sync();     // no CTA leaves while its peer may reach it
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 128 or 256.  bf16: q, k, v (B, S,
// H, D) at element strides for the (B, S, H) axes (the D axis contiguous).
// f32: q and k are the natural split planes of pbt_tf32_split (flash_bwd.cu)
// and v its transposed planes; the strides are not read.  Returns cudaGetLastError(), 1000 + the CUresult of
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
    CUresult r = plane_map(enc, &tq, q, B * H, Sq, D, K1_BM);
    if (r == CUDA_SUCCESS) r = plane_map(enc, &tk, k, B * H, Skv, D, F_BN);
    if (r == CUDA_SUCCESS) r = plane_map(enc, &tv, v, B * H, D, Skv, F_D);
    if (r == CUDA_SUCCESS) r = mask_map(enc, &tm, mask, B, Skv, F_BN);
    if (r != CUDA_SUCCESS) return TMAP_ERROR + (int)r;
    const int tiles = (Sq + K1_BM - 1) / K1_BM;
    if (D == 256)
      return (int)launch_pair(flash_fwd_tf32_kernel<256>, dim3(2 * tiles, H, B),
                              128 * (K1_WG + 1), K1F32Smem::ALLOC, st, tq, tk, tv, tm,
                              (float*)o, (float*)lse, Sq, Skv, H, causal);
    cudaFuncSetAttribute(flash_fwd_tf32_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         K1F32Smem::ALLOC);
    dim3 grid(tiles, H, B);
    flash_fwd_tf32_kernel<128><<<grid, 128 * (K1_WG + 1), K1F32Smem::ALLOC, st>>>(
        tq, tk, tv, tm, (float*)o, (float*)lse, Sq, Skv, H, causal);
  }
  return (int)cudaGetLastError();
}
