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
// 3.35 TB/s, so the kernel is bound by operations.  At the long-context
// shape (B=16, S=2048) K3a does 3 of those products (0.417 ms) and K3b 4
// (0.556 ms), both bound by operations.
//
// Design (simple first).  The TPU kernel held one (b, h)'s whole 1024 x 1024
// block in VMEM and computed S, P, dP and dS once; a CTA has 227 KB, so here
// the backward is tiled and split into two kernels with no atomics and a
// deterministic result:
//   dkv: one CTA per (64-row kv tile, head, batch), four warps of 16 kv rows,
//        sweeping 64-row q tiles; dK and dV accumulate in registers.  The q
//        tile is taken in two 32-column halves to keep the live S^T and dP^T
//        fragments small beside the two 16 x 128 accumulators.
//   dq:  one CTA per (64-row q tile, head, batch), four warps of 16 q rows,
//        sweeping 64-row kv tiles, as the forward does; dQ accumulates in
//        registers.
// So S, P and dP are computed twice (seven products instead of five): the
// price of having no cross-CTA reduction.  The bf16 kernels run every product
// on the tensor cores with mma.sync m16n8k16 (f32 accumulation) and round P
// and dS to bf16 as operands of their products, as the TPU's single-pass
// bf16 MXU dots did; hence the stated bf16 tolerance.  The f32 kernels do the
// same algorithm with FMAs on the CUDA cores, for checks where the point is
// the algorithm.  Causal tiles wholly above the diagonal are skipped.  Left
// on the table: wgmma and TMA, a pipelined tile loop, ldmatrix(.trans) in
// place of the scalar B gathers, and the fused one-pass schedule.
#include "flash_common.cuh"

namespace {

using namespace pbt;

// ---------------------------------------------------------------- bf16 / mma
constexpr int BM = 64;        // q rows per tile
constexpr int BN = 64;        // kv rows per tile
constexpr int THREADS = 128;  // four warps, 16 rows each
constexpr size_t MMA_SMEM = 4 * 64 * LDS * sizeof(__nv_bfloat16) +
                            2 * BM * sizeof(float) + BN * sizeof(int);

__global__ void __launch_bounds__(THREADS)
flash_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const int* __restrict__ mask,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv,
                      int Sq, int Skv, int H, int causal,
                      long long qsb, long long qss, long long qsh,
                      long long ksb, long long kss, long long ksh,
                      long long vsb, long long vss, long long vsh,
                      long long osb, long long oss, long long osh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BN * LDS;
  __nv_bfloat16* Qs = Vs + BN * LDS;
  __nv_bfloat16* Os = Qs + BM * LDS;   // dO tile
  float* Ls = reinterpret_cast<float*>(Os + BM * LDS);
  float* Ds = Ls + BM;

  const int kv0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;

  load_tile_bf16<THREADS>(Ks, k + b * ksb + (long long)kv0 * kss + h * ksh, kss, BN);
  load_tile_bf16<THREADS>(Vs, v + b * vsb + (long long)kv0 * vss + h * vsh, vss, BN);
  int kv_row[2];
  bool kv_keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kv_row[r] = kv0 + wr + g + 8 * r;
    kv_keep[r] = mask[(long long)b * Skv + kv_row[r]] != 0;
  }

  float acc_k[HEAD_DIM / 8][4], acc_v[HEAD_DIM / 8][4];
#pragma unroll
  for (int i = 0; i < HEAD_DIM / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  const float* lse_bh = lse + ((long long)b * H + h) * Sq;
  const float* dl_bh = delta + ((long long)b * H + h) * Sq;
  // causal: q tile i holds rows i*BM .. i*BM+BM-1 and needs one >= kv0
  const int i0 = causal ? kv0 / BM : 0;
  for (int i = i0; i < Sq / BM; ++i) {
    const int q0 = i * BM;
    __syncthreads();  // previous tile fully consumed
    load_tile_bf16<THREADS>(Qs, q + b * qsb + (long long)q0 * qss + h * qsh, qss, BM);
    load_tile_bf16<THREADS>(Os, dout + b * osb + (long long)q0 * oss + h * osh, oss, BM);
    for (int j = threadIdx.x; j < BM; j += THREADS) {
      Ls[j] = lse_bh[q0 + j];
      Ds[j] = dl_bh[q0 + j];
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;   // first q column of this half, in the tile
      // S^T = K Q^T and dP^T = V dO^T for 16 kv rows x 32 q columns
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HEAD_DIM; kk += 16) {
        uint32_t ak[4], av[4];
        load_a(ak, Ks + (wr + g) * LDS + kk + 2 * t);
        load_a(av, Vs + (wr + g) * LDS + kk + 2 * t);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int off = (c0 + nt * 8 + g) * LDS + kk + 2 * t;
          mma_bt(s[nt], ak, Qs + off);
          mma_bt(dp[nt], av, Os + off);
        }
      }
      // P^T = exp(S^T - lse), dS^T = P^T * (dP^T - delta)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nt * 8 + 2 * t + (e & 1);
          const bool keep = kv_keep[e >> 1] && (!causal || q0 + col >= kv_row[e >> 1]);
          const float p = __expf((keep ? s[nt][e] : NEG_INF) - Ls[col]);
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - Ds[col]);
        }
      }
      // dV += P^T dO, dK += dS^T Q over these 32 q rows
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(ads, dp[2 * kk], dp[2 * kk + 1]);
        const int row = (c0 + kk * 16 + 2 * t) * LDS + g;
#pragma unroll
        for (int dt = 0; dt < HEAD_DIM / 8; ++dt) {
          mma_b(acc_v[dt], ap, Os + row + dt * 8);
          mma_b(acc_k[dt], ads, Qs + row + dt * 8);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long base = (((long long)b * Skv + kv_row[r]) * H + h) * HEAD_DIM;
#pragma unroll
    for (int dt = 0; dt < HEAD_DIM / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + base + dt * 8 + 2 * t) =
          pack_bf16(acc_k[dt][2 * r], acc_k[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + dt * 8 + 2 * t) =
          pack_bf16(acc_v[dt][2 * r], acc_v[dt][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const int* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq,
                     int Sq, int Skv, int H, int causal,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long osb, long long oss, long long osh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + BM * LDS;   // dO tile
  __nv_bfloat16* Ks = Os + BM * LDS;
  __nv_bfloat16* Vs = Ks + BN * LDS;
  int* Ms = reinterpret_cast<int*>(Vs + BN * LDS);

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;

  load_tile_bf16<THREADS>(Qs, q + b * qsb + (long long)q0 * qss + h * qsh, qss, BM);
  load_tile_bf16<THREADS>(Os, dout + b * osb + (long long)q0 * oss + h * osh, oss, BM);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = ((long long)b * H + h) * Sq + q0 + wr + g + 8 * r;
    lse_r[r] = lse[at];
    dl_r[r] = delta[at];
  }

  float acc[HEAD_DIM / 8][4];
#pragma unroll
  for (int i = 0; i < HEAD_DIM / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_tiles = Skv / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);  // skip tiles above the diagonal

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BN;
    __syncthreads();
    load_tile_bf16<THREADS>(Ks, k + b * ksb + (long long)kv0 * kss + h * ksh, kss, BN);
    load_tile_bf16<THREADS>(Vs, v + b * vsb + (long long)kv0 * vss + h * vsh, vss, BN);
    for (int i = threadIdx.x; i < BN; i += THREADS)
      Ms[i] = mask[(long long)b * Skv + kv0 + i];
    __syncthreads();

    // S = Q K^T and dP = dO V^T for 16 q rows x 64 kv columns
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM; kk += 16) {
      uint32_t aq[4], ao[4];
      load_a(aq, Qs + (wr + g) * LDS + kk + 2 * t);
      load_a(ao, Os + (wr + g) * LDS + kk + 2 * t);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int off = (nt * 8 + g) * LDS + kk + 2 * t;
        mma_bt(s[nt], aq, Ks + off);
        mma_bt(dp[nt], ao, Vs + off);
      }
    }
    // dS = exp(S - lse) * (dP - delta)
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int row = q0 + wr + g + (e >= 2 ? 8 : 0);
        const bool keep = Ms[col] != 0 && (!causal || row >= kv0 + col);
        const float p = __expf((keep ? s[nt][e] : NEG_INF) - lse_r[e >> 1]);
        s[nt][e] = p * (dp[nt][e] - dl_r[e >> 1]);
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
      const __nv_bfloat16* kb = Ks + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int dt = 0; dt < HEAD_DIM / 8; ++dt) mma_b(acc[dt], a, kb + dt * 8);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    __nv_bfloat16* qrow = dq + (((long long)b * Sq + row) * H + h) * HEAD_DIM;
#pragma unroll
    for (int dt = 0; dt < HEAD_DIM / 8; ++dt)
      *reinterpret_cast<uint32_t*>(qrow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// ------------------------------------------------------------------ f32 / FMA
// Thread tid owns output column d = tid for FR rows; scores are computed one
// (row, column) pair per thread into padded smem.
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

// The dK/dV kernel on `st`; returns its cudaGetLastError().
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* mask, const void* lse, const void* delta, void* dk,
               void* dv, int B, int Sq, int Skv, int H, int dtype, int causal,
               PBT_STRIDES, cudaStream_t st) {
  if (dtype == 1) {
    typedef const __nv_bfloat16* cbf;
    cudaFuncSetAttribute(flash_dkv_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MMA_SMEM);
    flash_dkv_bf16_kernel<<<dim3(Skv / BN, H, B), THREADS, MMA_SMEM, st>>>(
        (cbf)q, (cbf)k, (cbf)v, (cbf)dout, (const int*)mask, (const float*)lse,
        (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Sq, Skv, H,
        causal, PBT_STRIDE_ARGS);
  } else {
    cudaFuncSetAttribute(flash_dkv_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    flash_dkv_f32_kernel<<<dim3(Skv / FR, H, B), THREADS, F32_SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const int*)mask, (const float*)lse, (const float*)delta, (float*)dk,
        (float*)dv, Sq, Skv, H, causal, PBT_STRIDE_ARGS);
  }
  return (int)cudaGetLastError();
}

// The dQ kernel on `st`; returns its cudaGetLastError().
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* mask, const void* lse, const void* delta, void* dq,
              int B, int Sq, int Skv, int H, int dtype, int causal, PBT_STRIDES,
              cudaStream_t st) {
  if (dtype == 1) {
    typedef const __nv_bfloat16* cbf;
    cudaFuncSetAttribute(flash_dq_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MMA_SMEM);
    flash_dq_bf16_kernel<<<dim3(Sq / BM, H, B), THREADS, MMA_SMEM, st>>>(
        (cbf)q, (cbf)k, (cbf)v, (cbf)dout, (const int*)mask, (const float*)lse,
        (const float*)delta, (__nv_bfloat16*)dq, Sq, Skv, H, causal,
        PBT_STRIDE_ARGS);
  } else {
    cudaFuncSetAttribute(flash_dq_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    flash_dq_f32_kernel<<<dim3(Sq / FR, H, B), THREADS, F32_SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const int*)mask, (const float*)lse, (const float*)delta, (float*)dq,
        Sq, Skv, H, causal, PBT_STRIDE_ARGS);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// (B, S, H) axes of q, k, v and dO; the D axis must be contiguous.  Each
// entry launches on `stream` and returns the first cudaGetLastError() that
// is not cudaSuccess.

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
