// Flash attention forward for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces the Pallas TPU kernel pianobart_tpu/ops/flash.py:_fwd_kernel
// (launched by _fwd). Same contract:
//   q, k, v   (B, S, H, D) bf16 or f32, read through their strides; q is
//             already scaled by D**-0.5 by the caller.
//   kv_mask   (B, Skv) int32, nonzero = attend.  causal: keep row >= col.
//   o         (B, Sq, H, D) contiguous, input dtype.
//   lse       (B, H, Sq) f32 row logsumexp.
// Online softmax with f32 running max m, sum l and accumulator.  Masked
// scores are the finite -1e30 (not -inf) so fully masked rows stay finite;
// l == 0 is guarded as in the reference (l_safe).
//
// Bound at the serving shape (S=1024, H=8, D=128, bf16): 4*B*H*S^2*D FLOPs
// = 4.29 GFLOP per unit of B, about 4.3 us x B at 989 TFLOP/s bf16; the
// q/k/v/o bytes (8.4 MB x B) take about 2.5 us x B at 3.35 TB/s, so the
// kernel is bound by operations.
//
// Design (simple first): one CTA per (64-row q tile, head, batch), four
// warps of 16 q rows each, looping over 64-row kv tiles held in shared
// memory.  The bf16 kernel runs both products on the tensor cores with
// mma.sync m16n8k16 (f32 accumulation); P is rounded to bf16 before P.V,
// as FlashAttention does, which is why the bf16 result differs from the
// all-f32 reference by about 1e-2 relative.  The f32 kernel does the same
// algorithm with FMAs on the CUDA cores, for checks where the point is the
// algorithm.  Left on the table: wgmma and TMA (the only route to the full
// tensor-core rate), a cp.async/TMA pipeline that overlaps the next tile's
// loads with this tile's math, ldmatrix for the fragments, and a persistent
// schedule; loads here are synchronous and the CTA waits on each tile.
#include "flash_common.cuh"

namespace {

using namespace pbt;

// ---------------------------------------------------------------- bf16 / mma
constexpr int BM = 64;              // q rows per CTA (16 per warp)
constexpr int BN = 64;              // kv rows per tile
constexpr int THREADS = 128;
constexpr size_t MMA_SMEM =
    3 * BM * LDS * sizeof(__nv_bfloat16) + BN * sizeof(int);

__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ mask,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int Sq, int Skv, int H, int causal,
                      long long qsb, long long qss, long long qsh,
                      long long ksb, long long kss, long long ksh,
                      long long vsb, long long vss, long long vsh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LDS;
  __nv_bfloat16* Vs = Ks + BN * LDS;
  int* Ms = reinterpret_cast<int*>(Vs + BN * LDS);

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma fragment coordinates
  const int wr = warp * 16;               // this warp's first row in the tile

  load_tile_bf16<THREADS>(Qs, q + b * qsb + (long long)q0 * qss + h * qsh, qss, BM);

  float m_i[2] = {NEG_INF, NEG_INF};  // rows g and g + 8
  float l_i[2] = {0.f, 0.f};          // this thread's partial row sums
  float acc[HEAD_DIM / 8][4];
#pragma unroll
  for (int i = 0; i < HEAD_DIM / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_tiles = Skv / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);  // skip tiles above the diagonal

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BN;
    __syncthreads();  // previous tile fully consumed
    load_tile_bf16<THREADS>(Ks, k + b * ksb + (long long)kv0 * kss + h * ksh, kss, BN);
    load_tile_bf16<THREADS>(Vs, v + b * vsb + (long long)kv0 * vss + h * vsh, vss, BN);
    for (int i = threadIdx.x; i < BN; i += THREADS)
      Ms[i] = mask[(long long)b * Skv + kv0 + i];
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM; kk += 16) {
      uint32_t a[4];
      const __nv_bfloat16* qa = Qs + (wr + g) * LDS + kk + 2 * t;
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LDS);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LDS + 8);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kb = Ks + (nt * 8 + g) * LDS + kk + 2 * t;
        mma_bf16(s[nt], a, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    // masks, then the online-softmax update
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int row = q0 + wr + g + (e >= 2 ? 8 : 0);
        const bool keep = Ms[col] != 0 && (!causal || row >= kv0 + col);
        if (!keep) s[nt][e] = NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      corr[r] = __expf(m_i[r] - m_new);
      m_i[r] = m_new;
      l_i[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - m_i[e >> 1]);
        l_i[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int dt = 0; dt < HEAD_DIM / 8; ++dt) {
      acc[dt][0] *= corr[0]; acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1]; acc[dt][3] *= corr[1];
    }

    // acc += P V: the S accumulators are reused as A fragments
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vb = Vs + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int dt = 0; dt < HEAD_DIM / 8; ++dt) {
        const __nv_bfloat16* p = vb + dt * 8;
        mma_bf16(acc[dt], a, pack_pair(p[0], p[LDS]),
                 pack_pair(p[8 * LDS], p[9 * LDS]));
      }
    }
  }

  // epilogue: full row sums, normalise, store O and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    if (l_i[r] == 0.f) l_i[r] = 1.f;  // l_safe
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    __nv_bfloat16* orow = o + (((long long)b * Sq + row) * H + h) * HEAD_DIM;
    const float inv = 1.f / l_i[r];
#pragma unroll
    for (int dt = 0; dt < HEAD_DIM / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    if (t == 0)
      lse[((long long)b * H + h) * Sq + row] = m_i[r] + logf(l_i[r]);
  }
}

// ------------------------------------------------------------------ f32 / FMA
constexpr int FM = 16;                    // q rows per CTA
constexpr int KP = HEAD_DIM + 1;          // K pitch: column reads hit distinct banks
constexpr int PP = BN + 1;                // P pitch
constexpr size_t FMA_SMEM =
    (FM * HEAD_DIM + BN * KP + BN * HEAD_DIM + FM * PP + 3 * FM) * sizeof(float) +
    BN * sizeof(int);

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ mask,
                     float* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Skv, int H, int causal,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + FM * HEAD_DIM;
  float* Vs = Ks + BN * KP;
  float* Ps = Vs + BN * HEAD_DIM;
  float* m_s = Ps + FM * PP;
  float* l_s = m_s + FM;
  float* c_s = l_s + FM;
  int* Ms = reinterpret_cast<int*>(c_s + FM);

  const int q0 = blockIdx.x * FM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;  // also the output column d this thread owns

  for (int i = tid; i < FM * HEAD_DIM; i += THREADS) {
    int r = i / HEAD_DIM, c = i % HEAD_DIM;
    Qs[i] = q[b * qsb + (long long)(q0 + r) * qss + h * qsh + c];
  }
  if (tid < FM) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }
  float acc[FM];
#pragma unroll
  for (int r = 0; r < FM; ++r) acc[r] = 0.f;

  int n_tiles = Skv / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + FM - 1) / BN + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BN;
    __syncthreads();
    for (int i = tid; i < BN * HEAD_DIM; i += THREADS) {
      int r = i / HEAD_DIM, c = i % HEAD_DIM;
      Ks[r * KP + c] = k[b * ksb + (long long)(kv0 + r) * kss + h * ksh + c];
      Vs[i] = v[b * vsb + (long long)(kv0 + r) * vss + h * vsh + c];
    }
    for (int i = tid; i < BN; i += THREADS) Ms[i] = mask[(long long)b * Skv + kv0 + i];
    __syncthreads();

    // scores: thread owns kv column c for 8 of the 16 rows
    {
      const int c = tid % BN, r0 = (tid / BN) * (FM / 2);
      for (int r = r0; r < r0 + FM / 2; ++r) {
        float sc = 0.f;
#pragma unroll 8
        for (int d = 0; d < HEAD_DIM; ++d) sc = fmaf(Qs[r * HEAD_DIM + d], Ks[c * KP + d], sc);
        const bool keep = Ms[c] != 0 && (!causal || q0 + r >= kv0 + c);
        Ps[r * PP + c] = keep ? sc : NEG_INF;
      }
    }
    __syncthreads();
    if (tid < FM) {  // online-softmax update of row tid
      float* pr = Ps + tid * PP;
      float mx = NEG_INF;
      for (int c = 0; c < BN; ++c) mx = fmaxf(mx, pr[c]);
      const float m_new = fmaxf(m_s[tid], mx);
      const float corr = expf(m_s[tid] - m_new);
      float sum = 0.f;
      for (int c = 0; c < BN; ++c) { pr[c] = expf(pr[c] - m_new); sum += pr[c]; }
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < FM; ++r) {
      float a = acc[r] * c_s[r];
      for (int c = 0; c < BN; ++c) a = fmaf(Ps[r * PP + c], Vs[c * HEAD_DIM + tid], a);
      acc[r] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < FM; ++r) {
    const float l = l_s[r] == 0.f ? 1.f : l_s[r];
    o[(((long long)b * Sq + q0 + r) * H + h) * HEAD_DIM + tid] = acc[r] / l;
  }
  if (tid < FM) {
    const float l = l_s[tid] == 0.f ? 1.f : l_s[tid];
    lse[((long long)b * H + h) * Sq + q0 + tid] = m_s[tid] + logf(l);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// (B, S, H) axes; the D axis must be contiguous.  Returns cudaGetLastError().
extern "C" int pbt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* lse,
                             int B, int Sq, int Skv, int H, int dtype, int causal,
                             long long qsb, long long qss, long long qsh,
                             long long ksb, long long kss, long long ksh,
                             long long vsb, long long vss, long long vsh,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    cudaFuncSetAttribute(flash_fwd_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MMA_SMEM);
    dim3 grid(Sq / BM, H, B);
    flash_fwd_bf16_kernel<<<grid, THREADS, MMA_SMEM, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const int*)mask, (__nv_bfloat16*)o, (float*)lse, Sq, Skv, H, causal,
        qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh);
  } else {
    cudaFuncSetAttribute(flash_fwd_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FMA_SMEM);
    dim3 grid(Sq / FM, H, B);
    flash_fwd_f32_kernel<<<grid, THREADS, FMA_SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)mask,
        (float*)o, (float*)lse, Sq, Skv, H, causal,
        qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh);
  }
  return (int)cudaGetLastError();
}
