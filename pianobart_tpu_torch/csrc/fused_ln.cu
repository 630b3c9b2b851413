// Fused dropout + residual add + LayerNorm for Hopper (sm_90a), bound to
// PyTorch through ctypes.
//
// Replaces the Pallas TPU kernels of pianobart_tpu/ops/fused_ln.py:
//   pbt_fused_ln_fwd  K4a, :91 _fwd_kernel (launched by _fwd_call):
//       y = residual + (keep ? h * ks : 0)        f32
//       out = (y - mean) * rstd * gamma + beta    in h's dtype
//     with f32 row statistics by the fast variance E[y^2] - mean^2, clamped
//     at 0 (large near-constant rows would otherwise give rsqrt of a
//     negative number), rstd = rsqrt(var + eps); saves mean and rstd (N,).
//   pbt_fused_ln_bwd  K4b, :112 _bwd_kernel (launched by _bwd_call):
//       regenerates the keep bits, rebuilds y and xhat = (y - mean) * rstd,
//       g = dout * gamma, dy = rstd * (g - mean(g) - xhat * mean(g * xhat)),
//       dres = dy, dh = keep ? dy * ks : 0, and per-CTA partial column sums
//       of dout * xhat (dgamma) and dout (dbeta), summed by the caller as
//       the reference sums its per-block partials outside Pallas: no
//       atomics, a deterministic result.
// h, residual, out, dout, dh, dres: (N, D) contiguous, bf16 or f32; gamma,
// beta: (D,) f32; D a multiple of 128 up to 8192, N a multiple of 128.
//
// Random bits.  keep = bits >= threshold, threshold = round(rate * 2^32),
// ks = 2^32 / (2^32 - threshold): the reference's 2^-32 quantisation.  The
// TPU kernel drew its bits from the core's PRNG seeded by (seed, block
// index), so its forward and backward had to block rows alike.  Here the
// bits are Philox4x32-10 keyed by the 64-bit seed (read through a device
// pointer, the role of the TPU kernel's SMEM seed, so the caller never waits
// on the device) with counter (e / 4, 0, 0) for the element index
// e = row * D + col: one call gives elements 4g .. 4g+3.  The mask then
// depends on no blocking, K4b regenerates exactly K4a's bits, and
// ops/fused_ln.py:philox_bits reproduces them in PyTorch.
//
// Bound: bytes.  At the flagship train shape (N = 32768 rows of D = 1024,
// bf16) K4a reads h and residual and writes out (192 MiB, 0.060 ms at
// 3.35 TB/s) and K4b reads h, residual and dout and writes dh and dres
// (320 MiB, 0.100 ms); about 10 and 20 f32 operations per element are far
// below the f32 rate.  Philox adds ~20 integer operations per element.
//
// Design (simple first): a lane holds four consecutive elements in each of
// up to MAX_NV groups of 128 columns (16-byte f32 or 8-byte bf16 loads,
// coalesced across the warp), the row kept in registers between the
// reduction and the write.  Rows of D <= 1024 take one warp each and reduce
// their statistics by warp shuffles.  A wider row is split across W warps
// of the CTA (W the power of two >= D / 1024, at most the CTA's 8 warps:
// D <= 8192), warp w taking the 128-column groups w, w + W, ...; each warp
// reduces by shuffles, and the W partial sums meet in shared memory, summed
// by every warp of the row in the same order.  K4b gives each CTA 64 rows
// (8 per warp, or 8 / W at a time) and accumulates each warp's dgamma/dbeta
// columns (up to D / W rounded up to 128) in its own slice of shared memory,
// then sums the slices into one partial row per CTA.  Left on the table: several rows per
// warp in flight, wider bf16 loads, a persistent grid with one partial per
// SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_NV = 8;        // 4-element groups per lane: D <= 1024 a warp
constexpr int BWD_ROWS = 64;     // rows per K4b CTA, 8 per warp

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// keep bits of the four elements 4g .. 4g+3, as bits 0..3
__device__ __forceinline__ uint32_t keep4(unsigned long long g, uint32_t k0,
                                          uint32_t k1, uint32_t threshold) {
  const uint4 b = philox4x32_10((uint32_t)g, (uint32_t)(g >> 32), k0, k1);
  return (uint32_t)(b.x >= threshold) | ((uint32_t)(b.y >= threshold) << 1) |
         ((uint32_t)(b.z >= threshold) << 2) | ((uint32_t)(b.w >= threshold) << 3);
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<uint32_t*>(&a);
  x.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ln_fwd_kernel(const T* __restrict__ h, const T* __restrict__ res,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const long long* __restrict__ seed, T* __restrict__ out,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out,
                    int N, int D, uint32_t threshold, float ks, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= N) return;
  const int nv = D / 128;
  const unsigned long long s = (unsigned long long)seed[0];
  const uint32_t k0 = (uint32_t)s, k1 = (uint32_t)(s >> 32);
  const long long base = row * D;

  float y[MAX_NV][4];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_NV; ++j) {
    if (j < nv) {
      const int col = 4 * (lane + 32 * j);
      float hv[4], rv[4];
      load4(h + base + col, hv);
      load4(res + base + col, rv);
      const uint32_t keep = keep4((unsigned long long)(base + col) / 4, k0, k1, threshold);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[j][e] = rv[e] + (((keep >> e) & 1u) ? hv[e] * ks : 0.f);
        sum += y[j][e];
        sq += y[j][e] * y[j][e];
      }
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum / D;
  const float var = fmaxf(sq / D - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < MAX_NV; ++j) {
    if (j < nv) {
      const int col = 4 * (lane + 32 * j);
      float g[4], b[4], o[4];
      load4(gamma + col, g);
      load4(beta + col, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = (y[j][e] - mean) * rstd * g[e] + b[e];
      store4(out + base + col, o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Dynamic shared memory: 2 * WARPS * D floats (each warp's dgamma and dbeta
// columns), 64 KB at D = 1024.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ln_bwd_kernel(const T* __restrict__ h, const T* __restrict__ res,
                    const float* __restrict__ gamma, const float* __restrict__ mean,
                    const float* __restrict__ rstd, const T* __restrict__ dout,
                    const long long* __restrict__ seed, T* __restrict__ dh,
                    T* __restrict__ dres, float* __restrict__ dgamma_p,
                    float* __restrict__ dbeta_p, int N, int D, uint32_t threshold,
                    float ks) {
  extern __shared__ float acc_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = D / 128;
  float* dg_acc = acc_smem + warp * D;              // this warp's dgamma columns
  float* db_acc = acc_smem + (WARPS + warp) * D;    // and dbeta columns
  for (int c = lane; c < D; c += 32) dg_acc[c] = db_acc[c] = 0.f;
  __syncwarp();   // the lanes below update columns other lanes zeroed
  const unsigned long long s = (unsigned long long)seed[0];
  const uint32_t k0 = (uint32_t)s, k1 = (uint32_t)(s >> 32);

  for (int i = 0; i < BWD_ROWS / WARPS; ++i) {
    const long long row = (long long)blockIdx.x * BWD_ROWS + i * WARPS + warp;
    const long long base = row * D;
    const float mu = mean[row], rs = rstd[row];
    float xh[MAX_NV][4], g[MAX_NV][4];
    uint32_t keep[MAX_NV];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_NV; ++j) {
      if (j < nv) {
        const int col = 4 * (lane + 32 * j);
        float hv[4], rv[4], dv[4], gm[4];
        load4(h + base + col, hv);
        load4(res + base + col, rv);
        load4(dout + base + col, dv);
        load4(gamma + col, gm);
        keep[j] = keep4((unsigned long long)(base + col) / 4, k0, k1, threshold);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = rv[e] + (((keep[j] >> e) & 1u) ? hv[e] * ks : 0.f);
          xh[j][e] = (y - mu) * rs;
          g[j][e] = dv[e] * gm[e];
          m1 += g[j][e];
          m2 += g[j][e] * xh[j][e];
          dg_acc[col + e] += dv[e] * xh[j][e];
          db_acc[col + e] += dv[e];
        }
      }
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int j = 0; j < MAX_NV; ++j) {
      if (j < nv) {
        const int col = 4 * (lane + 32 * j);
        float dy[4], dhv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dy[e] = rs * (g[j][e] - m1 - xh[j][e] * m2);
          dhv[e] = ((keep[j] >> e) & 1u) ? dy[e] * ks : 0.f;
        }
        store4(dres + base + col, dy);
        store4(dh + base + col, dhv);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      sg += acc_smem[w * D + c];
      sb += acc_smem[(WARPS + w) * D + c];
    }
    dgamma_p[(long long)blockIdx.x * D + c] = sg;
    dbeta_p[(long long)blockIdx.x * D + c] = sb;
  }
}


// ------------------------------------------------- rows split across W warps
// Columns of a warp's slice in K4b: its part with the most groups, 128 each
// (D = 1152, W = 2: part 0 holds groups 0, 2, 4, 6, 8).
__host__ __device__ __forceinline__ int split_cols(int D, int W) {
  return (D / 128 + W - 1) / W * 128;
}

// The two kernels above for D > 1024: a row's 128-column groups go to W
// warps (warp part wp takes groups wp, wp + W, ...), 8 / W rows a CTA at a
// time.  Each warp's partial row sums meet in `red` (one pair per warp);
// every warp of the row adds its row's W pairs in the same order.

// Sum of x and y over the W warps of this warp's row, through red (2 x
// WARPS floats).  Every thread of the CTA calls it.
__device__ __forceinline__ float2 row_sum(float x, float y, float* red, int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = warp_sum(x);
  y = warp_sum(y);
  if (lane == 0) {
    red[warp] = x;
    red[WARPS + warp] = y;
  }
  __syncthreads();
  const int w0 = warp - warp % W;
  float2 s = make_float2(0.f, 0.f);
  for (int i = 0; i < W; ++i) {
    s.x += red[w0 + i];
    s.y += red[WARPS + w0 + i];
  }
  __syncthreads();   // red is free again
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ln_fwd_split_kernel(const T* __restrict__ h, const T* __restrict__ res,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const long long* __restrict__ seed, T* __restrict__ out,
                          float* __restrict__ mean_out, float* __restrict__ rstd_out,
                          int D, int W, uint32_t threshold, float ks, float eps) {
  __shared__ float red[2 * WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wp = warp % W;
  const long long row = (long long)blockIdx.x * (WARPS / W) + warp / W;  // N % (8 / W) == 0
  const int nv = (D / 128 - wp + W - 1) / W;      // this warp's groups, <= MAX_NV
  const unsigned long long s = (unsigned long long)seed[0];
  const uint32_t k0 = (uint32_t)s, k1 = (uint32_t)(s >> 32);
  const long long base = row * D;

  float y[MAX_NV][4];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_NV; ++j) {
    if (j < nv) {
      const int col = 4 * (lane + 32 * (wp + W * j));
      float hv[4], rv[4];
      load4(h + base + col, hv);
      load4(res + base + col, rv);
      const uint32_t keep = keep4((unsigned long long)(base + col) / 4, k0, k1, threshold);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[j][e] = rv[e] + (((keep >> e) & 1u) ? hv[e] * ks : 0.f);
        sum += y[j][e];
        sq += y[j][e] * y[j][e];
      }
    }
  }
  const float2 tot = row_sum(sum, sq, red, W);
  const float mean = tot.x / D;
  const float var = fmaxf(tot.y / D - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < MAX_NV; ++j) {
    if (j < nv) {
      const int col = 4 * (lane + 32 * (wp + W * j));
      float g[4], b[4], o[4];
      load4(gamma + col, g);
      load4(beta + col, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = (y[j][e] - mean) * rstd * g[e] + b[e];
      store4(out + base + col, o);
    }
  }
  if (lane == 0 && wp == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Dynamic shared memory: 2 * WARPS * split_cols(D, W) floats (each warp's
// dgamma and dbeta over its own columns), at most 64 KB.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ln_bwd_split_kernel(const T* __restrict__ h, const T* __restrict__ res,
                          const float* __restrict__ gamma, const float* __restrict__ mean,
                          const float* __restrict__ rstd, const T* __restrict__ dout,
                          const long long* __restrict__ seed, T* __restrict__ dh,
                          T* __restrict__ dres, float* __restrict__ dgamma_p,
                          float* __restrict__ dbeta_p, int D, int W, uint32_t threshold,
                          float ks) {
  extern __shared__ float acc_smem[];
  __shared__ float red[2 * WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wp = warp % W, rows = WARPS / W;       // rows in flight
  const int nv = (D / 128 - wp + W - 1) / W;
  const int cols = split_cols(D, W);                // each warp's slice
  float* dg_acc = acc_smem + warp * cols;           // local column 4 * (lane + 32 j) + e
  float* db_acc = acc_smem + (WARPS + warp) * cols;
  for (int c = lane; c < cols; c += 32) dg_acc[c] = db_acc[c] = 0.f;
  __syncwarp();
  const unsigned long long s = (unsigned long long)seed[0];
  const uint32_t k0 = (uint32_t)s, k1 = (uint32_t)(s >> 32);

  for (int i = 0; i < BWD_ROWS / rows; ++i) {
    const long long row = (long long)blockIdx.x * BWD_ROWS + i * rows + warp / W;
    const long long base = row * D;
    const float mu = mean[row], rs = rstd[row];
    float xh[MAX_NV][4], g[MAX_NV][4];
    uint32_t keep[MAX_NV];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_NV; ++j) {
      if (j < nv) {
        const int col = 4 * (lane + 32 * (wp + W * j)), lc = 4 * (lane + 32 * j);
        float hv[4], rv[4], dv[4], gm[4];
        load4(h + base + col, hv);
        load4(res + base + col, rv);
        load4(dout + base + col, dv);
        load4(gamma + col, gm);
        keep[j] = keep4((unsigned long long)(base + col) / 4, k0, k1, threshold);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = rv[e] + (((keep[j] >> e) & 1u) ? hv[e] * ks : 0.f);
          xh[j][e] = (y - mu) * rs;
          g[j][e] = dv[e] * gm[e];
          m1 += g[j][e];
          m2 += g[j][e] * xh[j][e];
          dg_acc[lc + e] += dv[e] * xh[j][e];
          db_acc[lc + e] += dv[e];
        }
      }
    }
    const float2 tot = row_sum(m1, m2, red, W);
    m1 = tot.x / D;
    m2 = tot.y / D;
#pragma unroll
    for (int j = 0; j < MAX_NV; ++j) {
      if (j < nv) {
        const int col = 4 * (lane + 32 * (wp + W * j));
        float dy[4], dhv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dy[e] = rs * (g[j][e] - m1 - xh[j][e] * m2);
          dhv[e] = ((keep[j] >> e) & 1u) ? dy[e] * ks : 0.f;
        }
        store4(dres + base + col, dy);
        store4(dh + base + col, dhv);
      }
    }
  }
  __syncthreads();
  // column c lies in group G = c / 128, held by the warps of part G % W at
  // local column 128 * (G / W) + c % 128
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const int G = c / 128, lc = 128 * (G / W) + c % 128;
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int w = r * W + G % W;
      sg += acc_smem[w * cols + lc];
      sb += acc_smem[(WARPS + w) * cols + lc];
    }
    dgamma_p[(long long)blockIdx.x * D + c] = sg;
    dbeta_p[(long long)blockIdx.x * D + c] = sb;
  }
}

// Warps a row of D takes: 1 up to 1024, else the power of two >= D / 1024.
int warps_per_row(int D) {
  int W = 1;
  while (W * 1024 < D) W *= 2;
  return W;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h, residual, out, dout, dh, dres).
// seed: one int64 on the device.  Each entry launches on `stream` and
// returns cudaGetLastError().

// K4a: N / 8 CTAs of 8 warps, one row per warp; for D > 1024, N / (8 / W)
// CTAs, a row per W warps.
extern "C" int pbt_fused_ln_fwd(const void* h, const void* res, const void* gamma,
                                const void* beta, const void* seed, void* out,
                                void* mean, void* rstd, int N, int D, int dtype,
                                uint32_t threshold, float ks, float eps,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int W = warps_per_row(D);
  if (W > 1) {
    const dim3 grid(N / (WARPS / W));
    if (dtype == 1) {
      typedef __nv_bfloat16 bf;
      fused_ln_fwd_split_kernel<bf><<<grid, THREADS, 0, st>>>(
          (const bf*)h, (const bf*)res, (const float*)gamma, (const float*)beta,
          (const long long*)seed, (bf*)out, (float*)mean, (float*)rstd, D, W,
          threshold, ks, eps);
    } else {
      fused_ln_fwd_split_kernel<float><<<grid, THREADS, 0, st>>>(
          (const float*)h, (const float*)res, (const float*)gamma,
          (const float*)beta, (const long long*)seed, (float*)out, (float*)mean,
          (float*)rstd, D, W, threshold, ks, eps);
    }
    return (int)cudaGetLastError();
  }
  const dim3 grid((N + WARPS - 1) / WARPS);
  if (dtype == 1) {
    typedef __nv_bfloat16 bf;
    fused_ln_fwd_kernel<bf><<<grid, THREADS, 0, st>>>(
        (const bf*)h, (const bf*)res, (const float*)gamma, (const float*)beta,
        (const long long*)seed, (bf*)out, (float*)mean, (float*)rstd, N, D,
        threshold, ks, eps);
  } else {
    fused_ln_fwd_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)h, (const float*)res, (const float*)gamma,
        (const float*)beta, (const long long*)seed, (float*)out, (float*)mean,
        (float*)rstd, N, D, threshold, ks, eps);
  }
  return (int)cudaGetLastError();
}

// K4b: N / 64 CTAs; dgamma_p and dbeta_p are (N / 64, D) f32 partials.
extern "C" int pbt_fused_ln_bwd(const void* h, const void* res, const void* gamma,
                                const void* mean, const void* rstd,
                                const void* dout, const void* seed, void* dh,
                                void* dres, void* dgamma_p, void* dbeta_p, int N,
                                int D, int dtype, uint32_t threshold, float ks,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(N / BWD_ROWS);
  const int W = warps_per_row(D);
  const int smem = 2 * WARPS * (W > 1 ? split_cols(D, W) : D) * (int)sizeof(float);
  if (W > 1) {
    if (dtype == 1) {
      typedef __nv_bfloat16 bf;
      cudaFuncSetAttribute(fused_ln_bwd_split_kernel<bf>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      fused_ln_bwd_split_kernel<bf><<<grid, THREADS, smem, st>>>(
          (const bf*)h, (const bf*)res, (const float*)gamma, (const float*)mean,
          (const float*)rstd, (const bf*)dout, (const long long*)seed, (bf*)dh,
          (bf*)dres, (float*)dgamma_p, (float*)dbeta_p, D, W, threshold, ks);
    } else {
      cudaFuncSetAttribute(fused_ln_bwd_split_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      fused_ln_bwd_split_kernel<float><<<grid, THREADS, smem, st>>>(
          (const float*)h, (const float*)res, (const float*)gamma,
          (const float*)mean, (const float*)rstd, (const float*)dout,
          (const long long*)seed, (float*)dh, (float*)dres, (float*)dgamma_p,
          (float*)dbeta_p, D, W, threshold, ks);
    }
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 bf;
    cudaFuncSetAttribute(fused_ln_bwd_kernel<bf>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_ln_bwd_kernel<bf><<<grid, THREADS, smem, st>>>(
        (const bf*)h, (const bf*)res, (const float*)gamma, (const float*)mean,
        (const float*)rstd, (const bf*)dout, (const long long*)seed, (bf*)dh,
        (bf*)dres, (float*)dgamma_p, (float*)dbeta_p, N, D, threshold, ks);
  } else {
    cudaFuncSetAttribute(fused_ln_bwd_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_ln_bwd_kernel<float><<<grid, THREADS, smem, st>>>(
        (const float*)h, (const float*)res, (const float*)gamma,
        (const float*)mean, (const float*)rstd, (const float*)dout,
        (const long long*)seed, (float*)dh, (float*)dres, (float*)dgamma_p,
        (float*)dbeta_p, N, D, threshold, ks);
  }
  return (int)cudaGetLastError();
}
