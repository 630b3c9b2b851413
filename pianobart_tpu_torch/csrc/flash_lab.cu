// The kernel lab's flash-forward experiments for Hopper (sm_90a), bound to
// PyTorch through ctypes.
//
// Replaces the two Pallas TPU kernels of scripts/kernel_lab.py, both K1's
// forward with one design choice changed:
//   L1  _kt_fwd_kernel (launched by kt_fwd): K read pre-transposed, as the
//       (B, H*D, Skv) array the caller built with Skv contiguous.  Options
//       upcast (f32 operands) and exp2 (exp2-domain softmax).
//   L2  hl_fwd's kernel: K1's layout, always with f32 operands; option exp2.
//
// Each is K1's own kernel (flash_fwd_bf16.cuh, flash_fwd_wgmma_kernel<KT,
// SPLIT_P, 128>; K1 is <false, false, D>) with the option changed, so that
// the lab measures the option and nothing else (at the lab's head width,
// LAB_D = 128):
//   L2                   <false, true>   P split into two bf16 products
//   L1, upcast           <true, true>    K^T through the transpose bit, P split
//   L1, no upcast        <true, false>   K^T through the transpose bit
// and the softmax's units at run time (SoftmaxUnits): under exp2 the lse is
// m*c + log2 l (a fully masked row keeps the -1e30 sentinel), and without
// upcast Q is scaled to bf16(q * bf16(log2 e)) in shared memory with c = 1,
// as the reference lab's bf16 arithmetic does; otherwise c = log2 e, as in
// K1, whose softmax is exp2-domain already (the settings differ only in the
// lse's unit and in c).  Contract as K1's, bf16 only, the lse in log2 units
// under exp2.  Sq and Skv are multiples of 64 (the callers' rule); K1's
// 128-row tiles make S = 320 ragged at both ends: rows past Sq are not
// stored, keys past Skv arrive as TMA's zeros and take p = 0.
//
// Bound at the lab shape (B=32, S=1024, H=8, D=128, the smoke run's pad
// tail): 4*B*H*S^2*D FLOPs over the kept pairs, 0.1381 ms at 989 TFLOP/s
// bf16, against q/k/v/o bytes at a fifth of that: bound by operations.  The
// bound is the function's work and the same for every variant; SPLIT_P's
// third product and L1's transpose of K are the variants' own extra cost.
#include "flash_common.cuh"
#include "flash_fwd_bf16.cuh"
#include "hopper.cuh"

namespace {

using namespace pbt;

constexpr int LAB_D = 128;              // the lab's head width

// The maps of q, v and the mask, K's built by the caller into tk; returns
// 0, or TMAP_ERROR + the CUresult of a map the driver refused.
int qv_mask_maps(EncodeTiled enc, CUtensorMap* tq, CUtensorMap* tv, CUtensorMap* tm,
                 const void* q, const void* v, const void* mask, int B, int Sq, int Skv, int H,
                 long long qsb, long long qss, long long qsh,
                 long long vsb, long long vss, long long vsh) {
  CUresult r = qkv_map(enc, tq, q, B, Sq, H, qsb, qss, qsh, K1_BM, LAB_D);
  if (r == CUDA_SUCCESS) r = qkv_map(enc, tv, v, B, Skv, H, vsb, vss, vsh, K1_BN, LAB_D);
  if (r == CUDA_SUCCESS) r = mask_map(enc, tm, mask, B, Skv, K1_BN);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERROR + (int)r;
}

}  // namespace

// L1.  kt is K^T, (B, H*D, Skv) with Skv contiguous; its strides are given
// as (batch, head = D rows, d row).  q and v strides in elements for their
// (B, S, H) axes, D contiguous.  upcast: split P (f32 P.V); exp2 without
// upcast: the bf16 log2(e) scaling of q.  Returns cudaGetLastError(), or
// 1000 + the CUresult of a tensor map the driver refused (1000 alone where
// the driver offers no encoder).
extern "C" int pbt_kt_fwd(const void* q, const void* kt, const void* v,
                          const void* mask, void* o, void* lse,
                          int B, int Sq, int Skv, int H, int causal, int upcast,
                          int exp2,
                          long long qsb, long long qss, long long qsh,
                          long long ktsb, long long ktsh, long long ktsd,
                          long long vsb, long long vss, long long vsh,
                          void* stream) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return TMAP_ERROR;
  CUtensorMap tq, tk, tv, tm;
  int rc = qv_mask_maps(enc, &tq, &tv, &tm, q, v, mask, B, Sq, Skv, H, qsb, qss, qsh,
                        vsb, vss, vsh);
  if (rc) return rc;
  const CUresult r = kt_map(enc, &tk, kt, B, Skv, H, ktsb, ktsh, ktsd, LAB_D);
  if (r != CUDA_SUCCESS) return TMAP_ERROR + (int)r;
  const int bf16_scale = exp2 && !upcast;
  const SoftmaxUnits u = {bf16_scale ? 1.f : LOG2E, exp2, bf16_scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return upcast ? launch_fwd_bf16<true, true>(tq, tk, tv, tm, o, lse, B, Sq, Skv, H, causal, u, st)
                : launch_fwd_bf16<true, false>(tq, tk, tv, tm, o, lse, B, Sq, Skv, H, causal, u,
                                               st);
}

// L2.  K1's layout and strides (batch, row, head for q, k, v); P.V always
// split (f32 operands).  Returns as pbt_kt_fwd.
extern "C" int pbt_hl_fwd(const void* q, const void* k, const void* v,
                          const void* mask, void* o, void* lse,
                          int B, int Sq, int Skv, int H, int causal, int exp2,
                          long long qsb, long long qss, long long qsh,
                          long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh,
                          void* stream) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return TMAP_ERROR;
  CUtensorMap tq, tk, tv, tm;
  int rc = qv_mask_maps(enc, &tq, &tv, &tm, q, v, mask, B, Sq, Skv, H, qsb, qss, qsh,
                        vsb, vss, vsh);
  if (rc) return rc;
  const CUresult r = qkv_map(enc, &tk, k, B, Skv, H, ksb, kss, ksh, K1_BN, LAB_D);
  if (r != CUDA_SUCCESS) return TMAP_ERROR + (int)r;
  const SoftmaxUnits u = {LOG2E, exp2, 0};
  return launch_fwd_bf16<false, true>(tq, tk, tv, tm, o, lse, B, Sq, Skv, H, causal, u,
                                      reinterpret_cast<cudaStream_t>(stream));
}
