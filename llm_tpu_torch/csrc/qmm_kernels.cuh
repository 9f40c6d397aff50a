// K1/K2/K7 at B > 16: the fused dequantize x matmul's prefill launch for
// Hopper (sm_90a), shared by qmm.cu (K1/K2) and qmm_stacked.cu (K7).
//
// Replaces the TPU kernels llm_tpu/ops/pallas_qmm.py::qmm_pallas ->
// _qmm_kernel_p4 / _qmm_kernel_p4_m (K1, nibble-packed planes) and
// _qmm_kernel_i8 / _qmm_kernel_i8_m (K2, int8 planes) at B > 16. It computes
//
//   y[b,n] = sum_k x[b,k] * (q[k,n] - zp) * s[k/gs,n]  -  sum_g xsum[b,g] * m[g,n]
//
// with x in bf16, the weight planes K-major (q [K(/2), N], s and m
// [K/gs, N] in f32 or bf16), xsum[b,g] the f32 sum of group g of row b,
// and y in f32, by qmm_gemm.cuh's warp-specialized wgmma GEMM over a TMA
// ring of stages, the mins folded into the weight and each weight split
// into bf16 hi + lo, so that the tensor cores keep the f32 group
// arithmetic (see there).
//
// p4 layout: within each 256-row pack tile of K, packed row t holds k=t in
// its low nibble and k=t+128 in its high nibble.
//
// Decode (B <= 16) is not here: K1/K2/K7 and K5 (with its stacked form,
// K7's K5 variant) run qmm_decode.cuh's kernels, built as their own library
// from qmm_decode.cu (mma.sync on exact integer operands over a TMA ring, K
// split over a thread block cluster; see there). ops/cuda_qmm.py sends every
// B <= 16 call there.
//
// K7 (qmm_stacked_launch) is K1/K2 on one layer of depth-stacked planes
// ([L, ...] qs, scales and mins, one allocation each): it replaces the
// stacked mode of the same TPU kernels (qmm_pallas(lidx=...),
// pallas_qmm.py:481). The GEMM's producer reads the layer index from device
// memory and takes it as the third coordinate of its tensor maps; nothing
// else changes, so K7 computes exactly what the unstacked kernel computes on
// that layer, and the host never reads the index (no sync per launch). Its
// bound is the unstacked kernel's: one layer's planes. K7's instantiations
// live in their own library (qmm_stacked.cu).

#pragma once

#include "qmm_gemm.cuh"

namespace {

// the layer of stacked planes (K7): the index in device memory and the
// bytes of one layer's qs and of one layer's scales (= mins)
struct Stack {
  const int* lidx;
  long long qs_ls, s_ls;
};

// returns 0, or the prefill GEMM's host-side error code; B <= 16 runs
// qmm_decode.cu's kernels and is refused here; G16: p4 planes at group size
// 16; GX: p4 planes at 256 or i8 planes at 8
template <bool P4, bool SBF16, bool MINS, bool STACKED, bool G16, int GX>
int run(cudaStream_t st, const __nv_bfloat16* x, int B, int K,
        const uint8_t* qs, const void* sc, const void* mn, float* y, int N,
        int gs, int zp, Stack sk, int split, int n_layers) {
  if (B <= 16) return (int)cudaErrorInvalidValue;
  return launch_gemm<P4, SBF16, MINS, G16, GX>(st, x, B, K, qs, sc, mn, y, N, gs, zp, split,
                                               STACKED ? sk.lidx : nullptr, sk.qs_ls, sk.s_ls,
                                               n_layers);
}

// K1/K2 (K7 with STACKED) at B > 16 on any planes: the launch the entry points share
template <bool STACKED>
int qmm_any(const void* x, const void* qs, const void* scales, const void* mins,
            void* y, int B, int K, int N, int gs, int zp, int p4, int scales_bf16,
            int split, Stack sk, int n_layers, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const uint8_t* q = reinterpret_cast<const uint8_t*>(qs);
  float* yf = reinterpret_cast<float*>(y);
  const bool has_m = mins != nullptr;
  if ((p4 && gs != 32 && gs != 16 && gs != 256) || (!p4 && gs != 32 && gs != 16 && gs != 8))
    return (int)cudaErrorInvalidValue;
  int rc = 0;
#define QMM_RUN(P, S, M, G, X)                                                               \
  rc = run<P, S, M, STACKED, G, X>(st, xb, B, K, q, scales, mins, yf, N, gs, zp, sk, split, \
                                   n_layers)
#define QMM_SM(P, G, X)                                                                      \
  if (scales_bf16) {                                                                         \
    if (has_m) QMM_RUN(P, true, true, G, X); else QMM_RUN(P, true, false, G, X);             \
  } else {                                                                                   \
    if (has_m) QMM_RUN(P, false, true, G, X); else QMM_RUN(P, false, false, G, X);           \
  }
  if (p4 && gs == 16) {
    QMM_SM(true, true, 0)
  } else if (p4 && gs == 256) {
    QMM_SM(true, false, 256)
  } else if (p4) {
    QMM_SM(true, false, 0)
  } else if (gs == 8) {
    QMM_SM(false, false, 8)
  } else {
    QMM_SM(false, false, 0)
  }
#undef QMM_SM
#undef QMM_RUN
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace
