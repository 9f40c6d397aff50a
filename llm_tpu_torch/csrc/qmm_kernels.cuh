// K1/K2/K5/K7: the fused dequantize x matmul for Hopper (sm_90a): its
// kernels, shared by qmm.cu (K1/K2/K5) and qmm_stacked.cu (K7).
//
// Replaces the TPU kernels llm_tpu/ops/pallas_qmm.py::qmm_pallas ->
// _qmm_kernel_p4 / _qmm_kernel_p4_m (K1, nibble-packed planes) and
// _qmm_kernel_i8 / _qmm_kernel_i8_m (K2, int8 planes). It computes
//
//   y[b,n] = sum_k x[b,k] * (q[k,n] - zp) * s[k/gs,n]  -  sum_g xsum[b,g] * m[g,n]
//
// with x in bf16, the weight planes K-major (q [K(/2), N], s and m
// [K/gs, N] in f32 or bf16), xsum[b,g] the f32 sum of group g of row b,
// and y in f32. The mins correction is fused (the TPU path ran it as a
// separate matmul on bf16 group sums); here it stays in f32.
//
// p4 layout: within each 256-row pack tile of K, packed row t holds k=t in
// its low nibble and k=t+128 in its high nibble.
//
// Two kernels here, the decode GEMV of K1/K2/K7 apart:
//  * decode (B <= 16) of K1/K2/K7 is no longer here: qmm_decode.cuh, built
//    as its own library from qmm_decode.cu (mma.sync on exact integer
//    operands over a TMA ring, K split over a thread block cluster; see
//    there). ops/cuda_qmm.py sends every B <= 16 call without gdot to it.
//  * K5 (qmm_gdot_launch, B <= 16) is the GEMV of qmm_gemv.cuh with GDOT
//    set: it replaces llm_tpu/ops/pallas_qmm.py::_gdot_kernel (via
//    _qmm_gdot_call). Each warp streams 8-byte words of one plane row
//    across 256 columns, keeps a per-group partial of x . q on the raw
//    nibbles and takes the scale once per 32-group; the K range is split
//    over CTAs whose partial sums meet through f32 atomics (a memset
//    first), in launches of 4 rows of x. The chained kernel K6
//    (qmm_chain.cu) shares that loop.
//  * prefill (B > 16): qmm_gemm.cuh's warp-specialized wgmma GEMM over a
//    TMA ring of stages, the mins folded into the weight and each weight
//    split into bf16 hi + lo, so that the tensor cores keep the f32 group
//    arithmetic (see there).
//
// K7 (qmm_stacked_launch, qmm_gdot_stacked_launch) is K1/K2/K5 on one layer
// of depth-stacked planes ([L, ...] qs, scales and mins, one allocation
// each): it replaces the stacked mode of the same TPU kernels
// (qmm_pallas(lidx=...), pallas_qmm.py:481 and :334, whose scalar-prefetch
// index maps prepend the layer to every plane block). Here every CTA reads
// the layer index from device memory once and offsets its plane pointers by
// the per-layer strides; nothing else changes, so K7 computes exactly what
// the unstacked kernel computes on that layer, and the host never reads the
// index (no sync per launch). Its bound is the unstacked kernel's: one
// layer's planes. K7's K5 variant (qmm_gemv_stacked) wraps the same
// inlined CTA body as K5's, whose kernels keep the parameters and code
// they had before K7 existed; its prefill runs qmm_gemm.cuh's kernel,
// whose producer reads the layer index and takes it as the third
// coordinate of its tensor maps. K7's instantiations live in their own
// library (qmm_stacked.cu).

#pragma once

#include "qmm_gemm.cuh"
#include "qmm_gemv.cuh"

namespace {

// the layer of stacked planes (K7): the index in device memory and the
// bytes of one layer's qs and of one layer's scales (= mins)
struct Stack {
  const int* lidx;
  long long qs_ls, s_ls;
};

// K7: every CTA reads the layer index once and moves its plane pointers to
// that layer
__device__ __forceinline__ void to_layer(const Stack& sk, const uint8_t*& qs, const void*& sc,
                                         const void*& mn) {
  const long long l = __ldg(sk.lidx);
  qs += l * sk.qs_ls;
  sc = static_cast<const char*>(sc) + l * sk.s_ls;
  if (mn != nullptr) mn = static_cast<const char*>(mn) + l * sk.s_ls;
}

// ----------------------------------------------------------------------------
// K5's decode GEMV (GDOT): one CTA per (N tile, K range)

template <int NB, bool P4, bool SBF16, bool MINS, bool GDOT>
__device__ __forceinline__ void gemv_cta(const __nv_bfloat16* __restrict__ x, int B, int K,
                                         const uint8_t* __restrict__ qs,
                                         const void* __restrict__ sc,
                                         const void* __restrict__ mn, float* __restrict__ y,
                                         int N, int gs, int zp, int upc, int atomic_out) {
  __shared__ float xs[GV_STAGE];  // [NB][units][UK], then the warp reduction
  __shared__ float xsum[GV_STAGE / 16];
  const int n_units = P4 ? K / 64 : K / 32;
  const int u0 = blockIdx.y * upc;
  gemv_block<NB, P4, SBF16, MINS, GDOT>(Bf16Rows{x, K}, B, qs, sc, mn, y, N, gs, zp, u0,
                                        min(upc, n_units - u0), blockIdx.x * GV_TILE_N,
                                        atomic_out != 0, xs, xsum);
}

template <int NB, bool P4, bool SBF16, bool MINS, bool GDOT>
__global__ void __launch_bounds__(GV_THREADS)
qmm_gemv(const __nv_bfloat16* __restrict__ x, int B, int K,
         const uint8_t* __restrict__ qs, const void* __restrict__ sc,
         const void* __restrict__ mn, float* __restrict__ y, int N, int gs,
         int zp, int upc, int atomic_out) {
  gemv_cta<NB, P4, SBF16, MINS, GDOT>(x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out);
}

// K7's decode GEMV: the same on layer *sk.lidx of stacked planes
template <int NB, bool P4, bool SBF16, bool MINS, bool GDOT>
__global__ void __launch_bounds__(GV_THREADS)
qmm_gemv_stacked(const __nv_bfloat16* __restrict__ x, int B, int K, const uint8_t* qs,
                 const void* sc, const void* mn, float* __restrict__ y, int N, int gs,
                 int zp, int upc, int atomic_out, Stack sk) {
  to_layer(sk, qs, sc, mn);
  gemv_cta<NB, P4, SBF16, MINS, GDOT>(x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out);
}

template <int NB, bool P4, bool SBF16, bool MINS, bool GDOT, bool STACKED>
void launch_gemv_t(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, int B,
                   int K, const uint8_t* qs, const void* sc, const void* mn,
                   float* y, int N, int gs, int zp, int upc, int atomic_out, Stack sk) {
  if constexpr (STACKED)
    qmm_gemv_stacked<NB, P4, SBF16, MINS, GDOT><<<grid, GV_THREADS, 0, st>>>(
        x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out, sk);
  else
    qmm_gemv<NB, P4, SBF16, MINS, GDOT><<<grid, GV_THREADS, 0, st>>>(
        x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out);
}

template <bool P4, bool SBF16, bool MINS, bool GDOT, bool STACKED>
void launch_gemv_nb(int nb, dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
                    int B, int K, const uint8_t* qs, const void* sc,
                    const void* mn, float* y, int N, int gs, int zp, int upc,
                    int atomic_out, Stack sk) {
  if (nb == 1)
    launch_gemv_t<1, P4, SBF16, MINS, GDOT, STACKED>(grid, st, x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out, sk);
  else if (nb == 2)
    launch_gemv_t<2, P4, SBF16, MINS, GDOT, STACKED>(grid, st, x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out, sk);
  else
    launch_gemv_t<4, P4, SBF16, MINS, GDOT, STACKED>(grid, st, x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out, sk);
}

// returns 0, or the prefill GEMM's host-side error code; K1/K2 at B <= 16
// run qmm_decode.cu's kernel and are refused here
template <bool P4, bool SBF16, bool MINS, bool GDOT, bool STACKED>
int run(cudaStream_t st, const __nv_bfloat16* x, int B, int K,
        const uint8_t* qs, const void* sc, const void* mn, float* y, int N,
        int gs, int zp, Stack sk, int split, int n_layers) {
  if constexpr (!GDOT) {
    if (B <= 16) return (int)cudaErrorInvalidValue;
    return launch_gemm<P4, SBF16, MINS>(st, x, B, K, qs, sc, mn, y, N, gs, zp, split,
                                        STACKED ? sk.lidx : nullptr, sk.qs_ls, sk.s_ls,
                                        n_layers);
  } else {
    // about two CTAs of 8 warps on every SM
    const GemvSplit sp = gemv_split(K, N, P4, 2 * sm_count());
    const int atomic_out = sp.ksplit > 1;
    if (atomic_out) cudaMemsetAsync(y, 0, sizeof(float) * (size_t)B * N, st);
    dim3 grid(sp.ntiles, sp.ksplit);
    for (int b0 = 0; b0 < B; b0 += GV_MAX_NB) {
      const int nb = min(GV_MAX_NB, B - b0);
      const int nbt = nb == 1 ? 1 : (nb == 2 ? 2 : 4);
      launch_gemv_nb<P4, SBF16, MINS, GDOT, STACKED>(nbt, grid, st, x + (size_t)b0 * K, nb, K,
                                            qs, sc, mn, y + (size_t)b0 * N, N, gs, zp,
                                            sp.upc, atomic_out, sk);
    }
    return 0;
  }
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
  int rc = 0;
#define QMM_RUN(P, S, M) rc = run<P, S, M, false, STACKED>(st, xb, B, K, q, scales, mins, yf, N, gs, zp, sk, split, n_layers)
  if (p4) {
    if (scales_bf16) { if (has_m) QMM_RUN(true, true, true); else QMM_RUN(true, true, false); }
    else { if (has_m) QMM_RUN(true, false, true); else QMM_RUN(true, false, false); }
  } else {
    if (scales_bf16) { if (has_m) QMM_RUN(false, true, true); else QMM_RUN(false, true, false); }
    else { if (has_m) QMM_RUN(false, false, true); else QMM_RUN(false, false, false); }
  }
#undef QMM_RUN
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// K5 (K7's K5 variant with STACKED)
template <bool STACKED>
int gdot_any(const void* x, const void* qs, const void* scales, const void* mins,
             void* y, int B, int K, int N, int zp, int scales_bf16, Stack sk,
             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const uint8_t* q = reinterpret_cast<const uint8_t*>(qs);
  float* yf = reinterpret_cast<float*>(y);
  const bool has_m = mins != nullptr;
#define GDOT_RUN(S, M) run<true, S, M, true, STACKED>(st, xb, B, K, q, scales, mins, yf, N, 32, zp, sk, 1, 1)
  if (scales_bf16) { if (has_m) GDOT_RUN(true, true); else GDOT_RUN(true, false); }
  else { if (has_m) GDOT_RUN(false, true); else GDOT_RUN(false, false); }
#undef GDOT_RUN
  return (int)cudaGetLastError();
}

}  // namespace
