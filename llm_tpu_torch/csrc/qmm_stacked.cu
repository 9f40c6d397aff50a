// K7 for Hopper (sm_90a) at B > 16: K1/K2 on one layer of depth-stacked
// planes, the layer index read on the card. Replaces the stacked mode of the
// TPU kernels (llm_tpu/ops/pallas_qmm.py::qmm_pallas(lidx=...), :481). The
// kernel is qmm_gemm.cuh's (prefill, reading the layer index on the card);
// its own library keeps K1/K2's code as it was and builds in parallel. K7
// at B <= 16, and its K5 variant (:334), are qmm_decode.cu's
// qmm_decode_stacked_launch and qmm_gdot_decode_stacked_launch.

#include "qmm_kernels.cuh"

// K7: qmm_launch (B > 16) on layer *lidx (an int32 in device
// memory) of stacked planes: qs, scales and mins are the bases of [L, ...]
// allocations, qs_ls and s_ls the bytes of one layer's qs and of one
// layer's scales (= mins), n_layers the stack's depth (the prefill GEMM's
// tensor maps span it). The wrapper checks that every layer's planes
// start 16-byte aligned.
extern "C" int qmm_stacked_launch(const void* x, const void* qs, const void* scales,
                                  const void* mins, void* y, int B, int K, int N,
                                  int gs, int zp, int p4, int scales_bf16, int split,
                                  long long qs_ls, long long s_ls, int n_layers,
                                  const void* lidx, void* stream) {
  return qmm_any<true>(x, qs, scales, mins, y, B, K, N, gs, zp, p4, scales_bf16, split,
                       Stack{reinterpret_cast<const int*>(lidx), qs_ls, s_ls}, n_layers,
                       stream);
}

