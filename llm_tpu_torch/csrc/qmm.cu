// K1/K2 (fused dequantize x matmul) at B > 16 for Hopper (sm_90a): the
// entry point. The kernels, and what they replace and compute, are in
// qmm_kernels.cuh; K7, the same kernels on stacked planes, is built from
// qmm_stacked.cu; K1/K2/K5/K7 at B <= 16 from qmm_decode.cu.

#include "qmm_kernels.cuh"

// x bf16 [B, K]; qs uint8 [K/2, N] (p4) or int8 [K, N] (i8); scales and
// mins [K/gs, N] f32 or bf16 (mins may be null); y f32 [B, N].
// Requirements (checked by the Python wrapper): p4 -> K % 256 == 0, gs 16, 32
// or 256; i8 -> K % 32 == 0, gs 8, 16 or 32; B > 16 and K % 64 == 0 (B <= 16 is
// refused: qmm_decode.cu). split: the prefill GEMM's K ranges per tile
// (ops/cuda_qmm.py::gemm_split).
extern "C" int qmm_launch(const void* x, const void* qs, const void* scales,
                          const void* mins, void* y, int B, int K, int N,
                          int gs, int zp, int p4, int scales_bf16, int split,
                          void* stream) {
  return qmm_any<false>(x, qs, scales, mins, y, B, K, N, gs, zp, p4, scales_bf16, split,
                        Stack{nullptr, 0, 0}, 1, stream);
}

