// K1/K2's decode GEMV (B <= 16) and K7's, the same kernel on one layer of
// depth-stacked planes, for Hopper (sm_90a): the entry points. The kernel,
// and what it replaces and computes, is in qmm_decode.cuh; its own library
// keeps the other K1/K2/K5/K7 kernels' code as it was.

#include "qmm_decode.cuh"

// x bf16 [B, K], 1 <= B <= 16; qs uint8 [K/2, N] (p4) or int8 [K, N] (i8);
// scales and mins [K/gs, N] f32 or bf16 (mins may be null); y [B, N] in
// bf16 (out_bf16) or f32. cluster: the CTAs that split K for one column
// tile (ops/cuda_qmm.py::decode_plan). Requirements (checked by the Python
// wrapper): p4 -> K % 256 == 0, gs 32, zp <= 15; i8 -> K % 32 == 0, gs 16
// or 32; every pointer 16-byte aligned.
extern "C" int qmm_decode_launch(const void* x, const void* qs, const void* scales,
                                 const void* mins, void* y, int B, int K, int N, int gs,
                                 int zp, int p4, int scales_bf16, int cluster, int out_bf16,
                                 void* stream) {
  return decode_any(x, qs, scales, mins, y, B, K, N, gs, zp, p4, scales_bf16, cluster,
                    out_bf16, nullptr, 0, 0, 1, stream);
}

// K7: the same on layer *lidx (an int32 in device memory) of stacked planes:
// qs, scales and mins are the bases of [L, ...] allocations, qs_ls and s_ls
// the bytes of one layer's qs and of one layer's scales (= mins), n_layers
// the stack's depth (the tensor maps span it). The wrapper checks that
// every layer's planes start 16-byte aligned.
extern "C" int qmm_decode_stacked_launch(const void* x, const void* qs, const void* scales,
                                         const void* mins, void* y, int B, int K, int N,
                                         int gs, int zp, int p4, int scales_bf16, int cluster,
                                         int out_bf16, long long qs_ls, long long s_ls,
                                         int n_layers, const void* lidx, void* stream) {
  return decode_any(x, qs, scales, mins, y, B, K, N, gs, zp, p4, scales_bf16, cluster,
                    out_bf16, reinterpret_cast<const int*>(lidx), qs_ls, s_ls, n_layers,
                    stream);
}
