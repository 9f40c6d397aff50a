// K1/K2's decode GEMV (B <= 16), K5, its group-factored form, and K7, either
// of them on one layer of depth-stacked planes, for Hopper (sm_90a): the
// entry points. The kernels, and what they replace and compute, are in
// qmm_decode.cuh; their own library keeps the prefill GEMM's code as it
// was.

#include "qmm_decode.cuh"

namespace {

// ----------------------------------------------------------------------------
// host side: the tensor maps (hopper.cuh's make_map) and the cluster launch

// the decode GEMV on planes qs/sc/mn (K7: layer *lidx of n_layers stacked
// ones, qs_ls / s_ls bytes apart), K split over a cluster of `cluster` CTAs
// (the wrapper's decode_plan); G16: p4 planes at group size 16; GX: p4
// planes at group size 256 or i8 planes at group size 8. Returns 0 or an
// error code; the launch's own error is returned too.
template <bool P4, bool SBF16, bool MINS, int NB8, bool GDOT, bool G16, int GX>
int launch_decode_t(cudaStream_t st, const __nv_bfloat16* x, int B, int K, const uint8_t* qs,
                    const void* sc, const void* mn, void* y, int N, int gs, int zp, int cluster,
                    int out_bf16, const int* lidx, long long qs_ls, long long s_ls,
                    int n_layers) {
  using L = DecodeSmem<P4, SBF16, MINS, G16, GX>;
  auto kern = qmm_decode<P4, SBF16, MINS, NB8>;
  if constexpr (GX == 256) kern = GDOT ? qmm_decode_gdot_g256<SBF16, MINS, NB8>
                                       : qmm_decode_g256<SBF16, MINS, NB8>;
  else if constexpr (GX == 8) kern = qmm_decode_g8<SBF16, MINS, NB8>;
  else if constexpr (G16) kern = GDOT ? qmm_decode_gdot_g16<SBF16, MINS, NB8>
                                      : qmm_decode_g16<SBF16, MINS, NB8>;
  else if constexpr (GDOT) kern = qmm_decode_gdot<SBF16, MINS, NB8>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr = true;
  }
  const int R = P4 ? K / 2 : K, G = K / gs, units = (K + DV_UNIT_K - 1) / DV_UNIT_K;
  if (cluster < 1 || cluster > DV_MAX_CLUSTER || cluster > units) return (int)cudaErrorInvalidValue;
  int upr = (units + cluster - 1) / cluster;
  // K5 at group size 256: every CTA takes whole groups, pairs of stages
  // (its last CTAs may take none)
  if (GDOT && GX == 256) upr += upr & 1;
  const long long L_ = n_layers < 1 ? 1 : n_layers;
  DecodeArgs a{qs, sc, mn, y, lidx, lidx ? qs_ls : (long long)R * N,
               lidx ? s_ls : (long long)G * N * L::ES, B, K, N, gs, zp, upr, N % 16 == 0,
               out_bf16};

  CUtensorMap mx, mw, ms, mm;
  memset(&mw, 0, sizeof(mw));
  memset(&ms, 0, sizeof(ms));
  memset(&mm, 0, sizeof(mm));
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)B};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)(8 * NB8)};
    if (int rc = make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  if (a.tma_w) {
    const cuuint64_t wd[3] = {(cuuint64_t)N, (cuuint64_t)R, (cuuint64_t)L_};
    const cuuint64_t wst[2] = {(cuuint64_t)N, (cuuint64_t)a.qs_ls};
    const cuuint32_t wb[3] = {DV_TILE_N, (cuuint32_t)L::W_ROWS, 1};
    if (int rc = make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, qs, wd, wst, wb,
                                 CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
    const CUtensorMapDataType sdt =
        SBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const cuuint64_t sd[3] = {(cuuint64_t)N, (cuuint64_t)G, (cuuint64_t)L_};
    const cuuint64_t sst[2] = {(cuuint64_t)N * L::ES, (cuuint64_t)a.s_ls};
    const cuuint32_t sb[3] = {DV_TILE_N,
                              (cuuint32_t)(GX == 256 ? 1 : P4 ? P4Groups<G16>::CG
                                                              : DV_UNIT_K / gs), 1};
    if (int rc = make_map(&ms, sdt, 3, sc, sd, sst, sb, CU_TENSOR_MAP_SWIZZLE_NONE))
      return rc;
    if (MINS)
      if (int rc = make_map(&mm, sdt, 3, mn, sd, sst, sb, CU_TENSOR_MAP_SWIZZLE_NONE))
        return rc;
  }
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(cluster, (N + DV_TILE_N - 1) / DV_TILE_N, 1);
  cfg.blockDim = dim3(DV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, mx, mw, ms, mm, a);
}

template <bool P4, bool SBF16, bool MINS, bool GDOT, bool G16, int GX>
int launch_decode_nb(cudaStream_t st, const __nv_bfloat16* x, int B, int K, const uint8_t* qs,
                     const void* sc, const void* mn, void* y, int N, int gs, int zp,
                     int cluster, int out_bf16, const int* lidx, long long qs_ls, long long s_ls,
                     int n_layers) {
  if (B <= 8)
    return launch_decode_t<P4, SBF16, MINS, 1, GDOT, G16, GX>(st, x, B, K, qs, sc, mn, y, N, gs,
                                                             zp, cluster, out_bf16, lidx, qs_ls,
                                                             s_ls, n_layers);
  return launch_decode_t<P4, SBF16, MINS, 2, GDOT, G16, GX>(st, x, B, K, qs, sc, mn, y, N, gs,
                                                           zp, cluster, out_bf16, lidx, qs_ls,
                                                           s_ls, n_layers);
}

// K1/K2 (K7 with lidx) at B <= 16 on any planes, or K5 (gdot, p4 planes):
// the launch every entry point shares
inline int decode_any(const void* x, const void* qs, const void* scales, const void* mins,
                      void* y, int B, int K, int N, int gs, int zp, int p4, int scales_bf16,
                      int cluster, int out_bf16, const int* lidx, long long qs_ls,
                      long long s_ls, int n_layers, int gdot, void* stream) {
  if (B < 1 || B > DV_MAX_B || (gdot && (!p4 || (mins != nullptr && zp != 0))) ||
      (p4 && gs != 32 && gs != 16 && gs != 256) || (!p4 && gs != 32 && gs != 16 && gs != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const uint8_t* q = reinterpret_cast<const uint8_t*>(qs);
  const bool has_m = mins != nullptr, g16 = p4 && gs == 16, g256 = p4 && gs == 256;
  int rc = 0;
#define DV_RUN(P, S, M, G, W, X)                                                               \
  rc = launch_decode_nb<P, S, M, G, W, X>(st, xb, B, K, q, scales, mins, y, N, gs, zp,       \
                                          cluster, out_bf16, lidx, qs_ls, s_ls, n_layers)
#define DV_SM(P, G, W, X)                                                                  \
  if (scales_bf16) {                                                                       \
    if (has_m) DV_RUN(P, true, true, G, W, X); else DV_RUN(P, true, false, G, W, X);       \
  } else {                                                                                 \
    if (has_m) DV_RUN(P, false, true, G, W, X); else DV_RUN(P, false, false, G, W, X);     \
  }
  if (gdot) {
    if (g16) { DV_SM(true, true, true, 0) }
    else if (g256) { DV_SM(true, true, false, 256) }
    else { DV_SM(true, true, false, 0) }
  } else if (p4) {
    if (g16) { DV_SM(true, false, true, 0) }
    else if (g256) { DV_SM(true, false, false, 256) }
    else { DV_SM(true, false, false, 0) }
  } else if (gs == 8) {
    DV_SM(false, false, false, 8)
  } else {
    DV_SM(false, false, false, 0)
  }
#undef DV_SM
#undef DV_RUN
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace

// x bf16 [B, K], 1 <= B <= 16; qs uint8 [K/2, N] (p4) or int8 [K, N] (i8);
// scales and mins [K/gs, N] f32 or bf16 (mins may be null); y [B, N] in
// bf16 (out_bf16) or f32. cluster: the CTAs that split K for one column
// tile (ops/cuda_qmm.py::decode_plan). Requirements (checked by the Python
// wrapper): p4 -> K % 256 == 0, gs 16, 32 or 256, zp <= 15; i8 -> K % 32
// == 0, gs 8, 16 or 32; every pointer 16-byte aligned.
extern "C" int qmm_decode_launch(const void* x, const void* qs, const void* scales,
                                 const void* mins, void* y, int B, int K, int N, int gs,
                                 int zp, int p4, int scales_bf16, int cluster, int out_bf16,
                                 void* stream) {
  return decode_any(x, qs, scales, mins, y, B, K, N, gs, zp, p4, scales_bf16, cluster,
                    out_bf16, nullptr, 0, 0, 1, 0, stream);
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
                    out_bf16, reinterpret_cast<const int*>(lidx), qs_ls, s_ls, n_layers, 0,
                    stream);
}

// K5: the group-factored decode GEMV on p4 planes (gs 16, 32 or 256, K % 256 ==
// 0, zp <= 15, no zero point beside mins), otherwise as qmm_decode_launch
extern "C" int qmm_gdot_decode_launch(const void* x, const void* qs, const void* scales,
                                      const void* mins, void* y, int B, int K, int N, int gs,
                                      int zp, int scales_bf16, int cluster, int out_bf16,
                                      void* stream) {
  return decode_any(x, qs, scales, mins, y, B, K, N, gs, zp, 1, scales_bf16, cluster,
                    out_bf16, nullptr, 0, 0, 1, 1, stream);
}

// K7's K5 variant: K5 on layer *lidx of stacked planes, as
// qmm_decode_stacked_launch
extern "C" int qmm_gdot_decode_stacked_launch(const void* x, const void* qs, const void* scales,
                                              const void* mins, void* y, int B, int K, int N,
                                              int gs, int zp, int scales_bf16, int cluster,
                                              int out_bf16, long long qs_ls, long long s_ls,
                                              int n_layers, const void* lidx, void* stream) {
  return decode_any(x, qs, scales, mins, y, B, K, N, gs, zp, 1, scales_bf16, cluster,
                    out_bf16, reinterpret_cast<const int*>(lidx), qs_ls, s_ls, n_layers, 1,
                    stream);
}
