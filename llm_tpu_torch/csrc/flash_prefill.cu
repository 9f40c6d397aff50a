// K4/K4q: flash prefill (T > 8) over the head-major, unroped KV cache, for
// Hopper (sm_90a): the library's kernels and their C entry points. The
// function, the exact bf16 hi/lo arithmetic and the kernel's shape are set
// out in csrc/flash_prefill.cuh, which holds the CTA body. One kernel a
// cache type at D = 128 (flash_prefill_wgmma, whose machine code the other
// head dims leave as it was) and four more at D = 64, 80, 96 and any other
// admitted D (flash_prefill_wgmma_dim); the ALiBi instantiations
// (flash_prefill_wgmma_alibi, at D = 128 and at any other D at run time) and
// the capped ones (flash_prefill_wgmma_cap, gemma2's softcap, likewise) are
// kernels of their own, so that those keep their machine code. Past the
// narrow CTA's heads, the wide kernels (flash_prefill_wgmma_wide at one or
// two 128-dim chunks and its capped twin), whose CTA body and design are
// csrc/flash_prefill_wide.cuh.

#include <string.h>

#include "flash_prefill.cuh"
#include "flash_prefill_wide.cuh"

namespace {

// D = 128
template <bool Q8>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_wgmma(const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
                    const __grid_constant__ CUtensorMap tmc, const __grid_constant__ CUtensorMap tms,
                    const PrefillArgs a) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * FP_STAGES + 1];
  const PrefillCta c = prefill_cta<Q8>(dyn_smem, bars, a);
  if (threadIdx.x >= FP_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FP_PRODUCER_REGS));
    prefill_producer<Q8>(c, &tmk, &tmv, &tmc, &tms, a);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FP_CONSUMER_REGS));
  prefill_consumers<FP_D>(c, a);
}

// D = DT < 128, or a.D where DT = 0
template <bool Q8, int DT>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_wgmma_dim(const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        const __grid_constant__ CUtensorMap tmc,
                        const __grid_constant__ CUtensorMap tms, const PrefillArgs a) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * FP_STAGES + 1];
  const PrefillCta c = prefill_cta<Q8>(dyn_smem, bars, a);
  if (threadIdx.x >= FP_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FP_PRODUCER_REGS));
    prefill_producer<Q8>(c, &tmk, &tmv, &tmc, &tms, a);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FP_CONSUMER_REGS));
  prefill_consumers<DT>(c, a);
}

// ALiBi at D = DT: 128, or a.D where DT = 0; no rope (no cos / sin maps)
template <bool Q8, int DT>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_wgmma_alibi(const __grid_constant__ CUtensorMap tmk,
                          const __grid_constant__ CUtensorMap tmv, const PrefillArgs a,
                          const PrefillAlibi al) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * FP_STAGES + 1];
  const PrefillCta c = prefill_cta<Q8>(dyn_smem, bars, a);
  if (threadIdx.x >= FP_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FP_PRODUCER_REGS));
    prefill_producer<Q8, true>(c, &tmk, &tmv, &tmk, &tmk, a);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FP_CONSUMER_REGS));
  prefill_consumers<DT, true>(c, a, al);
}

template <bool Q8>
using PrefillKernel = decltype(&flash_prefill_wgmma<Q8>);

template <bool Q8>
int launch_prefill(const PrefillArgs& a, cudaStream_t st) {
  if (a.D < 8 || a.D > FP_D || a.D % (Q8 ? 16 : 8) || a.H % a.Hkv)
    return (int)cudaErrorInvalidValue;
  const int ki = a.D == FP_D ? 0 : a.D == 64 ? 1 : a.D == 80 ? 2 : a.D == 96 ? 3 : 4;
  const PrefillKernel<Q8> kerns[5] = {flash_prefill_wgmma<Q8>, flash_prefill_wgmma_dim<Q8, 64>,
                                      flash_prefill_wgmma_dim<Q8, 80>,
                                      flash_prefill_wgmma_dim<Q8, 96>,
                                      flash_prefill_wgmma_dim<Q8, 0>};
  // once per instantiation, outside any later graph capture
  static bool attr[5] = {false, false, false, false, false};
  if (!attr[ki]) {
    cudaFuncSetAttribute(kerns[ki], cudaFuncAttributeMaxDynamicSharedMemorySize, FP_SMEM);
    attr[ki] = true;
  }
  CUtensorMap m[4];
  if (const int rc = prefill_maps<Q8>(a, m)) return rc;
  kerns[ki]<<<prefill_grid(a), FP_THREADS, FP_SMEM, st>>>(m[0], m[1], m[2], m[3], a);
  return (int)cudaGetLastError();
}

// the ALiBi kernels: D = 128's, else the run-time D's
template <bool Q8>
int launch_prefill_alibi(const PrefillArgs& a, const PrefillAlibi& al, cudaStream_t st) {
  if (a.D < 8 || a.D > FP_D || a.D % (Q8 ? 16 : 8) || a.H % a.Hkv)
    return (int)cudaErrorInvalidValue;
  const int ki = a.D == FP_D ? 0 : 1;
  using K = decltype(&flash_prefill_wgmma_alibi<Q8, FP_D>);
  const K kerns[2] = {flash_prefill_wgmma_alibi<Q8, FP_D>, flash_prefill_wgmma_alibi<Q8, 0>};
  static bool attr[2] = {false, false};
  if (!attr[ki]) {
    cudaFuncSetAttribute(kerns[ki], cudaFuncAttributeMaxDynamicSharedMemorySize, FP_SMEM);
    attr[ki] = true;
  }
  CUtensorMap m[4];
  if (const int rc = prefill_maps<Q8>(a, m, false)) return rc;
  kerns[ki]<<<prefill_grid(a), FP_THREADS, FP_SMEM, st>>>(m[0], m[1], a, al);
  return (int)cudaGetLastError();
}

// gemma2's softcap at D = DT: 128, or a.D where DT = 0; cap = (scale /
// softcap, softcap * log2 e). Kernels of their own, so that
// flash_prefill_wgmma, _dim and _alibi keep their machine code; their
// registers split as FP_CAP_CONSUMER_REGS / FP_CAP_PRODUCER_REGS.
template <bool Q8, int DT>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_wgmma_cap(const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        const __grid_constant__ CUtensorMap tmc,
                        const __grid_constant__ CUtensorMap tms, const PrefillArgs a,
                        const float2 cap) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * FP_STAGES + 1];
  const PrefillCta c = prefill_cta<Q8>(dyn_smem, bars, a);
  if (threadIdx.x >= FP_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FP_CAP_PRODUCER_REGS));
    prefill_producer<Q8>(c, &tmk, &tmv, &tmc, &tms, a);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FP_CAP_CONSUMER_REGS));
  prefill_consumers<DT, false, true>(c, a, PrefillAlibi{nullptr, nullptr, nullptr}, cap);
}

// the capped kernels: D = 128's, else the run-time D's; softcap > 0
template <bool Q8>
int launch_prefill_cap(const PrefillArgs& a, float softcap, cudaStream_t st) {
  if (a.D < 8 || a.D > FP_D || a.D % (Q8 ? 16 : 8) || a.H % a.Hkv || !(softcap > 0.f))
    return (int)cudaErrorInvalidValue;
  const int ki = a.D == FP_D ? 0 : 1;
  using K = decltype(&flash_prefill_wgmma_cap<Q8, FP_D>);
  const K kerns[2] = {flash_prefill_wgmma_cap<Q8, FP_D>, flash_prefill_wgmma_cap<Q8, 0>};
  static bool attr[2] = {false, false};
  if (!attr[ki]) {
    cudaFuncSetAttribute(kerns[ki], cudaFuncAttributeMaxDynamicSharedMemorySize, FP_SMEM);
    attr[ki] = true;
  }
  CUtensorMap m[4];
  if (const int rc = prefill_maps<Q8>(a, m)) return rc;
  kerns[ki]<<<prefill_grid(a), FP_THREADS, FP_SMEM, st>>>(
      m[0], m[1], m[2], m[3], a, make_float2(a.scale / softcap, softcap * LOG2E));
  return (int)cudaGetLastError();
}

template <bool Q8, int NC>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_wgmma_wide(const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv,
                         const __grid_constant__ CUtensorMap tmc,
                         const __grid_constant__ CUtensorMap tms, const PrefillWideArgs w) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[3 * WideSmem<NC>::NR + 2 * WideSmem<NC>::NV];
  wide_cta<Q8, NC, false>(&tmk, &tmv, &tmc, &tms, w, make_float2(0.f, 0.f), dyn_smem, bars);
}

// the capped wide kernel, cap = (scale / softcap, softcap * log2 e)
template <bool Q8, int NC>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_wgmma_wide_cap(const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             const __grid_constant__ CUtensorMap tmc,
                             const __grid_constant__ CUtensorMap tms, const PrefillWideArgs w,
                             const float2 cap) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[3 * WideSmem<NC>::NR + 2 * WideSmem<NC>::NV];
  wide_cta<Q8, NC, true>(&tmk, &tmv, &tmc, &tms, w, cap, dyn_smem, bars);
}

// NC chunks; softcap > 0: the capped instantiation
template <bool Q8, int NC>
int launch_wide_nc(const PrefillWideArgs& w, float softcap, cudaStream_t st) {
  constexpr int smem = WideSmem<NC>::SMEM;
  static bool attr[2] = {false, false};  // once per instantiation, outside any later capture
  if (!attr[softcap > 0.f]) {
    if (softcap > 0.f)
      cudaFuncSetAttribute(flash_prefill_wgmma_wide_cap<Q8, NC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    else
      cudaFuncSetAttribute(flash_prefill_wgmma_wide<Q8, NC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr[softcap > 0.f] = true;
  }
  CUtensorMap m[4];
  if (const int rc = wide_maps<Q8>(w, m)) return rc;
  if (softcap > 0.f)
    return launch_wide_cluster(flash_prefill_wgmma_wide_cap<Q8, NC>, smem, w, st, m[0], m[1],
                               m[2], m[3], w,
                               make_float2(w.a.scale / softcap, softcap * LOG2E));
  return launch_wide_cluster(flash_prefill_wgmma_wide<Q8, NC>, smem, w, st, m[0], m[1], m[2],
                             m[3], w);
}

// one or two chunks by max(Dk, Dv); split: CTAs a KV head's row tile
// (ops/cuda_attn.py wide_prefill_plan), each every ceil(blocks / split)
template <bool Q8>
int launch_prefill_wide(PrefillWideArgs w, float softcap, cudaStream_t st) {
  if (!wide_args_ok(w, softcap)) return (int)cudaErrorInvalidValue;
  const int rc = max(w.a.D, w.Dv) <= 128 ? launch_wide_nc<Q8, 1>(w, softcap, st)
                                         : launch_wide_nc<Q8, 2>(w, softcap, st);
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace

// K4. Requirements (checked by the Python wrapper as well): D a multiple of
// 8 up to 128, H % Hkv == 0, every tensor contiguous.
extern "C" int flash_prefill_launch(const void* q, const void* qr, const void* k,
                                    const void* v, const void* cs, const void* sn,
                                    const void* bias, void* out, int T, int H, int Hkv,
                                    int S, int D, float scale, void* stream) {
  return launch_prefill<false>(
      args_of(q, qr, k, nullptr, v, nullptr, cs, sn, bias, out, T, H, Hkv, S, D, scale),
      reinterpret_cast<cudaStream_t>(stream));
}

// K4q: int8 K/V with bf16 scales [Hkv, S] (one a head row); D a multiple of 16.
extern "C" int flash_prefill_q8_launch(const void* q, const void* qr, const void* k,
                                       const void* ks, const void* v, const void* vs,
                                       const void* cs, const void* sn, const void* bias,
                                       void* out, int T, int H, int Hkv, int S, int D,
                                       float scale, void* stream) {
  return launch_prefill<true>(
      args_of(q, qr, k, ks, v, vs, cs, sn, bias, out, T, H, Hkv, S, D, scale),
      reinterpret_cast<cudaStream_t>(stream));
}

// K4 with ALiBi (K4_alibi), on rope NONE (no q_rot, cos or sin): slopes
// [H], tok_pos [T] and cell_pos [S] f32.
extern "C" int flash_prefill_alibi_launch(const void* q, const void* k, const void* v,
                                          const void* bias, const void* slopes,
                                          const void* tok_pos, const void* cell_pos, void* out,
                                          int T, int H, int Hkv, int S, int D, float scale,
                                          void* stream) {
  return launch_prefill_alibi<false>(
      args_of(q, nullptr, k, nullptr, v, nullptr, nullptr, nullptr, bias, out, T, H, Hkv, S,
              D, scale),
      PrefillAlibi{(const float*)slopes, (const float*)tok_pos, (const float*)cell_pos},
      reinterpret_cast<cudaStream_t>(stream));
}

// K4q with ALiBi (K4q_alibi).
extern "C" int flash_prefill_q8_alibi_launch(const void* q, const void* k, const void* ks,
                                             const void* v, const void* vs, const void* bias,
                                             const void* slopes, const void* tok_pos,
                                             const void* cell_pos, void* out, int T, int H,
                                             int Hkv, int S, int D, float scale, void* stream) {
  return launch_prefill_alibi<true>(
      args_of(q, nullptr, k, ks, v, vs, nullptr, nullptr, bias, out, T, H, Hkv, S, D, scale),
      PrefillAlibi{(const float*)slopes, (const float*)tok_pos, (const float*)cell_pos},
      reinterpret_cast<cudaStream_t>(stream));
}

// K4 and K4q capped (gemma2's attention logit cap, softcap > 0) at Dk = Dv
// <= 128 (K4q: a multiple of 16): the narrow kernels' capped instantiations.
extern "C" int flash_prefill_cap_launch(const void* q, const void* qr, const void* k,
                                        const void* v, const void* cs, const void* sn,
                                        const void* bias, void* out, int T, int H, int Hkv,
                                        int S, int D, float scale, float softcap, void* stream) {
  return launch_prefill_cap<false>(
      args_of(q, qr, k, nullptr, v, nullptr, cs, sn, bias, out, T, H, Hkv, S, D, scale), softcap,
      reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int flash_prefill_q8_cap_launch(const void* q, const void* qr, const void* k,
                                           const void* ks, const void* v, const void* vs,
                                           const void* cs, const void* sn, const void* bias,
                                           void* out, int T, int H, int Hkv, int S, int D,
                                           float scale, float softcap, void* stream) {
  return launch_prefill_cap<true>(
      args_of(q, qr, k, ks, v, vs, cs, sn, bias, out, T, H, Hkv, S, D, scale), softcap,
      reinterpret_cast<cudaStream_t>(stream));
}

// K4 at Dk, Dv apart, each a multiple of 8 up to 256: the wide kernel.
// softcap > 0: the capped instantiation (gemma2's attention logit cap).
// split: the CTAs of a cluster that split a KV head's cells (1 to 8, at
// most the 32-cell blocks; ops/cuda_attn.py wide_prefill_plan).
extern "C" int flash_prefill_wide_launch(const void* q, const void* qr, const void* k,
                                         const void* v, const void* cs, const void* sn,
                                         const void* bias, void* out, int T, int H, int Hkv,
                                         int S, int Dk, int Dv, float scale, float softcap,
                                         int split, void* stream) {
  const PrefillWideArgs w{
      args_of(q, qr, k, nullptr, v, nullptr, cs, sn, bias, out, T, H, Hkv, S, Dk, scale), Dv,
      0, 0, split, 0};
  return launch_prefill_wide<false>(w, softcap, reinterpret_cast<cudaStream_t>(stream));
}

// The clusters of `split` wide CTAs (one or two chunks) the card holds at
// once, or a negative CUDA error: wide_prefill_plan keeps a split whose
// clusters all fit, so that a launch takes one wave.
extern "C" int flash_prefill_wide_clusters(int q8, int chunks, int split) {
  const int smem = chunks == 1 ? WideSmem<1>::SMEM : WideSmem<2>::SMEM;
  const void* kern = q8 ? (chunks == 1 ? (const void*)flash_prefill_wgmma_wide<true, 1>
                                       : (const void*)flash_prefill_wgmma_wide<true, 2>)
                        : (chunks == 1 ? (const void*)flash_prefill_wgmma_wide<false, 1>
                                       : (const void*)flash_prefill_wgmma_wide<false, 2>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(split, 1, 1);
  cfg.blockDim = dim3(FP_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// K4q on the wide kernel: int8 rows at any multiple of 8, one scale a row.
extern "C" int flash_prefill_wide_q8_launch(const void* q, const void* qr, const void* k,
                                            const void* ks, const void* v, const void* vs,
                                            const void* cs, const void* sn, const void* bias,
                                            void* out, int T, int H, int Hkv, int S, int Dk,
                                            int Dv, float scale, float softcap, int split,
                                            void* stream) {
  const PrefillWideArgs w{
      args_of(q, qr, k, ks, v, vs, cs, sn, bias, out, T, H, Hkv, S, Dk, scale), Dv,
      Dk % 16 != 0, Dv % 16 != 0, split, 0};
  return launch_prefill_wide<true>(w, softcap, reinterpret_cast<cudaStream_t>(stream));
}
