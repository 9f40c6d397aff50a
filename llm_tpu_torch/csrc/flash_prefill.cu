// K4/K4q: flash prefill (T > 8) over the head-major, unroped KV cache, for
// Hopper (sm_90a): the library's kernels and their C entry points. The
// function, the exact bf16 hi/lo arithmetic and the kernel's shape are set
// out in csrc/flash_prefill.cuh, which holds the CTA body. One kernel a
// cache type at D = 128 (flash_prefill_wgmma, whose machine code the other
// head dims leave as it was) and four more at D = 64, 80, 96 and any other
// admitted D (flash_prefill_wgmma_dim).

#include "flash_prefill.cuh"

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
