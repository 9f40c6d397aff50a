// Where K4/K4q's time goes: flash prefill's CTA body (csrc/flash_prefill.cuh)
// with one side of its ring alone, for tools/prefill_split.py.
//
//   part 1, the producer alone: TMA of the raw blocks and of V, the hi/lo
//     planes built; the consumers only wait for each stage and release it.
//   part 2, the consumers alone: the score and P.V chains and the softmax
//     on whatever the stages hold; the producer only releases each stage,
//     with no TMA and no planes built.
//
// The full kernel is the library's (csrc/flash_prefill.cu). The wide CTA
// (csrc/flash_prefill_wide.cuh) likewise: flash_prefill_wide_part, PART 1
// its producer alone, PART 2 its consumers alone, at one or two chunks,
// capped or not.

#include "flash_prefill.cuh"
#include "flash_prefill_wide.cuh"

namespace {

// the consumers' side of the ring, doing nothing: wait for each stage and
// release it
__device__ __forceinline__ void drain_stages(const PrefillCta& c) {
  const int lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t phase = 0;
  for (int b = 0; b < c.nblk; ++b) {
    mbar_wait(c.full0 + 8 * stage, phase);
    __syncwarp();
    if (lane == 0) mbar_arrive(c.empty0 + 8 * stage);
    if (++stage == FP_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// the producer's side of the ring, doing nothing: release each stage as it
// comes free (K4's lane 0 arrives once more, in place of its expect_tx for V)
template <bool Q8>
__device__ __forceinline__ void release_stages(const PrefillCta& c) {
  const int p = threadIdx.x - FP_CONSUMERS;
  int stage = 0;
  uint32_t phase = 0;
  for (int b = 0; b < c.nblk; ++b) {
    mbar_wait(c.empty0 + 8 * stage, phase ^ 1);
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    mbar_arrive(c.full0 + 8 * stage);
    if (!Q8 && p == 0) mbar_arrive(c.full0 + 8 * stage);
    if (++stage == FP_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <bool Q8, int PART>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_part(const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
                   const __grid_constant__ CUtensorMap tmc, const __grid_constant__ CUtensorMap tms,
                   const PrefillArgs a) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * FP_STAGES + 1];
  const PrefillCta c = prefill_cta<Q8>(dyn_smem, bars, a);
  if (threadIdx.x >= FP_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FP_PRODUCER_REGS));
    if (PART == 1)
      prefill_producer<Q8>(c, &tmk, &tmv, &tmc, &tms, a);
    else
      release_stages<Q8>(c);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FP_CONSUMER_REGS));
  if (PART == 2)
    prefill_consumers<FP_D>(c, a);
  else
    drain_stages(c);
}

// the capped narrow kernel (flash_prefill_wgmma_cap at D = 128, its
// register split) with one side alone
template <bool Q8, int PART>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_part_cap(const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       const __grid_constant__ CUtensorMap tmc,
                       const __grid_constant__ CUtensorMap tms, const PrefillArgs a,
                       const float2 cap) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * FP_STAGES + 1];
  const PrefillCta c = prefill_cta<Q8>(dyn_smem, bars, a);
  if (threadIdx.x >= FP_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FP_CAP_PRODUCER_REGS));
    if (PART == 1)
      prefill_producer<Q8>(c, &tmk, &tmv, &tmc, &tms, a);
    else
      release_stages<Q8>(c);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FP_CAP_CONSUMER_REGS));
  if (PART == 2)
    prefill_consumers<FP_D, false, true>(c, a, PrefillAlibi{nullptr, nullptr, nullptr}, cap);
  else
    drain_stages(c);
}

template <bool Q8, int PART>
int launch_part_cap(const PrefillArgs& a, float softcap, cudaStream_t st) {
  static bool attr = false;  // once per instantiation, outside any later graph capture
  if (!attr) {
    cudaFuncSetAttribute(flash_prefill_part_cap<Q8, PART>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, FP_SMEM);
    attr = true;
  }
  CUtensorMap m[4];
  if (const int rc = prefill_maps<Q8>(a, m)) return rc;
  flash_prefill_part_cap<Q8, PART><<<prefill_grid(a), FP_THREADS, FP_SMEM, st>>>(
      m[0], m[1], m[2], m[3], a, make_float2(a.scale / softcap, softcap * LOG2E));
  return (int)cudaGetLastError();
}

template <bool Q8, int PART>
int launch_part(const PrefillArgs& a, cudaStream_t st) {
  static bool attr = false;  // once per instantiation, outside any later graph capture
  if (!attr) {
    cudaFuncSetAttribute(flash_prefill_part<Q8, PART>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, FP_SMEM);
    attr = true;
  }
  CUtensorMap m[4];
  if (const int rc = prefill_maps<Q8>(a, m)) return rc;
  flash_prefill_part<Q8, PART>
      <<<prefill_grid(a), FP_THREADS, FP_SMEM, st>>>(m[0], m[1], m[2], m[3], a);
  return (int)cudaGetLastError();
}

template <bool Q8, int NC, bool CAP, int PART>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_wide_part(const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        const __grid_constant__ CUtensorMap tmc,
                        const __grid_constant__ CUtensorMap tms, const PrefillWideArgs w,
                        const float2 cap) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[3 * WideSmem<NC>::NR + 2 * WideSmem<NC>::NV];
  wide_cta<Q8, NC, CAP, PART>(&tmk, &tmv, &tmc, &tms, w, cap, dyn_smem, bars);
}

template <bool Q8, int NC, bool CAP, int PART>
int launch_wide_part(const PrefillWideArgs& w, float softcap, cudaStream_t st) {
  constexpr int smem = WideSmem<NC>::SMEM;
  static bool attr = false;  // once per instantiation, outside any later graph capture
  if (!attr) {
    cudaFuncSetAttribute(flash_prefill_wide_part<Q8, NC, CAP, PART>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr = true;
  }
  CUtensorMap m[4];
  if (const int rc = wide_maps<Q8>(w, m)) return rc;
  const float2 cap = CAP ? make_float2(w.a.scale / softcap, softcap * LOG2E) : make_float2(0.f, 0.f);
  return launch_wide_cluster(flash_prefill_wide_part<Q8, NC, CAP, PART>, smem, w, st, m[0], m[1],
                             m[2], m[3], w, cap);
}

template <bool Q8, int PART>
int launch_wide_part_any(PrefillWideArgs w, float softcap, cudaStream_t st) {
  if (!wide_args_ok(w, softcap)) return (int)cudaErrorInvalidValue;
  const bool one = max(w.a.D, w.Dv) <= 128, cap = softcap > 0.f;
  const int rc = one ? (cap ? launch_wide_part<Q8, 1, true, PART>(w, softcap, st)
                            : launch_wide_part<Q8, 1, false, PART>(w, softcap, st))
                     : (cap ? launch_wide_part<Q8, 2, true, PART>(w, softcap, st)
                            : launch_wide_part<Q8, 2, false, PART>(w, softcap, st));
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace

// part 1 or 2 of K4 (q8 = 0; ks, vs null) or K4q (q8 = 1), on the library
// kernel's arguments; softcap > 0: of K4_cap / K4q_cap.
extern "C" int flash_prefill_part_launch(int part, int q8, const void* q, const void* qr,
                                         const void* k, const void* ks, const void* v,
                                         const void* vs, const void* cs, const void* sn,
                                         const void* bias, void* out, int T, int H, int Hkv,
                                         int S, float scale, float softcap, void* stream) {
  const PrefillArgs a = args_of(q, qr, k, ks, v, vs, cs, sn, bias, out, T, H, Hkv, S, FP_D, scale);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (softcap > 0.f) {
    if (part == 1)
      return q8 ? launch_part_cap<true, 1>(a, softcap, st) : launch_part_cap<false, 1>(a, softcap, st);
    if (part == 2)
      return q8 ? launch_part_cap<true, 2>(a, softcap, st) : launch_part_cap<false, 2>(a, softcap, st);
    return (int)cudaErrorInvalidValue;
  }
  if (part == 1) return q8 ? launch_part<true, 1>(a, st) : launch_part<false, 1>(a, st);
  if (part == 2) return q8 ? launch_part<true, 2>(a, st) : launch_part<false, 2>(a, st);
  return (int)cudaErrorInvalidValue;
}

// part 1 or 2 of K4w / K4qw (q8 = 1; int8 rows of 8 mod 16 bytes by
// cp.async), capped where softcap > 0, on the library kernel's arguments;
// split: the cluster (ops/cuda_attn.py wide_prefill_plan).
extern "C" int flash_prefill_wide_part_launch(int part, int q8, const void* q, const void* qr,
                                              const void* k, const void* ks, const void* v,
                                              const void* vs, const void* cs, const void* sn,
                                              const void* bias, void* out, int T, int H,
                                              int Hkv, int S, int Dk, int Dv, float scale,
                                              float softcap, int split, void* stream) {
  const PrefillWideArgs w{
      args_of(q, qr, k, ks, v, vs, cs, sn, bias, out, T, H, Hkv, S, Dk, scale), Dv,
      q8 && Dk % 16 != 0, q8 && Dv % 16 != 0, split, 0};
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (part == 1) return q8 ? launch_wide_part_any<true, 1>(w, softcap, st)
                           : launch_wide_part_any<false, 1>(w, softcap, st);
  if (part == 2) return q8 ? launch_wide_part_any<true, 2>(w, softcap, st)
                           : launch_wide_part_any<false, 2>(w, softcap, st);
  return (int)cudaErrorInvalidValue;
}
