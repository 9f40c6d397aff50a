// K4/K4q: flash prefill (T > 8) over the head-major, unroped KV cache, for
// Hopper (sm_90a): the library's kernels and their C entry points. The
// function, the exact bf16 hi/lo arithmetic and the kernel's shape are set
// out in csrc/flash_prefill.cuh, which holds the CTA body. One kernel a
// cache type at D = 128 (flash_prefill_wgmma, whose machine code the other
// head dims leave as it was) and four more at D = 64, 80, 96 and any other
// admitted D (flash_prefill_wgmma_dim); the ALiBi instantiations
// (flash_prefill_wgmma_alibi, at D = 128 and at any other D at run time) are
// kernels of their own, so that those keep their machine code.

#include <string.h>

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


// ----------------------------------------------------------------------------
// The wide kernel: Dk and Dv apart, each a multiple of 8 up to 256, and
// K4q's int8 rows at any multiple of 8 (rows whose pitch is no multiple of
// 16 bytes come by 8-byte cp.async from the producer's lanes, not TMA). A
// CTA owns 64 query rows (grid ceil(T*G/64) x Hkv) and the two consumer
// warpgroups split the head dims, not the rows: warpgroup c holds q, q_rot
// of dims 128c..128c+127 (64 registers, as in the narrow kernel) and O's
// dims 128c.. (64), so O at Dv = 256 needs no more registers a thread than
// at 128. The ring is two stages, one a chunk: the producer converts S
// block b's dims 128c.. into stage c (the narrow kernel's planes, its
// raw block and convert_block, at TMA x-coordinate 128c). Per block each
// warpgroup runs its score chain on its stage, the two partial scores meet
// in shared memory (warpgroup 1's into warpgroup 0, the sum back: 16 KB,
// two named barriers), both run the same softmax on the same sums, and
// each runs P.V against its stage's V. gemma2's attention softcap is the
// SOFTCAP instantiation of the same CTA, a __global__ of its own
// (flash_prefill_wgmma_wide_cap, so that the uncapped kernel keeps its name
// and machine code): its scale-and-bias step is cap log2e * tanhf(s *
// scale / cap) + max(bias, -1e30) log2e, in place of the one fmaf. Shared memory: 2 x 80 KB stages, the
// 48 KB raw block and the 16 KB exchange: 225 KB. Past Dk or Dv, TMA and
// cp.async fill zeros, which add nothing.

constexpr int FW_ROWS = 64;                             // query rows a CTA
constexpr int FW_XCH = FP_RAW + FP_RAW_BYTES;           // [32 scores][128 threads] f32
constexpr int FW_SMEM = FW_XCH + 32 * 128 * 4 + 1024;   // + 1024 to align
static_assert(FW_SMEM <= 232448, "227 KB of shared memory a CTA");

struct PrefillWideArgs {
  PrefillArgs a;  // a.D is Dk
  int Dv;
  int kcp, vcp;   // K4q: K's (V's) int8 rows by cp.async
};

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// the raw block of item (sb, chunk c): lane 0's TMA and, for K4q rows that
// TMA cannot take, every lane's 8-byte pieces; every lane arrives on bar
// once its pieces land where any are needed
template <bool Q8>
__device__ __forceinline__ void load_raw_wide(const PrefillWideArgs& w, uint32_t raw,
                                              uint32_t bar, const CUtensorMap* tmk,
                                              const CUtensorMap* tmv, const CUtensorMap* tmc,
                                              const CUtensorMap* tms, int sb, int c, int h,
                                              int p) {
  const PrefillArgs& a = w.a;
  const int x0 = 128 * c;
  if (p == 0) {
    const int kb = Q8 ? FP_SB * FP_D : FP_PLANE;
    mbar_expect_tx(bar, 2 * FP_PLANE + (w.kcp ? 0 : kb) + (Q8 && !w.vcp ? kb : 0));
    if (!w.kcp) tma_3d(raw, tmk, bar, x0, sb, h);
    if (Q8 && !w.vcp) tma_3d(raw + FP_RAW_V8, tmv, bar, x0, sb, h);
    tma_2d(raw + FP_RAW_C, tmc, bar, x0, sb);
    tma_2d(raw + FP_RAW_S, tms, bar, x0, sb);
  }
  if (Q8 && (w.kcp || w.vcp)) {
#pragma unroll 1
    for (int v = 0; v < 2; ++v) {
      if (!(v ? w.vcp : w.kcp)) continue;
      const int D = v ? w.Dv : a.D;
      const int8_t* base = reinterpret_cast<const int8_t*>(v ? a.v : a.k);
      for (int pi = p; pi < FP_SB * 16; pi += 128) {
        const int cell = pi >> 4, j = pi & 15, s = sb + cell, d = x0 + 8 * j;
        const bool ok = s < a.S && d < D;
        cp_async8(raw + (v ? FP_RAW_V8 : 0) + cell * FP_D + 8 * j,
                  base + (ok ? ((size_t)h * a.S + s) * D + d : 0), ok ? 8 : 0);
      }
    }
    cp_async_arrive(bar);
  }
}

// the producer warpgroup: items (b, c), block b's chunk c into stage c
template <bool Q8>
__device__ __forceinline__ void wide_producer(const PrefillCta& cta, const CUtensorMap* tmk,
                                              const CUtensorMap* tmv, const CUtensorMap* tmc,
                                              const CUtensorMap* tms, const PrefillWideArgs& w) {
  const PrefillArgs& a = w.a;
  const int h = cta.h, nblk = cta.nblk;
  const int p = threadIdx.x - FP_CONSUMERS;
  const uint32_t raw = cta.smem_a + FP_RAW;
  load_raw_wide<Q8>(w, raw, cta.rawbar, tmk, tmv, tmc, tms, 0, 0, h, p);
  for (int b = 0; b < nblk; ++b) {
    float ksc[8], vsc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = b * FP_SB + (p >> 4) + 8 * j;
      ksc[j] = Q8 && s < a.S ? __bfloat162float(a.ks[(size_t)h * a.S + s]) : 0.f;
      vsc[j] = Q8 && s < a.S ? __bfloat162float(a.vs[(size_t)h * a.S + s]) : 0.f;
    }
#pragma unroll 1
    for (int c = 0; c < 2; ++c) {
      const int it = 2 * b + c;
      mbar_wait(cta.empty0 + 8 * c, (b & 1) ^ 1);
      const uint32_t full = cta.full0 + 8 * c;
      if (!Q8 && p == 0) {
        const uint32_t vdst = cta.smem_a + c * FP_STAGE + FP_V_OFF;
        mbar_expect_tx(full, FP_PLANE);
        tma_3d(vdst, tmv, full, 128 * c, b * FP_SB, h);
        tma_3d(vdst + FP_HALF, tmv, full, 128 * c + 64, b * FP_SB, h);
      }
      mbar_wait(cta.rawbar, it & 1);
      convert_block<Q8>(cta.smem + c * FP_STAGE, cta.smem + FP_RAW, p, ksc, vsc);
      // as prefill_producer: the raw block's reads and the stage's writes
      // ordered before the next TMA into the raw block and the wgmma
      fence_proxy_async();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (it + 1 < 2 * nblk)
        load_raw_wide<Q8>(w, raw, cta.rawbar, tmk, tmv, tmc, tms, (b + c) * FP_SB, c ^ 1, h, p);
      mbar_arrive(full);
    }
  }
}

// the two consumer warpgroups: warpgroup c takes dims 128c.. of the scores
// and of O for the CTA's 64 rows. SOFTCAP: a score s becomes cap.y *
// tanhf(s * cap.x) + max(bias, -1e30) log2 e, cap.x = scale / softcap and
// cap.y = softcap * log2 e (the TPU kernel's tanh(s * scale / cap) * cap)
template <bool SOFTCAP>
__device__ __forceinline__ void wide_consumers(const PrefillCta& cta, const PrefillWideArgs& w,
                                               float2 cap) {
  const PrefillArgs& a = w.a;
  const int Dk = a.D, Dv = w.Dv;
  const int h = cta.h, row0 = cta.row0, nblk = cta.nblk;
  const int tid = threadIdx.x & 127, lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7, d0 = 128 * wg;
  const int gid = lane >> 2, t4 = lane & 3;
  const int ra = 16 * warp + gid, rb = ra + 8;
  const int G = a.G;
  float* xch = reinterpret_cast<float*>(cta.smem + FW_XCH);

  uint32_t qf[2][8][4];
  {
    const int Ra = row0 + ra, Rb = row0 + rb;
    const bool oka = Ra / G < a.T, okb = Rb / G < a.T;
    const size_t offa = ((size_t)(Ra / G) * a.H + h * G + Ra % G) * Dk + d0 + 2 * t4;
    const size_t offb = ((size_t)(Rb / G) * a.H + h * G + Rb % G) * Dk + d0 + 2 * t4;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const __nv_bfloat16* src = v ? a.qr : a.q;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const bool lo = d0 + 16 * ks < Dk, hi = d0 + 16 * ks + 8 < Dk;
        qf[v][ks][0] =
            oka && lo ? __ldg(reinterpret_cast<const uint32_t*>(src + offa + 16 * ks)) : 0u;
        qf[v][ks][1] =
            okb && lo ? __ldg(reinterpret_cast<const uint32_t*>(src + offb + 16 * ks)) : 0u;
        qf[v][ks][2] =
            oka && hi ? __ldg(reinterpret_cast<const uint32_t*>(src + offa + 16 * ks + 8)) : 0u;
        qf[v][ks][3] =
            okb && hi ? __ldg(reinterpret_cast<const uint32_t*>(src + offb + 16 * ks + 8)) : 0u;
      }
    }
  }
  const float* bra = a.bias + (size_t)min((row0 + ra) / G, a.T - 1) * a.S;
  const float* brb = a.bias + (size_t)min((row0 + rb) / G, a.T - 1) * a.S;
  float ba[16], bb[16];
  load_bias(ba, bb, bra, brb, 2 * t4, a.S);

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float ma = FP_NEG * LOG2E, mb = FP_NEG * LOG2E, la = 0.f, lb = 0.f;
  const float scale2 = a.scale * LOG2E;
  const float NINF = __int_as_float(0xff800000u);
  const uint32_t st = cta.smem_a + wg * FP_STAGE;
  for (int b = 0; b < nblk; ++b) {
    const int sb = b * FP_SB;
    mbar_wait(cta.full0 + 8 * wg, b & 1);
    float sc[32];
    wg_fence();
#pragma unroll
    for (int pl = 0; pl < 4; ++pl)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s(sc, qf[pl & 1][4 * hh + kk],
                  x_desc(st + pl * FP_PLANE + hh * FP_HALF + kk * 32),
                  (pl | hh | kk) ? 1 : 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    // the two partial scores meet: warpgroup 1's into warpgroup 0, the sum back
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) xch[i * 128 + tid] = sc[i];
    }
    named_sync(2);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] += xch[i * 128 + tid];
        xch[i * 128 + tid] = sc[i];
      }
    }
    named_sync(3);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = xch[i * 128 + tid];
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (SOFTCAP) {
        sc[4 * i + 0] = fmaf(tanhf(sc[4 * i + 0] * cap.x), cap.y, ba[2 * i]);
        sc[4 * i + 1] = fmaf(tanhf(sc[4 * i + 1] * cap.x), cap.y, ba[2 * i + 1]);
        sc[4 * i + 2] = fmaf(tanhf(sc[4 * i + 2] * cap.x), cap.y, bb[2 * i]);
        sc[4 * i + 3] = fmaf(tanhf(sc[4 * i + 3] * cap.x), cap.y, bb[2 * i + 1]);
      } else {
        sc[4 * i + 0] = fmaf(sc[4 * i + 0], scale2, ba[2 * i]);
        sc[4 * i + 1] = fmaf(sc[4 * i + 1], scale2, ba[2 * i + 1]);
        sc[4 * i + 2] = fmaf(sc[4 * i + 2], scale2, bb[2 * i]);
        sc[4 * i + 3] = fmaf(sc[4 * i + 3], scale2, bb[2 * i + 1]);
      }
    }
    if (sb + FP_SB > a.S) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (sb + 8 * (i >> 2) + 2 * t4 + (i & 1) >= a.S) sc[i] = NINF;
    }
    if (b + 1 < nblk) load_bias(ba, bb, bra, brb, sb + FP_SB + 2 * t4, a.S);
    float mxa, mxb;
    {
      float m4[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m4[i][0] = fmaxf(fmaxf(sc[8 * i + 0], sc[8 * i + 1]), fmaxf(sc[8 * i + 4], sc[8 * i + 5]));
        m4[i][1] = fmaxf(fmaxf(sc[8 * i + 2], sc[8 * i + 3]), fmaxf(sc[8 * i + 6], sc[8 * i + 7]));
      }
      mxa = fmaxf(fmaxf(m4[0][0], m4[1][0]), fmaxf(m4[2][0], m4[3][0]));
      mxb = fmaxf(fmaxf(m4[0][1], m4[1][1]), fmaxf(m4[2][1], m4[3][1]));
    }
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 2));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 2));
    const float na = fmaxf(ma, mxa), nb = fmaxf(mb, mxb);
    const float alpha_a = ex2(ma - na), alpha_b = ex2(mb - nb);
    const bool moved = __any_sync(0xffffffffu, na != ma || nb != mb);
    ma = na;
    mb = nb;
    float sum4[4][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[4 * i + 0] = ex2(sc[4 * i + 0] - na);
      sc[4 * i + 1] = ex2(sc[4 * i + 1] - na);
      sc[4 * i + 2] = ex2(sc[4 * i + 2] - nb);
      sc[4 * i + 3] = ex2(sc[4 * i + 3] - nb);
      const float pa = sc[4 * i + 0] + sc[4 * i + 1], pb = sc[4 * i + 2] + sc[4 * i + 3];
      sum4[i & 3][0] = i < 4 ? pa : sum4[i & 3][0] + pa;
      sum4[i & 3][1] = i < 4 ? pb : sum4[i & 3][1] + pb;
    }
    float suma = (sum4[0][0] + sum4[1][0]) + (sum4[2][0] + sum4[3][0]);
    float sumb = (sum4[0][1] + sum4[1][1]) + (sum4[2][1] + sum4[3][1]);
    suma += __shfl_xor_sync(0xffffffffu, suma, 1);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, 1);
    suma += __shfl_xor_sync(0xffffffffu, suma, 2);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, 2);
    if (moved) {
      la *= alpha_a;
      lb *= alpha_b;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[4 * i + 0] *= alpha_a;
        o[4 * i + 1] *= alpha_a;
        o[4 * i + 2] *= alpha_b;
        o[4 * i + 3] *= alpha_b;
      }
    }
    la += suma;
    lb += sumb;
    uint32_t ph[4][4], plo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 2 * j + (r >> 1), e = 2 * (r & 1);
        split_hilo(sc[4 * i + e], sc[4 * i + e + 1], ph[j][r], plo[j][r]);
      }
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t vd = v_desc(st + FP_V_OFF + j * 16 * 128);
      wgmma_o(o, ph[j], vd);
      wgmma_o(o, plo[j], vd);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    // no proxy fence: only wgmma read this slot (the partial scores meet in
    // xch, outside the ring), and wait_group 0 has seen those reads complete
    __syncwarp();
    if (lane == 0) mbar_arrive(cta.empty0 + 8 * wg);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = row0 + (half ? rb : ra);
    const int t = R / G;
    if (t >= a.T) continue;
    const float inv = 1.f / fmaxf(half ? lb : la, 1e-30f);
    float* dst = a.out + ((size_t)t * a.H + h * G + R % G) * Dv + d0 + 2 * t4;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (d0 + 8 * i < Dv)
        *reinterpret_cast<float2*>(dst + 8 * i) =
            make_float2(o[4 * i + 2 * half] * inv, o[4 * i + 2 * half + 1] * inv);
  }
}

template <bool Q8>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_wgmma_wide(const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv,
                         const __grid_constant__ CUtensorMap tmc,
                         const __grid_constant__ CUtensorMap tms, const PrefillWideArgs w) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * FP_STAGES + 1];
  PrefillCta c;
  const uint32_t raw_ = smem_u32(dyn_smem);
  c.smem = dyn_smem + (((raw_ + 1023) & ~1023u) - raw_);
  c.smem_a = smem_u32(c.smem);
  c.full0 = smem_u32(&bars[0]);
  c.empty0 = smem_u32(&bars[FP_STAGES]);
  c.rawbar = smem_u32(&bars[2 * FP_STAGES]);
  c.h = blockIdx.y;
  c.row0 = blockIdx.x * FW_ROWS;
  c.nblk = (w.a.S + FP_SB - 1) / FP_SB;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FP_STAGES; ++s) {
      mbar_init(c.full0 + 8 * s, Q8 ? 128 : 129);  // K4: + lane 0's expect_tx for V
      mbar_init(c.empty0 + 8 * s, 4);               // one warpgroup a stage
    }
    mbar_init(c.rawbar, 1 + (Q8 && (w.kcp || w.vcp) ? 128 : 0));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= FP_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FP_PRODUCER_REGS));
    wide_producer<Q8>(c, &tmk, &tmv, &tmc, &tms, w);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FP_CONSUMER_REGS));
  wide_consumers<false>(c, w, make_float2(0.f, 0.f));
}

// the wide kernel with gemma2's attention softcap, cap = (scale / softcap,
// softcap * log2 e): the same CTA but for wide_consumers<true>. (Its body is
// the uncapped kernel's, written out: with the two sharing a force-inlined
// CTA function, ptxas ordered two of the K4qw kernel's prologue loads
// differently, and its machine code would no longer be the parent's.)
template <bool Q8>
__global__ void __launch_bounds__(FP_THREADS, 1)
flash_prefill_wgmma_wide_cap(const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             const __grid_constant__ CUtensorMap tmc,
                             const __grid_constant__ CUtensorMap tms, const PrefillWideArgs w,
                             const float2 cap) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * FP_STAGES + 1];
  PrefillCta c;
  const uint32_t raw_ = smem_u32(dyn_smem);
  c.smem = dyn_smem + (((raw_ + 1023) & ~1023u) - raw_);
  c.smem_a = smem_u32(c.smem);
  c.full0 = smem_u32(&bars[0]);
  c.empty0 = smem_u32(&bars[FP_STAGES]);
  c.rawbar = smem_u32(&bars[2 * FP_STAGES]);
  c.h = blockIdx.y;
  c.row0 = blockIdx.x * FW_ROWS;
  c.nblk = (w.a.S + FP_SB - 1) / FP_SB;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FP_STAGES; ++s) {
      mbar_init(c.full0 + 8 * s, Q8 ? 128 : 129);  // K4: + lane 0's expect_tx for V
      mbar_init(c.empty0 + 8 * s, 4);               // one warpgroup a stage
    }
    mbar_init(c.rawbar, 1 + (Q8 && (w.kcp || w.vcp) ? 128 : 0));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= FP_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FP_PRODUCER_REGS));
    wide_producer<Q8>(c, &tmk, &tmv, &tmc, &tms, w);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FP_CONSUMER_REGS));
  wide_consumers<true>(c, w, cap);
}

// softcap > 0: the capped instantiation; 0: none
template <bool Q8>
int launch_prefill_wide(const PrefillWideArgs& w, float softcap, cudaStream_t st) {
  const PrefillArgs& a = w.a;
  if (a.D < 8 || a.D > 256 || a.D % 8 || w.Dv < 8 || w.Dv > 256 || w.Dv % 8 || a.H % a.Hkv ||
      !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  static bool attr[2] = {false, false};
  if (!attr[softcap > 0.f]) {
    if (softcap > 0.f)
      cudaFuncSetAttribute(flash_prefill_wgmma_wide_cap<Q8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, FW_SMEM);
    else
      cudaFuncSetAttribute(flash_prefill_wgmma_wide<Q8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, FW_SMEM);
    attr[softcap > 0.f] = true;
  }
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  const cuuint64_t S = a.S, Hkv = a.Hkv, Dk = a.D, Dv = w.Dv;
  CUtensorMap m[4];
  memset(m, 0, sizeof(m));
  int rc = 0;
  if (!w.kcp)
    rc = Q8 ? raw_map(&m[0], u8, 3, a.k, 1, Dk, S, Hkv, none, FP_D)
            : raw_map(&m[0], bf, 3, a.k, 2, Dk, S, Hkv, none, FP_D);
  if (!rc && !w.vcp)
    rc = Q8 ? raw_map(&m[1], u8, 3, a.v, 1, Dv, S, Hkv, none, FP_D)
            : raw_map(&m[1], bf, 3, a.v, 2, Dv, S, Hkv, CU_TENSOR_MAP_SWIZZLE_128B, 64);
  if (!rc) rc = raw_map(&m[2], bf, 2, a.cs, 2, Dk, S, 1, none, FP_D);
  if (!rc) rc = raw_map(&m[3], bf, 2, a.sn, 2, Dk, S, 1, none, FP_D);
  if (rc) return rc;
  const dim3 grid((a.T * a.G + FW_ROWS - 1) / FW_ROWS, a.Hkv);
  if (softcap > 0.f)
    flash_prefill_wgmma_wide_cap<Q8><<<grid, FP_THREADS, FW_SMEM, st>>>(
        m[0], m[1], m[2], m[3], w, make_float2(a.scale / softcap, softcap * LOG2E));
  else
    flash_prefill_wgmma_wide<Q8><<<grid, FP_THREADS, FW_SMEM, st>>>(m[0], m[1], m[2], m[3], w);
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

// K4 at Dk, Dv apart, each a multiple of 8 up to 256: the wide kernel.
// softcap > 0: the capped instantiation (gemma2's attention logit cap).
extern "C" int flash_prefill_wide_launch(const void* q, const void* qr, const void* k,
                                         const void* v, const void* cs, const void* sn,
                                         const void* bias, void* out, int T, int H, int Hkv,
                                         int S, int Dk, int Dv, float scale, float softcap,
                                         void* stream) {
  const PrefillWideArgs w{
      args_of(q, qr, k, nullptr, v, nullptr, cs, sn, bias, out, T, H, Hkv, S, Dk, scale), Dv,
      0, 0};
  return launch_prefill_wide<false>(w, softcap, reinterpret_cast<cudaStream_t>(stream));
}

// K4q on the wide kernel: int8 rows at any multiple of 8, one scale a row.
extern "C" int flash_prefill_wide_q8_launch(const void* q, const void* qr, const void* k,
                                            const void* ks, const void* v, const void* vs,
                                            const void* cs, const void* sn, const void* bias,
                                            void* out, int T, int H, int Hkv, int S, int Dk,
                                            int Dv, float scale, float softcap, void* stream) {
  const PrefillWideArgs w{
      args_of(q, qr, k, ks, v, vs, cs, sn, bias, out, T, H, Hkv, S, Dk, scale), Dv,
      Dk % 16 != 0, Dv % 16 != 0};
  return launch_prefill_wide<true>(w, softcap, reinterpret_cast<cudaStream_t>(stream));
}
