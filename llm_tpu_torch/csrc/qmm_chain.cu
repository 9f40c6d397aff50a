// K6: a chain of quantized decode matmuls with their glue, in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel llm_tpu/ops/pallas_qmm_chain.py::qmm_chain ->
// _chain_kernel. A chain is a layer tail
//
//   y1 = att @ Wo;  h = bf16(x_res + bf16(y1));  hn = bf16(rms(h) * gamma)
//   gu = hn @ Wgu;  cur = bf16(act(g) * u);      y3 = cur @ Wd
//   out = bf16(h + bf16(y3))
//
// with act silu (SwiGLU: kernel qmm_chain_tc) or gelu's tanh form (GeGLU,
// the TPU kernel's _act_f32 "gelu", jax.nn.gelu(approximate=True), with
// tanhf: kernel qmm_chain_tc_gelu, the same CTA instantiated for it),
// either of them with phases on nibble planes at group size 16 (Q2_K,
// Q3_K; kernel qmm_chain_tc_g16, which reads each boundary's act), on
// nibble planes at group size 256 (TQ1_0, TQ2_0; qmm_chain_tc_g256) or on
// int8 planes at group size 8 (IQ1_M; qmm_chain_tc_g8), which read it
// likewise, or one phase, out = (bf16(rms(x) * gamma)) @ W cast to bf16 or f32 (the
// attn_norm -> fused QKV head and the final norm -> lm_head). Each phase is
// K1/K2's function as their decode GEMV computes it (qmm_decode.cuh: exact
// integer products on the tensor cores, s and m applied per group in f32).
//
// Bound: the bytes of the chain's planes (each read once), as for the
// K1/K2 launches it replaces; the intermediates are small (gu at B=8 is
// 0.9 MB of f32) and stay in the 50 MB L2.
//
// Design. The TPU kernel walks one sequential grid and keeps the
// intermediates in VMEM. Here the phases run on a persistent grid of thread
// block clusters of C = 4, 6 or 8 CTAs (ops/cuda_qmm_chain.py::chain_plan
// picks C for the chain), every CTA resident at once: a cooperative launch
// with a cluster dimension, as many clusters as cudaOccupancyMaxActiveClusters
// allows, so that a grid that does not fit is refused rather than
// deadlocked.
//  * the CTA is the decode GEMV's: 160 threads, a producer warp whose lane 0
//    keeps a TMA ring of stages (128 plane columns x 128 k, two x chunks,
//    the group rows of scales and mins), and four consumer warps that run
//    dv_consume. The ring holds CH_RING = 96 KB (two CTAs an SM); each phase
//    lays it out in slots of its own layout's stage (p4: 6 slots, 4 at group
//    size 16 with f32 scales and mins; i8: 4) and
//    re-arms the slots' mbarriers, so that a running stage count within the
//    phase gives every wait its parity across the phase's work items, and
//    each consumer pair takes the slots of one parity;
//  * a phase's work items are (128-column tile, K range): `split` CTAs (a
//    divisor of C) of a cluster split one tile's K, the cluster's C / split
//    groups take that many tiles a round, a round's tiles dealt cluster by
//    cluster: the CTAs of one cluster sit on different SMs, while the card
//    stacks clusters on the same SMs (on the H100, clusters 15 apart at C =
//    8), so the busy CTAs of a round with few tiles spread over the SMs.
//    The tiles the full rounds leave may take one last round at a larger
//    split (`split_last`), over more CTAs. The partial tiles of a group
//    meet through distributed shared memory in rank order (two cluster
//    barriers an item; a CTA alone: two named barriers of its consumers),
//    and the sums are written with the phase's epilogue: f32, bf16, or the
//    residual add bf16(res + bf16(y)). No memset, no atomics: two launches
//    give the same bits;
//  * each phase's x comes by TMA: phase 0 of a tail reads the caller's x;
//    otherwise a boundary step after a grid barrier writes x once into bf16
//    scratch: bf16(rms(v) * gamma) of the caller's x (a head) or of h (the
//    tail's phase 0 epilogue writes h), one CTA a row (the row read once,
//    in registers), or cur = bf16(act(g) * u) from the f32 gu by the whole
//    grid; then fence.proxy.async (TMA, the async proxy, reads what generic
//    stores wrote) and a grid barrier;
//  * the last phase's epilogue writes the output itself.
// So a tail is one launch with four grid barriers, a head or the lm_head
// one.

#include <cooperative_groups.h>

#include "qmm_decode.cuh"

namespace cg = cooperative_groups;

// PRE_GEGLU is PRE_SWIGLU's boundary with gelu: a launch with one runs
// qmm_chain_tc_gelu, whose PRE_SWIGLU-or-PRE_GEGLU boundary computes gelu
enum { PRE_CAST = 0, PRE_NORM = 1, PRE_RES_NORM = 2, PRE_SWIGLU = 3, PRE_GEGLU = 4 };
enum { EPI_F32 = 0, EPI_BF16 = 1, EPI_RES = 2 };
constexpr int CH_MAX_PHASES = 3;
constexpr int CH_MAX_B = 8;
constexpr int CH_MAX_CLUSTER = 8;                           // CTAs a cluster (portable)
constexpr int CH_RING = 96 * 1024;                          // the ring's bytes
constexpr int CH_MAX_SLOTS = 6;
constexpr int CH_RED = 2 * CH_MAX_B * DV_TILE_N * 4;        // [2][8][128] f32 partials
constexpr int CH_SMEM = CH_RING + CH_RED + 1024;            // + slack to align to 1024

// one phase; mirrored by ctypes in ops/cuda_qmm_chain.py
struct ChainPhase {
  const void* qs;       // uint8 [K/2, N] (p4) or int8 [K, N] (i8)
  const void* scales;   // [K/gs, N] f32 or bf16
  const void* mins;     // same, or null
  const float* gamma;   // [K]: the boundary's norm weight (PRE_NORM, PRE_RES_NORM)
  const void* src;      // the boundary's input: bf16 [B, K] to normalize, or f32 gu [B, 2K]
  void* x;              // bf16 [B, K]: the phase's x (the boundary writes it)
  void* y;              // [B, N]: the phase's output, as `epi` writes it
  const void* res;      // bf16 [B, N]: the residual of EPI_RES
  int K, N, gs, zp, p4, scales_bf16, pre, epi;
  int split, split_last;  // CTAs a tile's K is split over; in a last round of few tiles
};

struct ChainMaps {
  CUtensorMap x[CH_MAX_PHASES], w[CH_MAX_PHASES], s[CH_MAX_PHASES], m[CH_MAX_PHASES];
};

struct ChainArgs {
  ChainPhase ph[CH_MAX_PHASES];
  int P, B, cluster;  // cluster: CTAs a cluster, the launch's cluster dimension
  float eps;
};

namespace {

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 128 consumer threads
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(DV_CONSUMERS) : "memory");
}

__device__ __forceinline__ float ldcg_bf16(const void* p, size_t i) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p) + i);
  return __uint_as_float((uint32_t)u << 16);
}

// 8 bf16 (16 bytes, from L2) as floats
__device__ __forceinline__ void ldcg_bf16x8(const void* p, size_t i, float (&v)[8]) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(reinterpret_cast<const uint16_t*>(p) + i));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
  }
}

// the sum of v over the CTA's 160 threads, in a fixed order, to every thread
__device__ __forceinline__ float cta_sum(float v, float* red5) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red5[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < DV_THREADS / 32; ++w) s += red5[w];
  return s;
}

constexpr int CH_ROW_CHUNKS = 4;  // 8-element chunks of a norm's row a thread keeps (K <= 5120)

// the gated FFN's activation of g in f32: silu, or gelu's tanh form
// 0.5 g (1 + tanh(sqrt(2/pi) (g + 0.044715 g^3))) with the full tanhf (the
// approximate tanh moves a weight by ~2.4%)
template <bool GELU>
__device__ __forceinline__ float glu_act(float g) {
  if constexpr (GELU) {
    return g * (0.5f * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * (g * g * g)))));
  } else {
    return g / (1.f + expf(-g));
  }
}

// the boundary before phase p: its x, written once into bf16 scratch
// (K % 8 == 0, every pointer 16-byte aligned)
template <bool GELU>
__device__ __forceinline__ void chain_boundary(const ChainArgs& a, int p, float* red5) {
  const ChainPhase& ph = a.ph[p];
  const int K = ph.K;
  if (ph.pre == PRE_NORM || ph.pre == PRE_RES_NORM) {
    // x = bf16(v * rsqrt(mean(v^2) + eps) * gamma), one CTA a row: the row
    // is read once (8 elements a load, every load in flight at once, kept in
    // registers up to CH_ROW_CHUNKS a thread)
    const int nch = K / 8;
    for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
      float v[CH_ROW_CHUNKS][8];
      float ss = 0.f;
#pragma unroll
      for (int m = 0; m < CH_ROW_CHUNKS; ++m) {
        const int ch = threadIdx.x + m * DV_THREADS;
        if (ch < nch) ldcg_bf16x8(ph.src, (size_t)b * K + 8 * ch, v[m]);
      }
#pragma unroll
      for (int m = 0; m < CH_ROW_CHUNKS; ++m)
        if (threadIdx.x + m * DV_THREADS < nch)
#pragma unroll
          for (int j = 0; j < 8; ++j) ss = fmaf(v[m][j], v[m][j], ss);
      for (int ch = threadIdx.x + CH_ROW_CHUNKS * DV_THREADS; ch < nch; ch += DV_THREADS) {
        float w[8];
        ldcg_bf16x8(ph.src, (size_t)b * K + 8 * ch, w);
#pragma unroll
        for (int j = 0; j < 8; ++j) ss = fmaf(w[j], w[j], ss);
      }
      const float r = rsqrtf(cta_sum(ss, red5) / (float)K + a.eps);
      auto put = [&](int ch, const float (&w)[8]) {
        const int k = 8 * ch;
        const float4 g0 = *reinterpret_cast<const float4*>(ph.gamma + k);
        const float4 g1 = *reinterpret_cast<const float4*>(ph.gamma + k + 4);
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        uint4 o;
        uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ow[j] = f2_bf16x2(w[2 * j] * r * g[2 * j], w[2 * j + 1] * r * g[2 * j + 1]);
        *reinterpret_cast<uint4*>(reinterpret_cast<uint16_t*>(ph.x) + (size_t)b * K + k) = o;
      };
#pragma unroll
      for (int m = 0; m < CH_ROW_CHUNKS; ++m) {
        const int ch = threadIdx.x + m * DV_THREADS;
        if (ch < nch) put(ch, v[m]);
      }
      for (int ch = threadIdx.x + CH_ROW_CHUNKS * DV_THREADS; ch < nch; ch += DV_THREADS) {
        float w[8];
        ldcg_bf16x8(ph.src, (size_t)b * K + 8 * ch, w);
        put(ch, w);
      }
    }
  } else {  // PRE_SWIGLU / PRE_GEGLU: x = bf16(act(g) * u) of gu [B, 2K], 4 k a thread at a time
    const float* gu = reinterpret_cast<const float*>(ph.src);
    const size_t n = (size_t)a.B * K / 4;
    for (size_t i = (size_t)blockIdx.x * DV_THREADS + threadIdx.x; i < n;
         i += (size_t)gridDim.x * DV_THREADS) {
      const size_t b = 4 * i / K, k = 4 * i % K;
      const float4 g = __ldcg(reinterpret_cast<const float4*>(gu + b * 2 * K + k));
      const float4 u = __ldcg(reinterpret_cast<const float4*>(gu + b * 2 * K + K + k));
      uint2 o;
      o.x = f2_bf16x2(glu_act<GELU>(g.x) * u.x, glu_act<GELU>(g.y) * u.y);
      o.y = f2_bf16x2(glu_act<GELU>(g.z) * u.z, glu_act<GELU>(g.w) * u.w);
      *reinterpret_cast<uint2*>(reinterpret_cast<uint16_t*>(ph.x) + 4 * i) = o;
    }
  }
  fence_proxy_async_global();  // the next phase's TMA reads these stores
}

// the TMA loads of stage u (128 k) of column tile n0 into st (G16: p4
// planes at group size 16; GX: p4 at 256 or i8 at 8, qmm_decode.cuh)
template <bool P4, bool SBF16, bool MINS, bool G16, int GX = 0>
__device__ __forceinline__ void chain_issue(const ChainMaps& maps, int p, int gs, uint32_t st,
                                            uint32_t full, int n0, int u) {
  using L = DecodeSmem<P4, SBF16, MINS, G16, GX>;
  constexpr int CG = P4Groups<G16>::CG, GS = P4Groups<G16>::GS;
  const int g_rows = GX == 256 ? 1 : P4 ? 2 * CG : DV_UNIT_K / gs;
  const uint32_t tx = 2 * 64 * CH_MAX_B * 2 + L::W_BYTES +
                      g_rows * DV_TILE_N * L::ES * (MINS ? 2 : 1);
  const int kx0 = P4 ? 256 * (u >> 1) + 64 * (u & 1) : DV_UNIT_K * u;
  const int kx1 = kx0 + (P4 ? 128 : 64);
  const int row0 = P4 ? 128 * (u >> 1) + 64 * (u & 1) : DV_UNIT_K * u;
  mbar_expect_tx(full, tx);
  tma_2d(st + L::X_OFF, &maps.x[p], full, kx0, 0);
  tma_2d(st + L::X_OFF + L::X_CHUNK, &maps.x[p], full, kx1, 0);
  tma_2d(st, &maps.w[p], full, n0, row0);
  if (GX == 256) {  // both chunks are in group kx0 / 256
    tma_2d(st + L::S_OFF, &maps.s[p], full, n0, kx0 / 256);
    if (MINS) tma_2d(st + L::M_OFF, &maps.m[p], full, n0, kx0 / 256);
  } else if (P4) {
    const int half = CG * DV_TILE_N * L::ES;
    tma_2d(st + L::S_OFF, &maps.s[p], full, n0, kx0 / GS);
    tma_2d(st + L::S_OFF + half, &maps.s[p], full, n0, kx1 / GS);
    if (MINS) {
      tma_2d(st + L::M_OFF, &maps.m[p], full, n0, kx0 / GS);
      tma_2d(st + L::M_OFF + half, &maps.m[p], full, n0, kx1 / GS);
    }
  } else {
    tma_2d(st + L::S_OFF, &maps.s[p], full, n0, kx0 / gs);
    if (MINS) tma_2d(st + L::M_OFF, &maps.m[p], full, n0, kx0 / gs);
  }
}

// the phase's output element (b, n) from its sum v
__device__ __forceinline__ void chain_store(const ChainPhase& ph, int b, int n, float v) {
  const size_t o = (size_t)b * ph.N + n;
  if (ph.epi == EPI_F32) {
    reinterpret_cast<float*>(ph.y)[o] = v;
  } else if (ph.epi == EPI_BF16) {
    reinterpret_cast<__nv_bfloat16*>(ph.y)[o] = __float2bfloat16_rn(v);
  } else {
    const float r = ldcg_bf16(ph.res, o);
    reinterpret_cast<__nv_bfloat16*>(ph.y)[o] = __float2bfloat16_rn(r + rn_bf16(v));
  }
}

// the ring's slots for a layout's stage: as many as CH_RING holds, even (a
// consumer pair takes the slots of one parity), at most CH_MAX_SLOTS
template <bool P4, bool SBF16, bool MINS, bool G16, int GX = 0>
struct ChainSlots {
  static constexpr int FIT = CH_RING / DecodeSmem<P4, SBF16, MINS, G16, GX>::STAGE;
  static constexpr int N = (FIT < CH_MAX_SLOTS ? FIT : CH_MAX_SLOTS) & ~1;
};

// one phase on this CTA: its items, round by round (G16: p4 planes at
// group size 16; GX: p4 at 256 or i8 at 8, run by dv_consume_gx)
template <bool P4, bool SBF16, bool MINS, bool G16, int GX = 0>
__device__ __forceinline__ void chain_phase(const ChainMaps& maps, const ChainArgs& a, int p,
                                            uint8_t* ring, float* red, uint32_t full0,
                                            uint32_t empty0) {
  using L = DecodeSmem<P4, SBF16, MINS, G16, GX>;
  constexpr int SLOTS = ChainSlots<P4, SBF16, MINS, G16, GX>::N;
  static_assert(SLOTS >= 2 && SLOTS * L::STAGE <= CH_RING, "a stage outgrows the ring");
  const ChainPhase& ph = a.ph[p];
  uint32_t rank, cid;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm("mov.u32 %0, %%clusterid.x;\n" : "=r"(cid));
  const int C = a.cluster, Q = gridDim.x / C;  // Q clusters of C CTAs
  const int tiles = ph.N / DV_TILE_N, units = (ph.K + DV_UNIT_K - 1) / DV_UNIT_K;
  // rounds of Q * C / split tiles; with split_last != split, the full rounds
  // and then one round of the remaining tiles at split_last
  const int per_round = Q * (C / ph.split);
  const int full = ph.split_last == ph.split ? (tiles + per_round - 1) / per_round
                                             : tiles / per_round;
  const int rounds = full + (ph.split_last == ph.split ? 0 : 1);
  // round k's split, this CTA's K range and tile (>= tiles: none)
  auto item = [&](int k, int& S, int& kr, int& u0, int& nu) {
    S = k < full ? ph.split : ph.split_last;
    const int grp = rank / S, upr = (units + S - 1) / S;
    kr = rank % S;
    u0 = min(units, kr * upr);
    nu = min(units, u0 + upr) - u0;
    return min(k, full) * per_round + (int)cid * (C / S) + grp;
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t ring_a = smem_u32(ring);

  if (warp == 4) {
    if (lane == 0) fence_proxy_async_global();  // x was written by generic stores
    int c = 0;  // the phase's running stage count
    for (int k = 0; k < rounds; ++k) {
      int S, kr, u0, nu;
      const int tile = item(k, S, kr, u0, nu);
      if (lane == 0 && tile < tiles) {
        for (int j = 0; j < nu; ++j, ++c) {
          const int slot = c % SLOTS;
          if (c >= SLOTS) mbar_wait(empty0 + 8 * slot, ((c / SLOTS) - 1) & 1);
          chain_issue<P4, SBF16, MINS, G16, GX>(maps, p, ph.gs, ring_a + slot * L::STAGE,
                                                full0 + 8 * slot, tile * DV_TILE_N, u0 + j);
        }
      }
      __syncwarp();
      if (S > 1) {  // the group's two cluster barriers of this item
        cluster_arrive();
        cluster_wait();
        cluster_arrive();
        cluster_wait();
      }
    }
    return;
  }

  const int cw = warp & 1, kw = warp >> 1;
  const uint32_t zb = 0x4300u | (uint32_t)ph.zp;  // p4: 128 + zp as a bf16 pair
  const uint32_t zp2 = zb | (zb << 16);
  const float ibase = 8388608.f + 128.f + (float)ph.zp;  // i8: 2^23 + 128 + zp
  int c = 0;
  for (int k = 0; k < rounds; ++k) {
    int S, kr, u0, nu;
    const int tile = item(k, S, kr, u0, nu);
    const bool active = tile < tiles;
    if (active) {
      float acc[1][4][4];
      zero_acc<1, 4>(acc);
      for (int j = 0; j < nu; ++j, ++c) {
        if ((c & 1) != kw) continue;  // pair kw takes the stages of its parity
        const int slot = c % SLOTS;
        mbar_wait(full0 + 8 * slot, (c / SLOTS) & 1);
        if constexpr (GX != 0) {
          float xg[1][1][4];
          dv_consume_gx<P4, SBF16, MINS, 1, false, GX>(ring + slot * L::STAGE, 64 * cw, zp2,
                                                       ibase, acc, xg, 0, 0.f);
        } else {
          dv_consume<P4, SBF16, MINS, 1, false, G16>(ring + slot * L::STAGE, 64 * cw, ph.gs,
                                                     zp2, ibase, acc);
        }
        dv_release(empty0 + 8 * slot, lane);  // qmm_decode.cuh: the fence, then the arrival
      }
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = 2 * t + (e & 1), col = 64 * cw + 8 * g + 2 * j + (e >> 1);
          red[(kw * CH_MAX_B + b) * DV_TILE_N + col] = acc[0][j][e];
        }
    }
    if (S > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      consumers_sync();
    }
    if (active) {
      // this CTA's slice of the tile, summed over its group in rank order
      const int elems = a.B * DV_TILE_N, per = (elems + S - 1) / S;
      const int e0 = kr * per, e1 = min(elems, e0 + per), n0 = tile * DV_TILE_N;
      for (int i = e0 + (int)threadIdx.x; i < e1; i += DV_CONSUMERS) {
        const int b = i / DV_TILE_N, col = i % DV_TILE_N;
        float v = 0.f;
        if (S > 1) {
          const uint32_t l0 = smem_u32(red + b * DV_TILE_N + col);
          const uint32_t l1 = smem_u32(red + (CH_MAX_B + b) * DV_TILE_N + col);
          for (int s = 0; s < S; ++s) {
            v += ld_dsmem(l0, (int)rank - kr + s);
            v += ld_dsmem(l1, (int)rank - kr + s);
          }
        } else {
          v = red[b * DV_TILE_N + col] + red[(CH_MAX_B + b) * DV_TILE_N + col];
        }
        chain_store(ph, b, n0 + col, v);
      }
    }
    if (S > 1) {  // no CTA writes its partial tile again while another reads it
      cluster_arrive();
      cluster_wait();
    } else {
      consumers_sync();
    }
  }
}

// the CTA of every kernel: the phases in turn, the boundaries with act
// silu (GELU false) or gelu; G16: p4 phases may also have group size 16,
// GX: p4 phases 256 (GX 256) or i8 phases 8 (GX 8); with G16 or GX the act
// is the boundary's (PRE_SWIGLU or PRE_GEGLU).
// It declares the kernel's shared memory itself: handed in as pointers
// from the kernel, the arrays cost qmm_chain_tc 24 more instructions
// (tools/cubin_cmp.py read DIFF), declared here it keeps its machine code
template <bool GELU, bool G16 = false, int GX = 0>
__device__ __forceinline__ void chain_cta(const ChainMaps& maps, const ChainArgs& a) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * CH_MAX_SLOTS];  // full, then empty
  __shared__ float red5[DV_THREADS / 32];
  const uint32_t raw = smem_u32(dyn_smem);
  uint8_t* ring = dyn_smem + (((raw + 1023) & ~1023u) - raw);
  float* red = reinterpret_cast<float*>(ring + CH_RING);
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[CH_MAX_SLOTS]);
  cg::grid_group grid = cg::this_grid();

  for (int p = 0; p < a.P; ++p) {
    const ChainPhase& ph = a.ph[p];
    if (ph.pre != PRE_CAST) {
      if ((G16 || GX != 0) && ph.pre == PRE_GEGLU) chain_boundary<true>(a, p, red5);
      else chain_boundary<GELU>(a, p, red5);
      grid.sync();
    }
    // arm the ring's barriers for this phase (every earlier wait has
    // completed: the previous phase ended at a grid barrier)
    if (threadIdx.x == 0) {
      for (int s = 0; s < CH_MAX_SLOTS; ++s) {
        if (p > 0) {
          mbar_inval(full0 + 8 * s);
          mbar_inval(empty0 + 8 * s);
        }
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, 2);  // the two consumer warps that take the stage
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
#define CHAIN_PHASE(P4, S, M, G) chain_phase<P4, S, M, G>(maps, a, p, ring, red, full0, empty0)
#define CHAIN_SM(P4, G)                                                            \
  if (ph.scales_bf16) {                                                            \
    if (ph.mins) CHAIN_PHASE(P4, true, true, G); else CHAIN_PHASE(P4, true, false, G); \
  } else {                                                                         \
    if (ph.mins) CHAIN_PHASE(P4, false, true, G); else CHAIN_PHASE(P4, false, false, G); \
  }
#define CHAIN_ANY                  \
    if (G16 && ph.p4 && ph.gs == 16) { \
      CHAIN_SM(true, G16)          \
    } else if (ph.p4) {            \
      CHAIN_SM(true, false)        \
    } else {                       \
      CHAIN_SM(false, false)       \
    }
    if constexpr (GX != 0) {
#define CHAIN_PHASE_GX(S, M) \
  chain_phase<GX == 256, S, M, false, GX>(maps, a, p, ring, red, full0, empty0)
      if (ph.gs == GX && (ph.p4 != 0) == (GX == 256)) {
        if (ph.scales_bf16) {
          if (ph.mins) CHAIN_PHASE_GX(true, true); else CHAIN_PHASE_GX(true, false);
        } else {
          if (ph.mins) CHAIN_PHASE_GX(false, true); else CHAIN_PHASE_GX(false, false);
        }
      } else {
        CHAIN_ANY
      }
#undef CHAIN_PHASE_GX
    } else {
      CHAIN_ANY
    }
#undef CHAIN_ANY
#undef CHAIN_SM
#undef CHAIN_PHASE
    if (p + 1 < a.P) grid.sync();
  }
}

__global__ void __launch_bounds__(DV_THREADS, 2)
qmm_chain_tc(const __grid_constant__ ChainMaps maps, const __grid_constant__ ChainArgs a) {
  chain_cta<false>(maps, a);
}

__global__ void __launch_bounds__(DV_THREADS, 2)
qmm_chain_tc_gelu(const __grid_constant__ ChainMaps maps, const __grid_constant__ ChainArgs a) {
  chain_cta<true>(maps, a);
}

// either with phases on p4 planes at group size 16 (Q2_K, Q3_K) beside the
// others: a kernel of its own, so that the two above keep their machine
// code
__global__ void __launch_bounds__(DV_THREADS, 2)
qmm_chain_tc_g16(const __grid_constant__ ChainMaps maps, const __grid_constant__ ChainArgs a) {
  chain_cta<false, true>(maps, a);
}

// either with phases on p4 planes at group size 256 (TQ1_0, TQ2_0), or on
// i8 planes at group size 8 (IQ1_M), beside the others (but group size 16)
__global__ void __launch_bounds__(DV_THREADS, 2)
qmm_chain_tc_g256(const __grid_constant__ ChainMaps maps, const __grid_constant__ ChainArgs a) {
  chain_cta<false, false, 256>(maps, a);
}

__global__ void __launch_bounds__(DV_THREADS, 2)
qmm_chain_tc_g8(const __grid_constant__ ChainMaps maps, const __grid_constant__ ChainArgs a) {
  chain_cta<false, false, 8>(maps, a);
}

// the kernel of a launch, by its index `kind`: 2 (qmm_chain_tc_g16) if a
// phase's p4 planes have group size 16, 3 (qmm_chain_tc_g256) if they have
// 256, 4 (qmm_chain_tc_g8) if a phase's i8 planes have group size 8 (no
// launch mixes these), else 1 (qmm_chain_tc_gelu) if a phase's boundary is
// PRE_GEGLU, else 0 (qmm_chain_tc)
using ChainKernel = void (*)(ChainMaps, ChainArgs);
constexpr int CH_KINDS = 5;
ChainKernel chain_kernel(int kind) {
  const ChainKernel kernels[CH_KINDS] = {qmm_chain_tc, qmm_chain_tc_gelu, qmm_chain_tc_g16,
                                         qmm_chain_tc_g256, qmm_chain_tc_g8};
  return kernels[kind];
}

// clusters of `cluster` CTAs of the kernel `kind` (chain_kernel) that can
// be resident at once: the grid. Asked once for each kernel and cluster
// size (it depends only on the kernel and the card).
cudaError_t chain_clusters(int cluster, int kind, int* n) {
  static int cached[CH_KINDS][CH_MAX_CLUSTER + 1] = {{0}};
  static bool attr[CH_KINDS] = {false, false, false, false, false};
  if (cluster < 1 || cluster > CH_MAX_CLUSTER || kind < 0 || kind >= CH_KINDS)
    return cudaErrorInvalidValue;
  const ChainKernel kernel = chain_kernel(kind);
  if (!attr[kind]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           CH_SMEM);
    if (err != cudaSuccess) return err;
    attr[kind] = true;
  }
  if (cached[kind][cluster] == 0) {
    cudaLaunchConfig_t cfg;
    memset(&cfg, 0, sizeof(cfg));
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(DV_THREADS, 1, 1);
    cfg.dynamicSmemBytes = CH_SMEM;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    int q = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&q, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (q < 1) return cudaErrorInvalidConfiguration;
    cached[kind][cluster] = q;
  }
  *n = cached[kind][cluster];
  return cudaSuccess;
}

// the tensor maps of one phase: x bf16 [B, K] (rows past B read as zero),
// the planes in the 128-byte swizzle, the group rows of scales and mins
int phase_maps(const ChainPhase& ph, int B, ChainMaps* mp, int p) {
  const int R = ph.p4 ? ph.K / 2 : ph.K, G = ph.K / ph.gs, es = ph.scales_bf16 ? 2 : 4;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)ph.K, (cuuint64_t)B};
    const cuuint64_t strides[1] = {(cuuint64_t)ph.K * 2};
    const cuuint32_t box[2] = {64, CH_MAX_B};
    if (int rc = make_map(&mp->x[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ph.x, dims, strides,
                          box, CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)ph.N, (cuuint64_t)R};
    const cuuint64_t strides[1] = {(cuuint64_t)ph.N};
    const cuuint32_t box[2] = {DV_TILE_N, (cuuint32_t)(ph.p4 ? 64 : 128)};
    if (int rc = make_map(&mp->w[p], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ph.qs, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  const CUtensorMapDataType dt =
      ph.scales_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[2] = {(cuuint64_t)ph.N, (cuuint64_t)G};
  const cuuint64_t strides[1] = {(cuuint64_t)ph.N * es};
  const cuuint32_t box[2] = {DV_TILE_N, (cuuint32_t)(ph.p4 ? (ph.gs == 256 ? 1 : 64 / ph.gs)
                                                           : DV_UNIT_K / ph.gs)};
  if (int rc = make_map(&mp->s[p], dt, 2, ph.scales, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return rc;
  if (ph.mins != nullptr)
    if (int rc = make_map(&mp->m[p], dt, 2, ph.mins, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE))
      return rc;
  return 0;
}

}  // namespace

// The clusters of `cluster` CTAs the card holds at once (-1 on an error):
// the grid of a launch with that cluster size, of the kernel `kind`
// (chain_kernel: 0 SwiGLU, 1 GeGLU, 2, 3, 4 group size 16, 256, 8). The wrapper's plan
// (chain_plan) picks the cluster size and deals a phase's tiles to them.
extern "C" int qmm_chain_clusters(int cluster, int kind) {
  int n = 0;
  return chain_clusters(cluster, kind, &n) == cudaSuccess ? n : -1;
}

// phases [P] (P <= 3), every field set by the wrapper; B <= 8 rows; the
// grid as many clusters of `cluster` CTAs as the card holds at once.
// Requirements (checked by the Python wrapper): every phase's planes as
// qmm_decode_launch takes them, N % 128 == 0, K % 256 == 0, split a
// divisor of the cluster size that leaves every CTA of a group a stage; the
// scratch x, y and res 16-byte aligned. Returns a CUDA error code: nonzero
// when the launch is refused.
extern "C" int qmm_chain_launch(const ChainPhase* phases, int P, int B, float eps, int cluster,
                                void* stream) {
  if (P < 1 || P > CH_MAX_PHASES || B < 1 || B > CH_MAX_B) return (int)cudaErrorInvalidValue;
  bool gelu = false, g16 = false, g256 = false, g8 = false;
  for (int p = 0; p < P; ++p) {
    gelu = gelu || phases[p].pre == PRE_GEGLU;
    g16 = g16 || (phases[p].p4 && phases[p].gs == 16);
    g256 = g256 || (phases[p].p4 && phases[p].gs == 256);
    g8 = g8 || (!phases[p].p4 && phases[p].gs == 8);
  }
  if ((int)g16 + (int)g256 + (int)g8 > 1) return (int)cudaErrorInvalidValue;
  const int kind = g16 ? 2 : g256 ? 3 : g8 ? 4 : gelu;
  int q = 0;
  cudaError_t err = chain_clusters(cluster, kind, &q);
  if (err != cudaSuccess) return (int)err;
  ChainArgs a;
  ChainMaps maps;
  memset(&a, 0, sizeof(a));
  memset(&maps, 0, sizeof(maps));
  a.P = P;
  a.B = B;
  a.cluster = cluster;
  a.eps = eps;
  for (int p = 0; p < P; ++p) {
    const ChainPhase& ph = phases[p];
    const int units = (ph.K + DV_UNIT_K - 1) / DV_UNIT_K, tiles = ph.N / DV_TILE_N;
    for (int S : {ph.split, ph.split_last})
      if (S < 1 || cluster % S != 0 || S > units || (S - 1) * ((units + S - 1) / S) >= units)
        return (int)cudaErrorInvalidValue;
    // a last round at its own split holds the tiles the full rounds leave
    const int rest = tiles % (q * (cluster / ph.split));
    if (ph.split_last != ph.split && (rest == 0 || rest > q * (cluster / ph.split_last)))
      return (int)cudaErrorInvalidValue;
    if (ph.N % DV_TILE_N != 0 || ph.K % 256 != 0 ||
        (ph.p4 && ph.gs != 32 && ph.gs != 16 && ph.gs != 256) ||
        (!ph.p4 && ph.gs != 32 && ph.gs != 16 && ph.gs != 8))
      return (int)cudaErrorInvalidValue;
    a.ph[p] = ph;
    if (int rc = phase_maps(ph, B, &maps, p)) return rc;
  }
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(q * cluster, 1, 1);
  cfg.blockDim = dim3(DV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = CH_SMEM;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, chain_kernel(kind), maps, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
