// K4/K4q's wide CTA body (flash prefill past the narrow CTA's heads), for
// Hopper (sm_90a): included by csrc/flash_prefill.cu (the library's kernels)
// and csrc/flash_prefill_probe.cu (each side of its ring alone).
//
// What the narrow CTA (flash_prefill.cuh) cannot take: Dk and Dv apart,
// each a multiple of 8 up to 256 (gemma's 256, MLA's 192 / 128, Dk 128 /
// Dv 64),
// and K4q's int8 rows at any multiple of 8 (rows whose pitch is no multiple
// of 16 bytes, D = 72 and 136, come by 8-byte cp.async from the producer's
// lanes, not TMA); capped (gemma2's softcap, the CAP instantiation, as the
// narrow consumers take it) and uncapped, bf16 and q8.
//
// The design, and why (the wide CTA this replaces ran at 1.5-9.7x SDPA and
// 2.2-19.9x its doubled floor at T = 512, S = 4096 on an H100, PERF.md):
//  * one owner per row. A CTA owns 128 query rows of one KV head, as the
//    narrow one does: each consumer warpgroup 64 of them across every head
//    dim, so a row has one softmax and no partial scores meet in shared
//    memory (the old CTA owned 64 rows, its two warpgroups splitting the
//    dims and exchanging 16 KB of scores every block). A converted block
//    serves 128 rows, twice the old CTA's.
//  * chunks by shape. NC = ceil(max(Dk, Dv) / 128) 128-dim chunks is a
//    template constant. NC = 1 (Dk 128 / Dv 64, int8 at 72) holds q and
//    q_rot as wgmma A fragments in registers (64 a thread) and O in 64, as
//    the narrow consumers do, and runs no dead chunk. NC = 2 (256, 192 /
//    128, 136) keeps O at Dv = 256 in 128 registers a thread, so q and
//    q_rot (another 128) come from shared memory as wgmma's A operand:
//    [warpgroup][q | q_rot][chunk][64-dim half][64 rows] in the 128-byte
//    swizzle, 128 KB, written once a launch.
//  * blocks of 32 cells (FW_SB), so that the K-side planes and V fit beside
//    q: a ring of NR planes slots, each one (block, chunk) item's kc_hi,
//    ks_hi, kc_lo, ks_lo ([32 cells][128 dims] bf16, 32 KB; each 64-dim
//    half of k cos as its hi rows then its lo rows, and of k sin likewise,
//    so that one m64n64k16 takes q against 32 cells' hi and lo at once:
//    q is read from shared memory once a plane pair, not once a plane,
//    which took 10-18% off every two-chunk row on an H100, PERF.md), and a
//    ring of
//    V slots, each a block's V ([NC chunks][32 cells][128 dims], 8 KB a
//    chunk). At NC = 1 four of each (planes 128 + V 32 = 160 KB), at NC = 2
//    two (q 128 + planes 64 + V 32 = 224 KB of the 227).
//  * a ring with a block ahead. The raw inputs of an item (K, cos, sin;
//    K4q: int8 K and V) land by TMA in the item's own planes slot; the
//    producer's lanes read them into registers, meet at a barrier, and
//    write the planes over them (no raw block of its own). The consumers
//    release a planes slot as soon as that chunk's score chain retires
//    (wgmma wait_group NC - 1 - c), before their softmax and P.V, so the
//    producer fills and converts block b + 1's chunks while the consumers
//    run block b's softmax and P.V; NC = 1's four slots keep up to three
//    blocks ahead. V (K4: by TMA in the 128-byte swizzle; K4q: dequantized
//    by the producer) has its own slots, released after P.V.
//  * the S split. Where the grid's 128-row tiles x Hkv leave SMs idle
//    (Gemma-2-2B: 4 KV heads x 1024 rows, 32 CTAs), a thread block cluster
//    of `split` CTAs (wide_prefill_plan in ops/cuda_attn.py: the largest
//    split whose clusters the card holds at once, by
//    cudaOccupancyMaxActiveClusters; Gemma-2-2B's 32 clusters of 4 took a
//    second wave, 346 µs against 227 at 3 on an H100) splits the head's
//    blocks; after the loop each CTA parks its (m, l, O) in its
//    shared memory and CTA `rank` combines a slice of the rows over every
//    rank in rank order through distributed shared memory, as K3's cluster
//    does: no scratch, no atomics, the same bits from launch to launch.
//  * the proxy fence: the producer's lanes read the raw inputs (ld.shared)
//    and write the planes (st.shared) that a later TMA refills and wgmma
//    reads: fence.proxy.async before each full arrival; the consumers read
//    their slots through wgmma alone (and their q, written once, behind a
//    fence before the first chain).
// The arithmetic is the narrow kernel's (flash_prefill.cuh): the exact hi +
// lo planes of k cos and k sin, q . [kc_hi | kc_lo] + q_rot . [ks_hi |
// ks_lo] per chunk (the hi and lo columns summed once the chains retire),
// P as hi + lo. Past Dk or Dv, TMA and cp.async fill zeros, which add
// nothing.

#pragma once

#include <string.h>

#include "flash_prefill.cuh"  // the narrow CTA's helpers: dq8, split_exact, load_bias, ...

namespace {

constexpr int FW_ROWS = 128;                 // query rows a CTA: 64 a consumer warpgroup
constexpr int FW_SB = 32;                    // cells a block
constexpr int FW_HALF = FW_SB * 128;         // [32 cells][64 dims] bf16
constexpr int FW_CHUNK = 2 * FW_HALF;        // [32 cells][128 dims] bf16
constexpr int FW_SLOT = 4 * FW_CHUNK;        // a planes slot: kc_hi, ks_hi, kc_lo, ks_lo
constexpr int FW_QPIECE = 64 * 128;          // [64 rows][64 dims] bf16 of q or q_rot
constexpr int FW_MAX_SPLIT = 8;              // portable cluster size
// an item's raw inputs in its planes slot, row-major: K bf16 [32][128]
// (K4q: int8 K [32][128], then int8 V), cos, sin bf16 [32][128]
constexpr int FW_RAW_V8 = FW_SB * 128;
constexpr int FW_RAW_C = FW_CHUNK, FW_RAW_S = 2 * FW_CHUNK;
// setmaxnreg can only hand the consumers what the producer gives back of
// the launch's 168 a thread: 128 (168 - 88) = 256 (208 - 168)
constexpr int FW_PRODUCER_REGS = 88;
constexpr int FW_CONSUMER_REGS = 208;
static_assert(128 * (168 - FW_PRODUCER_REGS) >= 256 * (FW_CONSUMER_REGS - 168),
              "the consumers' registers come from the producer's");

template <int NC>
struct WideSmem {
  static constexpr int NR = NC == 1 ? 4 : 2;               // planes slots
  static constexpr int NV = NC == 1 ? 4 : 2;               // V slots
  static constexpr int Q_BYTES = NC == 1 ? 0 : 2 * 2 * NC * 2 * FW_QPIECE;
  static constexpr int PLANES = Q_BYTES;
  static constexpr int V = PLANES + NR * FW_SLOT;
  static constexpr int BYTES = V + NV * NC * FW_CHUNK;
  // the S split's partials, over the ring once every item is consumed: O
  // [128 rows][NC * 128] f32, m [128], l [128], then every rank's m and l
  static constexpr int P_M = FW_ROWS * NC * 128 * 4;
  static constexpr int P_L = P_M + FW_ROWS * 4;
  static constexpr int X_M = P_L + FW_ROWS * 4;
  static constexpr int X_L = X_M + FW_MAX_SPLIT * FW_ROWS * 4;
  static_assert(X_L + FW_MAX_SPLIT * FW_ROWS * 4 <= BYTES, "partials within the ring");
  static constexpr int SMEM = BYTES + 1024;                // + 1024 to align
  static_assert(SMEM <= 232448, "227 KB of shared memory a CTA");
};

struct PrefillWideArgs {
  PrefillArgs a;  // a.D is Dk
  int Dv;
  int kcp, vcp;   // K4q: K's (V's) int8 rows by cp.async
  int split, bpr; // CTAs a KV head's row tile (the cluster), blocks a rank
};

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// s[32] (+)= A[64 x 16] (shared memory, K-major) x B[16 x 64] (shared memory, K-major)
__device__ __forceinline__ void wgmma_s64_ss(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// byte offset in a planes slot of dims 8*c8 .. 8*c8 + 7 of cell `cell` of
// plane (cs: k cos 0, k sin 1; hl: hi 0, lo 1): [64-dim half][cs][hl][32
// cells][128 B], so that a plane's hi and lo rows make one 64-row B tile
__device__ __forceinline__ int fw_poff(int cell, int c8, int cs, int hl) {
  return (((c8 >> 3) * 2 + cs) * 2 + hl) * FW_HALF + cell * 128 +
         (((c8 & 7) ^ (cell & 7)) << 4);
}

// descriptor of a bf16 V chunk read MN-major: 8-cell groups 1024 bytes
// apart, the second 64-dim half FW_HALF on, 128-byte swizzle
__device__ __forceinline__ uint64_t fw_v_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(FW_HALF >> 4) << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

// byte offset of dims 8*c8 .. 8*c8 + 7 (c8 < 16) of row r of a swizzled
// tile of two 64-dim halves `half` bytes apart
__device__ __forceinline__ int fw_off(int r, int c8, int half) {
  return (c8 >> 3) * half + r * 128 + (((c8 & 7) ^ (r & 7)) << 4);
}

// cells s0 + 8 i + {0, 1} (i < 4, s0 even) of two bias rows, clamped to
// -1e30 and times log2 e, 0 past S
__device__ __forceinline__ void fw_load_bias(float (&ba)[8], float (&bb)[8], const float* bra,
                                             const float* brb, int s0, int S) {
  if ((S & 1) == 0 && s0 + 8 * 3 + 1 < S) {
    const float2* pa = reinterpret_cast<const float2*>(bra + s0);
    const float2* pb = reinterpret_cast<const float2*>(brb + s0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 va = __ldg(pa + 4 * i), vb = __ldg(pb + 4 * i);
      ba[2 * i] = fmaxf(va.x, FP_NEG) * LOG2E;
      ba[2 * i + 1] = fmaxf(va.y, FP_NEG) * LOG2E;
      bb[2 * i] = fmaxf(vb.x, FP_NEG) * LOG2E;
      bb[2 * i + 1] = fmaxf(vb.y, FP_NEG) * LOG2E;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + 8 * (i >> 1) + (i & 1);
      ba[i] = s < S ? fmaxf(__ldg(bra + s), FP_NEG) * LOG2E : 0.f;
      bb[i] = s < S ? fmaxf(__ldg(brb + s), FP_NEG) * LOG2E : 0.f;
    }
  }
}

// a wide CTA's shared memory, barriers and place in the grid
struct WideCta {
  uint8_t* smem;
  uint32_t smem_a, full0, empty0, raw0, vfull0, vempty0;
  int h, row0, rank, b0, b1;
};

// the raw inputs of item (block at cell sb, chunk c) into a planes slot:
// lane 0's TMA and, for K4q rows that TMA cannot take, every lane's 8-byte
// pieces; every lane arrives on bar once its pieces land where any are needed
template <bool Q8>
__device__ __forceinline__ void fw_load_raw(const PrefillWideArgs& w, uint32_t raw, uint32_t bar,
                                            const CUtensorMap* tmk, const CUtensorMap* tmv,
                                            const CUtensorMap* tmc, const CUtensorMap* tms,
                                            int sb, int c, int h, int p) {
  const PrefillArgs& a = w.a;
  const int x0 = 128 * c;
  if (p == 0) {
    const int kb = Q8 ? FW_SB * 128 : FW_CHUNK;
    mbar_expect_tx(bar, 2 * FW_CHUNK + (w.kcp ? 0 : kb) + (Q8 && !w.vcp ? kb : 0));
    if (!w.kcp) tma_3d(raw, tmk, bar, x0, sb, h);
    if (Q8 && !w.vcp) tma_3d(raw + FW_RAW_V8, tmv, bar, x0, sb, h);
    tma_2d(raw + FW_RAW_C, tmc, bar, x0, sb);
    tma_2d(raw + FW_RAW_S, tms, bar, x0, sb);
  }
  if (Q8 && (w.kcp || w.vcp)) {
#pragma unroll 1
    for (int v = 0; v < 2; ++v) {
      if (!(v ? w.vcp : w.kcp)) continue;
      const int D = v ? w.Dv : a.D;
      const int8_t* base = reinterpret_cast<const int8_t*>(v ? a.v : a.k);
      for (int pi = p; pi < FW_SB * 16; pi += 128) {
        const int cell = pi >> 4, j = pi & 15, s = sb + cell, d = x0 + 8 * j;
        const bool ok = s < a.S && d < D;
        cp_async8(raw + (v ? FW_RAW_V8 : 0) + cell * 128 + 8 * j,
                  base + (ok ? ((size_t)h * a.S + s) * D + d : 0), ok ? 8 : 0);
      }
    }
    cp_async_arrive(bar);
  }
}

// the producer warpgroup: the rank's items (block b, chunk c) in order, each
// into planes slot i % NR; a block's V into V slot (b - b0) % NV (K4: TMA at
// its first chunk; K4q: dequantized chunk by chunk). PART 2 (the consumers
// alone, csrc/flash_prefill_probe.cu): every slot handed over unfilled
template <bool Q8, int NC, int PART = 0>
__device__ __forceinline__ void wide_producer(const WideCta& w, const CUtensorMap* tmk,
                                              const CUtensorMap* tmv, const CUtensorMap* tmc,
                                              const CUtensorMap* tms, const PrefillWideArgs& wa) {
  using L = WideSmem<NC>;
  const PrefillArgs& a = wa.a;
  const int h = w.h, p = threadIdx.x - FP_CONSUMERS, c8 = p & 15;
  const int nitems = (w.b1 - w.b0) * NC;
  if constexpr (PART == 2) {
#pragma unroll 1
    for (int i = 0; i < nitems; ++i) {
      const int ib = i / NC, c = i % NC, slot = i % L::NR, vslot = ib % L::NV;
      mbar_wait(w.empty0 + 8 * slot, ((i / L::NR) & 1) ^ 1);
      if (c == 0) {
        mbar_wait(w.vempty0 + 8 * vslot, ((ib / L::NV) & 1) ^ 1);
        if (!Q8 && p == 0) mbar_arrive(w.vfull0 + 8 * vslot);
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      mbar_arrive(w.full0 + 8 * slot);
      if (Q8 && c == NC - 1) mbar_arrive(w.vfull0 + 8 * vslot);
    }
    return;
  }
#pragma unroll 1
  for (int i = 0; i < nitems; ++i) {
    const int ib = i / NC, c = i % NC, sb = (w.b0 + ib) * FW_SB;
    const int slot = i % L::NR, vslot = ib % L::NV;
    const uint32_t ph = (i / L::NR) & 1, vph = (ib / L::NV) & 1;
    const uint32_t st_a = w.smem_a + L::PLANES + slot * FW_SLOT;
    uint8_t* const st = w.smem + L::PLANES + slot * FW_SLOT;
    uint8_t* const vst = w.smem + L::V + vslot * NC * FW_CHUNK + c * FW_CHUNK;
    float ksc[4], vsc[4];  // K4q: the row scales of this lane's cells
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = sb + (p >> 4) + 8 * j;
      ksc[j] = Q8 && s < a.S ? __bfloat162float(a.ks[(size_t)h * a.S + s]) : 0.f;
      vsc[j] = Q8 && s < a.S ? __bfloat162float(a.vs[(size_t)h * a.S + s]) : 0.f;
    }
    mbar_wait(w.empty0 + 8 * slot, ph ^ 1);
    fw_load_raw<Q8>(wa, st_a, w.raw0 + 8 * slot, tmk, tmv, tmc, tms, sb, c, h, p);
    if (c == 0) {
      mbar_wait(w.vempty0 + 8 * vslot, vph ^ 1);
      if (!Q8 && p == 0) {
        const uint32_t vdst = w.smem_a + L::V + vslot * NC * FW_CHUNK;
        const uint32_t vfull = w.vfull0 + 8 * vslot;
        mbar_expect_tx(vfull, NC * FW_CHUNK);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          tma_3d(vdst + cc * FW_CHUNK, tmv, vfull, 128 * cc, sb, h);
          tma_3d(vdst + cc * FW_CHUNK + FW_HALF, tmv, vfull, 128 * cc + 64, sb, h);
        }
      }
    }
    mbar_wait(w.raw0 + 8 * slot, ph);
    // this lane's 8 dims (c8) of cells p / 16 + 8 j, into registers: the
    // planes are written over them
    uint4 kin[4], cin[4], sin4[4];
    uint2 k8[4], v8[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cell = (p >> 4) + 8 * j;
      if (Q8) {
        k8[j] = *reinterpret_cast<const uint2*>(st + cell * 128 + 8 * c8);
        v8[j] = *reinterpret_cast<const uint2*>(st + FW_RAW_V8 + cell * 128 + 8 * c8);
      } else {
        kin[j] = *reinterpret_cast<const uint4*>(st + cell * 256 + 16 * c8);
      }
      cin[j] = *reinterpret_cast<const uint4*>(st + FW_RAW_C + cell * 256 + 16 * c8);
      sin4[j] = *reinterpret_cast<const uint4*>(st + FW_RAW_S + cell * 256 + 16 * c8);
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // every lane has read the raw inputs
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cell = (p >> 4) + 8 * j;
      const uint4 kw = Q8 ? dq8(k8[j], ksc[j]) : kin[j];
      const uint32_t kk[4] = {kw.x, kw.y, kw.z, kw.w},
                     cc[4] = {cin[j].x, cin[j].y, cin[j].z, cin[j].w},
                     ss[4] = {sin4[j].x, sin4[j].y, sin4[j].z, sin4[j].w};
      uint32_t ch[4], cl[4], sh[4], sl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float k0 = bf_lo(kk[e]), k1 = bf_hi(kk[e]);
        split_exact(k0 * bf_lo(cc[e]), k1 * bf_hi(cc[e]), ch[e], cl[e]);
        split_exact(k0 * bf_lo(ss[e]), k1 * bf_hi(ss[e]), sh[e], sl[e]);
      }
      *reinterpret_cast<uint4*>(st + fw_poff(cell, c8, 0, 0)) =
          make_uint4(ch[0], ch[1], ch[2], ch[3]);
      *reinterpret_cast<uint4*>(st + fw_poff(cell, c8, 1, 0)) =
          make_uint4(sh[0], sh[1], sh[2], sh[3]);
      *reinterpret_cast<uint4*>(st + fw_poff(cell, c8, 0, 1)) =
          make_uint4(cl[0], cl[1], cl[2], cl[3]);
      *reinterpret_cast<uint4*>(st + fw_poff(cell, c8, 1, 1)) =
          make_uint4(sl[0], sl[1], sl[2], sl[3]);
      if (Q8) *reinterpret_cast<uint4*>(vst + fw_off(cell, c8, FW_HALF)) = dq8(v8[j], vsc[j]);
    }
    // the raw inputs' reads and the planes' (and K4q V's) writes ordered
    // before the async proxy: the wgmma that read them, the TMA that refills
    fence_proxy_async();
    mbar_arrive(w.full0 + 8 * slot);
    if (Q8 && c == NC - 1) mbar_arrive(w.vfull0 + 8 * vslot);
  }
}

// the two consumer warpgroups: warpgroup wg owns rows 64 wg .. 64 wg + 63 of
// the CTA over the rank's blocks and every chunk; returns its O (o[c]: dims
// 128 c + 8 i + 2 t4 + (e & 1) of rows a, b as o[c][4i + e]) and (m, l) of
// rows a and b. CAP: the softcap, as prefill_consumers' (cap.x = scale /
// softcap, cap.y = softcap * log2 e). PART 1 (the producer alone,
// csrc/flash_prefill_probe.cu): every item waited for and released unread
template <int NC, bool CAP, int PART = 0>
__device__ __forceinline__ void wide_consumers(const WideCta& w, const PrefillWideArgs& wa,
                                               float2 cap, float (&o)[NC][64], float& ma,
                                               float& mb, float& la, float& lb) {
  using L = WideSmem<NC>;
  const PrefillArgs& a = wa.a;
  const int Dk = a.D, G = a.G, h = w.h, row0 = w.row0;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int gid = lane >> 2, t4 = lane & 3;
  const int ra = 64 * wg + 16 * warp + gid, rb = ra + 8;  // this thread's rows of the CTA
  if constexpr (PART == 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[c][i] = 0.f;
    ma = mb = FP_NEG * LOG2E;
    la = lb = 0.f;
#pragma unroll 1
    for (int ib = 0; ib < w.b1 - w.b0; ++ib) {
      for (int c = 0; c < NC; ++c) {
        const int it = ib * NC + c;
        mbar_wait(w.full0 + 8 * (it % L::NR), (it / L::NR) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(w.empty0 + 8 * (it % L::NR));
      }
      mbar_wait(w.vfull0 + 8 * (ib % L::NV), (ib / L::NV) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(w.vempty0 + 8 * (ib % L::NV));
    }
    return;
  }

  // q and q_rot: NC = 1, A fragments of rows a, b ([q / q_rot][16-dim
  // step]); NC = 2, the warpgroup's 64 rows into shared memory
  uint32_t qf[NC == 1 ? 2 : 1][8][4];
  const uint32_t qbase = w.smem_a + wg * 2 * NC * 2 * FW_QPIECE;
  if constexpr (NC == 1) {
    const int Ra = row0 + ra, Rb = row0 + rb;
    const bool oka = Ra / G < a.T, okb = Rb / G < a.T;
    const size_t offa = ((size_t)(Ra / G) * a.H + h * G + Ra % G) * Dk + 2 * t4;
    const size_t offb = ((size_t)(Rb / G) * a.H + h * G + Rb % G) * Dk + 2 * t4;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const __nv_bfloat16* src = v ? a.qr : a.q;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const bool lo = 16 * ks < Dk, hi = 16 * ks + 8 < Dk;
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
  } else {
    uint8_t* const qs = w.smem + wg * 2 * NC * 2 * FW_QPIECE;
    const int tid = threadIdx.x & 127;
#pragma unroll 4
    for (int i = tid; i < 64 * 2 * NC * 16; i += 128) {
      const int g8 = i % (NC * 16), v = (i / (NC * 16)) & 1, r = i / (2 * NC * 16);
      const int R = row0 + 64 * wg + r, t = R / G;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (t < a.T && 8 * g8 < Dk)
        x = __ldg(reinterpret_cast<const uint4*>((v ? a.qr : a.q) +
                                                 ((size_t)t * a.H + h * G + R % G) * Dk +
                                                 8 * g8));
      const int cc = g8 >> 4;
      *reinterpret_cast<uint4*>(qs + (v * NC + cc) * 2 * FW_QPIECE +
                                fw_off(r, g8 & 15, FW_QPIECE)) = x;
    }
    fence_proxy_async();  // the generic writes before wgmma reads them
    asm volatile("bar.sync %0, 128;\n" ::"r"(4 + wg) : "memory");
  }

  const float* bra = a.bias + (size_t)min((row0 + ra) / G, a.T - 1) * a.S;
  const float* brb = a.bias + (size_t)min((row0 + rb) / G, a.T - 1) * a.S;
  float ba[8], bb[8];
  fw_load_bias(ba, bb, bra, brb, w.b0 * FW_SB + 2 * t4, a.S);

#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[c][i] = 0.f;
  ma = mb = FP_NEG * LOG2E;
  la = lb = 0.f;
  const float scale2 = a.scale * LOG2E;
  const float NINF = __int_as_float(0xff800000u);

  // the two warpgroups take turns to issue their chains (named barriers 2
  // and 3), so that one's softmax runs under the other's chain
  const int turn = 2 + wg, other = 3 - wg;
  if (wg == 1 && w.b0 < w.b1) named_arrive(2);  // warpgroup 0 issues first
#pragma unroll 1
  for (int b = w.b0; b < w.b1; ++b) {
    const int ib = b - w.b0, sb = b * FW_SB;
    float acc[32];
    named_sync(turn);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int it = ib * NC + c, slot = it % L::NR;
      mbar_wait(w.full0 + 8 * slot, (it / L::NR) & 1);
      const uint32_t st = w.smem_a + L::PLANES + slot * FW_SLOT;
      // q . [kc_hi | kc_lo] and q_rot . [ks_hi | ks_lo] of chunk c, 64 columns each
#pragma unroll
      for (int cs = 0; cs < 2; ++cs)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bd = x_desc(st + (hh * 2 + cs) * 2 * FW_HALF + kk * 32);
            const int more = (c | cs | hh | kk) ? 1 : 0;
            if constexpr (NC == 1)
              wgmma_s(acc, qf[cs][4 * hh + kk], bd, more);
            else
              wgmma_s64_ss(acc,
                           x_desc(qbase + (cs * NC + c) * 2 * FW_QPIECE + hh * FW_QPIECE +
                                  kk * 32),
                           bd, more);
          }
      wg_commit();
    }
    named_arrive(other);
    // each chunk's slot goes back to the producer as its chain retires (no
    // proxy fence: only wgmma read it, and wait_group has seen those reads)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (NC == 2 && c == 0)
        wg_wait<1>();
      else
        wg_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(w.empty0 + 8 * ((ib * NC + c) % L::NR));
    }
    fence_regs(acc);
    float sc[16];  // the hi and lo halves' sums
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = acc[i] + acc[16 + i];

    // sc[4i + e]: row (e < 2 ? a : b), cell sb + 8 i + 2 t4 + (e & 1), in
    // log2 units as prefill_consumers takes them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (CAP) {
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
    if (sb + FW_SB > a.S) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (sb + 8 * (i >> 2) + 2 * t4 + (i & 1) >= a.S) sc[i] = NINF;
    }
    if (b + 1 < w.b1) fw_load_bias(ba, bb, bra, brb, sb + FW_SB + 2 * t4, a.S);
    float mxa = fmaxf(fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[4], sc[5])),
                      fmaxf(fmaxf(sc[8], sc[9]), fmaxf(sc[12], sc[13])));
    float mxb = fmaxf(fmaxf(fmaxf(sc[2], sc[3]), fmaxf(sc[6], sc[7])),
                      fmaxf(fmaxf(sc[10], sc[11]), fmaxf(sc[14], sc[15])));
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 2));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 2));
    const float na = fmaxf(ma, mxa), nb = fmaxf(mb, mxb);
    const float alpha_a = ex2(ma - na), alpha_b = ex2(mb - nb);
    const bool moved = __any_sync(0xffffffffu, na != ma || nb != mb);
    ma = na;
    mb = nb;
    float sum2[2][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[4 * i + 0] = ex2(sc[4 * i + 0] - na);
      sc[4 * i + 1] = ex2(sc[4 * i + 1] - na);
      sc[4 * i + 2] = ex2(sc[4 * i + 2] - nb);
      sc[4 * i + 3] = ex2(sc[4 * i + 3] - nb);
      const float pa = sc[4 * i + 0] + sc[4 * i + 1], pb = sc[4 * i + 2] + sc[4 * i + 3];
      sum2[i & 1][0] = i < 2 ? pa : sum2[i & 1][0] + pa;
      sum2[i & 1][1] = i < 2 ? pb : sum2[i & 1][1] + pb;
    }
    float suma = sum2[0][0] + sum2[1][0], sumb = sum2[0][1] + sum2[1][1];
    suma += __shfl_xor_sync(0xffffffffu, suma, 1);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, 1);
    suma += __shfl_xor_sync(0xffffffffu, suma, 2);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, 2);
    if (moved) {
      la *= alpha_a;
      lb *= alpha_b;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          o[c][4 * i + 0] *= alpha_a;
          o[c][4 * i + 1] *= alpha_a;
          o[c][4 * i + 2] *= alpha_b;
          o[c][4 * i + 3] *= alpha_b;
        }
    }
    la += suma;
    lb += sumb;
    // P_hi / P_lo as A fragments: 16-cell step j is accumulator columns
    // 8 (2j) .. 8 (2j + 1) + 7
    uint32_t ph[2][4], plo[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 2 * j + (r >> 1), e = 2 * (r & 1);
        split_hilo(sc[4 * i + e], sc[4 * i + e + 1], ph[j][r], plo[j][r]);
      }
    // P.V, chunk by chunk of V's dims
    const int vslot = ib % L::NV;
    mbar_wait(w.vfull0 + 8 * vslot, (ib / L::NV) & 1);
    const uint32_t vst = w.smem_a + L::V + vslot * NC * FW_CHUNK;
    named_sync(turn);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t vd = fw_v_desc(vst + c * FW_CHUNK + j * 16 * 128);
        wgmma_o(o[c], ph[j], vd);
        wgmma_o(o[c], plo[j], vd);
      }
    wg_commit();
    if (wg == 0 || b + 1 < w.b1) named_arrive(other);  // warpgroup 1's last turn is the last
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(w.vempty0 + 8 * vslot);
  }
}

// the CTA: grid (128-row tiles x split, Hkv), clusters of `split` CTAs
// along x, rank r taking blocks [r bpr, (r + 1) bpr); bars: 3 NR + 2 NV
// mbarriers. PART 0: the library's kernel; 1, 2: one side alone (probe)
template <bool Q8, int NC, bool CAP, int PART = 0>
__device__ __forceinline__ void wide_cta(const CUtensorMap* tmk, const CUtensorMap* tmv,
                                         const CUtensorMap* tmc, const CUtensorMap* tms,
                                         const PrefillWideArgs& wa, float2 cap,
                                         uint8_t* dyn_smem, uint64_t* bars) {
  using L = WideSmem<NC>;
  const PrefillArgs& a = wa.a;
  WideCta w;
  const uint32_t raw_ = smem_u32(dyn_smem);
  w.smem = dyn_smem + (((raw_ + 1023) & ~1023u) - raw_);
  w.smem_a = smem_u32(w.smem);
  w.full0 = smem_u32(&bars[0]);
  w.empty0 = smem_u32(&bars[L::NR]);
  w.raw0 = smem_u32(&bars[2 * L::NR]);
  w.vfull0 = smem_u32(&bars[3 * L::NR]);
  w.vempty0 = smem_u32(&bars[3 * L::NR + L::NV]);
  w.h = blockIdx.y;
  w.rank = blockIdx.x % wa.split;
  w.row0 = (blockIdx.x / wa.split) * FW_ROWS;
  const int nblk = (a.S + FW_SB - 1) / FW_SB;
  w.b0 = min(nblk, w.rank * wa.bpr);
  w.b1 = min(nblk, w.b0 + wa.bpr);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::NR; ++s) {
      mbar_init(w.full0 + 8 * s, 128);                 // the producer's lanes
      mbar_init(w.empty0 + 8 * s, FP_CONSUMERS / 32);  // the consumers' warps
      mbar_init(w.raw0 + 8 * s, 1 + (Q8 && (wa.kcp || wa.vcp) ? 128 : 0));
    }
    for (int s = 0; s < L::NV; ++s) {
      mbar_init(w.vfull0 + 8 * s, Q8 ? 128 : 1);
      mbar_init(w.vempty0 + 8 * s, FP_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int C = wa.split;
  if (threadIdx.x >= FP_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FW_PRODUCER_REGS));
    wide_producer<Q8, NC, PART>(w, tmk, tmv, tmc, tms, wa);
    if (C > 1) {  // the producer's part in the consumers' two cluster barriers
      cluster_sync_all();
      cluster_sync_all();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FW_CONSUMER_REGS));
  float o[NC][64], ma, mb, la, lb;
  wide_consumers<NC, CAP, PART>(w, wa, cap, o, ma, mb, la, lb);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int t4 = lane & 3;
  const int ra = 64 * wg + 16 * warp + (lane >> 2), rb = ra + 8;
  const int Dv = wa.Dv, G = a.G, h = w.h;
  if (C == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int R = w.row0 + (half ? rb : ra), t = R / G;
      if (t >= a.T) continue;
      const float inv = 1.f / fmaxf(half ? lb : la, 1e-30f);
      float* dst = a.out + ((size_t)t * a.H + h * G + R % G) * Dv + 2 * t4;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (128 * c + 8 * i < Dv)
            *reinterpret_cast<float2*>(dst + 128 * c + 8 * i) =
                make_float2(o[c][4 * i + 2 * half] * inv, o[c][4 * i + 2 * half + 1] * inv);
    }
    return;
  }
  // the S split: once both warpgroups' last wgmma retired (every item was
  // consumed), the ring holds this CTA's partials: O (unnormalized), m and l
  asm volatile("bar.sync 6, 256;\n" ::: "memory");
  constexpr int DP = NC * 128;
  float* po = reinterpret_cast<float*>(w.smem);
  float* pm = reinterpret_cast<float*>(w.smem + L::P_M);
  float* pl = reinterpret_cast<float*>(w.smem + L::P_L);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<float2*>(po + r * DP + 128 * c + 8 * i + 2 * t4) =
            make_float2(o[c][4 * i + 2 * half], o[c][4 * i + 2 * half + 1]);
    if (t4 == 0) {
      pm[r] = half ? mb : ma;
      pl[r] = half ? lb : la;
    }
  }
  cluster_sync_all();
  // CTA `rank` writes rows [rank RS, rank RS + RS) over every rank's
  // partials, the ranks in rank order
  const int RS = (FW_ROWS + C - 1) / C, r0 = w.rank * RS;
  const int nr = max(0, min(FW_ROWS, r0 + RS) - r0);
  float* xm = reinterpret_cast<float*>(w.smem + L::X_M);
  float* xl = reinterpret_cast<float*>(w.smem + L::X_L);
  for (int i = threadIdx.x; i < C * nr; i += FP_CONSUMERS) {
    const int q = i / nr, r = r0 + i % nr;
    xm[q * FW_ROWS + r] = ld_dsmem(smem_u32(pm + r), q);
    xl[q * FW_ROWS + r] = ld_dsmem(smem_u32(pl + r), q);
  }
  asm volatile("bar.sync 6, 256;\n" ::: "memory");
  for (int i = threadIdx.x; i < nr * Dv; i += FP_CONSUMERS) {
    const int r = r0 + i / Dv, d = i % Dv, R = w.row0 + r, t = R / G;
    if (t >= a.T) continue;
    float M = xm[r];
    for (int q = 1; q < C; ++q) M = fmaxf(M, xm[q * FW_ROWS + r]);
    float ov[FW_MAX_SPLIT];  // every rank's O of the element in flight at once
#pragma unroll
    for (int q = 0; q < FW_MAX_SPLIT; ++q)
      if (q < C) ov[q] = ld_dsmem(smem_u32(po + r * DP + d), q);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int q = 0; q < FW_MAX_SPLIT; ++q) {
      if (q < C) {
        const float e = ex2(xm[q * FW_ROWS + r] - M);
        Ls += xl[q * FW_ROWS + r] * e;
        A += ov[q] * e;
      }
    }
    a.out[((size_t)t * a.H + h * G + R % G) * Dv + d] = A / fmaxf(Ls, 1e-30f);
  }
  cluster_sync_all();  // no CTA leaves while another reads its partials
}

// a tiled map of a row-major bf16 or byte array [heads][rows][D] in boxes
// of FW_SB rows: a box's columns past D read as zero
int fw_map(CUtensorMap* m, CUtensorMapDataType dt, int rank, const void* base, int es,
           cuuint64_t D, cuuint64_t rows, cuuint64_t heads, CUtensorMapSwizzle swz,
           cuuint32_t box0) {
  const cuuint64_t dims[3] = {D, rows, heads};
  const cuuint64_t strides[2] = {D * es, rows * D * es};
  const cuuint32_t box[3] = {box0, FW_SB, 1};
  return make_map(m, dt, rank, base, dims, strides, box, swz);
}


// the maps of K, V, cos and sin: [0] K, [1] V (K4's in the 128-byte
// swizzle, 64 dims a box), [2] cos, [3] sin; K4q rows by cp.async get none
template <bool Q8>
int wide_maps(const PrefillWideArgs& w, CUtensorMap (&m)[4]) {
  const PrefillArgs& a = w.a;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  const cuuint64_t S = a.S, Hkv = a.Hkv, Dk = a.D, Dv = w.Dv;
  memset(m, 0, sizeof(m));
  int rc = 0;
  if (!w.kcp)
    rc = Q8 ? fw_map(&m[0], u8, 3, a.k, 1, Dk, S, Hkv, none, 128)
            : fw_map(&m[0], bf, 3, a.k, 2, Dk, S, Hkv, none, 128);
  if (!rc && !w.vcp)
    rc = Q8 ? fw_map(&m[1], u8, 3, a.v, 1, Dv, S, Hkv, none, 128)
            : fw_map(&m[1], bf, 3, a.v, 2, Dv, S, Hkv, CU_TENSOR_MAP_SWIZZLE_128B, 64);
  if (!rc) rc = fw_map(&m[2], bf, 2, a.cs, 2, Dk, S, 1, none, 128);
  if (!rc) rc = fw_map(&m[3], bf, 2, a.sn, 2, Dk, S, 1, none, 128);
  return rc;
}

// w with its blocks a rank, or false where the launcher refuses it
inline bool wide_args_ok(PrefillWideArgs& w, float softcap) {
  const PrefillArgs& a = w.a;
  const int nblk = (a.S + FW_SB - 1) / FW_SB;
  if (a.D < 8 || a.D > 256 || a.D % 8 || w.Dv < 8 || w.Dv > 256 || w.Dv % 8 || a.H % a.Hkv ||
      !(softcap >= 0.f) || w.split < 1 || w.split > FW_MAX_SPLIT || w.split > nblk)
    return false;
  w.bpr = (nblk + w.split - 1) / w.split;
  return true;
}

// kern on the grid (128-row tiles x split, Hkv) in clusters of split along x
template <typename Kern, typename... Args>
int launch_wide_cluster(Kern kern, int smem, const PrefillWideArgs& w, cudaStream_t st,
                        Args... args) {
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(((w.a.T * w.a.G + FW_ROWS - 1) / FW_ROWS) * w.split, w.a.Hkv, 1);
  cfg.blockDim = dim3(FP_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = w.split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace
