// K1/K2/K7's decode GEMV (B <= 16) for Hopper (sm_90a): the B <= 16
// regime of llm_tpu/ops/pallas_qmm.py::qmm_pallas -> _qmm_kernel_p4 /
// _p4_m (K1), _qmm_kernel_i8 / _i8_m (K2), and their stacked mode
// qmm_pallas(lidx=...) (K7); with GDOT, K5 (_qmm_gdot_call -> _gdot_kernel,
// and its stacked mode, K7's K5 variant); and the CTA body that K6
// (qmm_chain.cu) runs phase after phase. It computes
//
//   y[b,n] = sum_k x[b,k] * (q[k,n] - zp) * s[k/gs,n]  -  sum_g xsum[b,g] * m[g,n]
//
// with x bf16 [B, K], the planes K-major (p4 uint8 [K/2, N] in 256-row pack
// tiles: packed row t holds k = t in its low nibble and k = t + 128 in its
// high nibble; or i8 [K, N]), s and m [K/gs, N] in bf16 or f32, and y
// [B, N] written in f32 or bf16 (one round-to-nearest of the f32 sum).
// p4 planes have group size 32 or 16 (Q2_K, Q3_K: the kernels
// qmm_decode_g16 and qmm_decode_gdot_g16, the same CTA with 4 group rows of
// scales and mins for each 64-k x chunk, each k16 step a group) or 256
// (TQ1_0, TQ2_0: qmm_decode_g256 and qmm_decode_gdot_g256, one group row a
// stage, dv_consume_gx); i8 planes 32, 16 or 8 (IQ1_M: qmm_decode_g8, 16
// group rows a stage, two m16n8k8 products a k16 step, dv_consume_gx).
//
// Bound: the planes' bytes (0.5 B a weight p4, 1 B i8, plus scales and
// mins), a few hundred times more than its operations need at B <= 16.
//
// Exact group arithmetic on the tensor cores. q - zp is an integer that
// bf16 holds exactly, and x is bf16, so a matrix product of x with the
// integer plane, accumulated in f32 over one quant group (P_g), times
// s[g,n] in f32, is K1's sum in another order; the mins term is
// - xsum[b,g] * m[g,n] in f32, with xsum the f32 sum of the bf16 x (a
// product of x with a block of ones on the same tensor cores). Nothing is
// rounded to bf16 on the way (tests/test_torch_qmm_decode.py holds the
// order against qmm_plain and the TPU kernel). K5 (GDOT, p4 only) is the
// TPU gdot kernel's group-factored form of the same sum: the A operand is
// the raw nibble (128 + nib minus 128), P'_g is folded with the f32 s[g],
// and then either the mins or the zero-point correction, -bf16(m[g]) *
// bf16(xsum) or -zp * bf16(xsum) * bf16(s[g]), their operands rounded to
// bf16 as the TPU kernel's rank-G dots round them (fold_group;
// tests/test_torch_gdot_decode.py). Its kernels (qmm_decode_gdot) are
// their own instantiations of the same CTA (dv_cta), so K1/K2/K7's keep
// their machine code; the bytes read, and so the bound, are K1's. The
// integer operands:
//  * p4: byte_perm puts the bytes of two adjacent plane rows (k, k + 1) of
//    one column into the two halves of a word, a LOP3 turns each half's
//    nibble into the bf16 0x4300 | nib = 128 + nib, and one bf16x2
//    subtract of 128 + zp leaves q - zp; the high nibbles (k + 128, the
//    group four rows on) come from the same bytes after one shift, so every
//    packed byte is read from device memory once and feeds two groups,
//    each with its own accumulators;
//  * i8: 2^23 + byte (sign bit flipped) as an f32 by byte_perm, minus
//    2^23 + 128 + zp (hopper.cuh q_of), then cvt.rn.bf16x2.f32: exact for
//    |q - zp| <= 256.
//
// Shape of the kernel:
//  * a CTA computes 128 columns of y for all B <= 16 rows over a range of
//    K; the planes are read once whatever B is (one launch a qmm call).
//    160 threads: four consumer warps (two column halves of 64, times two
//    that take the stages in turns) and a producer warp.
//  * a stage is 128 k: the plane rows that hold them (p4: 64 packed rows,
//    whose low and high nibbles are k0..k0+63 and k0+128..k0+191; i8: 128
//    rows) as 128 columns in the 128-byte swizzle, two 64-k chunks of x
//    (8 or 16 rows, 128-byte swizzle; rows past B read as zero) and the
//    stage's group rows of scales and mins. The producer's lane 0 keeps a
//    ring of 2 or 4 stages in flight with TMA (cp.async.bulk.tensor, mbarrier
//    completion) wherever the planes' strides allow it (N % 16 == 0: every
//    main-path shape); otherwise (N = 264, 1000, ...) its 32 lanes gather
//    the plane and group rows with bounds checks into the same layout. The
//    consumers issue no global load. K7 reads its layer index on the card:
//    the plane maps are 3-D [L, rows, N] and take it as a coordinate.
//  * mma.sync m16n8k16 (bf16 in, f32 accumulate): A = 16 columns of the
//    integer plane x 16 k, built in registers from one 8-byte shared load
//    per plane row and thread, B = x (8 rows; two n8 blocks at B > 8). A
//    thread's A rows g and g + 8 of the four m16 tiles are the 8 adjacent
//    columns 8g..8g+7 of its warp's 64, so its scales and mins come in one
//    or two 16-byte loads. mma.sync rather than wgmma: at B <= 16 a
//    wgmma's 64-row operand would be x padded 4-8x, or the weights would
//    have to go back to shared memory for the A side; mma.sync takes the
//    weights from registers at n = 8 and uses under half of the tensor
//    cores' mma.sync rate at the bytes bound.
//  * a consumer warp hands a stage's slot back (dv_release) only after
//    fence.proxy.async: its lanes read the slot through the generic proxy
//    (ld.shared) and the producer's next TMA writes it through the async
//    proxy, an order that the mbarrier's release and acquire alone do not
//    give. Without the fence, qmm_decode_g16 on Q3_K planes read the last
//    k16 step's x fragments of the second chunk from the next round's TMA
//    now and then (a y off by that step's share on 40-50 of 6000 launches).
//  * the K split: the CTAs of one column tile form a thread block cluster
//    (up to 16, the split chosen by ops/cuda_qmm.py::decode_plan). Each CTA
//    leaves its partial tile in shared memory; after a cluster barrier,
//    CTA r sums slice r of the tile over every CTA of the cluster in rank
//    order through distributed shared memory and writes it to y. No
//    memset, no atomics: y is bit-identical from launch to launch, and K7
//    equals K1/K2 on the same layer bit for bit.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int DV_TILE_N = 128;                 // columns of y per CTA
constexpr int DV_UNIT_K = 128;                 // k per stage
constexpr int DV_CONSUMERS = 128;              // four consumer warps
constexpr int DV_THREADS = DV_CONSUMERS + 32;  // and a producer warp
constexpr int DV_MAX_B = 16;                   // rows of x
constexpr int DV_MAX_CLUSTER = 16;             // non-portable cluster size
constexpr int DV_RAGGED_ARRIVALS = 33;         // lane 0's expect_tx, then all 32 lanes
constexpr int DV_RING_MAX = 96 * 1024;         // a ring of 4 stages up to this size
constexpr int DV_RING_MAX_G8 = 120 * 1024;     // the same at group size 8 (i8)

// GX: the group-size forms of their own, 256 (p4) or 8 (i8); 0 otherwise
template <bool P4, bool SBF16, bool MINS, bool G16 = false, int GX = 0>
struct DecodeSmem {
  static constexpr int W_ROWS = P4 ? 64 : 128;          // plane rows of a stage
  static constexpr int W_BYTES = W_ROWS * DV_TILE_N;    // 128 columns of them
  static constexpr int X_CHUNK = DV_MAX_B * 64 * 2;     // 16 rows x 64 k of bf16
  static constexpr int ES = SBF16 ? 2 : 4;
  // group rows (i8: gs 16 or 32; GX 256: one for the stage; GX 8: 16)
  static constexpr int G_ROWS = GX == 256 ? 1 : GX == 8 ? 16 : P4 ? 2 * P4Groups<G16>::CG : 8;
  static constexpr int G_BYTES = G_ROWS * DV_TILE_N * ES;
  static constexpr int X_OFF = W_BYTES;                 // 1024-aligned
  static constexpr int S_OFF = X_OFF + 2 * X_CHUNK;
  static constexpr int M_OFF = S_OFF + G_BYTES;
  static constexpr int STAGE = (M_OFF + (MINS ? G_BYTES : 0) + 1023) / 1024 * 1024;
  // even: slot s is always taken by consumer pair s % 2, so no pair waits
  // on a slot's phase while the other pair still holds its earlier one
  static constexpr int STAGES = 4 * STAGE <= (GX == 8 ? DV_RING_MAX_G8 : DV_RING_MAX) ? 4 : 2;
  static constexpr int RED = 2 * DV_MAX_B * DV_TILE_N * 4;  // [2][16][128] f32 partials
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BYTES = (RING > RED ? RING : RED) + 1024;  // + slack to align to 1024
};

struct DecodeArgs {
  const uint8_t* qs;  // the planes (layer 0 of a stack), read directly on the ragged path
  const void* sc;
  const void* mn;
  void* y;
  const int* lidx;        // K7: the layer index in device memory; null for K1/K2
  long long qs_ls, s_ls;  // bytes from one layer's qs / scales (= mins) to the next
  int B, K, N, gs, zp, upr, tma_w, out_bf16;  // upr: stages (units of 128 k) a CTA
};

template <int NB8, int J>
__device__ __forceinline__ void zero_acc(float (&p)[NB8][J][4]) {
#pragma unroll
  for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nb][j][e] = 0.f;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t f2_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float rn_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a thread's 8 adjacent columns' values of one group row (col % 8 == 0)
template <bool SBF16>
__device__ __forceinline__ void ld_eight(const uint8_t* row, int col, float (&v)[8]) {
  if (SBF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + col * 2);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
    const float4 a = *reinterpret_cast<const float4*>(row + col * 4);
    const float4 b = *reinterpret_cast<const float4*>(row + col * 4 + 16);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// a consumer warp gives slot `empty`'s stage back to the producer: every
// lane's reads of the slot (generic proxy) are performed before the TMA
// that refills it (async proxy) can write, then one arrival for the warp
__device__ __forceinline__ void dv_release(uint32_t empty, int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// the ragged path: the producer's lanes gather a stage's plane rows ...
template <bool P4, bool SBF16, bool MINS>
__device__ __forceinline__ void dv_gather_rows(uint8_t* w, const uint8_t* qs, int lane, int n0,
                                               int row0, const DecodeArgs& a) {
  using L = DecodeSmem<P4, SBF16, MINS>;
  const int R = P4 ? a.K / 2 : a.K;
  for (int i = lane; i < L::W_ROWS * (DV_TILE_N / 4); i += 32) {
    const int r = i / (DV_TILE_N / 4), c4 = (i % (DV_TILE_N / 4)) * 4;
    uint32_t v = 0;
    if (row0 + r < R) {
      const uint8_t* src = qs + (size_t)(row0 + r) * a.N;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + c4 + e < a.N) v |= (uint32_t)src[n0 + c4 + e] << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(w + swz(r, c4)) = v;
  }
}

// ... and its group rows of scales or mins (p4: CG rows from each x chunk,
// GX 256: the one row of both; i8: 128 / gs rows)
template <bool P4, bool SBF16, bool MINS, bool G16 = false, int GX = 0>
__device__ __forceinline__ void dv_gather_groups(uint8_t* s, const void* src, int lane, int n0,
                                                 int kx0, int kx1, const DecodeArgs& a) {
  using L = DecodeSmem<P4, SBF16, MINS, G16, GX>;
  constexpr int CG = P4Groups<G16>::CG, GS = P4Groups<G16>::GS;
  const int G = a.K / a.gs, rows = GX == 256 ? 1 : P4 ? 2 * CG : DV_UNIT_K / a.gs;
  for (int i = lane; i < L::G_ROWS * DV_TILE_N; i += 32) {
    const int gr = i / DV_TILE_N, n = n0 + i % DV_TILE_N;
    const int g = GX == 256 ? kx0 / 256
                  : P4 ? (gr < CG ? kx0 / GS + gr : kx1 / GS + gr - CG) : kx0 / a.gs + gr;
    const bool ok = gr < rows && g < G && n < a.N;
    if (SBF16)
      reinterpret_cast<uint16_t*>(s)[i] =
          ok ? reinterpret_cast<const uint16_t*>(src)[(size_t)g * a.N + n] : 0;
    else
      reinterpret_cast<uint32_t*>(s)[i] =
          ok ? reinterpret_cast<const uint32_t*>(src)[(size_t)g * a.N + n] : 0;
  }
}

// the producer warp: stages [u0, u1) of this CTA's column tile n0
template <bool P4, bool SBF16, bool MINS, bool G16 = false, int GX = 0>
__device__ __forceinline__ void dv_producer(const CUtensorMap* tmx, const CUtensorMap* tmw,
                                            const CUtensorMap* tms, const CUtensorMap* tmm,
                                            const DecodeArgs& a, uint8_t* smem, uint32_t full0,
                                            uint32_t empty0, int n0, int u0, int u1) {
  using L = DecodeSmem<P4, SBF16, MINS, G16, GX>;
  constexpr int CG = P4Groups<G16>::CG, GS = P4Groups<G16>::GS;
  const int lane = threadIdx.x & 31;
  if (a.tma_w && lane != 0) return;
  const int layer = a.lidx != nullptr ? __ldg(a.lidx) : 0;
  const uint8_t* qs = a.qs + (long long)layer * a.qs_ls;
  const void* sc = static_cast<const char*>(a.sc) + (long long)layer * a.s_ls;
  const void* mn =
      MINS ? static_cast<const void*>(static_cast<const char*>(a.mn) + (long long)layer * a.s_ls)
           : nullptr;
  const int xr = a.B > 8 ? 16 : 8;                   // x rows a chunk's box brings
  const int g_rows = GX == 256 ? 1 : P4 ? 2 * CG : DV_UNIT_K / a.gs;  // group rows a stage
  const uint32_t tx = 2 * 64 * xr * 2 +
                      (a.tma_w ? L::W_BYTES + g_rows * DV_TILE_N * L::ES * (MINS ? 2 : 1) : 0);
  const uint32_t smem_a = smem_u32(smem);
  for (int j = 0; j < u1 - u0; ++j) {
    const int slot = j % L::STAGES;
    if (j >= L::STAGES) mbar_wait(empty0 + 8 * slot, ((j / L::STAGES) - 1) & 1);
    const int u = u0 + j;
    // the two x chunks and the plane rows of this stage (p4: the chunks are
    // the low and high nibbles of the same 64 packed rows)
    const int kx0 = P4 ? 256 * (u >> 1) + 64 * (u & 1) : DV_UNIT_K * u;
    const int kx1 = kx0 + (P4 ? 128 : 64);
    const int row0 = P4 ? 128 * (u >> 1) + 64 * (u & 1) : DV_UNIT_K * u;
    const uint32_t st = smem_a + slot * L::STAGE, full = full0 + 8 * slot;
    if (lane == 0) {
      mbar_expect_tx(full, tx);
      tma_2d(st + L::X_OFF, tmx, full, kx0, 0);
      tma_2d(st + L::X_OFF + L::X_CHUNK, tmx, full, kx1, 0);
      if (a.tma_w) {
        tma_3d(st, tmw, full, n0, row0, layer);
        if (GX == 256) {  // both chunks are in group kx0 / 256
          tma_3d(st + L::S_OFF, tms, full, n0, kx0 / 256, layer);
          if (MINS) tma_3d(st + L::M_OFF, tmm, full, n0, kx0 / 256, layer);
        } else if (P4) {
          const int half = CG * DV_TILE_N * L::ES;
          tma_3d(st + L::S_OFF, tms, full, n0, kx0 / GS, layer);
          tma_3d(st + L::S_OFF + half, tms, full, n0, kx1 / GS, layer);
          if (MINS) {
            tma_3d(st + L::M_OFF, tmm, full, n0, kx0 / GS, layer);
            tma_3d(st + L::M_OFF + half, tmm, full, n0, kx1 / GS, layer);
          }
        } else {
          tma_3d(st + L::S_OFF, tms, full, n0, kx0 / a.gs, layer);
          if (MINS) tma_3d(st + L::M_OFF, tmm, full, n0, kx0 / a.gs, layer);
        }
      }
    }
    if (!a.tma_w) {
      uint8_t* stp = smem + slot * L::STAGE;
      dv_gather_rows<P4, SBF16, MINS>(stp, qs, lane, n0, row0, a);
      dv_gather_groups<P4, SBF16, MINS, G16, GX>(stp + L::S_OFF, sc, lane, n0, kx0, kx1, a);
      if (MINS)
        dv_gather_groups<P4, SBF16, MINS, G16, GX>(stp + L::M_OFF, mn, lane, n0, kx0, kx1, a);
      mbar_arrive(full);
    }
  }
}

// x's B fragments of one k16 step of a chunk for both n8 blocks: rows g and
// g + 8, k = k16 + 2t (+1) and + 8
template <int NB8>
__device__ __forceinline__ void ld_xfrag(const uint8_t* chunk, int k16, int g, int t,
                                         uint32_t (&b)[NB8][2]) {
#pragma unroll
  for (int nb = 0; nb < NB8; ++nb) {
    const int r = g + 8 * nb;
    b[nb][0] = *reinterpret_cast<const uint32_t*>(chunk + swz(r, 2 * k16 + 4 * t));
    b[nb][1] = *reinterpret_cast<const uint32_t*>(chunk + swz(r, 2 * k16 + 16 + 4 * t));
  }
}

// acc += s * P - m * X over a thread's accumulators: m16 tile j holds the
// thread's columns 2j (c0, c1) and 2j + 1 (c2, c3) of its eight; X's c0/c1
// are the group sums of x's rows 2t, 2t + 1 (every row of a ones product is
// the same). GDOT (K5): P is the product with the raw nibbles, and the mins
// or the zero-point correction takes its operands rounded to bf16, as the
// TPU kernel's rank-G dots do: acc += s * P' - bf16(m) * bf16(X), or (no
// mins) acc += s * P' - zp * bf16(X) * bf16(s), which adds nothing at zp = 0
// (K5 takes no planes with both)
template <int NB8, bool MINS, bool GDOT = false>
__device__ __forceinline__ void fold_group(float (&acc)[NB8][4][4], const float (&p)[NB8][4][4],
                                           const float (&xs)[NB8][1][4], const float (&s)[8],
                                           const float (&m)[8], float zp = 0.f) {
#pragma unroll
  for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * j + (e >> 1);
        float v = fmaf(s[c], p[nb][j][e], acc[nb][j][e]);
        if constexpr (GDOT) {
          const float xg = rn_bf16(xs[nb][0][e & 1]);
          if (MINS) v = fmaf(-rn_bf16(m[c]), xg, v);
          else v = fmaf(-zp * xg, rn_bf16(s[c]), v);
        } else if (MINS) {
          v = fmaf(-m[c], xs[nb][0][e & 1], v);
        }
        acc[nb][j][e] = v;
      }
}

// one consumer warp's share of a stage: columns col0..col0+63 of the tile.
// GDOT (K5, p4): zp2 is 128 (the raw nibbles), zpf the zero point whose
// correction fold_group applies; the group sums of x feed either correction.
// G16 (p4 at group size 16): every k16 step is a group of each chunk
template <bool P4, bool SBF16, bool MINS, int NB8, bool GDOT = false, bool G16 = false>
__device__ __forceinline__ void dv_consume(const uint8_t* stp, int col0, int gs, uint32_t zp2,
                                           float ibase, float (&acc)[NB8][4][4],
                                           float zpf = 0.f) {
  static_assert(!GDOT || P4, "K5 reads p4 planes");
  static_assert(!G16 || P4, "i8 planes take their group size at run time");
  using L = DecodeSmem<P4, SBF16, MINS, G16>;
  constexpr int CG = P4Groups<G16>::CG;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c = col0 + 8 * g;  // the thread's 8 columns within the tile
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
  float s[8], m[8];
  if constexpr (P4) {
    // 4 k16 steps of 16 packed rows: low nibbles -> chunk 0 (the stage's
    // group rows 0..CG-1), high nibbles -> chunk 1 (rows CG..2CG-1); a group
    // is two steps (gs 32) or one (G16)
    float plo[NB8][4][4], phi[NB8][4][4], xlo[NB8][1][4], xhi[NB8][1][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * st + 2 * t + (i & 1) + 8 * (i >> 1);
        w[i] = *reinterpret_cast<const uint2*>(stp + swz(r, c));
      }
      uint32_t b0[NB8][2], b1[NB8][2];
      ld_xfrag<NB8>(stp + L::X_OFF, 16 * st, g, t, b0);
      ld_xfrag<NB8>(stp + L::X_OFF + L::X_CHUNK, 16 * st, g, t, b1);
      if (G16 || (st & 1) == 0) {  // a group's first step
        zero_acc<NB8, 4>(plo);
        zero_acc<NB8, 4>(phi);
        zero_acc<NB8, 1>(xlo);
        zero_acc<NB8, 1>(xhi);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t alo[4], ahi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // a[i]: column 2j + (i & 1), rows (k, k + 1) = plane rows 2(i >> 1), +1
          const int cc = 2 * j + (i & 1), by = cc & 3;
          const uint32_t wk = (cc >> 2) ? w[2 * (i >> 1)].y : w[2 * (i >> 1)].x;
          const uint32_t wk1 = (cc >> 2) ? w[2 * (i >> 1) + 1].y : w[2 * (i >> 1) + 1].x;
          const uint32_t p = __byte_perm(wk, wk1, by | ((4 + by) << 8) | (by << 4) | ((4 + by) << 12));
          alo[i] = bf16x2_sub((p & 0x000F000Fu) | 0x43004300u, zp2);  // one LOP3
          ahi[i] = bf16x2_sub(((p >> 4) & 0x000F000Fu) | 0x43004300u, zp2);
        }
#pragma unroll
        for (int nb = 0; nb < NB8; ++nb) {
          mma_bf16(plo[nb][j], alo, b0[nb][0], b0[nb][1]);
          mma_bf16(phi[nb][j], ahi, b1[nb][0], b1[nb][1]);
        }
      }
      if (MINS || GDOT) {
#pragma unroll
        for (int nb = 0; nb < NB8; ++nb) {
          mma_bf16(xlo[nb][0], ones, b0[nb][0], b0[nb][1]);
          mma_bf16(xhi[nb][0], ones, b1[nb][0], b1[nb][1]);
        }
      }
      if (G16 || (st & 1)) {  // the end of a group: its scale (and min) once
        const int gr = G16 ? st : st >> 1;
        ld_eight<SBF16>(stp + L::S_OFF + gr * DV_TILE_N * L::ES, c, s);
        if (MINS) ld_eight<SBF16>(stp + L::M_OFF + gr * DV_TILE_N * L::ES, c, m);
        fold_group<NB8, MINS, GDOT>(acc, plo, xlo, s, m, zpf);
        ld_eight<SBF16>(stp + L::S_OFF + (CG + gr) * DV_TILE_N * L::ES, c, s);
        if (MINS) ld_eight<SBF16>(stp + L::M_OFF + (CG + gr) * DV_TILE_N * L::ES, c, m);
        fold_group<NB8, MINS, GDOT>(acc, phi, xhi, s, m, zpf);
      }
    }
  } else {
    // 8 k16 steps of 16 plane rows; x chunk st / 4; a group is one step
    // (gs 16) or two (gs 32)
    const bool gs16 = gs == 16;
    float pp[NB8][4][4], xx[NB8][1][4];
#pragma unroll
    for (int st = 0; st < 8; ++st) {
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * st + 2 * t + (i & 1) + 8 * (i >> 1);
        w[i] = *reinterpret_cast<const uint2*>(stp + swz(r, c));
        w[i].x ^= 0x80808080u;  // int8 -> byte + 128
        w[i].y ^= 0x80808080u;
      }
      uint32_t b[NB8][2];
      ld_xfrag<NB8>(stp + L::X_OFF + (st >> 2) * L::X_CHUNK, 16 * (st & 3), g, t, b);
      if (gs16 || (st & 1) == 0) {  // a group's first step
        zero_acc<NB8, 4>(pp);
        zero_acc<NB8, 1>(xx);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t aa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cc = 2 * j + (i & 1), by = cc & 3;
          const uint32_t wk = (cc >> 2) ? w[2 * (i >> 1)].y : w[2 * (i >> 1)].x;
          const uint32_t wk1 = (cc >> 2) ? w[2 * (i >> 1) + 1].y : w[2 * (i >> 1) + 1].x;
          aa[i] = f2_bf16x2(q_of(wk, by, ibase), q_of(wk1, by, ibase));
        }
#pragma unroll
        for (int nb = 0; nb < NB8; ++nb)
          mma_bf16(pp[nb][j], aa, b[nb][0], b[nb][1]);
      }
      if (MINS) {
#pragma unroll
        for (int nb = 0; nb < NB8; ++nb)
          mma_bf16(xx[nb][0], ones, b[nb][0], b[nb][1]);
      }
      if (gs16 || (st & 1)) {
        const int gr = gs16 ? st : st >> 1;
        ld_eight<SBF16>(stp + L::S_OFF + gr * DV_TILE_N * L::ES, c, s);
        if (MINS) ld_eight<SBF16>(stp + L::M_OFF + gr * DV_TILE_N * L::ES, c, m);
        fold_group<NB8, MINS>(acc, pp, xx, s, m);
      }
    }
  }
}

// d += A (16 x 8, bf16) x B (8 x 8, bf16): half of a k16 step, a0 / a1 the
// rows g / g + 8 at k = 2t, 2t + 1 and b0 x's at the same k
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// K5's correction of one group from its x sums X (the group's whole k
// range): acc -= bf16(m) * bf16(X), or (no mins) zp * bf16(X) * bf16(s),
// the operands rounded as fold_group's GDOT branch rounds them
template <int NB8, bool MINS>
__device__ __forceinline__ void fold_correction(float (&acc)[NB8][4][4],
                                                const float (&xs)[NB8][1][4], const float (&s)[8],
                                                const float (&m)[8], float zp) {
#pragma unroll
  for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * j + (e >> 1);
        const float xg = rn_bf16(xs[nb][0][e & 1]);
        acc[nb][j][e] = MINS ? fmaf(-rn_bf16(m[c]), xg, acc[nb][j][e])
                             : fmaf(-zp * xg, rn_bf16(s[c]), acc[nb][j][e]);
      }
}

// dv_consume for the group-size forms of their own (GX):
//  * 256, p4 planes (TQ1_0, TQ2_0): one group row holds the scale (and min)
//    of both x chunks of the stage. The products fold every 32 k, as at
//    group size 32, each fold with that one scale (the same sum in another
//    f32 order). K5 (GDOT): the raw nibbles' products fold the same way;
//    its correction needs the group's x sums over all 256 k, which lie in
//    two stages (u even: k0..63 and 128..191 of the pack tile; u odd: the
//    rest), so the consumer pair that takes both (dv_cta) adds them up in
//    xg (half 0 starts it) and applies the correction after the second
//    (half 1);
//  * 8, i8 planes (IQ1_M): a k16 step spans two groups, its 16 group rows a
//    stage; each step runs as two m16n8k8 products (k 0..7 and 8..15), each
//    folded with its own group's scale.
template <bool P4, bool SBF16, bool MINS, int NB8, bool GDOT, int GX>
__device__ __forceinline__ void dv_consume_gx(const uint8_t* stp, int col0, uint32_t zp2,
                                              float ibase, float (&acc)[NB8][4][4],
                                              float (&xg)[NB8][1][4], int half, float zpf) {
  static_assert(GX == 256 ? P4 : (GX == 8 && !P4 && !GDOT), "GX 256: p4; GX 8: i8, no K5");
  using L = DecodeSmem<P4, SBF16, MINS, false, GX>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c = col0 + 8 * g;
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
  float s[8], m[8];
  if constexpr (GX == 256) {
    constexpr bool XM = MINS && !GDOT;  // K1's mins term, folded with the products
    ld_eight<SBF16>(stp + L::S_OFF, c, s);
    if (MINS) ld_eight<SBF16>(stp + L::M_OFF, c, m);
    if (GDOT && half == 0) zero_acc<NB8, 1>(xg);
    float plo[NB8][4][4], phi[NB8][4][4], xlo[NB8][1][4], xhi[NB8][1][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * st + 2 * t + (i & 1) + 8 * (i >> 1);
        w[i] = *reinterpret_cast<const uint2*>(stp + swz(r, c));
      }
      uint32_t b0[NB8][2], b1[NB8][2];
      ld_xfrag<NB8>(stp + L::X_OFF, 16 * st, g, t, b0);
      ld_xfrag<NB8>(stp + L::X_OFF + L::X_CHUNK, 16 * st, g, t, b1);
      if ((st & 1) == 0) {
        zero_acc<NB8, 4>(plo);
        zero_acc<NB8, 4>(phi);
        if (XM) {
          zero_acc<NB8, 1>(xlo);
          zero_acc<NB8, 1>(xhi);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t alo[4], ahi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cc = 2 * j + (i & 1), by = cc & 3;
          const uint32_t wk = (cc >> 2) ? w[2 * (i >> 1)].y : w[2 * (i >> 1)].x;
          const uint32_t wk1 = (cc >> 2) ? w[2 * (i >> 1) + 1].y : w[2 * (i >> 1) + 1].x;
          const uint32_t p = __byte_perm(wk, wk1, by | ((4 + by) << 8) | (by << 4) | ((4 + by) << 12));
          alo[i] = bf16x2_sub((p & 0x000F000Fu) | 0x43004300u, zp2);
          ahi[i] = bf16x2_sub(((p >> 4) & 0x000F000Fu) | 0x43004300u, zp2);
        }
#pragma unroll
        for (int nb = 0; nb < NB8; ++nb) {
          mma_bf16(plo[nb][j], alo, b0[nb][0], b0[nb][1]);
          mma_bf16(phi[nb][j], ahi, b1[nb][0], b1[nb][1]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB8; ++nb) {
        if (GDOT) {
          mma_bf16(xg[nb][0], ones, b0[nb][0], b0[nb][1]);
          mma_bf16(xg[nb][0], ones, b1[nb][0], b1[nb][1]);
        } else if (XM) {
          mma_bf16(xlo[nb][0], ones, b0[nb][0], b0[nb][1]);
          mma_bf16(xhi[nb][0], ones, b1[nb][0], b1[nb][1]);
        }
      }
      if (st & 1) {
        fold_group<NB8, XM>(acc, plo, xlo, s, m);
        fold_group<NB8, XM>(acc, phi, xhi, s, m);
      }
    }
    if (GDOT && half == 1) fold_correction<NB8, MINS>(acc, xg, s, m, zpf);
  } else {
    float p0[NB8][4][4], p1[NB8][4][4], x0[NB8][1][4], x1[NB8][1][4];
#pragma unroll
    for (int st = 0; st < 8; ++st) {
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * st + 2 * t + (i & 1) + 8 * (i >> 1);
        w[i] = *reinterpret_cast<const uint2*>(stp + swz(r, c));
        w[i].x ^= 0x80808080u;  // int8 -> byte + 128
        w[i].y ^= 0x80808080u;
      }
      uint32_t b[NB8][2];
      ld_xfrag<NB8>(stp + L::X_OFF + (st >> 2) * L::X_CHUNK, 16 * (st & 3), g, t, b);
      zero_acc<NB8, 4>(p0);
      zero_acc<NB8, 4>(p1);
      if (MINS) {
        zero_acc<NB8, 1>(x0);
        zero_acc<NB8, 1>(x1);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t aa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cc = 2 * j + (i & 1), by = cc & 3;
          const uint32_t wk = (cc >> 2) ? w[2 * (i >> 1)].y : w[2 * (i >> 1)].x;
          const uint32_t wk1 = (cc >> 2) ? w[2 * (i >> 1) + 1].y : w[2 * (i >> 1) + 1].x;
          aa[i] = f2_bf16x2(q_of(wk, by, ibase), q_of(wk1, by, ibase));
        }
        // aa[0], aa[1]: k = 2t, 2t + 1 (the step's first group); aa[2], aa[3]: + 8
#pragma unroll
        for (int nb = 0; nb < NB8; ++nb) {
          mma_bf16_k8(p0[nb][j], aa[0], aa[1], b[nb][0]);
          mma_bf16_k8(p1[nb][j], aa[2], aa[3], b[nb][1]);
        }
      }
      if (MINS) {
#pragma unroll
        for (int nb = 0; nb < NB8; ++nb) {
          mma_bf16_k8(x0[nb][0], ones[0], ones[1], b[nb][0]);
          mma_bf16_k8(x1[nb][0], ones[0], ones[1], b[nb][1]);
        }
      }
      ld_eight<SBF16>(stp + L::S_OFF + 2 * st * DV_TILE_N * L::ES, c, s);
      if (MINS) ld_eight<SBF16>(stp + L::M_OFF + 2 * st * DV_TILE_N * L::ES, c, m);
      fold_group<NB8, MINS>(acc, p0, x0, s, m);
      ld_eight<SBF16>(stp + L::S_OFF + (2 * st + 1) * DV_TILE_N * L::ES, c, s);
      if (MINS) ld_eight<SBF16>(stp + L::M_OFF + (2 * st + 1) * DV_TILE_N * L::ES, c, m);
      fold_group<NB8, MINS>(acc, p1, x1, s, m);
    }
  }
}

// a CTA of the grid (cluster size C, column tiles); the C CTAs of a
// cluster split K. GDOT: K5's group-factored sum (dv_consume); G16: p4
// planes at group size 16; GX: the forms of dv_consume_gx (256, p4; 8, i8)
template <bool P4, bool SBF16, bool MINS, int NB8, bool GDOT, bool G16 = false, int GX = 0>
__device__ __forceinline__ void dv_cta(const CUtensorMap& tmx, const CUtensorMap& tmw,
                                       const CUtensorMap& tms, const CUtensorMap& tmm,
                                       const DecodeArgs& a) {
  using L = DecodeSmem<P4, SBF16, MINS, G16, GX>;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[8];  // full[0..3], empty[4..7]
  const uint32_t raw = smem_u32(dyn_smem);
  uint8_t* smem = dyn_smem + (((raw + 1023) & ~1023u) - raw);
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[4]);
  const int C = gridDim.x, rank = blockIdx.x, n0 = blockIdx.y * DV_TILE_N;
  const int units = (a.K + DV_UNIT_K - 1) / DV_UNIT_K;
  const int u0 = min(units, rank * a.upr), u1 = min(units, u0 + a.upr);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full0 + 8 * s, a.tma_w ? 1 : DV_RAGGED_ARRIVALS);
      mbar_init(empty0 + 8 * s, 2);  // the two consumer warps that take the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[NB8][4][4];
#pragma unroll
  for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][j][e] = 0.f;
  const int cw = warp & 1, kw = warp >> 1;
  if (warp == 4) {
    dv_producer<P4, SBF16, MINS, G16, GX>(&tmx, &tmw, &tms, &tmm, a, smem, full0, empty0, n0,
                                          u0, u1);
  } else {
    // p4: 128 + zp as a bf16 pair (K5: 128, the raw nibbles); i8: 2^23 + 128 + zp
    const uint32_t zb = 0x4300u | (uint32_t)(GDOT ? 0 : a.zp);  // exact for zp <= 15
    const uint32_t zp2 = zb | (zb << 16);
    const float ibase = 8388608.f + 128.f + (float)a.zp;
    if constexpr (GX == 256 && GDOT) {
      // K5 at group size 256: consumer pair kw takes both stages of a group
      // (stages 4 i + 2 kw and 4 i + 2 kw + 1, slots 2 kw and 2 kw + 1; the
      // launch gives every CTA an even number of stages from an even one)
      static_assert(L::STAGES == 4, "the pairs of stages need a ring of 4");
      float xg[NB8][1][4];
      for (int j2 = 2 * kw; j2 < u1 - u0; j2 += 4)
        for (int h = 0; h < 2; ++h) {
          const int j = j2 + h, slot = j % L::STAGES;
          mbar_wait(full0 + 8 * slot, (j / L::STAGES) & 1);
          dv_consume_gx<P4, SBF16, MINS, NB8, true, 256>(smem + slot * L::STAGE, 64 * cw, zp2,
                                                         ibase, acc, xg, h, (float)a.zp);
          dv_release(empty0 + 8 * slot, lane);
        }
    } else {
      for (int j = kw; j < u1 - u0; j += 2) {
        const int slot = j % L::STAGES;
        mbar_wait(full0 + 8 * slot, (j / L::STAGES) & 1);
        if constexpr (GX != 0) {
          float xg[NB8][1][4];
          dv_consume_gx<P4, SBF16, MINS, NB8, false, GX>(smem + slot * L::STAGE, 64 * cw, zp2,
                                                         ibase, acc, xg, 0, 0.f);
        } else {
          dv_consume<P4, SBF16, MINS, NB8, GDOT, G16>(smem + slot * L::STAGE, 64 * cw, a.gs, zp2,
                                                      ibase, acc, GDOT ? (float)a.zp : 0.f);
        }
        dv_release(empty0 + 8 * slot, lane);
      }
    }
  }
  __syncthreads();  // every stage consumed: the ring becomes the partial tile

  // the CTA's partial tile [kw][row][column], f32
  float* red = reinterpret_cast<float*>(smem);
  if (warp < 4) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = 8 * nb + 2 * t + (e & 1), col = 64 * cw + 8 * g + 2 * j + (e >> 1);
          red[(kw * DV_MAX_B + b) * DV_TILE_N + col] = acc[nb][j][e];
        }
  }
  if (C > 1) cluster_sync_all();
  else __syncthreads();
  // CTA `rank` sums its slice of the tile over the cluster, in rank order
  const int elems = a.B * DV_TILE_N, per = (elems + C - 1) / C;
  const int e0 = rank * per, e1 = min(elems, e0 + per);
  for (int i = e0 + threadIdx.x; i < e1; i += DV_THREADS) {
    const int b = i / DV_TILE_N, col = i % DV_TILE_N, n = n0 + col;
    const uint32_t l0 = smem_u32(red + b * DV_TILE_N + col);
    const uint32_t l1 = smem_u32(red + (DV_MAX_B + b) * DV_TILE_N + col);
    float v = 0.f;
    if (C > 1) {
      for (int q = 0; q < C; ++q) {
        v += ld_dsmem(l0, q);
        v += ld_dsmem(l1, q);
      }
    } else {
      v = red[b * DV_TILE_N + col] + red[(DV_MAX_B + b) * DV_TILE_N + col];
    }
    if (n < a.N) {
      const size_t o = (size_t)b * a.N + n;
      if (a.out_bf16) reinterpret_cast<__nv_bfloat16*>(a.y)[o] = __float2bfloat16_rn(v);
      else reinterpret_cast<float*>(a.y)[o] = v;
    }
  }
  if (C > 1) cluster_sync_all();  // no CTA leaves while another reads its tile
}

// K1/K2/K7's decode GEMV
template <bool P4, bool SBF16, bool MINS, int NB8>
__global__ void __launch_bounds__(DV_THREADS, NB8 == 1 ? 3 : 2)
qmm_decode(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
           const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmm,
           const DecodeArgs a) {
  dv_cta<P4, SBF16, MINS, NB8, false>(tmx, tmw, tms, tmm, a);
}

// K5 (and K7's K5 variant): the same CTA on p4 planes, group-factored
template <bool SBF16, bool MINS, int NB8>
__global__ void __launch_bounds__(DV_THREADS, NB8 == 1 ? 3 : 2)
qmm_decode_gdot(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmm,
                const DecodeArgs a) {
  dv_cta<true, SBF16, MINS, NB8, true>(tmx, tmw, tms, tmm, a);
}

// K1/K7 (and, GDOT, K5 and K7's K5 variant) on p4 planes at group size 16
// (Q2_K, Q3_K): the same CTA with a group every k16 step, kernels of their
// own so that the group-size-32 ones keep their machine code
template <bool SBF16, bool MINS, int NB8>
__global__ void __launch_bounds__(DV_THREADS, NB8 == 1 ? 3 : 2)
qmm_decode_g16(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
               const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmm,
               const DecodeArgs a) {
  dv_cta<true, SBF16, MINS, NB8, false, true>(tmx, tmw, tms, tmm, a);
}

template <bool SBF16, bool MINS, int NB8>
__global__ void __launch_bounds__(DV_THREADS, NB8 == 1 ? 3 : 2)
qmm_decode_gdot_g16(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw,
                    const __grid_constant__ CUtensorMap tms,
                    const __grid_constant__ CUtensorMap tmm, const DecodeArgs a) {
  dv_cta<true, SBF16, MINS, NB8, true, true>(tmx, tmw, tms, tmm, a);
}

// K1/K7 (and, GDOT, K5 and K7's K5 variant) on p4 planes at group size 256
// (TQ1_0, TQ2_0), and K2/K7 on int8 planes at group size 8 (IQ1_M): the
// same CTA with dv_consume_gx, kernels of their own
template <bool SBF16, bool MINS, int NB8>
__global__ void __launch_bounds__(DV_THREADS, NB8 == 1 ? 3 : 2)
qmm_decode_g256(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmm,
                const DecodeArgs a) {
  dv_cta<true, SBF16, MINS, NB8, false, false, 256>(tmx, tmw, tms, tmm, a);
}

template <bool SBF16, bool MINS, int NB8>
__global__ void __launch_bounds__(DV_THREADS, NB8 == 1 ? 3 : 2)
qmm_decode_gdot_g256(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw,
                     const __grid_constant__ CUtensorMap tms,
                     const __grid_constant__ CUtensorMap tmm, const DecodeArgs a) {
  dv_cta<true, SBF16, MINS, NB8, true, false, 256>(tmx, tmw, tms, tmm, a);
}

template <bool SBF16, bool MINS, int NB8>
__global__ void __launch_bounds__(DV_THREADS, NB8 == 1 ? 3 : 2)
qmm_decode_g8(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
              const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmm,
              const DecodeArgs a) {
  dv_cta<false, SBF16, MINS, NB8, false, false, 8>(tmx, tmw, tms, tmm, a);
}

}  // namespace
