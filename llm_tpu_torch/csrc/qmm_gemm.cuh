// K1/K2/K7's prefill GEMM (B > 16) for Hopper (sm_90a): the B > 16 regime
// of llm_tpu/ops/pallas_qmm.py::qmm_pallas -> _qmm_kernel_p4 / _p4_m (K1),
// _qmm_kernel_i8 / _i8_m (K2), and their stacked mode qmm_pallas(lidx=...)
// (K7). It computes what the decode GEMV computes (qmm_kernels.cuh):
//
//   y[b,n] = sum_k x[b,k] * (q[k,n] - zp) * s[k/gs,n]  -  sum_g xsum[b,g] * m[g,n]
//
// with x bf16 [B, K], the planes K-major (p4 uint8 [K/2, N] in 256-row pack
// tiles, low nibble k = t, high nibble k = t + 128; or i8 [K, N]), s and m
// [K/gs, N] in bf16 or f32, y f32 [B, N]. p4 planes have group size 32
// (qmm_wgmma), 16 (Q2_K, Q3_K: qmm_wgmma_g16, the same body with 4 group
// rows of scales and mins for each 64-k x chunk, a group every k16 step)
// or 256 (TQ1_0, TQ2_0: qmm_wgmma_g256, one group row a stage); i8 planes
// 32, 16 or 8 (IQ1_M: qmm_wgmma_g8, 16 group rows a stage, each k16 step's
// two halves folded with their own group's scale and min).
//
// Bound: operations at the main path's prefill shapes (2 B K N at B = 512
// is 2-4x the planes' bytes over the HBM rate). This kernel does twice
// those operations (below), so its floor is twice the operations bound.
//
// Exact group arithmetic. The mins fold into the weight, w' = (q - zp) * s
// - m in f32 (sum_g xsum[b,g] m[g,n] = sum_k x[b,k] m[k/gs,n]), and w' is
// split into bf16 hi = bf16(w') and lo = bf16(w' - hi). x @ hi + x @ lo
// accumulate in one f32 accumulator on the tensor cores: no per-group
// epilogue breaks the chain of matrix instructions, and the result is
// within ~1e-6 of max|y| of the f32 reference (a single bf16 rounding of
// w, as the TPU kernel rounds it, misses the 1e-3 * max|y| check by
// 1.4-1.6x; tests/test_torch_qmm_gemm.py).
//
// Shape of the kernel (the Hopper GEMM of the hopper-kernels guide):
//  * a CTA computes a 256 (n) x 128 (b) tile of y over a range of K; 384
//    threads: two consumer warpgroups of 128 columns each, and a producer
//    warpgroup whose first warp works (setmaxnreg moves the registers: 40
//    a producer thread, 232 a consumer thread). The CTAs are persistent
//    (one per SM) and walk a list of (n tile, b tile, K split) items;
//    split-K partial tiles meet in y through f32 atomics after a memset.
//    The split is chosen by the wrapper (ops/cuda_qmm.py::gemm_split) by a
//    cost model of item waves; the launch computes the items and the grid
//    (attn_k and attn_v at B = 512: 16 tiles x split 8, 128 CTAs).
//  * a ring of 2-4 stages in shared memory, each 128 k deep: two 64-wide
//    x chunks (128 rows, 128-byte swizzle, by TMA; the rows past B read as
//    zero), the plane rows that hold those k (p4: 64 packed rows whose low
//    and high nibbles are the two chunks, so each packed byte is read once;
//    i8: 128 rows) as two 128-column halves in the 128-byte swizzle, and
//    their scales and mins. The producer keeps them in flight with TMA
//    (cp.async.bulk.tensor, mbarrier completion) wherever the planes'
//    strides allow it (N % 16 == 0: every main-path shape). Otherwise (N =
//    264, 1000, ...) its 32 lanes gather the planes and group rows with
//    bounds checks into the same layout and arrive on the stage's barrier;
//    x still comes by TMA. K7 reads its layer index on the card once per
//    CTA: a 3-D tensor map [L, rows, N] takes it as a coordinate.
//  * wgmma with the weights as the register A operand: y^T = w'^T x^T,
//    m64n128k16, A = 64 columns of w' x 16 k (each thread dequantizes its
//    own fragment from the staged bytes: two adjacent columns at 4 k, one
//    2-byte shared load a k, so no dequantized weight goes back to shared
//    memory), B = the x chunk read from shared memory by its descriptor.
//    Each warpgroup holds two 64-column slices (128 f32 accumulators a
//    thread), interleaved so that a thread's rows are four adjacent columns
//    of y: accumulator row r of warp w, slice j, is column 32 w + 4 (r mod
//    8) + 2 j + (r >= 8) of the warpgroup's 128. Its scales and mins come
//    in one 4-wide load, and its results go out as 16-byte stores (or
//    16-byte f32 atomics when K is split). One hi/lo pair of wgmma a slice
//    and k16 step; the fragments rotate through 4 register sets, so up to
//    3 pairs run on the tensor cores while the next is dequantized
//    (wgmma.wait_group 3).
//  * one item = one tile over its K range; the consumers release a stage
//    as soon as a wait in the next stage has retired the last matrix
//    instruction that read it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int GM_TILE_N = 256;                  // columns of y per tile
constexpr int GM_TILE_B = 128;                  // rows of y per tile (wgmma N)
constexpr int GM_UNIT_K = 128;                  // k per stage
constexpr int GM_CONSUMERS = 256;               // two warpgroups
constexpr int GM_THREADS = GM_CONSUMERS + 128;  // and a producer warpgroup (one warp works)
constexpr int GM_PRODUCER_REGS = 40;            // setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 64 K
constexpr int GM_CONSUMER_REGS = 232;
constexpr int GM_INFLIGHT = 3;                  // wgmma groups in flight a warpgroup
constexpr int GM_SMEM_CAP = 232448 - 2048;      // dynamic shared memory a CTA may take
constexpr int GM_RAGGED_ARRIVALS = 33;          // lane 0's expect_tx, then all 32 lanes

// GX: the group-size forms of their own, 256 (p4) or 8 (i8); 0 otherwise
template <bool P4, bool SBF16, bool MINS, bool G16 = false, int GX = 0>
struct GemmSmem {
  static constexpr int GFORM = GX;
  static constexpr int X_CHUNK = GM_TILE_B * 64 * 2;  // 128 rows x 64 k of bf16
  static constexpr int W_ROWS = P4 ? 64 : 128;        // plane rows of a stage
  static constexpr int W_HALF = W_ROWS * 128;         // 128 columns of them
  static constexpr int CG = P4Groups<G16>::CG;        // p4: group rows of an x chunk
  static constexpr int GS = P4Groups<G16>::GS;        // p4: the group size
  // group rows (i8: gs 16 or 32; GX 256: one for the stage; GX 8: 16)
  static constexpr int G_ROWS = GX == 256 ? 1 : GX == 8 ? 16 : P4 ? 2 * CG : 8;
  static constexpr int ES = SBF16 ? 2 : 4;
  static constexpr int G_BYTES = G_ROWS * GM_TILE_N * ES;
  static constexpr int W_OFF = 2 * X_CHUNK;
  static constexpr int S_OFF = W_OFF + 2 * W_HALF;
  static constexpr int M_OFF = S_OFF + G_BYTES;
  static constexpr int STAGE = (M_OFF + (MINS ? G_BYTES : 0) + 1023) / 1024 * 1024;
  static constexpr int STAGES = GM_SMEM_CAP / STAGE > 4 ? 4 : GM_SMEM_CAP / STAGE;
  static constexpr int BYTES = STAGES * STAGE + 1024;  // + slack to align to 1024
};

struct GemmArgs {
  const uint8_t* qs;  // the planes (layer 0 of a stack), read directly on the ragged path
  const void* sc;
  const void* mn;
  float* y;
  const int* lidx;  // K7: the layer index in device memory; null for K1/K2
  long long qs_ls, s_ls;  // bytes from one layer's qs / scales (= mins) to the next
  int B, K, N, gs, zp, split, n_items, tma_w;
};

// keeps the compiler from moving reads of the accumulators across a wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] += A[64 x 16] (registers, bf16) x B[16 x 128] (shared memory, x)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <bool MINS>
__device__ __forceinline__ float fold(float q, float s, float m) {
  return MINS ? fmaf(q, s, -m) : q * s;
}

// a thread's A fragment (hi and lo) from two byte words: xa = [even col @ k,
// odd col @ k, even @ k+1, odd @ k+1] at k = 2 t4, xb the same at k = 2 t4 + 8.
// Registers: 0 = (row gid = even col, k, k+1), 1 = (row gid + 8 = odd col,
// k, k+1), 2 and 3 the same at k + 8.
template <bool P4, bool MINS>
__device__ __forceinline__ void dequant(uint32_t xa, uint32_t xb, bool high, float base,
                                        float se, float so, float me, float mo,
                                        uint32_t (&fh)[4], uint32_t (&fl)[4]) {
  uint32_t ya, yb;
  if (P4) {
    ya = (high ? xa >> 4 : xa) & 0x0F0F0F0Fu;
    yb = (high ? xb >> 4 : xb) & 0x0F0F0F0Fu;
  } else {
    ya = xa ^ 0x80808080u;
    yb = xb ^ 0x80808080u;
  }
  split_hilo(fold<MINS>(q_of(ya, 0, base), se, me), fold<MINS>(q_of(ya, 2, base), se, me),
             fh[0], fl[0]);
  split_hilo(fold<MINS>(q_of(ya, 1, base), so, mo), fold<MINS>(q_of(ya, 3, base), so, mo),
             fh[1], fl[1]);
  split_hilo(fold<MINS>(q_of(yb, 0, base), se, me), fold<MINS>(q_of(yb, 2, base), se, me),
             fh[2], fl[2]);
  split_hilo(fold<MINS>(q_of(yb, 1, base), so, mo), fold<MINS>(q_of(yb, 3, base), so, mo),
             fh[3], fl[3]);
}

struct Item {
  int n0, b0, u0, u1;
};

__device__ __forceinline__ Item item_of(int item, const GemmArgs& a) {
  const int nbt = (a.B + GM_TILE_B - 1) / GM_TILE_B;
  const int units = (a.K + GM_UNIT_K - 1) / GM_UNIT_K;
  const int bt = item % nbt, rest = item / nbt;
  const int ks = rest % a.split, nt = rest / a.split;
  return Item{nt * GM_TILE_N, bt * GM_TILE_B, units * ks / a.split,
              units * (ks + 1) / a.split};
}

// the producer's share of a stage on the ragged path, gathered by its 32
// lanes with bounds checks (zeros outside) into the TMA path's layout:
// plane rows [row0, row0 + W_ROWS) x columns [n0, n0 + 256) ...
template <bool P4>
__device__ __forceinline__ void gather_rows(uint8_t* w, const uint8_t* qs, int lane, int n0,
                                            int row0, const GemmArgs& a) {
  using L = GemmSmem<P4, true, false>;
  const int R = P4 ? a.K / 2 : a.K;
  for (int i = lane; i < L::W_ROWS * (GM_TILE_N / 4); i += 32) {
    const int r = i / (GM_TILE_N / 4), c4 = (i % (GM_TILE_N / 4)) * 4;
    uint32_t v = 0;
    if (row0 + r < R) {
      const uint8_t* src = qs + (size_t)(row0 + r) * a.N;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + c4 + e < a.N) v |= (uint32_t)src[n0 + c4 + e] << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(w + (c4 >> 7) * L::W_HALF + swz(r, c4 & 127)) = v;
  }
}

// ... and the stage's group rows of scales or mins (p4: L::CG rows from each
// x chunk, GX 256: the one row of both; i8: 128 / gs rows)
template <bool P4, bool SBF16, bool G16 = false, int GX = 0>
__device__ __forceinline__ void gather_groups(uint8_t* s, const void* src, int lane, int n0,
                                              int kx0, int kx1, const GemmArgs& a) {
  using L = GemmSmem<P4, SBF16, false, G16, GX>;
  const int G = a.K / a.gs, rows = GX == 256 ? 1 : P4 ? 2 * L::CG : GM_UNIT_K / a.gs;
  for (int i = lane; i < L::G_ROWS * GM_TILE_N; i += 32) {
    const int gr = i / GM_TILE_N, n = n0 + i % GM_TILE_N;
    const int g = GX == 256 ? kx0 / 256
                  : P4 ? (gr < L::CG ? kx0 / L::GS + gr : kx1 / L::GS + gr - L::CG)
                       : kx0 / a.gs + gr;
    const bool ok = gr < rows && g < G && n < a.N;
    if (SBF16)
      reinterpret_cast<uint16_t*>(s)[i] =
          ok ? reinterpret_cast<const uint16_t*>(src)[(size_t)g * a.N + n] : 0;
    else
      reinterpret_cast<uint32_t*>(s)[i] =
          ok ? reinterpret_cast<const uint32_t*>(src)[(size_t)g * a.N + n] : 0;
  }
}

// a thread's four adjacent columns' values of a group row (idx % 4 == 0)
template <bool SBF16>
__device__ __forceinline__ void ld_quad(const uint8_t* base, int idx, float (&v)[4]) {
  if (SBF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(base + idx * 2);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xFFFF0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xFFFF0000u);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(base + idx * 4);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// dequant on int8 planes at group size 8: xa's k (2 t4, 2 t4 + 1) lie in
// the k16 step's first group (scales sa*, mins ma*), xb's (+ 8) in its
// second (sb*, mb*)
template <bool MINS>
__device__ __forceinline__ void dequant_g8(uint32_t xa, uint32_t xb, float base, float sae,
                                           float sao, float sbe, float sbo, float mae, float mao,
                                           float mbe, float mbo, uint32_t (&fh)[4],
                                           uint32_t (&fl)[4]) {
  const uint32_t ya = xa ^ 0x80808080u, yb = xb ^ 0x80808080u;
  split_hilo(fold<MINS>(q_of(ya, 0, base), sae, mae), fold<MINS>(q_of(ya, 2, base), sae, mae),
             fh[0], fl[0]);
  split_hilo(fold<MINS>(q_of(ya, 1, base), sao, mao), fold<MINS>(q_of(ya, 3, base), sao, mao),
             fh[1], fl[1]);
  split_hilo(fold<MINS>(q_of(yb, 0, base), sbe, mbe), fold<MINS>(q_of(yb, 2, base), sbe, mbe),
             fh[2], fl[2]);
  split_hilo(fold<MINS>(q_of(yb, 1, base), sbo, mbo), fold<MINS>(q_of(yb, 3, base), sbo, mbo),
             fh[3], fl[3]);
}

// the kernel (its body: qmm_gemm_body.cuh)
template <bool P4, bool SBF16, bool MINS>
__global__ void __launch_bounds__(GM_THREADS, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
          const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmm,
          const GemmArgs a) {
  constexpr bool G16 = false;
#include "qmm_gemm_body.cuh"
}

// K1/K7 on p4 planes at group size 16 (Q2_K, Q3_K): a kernel of its own,
// so that the group-size-32 ones keep their machine code
template <bool SBF16, bool MINS>
__global__ void __launch_bounds__(GM_THREADS, 1)
qmm_wgmma_g16(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
              const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmm,
              const GemmArgs a) {
  constexpr bool P4 = true, G16 = true;
#include "qmm_gemm_body.cuh"
}

// K1/K7 on p4 planes at group size 256 (TQ1_0, TQ2_0) and K2/K7 on int8
// planes at group size 8 (IQ1_M): kernels of their own (GEMM_GX picks the
// form in the body's GemmSmem)
template <bool SBF16, bool MINS>
__global__ void __launch_bounds__(GM_THREADS, 1)
qmm_wgmma_g256(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
               const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmm,
               const GemmArgs a) {
  constexpr bool P4 = true, G16 = false;
#define GEMM_GX 256
#include "qmm_gemm_body.cuh"
}

template <bool SBF16, bool MINS>
__global__ void __launch_bounds__(GM_THREADS, 1)
qmm_wgmma_g8(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
             const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmm,
             const GemmArgs a) {
  constexpr bool P4 = false, G16 = false;
#define GEMM_GX 8
#include "qmm_gemm_body.cuh"
}

// ----------------------------------------------------------------------------
// host side: the launch (tensor maps by hopper.cuh's make_map)

// the prefill GEMM on planes qs/sc/mn (K7: layer *lidx of n_layers stacked
// ones, qs_ls / s_ls bytes apart); split: K ranges per tile (the wrapper's
// gemm_split); G16: p4 planes at group size 16; GX: p4 planes at 256 or
// i8 planes at 8. Returns 0 or an error code; the launch's own error is
// left for cudaGetLastError.
template <bool P4, bool SBF16, bool MINS, bool G16 = false, int GX = 0>
int launch_gemm(cudaStream_t st, const __nv_bfloat16* x, int B, int K, const uint8_t* qs,
                const void* sc, const void* mn, float* y, int N, int gs, int zp, int split,
                const int* lidx, long long qs_ls, long long s_ls, int n_layers) {
  using L = GemmSmem<P4, SBF16, MINS, G16, GX>;
  auto kern = qmm_wgmma<P4, SBF16, MINS>;
  if constexpr (GX == 256) kern = qmm_wgmma_g256<SBF16, MINS>;
  else if constexpr (GX == 8) kern = qmm_wgmma_g8<SBF16, MINS>;
  else if constexpr (G16) kern = qmm_wgmma_g16<SBF16, MINS>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    attr = true;
  }
  const int R = P4 ? K / 2 : K, G = K / gs, units = (K + GM_UNIT_K - 1) / GM_UNIT_K;
  split = split < 1 ? 1 : (split > units ? units : split);
  const long long L_ = n_layers < 1 ? 1 : n_layers;
  GemmArgs a{qs, sc, mn, y, lidx, lidx ? qs_ls : (long long)R * N,
             lidx ? s_ls : (long long)G * N * L::ES, B, K, N, gs, zp, split, 0,
             N % 16 == 0};
  a.n_items = ((N + GM_TILE_N - 1) / GM_TILE_N) * ((B + GM_TILE_B - 1) / GM_TILE_B) * split;

  CUtensorMap mx, mw, ms, mm;
  memset(&mw, 0, sizeof(mw));
  memset(&ms, 0, sizeof(ms));
  memset(&mm, 0, sizeof(mm));
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)B};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {64, GM_TILE_B};
    if (int rc = make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  if (a.tma_w) {
    const cuuint64_t wd[3] = {(cuuint64_t)N, (cuuint64_t)R, (cuuint64_t)L_};
    const cuuint64_t wst[2] = {(cuuint64_t)N, (cuuint64_t)a.qs_ls};
    const cuuint32_t wb[3] = {128, (cuuint32_t)L::W_ROWS, 1};
    if (int rc = make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, qs, wd, wst, wb,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
    const CUtensorMapDataType sdt =
        SBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const cuuint64_t sd[3] = {(cuuint64_t)N, (cuuint64_t)G, (cuuint64_t)L_};
    const cuuint64_t sst[2] = {(cuuint64_t)N * L::ES, (cuuint64_t)a.s_ls};
    const cuuint32_t sb[3] = {GM_TILE_N,
                              (cuuint32_t)(GX == 256 ? 1 : P4 ? P4Groups<G16>::CG
                                                              : GM_UNIT_K / gs), 1};
    if (int rc = make_map(&ms, sdt, 3, sc, sd, sst, sb, CU_TENSOR_MAP_SWIZZLE_NONE)) return rc;
    if (MINS)
      if (int rc = make_map(&mm, sdt, 3, mn, sd, sst, sb, CU_TENSOR_MAP_SWIZZLE_NONE)) return rc;
  }
  if (split > 1) cudaMemsetAsync(y, 0, sizeof(float) * (size_t)B * N, st);
  const int grid = a.n_items < sm_count() ? a.n_items : sm_count();
  kern<<<grid, GM_THREADS, L::BYTES, st>>>(mx, mw, ms, mm, a);
  return 0;
}

}  // namespace
