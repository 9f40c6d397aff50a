// The GEMV loop of the S1 probes (qmm_probe.cu) alone: no production
// kernel runs it. K1/K2/K7 and K5 run qmm_decode.cuh's decode GEMV, K6 the
// same CTA body (qmm_chain.cu); this loop was K1's decode GEMV when S1 was
// ported, and K5's and K6's after that.
//
//   y[b,n] += sum_{k in the block's K range} x[b,k] * (q[k,n] - zp) * s[k/gs,n]
//             - sum_g xsum[b,g] * m[g,n]
//
// One call is the work of one CTA: 256 columns of the output (32 lanes x
// 8 columns per warp, each lane streaming one 8-byte word of a plane row)
// over a range of K "units" (32 plane rows each), for up to 4 rows of x.
// The activations of the K range are staged once in shared memory through
// a loader functor xl(b, k). The 8 warps reduce in shared memory and the
// sums land in y, by atomics when K is split over CTAs.
//
// MODE (default GV_FULL, which is the GEMV above) turns the same CTA into
// one of the old decode GEMV's probes (S1), which
// replace the TPU package's timing probes scripts/kbench.py:56 and
// scripts/kbench3.py:54/:89. They run on the loop's grid over p4 planes and write
// f32 [GV_PROBE_ROWS = 3, N], to which every byte they load contributes, so
// that no load can be dropped by the compiler. Each kind of load has a row
// of its own, so that each is checked at a tolerance of its own size (the
// byte sums would swamp the rest):
//   row 0, the packed qs bytes' column sums (GV_QS, GV_DMA; integers);
//   row 1, GV_DMA: the column's sums of its scales and mins;
//          GV_DEQ: every weight unpacked and dequantized, as the GEMV's
//          loop does without the product with x: the column's sum of
//          (q - zp) * s - m over K;
//   row 2, the sum of the staged x (GV_DMA, GV_DEQ).
// GV_QS streams the packed qs only; GV_DMA also streams scales and mins and
// stages x as the GEMV does; a row a mode does not feed is 0. A launch per
// 4 rows of x streams the planes once, as the loop does, so every plane term
// counts once per such launch.
//
// p4 layout: within each 256-row pack tile of K, packed row t holds k=t in
// its low nibble and k=t+128 in its high nibble.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // sm_count

namespace {

constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int LANE_COLS = 8;                // columns per lane (one 8-byte word)
constexpr int GV_TILE_N = 32 * LANE_COLS;   // 256 columns per CTA
constexpr int GV_STAGE = 8192;              // floats of staged x per CTA
constexpr int GV_MAX_NB = 4;                // rows of x per call
constexpr int GV_PROBE_ROWS = 3;            // rows of a probe's output

// what a gemv_block call computes (the probes are S1's, see above)
enum { GV_FULL = 0, GV_QS = 1, GV_DMA = 2, GV_DEQ = 3 };

template <bool BF16>
__device__ __forceinline__ float ld_group(const void* p, size_t i) {
  if (BF16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  return reinterpret_cast<const float*>(p)[i];
}

// 8 consecutive group values starting at element i; vec requires i % 8 == 0
template <bool BF16>
__device__ __forceinline__ void ld_group8(const void* p, size_t i, bool vec,
                                          int nvalid, float out[8]) {
  if (vec) {
    if (BF16) {
      uint4 u = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const __nv_bfloat16*>(p) + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        out[2 * j] = f.x;
        out[2 * j + 1] = f.y;
      }
    } else {
      const float4* f = reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(p) + i);
      float4 a = f[0], b = f[1];
      out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
      out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = j < nvalid ? ld_group<BF16>(p, i + j) : 0.f;
  }
}

// A "unit" is the work of one warp step: 32 plane rows. For p4 that is 32
// packed rows of one pack tile = 64 values of k (32 low, 32 high nibbles);
// for i8 it is 32 consecutive k.
template <bool P4>
__device__ __forceinline__ int unit_k(int u, int r) {
  if (P4) {
    int tile = u >> 2, j = u & 3;
    return tile * 256 + j * 32 + (r < 32 ? r : 128 + (r - 32));
  }
  return u * 32 + r;
}

// the probes' loader: bf16 rows of x with leading dimension ld
struct Bf16Rows {
  const __nv_bfloat16* x;
  int ld;
  __device__ __forceinline__ float operator()(int b, int k) const {
    return __bfloat162float(x[(size_t)b * ld + k]);
  }
};

// S1's GV_QS / GV_DMA work on unit u of p4 planes for one lane's columns:
// the unit's 32 packed rows, each byte once, into acc row 0 (byte sums in
// 16-bit halves of four words: at most 32 x 255 a half), and with DMA its
// two groups' scales and mins into row 1 and the staged x's sums of the
// unit (xg, rows xg_stride apart) into row 2.
template <int NB, bool SBF16, bool MINS, bool DMA>
__device__ __forceinline__ void probe_stream(
    const uint8_t* __restrict__ qs, const void* __restrict__ sc,
    const void* __restrict__ mn, int N, int u, int col, bool vec, int nvalid,
    const float* xg, int xg_stride, float (*acc)[LANE_COLS]) {
  uint32_t bs[4] = {0u, 0u, 0u, 0u};
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    const size_t prow = (size_t)((u >> 2) * 128 + (u & 3) * 32 + r);
    uint32_t w[2];
    if (vec) {
      uint2 v = *reinterpret_cast<const uint2*>(qs + prow * N + col);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = w[1] = 0;
      for (int c = 0; c < nvalid; ++c)
        w[c >> 2] |= (uint32_t)qs[prow * N + col + c] << (8 * (c & 3));
    }
    bs[0] += w[0] & 0x00FF00FFu;
    bs[1] += (w[0] >> 8) & 0x00FF00FFu;
    bs[2] += w[1] & 0x00FF00FFu;
    bs[3] += (w[1] >> 8) & 0x00FF00FFu;
  }
#pragma unroll
  for (int c = 0; c < LANE_COLS; ++c)  // byte c & 3 of word c >> 2
    acc[0][c] += (float)((bs[2 * (c >> 2) + (c & 1)] >> (16 * ((c >> 1) & 1))) & 0xFFFFu);
  if constexpr (DMA) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int g = (u >> 2) * 8 + (u & 3) + half * 4;
      float s[LANE_COLS];
      ld_group8<SBF16>(sc, (size_t)g * N + col, vec, nvalid, s);
#pragma unroll
      for (int c = 0; c < LANE_COLS; ++c) acc[1][c] += s[c];
      if (MINS) {
        ld_group8<SBF16>(mn, (size_t)g * N + col, vec, nvalid, s);
#pragma unroll
        for (int c = 0; c < LANE_COLS; ++c) acc[1][c] += s[c];
      }
    }
    float xt = 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) xt += xg[b * xg_stride] + xg[b * xg_stride + 1];
#pragma unroll
    for (int c = 0; c < LANE_COLS; ++c) acc[2][c] += xt;
  }
}

// One CTA's share of y: columns [n0, n0 + 256) over units [u0, u0 + nu),
// rows 0..B-1 (B <= NB) of xl. xs holds GV_STAGE floats and xsum
// GV_STAGE / 16, both in shared memory; every thread of the CTA calls this.
// MODE other than GV_FULL: an S1 probe (file comment), which writes rows
// 0..GV_PROBE_ROWS-1.
template <int NB, bool P4, bool SBF16, bool MINS, int MODE = GV_FULL, class XL>
__device__ __forceinline__ void gemv_block(
    const XL& xl, int B, const uint8_t* __restrict__ qs, const void* __restrict__ sc,
    const void* __restrict__ mn, float* __restrict__ y, int N, int gs, int zp,
    int u0, int nu, int n0, bool atomic_out, float* xs, float* xsum) {
  constexpr int UK = P4 ? 64 : 32;  // k values per unit
  static_assert(MODE == GV_FULL || P4, "the probes read p4 planes");
  constexpr bool PROBE_X = MODE == GV_DMA || MODE == GV_DEQ;  // x's sums feed the probe
  // rows of acc: x's rows, or a probe's output rows (at least NB, so that
  // the GEMV's code, unreached in a probe, indexes within acc)
  constexpr int AR = MODE == GV_FULL ? NB : (NB > GV_PROBE_ROWS ? NB : GV_PROBE_ROWS);
  static_assert(GV_WARPS * AR * GV_TILE_N <= GV_STAGE, "the reduction reuses xs");

  if constexpr (MODE != GV_QS) {
    for (int i = threadIdx.x; i < NB * nu * UK; i += GV_THREADS) {
      int b = i / (nu * UK), rem = i % (nu * UK);
      int k = unit_k<P4>(u0 + rem / UK, rem % UK);
      xs[i] = b < B ? xl(b, k) : 0.f;
    }
    __syncthreads();
  }
  const int gpu = UK / gs;  // groups per unit (2 for p4 and i8/gs16, 1 for i8/gs32)
  if (MODE != GV_QS && (MINS || PROBE_X)) {
    for (int i = threadIdx.x; i < NB * nu * gpu; i += GV_THREADS) {
      const float* src = xs + (size_t)i * gs;
      float s = 0.f;
      for (int j = 0; j < gs; ++j) s += src[j];
      xsum[i] = s;
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = n0 + lane * LANE_COLS;
  const int nvalid = max(0, min(LANE_COLS, N - col));
  const bool vec = nvalid == LANE_COLS && (N % LANE_COLS) == 0;
  const float fzp = (float)zp;

  float acc[AR][LANE_COLS];
#pragma unroll
  for (int b = 0; b < AR; ++b)
#pragma unroll
    for (int c = 0; c < LANE_COLS; ++c) acc[b][c] = 0.f;

  if (nvalid > 0) {
    for (int ul = warp; ul < nu; ul += GV_WARPS) {
      const int u = u0 + ul;
      const float* xu = xs + ul * UK;
      if constexpr (MODE == GV_QS || MODE == GV_DMA) {
        probe_stream<NB, SBF16, MINS, MODE == GV_DMA>(qs, sc, mn, N, u, col, vec, nvalid,
                                                       xsum + ul * gpu, nu * gpu, acc);
        continue;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // half 0/1: p4 -> low/high nibbles of the same 32 packed rows;
        // i8 -> plane rows 0..15 / 16..31 of the unit
        const int gl = P4 ? half : (half * 16) / gs;  // group within the unit
        int g;                                       // global group row
        if (P4) g = (u >> 2) * 8 + (u & 3) + half * 4;
        else g = (u * 32 + half * 16) / gs;
        float s[LANE_COLS];
        ld_group8<SBF16>(sc, (size_t)g * N + col, vec, nvalid, s);
        const int r_lo = P4 ? 0 : half * 16;
        const int r_hi = P4 ? 32 : half * 16 + 16;
#pragma unroll 8
        for (int r = r_lo; r < r_hi; ++r) {
          const size_t prow = P4 ? (size_t)((u >> 2) * 128 + (u & 3) * 32 + r)
                                 : (size_t)(u * 32 + r);
          uint32_t w[2];
          if (vec) {
            uint2 v = *reinterpret_cast<const uint2*>(qs + prow * N + col);
            w[0] = v.x;
            w[1] = v.y;
          } else {
            w[0] = w[1] = 0;
            for (int c = 0; c < nvalid; ++c)
              w[c >> 2] |= (uint32_t)qs[prow * N + col + c] << (8 * (c & 3));
          }
          float xv[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) xv[b] = xu[b * nu * UK + (P4 ? r + half * 32 : r)];
#pragma unroll
          for (int c = 0; c < LANE_COLS; ++c) {
            uint32_t byte = (w[c >> 2] >> (8 * (c & 3))) & 0xFFu;
            float q;
            if (P4) q = (float)(half ? (byte >> 4) : (byte & 15u)) - fzp;
            else q = (float)(int8_t)byte - fzp;
            const float wv = q * s[c];
            if constexpr (MODE == GV_DEQ) {
              acc[1][c] += wv;
            } else {
#pragma unroll
              for (int b = 0; b < NB; ++b) acc[b][c] = fmaf(xv[b], wv, acc[b][c]);
            }
          }
        }
        if constexpr (MODE == GV_DEQ) {
          // - gs * m per group (each weight's - m); the group's x sums
          float xt = 0.f;
#pragma unroll
          for (int b = 0; b < NB; ++b) xt += xsum[(b * nu + ul) * gpu + half];
          float m[LANE_COLS];
          if (MINS) ld_group8<SBF16>(mn, (size_t)g * N + col, vec, nvalid, m);
#pragma unroll
          for (int c = 0; c < LANE_COLS; ++c) {
            if (MINS) acc[1][c] = fmaf(-(float)gs, m[c], acc[1][c]);
            acc[2][c] += xt;
          }
        } else if (MINS && (P4 || gs == 16 || half == 0)) {
          float m[LANE_COLS];
          ld_group8<SBF16>(mn, (size_t)g * N + col, vec, nvalid, m);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const float xg = xsum[(b * nu + ul) * gpu + gl];
#pragma unroll
            for (int c = 0; c < LANE_COLS; ++c) acc[b][c] = fmaf(-xg, m[c], acc[b][c]);
          }
        }
      }
    }
  }

  __syncthreads();  // xs is reused for the cross-warp reduction
  float* red = xs;  // [warps][AR][256]
#pragma unroll
  for (int b = 0; b < AR; ++b)
#pragma unroll
    for (int c = 0; c < LANE_COLS; ++c)
      red[(warp * AR + b) * GV_TILE_N + lane * LANE_COLS + c] = acc[b][c];
  __syncthreads();
  for (int i = threadIdx.x; i < AR * GV_TILE_N; i += GV_THREADS) {
    const int b = i / GV_TILE_N, cc = i % GV_TILE_N, n = n0 + cc;
    if (b < (MODE == GV_FULL ? B : GV_PROBE_ROWS) && n < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < GV_WARPS; ++w) s += red[(w * AR + b) * GV_TILE_N + cc];
      if (atomic_out) atomicAdd(&y[(size_t)b * N + n], s);
      else y[(size_t)b * N + n] = s;
    }
  }
  __syncthreads();  // xs and xsum are free for the CTA's next call
}

// split of K over CTAs for one GEMV: about `target` CTAs in all, at least
// one unit per warp, the staged x within shared memory
struct GemvSplit {
  int ntiles, ksplit, upc;
};

inline GemvSplit gemv_split(int K, int N, bool p4, int target) {
  const int UK = p4 ? 64 : 32;
  const int n_units = K / UK;
  GemvSplit sp;
  sp.ntiles = (N + GV_TILE_N - 1) / GV_TILE_N;
  int ksplit = (target + sp.ntiles - 1) / sp.ntiles;
  ksplit = max(1, min(ksplit, n_units / GV_WARPS));
  int upc = (n_units + ksplit - 1) / ksplit;
  sp.upc = min(upc, GV_STAGE / (GV_MAX_NB * UK));
  sp.ksplit = (n_units + sp.upc - 1) / sp.upc;
  return sp;
}

}  // namespace
