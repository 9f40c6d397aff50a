// K1/K2/K5/K7: the fused dequantize x matmul for Hopper (sm_90a): its
// kernels, shared by qmm.cu (K1/K2/K5) and qmm_stacked.cu (K7).
//
// Replaces the TPU kernels llm_tpu/ops/pallas_qmm.py::qmm_pallas ->
// _qmm_kernel_p4 / _qmm_kernel_p4_m (K1, nibble-packed planes) and
// _qmm_kernel_i8 / _qmm_kernel_i8_m (K2, int8 planes). It computes
//
//   y[b,n] = sum_k x[b,k] * (q[k,n] - zp) * s[k/gs,n]  -  sum_g xsum[b,g] * m[g,n]
//
// with x in bf16, the weight planes K-major (q [K(/2), N], s and m
// [K/gs, N] in f32 or bf16), xsum[b,g] the f32 sum of group g of row b,
// and y in f32. The mins correction is fused (the TPU path ran it as a
// separate matmul on bf16 group sums); here it stays in f32.
//
// p4 layout: within each 256-row pack tile of K, packed row t holds k=t in
// its low nibble and k=t+128 in its high nibble.
//
// Two regimes:
//  * decode (B <= 16, rows in chunks of 4): a GEMV bound by the bytes of
//    the planes (0.5 B/weight p4, 1 B/weight i8, plus scales and mins).
//    Each warp streams 8-byte words of one plane row across 256 columns
//    (32 lanes x 8 columns, fully coalesced), dequantizes in registers
//    (w = (q - zp) * s in f32, then an FMA per row of x), and the K range
//    is split over CTAs so that even N = 4096 fills the 132 SMs; partial
//    sums meet through f32 atomics (a memset first). The activations of a
//    CTA's K range are staged once in shared memory. The loop lives in
//    qmm_gemv.cuh, which the chained kernel K6 (qmm_chain.cu) shares.
//    K5 (qmm_gdot_launch) is the same GEMV with GDOT set: it replaces
//    llm_tpu/ops/pallas_qmm.py::_gdot_kernel (via _qmm_gdot_call), takes
//    the scale once per 32-group instead of once per weight, and is bound
//    by the same plane bytes as K1.
//  * prefill (B > 16): a tiled tensor-core GEMM (mma.sync m16n8k16 bf16).
//    A 64-wide K chunk of the planes is unpacked into shared memory as
//    the raw integers (q - zp), which bf16 holds exactly; each quant group
//    is one or two MMAs into a partial, which is scaled by s[g,n] and
//    corrected by xsum[b,g] * m[g,n] in f32 (the known accumulator layout
//    of mma.sync makes this possible). This is bound by operations; it is
//    simple, not fast: no TMA, no wgmma, no pipelining.
//
// K7 (qmm_stacked_launch, qmm_gdot_stacked_launch) is K1/K2/K5 on one layer
// of depth-stacked planes ([L, ...] qs, scales and mins, one allocation
// each): it replaces the stacked mode of the same TPU kernels
// (qmm_pallas(lidx=...), pallas_qmm.py:481 and :334, whose scalar-prefetch
// index maps prepend the layer to every plane block). Here every CTA reads
// the layer index from device memory once and offsets its plane pointers by
// the per-layer strides; nothing else changes, so K7 computes exactly what
// the unstacked kernel computes on that layer, and the host never reads the
// index (no sync per launch). Its bound is the unstacked kernel's: one
// layer's planes. K7's kernels (qmm_gemv_stacked, qmm_gemm_stacked) wrap
// the same inlined CTA bodies as K1/K2/K5's, whose kernels keep the
// parameters and code they had before K7 existed; K7's instantiations
// live in their own library (qmm_stacked.cu).

#pragma once

#include "qmm_gemv.cuh"

namespace {

// the layer of stacked planes (K7): the index in device memory and the
// bytes of one layer's qs and of one layer's scales (= mins)
struct Stack {
  const int* lidx;
  long long qs_ls, s_ls;
};

// K7: every CTA reads the layer index once and moves its plane pointers to
// that layer
__device__ __forceinline__ void to_layer(const Stack& sk, const uint8_t*& qs, const void*& sc,
                                         const void*& mn) {
  const long long l = __ldg(sk.lidx);
  qs += l * sk.qs_ls;
  sc = static_cast<const char*>(sc) + l * sk.s_ls;
  if (mn != nullptr) mn = static_cast<const char*>(mn) + l * sk.s_ls;
}

// ----------------------------------------------------------------------------
// decode GEMV (K1/K2, and K5 with GDOT): one CTA per (N tile, K range)

template <int NB, bool P4, bool SBF16, bool MINS, bool GDOT>
__device__ __forceinline__ void gemv_cta(const __nv_bfloat16* __restrict__ x, int B, int K,
                                         const uint8_t* __restrict__ qs,
                                         const void* __restrict__ sc,
                                         const void* __restrict__ mn, float* __restrict__ y,
                                         int N, int gs, int zp, int upc, int atomic_out) {
  __shared__ float xs[GV_STAGE];  // [NB][units][UK], then the warp reduction
  __shared__ float xsum[GV_STAGE / 16];
  const int n_units = P4 ? K / 64 : K / 32;
  const int u0 = blockIdx.y * upc;
  gemv_block<NB, P4, SBF16, MINS, GDOT>(Bf16Rows{x, K}, B, qs, sc, mn, y, N, gs, zp, u0,
                                        min(upc, n_units - u0), blockIdx.x * GV_TILE_N,
                                        atomic_out != 0, xs, xsum);
}

template <int NB, bool P4, bool SBF16, bool MINS, bool GDOT>
__global__ void __launch_bounds__(GV_THREADS)
qmm_gemv(const __nv_bfloat16* __restrict__ x, int B, int K,
         const uint8_t* __restrict__ qs, const void* __restrict__ sc,
         const void* __restrict__ mn, float* __restrict__ y, int N, int gs,
         int zp, int upc, int atomic_out) {
  gemv_cta<NB, P4, SBF16, MINS, GDOT>(x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out);
}

// K7's decode GEMV: the same on layer *sk.lidx of stacked planes
template <int NB, bool P4, bool SBF16, bool MINS, bool GDOT>
__global__ void __launch_bounds__(GV_THREADS)
qmm_gemv_stacked(const __nv_bfloat16* __restrict__ x, int B, int K, const uint8_t* qs,
                 const void* sc, const void* mn, float* __restrict__ y, int N, int gs,
                 int zp, int upc, int atomic_out, Stack sk) {
  to_layer(sk, qs, sc, mn);
  gemv_cta<NB, P4, SBF16, MINS, GDOT>(x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out);
}

// ----------------------------------------------------------------------------
// prefill GEMM

constexpr int BM = 64, BN = 128, KC = 64, GM_THREADS = 256, PAD = 8;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool P4, bool SBF16, bool MINS>
__device__ __forceinline__ void gemm_cta(const __nv_bfloat16* __restrict__ x, int B, int K,
                                         const uint8_t* __restrict__ qs,
                                         const void* __restrict__ sc,
                                         const void* __restrict__ mn, float* __restrict__ y,
                                         int N, int gs, int zp) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][KC + PAD];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN][KC + PAD];  // [n][k]: raw q - zp
  __shared__ float Ss[KC / 16][BN];
  __shared__ float Ms[KC / 16][BN];
  __shared__ float Xg[BM][KC / 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int b0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ngc = KC / gs;
  const bool nvec = (N % 16) == 0;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int kb = 0; kb < K; kb += KC) {
    // x tile: 64 rows x 64 k, 16 bytes per load
    for (int i = tid; i < BM * KC / 8; i += GM_THREADS) {
      const int row = i / (KC / 8), c8 = (i % (KC / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (b0 + row < B)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(b0 + row) * K + kb + c8);
      *reinterpret_cast<uint4*>(&As[row][c8]) = v;
    }
    // weight tile: 64 k x 128 columns of raw integers, transposed to [n][k]
    for (int i = tid; i < KC * BN / 16; i += GM_THREADS) {
      const int kk = i / (BN / 16), c16 = (i % (BN / 16)) * 16;
      const int k = kb + kk, n = n0 + c16;
      size_t prow;
      bool hi = false;
      if (P4) {
        prow = (size_t)(k >> 8) * 128 + ((k & 255) & 127);
        hi = (k & 255) >= 128;
      } else {
        prow = (size_t)k;
      }
      uint8_t bytes[16];
      if (nvec && n + 16 <= N) {
        *reinterpret_cast<uint4*>(bytes) =
            *reinterpret_cast<const uint4*>(qs + prow * N + n);
      } else {
        for (int j = 0; j < 16; ++j) bytes[j] = n + j < N ? qs[prow * N + n + j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        int v;
        if (P4) v = (int)(hi ? (bytes[j] >> 4) : (bytes[j] & 15)) - zp;
        else v = (int)(int8_t)bytes[j] - zp;
        Ws[c16 + j][kk] = __float2bfloat16((n + j < N) ? (float)v : 0.f);
      }
    }
    for (int i = tid; i < ngc * BN; i += GM_THREADS) {
      const int gg = i / BN, c = i % BN, n = n0 + c;
      const size_t gi = (size_t)(kb / gs + gg) * N + n;
      Ss[gg][c] = n < N ? ld_group<SBF16>(sc, gi) : 0.f;
      if (MINS) Ms[gg][c] = n < N ? ld_group<SBF16>(mn, gi) : 0.f;
    }
    __syncthreads();
    if (MINS) {
      for (int i = tid; i < BM * ngc; i += GM_THREADS) {
        const int row = i / ngc, gg = i % ngc;
        float s = 0.f;
        for (int j = 0; j < gs; ++j) s += __bfloat162float(As[row][gg * gs + j]);
        Xg[row][gg] = s;
      }
      __syncthreads();
    }

    for (int gg = 0; gg < ngc; ++gg) {
      float part[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
      for (int ks = gg * gs; ks < (gg + 1) * gs; ks += 16) {
        uint32_t a[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + gid;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + t4 * 2]);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + t4 * 2]);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 8 + t4 * 2]);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 8 + t4 * 2]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = wn * 32 + ni * 8 + gid;
          bf[ni][0] = *reinterpret_cast<const uint32_t*>(&Ws[c][ks + t4 * 2]);
          bf[ni][1] = *reinterpret_cast<const uint32_t*>(&Ws[c][ks + 8 + t4 * 2]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(part[mi][ni], a[mi], bf[ni]);
      }
      // accumulator layout of m16n8: c0,c1 at (gid, 2*t4 + {0,1}); c2,c3 at (gid+8, ...)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = wm * 32 + mi * 16 + gid + (c >> 1) * 8;
            const int cn = wn * 32 + ni * 8 + t4 * 2 + (c & 1);
            float v = fmaf(Ss[gg][cn], part[mi][ni][c], acc[mi][ni][c]);
            if (MINS) v = fmaf(-Xg[r][gg], Ms[gg][cn], v);
            acc[mi][ni][c] = v;
          }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = b0 + wm * 32 + mi * 16 + gid + (c >> 1) * 8;
        const int n = n0 + wn * 32 + ni * 8 + t4 * 2 + (c & 1);
        if (r < B && n < N) y[(size_t)r * N + n] = acc[mi][ni][c];
      }
}

template <bool P4, bool SBF16, bool MINS>
__global__ void __launch_bounds__(GM_THREADS)
qmm_gemm(const __nv_bfloat16* __restrict__ x, int B, int K,
         const uint8_t* __restrict__ qs, const void* __restrict__ sc,
         const void* __restrict__ mn, float* __restrict__ y, int N, int gs,
         int zp) {
  gemm_cta<P4, SBF16, MINS>(x, B, K, qs, sc, mn, y, N, gs, zp);
}

// K7's prefill GEMM: the same on layer *sk.lidx of stacked planes
template <bool P4, bool SBF16, bool MINS>
__global__ void __launch_bounds__(GM_THREADS)
qmm_gemm_stacked(const __nv_bfloat16* __restrict__ x, int B, int K, const uint8_t* qs,
                 const void* sc, const void* mn, float* __restrict__ y, int N, int gs,
                 int zp, Stack sk) {
  to_layer(sk, qs, sc, mn);
  gemm_cta<P4, SBF16, MINS>(x, B, K, qs, sc, mn, y, N, gs, zp);
}

template <int NB, bool P4, bool SBF16, bool MINS, bool GDOT, bool STACKED>
void launch_gemv_t(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, int B,
                   int K, const uint8_t* qs, const void* sc, const void* mn,
                   float* y, int N, int gs, int zp, int upc, int atomic_out, Stack sk) {
  if constexpr (STACKED)
    qmm_gemv_stacked<NB, P4, SBF16, MINS, GDOT><<<grid, GV_THREADS, 0, st>>>(
        x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out, sk);
  else
    qmm_gemv<NB, P4, SBF16, MINS, GDOT><<<grid, GV_THREADS, 0, st>>>(
        x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out);
}

template <bool P4, bool SBF16, bool MINS, bool GDOT, bool STACKED>
void launch_gemv_nb(int nb, dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
                    int B, int K, const uint8_t* qs, const void* sc,
                    const void* mn, float* y, int N, int gs, int zp, int upc,
                    int atomic_out, Stack sk) {
  if (nb == 1)
    launch_gemv_t<1, P4, SBF16, MINS, GDOT, STACKED>(grid, st, x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out, sk);
  else if (nb == 2)
    launch_gemv_t<2, P4, SBF16, MINS, GDOT, STACKED>(grid, st, x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out, sk);
  else
    launch_gemv_t<4, P4, SBF16, MINS, GDOT, STACKED>(grid, st, x, B, K, qs, sc, mn, y, N, gs, zp, upc, atomic_out, sk);
}

template <bool P4, bool SBF16, bool MINS, bool GDOT, bool STACKED>
void run(cudaStream_t st, const __nv_bfloat16* x, int B, int K,
         const uint8_t* qs, const void* sc, const void* mn, float* y, int N,
         int gs, int zp, Stack sk) {
  if (B > 16) {
    dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
    if constexpr (STACKED)
      qmm_gemm_stacked<P4, SBF16, MINS><<<grid, GM_THREADS, 0, st>>>(x, B, K, qs, sc, mn, y, N,
                                                                     gs, zp, sk);
    else
      qmm_gemm<P4, SBF16, MINS><<<grid, GM_THREADS, 0, st>>>(x, B, K, qs, sc, mn, y, N, gs, zp);
    return;
  }
  // about two CTAs of 8 warps on every SM
  const GemvSplit sp = gemv_split(K, N, P4, 2 * sm_count());
  const int atomic_out = sp.ksplit > 1;
  if (atomic_out) cudaMemsetAsync(y, 0, sizeof(float) * (size_t)B * N, st);
  dim3 grid(sp.ntiles, sp.ksplit);
  for (int b0 = 0; b0 < B; b0 += GV_MAX_NB) {
    const int nb = min(GV_MAX_NB, B - b0);
    const int nbt = nb == 1 ? 1 : (nb == 2 ? 2 : 4);
    launch_gemv_nb<P4, SBF16, MINS, GDOT, STACKED>(nbt, grid, st, x + (size_t)b0 * K, nb, K,
                                          qs, sc, mn, y + (size_t)b0 * N, N, gs, zp,
                                          sp.upc, atomic_out, sk);
  }
}

// K1/K2 (K7 with STACKED) on any planes: the launch the entry points share
template <bool STACKED>
int qmm_any(const void* x, const void* qs, const void* scales, const void* mins,
            void* y, int B, int K, int N, int gs, int zp, int p4, int scales_bf16,
            Stack sk, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const uint8_t* q = reinterpret_cast<const uint8_t*>(qs);
  float* yf = reinterpret_cast<float*>(y);
  const bool has_m = mins != nullptr;
#define QMM_RUN(P, S, M) run<P, S, M, false, STACKED>(st, xb, B, K, q, scales, mins, yf, N, gs, zp, sk)
  if (p4) {
    if (scales_bf16) { if (has_m) QMM_RUN(true, true, true); else QMM_RUN(true, true, false); }
    else { if (has_m) QMM_RUN(true, false, true); else QMM_RUN(true, false, false); }
  } else {
    if (scales_bf16) { if (has_m) QMM_RUN(false, true, true); else QMM_RUN(false, true, false); }
    else { if (has_m) QMM_RUN(false, false, true); else QMM_RUN(false, false, false); }
  }
#undef QMM_RUN
  return (int)cudaGetLastError();
}

// K5 (K7's K5 variant with STACKED)
template <bool STACKED>
int gdot_any(const void* x, const void* qs, const void* scales, const void* mins,
             void* y, int B, int K, int N, int zp, int scales_bf16, Stack sk,
             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const uint8_t* q = reinterpret_cast<const uint8_t*>(qs);
  float* yf = reinterpret_cast<float*>(y);
  const bool has_m = mins != nullptr;
#define GDOT_RUN(S, M) run<true, S, M, true, STACKED>(st, xb, B, K, q, scales, mins, yf, N, 32, zp, sk)
  if (scales_bf16) { if (has_m) GDOT_RUN(true, true); else GDOT_RUN(true, false); }
  else { if (has_m) GDOT_RUN(false, true); else GDOT_RUN(false, false); }
#undef GDOT_RUN
  return (int)cudaGetLastError();
}

}  // namespace
