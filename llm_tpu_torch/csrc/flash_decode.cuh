// The split-S flash decode that only the S3 probes run (flash_probe.cu: the
// layout and dequant probes; K3/K3q run flash_attn.cu's flash_decode_tc):
// the K/V loaders, the CTA body of the split kernel, the combine kernel, the
// choice of split and the launch of the two.
//
// For query row r = t*G + g of KV head h (query head h*G + g):
//
//   score[r,s] = (q.(k_s*cos_s) + q_rot.(k_s*sin_s)) * scale + max(bias[t,s], -1e30)
//   out[t, h*G+g] = sum_s softmax_s(score[r,:]) * v_s
//
// One CTA per (S split, KV head, chunk of 8 query rows): the Hkv x 1 grid
// alone would fill 8 of 132 SMs, so S is split (flash-decoding) and a
// second small kernel combines the splits' (m, l, acc). Each warp walks its
// cells; its 32 lanes hold 4 of the 128 dims, so one cell's K/V/cos/sin rows
// are coalesced loads (256 bytes of bf16, or 128 bytes of int8 read as one
// char4 a lane plus the row's scale as a broadcast), and the dot products
// finish with warp shuffles. The online softmax starts from m = -1e30, l = 0
// and the combine divides by max(l, 1e-30), so a fully masked row is finite.
// Its bound is the bytes of K, V, cos and sin, but on the H100 its time is
// each warp's walk over its cells, one dependent load-dot-exp chain a cell
// (S3's split sweep, PERF.md): more cells in flight is what would speed it.
//
// A loader gives dims d0..d0+3 of cell s of KV head h as f32; a kernel
// calls decode_split_cta with the loader it has bound to its buffer (the
// int8 modes pass theirs as they are; the stacked loaders first read the
// buffer index, once a CTA).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float out[4]) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// Loaders: dims d0..d0+3 of cell s of KV head h, as f32.
struct Bf16KV {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __device__ __forceinline__ void load(int h, int s, int S, int d0, float kk[4],
                                       float vv[4]) const {
    const size_t off = ((size_t)h * S + s) * D + d0;
    ld4(k + off, kk);
    ld4(v + off, vv);
  }
  // the same cache o elements further on (S3's stacked buffers)
  __device__ __forceinline__ Bf16KV shifted(size_t o) const { return {k + o, v + o}; }
};

__device__ __forceinline__ void dq4(const int8_t* p, __nv_bfloat16 sc, float out[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  const float s = __bfloat162float(sc);
  out[0] = __bfloat162float(__float2bfloat16_rn((float)c.x * s));
  out[1] = __bfloat162float(__float2bfloat16_rn((float)c.y * s));
  out[2] = __bfloat162float(__float2bfloat16_rn((float)c.z * s));
  out[3] = __bfloat162float(__float2bfloat16_rn((float)c.w * s));
}

struct Q8KV {
  const int8_t* k;
  const __nv_bfloat16* ks;  // [Hkv, S] (the trailing 1 dropped)
  const int8_t* v;
  const __nv_bfloat16* vs;
  __device__ __forceinline__ void load(int h, int s, int S, int d0, float kk[4],
                                       float vv[4]) const {
    const size_t row = (size_t)h * S + s;
    dq4(k + row * D + d0, ks[row], kk);
    dq4(v + row * D + d0, vs[row], vv);
  }
};

// ----------------------------------------------------------------------------
// split-S decode

constexpr int DEC_WARPS = 4;
constexpr int RC = 8;  // query rows per CTA

// The work of one CTA of a split kernel (DEC_WARPS * 32 threads): split
// blockIdx.x of S, KV head blockIdx.y, query rows 8*blockIdx.z.., written to
// the partials pm, pl, pacc. A kernel passes its __restrict__ parameters
// through, so its loads are those of a kernel that holds the body itself.
template <class KV>
__device__ __forceinline__ void decode_split_cta(
    const KV& kv, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ qr, const __nv_bfloat16* __restrict__ cs,
    const __nv_bfloat16* __restrict__ sn, const float* __restrict__ bias,
    float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc,
    int T, int H, int Hkv, int S, float scale, int cells_per_split) {
  const int split = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * RC;
  const int n_splits = gridDim.x;
  const int G = H / Hkv, TG = T * G;
  const int nr = min(RC, TG - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * 4;

  __shared__ float wm[DEC_WARPS][RC], wl[DEC_WARPS][RC];
  __shared__ float wacc[DEC_WARPS][RC][D];

  // this lane's 4 dims of the chunk's query rows
  float qv[RC][4], qrv[RC][4];
  int tok[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int rg = r0 + min(r, nr - 1);
    const int t = rg / G, g = rg % G;
    tok[r] = t;
    const size_t off = ((size_t)t * H + h * G + g) * D + d0;
    ld4(q + off, qv[r]);
    ld4(qr + off, qrv[r]);
  }
  float m[RC], l[RC], acc[RC][4];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }

  const int s0 = split * cells_per_split;
  const int s1 = min(S, s0 + cells_per_split);
  for (int s = s0 + warp; s < s1; s += DEC_WARPS) {
    float kk[4], vv[4], cc[4], ss[4], kc[4], ks[4];
    kv.load(h, s, S, d0, kk, vv);
    ld4(cs + (size_t)s * D + d0, cc);
    ld4(sn + (size_t)s * D + d0, ss);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kc[j] = kk[j] * cc[j];
      ks[j] = kk[j] * ss[j];
    }
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r < nr) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) dot = fmaf(qv[r][j], kc[j], fmaf(qrv[r][j], ks[j], dot));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const float sc = dot * scale + fmaxf(bias[(size_t)tok[r] * S + s], NEG);
        const float mn = fmaxf(m[r], sc);
        const float alpha = __expf(m[r] - mn);
        const float p = __expf(sc - mn);
        l[r] = l[r] * alpha + p;
        m[r] = mn;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j] * alpha);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RC; ++r) {
    if (lane == 0) {
      wm[warp][r] = m[r];
      wl[warp][r] = l[r];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wacc[warp][r][d0 + j] = acc[r][j];
  }
  __syncthreads();
  // combine the CTA's warps; thread = one dim, loop over rows
  for (int i = threadIdx.x; i < nr * D; i += DEC_WARPS * 32) {
    const int r = i / D, d = i % D;
    float M = NEG;
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, wm[w][r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float e = __expf(wm[w][r] - M);
      L += wl[w][r] * e;
      A += wacc[w][r][d] * e;
    }
    const size_t row = ((size_t)h * TG + r0 + r) * n_splits + split;
    pacc[row * D + d] = A;
    if (d == 0) {
      pm[row] = M;
      pl[row] = L;
    }
  }
}


__global__ void __launch_bounds__(D)
flash_decode_combine(const float* __restrict__ pm, const float* __restrict__ pl,
                     const float* __restrict__ pacc, float* __restrict__ out,
                     int T, int H, int Hkv, int n_splits) {
  const int h = blockIdx.x, rg = blockIdx.y, d = threadIdx.x;
  const int G = H / Hkv, TG = T * G;
  const size_t base = ((size_t)h * TG + rg) * n_splits;
  float M = NEG;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, pm[base + s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float e = __expf(pm[base + s] - M);
    L += pl[base + s] * e;
    A += pacc[(base + s) * D + d] * e;
  }
  const int t = rg / G, g = rg % G;
  out[((size_t)t * H + h * G + g) * D + d] = A / fmaxf(L, 1e-30f);
}

// The default split: about two CTAs per SM, and at least 64 cells per split.
inline int decode_splits(int S, int Hkv, int T, int H, int sms) {
  const int G = H / Hkv;
  const int chunks = (T * G + RC - 1) / RC;
  int n = (2 * sms + Hkv * chunks - 1) / (Hkv * chunks);
  n = max(1, min(n, (S + 63) / 64));
  return n;
}

// The split kernel's parameters: q, q_rot, loader, cos, sin, bias, pm, pl,
// pacc, T, H, Hkv, S, scale, cells_per_split.
template <class KV>
using SplitKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const KV,
                             const __nv_bfloat16*, const __nv_bfloat16*, const float*,
                             float*, float*, float*, int, int, int, int, float, int);

// Scratch: pm, pl [Hkv * T*G * n_splits] f32, pacc [.. * D] f32.
template <class KV>
int launch_decode(SplitKernel<KV> split_kernel, const void* q, const void* qr,
                  const KV& kv, const void* cs, const void* sn, const void* bias,
                  void* out, void* pm, void* pl, void* pacc, int T, int H, int Hkv,
                  int S, float scale, int n_splits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  const int chunks = (T * G + RC - 1) / RC;
  const int cps = (S + n_splits - 1) / n_splits;
  dim3 grid(n_splits, Hkv, chunks);
  using bf = __nv_bfloat16;
  split_kernel<<<grid, DEC_WARPS * 32, 0, st>>>(
      (const bf*)q, (const bf*)qr, kv, (const bf*)cs, (const bf*)sn,
      (const float*)bias, (float*)pm, (float*)pl, (float*)pacc, T, H, Hkv, S,
      scale, cps);
  flash_decode_combine<<<dim3(Hkv, T * G), D, 0, st>>>(
      (const float*)pm, (const float*)pl, (const float*)pacc, (float*)out, T,
      H, Hkv, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace
