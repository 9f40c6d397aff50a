// K3/K4 and K3q/K4q: flash attention over the head-major, unroped KV
// cache, for Hopper.
//
// Replaces the TPU kernels llm_tpu/ops/pallas_attn.py::flash_decode ->
// _kernel via _decode_body (K3, T <= 8) and flash_prefill ->
// _prefill_kernel via _prefill_body (K4, T > 8), and their int8-cache
// variants _kernel_q8 (K3q) and _prefill_kernel_q8 (K4q). All compute, for
// query row r = t*G + g of KV head h (query head h*G + g):
//
//   score[r,s] = (q.(k_s*cos_s) + q_rot.(k_s*sin_s)) * scale + max(bias[t,s], -1e30)
//   out[t, h*G+g] = sum_s softmax_s(score[r,:]) * v_s
//
// Rope stays folded into the scores exactly as on the TPU: K is cached
// unroped and cos/sin are full-width per-cell tables. The -inf mask is
// clamped to -1e30, so a fully masked (padding) row comes out finite; the
// online softmax starts from m = -1e30, l = 0 and divides by max(l, 1e-30).
// Every cache cell is read, filled or not: the bias masks empty cells.
// Loads are bounded by S (an out-of-range load is a fault on the GPU);
// cells past S take no part at all.
//
// Inputs: q, q_rot bf16 [T, H, D]; K/V bf16 [Hkv, S, D] (K3/K4) or int8
// [Hkv, S, D] with one bf16 scale per head row [Hkv, S, 1] (K3q/K4q);
// cos, sin bf16 [S, D]; bias f32 [T, S]. Output f32 [T, H, D]. D = 128.
//
// The two cache types differ only in how one cell's 4 dims of K and V are
// loaded, so the kernels are templates on a loader (Bf16KV, Q8KV), as the
// TPU kernels share _decode_body / _prefill_body. Q8KV dequantizes as the
// TPU kernel does, bf16(q) * bf16(s) rounded to bf16: (float)q * s is exact
// in f32 (8 + 8 significant bits), so __float2bfloat16_rn of it is that
// bf16 product bit for bit.
//
// K3/K3q (decode) are bound by the bytes of K, V, cos and sin (K3q reads
// half of K3's K/V bytes: 1 byte a dim plus 2 bytes a row). Their split-S
// kernel and its combine live in flash_decode.cuh, which flash_probe.cu
// (S3) shares: one CTA per (S split, KV head, chunk of 8 query rows), the
// splits' (m, l, acc) combined by a second small kernel.
//
// K4/K4q (prefill) are bound by operations. One CTA per (KV head, block of
// 64/G tokens) = 64 query rows, looping over S in blocks of 64 cells with
// the online softmax; the tile load dequantizes into f32 shared memory, and
// scores and P.V are plain f32 FMA loops over those tiles (no tensor cores
// yet).

#include "flash_decode.cuh"

namespace {

// ----------------------------------------------------------------------------
// K3: split-S decode (the CTA body is flash_decode.cuh's)

template <class KV>
__global__ void __launch_bounds__(DEC_WARPS * 32)
flash_decode_split(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ qr, const KV kv,
                   const __nv_bfloat16* __restrict__ cs,
                   const __nv_bfloat16* __restrict__ sn,
                   const float* __restrict__ bias, float* __restrict__ pm,
                   float* __restrict__ pl, float* __restrict__ pacc, int T,
                   int H, int Hkv, int S, float scale, int cells_per_split) {
  decode_split_cta(kv, q, qr, cs, sn, bias, pm, pl, pacc, T, H, Hkv, S, scale,
                   cells_per_split);
}

// ----------------------------------------------------------------------------
// K4: prefill

constexpr int PR = 64;   // query rows per CTA (= tokens per block * G)
constexpr int SB = 64;   // cells per S block
constexpr int PTHREADS = 256;
constexpr int DP = D + 4;  // padded row pitch (floats)
constexpr int SBP = SB + 4;

struct PrefillSmem {
  float q[PR][DP];
  float qr[PR][DP];
  float kc[SB][DP];
  float ks[SB][DP];
  float v[SB][DP];
  float p[PR][SBP];
  float m[PR], l[PR], alpha[PR];
};

template <class KV>
__global__ void __launch_bounds__(PTHREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ qr, const KV kv,
                     const __nv_bfloat16* __restrict__ cs,
                     const __nv_bfloat16* __restrict__ sn,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int T, int H, int Hkv, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PrefillSmem& sm = *reinterpret_cast<PrefillSmem*>(smem_raw);
  const int h = blockIdx.x;
  const int G = H / Hkv;
  const int tb = PR / G;  // tokens per block
  const int t0 = blockIdx.y * tb;
  const int tid = threadIdx.x;

  for (int i = tid; i < PR * D / 4; i += PTHREADS) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4;
    const int t = t0 + r / G, g = r % G;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < T) {
      const size_t off = ((size_t)t * H + h * G + g) * D + d;
      ld4(q + off, a);
      ld4(qr + off, b);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sm.q[r][d + j] = a[j];
      sm.qr[r][d + j] = b[j];
    }
  }
  for (int r = tid; r < PR; r += PTHREADS) {
    sm.m[r] = NEG;
    sm.l[r] = 0.f;
  }
  // P.V register tile: rows ra + 16i, dims 4*da + {0..3} and 64 + 4*da + {0..3}
  const int ra = tid / 16, da = tid % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int sb = 0; sb < S; sb += SB) {
    __syncthreads();
    for (int i = tid; i < SB * D / 4; i += PTHREADS) {
      const int c = i / (D / 4), d = (i % (D / 4)) * 4;
      const int s = sb + c;
      float kk[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
      float cc[4] = {0.f, 0.f, 0.f, 0.f}, ss[4] = {0.f, 0.f, 0.f, 0.f};
      if (s < S) {
        kv.load(h, s, S, d, kk, vv);
        ld4(cs + (size_t)s * D + d, cc);
        ld4(sn + (size_t)s * D + d, ss);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sm.kc[c][d + j] = kk[j] * cc[j];
        sm.ks[c][d + j] = kk[j] * ss[j];
        sm.v[c][d + j] = vv[j];
      }
    }
    __syncthreads();
    {  // scores: rows tr + 16i, cells tc + 16j
      const int tr = tid / 16, tc = tid % 16;
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int d = 0; d < D; d += 4) {
        float4 qa[4], qb[4], ka[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = *reinterpret_cast<const float4*>(&sm.q[tr + 16 * i][d]);
          qb[i] = *reinterpret_cast<const float4*>(&sm.qr[tr + 16 * i][d]);
          ka[i] = *reinterpret_cast<const float4*>(&sm.kc[tc + 16 * i][d]);
          kb[i] = *reinterpret_cast<const float4*>(&sm.ks[tc + 16 * i][d]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = sc[i][j];
            a = fmaf(qa[i].x, ka[j].x, a); a = fmaf(qa[i].y, ka[j].y, a);
            a = fmaf(qa[i].z, ka[j].z, a); a = fmaf(qa[i].w, ka[j].w, a);
            a = fmaf(qb[i].x, kb[j].x, a); a = fmaf(qb[i].y, kb[j].y, a);
            a = fmaf(qb[i].z, kb[j].z, a); a = fmaf(qb[i].w, kb[j].w, a);
            sc[i][j] = a;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr + 16 * i;
        const int t = min(t0 + r / G, T - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + 16 * j, s = sb + c;
          // cells past S get p = 0 exactly (-inf, not the -1e30 clamp), so
          // K4, like K3, attends over exactly S cells
          sm.p[r][c] = s < S ? sc[i][j] * scale + fmaxf(bias[(size_t)t * S + s], NEG)
                             : __int_as_float(0xff800000u);
        }
      }
    }
    __syncthreads();
    {  // online softmax: 4 threads per row, 16 cells each
      const int r = tid / 4, sub = tid % 4;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, sm.p[r][sub * 16 + j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mold = sm.m[r];
      const float mn = fmaxf(mold, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = __expf(sm.p[r][sub * 16 + j] - mn);
        sm.p[r][sub * 16 + j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (sub == 0) {
        const float alpha = __expf(mold - mn);
        sm.alpha[r] = alpha;
        sm.l[r] = sm.l[r] * alpha + sum;
        sm.m[r] = mn;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = sm.alpha[ra + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < SB; ++c) {
      const float4 va = *reinterpret_cast<const float4*>(&sm.v[c][4 * da]);
      const float4 vb = *reinterpret_cast<const float4*>(&sm.v[c][64 + 4 * da]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sm.p[ra + 16 * i][c];
        acc[i][0] = fmaf(p, va.x, acc[i][0]); acc[i][1] = fmaf(p, va.y, acc[i][1]);
        acc[i][2] = fmaf(p, va.z, acc[i][2]); acc[i][3] = fmaf(p, va.w, acc[i][3]);
        acc[i][4] = fmaf(p, vb.x, acc[i][4]); acc[i][5] = fmaf(p, vb.y, acc[i][5]);
        acc[i][6] = fmaf(p, vb.z, acc[i][6]); acc[i][7] = fmaf(p, vb.w, acc[i][7]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ra + 16 * i;
    const int t = t0 + r / G, g = r % G;
    if (t < T) {
      const float inv = 1.f / fmaxf(sm.l[r], 1e-30f);
      float* o = out + ((size_t)t * H + h * G + g) * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[4 * da + j] = acc[i][j] * inv;
        o[64 + 4 * da + j] = acc[i][4 + j] * inv;
      }
    }
  }
}
template <class KV>
int launch_prefill(const void* q, const void* qr, const KV& kv, const void* cs,
                   const void* sn, const void* bias, void* out, int T, int H,
                   int Hkv, int S, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  const int tb = PR / G;
  const int smem = (int)sizeof(PrefillSmem);
  static bool smem_set = false;  // once per loader, outside any later graph capture
  if (!smem_set) {
    cudaFuncSetAttribute(flash_prefill_kernel<KV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = true;
  }
  dim3 grid(Hkv, (T + tb - 1) / tb);
  using bf = __nv_bfloat16;
  flash_prefill_kernel<KV><<<grid, PTHREADS, smem, st>>>(
      (const bf*)q, (const bf*)qr, kv, (const bf*)cs, (const bf*)sn,
      (const float*)bias, (float*)out, T, H, Hkv, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch for K3/K3q: pm, pl [Hkv * T*G * n_splits] f32, pacc [.. * D] f32,
// sized by the caller from flash_decode_splits().
extern "C" int flash_decode_splits(int S, int Hkv, int T, int H, int sms) {
  return decode_splits(S, Hkv, T, H, sms);
}

extern "C" int flash_decode_launch(const void* q, const void* qr, const void* k,
                                   const void* v, const void* cs, const void* sn,
                                   const void* bias, void* out, void* pm,
                                   void* pl, void* pacc, int T, int H, int Hkv,
                                   int S, float scale, int n_splits,
                                   void* stream) {
  const Bf16KV kv{(const __nv_bfloat16*)k, (const __nv_bfloat16*)v};
  return launch_decode(flash_decode_split<Bf16KV>, q, qr, kv, cs, sn, bias, out, pm,
                       pl, pacc, T, H, Hkv, S, scale, n_splits, stream);
}

extern "C" int flash_decode_q8_launch(const void* q, const void* qr, const void* k,
                                      const void* ks, const void* v, const void* vs,
                                      const void* cs, const void* sn,
                                      const void* bias, void* out, void* pm,
                                      void* pl, void* pacc, int T, int H,
                                      int Hkv, int S, float scale, int n_splits,
                                      void* stream) {
  const Q8KV kv{(const int8_t*)k, (const __nv_bfloat16*)ks, (const int8_t*)v,
                (const __nv_bfloat16*)vs};
  return launch_decode(flash_decode_split<Q8KV>, q, qr, kv, cs, sn, bias, out, pm,
                       pl, pacc, T, H, Hkv, S, scale, n_splits, stream);
}

extern "C" int flash_prefill_launch(const void* q, const void* qr, const void* k,
                                    const void* v, const void* cs,
                                    const void* sn, const void* bias, void* out,
                                    int T, int H, int Hkv, int S, float scale,
                                    void* stream) {
  const Bf16KV kv{(const __nv_bfloat16*)k, (const __nv_bfloat16*)v};
  return launch_prefill(q, qr, kv, cs, sn, bias, out, T, H, Hkv, S, scale, stream);
}

extern "C" int flash_prefill_q8_launch(const void* q, const void* qr, const void* k,
                                       const void* ks, const void* v,
                                       const void* vs, const void* cs,
                                       const void* sn, const void* bias,
                                       void* out, int T, int H, int Hkv, int S,
                                       float scale, void* stream) {
  const Q8KV kv{(const int8_t*)k, (const __nv_bfloat16*)ks, (const int8_t*)v,
                (const __nv_bfloat16*)vs};
  return launch_prefill(q, qr, kv, cs, sn, bias, out, T, H, Hkv, S, scale, stream);
}
