// S3: the flash-decode layout and q8 dequant probes, for Hopper (sm_90a).
//
// Replaces the TPU package's timing probes of the decode attention kernel:
//   scripts/kbench7.py:156 v1_stacked (pallas_call :188, kernel _hm_kernel
//     :102): head-major decode over stacked [NB, Hkv, S, D] caches, the
//     buffer picked by a scalar-prefetch index;
//   scripts/kbench7.py:47 v0_stacked (pallas_call :79): the production
//     decode kernel over stacked seq-major [NB, S, Hkv, D] caches. (That
//     script's shim no longer runs: it hands the head-major body a
//     seq-major block on a 1-D grid. This is what its docstring says it
//     measures.)
//   scripts/kbench9.py:35 _mk_kernel (pallas_call :79): the q8 cache's
//     dequant, modes "noscale" (the int8 values, scales read but not
//     applied), "full" (int8 x bf16 scale kept in f32) and "bf16" (the
//     production K3q dequant, rounded to bf16).
//
// Every probe is the split-S decode of flash_decode.cuh (its CTA body and
// combine, on its grid; K3/K3q run flash_attn.cu's flash_decode_tc) with
// another loader, so the probes' times differ from one another only by how
// a cell's K/V are addressed and dequantized:
//   v1        Stacked<Bf16KV>: buffer *lidx of [NB, Hkv, S, D];
//   v0        Stacked<Bf16KVSeqMajor>: buffer *lidx of [NB, S, Hkv, D],
//             cell (s, h) at ((s*Hkv + h)*D); each row is still 256
//             contiguous bytes, so a warp's load is as coalesced as v1's;
//   noscale   Q8KVNoScale, full Q8KVF32, bf16 Q8KV (the body's K3q loader),
//             on int8 [Hkv, S, D] with bf16 scales [Hkv, S].
// The buffer index lives in device memory and every CTA reads it once (as
// K7 reads its layer index), so a CUDA graph of launches that each name
// another index cycles the buffers past the 50 MB L2, as the TPU's scalar
// prefetch did. The split size (cells per CTA) is a launch parameter, the
// body's own choice (decode_splits) the default. Bound by the bytes of K, V (and
// scales), cos and sin; the sweep over split sizes shows what bounds it
// instead.

#include "flash_decode.cuh"

namespace {

// v0's loader: the cache seq-major [S, Hkv, D].
struct Bf16KVSeqMajor {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int hkv;
  __device__ __forceinline__ void load(int h, int s, int S, int d0, float kk[4],
                                       float vv[4]) const {
    const size_t off = ((size_t)s * hkv + h) * D + d0;
    ld4(k + off, kk);
    ld4(v + off, vv);
  }
  __device__ __forceinline__ Bf16KVSeqMajor shifted(size_t o) const {
    return {k + o, v + o, hkv};
  }
};

// Buffer *lidx of a stack of caches, `stride` elements apart.
template <class L>
struct Stacked {
  L kv;  // buffer 0
  const int* lidx;
  size_t stride;
};

template <class L>
__device__ __forceinline__ L bind(const L& kv) {
  return kv;
}

template <class L>
__device__ __forceinline__ L bind(const Stacked<L>& st) {
  return st.kv.shifted((size_t)__ldg(st.lidx) * st.stride);
}

// The scale's two bytes are loaded (volatile, so that no compiler drops the
// load) and not used: the TPU probe moved the scale blocks and skipped the
// multiply.
__device__ __forceinline__ void touch(const __nv_bfloat16* p) {
  unsigned short r;
  asm volatile("ld.volatile.global.u16 %0, [%1];" : "=h"(r) : "l"(p));
}

__device__ __forceinline__ void i8x4(const int8_t* p, float out[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  out[0] = (float)c.x; out[1] = (float)c.y; out[2] = (float)c.z; out[3] = (float)c.w;
}

struct Q8KVNoScale {
  const int8_t* k;
  const __nv_bfloat16* ks;
  const int8_t* v;
  const __nv_bfloat16* vs;
  __device__ __forceinline__ void load(int h, int s, int S, int d0, float kk[4],
                                       float vv[4]) const {
    const size_t row = (size_t)h * S + s;
    touch(ks + row);
    touch(vs + row);
    i8x4(k + row * D + d0, kk);
    i8x4(v + row * D + d0, vv);
  }
};

// kbench9's "full": q * s in f32, not rounded (exact: 8 + 8 significant bits)
struct Q8KVF32 {
  const int8_t* k;
  const __nv_bfloat16* ks;
  const int8_t* v;
  const __nv_bfloat16* vs;
  __device__ __forceinline__ void load(int h, int s, int S, int d0, float kk[4],
                                       float vv[4]) const {
    const size_t row = (size_t)h * S + s;
    const float sk = __bfloat162float(ks[row]), sv = __bfloat162float(vs[row]);
    i8x4(k + row * D + d0, kk);
    i8x4(v + row * D + d0, vv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] *= sk;
      vv[j] *= sv;
    }
  }
};

template <class KV>
__global__ void __launch_bounds__(DEC_WARPS * 32)
flash_probe_split(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ qr, const KV kv,
                  const __nv_bfloat16* __restrict__ cs,
                  const __nv_bfloat16* __restrict__ sn,
                  const float* __restrict__ bias, float* __restrict__ pm,
                  float* __restrict__ pl, float* __restrict__ pacc, int T, int H,
                  int Hkv, int S, float scale, int cells_per_split) {
  decode_split_cta(bind(kv), q, qr, cs, sn, bias, pm, pl, pacc, T, H, Hkv, S, scale,
                   cells_per_split);
}

using bf = __nv_bfloat16;

}  // namespace

// Splits for a probe launch: cells_per_split > 0 asks for splits of that
// many cells, 0 for the body's own choice. The caller sizes the scratch
// from it: pm, pl [Hkv * T*G * n_splits] f32, pacc [.. * D] f32.
extern "C" int flash_probe_splits(int S, int Hkv, int T, int H, int sms,
                                  int cells_per_split) {
  if (cells_per_split > 0) return (S + cells_per_split - 1) / cells_per_split;
  return decode_splits(S, Hkv, T, H, sms);
}

// v1 (seq_major 0) or v0 (seq_major 1) on buffer *lidx (int32 in device
// memory) of bf16 stacks [NB, Hkv, S, D] or [NB, S, Hkv, D]; q, qr, cos,
// sin, bias and out as K3's (flash_attn.cu), then the scratch and the
// splits.
extern "C" int flash_probe_stacked_launch(int seq_major, const void* q, const void* qr,
                                          const void* k, const void* v, const void* lidx,
                                          const void* cs, const void* sn, const void* bias,
                                          void* out, void* pm, void* pl, void* pacc, int T,
                                          int H, int Hkv, int S, float scale, int n_splits,
                                          void* stream) {
  const size_t stride = (size_t)Hkv * S * D;
  const int* ix = reinterpret_cast<const int*>(lidx);
  if (seq_major) {
    const Stacked<Bf16KVSeqMajor> kv{{(const bf*)k, (const bf*)v, Hkv}, ix, stride};
    return launch_decode(flash_probe_split<Stacked<Bf16KVSeqMajor>>, q, qr, kv, cs, sn,
                         bias, out, pm, pl, pacc, T, H, Hkv, S, scale, n_splits, stream);
  }
  const Stacked<Bf16KV> kv{{(const bf*)k, (const bf*)v}, ix, stride};
  return launch_decode(flash_probe_split<Stacked<Bf16KV>>, q, qr, kv, cs, sn, bias, out,
                       pm, pl, pacc, T, H, Hkv, S, scale, n_splits, stream);
}

// The q8 modes on int8 [Hkv, S, D] K/V with bf16 scales [Hkv, S]: mode 0
// noscale, 1 full, 2 bf16 (K3q's dequant); the other arguments as
// flash_probe_stacked_launch's.
extern "C" int flash_probe_q8_launch(int mode, const void* q, const void* qr, const void* k,
                                     const void* ks, const void* v, const void* vs,
                                     const void* cs, const void* sn, const void* bias,
                                     void* out, void* pm, void* pl, void* pacc, int T, int H,
                                     int Hkv, int S, float scale, int n_splits,
                                     void* stream) {
  const int8_t *k8 = (const int8_t*)k, *v8 = (const int8_t*)v;
  const bf *ksb = (const bf*)ks, *vsb = (const bf*)vs;
  if (mode == 0)
    return launch_decode(flash_probe_split<Q8KVNoScale>, q, qr, Q8KVNoScale{k8, ksb, v8, vsb},
                         cs, sn, bias, out, pm, pl, pacc, T, H, Hkv, S, scale, n_splits,
                         stream);
  if (mode == 1)
    return launch_decode(flash_probe_split<Q8KVF32>, q, qr, Q8KVF32{k8, ksb, v8, vsb}, cs, sn,
                         bias, out, pm, pl, pacc, T, H, Hkv, S, scale, n_splits, stream);
  if (mode == 2)
    return launch_decode(flash_probe_split<Q8KV>, q, qr, Q8KV{k8, ksb, v8, vsb}, cs, sn, bias,
                         out, pm, pl, pacc, T, H, Hkv, S, scale, n_splits, stream);
  return (int)cudaErrorInvalidValue;
}
