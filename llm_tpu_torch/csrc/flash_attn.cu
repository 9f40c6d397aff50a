// K3 and K3q: flash decode (T <= 8) over the head-major, unroped KV cache,
// for Hopper.
//
// Replaces the TPU kernels llm_tpu/ops/pallas_attn.py::flash_decode ->
// _kernel via _decode_body (K3) and its int8-cache variant _kernel_q8
// (K3q). Both compute, for query row r = t*G + g of KV head h (query head
// h*G + g):
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
// Inputs: q, q_rot bf16 [T, H, D]; K/V bf16 [Hkv, S, D] (K3) or int8
// [Hkv, S, D] with one bf16 scale per head row [Hkv, S, 1] (K3q); cos, sin
// bf16 [S, D]; bias f32 [T, S]. Output f32 [T, H, D]. D = 128.
//
// The two cache types differ only in how one cell's 4 dims of K and V are
// loaded, so the kernel is a template on a loader (Bf16KV, Q8KV), as the
// TPU kernels share _decode_body. Q8KV dequantizes as the TPU kernel does,
// bf16(q) * bf16(s) rounded to bf16: (float)q * s is exact in f32 (8 + 8
// significant bits), so __float2bfloat16_rn of it is that bf16 product bit
// for bit.
//
// K3/K3q are bound by the bytes of K, V, cos and sin (K3q reads half of
// K3's K/V bytes: 1 byte a dim plus 2 bytes a row). Their split-S kernel
// and its combine live in flash_decode.cuh, which flash_probe.cu (S3)
// shares: one CTA per (S split, KV head, chunk of 8 query rows), the
// splits' (m, l, acc) combined by a second small kernel.
//
// The prefill kernels K4/K4q (T > 8) are flash_prefill.cu's, a library of
// their own, so that these kernels keep their machine code.

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
