// K4/K4q's CTA body: flash prefill (T > 8) over the head-major, unroped KV
// cache, for Hopper (sm_90a). The library's kernels are csrc/flash_prefill.cu.
//
// Replaces the TPU kernels llm_tpu/ops/pallas_attn.py::flash_prefill ->
// _prefill_kernel (K4, bf16 cache) and _prefill_kernel_q8 (K4q, int8 cache
// with one bf16 scale a head row), both via _prefill_body. For query row
// r = t*G + g of KV head h (query head h*G + g):
//
//   score[r,s] = (q.(k_s*cos_s) + q_rot.(k_s*sin_s)) * scale + max(bias[t,s], -1e30)
//   out[t, h*G+g] = sum_s softmax_s(score[r,:]) * v_s
//
// as csrc/flash_attn.cu's decode kernels compute it: the -inf mask is
// clamped to -1e30, so a fully masked (padding) row comes out finite; the
// online softmax starts from m = -1e30, l = 0 and divides by max(l, 1e-30);
// every cache cell is read, filled or not (the bias masks empty cells);
// cells past S take no part at all (score -inf, p = 0 exactly).
//
// Inputs: q, q_rot bf16 [T, H, D]; K/V bf16 [Hkv, S, D] (K4) or int8
// [Hkv, S, D] with bf16 scales [Hkv, S] (K4q); cos, sin bf16 [S, D]; bias
// f32 [T, S]. Output f32 [T, H, D]. D = Dk = Dv a multiple of 8 up to 128
// (K4q: of 16, the int8 rows' TMA pitch), any G = H / Hkv.
//
// Head dims below 128: the CTA holds a block as 128 dims whatever D is. The
// tensor maps have the true width D, so TMA fills the columns past D of the
// raw block (and of K4's V tile: its whole second half where D <= 64) with
// zeros; q's fragments are zero there too, and the zeros add nothing to the
// scores or to P.V. Only D output columns are stored. The tensor work stays
// that of D = 128, 128 / D times what D needs (PERF.md). prefill_consumers
// takes D as a template constant (128 for flash_prefill_wgmma; 64, 80, 96
// for flash_prefill_wgmma_dim) or at run time (DT = 0: a.D).
//
// Bound: operations (6 T H S D: two score dots of D and one P.V of D per
// query row and cell). The tensor cores need bf16 operands, and the f32
// function is held at 1e-3, so the operands are split exactly:
//  * k, cos and sin are bf16 (8 significant bits), so k*cos and k*sin have
//    at most 16 and are exact in f32; hi = their upper 16 bits and lo = the
//    rest (at most 8 significant bits) are bf16 values whose sum is exact.
//    The scores are one chain [q | q_rot | q | q_rot] . [kc_hi | ks_hi |
//    kc_lo | ks_lo] (K = 512) into an f32 accumulator: the products of the
//    TPU body's f32 dots.
//  * p in [0, 1] becomes P_hi = bf16(p), P_lo = bf16(p - P_hi): 16 bits,
//    an error of 2^-17 of p; O += P_hi.V + P_lo.V, V exact in bf16 (K4q's
//    dequantized as the TPU kernel does, bf16(bf16(q) * bf16(s))); l sums
//    the f32 p.
// One rounding of either (FlashAttention's choice) misses the 1e-3 check at
// T=512 S=1024 (tests/test_torch_flash_prefill.py). The split doubles the
// tensor work: 12 T H S D operations, the kernel's floor.
//
// Shape of the kernel (warp-specialized, as Hopper attention kernels are):
//  * a CTA owns 128 query rows r = t*G + g of one KV head outright and
//    walks all of S in blocks of 64 cells: no split over S and no atomics,
//    so a launch is deterministic. Grid ceil(T*G/128) x Hkv (128 CTAs at
//    T = 512, G = 4: one wave on 132 SMs). Each row is its own softmax, so a
//    token's G rows may fall in two CTAs (where 128 % G != 0): a row reads
//    q of its head and the bias row of its token, r / G, as the reference's
//    T*G tiling does.
//  * 384 threads: two consumer warpgroups of 64 rows, and a producer
//    warpgroup (setmaxnreg 56 / 224). The consumers hold their rows' q and
//    q_rot as wgmma A fragments in registers for the whole launch (64 a
//    thread), the 64x128 O accumulator (64) and a 64x64 score accumulator
//    (32).
//  * shared memory: a ring of 2 stages, each one S block's K-side planes
//    kc_hi, ks_hi, kc_lo, ks_lo and V, each [64 cells][128 dims] bf16 as two
//    64-dim halves in the 128-byte swizzle (80 KB), and one raw block (48
//    KB). Lane 0 of the producer has TMA bring each block's K (K4q: int8 K
//    and V), cos and sin into the raw block (the cells past S read as
//    zero), one block ahead, and K4's V straight into its stage slot; the
//    128 lanes turn the raw block into the planes (and K4q's V, dequantized)
//    with byte permutes, no conversion instruction, and fence the async
//    proxy before lane 0's next TMA refills the raw block they read and
//    before the stage's full barrier releases the planes they wrote. The
//    producer alone takes about half the kernel's time
//    (tools/prefill_split.py, which times each side alone from
//    csrc/flash_prefill_probe.cu; PERF.md).
//  * the consumers read the bias rows of their two rows from global memory,
//    one block ahead (no 16-byte pitch when S % 4 != 0, and [128/G][64] f32
//    a stage would not fit beside the ring at G = 1).
//  * per S block a consumer warpgroup runs the score chain (32 wgmma
//    m64n64k16, A = q / q_rot from registers, B = a plane, K-major), then
//    the scale, bias, mask and online softmax in registers, in log2 units
//    (s' = (s * scale + max(bias, -1e30)) * log2 e, p = 2^(s' - m'), row max
//    and sum by quad shuffles), rescales O where a row's max moved, turns p
//    into P_hi / P_lo register A fragments (the score accumulator's layout
//    is the A operand's), and runs P.V (8 wgmma m64n128k16, B = V read
//    MN-major from the same swizzled tile). The two warpgroups take turns to
//    issue their chains (named barriers), so that one's softmax runs while
//    the other's chain does; a warpgroup releases the stage once both its
//    chains have retired.
//
// gemma2's attention softcap (pallas_attn.py _prefill_body's softcap term)
// is the CAP instantiation of the consumers: cap log2e * tanhf(s * scale /
// cap) + max(bias, -1e30) log2e in place of the one fmaf, in kernels of
// their own (flash_prefill_wgmma_cap) at Dk = Dv <= 128.
//
// ALiBi (pallas_attn.py _prefill_body's slopes_ref / dist_ref term, score
// -= slope_h * (pos_q - pos_k) after the scale and before the bias) is the
// ALIBI instantiation of the producer and the consumers. Every ALiBi model
// runs rope NONE, so it folds no rope: the producer has TMA bring K (K4q:
// K and V) alone into the raw block and writes k itself as the one K-side
// plane (k is bf16, or K4q's dequantized bf16: exact, no hi / lo split),
// and the consumers hold q alone and run one score chain of 8 wgmma in
// place of 32. Its inputs are the positions, tok_pos [T] and cell_pos [S]
// f32: each thread reads its two rows' slopes (head h*G + r % G) and token
// positions once and folds slope log2e * (tok_pos - cell_pos) into the
// bias term of the one fmaf, one block ahead with the bias rows
// (load_bias_alibi): one load a cell of cell_pos, shared by every row of
// the CTA. The difference of two integer positions below 2^24 is exact in
// f32, the reference's dist. (A dist [T, S] row a query row beside each
// bias row cost 1.85x K4's time at Baichuan-13B's G = 1; PERF.md.)

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

constexpr int FP_D = 128;  // head dims a block holds (D <= 128)
constexpr float FP_NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FP_ROWS = 128;  // query rows a CTA
constexpr int FP_SB = 64;     // cells a stage
constexpr int FP_STAGES = 2;
constexpr int FP_CONSUMERS = 256;
constexpr int FP_THREADS = FP_CONSUMERS + 128;
constexpr int FP_PRODUCER_REGS = 56;  // 2 x 128 x 224 + 128 x 56 = 384 x 168
constexpr int FP_CONSUMER_REGS = 224;
// the capped instantiation: tanhf's temporaries do not fit 224 registers
// beside q, O, the scores and the bias rows (300 bytes of spills; 40 / 232
// ran Gemma-2-27B's capped step 7% faster on an H100, PERF.md)
constexpr int FP_CAP_PRODUCER_REGS = 40;  // 2 x 128 x 232 + 128 x 40 = 384 x 168
constexpr int FP_CAP_CONSUMER_REGS = 232;
constexpr int FP_HALF = FP_SB * 128;       // bytes of a [64 cells][64 dims] bf16 half
constexpr int FP_PLANE = 2 * FP_HALF;      // one [64][128] plane
constexpr int FP_V_OFF = 4 * FP_PLANE;     // after kc_hi, ks_hi, kc_lo, ks_lo
constexpr int FP_STAGE = FP_V_OFF + FP_PLANE;
// the raw block the producer converts, by TMA, row-major: K bf16 [64][128]
// (K4q: int8 K [64][128], then int8 V), cos, sin bf16 [64][128]
constexpr int FP_RAW = FP_STAGES * FP_STAGE;
constexpr int FP_RAW_V8 = FP_SB * FP_D;     // K4q's V after its K
constexpr int FP_RAW_C = FP_PLANE, FP_RAW_S = 2 * FP_PLANE;
constexpr int FP_RAW_BYTES = 3 * FP_PLANE;  // K4 and K4q alike
constexpr int FP_SMEM = FP_RAW + FP_RAW_BYTES + 1024;  // + 1024 to align

struct PrefillArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* qr;
  const void* k;
  const __nv_bfloat16* ks;  // K4q: [Hkv, S] scales; null for K4
  const void* v;
  const __nv_bfloat16* vs;
  const __nv_bfloat16* cs;
  const __nv_bfloat16* sn;
  const float* bias;
  float* out;
  int T, H, Hkv, S, G;
  float scale;
  int D;  // head dim (read only by prefill_consumers<0>)
};

// the ALiBi kernels' inputs, f32: slopes [H], tok_pos [T], cell_pos [S]
struct PrefillAlibi {
  const float* slopes;
  const float* tok_pos;
  const float* cell_pos;
};

// named barriers between the two consumer warpgroups (256 threads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a bf16 V tile read MN-major (dims contiguous): 8-cell
// groups 1024 bytes apart (stride), the second 64-dim half one FP_HALF on
// (leading), 128-byte swizzle
__device__ __forceinline__ uint64_t v_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(FP_HALF >> 4) << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

// s[32] (+)= A[64 x 16] (registers, bf16) x B[16 x 64] (shared memory, K-major)
__device__ __forceinline__ void wgmma_s(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                        int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// o[64] += A[64 x 16] (registers, bf16) x B[16 x 128] (shared memory, MN-major)
__device__ __forceinline__ void wgmma_o(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 8 int8 values times their row scale, each product rounded to bf16 (the
// TPU kernel's dequant; q * s is exact in f32), as 4 bf16x2 words. q comes
// from its byte without a conversion instruction: the byte with its sign
// bit flipped is the low byte of 2^23 + q + 128.
__device__ __forceinline__ uint4 dq8(uint2 raw, float s) {
  const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
  const float base = 8388608.f + 128.f;
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = pack_bf2(q_of(w[i >> 1], 2 * (i & 1), base) * s,
                    q_of(w[i >> 1], 2 * (i & 1) + 1, base) * s);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// x0, x1 with at most 16 significant bits (products of two bf16 values,
// exact in f32) -> bf16x2 hi (x cut to its upper 16 bits) and lo = x - hi,
// which has at most 8 significant bits and so is exact in bf16: hi + lo =
// x exactly, with no conversion instruction
__device__ __forceinline__ void split_exact(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  const float r0 = x0 - __uint_as_float(u0 & 0xFFFF0000u);
  const float r1 = x1 - __uint_as_float(u1 & 0xFFFF0000u);
  lo = __byte_perm(__float_as_uint(r0), __float_as_uint(r1), 0x7632);
}

// byte offset of dims 8*c8 .. 8*c8 + 7 (c8 < 16) of cell c in a swizzled
// [64][128] bf16 plane
__device__ __forceinline__ int plane_off(int c, int c8) {
  return (c8 >> 3) * FP_HALF + c * 128 + (((c8 & 7) ^ (c & 7)) << 4);
}

// The producer's conversion of one S block, by its 128 lanes (p), from the
// raw block to the four K-side planes and (K4q) V of a stage. A lane takes
// 8 dims of cells p / 16 + 8 j; ksc / vsc are those cells' K4q scales.
// ALIBI (no rope): k itself as the one K-side plane.
template <bool Q8, bool ALIBI = false>
__device__ __forceinline__ void convert_block(uint8_t* st, const uint8_t* raw, int p,
                                              const float (&ksc)[8], const float (&vsc)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (p >> 4) + 8 * j, c8 = p & 15;
    uint4 kw, vw;
    if (Q8) {
      kw = dq8(*reinterpret_cast<const uint2*>(raw + c * FP_D + 8 * c8), ksc[j]);
      vw = dq8(*reinterpret_cast<const uint2*>(raw + FP_RAW_V8 + c * FP_D + 8 * c8), vsc[j]);
    } else {
      kw = *reinterpret_cast<const uint4*>(raw + c * 256 + 16 * c8);
    }
    if constexpr (ALIBI) {
      const int off = plane_off(c, c8);
      *reinterpret_cast<uint4*>(st + off) = kw;
      if (Q8) *reinterpret_cast<uint4*>(st + FP_V_OFF + off) = vw;
      continue;
    }
    const uint4 cw = *reinterpret_cast<const uint4*>(raw + FP_RAW_C + c * 256 + 16 * c8);
    const uint4 sw = *reinterpret_cast<const uint4*>(raw + FP_RAW_S + c * 256 + 16 * c8);
    const uint32_t kk[4] = {kw.x, kw.y, kw.z, kw.w}, cc[4] = {cw.x, cw.y, cw.z, cw.w},
                   ss[4] = {sw.x, sw.y, sw.z, sw.w};
    uint32_t ch[4], cl[4], sh[4], sl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float k0 = bf_lo(kk[e]), k1 = bf_hi(kk[e]);
      split_exact(k0 * bf_lo(cc[e]), k1 * bf_hi(cc[e]), ch[e], cl[e]);
      split_exact(k0 * bf_lo(ss[e]), k1 * bf_hi(ss[e]), sh[e], sl[e]);
    }
    const int off = plane_off(c, c8);
    *reinterpret_cast<uint4*>(st + off) = make_uint4(ch[0], ch[1], ch[2], ch[3]);
    *reinterpret_cast<uint4*>(st + FP_PLANE + off) = make_uint4(sh[0], sh[1], sh[2], sh[3]);
    *reinterpret_cast<uint4*>(st + 2 * FP_PLANE + off) = make_uint4(cl[0], cl[1], cl[2], cl[3]);
    *reinterpret_cast<uint4*>(st + 3 * FP_PLANE + off) = make_uint4(sl[0], sl[1], sl[2], sl[3]);
    if (Q8) *reinterpret_cast<uint4*>(st + FP_V_OFF + off) = vw;
  }
}

// cells s0 + 8 i + {0, 1} (i < 8, s0 even) of two bias rows, clamped to
// -1e30 and times log2 e, 0 past S; pairs as float2 where S is even (each
// pair is then 8-byte aligned)
__device__ __forceinline__ void load_bias(float (&ba)[16], float (&bb)[16], const float* bra,
                                          const float* brb, int s0, int S) {
  if ((S & 1) == 0 && s0 + 8 * 7 + 1 < S) {
    const float2* pa = reinterpret_cast<const float2*>(bra + s0);
    const float2* pb = reinterpret_cast<const float2*>(brb + s0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 va = __ldg(pa + 4 * i), vb = __ldg(pb + 4 * i);
      ba[2 * i] = fmaxf(va.x, FP_NEG) * LOG2E;
      ba[2 * i + 1] = fmaxf(va.y, FP_NEG) * LOG2E;
      bb[2 * i] = fmaxf(vb.x, FP_NEG) * LOG2E;
      bb[2 * i + 1] = fmaxf(vb.y, FP_NEG) * LOG2E;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int s = s0 + 8 * (i >> 1) + (i & 1);
      ba[i] = s < S ? fmaxf(__ldg(bra + s), FP_NEG) * LOG2E : 0.f;
      bb[i] = s < S ? fmaxf(__ldg(brb + s), FP_NEG) * LOG2E : 0.f;
    }
  }
}

// load_bias with the ALiBi term: ba[i] = max(bias, -1e30) log2e - sa *
// (ta - cell_pos[s]) (sa, sb: the rows' slopes times log2 e; ta, tb: their
// tokens' positions), 0 past S; pairs as float2 where S is even
__device__ __forceinline__ void load_bias_alibi(float (&ba)[16], float (&bb)[16],
                                                const float* bra, const float* brb,
                                                const float* cpos, float sa, float sb, float ta,
                                                float tb, int s0, int S) {
  if ((S & 1) == 0 && s0 + 8 * 7 + 1 < S) {
    const float2* pa = reinterpret_cast<const float2*>(bra + s0);
    const float2* pb = reinterpret_cast<const float2*>(brb + s0);
    const float2* pc = reinterpret_cast<const float2*>(cpos + s0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 va = __ldg(pa + 4 * i), vb = __ldg(pb + 4 * i), vc = __ldg(pc + 4 * i);
      ba[2 * i] = fmaf(-sa, ta - vc.x, fmaxf(va.x, FP_NEG) * LOG2E);
      ba[2 * i + 1] = fmaf(-sa, ta - vc.y, fmaxf(va.y, FP_NEG) * LOG2E);
      bb[2 * i] = fmaf(-sb, tb - vc.x, fmaxf(vb.x, FP_NEG) * LOG2E);
      bb[2 * i + 1] = fmaf(-sb, tb - vc.y, fmaxf(vb.y, FP_NEG) * LOG2E);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int s = s0 + 8 * (i >> 1) + (i & 1);
      const float c = s < S ? __ldg(cpos + s) : 0.f;
      ba[i] = s < S ? fmaf(-sa, ta - c, fmaxf(__ldg(bra + s), FP_NEG) * LOG2E) : 0.f;
      bb[i] = s < S ? fmaf(-sb, tb - c, fmaxf(__ldg(brb + s), FP_NEG) * LOG2E) : 0.f;
    }
  }
}

// thread 0 of the producer: the raw block at cell sb (ALIBI: no cos, sin)
template <bool Q8, bool ALIBI = false>
__device__ __forceinline__ void load_raw(uint32_t raw, uint32_t bar, const CUtensorMap* tmk,
                                         const CUtensorMap* tmv, const CUtensorMap* tmc,
                                         const CUtensorMap* tms, int sb, int h) {
  mbar_expect_tx(bar, ALIBI ? FP_PLANE : FP_RAW_BYTES);
  tma_3d(raw, tmk, bar, 0, sb, h);
  if (Q8) tma_3d(raw + FP_RAW_V8, tmv, bar, 0, sb, h);
  if constexpr (!ALIBI) {
    tma_2d(raw + FP_RAW_C, tmc, bar, 0, sb);
    tma_2d(raw + FP_RAW_S, tms, bar, 0, sb);
  }
}

// a CTA's shared memory (aligned to 1024 bytes: the ring's stages, then
// the raw block) and barriers: full[0..1], empty[2..3], raw
struct PrefillCta {
  uint8_t* smem;
  uint32_t smem_a, full0, empty0, rawbar;
  int h, row0, nblk;
};

// every thread: the CTA's record, once thread 0 has set up the barriers
template <bool Q8>
__device__ __forceinline__ PrefillCta prefill_cta(uint8_t* dyn_smem, uint64_t* bars,
                                                  const PrefillArgs& a) {
  PrefillCta c;
  const uint32_t raw_ = smem_u32(dyn_smem);
  c.smem = dyn_smem + (((raw_ + 1023) & ~1023u) - raw_);
  c.smem_a = smem_u32(c.smem);
  c.full0 = smem_u32(&bars[0]);
  c.empty0 = smem_u32(&bars[FP_STAGES]);
  c.rawbar = smem_u32(&bars[2 * FP_STAGES]);
  c.h = blockIdx.y;
  c.row0 = blockIdx.x * FP_ROWS;
  c.nblk = (a.S + FP_SB - 1) / FP_SB;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FP_STAGES; ++s) {
      mbar_init(c.full0 + 8 * s, Q8 ? 128 : 129);  // K4: + lane 0's expect_tx for V
      mbar_init(c.empty0 + 8 * s, FP_CONSUMERS / 32);
    }
    mbar_init(c.rawbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return c;
}

// the producer warpgroup (threads FP_CONSUMERS ..): each S block into a
// stage of the ring (ALIBI: no rope; tmc, tms unread)
template <bool Q8, bool ALIBI = false>
__device__ __forceinline__ void prefill_producer(const PrefillCta& c, const CUtensorMap* tmk,
                                                 const CUtensorMap* tmv, const CUtensorMap* tmc,
                                                 const CUtensorMap* tms, const PrefillArgs& a) {
  uint8_t* const smem = c.smem;
  const uint32_t smem_a = c.smem_a, full0 = c.full0, empty0 = c.empty0, rawbar = c.rawbar;
  const int h = c.h, nblk = c.nblk;
  const int p = threadIdx.x - FP_CONSUMERS;
  const uint32_t raw = smem_a + FP_RAW;
  if (p == 0) load_raw<Q8, ALIBI>(raw, rawbar, tmk, tmv, tmc, tms, 0, h);
  int stage = 0;
  uint32_t phase = 0;
  for (int b = 0; b < nblk; ++b) {
    float ksc[8], vsc[8];  // K4q: the row scales of this lane's cells
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = b * FP_SB + (p >> 4) + 8 * j;
      ksc[j] = Q8 && s < a.S ? __bfloat162float(a.ks[(size_t)h * a.S + s]) : 0.f;
      vsc[j] = Q8 && s < a.S ? __bfloat162float(a.vs[(size_t)h * a.S + s]) : 0.f;
    }
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    const uint32_t full = full0 + 8 * stage;
    if (!Q8 && p == 0) {
      const uint32_t vdst = smem_a + stage * FP_STAGE + FP_V_OFF;
      mbar_expect_tx(full, FP_PLANE);
      tma_3d(vdst, tmv, full, 0, b * FP_SB, h);
      tma_3d(vdst + FP_HALF, tmv, full, 64, b * FP_SB, h);
    }
    mbar_wait(rawbar, b & 1);
    convert_block<Q8, ALIBI>(smem + stage * FP_STAGE, smem + FP_RAW, p, ksc, vsc);
    // each lane's generic reads of the raw block and writes of the stage
    // are ordered before the async proxy: lane 0's next TMA into the raw
    // block, and the consumers' wgmma on the stage
    fence_proxy_async();
    // every lane has read the raw block: lane 0 asks for the next one
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (p == 0 && b + 1 < nblk)
      load_raw<Q8, ALIBI>(raw, rawbar, tmk, tmv, tmc, tms, (b + 1) * FP_SB, h);
    mbar_arrive(full);
    if (++stage == FP_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// the two consumer warpgroups (threads 0 .. FP_CONSUMERS - 1): the CTA's
// 128 rows over every stage, then the output. DT: the head dim, 0 = a.D;
// ALIBI: the ALiBi term, from al, and no rope (q alone, one K-side plane);
// CAP: gemma2's attention softcap, a score s becoming cap.y * tanhf(s *
// cap.x) + max(bias, -1e30) log2 e, cap.x = scale / softcap and cap.y =
// softcap * log2 e (the TPU kernel's tanh(s * scale / cap) * cap)
template <int DT, bool ALIBI = false, bool CAP = false>
__device__ __forceinline__ void prefill_consumers(
    const PrefillCta& c, const PrefillArgs& a,
    const PrefillAlibi& al = PrefillAlibi{nullptr, nullptr, nullptr}, float2 cap = float2{}) {
  const int D = DT ? DT : a.D;
  const uint32_t smem_a = c.smem_a, full0 = c.full0, empty0 = c.empty0;
  const int h = c.h, row0 = c.row0, nblk = c.nblk;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int gid = lane >> 2, t4 = lane & 3;
  // this thread's two rows (accumulator rows gid and gid + 8 of its warp)
  const int ra = 64 * wg + 16 * warp + gid, rb = ra + 8;
  const int G = a.G;

  // q and q_rot (ALIBI: q alone) of the two rows as A fragments: [q /
  // q_rot][16-dim step]; dims past D zero
  constexpr int NQ = ALIBI ? 1 : 2;
  uint32_t qf[NQ][8][4];
  {
    const int Ra = row0 + ra, Rb = row0 + rb;
    const bool oka = Ra / G < a.T, okb = Rb / G < a.T;
    const size_t offa = ((size_t)(Ra / G) * a.H + h * G + Ra % G) * D + 2 * t4;
    const size_t offb = ((size_t)(Rb / G) * a.H + h * G + Rb % G) * D + 2 * t4;
#pragma unroll
    for (int w = 0; w < NQ; ++w) {
      const __nv_bfloat16* src = w ? a.qr : a.q;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const bool lo = DT == FP_D || 16 * ks < D, hi = DT == FP_D || 16 * ks + 8 < D;
        qf[w][ks][0] =
            oka && lo ? __ldg(reinterpret_cast<const uint32_t*>(src + offa + 16 * ks)) : 0u;
        qf[w][ks][1] =
            okb && lo ? __ldg(reinterpret_cast<const uint32_t*>(src + offb + 16 * ks)) : 0u;
        qf[w][ks][2] =
            oka && hi ? __ldg(reinterpret_cast<const uint32_t*>(src + offa + 16 * ks + 8)) : 0u;
        qf[w][ks][3] =
            okb && hi ? __ldg(reinterpret_cast<const uint32_t*>(src + offb + 16 * ks + 8)) : 0u;
      }
    }
  }
  // the rows' bias rows (a row past T reads the last token's: never stored)
  const float* bra = a.bias + (size_t)min((row0 + ra) / G, a.T - 1) * a.S;
  const float* brb = a.bias + (size_t)min((row0 + rb) / G, a.T - 1) * a.S;
  // a block's bias of both rows, ba[2i + e] = cell sb + 8 i + 2 t4 + e
  // (clamped to -1e30, times log2 e), loaded one block ahead of its use
  float ba[16], bb[16];
  // ALIBI: the rows' slopes times log2 e and their tokens' positions
  float sla = 0.f, slb = 0.f, tpa = 0.f, tpb = 0.f;
  if constexpr (ALIBI) {
    sla = al.slopes[h * G + (row0 + ra) % G] * LOG2E;
    slb = al.slopes[h * G + (row0 + rb) % G] * LOG2E;
    tpa = __ldg(al.tok_pos + min((row0 + ra) / G, a.T - 1));
    tpb = __ldg(al.tok_pos + min((row0 + rb) / G, a.T - 1));
    load_bias_alibi(ba, bb, bra, brb, al.cell_pos, sla, slb, tpa, tpb, 2 * t4, a.S);
  } else {
    load_bias(ba, bb, bra, brb, 2 * t4, a.S);
  }

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // the running max in log2 units (from -1e30 log2 e) and sum
  float ma = FP_NEG * LOG2E, mb = FP_NEG * LOG2E, la = 0.f, lb = 0.f;
  const float scale2 = a.scale * LOG2E;
  const float NINF = __int_as_float(0xff800000u);

  // the two warpgroups take turns to issue their matrix chains (named
  // barriers 2 and 3), so that one's softmax runs under the other's chain
  const int turn = 2 + wg, other = 3 - wg;
  if (wg == 1) named_arrive(2);  // warpgroup 0 issues first
  int stage = 0;
  uint32_t phase = 0;
  for (int b = 0; b < nblk; ++b) {
    const int sb = b * FP_SB;
    mbar_wait(full0 + 8 * stage, phase);
    const uint32_t st = smem_a + stage * FP_STAGE;
    // scores: [q | q_rot | q | q_rot] . [kc_hi | ks_hi | kc_lo | ks_lo]
    // (ALIBI: q . k)
    float sc[32];
    named_sync(turn);
    wg_fence();
#pragma unroll
    for (int pl = 0; pl < (ALIBI ? 1 : 4); ++pl)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s(sc, qf[pl & (NQ - 1)][4 * hh + kk],
                  x_desc(st + pl * FP_PLANE + hh * FP_HALF + kk * 32),
                  (pl | hh | kk) ? 1 : 0);
    wg_commit();
    named_arrive(other);
    wg_wait<0>();
    fence_regs(sc);

    // scores in log2 units, s' = (s * scale + max(bias, -1e30)) * log2 e,
    // so that p = exp(s - m) = 2^(s' - m'), whose argument is never
    // positive; cells past S -inf (only the last block has any).
    // sc[4i + e]: row (e < 2 ? a : b), cell 8i + 2 t4 + (e & 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
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
    if (sb + FP_SB > a.S) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (sb + 8 * (i >> 2) + 2 * t4 + (i & 1) >= a.S) sc[i] = NINF;
    }
    if (b + 1 < nblk) {
      if constexpr (ALIBI)
        load_bias_alibi(ba, bb, bra, brb, al.cell_pos, sla, slb, tpa, tpb, sb + FP_SB + 2 * t4,
                        a.S);
      else
        load_bias(ba, bb, bra, brb, sb + FP_SB + 2 * t4, a.S);
    }
    float mxa, mxb;
    {
      float m4[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m4[i][0] = fmaxf(fmaxf(sc[8 * i + 0], sc[8 * i + 1]), fmaxf(sc[8 * i + 4], sc[8 * i + 5]));
        m4[i][1] = fmaxf(fmaxf(sc[8 * i + 2], sc[8 * i + 3]), fmaxf(sc[8 * i + 6], sc[8 * i + 7]));
      }
      mxa = fmaxf(fmaxf(m4[0][0], m4[1][0]), fmaxf(m4[2][0], m4[3][0]));
      mxb = fmaxf(fmaxf(m4[0][1], m4[1][1]), fmaxf(m4[2][1], m4[3][1]));
    }
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 2));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 2));
    const float na = fmaxf(ma, mxa), nb = fmaxf(mb, mxb);
    const float alpha_a = ex2(ma - na), alpha_b = ex2(mb - nb);
    // O and l rescale only where a row's max moved (in most blocks of a
    // causal prefill none did); the vote keeps the warp on one path
    const bool moved = __any_sync(0xffffffffu, na != ma || nb != mb);
    ma = na;
    mb = nb;
    float sum4[4][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[4 * i + 0] = ex2(sc[4 * i + 0] - na);
      sc[4 * i + 1] = ex2(sc[4 * i + 1] - na);
      sc[4 * i + 2] = ex2(sc[4 * i + 2] - nb);
      sc[4 * i + 3] = ex2(sc[4 * i + 3] - nb);
      const float pa = sc[4 * i + 0] + sc[4 * i + 1], pb = sc[4 * i + 2] + sc[4 * i + 3];
      sum4[i & 3][0] = i < 4 ? pa : sum4[i & 3][0] + pa;
      sum4[i & 3][1] = i < 4 ? pb : sum4[i & 3][1] + pb;
    }
    float suma = (sum4[0][0] + sum4[1][0]) + (sum4[2][0] + sum4[3][0]);
    float sumb = (sum4[0][1] + sum4[1][1]) + (sum4[2][1] + sum4[3][1]);
    suma += __shfl_xor_sync(0xffffffffu, suma, 1);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, 1);
    suma += __shfl_xor_sync(0xffffffffu, suma, 2);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, 2);
    if (moved) {
      la *= alpha_a;
      lb *= alpha_b;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[4 * i + 0] *= alpha_a;
        o[4 * i + 1] *= alpha_a;
        o[4 * i + 2] *= alpha_b;
        o[4 * i + 3] *= alpha_b;
      }
    }
    la += suma;
    lb += sumb;
    // P_hi / P_lo as A fragments: 16-cell step j is accumulator columns
    // 8 (2j) .. 8 (2j + 1) + 7
    uint32_t ph[4][4], plo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 2 * j + (r >> 1), e = 2 * (r & 1);
        split_hilo(sc[4 * i + e], sc[4 * i + e + 1], ph[j][r], plo[j][r]);
      }
    // P.V
    named_sync(turn);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t vd = v_desc(st + FP_V_OFF + j * 16 * 128);
      wgmma_o(o, ph[j], vd);
      wgmma_o(o, plo[j], vd);
    }
    wg_commit();
    if (wg == 0 || b + 1 < nblk) named_arrive(other);  // warpgroup 1's last turn is the last
    wg_wait<0>();
    fence_regs(o);
    // no proxy fence before the release: only wgmma (the async proxy) read
    // this slot (q and the bias come from global memory), and wait_group 0
    // has seen those reads complete
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    if (++stage == FP_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // epilogue: o[4i + e] is (row a or b, dim 8 i + 2 t4 + (e & 1))
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = row0 + (half ? rb : ra);
    const int t = R / G;
    if (t >= a.T) continue;
    const float inv = 1.f / fmaxf(half ? lb : la, 1e-30f);
    float* dst = a.out + ((size_t)t * a.H + h * G + R % G) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (DT == FP_D || 8 * i < D)
        *reinterpret_cast<float2*>(dst + 8 * i) =
            make_float2(o[4 * i + 2 * half] * inv, o[4 * i + 2 * half + 1] * inv);
  }
}

// a tiled map of a row-major bf16 or byte array [heads][rows][D], dims
// innermost first: a box's columns past D read as zero
int raw_map(CUtensorMap* m, CUtensorMapDataType dt, int rank, const void* base, int es,
            cuuint64_t D, cuuint64_t rows, cuuint64_t heads, CUtensorMapSwizzle swz,
            cuuint32_t box0) {
  const cuuint64_t dims[3] = {D, rows, heads};
  const cuuint64_t strides[2] = {D * es, rows * D * es};
  const cuuint32_t box[3] = {box0, FP_SB, 1};
  return make_map(m, dt, rank, base, dims, strides, box, swz);
}

// K, V, cos and sin's tensor maps: [0] K, [1] V (K4's lands in its stage
// slot in the 128-byte swizzle, 64 dims a box), [2] cos, [3] sin (rope
// false: K and V alone)
template <bool Q8>
int prefill_maps(const PrefillArgs& a, CUtensorMap (&m)[4], bool rope = true) {
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  const cuuint64_t S = a.S, Hkv = a.Hkv, D = a.D;
  int rc = Q8 ? raw_map(&m[0], u8, 3, a.k, 1, D, S, Hkv, none, FP_D)
              : raw_map(&m[0], bf, 3, a.k, 2, D, S, Hkv, none, FP_D);
  if (!rc) rc = Q8 ? raw_map(&m[1], u8, 3, a.v, 1, D, S, Hkv, none, FP_D)
                   : raw_map(&m[1], bf, 3, a.v, 2, D, S, Hkv, CU_TENSOR_MAP_SWIZZLE_128B, 64);
  if (!rc && rope) rc = raw_map(&m[2], bf, 2, a.cs, 2, D, S, 1, none, FP_D);
  if (!rc && rope) rc = raw_map(&m[3], bf, 2, a.sn, 2, D, S, 1, none, FP_D);
  return rc;
}

inline dim3 prefill_grid(const PrefillArgs& a) {
  return dim3((a.T * a.G + FP_ROWS - 1) / FP_ROWS, a.Hkv);
}

PrefillArgs args_of(const void* q, const void* qr, const void* k, const void* ks,
                    const void* v, const void* vs, const void* cs, const void* sn,
                    const void* bias, void* out, int T, int H, int Hkv, int S, int D,
                    float scale) {
  return PrefillArgs{(const __nv_bfloat16*)q,  (const __nv_bfloat16*)qr, k,
                     (const __nv_bfloat16*)ks, v,
                     (const __nv_bfloat16*)vs, (const __nv_bfloat16*)cs,
                     (const __nv_bfloat16*)sn, (const float*)bias,
                     (float*)out,              T, H, Hkv, S, H / Hkv, scale, D};
}

}  // namespace
