// K3 and K3q: flash decode (T <= 8) over the head-major, unroped KV cache,
// for Hopper (sm_90a).
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
// clamped to -1e30, so a fully masked (padding) row comes out finite (the
// mean of V over the S cells); the online softmax starts from m = -1e30,
// l = 0 and the output divides by max(l, 1e-30). Every cache cell is read,
// filled or not: the bias masks empty cells. Cells past S take no part at
// all (score -inf, p = 0 exactly).
//
// Inputs: q, q_rot bf16 [T, H, D]; K/V bf16 [Hkv, S, D] (K3) or int8
// [Hkv, S, D] with one bf16 scale per head row [Hkv, S, 1] (K3q); cos, sin
// bf16 [S, D]; bias f32 [T, S]. Output f32 [T, H, D]. T <= 8, every
// pointer 16-byte aligned; D = Dk = Dv a multiple of 8 up to 128 (K3q: of
// 16, the int8 rows' TMA pitch). The kernels hold a block as 128 dims
// whatever D is: the tensor maps have the true width D, so TMA fills the
// columns past D with zeros, q's are zero there too, and the zeros add
// nothing to q.k or to P.V; only D output columns are stored. D = 128 is
// flash_decode_tc; flash_decode_tc_dim takes D = 64, 80 and 96 as constants
// and any other D at run time (DT = 0). Below D = 128 the products do
// 128 / D times the work D needs (PERF.md).
//
// K3q dequantizes as the TPU kernel does, bf16(q) * bf16(s) rounded to
// bf16: (float)q * s is exact in f32 (8 + 8 significant bits), so
// __float2bfloat16_rn of it is that product bit for bit.
//
// Bound: the bytes of K, V, cos and sin (K3q: half of K3's K/V bytes, 1
// byte a dim plus 2 bytes a row). At T = 1 the score and P.V products are
// 4 query rows of a KV head against each cell, a few operations a byte.
//
// Exact operands on the tensor cores. k, cos and sin are bf16, so k*cos and
// k*sin have at most 16 significant bits: hi = bf16(k*c) (one bf16x2
// multiply, rounded once) and lo = k*c - hi (at most 8 bits; one bf16x2 fma
// gives -lo exactly) split each exactly. q and q_rot are bf16. So mma.sync
// m16n8k16 of [kc_hi | ks_hi] and [kc_lo | ks_lo] against [q | q_rot],
// accumulated in f32, gives the TPU body's f32 dots up to the order of the
// sum. p in [0, 1] becomes P_hi = bf16(p) and P_lo = bf16(p - P_hi), 16
// bits; O += V.P_hi + V.P_lo with V exact in bf16 (K3q's dequantized values
// are bf16 too). One bf16 rounding of k*cos, k*sin or p misses the card's
// atol = rtol = 1e-3 at small caches (tests/test_torch_flash_decode.py).
//
// Shape of the kernel:
//  * a thread block cluster of C CTAs (up to 8, the size chosen by
//    ops/cuda_attn.py::decode_attn_plan) shares one KV head and every query
//    row of it (up to 32; T*G > 32 takes more row chunks on the grid's z,
//    each reading K and V again): CTA `rank` walks its share of the blocks
//    of 64 cells, so K and V cross from device memory once per head
//    whatever T is. Grid (C, Hkv, row chunks), one launch a call.
//  * 160 threads: a producer warp that keeps a ring of 3 stages in flight.
//    Its lane 0 has TMA (cp.async.bulk.tensor, mbarrier completion) bring a
//    block's K and V ([Hkv, S, D] 3-D maps; K3: two 64-dim halves each, K3q:
//    the int8 rows) and cos and sin (two halves each), all in the 128-byte
//    swizzle; the cells past S read as zero. Its 32 lanes bring the block's
//    T bias rows and K3q's two scale rows by 4-byte cp.async (zero past S
//    or past the tensor's end), whose completion the same mbarrier tracks:
//    those rows start at any element, and a TMA box must start 16-byte
//    aligned (an unaligned 1-D box stops the card with an illegal
//    instruction). The consumers issue no global load in the loop.
//  * four consumer warps, 16 cells of each block apiece. The products run
//    transposed: the warp's cells on mma's 16-row side, the query rows on
//    its 8-column side in one, two or four n8 tiles (the 4 rows of a KV head
//    at T = 1 fill half a tile, where on the 16-row side they would fill a
//    quarter). A warp forms its cells' kc and ks from the staged k (K3q:
//    dequantized), cos and sin as hi/lo A fragments, runs S^T = [kc | ks] .
//    [q | q_rot]^T (q's B fragments in registers up to 16 rows), then the
//    online softmax in log2 units: s' = (s * scale + max(bias, -1e30)) *
//    log2 e, p = 2^(s' - m'), a row's max and sum over the 8 lanes that
//    hold its cells. P_hi^T and P_lo^T become B fragments by movmatrix, V^T
//    the A operand through ldmatrix.trans (K3q: the warp first writes its
//    cells' V dequantized to bf16 into a tile of its own), and O^T +=
//    V^T.P^T. A thread's k positions of a k16 step hold 4 adjacent dims, so
//    k, cos and sin come in 8-byte loads.
//  * the end: the CTA combines its warps' (m, l, O) in warp order in shared
//    memory; after a cluster barrier CTA `rank` combines a slice of the
//    rows x dims over every rank in rank order through distributed shared
//    memory and writes it to out. No second kernel, no scratch in device
//    memory, no atomics: a launch's output is bit-identical to the last.
//
// mma.sync rather than wgmma: the 4 query rows of a KV head at T = 1 would
// be padded 16x to wgmma's 64-row side; mma.sync pads them to 8.
//
// ALiBi (Baichuan-13B, refact: pallas_attn.py _decode_body's slopes_ref /
// dist_ref term, score -= slope_h * (pos_q - pos_k) after the scale and
// before the bias) is the ALIBI instantiation of the same CTA body, in
// __global__s of their own (flash_decode_tc_alibi<Q8, NR, DT>, at D = 128
// and at any other D at run time, DT = 0) so that the kernels above keep
// their names and machine code. Every ALiBi model runs rope NONE, so the
// ALIBI body folds no rope: no cos / sin tiles and no q_rot, and the
// scores are one chain S^T = k . q^T (k is bf16, or K3q's dequantized
// bf16: exact A operands with no hi / lo split). The inputs are the
// positions themselves, tok_pos [T] and cell_pos [S] f32: the block's 64
// cell positions travel with its bias rows, by the producer lanes' 4-byte
// cp.async into the stage; each consumer thread reads its rows' slopes and
// token positions once, before the block loop (head h*G + r % G of row
// r), and the scale-and-bias step becomes s * scale2 - slope log2e *
// (tok_pos[t] - cell_pos[s]) + max(bias, -1e30) log2e. The difference of
// two integer positions below 2^24 is exact in f32: the reference's dist,
// which keeps the cells near the query near 0 (dropping the row-constant
// -slope * pos_q would leave scores near slope * pos_k, ~3400 at S = 4096,
// where an f32 ulp is 2.4e-4).
//
// The prefill kernels K4/K4q (T > 8) are flash_prefill.cu's, and the S3
// probes flash_probe.cu's (the split-S body of flash_decode.cuh):
// libraries of their own, so that each keeps its machine code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int DA_D = 128;                       // head dims a block holds (D <= 128)
constexpr int DA_BLK = 64;                      // cells a stage
constexpr int DA_CELLS = 16;                    // cells of a stage a consumer warp takes
constexpr int DA_WARPS = DA_BLK / DA_CELLS;     // consumer warps
constexpr int DA_THREADS = DA_WARPS * 32 + 32;  // and a producer warp
constexpr int DA_ROWS = 32;                     // query rows a CTA at most (four n8 tiles)
constexpr int DA_MAX_T = 8;
constexpr int DA_MAX_CLUSTER = 8;               // portable cluster size
constexpr int DA_STAGES = 3;
constexpr float DA_NEG = -1e30f;
constexpr float DA_LOG2E = 1.4426950408889634f;
constexpr int DA_HALF = DA_BLK * 128;           // one 64-dim half of a bf16 block: 8 KB
constexpr int DA_SC_WORDS = DA_BLK / 2 + 1;     // words that cover 64 bf16 scales
constexpr int DA_FULL_ARRIVALS = 33;            // lane 0's expect_tx, then 32 lanes' cp.async

// shared memory: the ring, then q and q_rot, then K3q's dequantized V tiles;
// ALIBI: no cos and sin in a stage, and the block's cell positions [64] f32
template <bool Q8, bool ALIBI = false>
struct DecSmem {
  static constexpr int KV_BYTES = Q8 ? DA_BLK * DA_D : 2 * DA_HALF;
  static constexpr int CS_BYTES = ALIBI ? 0 : 2 * DA_HALF;  // a rope table, two halves
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int C_OFF = 2 * KV_BYTES;           // cos, two halves
  static constexpr int S_OFF = C_OFF + CS_BYTES;       // sin, two halves
  static constexpr int B_OFF = S_OFF + CS_BYTES;       // bias [T][64] f32
  static constexpr int P_OFF = B_OFF + DA_MAX_T * DA_BLK * 4;  // ALIBI: cell_pos [64] f32
  // K3q: the 4-byte words that hold the block's K and V scales (bf16,
  // starting at element (h*S + s0) & 1 of the first word)
  static constexpr int KS_OFF = P_OFF + (ALIBI ? DA_BLK * 4 : 0);
  static constexpr int VS_OFF = KS_OFF + 4 * DA_SC_WORDS;
  static constexpr int STAGE = ((Q8 ? VS_OFF + 4 * DA_SC_WORDS : KS_OFF) + 1023) / 1024 * 1024;
  static constexpr int RING = DA_STAGES * STAGE;
  static constexpr int Q_OFF = RING;                   // [q, q_rot][half][32 rows][128 B]
  static constexpr int Q_BYTES = 2 * 2 * DA_ROWS * 128;
  static constexpr int VT_OFF = Q_OFF + Q_BYTES;       // K3q: [warp][half][16 cells][128 B]
  static constexpr int VT_WARP = 2 * DA_CELLS * 128;
  // the end, over the ring and past it: each warp's O^T (its fragments), m and l
  // [warp][row], then the CTA's O [row][dim], m and l [row], then every
  // rank's m and l, f32
  static constexpr int W_ACC = 0;
  static constexpr int W_M = W_ACC + DA_WARPS * DA_ROWS * DA_D * 4;
  static constexpr int W_L = W_M + DA_WARPS * DA_ROWS * 4;
  static constexpr int C_ACC = W_L + DA_WARPS * DA_ROWS * 4;
  static constexpr int C_M = C_ACC + DA_ROWS * DA_D * 4;
  static constexpr int C_L = C_M + DA_ROWS * 4;
  static constexpr int X_M = C_L + DA_ROWS * 4;  // every rank's m and l [rank][row]
  static constexpr int X_L = X_M + DA_MAX_CLUSTER * DA_ROWS * 4;
  static constexpr int END = X_L + DA_MAX_CLUSTER * DA_ROWS * 4;
  static constexpr int USED = VT_OFF + (Q8 ? DA_WARPS * VT_WARP : 0);
  static constexpr int BYTES = (USED > END ? USED : END) + 1024;  // + slack to align to 1024
  static_assert(BYTES <= 232448, "227 KB of shared memory a CTA");
};

struct DecArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* qr;
  const float* bias;
  const __nv_bfloat16* ks;  // K3q: [Hkv, S] scales
  const __nv_bfloat16* vs;
  float* out;
  int T, H, Hkv, G, S, R, bpr;  // R = T*G rows; bpr: blocks of 64 cells a rank
  float scale2;                 // scale * log2 e
  int D;                        // head dim (read only by flash_decode_tc_dim<.., 0>)
};

// the ALiBi kernels' inputs, f32: slopes [H], tok_pos [T], cell_pos [S]
struct DecAlibi {
  const float* slopes;
  const float* tok_pos;
  const float* cell_pos;
};

// 4 bytes (the first `bytes` of them read, the rest zero) into shared memory
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// an arrival on bar once the thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// the int8 value of byte i of v as an f32, exactly, without a conversion
// instruction: 2^23 + (byte + 128) by byte_perm (hopper.cuh q_of), minus
// 2^23 + 128
constexpr float DA_I8_BASE = 8388608.f + 128.f;
__device__ __forceinline__ float i8_of(uint32_t v, int i) {
  return q_of(v ^ 0x80808080u, i, DA_I8_BASE);
}

// K3q's dequant of 4 int8 values (a word) and their row scale: two bf16
// pairs, bf16(q * s) each
__device__ __forceinline__ void dq4(uint32_t w, float s, uint32_t& lo, uint32_t& hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(i8_of(w, 0) * s, i8_of(w, 1) * s);
  __nv_bfloat162 y = __floats2bfloat162_rn(i8_of(w, 2) * s, i8_of(w, 3) * s);
  lo = *reinterpret_cast<uint32_t*>(&x);
  hi = *reinterpret_cast<uint32_t*>(&y);
}

// ... of 16 int8 values: 16 bf16 in two uint4
__device__ __forceinline__ void dq16(uint4 raw, float s, uint4& lo, uint4& hi) {
  dq4(raw.x, s, lo.x, lo.y);
  dq4(raw.y, s, lo.z, lo.w);
  dq4(raw.z, s, hi.x, hi.y);
  dq4(raw.w, s, hi.z, hi.w);
}

// the producer warp: blocks [b0, b1) of KV head h into the ring (ALIBI:
// no cos and sin; the cell positions beside the bias rows)
template <bool Q8, bool ALIBI = false>
__device__ __forceinline__ void da_producer(const CUtensorMap* tmk, const CUtensorMap* tmv,
                                            const CUtensorMap* tmc, const CUtensorMap* tms,
                                            const DecArgs& a, uint32_t sm, uint32_t full0,
                                            uint32_t empty0, int h, int b0, int b1,
                                            const float* cell_pos = nullptr) {
  using L = DecSmem<Q8, ALIBI>;
  const int lane = threadIdx.x & 31;
  const uint32_t tx = 2 * L::KV_BYTES + 2 * L::CS_BYTES;
  const long long sc_bytes = 2LL * a.Hkv * a.S;
  for (int j = 0; j < b1 - b0; ++j) {
    const int slot = j % DA_STAGES;
    if (j >= DA_STAGES) mbar_wait(empty0 + 8 * slot, ((j / DA_STAGES) - 1) & 1);
    const int s0 = (b0 + j) * DA_BLK;
    const uint32_t st = sm + slot * L::STAGE, full = full0 + 8 * slot;
    if (lane == 0) {
      mbar_expect_tx(full, tx);
      if (Q8) {
        tma_3d(st + L::K_OFF, tmk, full, 0, s0, h);
        tma_3d(st + L::V_OFF, tmv, full, 0, s0, h);
      } else {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          tma_3d(st + L::K_OFF + hf * DA_HALF, tmk, full, 64 * hf, s0, h);
          tma_3d(st + L::V_OFF + hf * DA_HALF, tmv, full, 64 * hf, s0, h);
        }
      }
      if constexpr (!ALIBI) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          tma_2d(st + L::C_OFF + hf * DA_HALF, tmc, full, 64 * hf, s0);
          tma_2d(st + L::S_OFF + hf * DA_HALF, tms, full, 64 * hf, s0);
        }
      }
    }
    for (int i = lane; i < a.T * DA_BLK; i += 32) {
      const int t = i / DA_BLK, s = s0 + i % DA_BLK;
      cp_async4(st + L::B_OFF + 4 * i, a.bias + (size_t)t * a.S + min(s, a.S - 1),
                s < a.S ? 4 : 0);
    }
    if constexpr (ALIBI) {
      for (int i = lane; i < DA_BLK; i += 32) {
        const int s = s0 + i;
        cp_async4(st + L::P_OFF + 4 * i, cell_pos + min(s, a.S - 1), s < a.S ? 4 : 0);
      }
    }
    if (Q8) {
      const long long w0 = ((long long)h * a.S + s0) >> 1;
      for (int i = lane; i < 2 * DA_SC_WORDS; i += 32) {
        const int v = i / DA_SC_WORDS, wi = i % DA_SC_WORDS;
        const long long byte = 4 * (w0 + wi);
        const int n = (int)max(0LL, min(4LL, sc_bytes - byte));
        const char* base = reinterpret_cast<const char*>(v ? a.vs : a.ks);
        cp_async4(st + (v ? L::VS_OFF : L::KS_OFF) + 4 * wi, base + (n ? byte : 0), n);
      }
    }
    cp_async_arrive(full);
  }
}

// a * b and a * b + c on bf16 pairs, each rounded to bf16 once
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bfma2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// movmatrix: the transpose of an 8x8 b16 matrix held one row pair a thread
__device__ __forceinline__ uint32_t mov_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// one consumer warp over blocks [b0, b1): its 16 cells 16w.. of each block
// against the CTA's 8 NR query rows. The products run transposed, the cells
// on mma's 16-row side and the query rows on its 8-column side (4 rows of a
// KV head at T = 1 fill half a side of 8, where they would fill a quarter of
// 16): S^T = [kc | ks] . [q | q_rot]^T, then O^T += V^T . P^T. Leaves the
// warp's (m, l, O^T) in registers: acc[dim tile][row tile] holds dims
// 16 dm + g (+ 8) of rows 8 nr + 2t (+ 1). ALIBI: no rope, S^T = k . q^T,
// and each score's term slope log2e * (tok_pos - cell_pos) from al.
template <bool Q8, int NR, bool ALIBI = false>
__device__ __forceinline__ void da_consumer(const DecArgs& a, uint8_t* smem, uint32_t full0,
                                            uint32_t empty0, int h, int r0, int b0, int b1,
                                            float (&acc)[8][NR][4], float (&m)[NR][2],
                                            float (&l)[NR][2],
                                            const DecAlibi& al = DecAlibi{nullptr, nullptr,
                                                                          nullptr}) {
  using L = DecSmem<Q8, ALIBI>;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int cw0 = DA_CELLS * w;  // the warp's first cell of a block
  // the bias row (token) of each of the thread's rows 8 nr + 2t (+ 1);
  // padding rows past R read the last token's and are never written
  int tok[NR][2];
#pragma unroll
  for (int nr = 0; nr < NR; ++nr)
#pragma unroll
    for (int i = 0; i < 2; ++i) tok[nr][i] = min((r0 + 8 * nr + 2 * t4 + i) / a.G, a.T - 1);
  // ALIBI: each row's slope times log2 e, head h*G + r % G, and its
  // token's position (padding rows too: they are never written)
  float slope2[ALIBI ? NR : 1][2], tpos[ALIBI ? NR : 1][2];
  if constexpr (ALIBI) {
#pragma unroll
    for (int nr = 0; nr < NR; ++nr)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        slope2[nr][i] = al.slopes[h * a.G + (r0 + 8 * nr + 2 * t4 + i) % a.G] * DA_LOG2E;
        tpos[nr][i] = al.tok_pos[tok[nr][i]];
      }
  }
  // the lane's ldmatrix row of V^T's A fragments: cell (lane % 8) + 8 (lane / 16),
  // dims + 8 ((lane / 8) % 2)
  const int v_cell = (lane & 7) + 8 * (lane >> 4), v_col = 8 * ((lane >> 3) & 1);
  uint8_t* vt = smem + L::VT_OFF + w * L::VT_WARP;  // K3q: the warp's V in bf16
  // a k16 step's B fragments of q and q_rot for row tile nr: row 8 nr + g.
  // A thread's k positions 2t, 2t + 1 and 2t + 8, 2t + 9 hold dims 4t..4t+3
  // of the step (the sum over dims does not care which k a dim takes, and q
  // and k agree), so each operand comes in one 8-byte load
  auto ld_q = [&](uint32_t (&qb)[2], uint32_t (&rb)[2], int nr, int kk) {
    const uint8_t* qa = smem + L::Q_OFF + (kk >> 2) * (DA_ROWS * 128);
    const int o = swz(8 * nr + g, 32 * (kk & 3) + 8 * t4);
    const uint2 x = *reinterpret_cast<const uint2*>(qa + o);
    qb[0] = x.x;
    qb[1] = x.y;
    if constexpr (!ALIBI) {  // ALIBI: no q_rot
      const uint2 y = *reinterpret_cast<const uint2*>(qa + 2 * DA_ROWS * 128 + o);
      rb[0] = y.x;
      rb[1] = y.y;
    }
  };
  // up to 16 rows the B fragments of q and q_rot stay in registers; past
  // that two are read from shared memory at each k16 step
  constexpr bool QREG = NR <= 2;
  constexpr int QN = QREG ? NR : 1, QK = QREG ? 8 : 1;
  uint32_t qreg[QK][QN][2], rreg[QK][QN][2];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int nr = 0; nr < NR; ++nr) ld_q(qreg[kk][nr], rreg[kk][nr], nr, kk);
  }

  for (int j = 0; j < b1 - b0; ++j) {
    const int slot = j % DA_STAGES;
    mbar_wait(full0 + 8 * slot, (j / DA_STAGES) & 1);
    const uint8_t* st = smem + slot * L::STAGE;

    // K3q: the block's scales start at element sc0 of their words
    const int sc0 = (int)(((long long)h * a.S + (b0 + j) * DA_BLK) & 1);
    float kscale[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      kscale[i] = Q8 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                           st + L::KS_OFF)[sc0 + cw0 + g + 8 * i])
                     : 0.f;
    // S^T of the warp's 16 cells x the rows: the hi products and the negated
    // lo products apart
    float sh[NR][4], sl[NR][4];
#pragma unroll
    for (int nr = 0; nr < NR; ++nr)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[nr][e] = sl[nr][e] = 0.f;
    if constexpr (ALIBI) {
      // no rope: S^T = k . q^T, k's A fragments as they stand (cells g and
      // g + 8, dims 4t..4t+3 of the step), exact in bf16
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int hf = kk >> 2;
        uint32_t ka[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = cw0 + g + 8 * i;
          uint32_t k2[2];
          if (Q8) {
            dq4(*reinterpret_cast<const uint32_t*>(st + L::K_OFF + swz(c, 16 * kk + 4 * t4)),
                kscale[i], k2[0], k2[1]);
          } else {
            const uint2 kw = *reinterpret_cast<const uint2*>(
                st + L::K_OFF + swz(c, 32 * (kk & 3) + 8 * t4) + hf * DA_HALF);
            k2[0] = kw.x;
            k2[1] = kw.y;
          }
          ka[i] = k2[0];
          ka[i + 2] = k2[1];
        }
#pragma unroll
        for (int nr = 0; nr < NR; ++nr) {
          uint32_t qb[2], rb[2];
          if constexpr (QREG) {
            qb[0] = qreg[kk][nr][0];
            qb[1] = qreg[kk][nr][1];
          } else {
            ld_q(qb, rb, nr, kk);
          }
          mma_bf16(sh[nr], ka, qb[0], qb[1]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int hf = kk >> 2;  // the 64-dim half of dims 16kk..16kk+15
        // A fragments of k*cos and k*sin: cells g (a0, a2) and g + 8 (a1,
        // a3), dims 4t..4t+3 of the step; hi = bf16(k*c) and -lo = bf16(hi -
        // k*c), both exact (k*c has at most 16 significant bits, hi - k*c at
        // most 8)
        uint32_t chi[4], cnl[4], shi[4], snl[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = cw0 + g + 8 * i;
          const int cb = swz(c, 32 * (kk & 3) + 8 * t4) + hf * DA_HALF;
          uint32_t k2[2];
          if (Q8) {
            dq4(*reinterpret_cast<const uint32_t*>(st + L::K_OFF + swz(c, 16 * kk + 4 * t4)),
                kscale[i], k2[0], k2[1]);
          } else {
            const uint2 kw = *reinterpret_cast<const uint2*>(st + L::K_OFF + cb);
            k2[0] = kw.x;
            k2[1] = kw.y;
          }
          const uint2 cw = *reinterpret_cast<const uint2*>(st + L::C_OFF + cb);
          const uint2 sw = *reinterpret_cast<const uint2*>(st + L::S_OFF + cb);
          const uint32_t c2[2] = {cw.x, cw.y}, s2[2] = {sw.x, sw.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ai = i + 2 * e;  // a0/a1: dims 4t, 4t+1; a2/a3: 4t+2, 4t+3
            const uint32_t kn = k2[e] ^ 0x80008000u;
            chi[ai] = bmul2(k2[e], c2[e]);
            cnl[ai] = bfma2(kn, c2[e], chi[ai]);
            shi[ai] = bmul2(k2[e], s2[e]);
            snl[ai] = bfma2(kn, s2[e], shi[ai]);
          }
        }
#pragma unroll
        for (int nr = 0; nr < NR; ++nr) {
          uint32_t qb[2], rb[2];
          if constexpr (QREG) {
            qb[0] = qreg[kk][nr][0];
            qb[1] = qreg[kk][nr][1];
            rb[0] = rreg[kk][nr][0];
            rb[1] = rreg[kk][nr][1];
          } else {
            ld_q(qb, rb, nr, kk);
          }
          mma_bf16(sh[nr], chi, qb[0], qb[1]);
          mma_bf16(sh[nr], shi, rb[0], rb[1]);
          mma_bf16(sl[nr], cnl, qb[0], qb[1]);
          mma_bf16(sl[nr], snl, rb[0], rb[1]);
        }
      }
    }

    // K3q: the warp's cells of V dequantized into its own bf16 tile
    uint32_t v_base = smem_u32(st + L::V_OFF);
    int v_row = cw0 + v_cell, v_half = DA_HALF;
    if (Q8) {
      __syncwarp();  // the last block's ldmatrix reads are done
#pragma unroll
      for (int i = 0; i < DA_CELLS / 4; ++i) {
        const int ci = lane + 32 * i, row = ci >> 3, c16 = ci & 7;  // 16 dims at 16 c16
        const uint4 raw =
            *reinterpret_cast<const uint4*>(st + L::V_OFF + swz(cw0 + row, 16 * c16));
        const float s = __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(st + L::VS_OFF)[sc0 + cw0 + row]);
        uint4 lo, hi;
        dq16(raw, s, lo, hi);
        uint8_t* dst = vt + (c16 >> 2) * (DA_CELLS * 128);
        *reinterpret_cast<uint4*>(dst + swz(row, (c16 & 3) * 32)) = lo;
        *reinterpret_cast<uint4*>(dst + swz(row, (c16 & 3) * 32 + 16)) = hi;
      }
      __syncwarp();
      v_base = smem_u32(vt);
      v_row = v_cell;
      v_half = DA_CELLS * 128;
    }

    // the online softmax in log2 units; cells past S take no part. A row's
    // 16 cells lie in the 8 lanes of one t (cells g and g + 8 each)
    const float* bias = reinterpret_cast<const float*>(st + L::B_OFF);
    const int cell0 = (b0 + j) * DA_BLK + cw0;
    uint32_t ph[NR][2], pl[NR][2];  // P^T's B fragments: cells 2t.., 2t+8.. of row g
    float al[NR][2];
    bool moved = false;
#pragma unroll
    for (int nr = 0; nr < NR; ++nr) {
      float p[4];  // cell g rows 2t, 2t+1; cell g+8 rows 2t, 2t+1
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = g + 8 * (e >> 1);
        float x;
        if constexpr (ALIBI) {
          const float* cpos = reinterpret_cast<const float*>(st + L::P_OFF);
          x = fmaf(-slope2[nr][e & 1], tpos[nr][e & 1] - cpos[cw0 + cl], sh[nr][e] * a.scale2) +
              fmaxf(bias[tok[nr][e & 1] * DA_BLK + cw0 + cl], DA_NEG) * DA_LOG2E;
        } else {
          x = (sh[nr][e] - sl[nr][e]) * a.scale2 +
              fmaxf(bias[tok[nr][e & 1] * DA_BLK + cw0 + cl], DA_NEG) * DA_LOG2E;
        }
        p[e] = cell0 + cl < a.S ? x : -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(p[i], p[2 + i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[nr][i], mx);
        const float alpha = ex2(m[nr][i] - mn);
        m[nr][i] = mn;
        p[i] = ex2(p[i] - mn);
        p[2 + i] = ex2(p[2 + i] - mn);
        l[nr][i] = l[nr][i] * alpha + (p[i] + p[2 + i]);
        al[nr][i] = alpha;
        moved |= alpha != 1.f;
      }
      // P^T hi + lo: row pairs (2t, 2t + 1) of cells g and g + 8, then the
      // transpose of each 8x8 (cells x rows) block
      uint32_t hi0, lo0, hi1, lo1;
      split_hilo(p[0], p[1], hi0, lo0);
      split_hilo(p[2], p[3], hi1, lo1);
      ph[nr][0] = mov_t(hi0);
      ph[nr][1] = mov_t(hi1);
      pl[nr][0] = mov_t(lo0);
      pl[nr][1] = mov_t(lo1);
    }
    // O *= alpha where a row's max moved (after the first blocks, rarely)
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int dm = 0; dm < 8; ++dm)
#pragma unroll
        for (int nr = 0; nr < NR; ++nr)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dm][nr][e] *= al[nr][e & 1];
    }

    // O^T += V^T.P_hi^T + V^T.P_lo^T, V^T's A fragments by ldmatrix.trans
#pragma unroll
    for (int dm = 0; dm < 8; ++dm) {
      const int d = 16 * dm + v_col;
      uint32_t va[4];
      ldsm_x4_t(va, v_base + (d >> 6) * v_half + swz(v_row, (d & 63) * 2));
#pragma unroll
      for (int nr = 0; nr < NR; ++nr) {
        mma_bf16(acc[dm][nr], va, ph[nr][0], ph[nr][1]);
        mma_bf16(acc[dm][nr], va, pl[nr][0], pl[nr][1]);
      }
    }
    // the slot's K, V, tables and bias rows were read by ld.shared and
    // ldmatrix (the generic proxy); the producer's next TMA writes it
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
  }
  // l over the rows' 16 cells (the 8 lanes of one t)
#pragma unroll
  for (int nr = 0; nr < NR; ++nr)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[nr][i] += __shfl_xor_sync(0xffffffffu, l[nr][i], 4);
      l[nr][i] += __shfl_xor_sync(0xffffffffu, l[nr][i], 8);
      l[nr][i] += __shfl_xor_sync(0xffffffffu, l[nr][i], 16);
    }
}

// a CTA of the grid (cluster C, Hkv, row chunks of 8 NR); the C CTAs of a
// cluster split the cells of one KV head. DT: the head dim, 0 = a.D;
// ALIBI: the ALiBi term, from al, and no rope (tmc, tms unread)
template <bool Q8, int NR, int DT, bool ALIBI = false>
__device__ __forceinline__ void decode_cta(const CUtensorMap& tmk, const CUtensorMap& tmv,
                                           const CUtensorMap& tmc, const CUtensorMap& tms,
                                           const DecArgs& a, uint8_t* dyn_smem, uint64_t* bars,
                                           const DecAlibi& al = DecAlibi{nullptr, nullptr,
                                                                         nullptr}) {
  using L = DecSmem<Q8, ALIBI>;
  constexpr int RC = 8 * NR;  // rows a CTA
  const int D = DT ? DT : a.D;
  const uint32_t raw = smem_u32(dyn_smem);
  uint8_t* smem = dyn_smem + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sm = smem_u32(smem);
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[DA_STAGES]);
  const int C = gridDim.x, rank = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * RC;
  const int nblk = (a.S + DA_BLK - 1) / DA_BLK;
  const int b0 = min(nblk, rank * a.bpr), b1 = min(nblk, b0 + a.bpr);
  const int nrows = min(RC, a.R - r0);  // rows of this CTA that exist

  if (threadIdx.x == 0) {
    for (int s = 0; s < DA_STAGES; ++s) {
      mbar_init(full0 + 8 * s, DA_FULL_ARRIVALS);
      mbar_init(empty0 + 8 * s, DA_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialized: the producer may start

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[8][NR][4], m[NR][2], l[NR][2];
#pragma unroll
  for (int nr = 0; nr < NR; ++nr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[nr][i] = DA_NEG * DA_LOG2E;
      l[nr][i] = 0.f;
    }
#pragma unroll
    for (int dm = 0; dm < 8; ++dm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dm][nr][e] = 0.f;
  }
  if (warp == DA_WARPS) {
    da_producer<Q8, ALIBI>(&tmk, &tmv, &tmc, &tms, a, sm, full0, empty0, h, b0, b1,
                           al.cell_pos);
  } else {
    // q and q_rot (ALIBI: q alone) of rows r0.. into [which][half][row][128
    // B], 128-byte swizzle, rows past R zero, while the first blocks come in
    for (int i = threadIdx.x; i < (ALIBI ? 1 : 2) * RC * 16; i += DA_WARPS * 32) {
      const int which = i / (RC * 16), r = (i / 16) % RC, c16 = i % 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows && (DT == DA_D || 8 * c16 < D)) {  // dims past D stay zero
        const int rg = r0 + r, t = rg / a.G, g = rg % a.G;
        const __nv_bfloat16* src =
            (which ? a.qr : a.q) + ((size_t)t * a.H + (size_t)h * a.G + g) * D + 8 * c16;
        v = *reinterpret_cast<const uint4*>(src);
      }
      *reinterpret_cast<uint4*>(smem + L::Q_OFF + which * 2 * DA_ROWS * 128 +
                                (c16 >> 3) * DA_ROWS * 128 + swz(r, (c16 & 7) * 16)) = v;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(DA_WARPS * 32) : "memory");  // the consumers
    da_consumer<Q8, NR, ALIBI>(a, smem, full0, empty0, h, r0, b0, b1, acc, m, l, al);
  }
  __syncthreads();  // every stage consumed: shared memory holds the partials now

  float* wacc = reinterpret_cast<float*>(smem + L::W_ACC);
  float* wm = reinterpret_cast<float*>(smem + L::W_M);
  float* wl = reinterpret_cast<float*>(smem + L::W_L);
  float* cacc = reinterpret_cast<float*>(smem + L::C_ACC);
  float* cm = reinterpret_cast<float*>(smem + L::C_M);
  float* cl = reinterpret_cast<float*>(smem + L::C_L);
  // each warp's O^T in fragment order [warp][dim tile][row tile][element]
  // [lane] (consecutive lanes, no bank conflict), and (m, l); rows past R
  // skipped
  if (warp < DA_WARPS) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int nr = 0; nr < NR; ++nr)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 8 * nr + 2 * t4 + i;
        if (row < nrows) {
#pragma unroll
          for (int dm = 0; dm < 8; ++dm)
#pragma unroll
            for (int e = i; e < 4; e += 2)
              wacc[(((warp * 8 + dm) * NR + nr) * 4 + e) * 32 + lane] = acc[dm][nr][e];
          if (g == 0) {
            wm[warp * DA_ROWS + row] = m[nr][i];
            wl[warp * DA_ROWS + row] = l[nr][i];
          }
        }
      }
  }
  __syncthreads();
  // the CTA's (m, l, O): its warps in order
  for (int i = threadIdx.x; i < nrows * DA_D; i += DA_THREADS) {
    const int r = i / DA_D, d = i % DA_D;
    // (r, d)'s place in a warp's fragments
    const int frag = ((d >> 4) * NR + (r >> 3)) * 4 + 2 * ((d >> 3) & 1) + (r & 1);
    const int fl = 4 * (d & 7) + ((r & 7) >> 1);
    float M = wm[r];
#pragma unroll
    for (int w = 1; w < DA_WARPS; ++w) M = fmaxf(M, wm[w * DA_ROWS + r]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float e = ex2(wm[w * DA_ROWS + r] - M);
      Ls += wl[w * DA_ROWS + r] * e;
      A += wacc[(w * 32 * NR + frag) * 32 + fl] * e;
    }
    cacc[r * DA_D + d] = A;
    if (d == 0) {
      cm[r] = M;
      cl[r] = Ls;
    }
  }
  if (C > 1) cluster_sync_all();
  else __syncthreads();
  // every rank's (m, l) of the rows, once, then CTA `rank` writes its slice
  // of rows x dims: the ranks in rank order
  float* xm = reinterpret_cast<float*>(smem + L::X_M);
  float* xl = reinterpret_cast<float*>(smem + L::X_L);
  for (int i = threadIdx.x; i < C * nrows; i += DA_THREADS) {
    const int q = i / nrows, r = i % nrows;
    xm[q * DA_ROWS + r] = C > 1 ? ld_dsmem(smem_u32(cm + r), q) : cm[r];
    xl[q * DA_ROWS + r] = C > 1 ? ld_dsmem(smem_u32(cl + r), q) : cl[r];
  }
  __syncthreads();
  // (the D columns that exist; cacc keeps DA_D a row)
  const int elems = nrows * D, per = (elems + C - 1) / C;
  const int e0 = rank * per, e1 = min(elems, e0 + per);
  for (int i = e0 + threadIdx.x; i < e1; i += DA_THREADS) {
    const int r = i / D, d = i % D;
    const int ci = DT == DA_D ? i : r * DA_D + d;
    float M = -INFINITY;
    for (int q = 0; q < C; ++q) M = fmaxf(M, xm[q * DA_ROWS + r]);
    // every rank's O of the element in flight at once
    float o[DA_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < DA_MAX_CLUSTER; ++q)
      if (q < C) o[q] = ld_dsmem(smem_u32(cacc + ci), q);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int q = 0; q < DA_MAX_CLUSTER; ++q) {
      if (q < C) {
        const float e = ex2(xm[q * DA_ROWS + r] - M);
        Ls += xl[q * DA_ROWS + r] * e;
        A += o[q] * e;
      }
    }
    const int rg = r0 + r, t = rg / a.G, g = rg % a.G;
    a.out[((size_t)t * a.H + (size_t)h * a.G + g) * D + d] = A / fmaxf(Ls, 1e-30f);
  }
  if (C > 1) cluster_sync_all();  // no CTA leaves while another reads its partials
}

// D = 128
template <bool Q8, int NR>
__global__ void __launch_bounds__(DA_THREADS, 1)
flash_decode_tc(const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
                const __grid_constant__ CUtensorMap tmc, const __grid_constant__ CUtensorMap tms,
                const DecArgs a) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * DA_STAGES];  // full, then empty
  decode_cta<Q8, NR, DA_D>(tmk, tmv, tmc, tms, a, dyn_smem, bars);
}

// D = DT < 128, or a.D where DT = 0
template <bool Q8, int NR, int DT>
__global__ void __launch_bounds__(DA_THREADS, 1)
flash_decode_tc_dim(const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const __grid_constant__ CUtensorMap tmc,
                    const __grid_constant__ CUtensorMap tms, const DecArgs a) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * DA_STAGES];  // full, then empty
  decode_cta<Q8, NR, DT>(tmk, tmv, tmc, tms, a, dyn_smem, bars);
}

// ALiBi at D = DT: 128, or a.D where DT = 0; no rope (no cos / sin maps)
template <bool Q8, int NR, int DT>
__global__ void __launch_bounds__(DA_THREADS, 1)
flash_decode_tc_alibi(const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, const DecArgs a,
                      const DecAlibi al) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * DA_STAGES];  // full, then empty
  decode_cta<Q8, NR, DT, true>(tmk, tmv, tmk, tmk, a, dyn_smem, bars, al);
}

// ----------------------------------------------------------------------------
// The wide kernel: Dk and Dv apart, each a multiple of 8 up to 256 (two
// 128-dim chunks), and K3q's int8 rows at any multiple of 8 (rows whose
// pitch is no multiple of 16 bytes come by 8-byte cp.async, not TMA). The
// stage is the narrow kernel's ([64 cells][128 dims] of K, V, cos and sin,
// the bias and K3q's scales): block j's chunk c (dims 128c..128c+127) is
// ring item j*NC + c. A warp sums its scores over the NC items of a block,
// runs the softmax once, then P.V against each item's V into accumulator
// dims 128c..; it releases the block's NC items together (3 stages: with
// NC = 2 the producer stays one item ahead). At most 16 query rows a CTA
// (NR <= 2; more rows take more row chunks) and q, q_rot read from shared
// memory at each k16 step, so that acc[16][NR][4] fits beside the score
// fragments. TMA fills the columns past Dk (past Dv) with zeros, so the
// chunks past a width add nothing. Shared memory: 3 stages of 66 KB (K3q:
// 50 KB) plus q and q_rot [2][4 x 64 dims][16 rows] bf16 (16 KB) and K3q's
// V tiles (16 KB): 215 KB (K3q 185 KB); the end's partials [4 warps][16
// rows][256 dims] f32 (64 KB) reuse the ring.
//
// gemma2's attention softcap (pallas_attn.py _decode_body: scores =
// tanh(scores / cap) * cap after the scale, before the bias) is the
// SOFTCAP instantiation of the same CTA body, a __global__ of its own
// (flash_decode_tc_wide_cap) so that the uncapped kernels keep their names
// and machine code: its scale-and-bias step is cap log2e * tanhf(s * scale
// / cap) + max(bias, -1e30) log2e. tanhf, not tanh.approx.f32: at cap 50
// the approximation's ~2^-11 relative error is up to ~0.024 in a score.
// Every capped step takes this kernel, at any head dims (NC = 1 up to 128).

constexpr int DW_ROWS = 16;  // query rows a CTA at most (two n8 tiles)
constexpr int DW_DIMS = 256;

template <bool Q8>
struct DecWideSmem {
  using N = DecSmem<Q8>;
  static constexpr int STAGE = N::STAGE;
  static constexpr int RING = N::RING;
  static constexpr int Q_OFF = RING;                // [q, q_rot][quarter][16 rows][128 B]
  static constexpr int Q_WHICH = 4 * DW_ROWS * 128;
  static constexpr int VT_OFF = Q_OFF + 2 * Q_WHICH;
  static constexpr int W_ACC = 0;
  static constexpr int W_M = W_ACC + DA_WARPS * DW_ROWS * DW_DIMS * 4;
  static constexpr int W_L = W_M + DA_WARPS * DW_ROWS * 4;
  static constexpr int C_ACC = W_L + DA_WARPS * DW_ROWS * 4;
  static constexpr int C_M = C_ACC + DW_ROWS * DW_DIMS * 4;
  static constexpr int C_L = C_M + DW_ROWS * 4;
  static constexpr int X_M = C_L + DW_ROWS * 4;
  static constexpr int X_L = X_M + DA_MAX_CLUSTER * DW_ROWS * 4;
  static constexpr int END = X_L + DA_MAX_CLUSTER * DW_ROWS * 4;
  static constexpr int USED = VT_OFF + (Q8 ? DA_WARPS * N::VT_WARP : 0);
  static constexpr int BYTES = (USED > END ? USED : END) + 1024;
  static_assert(END <= RING, "the end's partials reuse the ring");
  static_assert(BYTES <= 232448, "227 KB of shared memory a CTA");
};

struct DecWideArgs {
  DecArgs a;   // a.D is Dk
  int Dv;
  int kcp, vcp;  // K3q: K's (V's) int8 rows by cp.async (pitch not a multiple of 16)
  const int8_t* k8;
  const int8_t* v8;
};

// 8 bytes (all or none of them read, the rest zero) into shared memory
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// the producer warp of the wide kernel: items [b0 * NC, b1 * NC)
template <bool Q8, int NC>
__device__ __forceinline__ void dw_producer(const CUtensorMap* tmk, const CUtensorMap* tmv,
                                            const CUtensorMap* tmc, const CUtensorMap* tms,
                                            const DecWideArgs& w, uint32_t sm, uint32_t full0,
                                            uint32_t empty0, int h, int b0, int b1) {
  using L = DecSmem<Q8>;
  const DecArgs& a = w.a;
  const int lane = threadIdx.x & 31;
  const uint32_t tx = (w.kcp ? 0 : L::KV_BYTES) + (w.vcp ? 0 : L::KV_BYTES) + 4 * DA_HALF;
  const long long sc_bytes = 2LL * a.Hkv * a.S;
  for (int i = 0; i < (b1 - b0) * NC; ++i) {
    const int slot = i % DA_STAGES, c = i % NC, x0 = 128 * c;
    if (i >= DA_STAGES) mbar_wait(empty0 + 8 * slot, ((i / DA_STAGES) - 1) & 1);
    const int s0 = (b0 + i / NC) * DA_BLK;
    const uint32_t st = sm + slot * L::STAGE, full = full0 + 8 * slot;
    if (lane == 0) {
      mbar_expect_tx(full, tx);
      if (Q8) {
        if (!w.kcp) tma_3d(st + L::K_OFF, tmk, full, x0, s0, h);
        if (!w.vcp) tma_3d(st + L::V_OFF, tmv, full, x0, s0, h);
      } else {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          tma_3d(st + L::K_OFF + hf * DA_HALF, tmk, full, x0 + 64 * hf, s0, h);
          tma_3d(st + L::V_OFF + hf * DA_HALF, tmv, full, x0 + 64 * hf, s0, h);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        tma_2d(st + L::C_OFF + hf * DA_HALF, tmc, full, x0 + 64 * hf, s0);
        tma_2d(st + L::S_OFF + hf * DA_HALF, tms, full, x0 + 64 * hf, s0);
      }
    }
    if (Q8) {  // int8 rows whose pitch TMA cannot take: 8 bytes a piece, zero outside
#pragma unroll 1
      for (int v = 0; v < 2; ++v) {
        if (!(v ? w.vcp : w.kcp)) continue;
        const int D = v ? w.Dv : a.D;
        const int8_t* base = v ? w.v8 : w.k8;
        for (int pi = lane; pi < DA_BLK * 16; pi += 32) {
          const int cell = pi >> 4, p = pi & 15, s = s0 + cell, d = x0 + 8 * p;
          const bool ok = s < a.S && d < D;
          cp_async8(st + (v ? L::V_OFF : L::K_OFF) + swz(cell, 8 * p),
                    base + (ok ? ((size_t)h * a.S + s) * D + d : 0), ok ? 8 : 0);
        }
      }
    }
    for (int e = lane; e < a.T * DA_BLK; e += 32) {
      const int t = e / DA_BLK, s = s0 + e % DA_BLK;
      cp_async4(st + L::B_OFF + 4 * e, a.bias + (size_t)t * a.S + min(s, a.S - 1),
                s < a.S ? 4 : 0);
    }
    if (Q8) {
      const long long w0 = ((long long)h * a.S + s0) >> 1;
      for (int e = lane; e < 2 * DA_SC_WORDS; e += 32) {
        const int v = e / DA_SC_WORDS, wi = e % DA_SC_WORDS;
        const long long byte = 4 * (w0 + wi);
        const int n = (int)max(0LL, min(4LL, sc_bytes - byte));
        const char* base = reinterpret_cast<const char*>(v ? a.vs : a.ks);
        cp_async4(st + (v ? L::VS_OFF : L::KS_OFF) + 4 * wi, base + (n ? byte : 0), n);
      }
    }
    cp_async_arrive(full);
  }
}

// one consumer warp of the wide kernel over blocks [b0, b1): as da_consumer,
// with the scores summed over a block's NC items and acc[8 NC][NR][4].
// SOFTCAP: a score s becomes cap.y * tanhf(s * cap.x) + max(bias, -1e30) *
// log2 e, cap.x = scale / softcap and cap.y = softcap * log2 e (the TPU
// kernel's tanh(s * scale / cap) * cap, in log2 units)
template <bool Q8, int NR, int NC, bool SOFTCAP>
__device__ __forceinline__ void dw_consumer(const DecArgs& a, uint8_t* smem, uint32_t full0,
                                            uint32_t empty0, int h, int r0, int b0, int b1,
                                            float (&acc)[8 * NC][NR][4], float (&m)[NR][2],
                                            float (&l)[NR][2], float2 cap) {
  using L = DecSmem<Q8>;
  using W = DecWideSmem<Q8>;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int cw0 = DA_CELLS * w;
  int tok[NR][2];
#pragma unroll
  for (int nr = 0; nr < NR; ++nr)
#pragma unroll
    for (int i = 0; i < 2; ++i) tok[nr][i] = min((r0 + 8 * nr + 2 * t4 + i) / a.G, a.T - 1);
  const int v_cell = (lane & 7) + 8 * (lane >> 4), v_col = 8 * ((lane >> 3) & 1);
  uint8_t* vt = smem + W::VT_OFF + w * L::VT_WARP;

  for (int j = 0; j < b1 - b0; ++j) {
    const int sc0 = (int)(((long long)h * a.S + (b0 + j) * DA_BLK) & 1);
    float sh[NR][4], sl[NR][4];
#pragma unroll
    for (int nr = 0; nr < NR; ++nr)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[nr][e] = sl[nr][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int it = j * NC + c, slot = it % DA_STAGES;
      mbar_wait(full0 + 8 * slot, (it / DA_STAGES) & 1);
      const uint8_t* st = smem + slot * L::STAGE;
      float kscale[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        kscale[i] = Q8 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                             st + L::KS_OFF)[sc0 + cw0 + g + 8 * i])
                       : 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int hf = kk >> 2;
        uint32_t chi[4], cnl[4], shi[4], snl[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int cc = cw0 + g + 8 * i;
          const int cb = swz(cc, 32 * (kk & 3) + 8 * t4) + hf * DA_HALF;
          uint32_t k2[2];
          if (Q8) {
            dq4(*reinterpret_cast<const uint32_t*>(st + L::K_OFF + swz(cc, 16 * kk + 4 * t4)),
                kscale[i], k2[0], k2[1]);
          } else {
            const uint2 kw = *reinterpret_cast<const uint2*>(st + L::K_OFF + cb);
            k2[0] = kw.x;
            k2[1] = kw.y;
          }
          const uint2 cw = *reinterpret_cast<const uint2*>(st + L::C_OFF + cb);
          const uint2 sw = *reinterpret_cast<const uint2*>(st + L::S_OFF + cb);
          const uint32_t c2[2] = {cw.x, cw.y}, s2[2] = {sw.x, sw.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ai = i + 2 * e;
            const uint32_t kn = k2[e] ^ 0x80008000u;
            chi[ai] = bmul2(k2[e], c2[e]);
            cnl[ai] = bfma2(kn, c2[e], chi[ai]);
            shi[ai] = bmul2(k2[e], s2[e]);
            snl[ai] = bfma2(kn, s2[e], shi[ai]);
          }
        }
        // q and q_rot of dims 128c + 16kk.. from their 64-dim quarter
        const uint8_t* qa = smem + W::Q_OFF + (2 * c + hf) * (DW_ROWS * 128);
#pragma unroll
        for (int nr = 0; nr < NR; ++nr) {
          const int o = swz(8 * nr + g, 32 * (kk & 3) + 8 * t4);
          const uint2 x = *reinterpret_cast<const uint2*>(qa + o);
          const uint2 y = *reinterpret_cast<const uint2*>(qa + W::Q_WHICH + o);
          mma_bf16(sh[nr], chi, x.x, x.y);
          mma_bf16(sh[nr], shi, y.x, y.y);
          mma_bf16(sl[nr], cnl, x.x, x.y);
          mma_bf16(sl[nr], snl, y.x, y.y);
        }
      }
    }

    // the online softmax, the bias from the block's first item
    const uint8_t* st0 = smem + ((j * NC) % DA_STAGES) * L::STAGE;
    const float* bias = reinterpret_cast<const float*>(st0 + L::B_OFF);
    const int cell0 = (b0 + j) * DA_BLK + cw0;
    uint32_t ph[NR][2], pl[NR][2];
    float al[NR][2];
    bool moved = false;
#pragma unroll
    for (int nr = 0; nr < NR; ++nr) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = g + 8 * (e >> 1);
        float x;
        if constexpr (SOFTCAP)
          x = fmaf(tanhf((sh[nr][e] - sl[nr][e]) * cap.x), cap.y,
                   fmaxf(bias[tok[nr][e & 1] * DA_BLK + cw0 + cl], DA_NEG) * DA_LOG2E);
        else
          x = (sh[nr][e] - sl[nr][e]) * a.scale2 +
              fmaxf(bias[tok[nr][e & 1] * DA_BLK + cw0 + cl], DA_NEG) * DA_LOG2E;
        p[e] = cell0 + cl < a.S ? x : -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(p[i], p[2 + i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[nr][i], mx);
        const float alpha = ex2(m[nr][i] - mn);
        m[nr][i] = mn;
        p[i] = ex2(p[i] - mn);
        p[2 + i] = ex2(p[2 + i] - mn);
        l[nr][i] = l[nr][i] * alpha + (p[i] + p[2 + i]);
        al[nr][i] = alpha;
        moved |= alpha != 1.f;
      }
      uint32_t hi0, lo0, hi1, lo1;
      split_hilo(p[0], p[1], hi0, lo0);
      split_hilo(p[2], p[3], hi1, lo1);
      ph[nr][0] = mov_t(hi0);
      ph[nr][1] = mov_t(hi1);
      pl[nr][0] = mov_t(lo0);
      pl[nr][1] = mov_t(lo1);
    }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int dm = 0; dm < 8 * NC; ++dm)
#pragma unroll
        for (int nr = 0; nr < NR; ++nr)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dm][nr][e] *= al[nr][e & 1];
    }

    // O^T += V^T.P^T, item c's V into accumulator dims 128c..
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint8_t* st = smem + ((j * NC + c) % DA_STAGES) * L::STAGE;
      uint32_t v_base = smem_u32(st + L::V_OFF);
      int v_row = cw0 + v_cell, v_half = DA_HALF;
      if (Q8) {
        __syncwarp();  // the last item's ldmatrix reads are done
#pragma unroll
        for (int i = 0; i < DA_CELLS / 4; ++i) {
          const int ci = lane + 32 * i, row = ci >> 3, c16 = ci & 7;
          const uint4 raw =
              *reinterpret_cast<const uint4*>(st + L::V_OFF + swz(cw0 + row, 16 * c16));
          const float s = __bfloat162float(
              reinterpret_cast<const __nv_bfloat16*>(st + L::VS_OFF)[sc0 + cw0 + row]);
          uint4 lo, hi;
          dq16(raw, s, lo, hi);
          uint8_t* dst = vt + (c16 >> 2) * (DA_CELLS * 128);
          *reinterpret_cast<uint4*>(dst + swz(row, (c16 & 3) * 32)) = lo;
          *reinterpret_cast<uint4*>(dst + swz(row, (c16 & 3) * 32 + 16)) = hi;
        }
        __syncwarp();
        v_base = smem_u32(vt);
        v_row = v_cell;
        v_half = DA_CELLS * 128;
      }
#pragma unroll
      for (int dm = 0; dm < 8; ++dm) {
        const int d = 16 * dm + v_col;
        uint32_t va[4];
        ldsm_x4_t(va, v_base + (d >> 6) * v_half + swz(v_row, (d & 63) * 2));
#pragma unroll
        for (int nr = 0; nr < NR; ++nr) {
          mma_bf16(acc[8 * c + dm][nr], va, ph[nr][0], ph[nr][1]);
          mma_bf16(acc[8 * c + dm][nr], va, pl[nr][0], pl[nr][1]);
        }
      }
    }
    fence_proxy_async();  // generic reads of the NC slots before their next TMA
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) mbar_arrive(empty0 + 8 * ((j * NC + c) % DA_STAGES));
    }
  }
#pragma unroll
  for (int nr = 0; nr < NR; ++nr)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[nr][i] += __shfl_xor_sync(0xffffffffu, l[nr][i], 4);
      l[nr][i] += __shfl_xor_sync(0xffffffffu, l[nr][i], 8);
      l[nr][i] += __shfl_xor_sync(0xffffffffu, l[nr][i], 16);
    }
}

// a CTA of the wide kernel: as decode_cta, with Dk = a.D and Dv apart;
// SOFTCAP and cap as dw_consumer's
template <bool Q8, int NR, int NC, bool SOFTCAP>
__device__ __forceinline__ void decode_wide_cta(const CUtensorMap* tmk, const CUtensorMap* tmv,
                                                const CUtensorMap* tmc, const CUtensorMap* tms,
                                                const DecWideArgs& wa, float2 cap) {
  using W = DecWideSmem<Q8>;
  constexpr int RC = 8 * NR, DM = 8 * NC, DH = 128 * NC;  // rows, dim tiles, dims held
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * DA_STAGES];
  const DecArgs& a = wa.a;
  const int Dk = a.D, Dv = wa.Dv;
  const uint32_t raw = smem_u32(dyn_smem);
  uint8_t* smem = dyn_smem + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sm = smem_u32(smem);
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[DA_STAGES]);
  const int C = gridDim.x, rank = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * RC;
  const int nblk = (a.S + DA_BLK - 1) / DA_BLK;
  const int b0 = min(nblk, rank * a.bpr), b1 = min(nblk, b0 + a.bpr);
  const int nrows = min(RC, a.R - r0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < DA_STAGES; ++s) {
      mbar_init(full0 + 8 * s, DA_FULL_ARRIVALS);
      mbar_init(empty0 + 8 * s, DA_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[DM][NR][4], m[NR][2], l[NR][2];
#pragma unroll
  for (int nr = 0; nr < NR; ++nr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[nr][i] = DA_NEG * DA_LOG2E;
      l[nr][i] = 0.f;
    }
#pragma unroll
    for (int dm = 0; dm < DM; ++dm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dm][nr][e] = 0.f;
  }
  if (warp == DA_WARPS) {
    dw_producer<Q8, NC>(tmk, tmv, tmc, tms, wa, sm, full0, empty0, h, b0, b1);
  } else {
    // q and q_rot of rows r0.. into [which][quarter][row][128 B], dims past Dk zero
    for (int i = threadIdx.x; i < 2 * RC * 32; i += DA_WARPS * 32) {
      const int which = i / (RC * 32), r = (i / 32) % RC, c16 = i % 32;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows && 8 * c16 < Dk) {
        const int rg = r0 + r, t = rg / a.G, g = rg % a.G;
        const __nv_bfloat16* src =
            (which ? a.qr : a.q) + ((size_t)t * a.H + (size_t)h * a.G + g) * Dk + 8 * c16;
        v = *reinterpret_cast<const uint4*>(src);
      }
      *reinterpret_cast<uint4*>(smem + W::Q_OFF + which * W::Q_WHICH +
                                (c16 >> 3) * DW_ROWS * 128 + swz(r, (c16 & 7) * 16)) = v;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(DA_WARPS * 32) : "memory");
    dw_consumer<Q8, NR, NC, SOFTCAP>(a, smem, full0, empty0, h, r0, b0, b1, acc, m, l, cap);
  }
  __syncthreads();

  float* wacc = reinterpret_cast<float*>(smem + W::W_ACC);
  float* wm = reinterpret_cast<float*>(smem + W::W_M);
  float* wl = reinterpret_cast<float*>(smem + W::W_L);
  float* cacc = reinterpret_cast<float*>(smem + W::C_ACC);
  float* cm = reinterpret_cast<float*>(smem + W::C_M);
  float* cl = reinterpret_cast<float*>(smem + W::C_L);
  if (warp < DA_WARPS) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int nr = 0; nr < NR; ++nr)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 8 * nr + 2 * t4 + i;
        if (row < nrows) {
#pragma unroll
          for (int dm = 0; dm < DM; ++dm)
#pragma unroll
            for (int e = i; e < 4; e += 2)
              wacc[(((warp * DM + dm) * NR + nr) * 4 + e) * 32 + lane] = acc[dm][nr][e];
          if (g == 0) {
            wm[warp * DW_ROWS + row] = m[nr][i];
            wl[warp * DW_ROWS + row] = l[nr][i];
          }
        }
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * DH; i += DA_THREADS) {
    const int r = i / DH, d = i % DH;
    const int frag = ((d >> 4) * NR + (r >> 3)) * 4 + 2 * ((d >> 3) & 1) + (r & 1);
    const int fl = 4 * (d & 7) + ((r & 7) >> 1);
    float M = wm[r];
#pragma unroll
    for (int w = 1; w < DA_WARPS; ++w) M = fmaxf(M, wm[w * DW_ROWS + r]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float e = ex2(wm[w * DW_ROWS + r] - M);
      Ls += wl[w * DW_ROWS + r] * e;
      A += wacc[(w * DM * NR * 4 + frag) * 32 + fl] * e;
    }
    cacc[r * DH + d] = A;
    if (d == 0) {
      cm[r] = M;
      cl[r] = Ls;
    }
  }
  if (C > 1) cluster_sync_all();
  else __syncthreads();
  float* xm = reinterpret_cast<float*>(smem + W::X_M);
  float* xl = reinterpret_cast<float*>(smem + W::X_L);
  for (int i = threadIdx.x; i < C * nrows; i += DA_THREADS) {
    const int q = i / nrows, r = i % nrows;
    xm[q * DW_ROWS + r] = C > 1 ? ld_dsmem(smem_u32(cm + r), q) : cm[r];
    xl[q * DW_ROWS + r] = C > 1 ? ld_dsmem(smem_u32(cl + r), q) : cl[r];
  }
  __syncthreads();
  const int elems = nrows * Dv, per = (elems + C - 1) / C;
  const int e0 = rank * per, e1 = min(elems, e0 + per);
  for (int i = e0 + threadIdx.x; i < e1; i += DA_THREADS) {
    const int r = i / Dv, d = i % Dv;
    const int ci = r * DH + d;
    float M = -INFINITY;
    for (int q = 0; q < C; ++q) M = fmaxf(M, xm[q * DW_ROWS + r]);
    float o[DA_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < DA_MAX_CLUSTER; ++q)
      if (q < C) o[q] = ld_dsmem(smem_u32(cacc + ci), q);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int q = 0; q < DA_MAX_CLUSTER; ++q) {
      if (q < C) {
        const float e = ex2(xm[q * DW_ROWS + r] - M);
        Ls += xl[q * DW_ROWS + r] * e;
        A += o[q] * e;
      }
    }
    const int rg = r0 + r, t = rg / a.G, g = rg % a.G;
    a.out[((size_t)t * a.H + (size_t)h * a.G + g) * Dv + d] = A / fmaxf(Ls, 1e-30f);
  }
  if (C > 1) cluster_sync_all();
}

template <bool Q8, int NR, int NC>
__global__ void __launch_bounds__(DA_THREADS, 1)
flash_decode_tc_wide(const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __grid_constant__ CUtensorMap tmc,
                     const __grid_constant__ CUtensorMap tms, const DecWideArgs wa) {
  decode_wide_cta<Q8, NR, NC, false>(&tmk, &tmv, &tmc, &tms, wa, make_float2(0.f, 0.f));
}

// the wide kernel with gemma2's attention softcap: cap = (scale / softcap,
// softcap * log2 e)
template <bool Q8, int NR, int NC>
__global__ void __launch_bounds__(DA_THREADS, 1)
flash_decode_tc_wide_cap(const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv,
                         const __grid_constant__ CUtensorMap tmc,
                         const __grid_constant__ CUtensorMap tms, const DecWideArgs wa,
                         const float2 cap) {
  decode_wide_cta<Q8, NR, NC, true>(&tmk, &tmv, &tmc, &tms, wa, cap);
}

// ----------------------------------------------------------------------------
// host side: the tensor maps (hopper.cuh's make_map) and the cluster launch

struct DecPtrs {
  const void *q, *qr, *k, *ks, *v, *vs, *cs, *sn, *bias;
  void* out;
};

// the kernel for head dim D: flash_decode_tc at 128, else flash_decode_tc_dim
template <bool Q8, int NR>
using DecKernel = decltype(&flash_decode_tc<Q8, NR>);

template <bool Q8, int NR>
DecKernel<Q8, NR> decode_kernel(int D) {
  switch (D) {
    case DA_D: return flash_decode_tc<Q8, NR>;
    case 64: return flash_decode_tc_dim<Q8, NR, 64>;
    case 80: return flash_decode_tc_dim<Q8, NR, 80>;
    case 96: return flash_decode_tc_dim<Q8, NR, 96>;
    default: return flash_decode_tc_dim<Q8, NR, 0>;
  }
}

// the ALiBi kernel for head dim D: D = 128's, else the run-time D's
template <bool Q8, int NR>
using DecAlibiKernel = decltype(&flash_decode_tc_alibi<Q8, NR, DA_D>);

template <bool Q8, int NR>
DecAlibiKernel<Q8, NR> decode_alibi_kernel(int D) {
  return D == DA_D ? flash_decode_tc_alibi<Q8, NR, DA_D> : flash_decode_tc_alibi<Q8, NR, 0>;
}

// ALIBI: the ALiBi kernels, with al
template <bool Q8, int NR, bool ALIBI>
int launch_t(const DecPtrs& p, int T, int H, int Hkv, int S, int D, float scale, int cluster,
             cudaStream_t st, const DecAlibi& al) {
  using L = DecSmem<Q8, ALIBI>;
  static bool attr[5] = {false, false, false, false, false};  // by the kernel's case
  const int ai = D == DA_D ? 0 : ALIBI ? 1 : D == 64 ? 1 : D == 80 ? 2 : D == 96 ? 3 : 4;
  if (!attr[ai]) {
    if constexpr (ALIBI)
      cudaFuncSetAttribute(decode_alibi_kernel<Q8, NR>(D),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    else
      cudaFuncSetAttribute(decode_kernel<Q8, NR>(D), cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::BYTES);
    attr[ai] = true;
  }
  const int G = H / Hkv, R = T * G, nblk = (S + DA_BLK - 1) / DA_BLK;
  using bf = __nv_bfloat16;
  DecArgs a{(const bf*)p.q, (const bf*)p.qr, (const float*)p.bias, (const bf*)p.ks,
            (const bf*)p.vs, (float*)p.out, T, H, Hkv, G, S, R,
            (nblk + cluster - 1) / cluster, scale * DA_LOG2E, D};

  // the maps have the true width D: a box's columns past D (the whole second
  // 64-dim half where D <= 64) arrive as zeros
  CUtensorMap mk, mv, mc, ms;
  {  // K, V: [Hkv, S, D] as 3-D maps; K3: 64-dim halves of bf16, K3q: int8 rows
    const cuuint64_t es = Q8 ? 1 : 2;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Hkv};
    const cuuint64_t strides[2] = {D * es, (cuuint64_t)S * D * es};
    const cuuint32_t box[3] = {Q8 ? 128u : 64u, (cuuint32_t)DA_BLK, 1};
    const CUtensorMapDataType dt =
        Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (int rc = make_map(&mk, dt, 3, p.k, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
    if (int rc = make_map(&mv, dt, 3, p.v, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  if (!ALIBI) {  // cos, sin: [S, D] bf16, 64-dim halves (ALIBI: no rope)
    const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)S};
    const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)DA_BLK};
    if (int rc = make_map(&mc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.cs, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
    if (int rc = make_map(&ms, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.sn, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(cluster, Hkv, (R + 8 * NR - 1) / (8 * NR));
  cfg.blockDim = dim3(DA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if constexpr (ALIBI)
    return (int)cudaLaunchKernelEx(&cfg, decode_alibi_kernel<Q8, NR>(D), mk, mv, a, al);
  else
    return (int)cudaLaunchKernelEx(&cfg, decode_kernel<Q8, NR>(D), mk, mv, mc, ms, a);
}

// the rows of a KV head in one, two or four n8 tiles (chunks of 32 past 32);
// ALIBI: the ALiBi kernels
template <bool Q8, bool ALIBI = false>
int launch_any(const DecPtrs& p, int T, int H, int Hkv, int S, int D, float scale, int cluster,
               void* stream, const DecAlibi& al = DecAlibi{nullptr, nullptr, nullptr}) {
  if (T < 1 || T > DA_MAX_T || Hkv < 1 || H % Hkv || S < 1) return (int)cudaErrorInvalidValue;
  if (D < 8 || D > DA_D || D % (Q8 ? 16 : 8)) return (int)cudaErrorInvalidValue;
  const int nblk = (S + DA_BLK - 1) / DA_BLK;
  if (cluster < 1 || cluster > DA_MAX_CLUSTER || cluster > nblk) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int R = T * (H / Hkv);
  const int rc = R <= 8    ? launch_t<Q8, 1, ALIBI>(p, T, H, Hkv, S, D, scale, cluster, st, al)
                 : R <= 16 ? launch_t<Q8, 2, ALIBI>(p, T, H, Hkv, S, D, scale, cluster, st, al)
                           : launch_t<Q8, 4, ALIBI>(p, T, H, Hkv, S, D, scale, cluster, st, al);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// the wide kernel's launch: Dk, Dv multiples of 8 up to 256, rows in one or
// two n8 tiles (chunks of 16 past 16), NC = 1 up to 128 dims, else 2;
// SOFTCAP: the capped instantiation, at softcap > 0
template <bool Q8, int NR, int NC, bool SOFTCAP>
int launch_wide_t(const DecPtrs& p, int T, int H, int Hkv, int S, int Dk, int Dv, float scale,
                  float softcap, int cluster, cudaStream_t st) {
  using W = DecWideSmem<Q8>;
  static bool attr = false;
  if (!attr) {
    if constexpr (SOFTCAP)
      cudaFuncSetAttribute(flash_decode_tc_wide_cap<Q8, NR, NC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, W::BYTES);
    else
      cudaFuncSetAttribute(flash_decode_tc_wide<Q8, NR, NC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, W::BYTES);
    attr = true;
  }
  const int G = H / Hkv, R = T * G, nblk = (S + DA_BLK - 1) / DA_BLK;
  using bf = __nv_bfloat16;
  DecWideArgs wa{{(const bf*)p.q, (const bf*)p.qr, (const float*)p.bias, (const bf*)p.ks,
                  (const bf*)p.vs, (float*)p.out, T, H, Hkv, G, S, R,
                  (nblk + cluster - 1) / cluster, scale * DA_LOG2E, Dk},
                 Dv, Q8 && Dk % 16 != 0, Q8 && Dv % 16 != 0, (const int8_t*)p.k,
                 (const int8_t*)p.v};
  CUtensorMap mk, mv, mc, ms;
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  const CUtensorMapDataType dt =
      Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t es = Q8 ? 1 : 2;
  const cuuint32_t box[3] = {Q8 ? 128u : 64u, (cuuint32_t)DA_BLK, 1};
  for (int v = 0; v < 2; ++v) {  // K at Dk, V at Dv: [Hkv, S, D] 3-D maps
    const int D = v ? Dv : Dk;
    if (v ? wa.vcp : wa.kcp) continue;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Hkv};
    const cuuint64_t strides[2] = {D * es, (cuuint64_t)S * D * es};
    if (int rc = make_map(v ? &mv : &mk, dt, 3, v ? p.v : p.k, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  {  // cos, sin: [S, Dk] bf16, 64-dim halves
    const cuuint64_t dims[2] = {(cuuint64_t)Dk, (cuuint64_t)S};
    const cuuint64_t strides[1] = {(cuuint64_t)Dk * 2};
    const cuuint32_t cbox[2] = {64, (cuuint32_t)DA_BLK};
    if (int rc = make_map(&mc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.cs, dims, strides, cbox,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
    if (int rc = make_map(&ms, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.sn, dims, strides, cbox,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
  }
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(cluster, Hkv, (R + 8 * NR - 1) / (8 * NR));
  cfg.blockDim = dim3(DA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = W::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if constexpr (SOFTCAP)
    return (int)cudaLaunchKernelEx(&cfg, flash_decode_tc_wide_cap<Q8, NR, NC>, mk, mv, mc, ms,
                                   wa, make_float2(scale / softcap, softcap * DA_LOG2E));
  else
    return (int)cudaLaunchKernelEx(&cfg, flash_decode_tc_wide<Q8, NR, NC>, mk, mv, mc, ms, wa);
}

template <bool Q8, bool SOFTCAP>
int launch_wide_rows(const DecPtrs& p, int T, int H, int Hkv, int S, int Dk, int Dv,
                     float scale, float softcap, int cluster, cudaStream_t st) {
  const bool two = Dk > 128 || Dv > 128;
  if (T * (H / Hkv) <= 8)
    return two ? launch_wide_t<Q8, 1, 2, SOFTCAP>(p, T, H, Hkv, S, Dk, Dv, scale, softcap,
                                                  cluster, st)
               : launch_wide_t<Q8, 1, 1, SOFTCAP>(p, T, H, Hkv, S, Dk, Dv, scale, softcap,
                                                  cluster, st);
  return two ? launch_wide_t<Q8, 2, 2, SOFTCAP>(p, T, H, Hkv, S, Dk, Dv, scale, softcap,
                                                cluster, st)
             : launch_wide_t<Q8, 2, 1, SOFTCAP>(p, T, H, Hkv, S, Dk, Dv, scale, softcap,
                                                cluster, st);
}

template <bool Q8>
int launch_wide(const DecPtrs& p, int T, int H, int Hkv, int S, int Dk, int Dv, float scale,
                float softcap, int cluster, void* stream) {
  if (T < 1 || T > DA_MAX_T || Hkv < 1 || H % Hkv || S < 1) return (int)cudaErrorInvalidValue;
  if (Dk < 8 || Dk > DW_DIMS || Dk % 8 || Dv < 8 || Dv > DW_DIMS || Dv % 8)
    return (int)cudaErrorInvalidValue;
  const int nblk = (S + DA_BLK - 1) / DA_BLK;
  if (cluster < 1 || cluster > DA_MAX_CLUSTER || cluster > nblk) return (int)cudaErrorInvalidValue;
  if (!(softcap >= 0.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rc =
      softcap > 0.f
          ? launch_wide_rows<Q8, true>(p, T, H, Hkv, S, Dk, Dv, scale, softcap, cluster, st)
          : launch_wide_rows<Q8, false>(p, T, H, Hkv, S, Dk, Dv, scale, softcap, cluster, st);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace

// K3: cluster is the number of CTAs that split a KV head's cells
// (ops/cuda_attn.py::decode_attn_plan), 1..8 and at most ceil(S / 64); D
// the head dim, a multiple of 8 up to 128.
extern "C" int flash_decode_launch(const void* q, const void* qr, const void* k, const void* v,
                                   const void* cs, const void* sn, const void* bias, void* out,
                                   int T, int H, int Hkv, int S, int D, float scale,
                                   int cluster, void* stream) {
  const DecPtrs p{q, qr, k, nullptr, v, nullptr, cs, sn, bias, out};
  return launch_any<false>(p, T, H, Hkv, S, D, scale, cluster, stream);
}

// K3q: the same on int8 K/V with bf16 scales [Hkv, S] (the trailing 1
// dropped); D a multiple of 16 up to 128.
extern "C" int flash_decode_q8_launch(const void* q, const void* qr, const void* k,
                                      const void* ks, const void* v, const void* vs,
                                      const void* cs, const void* sn, const void* bias,
                                      void* out, int T, int H, int Hkv, int S, int D,
                                      float scale, int cluster, void* stream) {
  const DecPtrs p{q, qr, k, ks, v, vs, cs, sn, bias, out};
  return launch_any<true>(p, T, H, Hkv, S, D, scale, cluster, stream);
}

// K3 with ALiBi (K3_alibi), on rope NONE (no q_rot, cos or sin): slopes
// [H], tok_pos [T] and cell_pos [S] f32, 16-byte aligned; otherwise as
// flash_decode_launch.
extern "C" int flash_decode_alibi_launch(const void* q, const void* k, const void* v,
                                         const void* bias, const void* slopes,
                                         const void* tok_pos, const void* cell_pos, void* out,
                                         int T, int H, int Hkv, int S, int D, float scale,
                                         int cluster, void* stream) {
  const DecPtrs p{q, nullptr, k, nullptr, v, nullptr, nullptr, nullptr, bias, out};
  return launch_any<false, true>(
      p, T, H, Hkv, S, D, scale, cluster, stream,
      DecAlibi{(const float*)slopes, (const float*)tok_pos, (const float*)cell_pos});
}

// K3q with ALiBi (K3q_alibi).
extern "C" int flash_decode_q8_alibi_launch(const void* q, const void* k, const void* ks,
                                            const void* v, const void* vs, const void* bias,
                                            const void* slopes, const void* tok_pos,
                                            const void* cell_pos, void* out, int T, int H,
                                            int Hkv, int S, int D, float scale, int cluster,
                                            void* stream) {
  const DecPtrs p{q, nullptr, k, ks, v, vs, nullptr, nullptr, bias, out};
  return launch_any<true, true>(
      p, T, H, Hkv, S, D, scale, cluster, stream,
      DecAlibi{(const float*)slopes, (const float*)tok_pos, (const float*)cell_pos});
}

// K3 at Dk, Dv apart (each a multiple of 8 up to 256): the wide kernel.
// cluster: CTAs a KV head (decode_attn_plan with 16 rows a CTA). softcap >
// 0: the capped instantiation (gemma2's attention logit cap); 0: none.
extern "C" int flash_decode_wide_launch(const void* q, const void* qr, const void* k,
                                        const void* v, const void* cs, const void* sn,
                                        const void* bias, void* out, int T, int H, int Hkv,
                                        int S, int Dk, int Dv, float scale, float softcap,
                                        int cluster, void* stream) {
  const DecPtrs p{q, qr, k, nullptr, v, nullptr, cs, sn, bias, out};
  return launch_wide<false>(p, T, H, Hkv, S, Dk, Dv, scale, softcap, cluster, stream);
}

// K3q on the wide kernel: int8 rows at any multiple of 8, one scale a row.
extern "C" int flash_decode_wide_q8_launch(const void* q, const void* qr, const void* k,
                                           const void* ks, const void* v, const void* vs,
                                           const void* cs, const void* sn, const void* bias,
                                           void* out, int T, int H, int Hkv, int S, int Dk,
                                           int Dv, float scale, float softcap, int cluster,
                                           void* stream) {
  const DecPtrs p{q, qr, k, ks, v, vs, cs, sn, bias, out};
  return launch_wide<true>(p, T, H, Hkv, S, Dk, Dv, scale, softcap, cluster, stream);
}
