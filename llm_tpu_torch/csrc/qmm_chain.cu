// K6: a chain of quantized decode matmuls with their glue, in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel llm_tpu/ops/pallas_qmm_chain.py::qmm_chain ->
// _chain_kernel. A chain is a layer tail
//
//   y1 = att @ Wo;  h = bf16(x_res + bf16(y1));  hn = bf16(rms(h) * gamma)
//   gu = hn @ Wgu;  cur = bf16(silu(g) * u);     y3 = cur @ Wd
//   out = bf16(h + bf16(y3))
//
// or one phase, out = (bf16(rms(x) * gamma)) @ W cast to bf16 or f32 (the
// attn_norm -> fused QKV head and the final norm -> lm_head).
//
// Bound: the bytes of the chain's planes (each read once), as for the
// K1/K2 launches it replaces; the intermediates are small (gu at B=8 is
// 0.9 MB of f32) and stay in the 50 MB L2.
//
// Design. The TPU kernel walks one sequential grid and keeps the
// intermediates in VMEM. Here CTAs run in parallel and share nothing, so
// the kernel is a persistent cooperative grid (cudaLaunchCooperativeKernel,
// as many CTAs as can be resident, so that a grid that does not fit is
// refused rather than deadlocked):
//  * it zeroes every phase's f32 accumulator (scratch in device memory,
//    allocated by the wrapper), then a grid barrier;
//  * each phase is a set of (N tile, K range) work items that the CTAs
//    walk, each the same GEMV work as one CTA of K1/K2 (qmm_gemv.cuh), its
//    partial sums meeting in the phase's accumulator by atomics; a grid
//    barrier closes the phase;
//  * the phase boundary is applied while a work item stages its K range
//    of x: the RMSNorm (each CTA recomputes the rows' RMS from the previous
//    phase's output, read back from L2, so the norm needs no barrier of its
//    own), the residual add and SwiGLU are elementwise;
//  * after the last barrier the CTAs write the output (the residual add,
//    or the cast).
// So a tail is one launch, with no memset, and four grid barriers.

#include <cooperative_groups.h>

#include "qmm_gemv.cuh"

namespace cg = cooperative_groups;

enum { PRE_CAST = 0, PRE_NORM = 1, PRE_RES_NORM = 2, PRE_SWIGLU = 3 };
constexpr int MAX_PHASES = 3;
constexpr int CHAIN_MAX_B = 8;

// one phase; mirrored by ctypes in ops/cuda_qmm_chain.py
struct PhaseDesc {
  const void* qs;       // uint8 [K/2, N] (p4) or int8 [K, N] (i8)
  const void* scales;   // [K/gs, N] f32 or bf16
  const void* mins;     // same, or null
  const float* gamma;   // [K] for PRE_NORM / PRE_RES_NORM, else null
  float* acc;           // f32 [B, N]: the phase's output, zeroed in the launch
  int K, N, gs, zp, p4, scales_bf16, pre;
  int ntiles, ksplit, upc;  // set by qmm_chain_launch
};

struct ChainArgs {
  PhaseDesc ph[MAX_PHASES];
  int P, B;
  const __nv_bfloat16* x;     // [B, K of phase 0]
  const __nv_bfloat16* xres;  // [B, N of phase 0] (the residual), or null
  void* out;                  // [B, N of the last phase], bf16 or f32
  int out_f32, add_res;
  float eps;
};

namespace {

// the x a phase's GEMV reads, its boundary applied
struct ChainRows {
  int pre, b0, ld;              // ld: the phase's K
  const __nv_bfloat16* x;       // PRE_CAST / PRE_NORM rows [B, ld]
  const __nv_bfloat16* xres;    // PRE_RES_NORM residual [B, ld]
  const float* prev;            // the previous phase's output
  const float* gamma;
  const float* rinv;            // [B] 1 / rms of each row, in shared memory

  // h = bf16(x_res + bf16(y1)) of the residual boundary
  __device__ __forceinline__ float h(int b, int k) const {
    const size_t i = (size_t)b * ld + k;
    return round_bf16(__bfloat162float(xres[i]) + round_bf16(__ldcg(prev + i)));
  }
  // the value whose RMS the norm takes
  __device__ __forceinline__ float norm_src(int b, int k) const {
    return pre == PRE_NORM ? __bfloat162float(x[(size_t)b * ld + k]) : h(b, k);
  }
  __device__ __forceinline__ float operator()(int b, int k) const {
    b += b0;
    switch (pre) {
      case PRE_CAST:
        return __bfloat162float(x[(size_t)b * ld + k]);
      case PRE_NORM:
      case PRE_RES_NORM:
        return round_bf16(norm_src(b, k) * rinv[b] * gamma[k]);
      default: {  // PRE_SWIGLU over gu [B, 2 * ld]
        const float* row = prev + (size_t)b * 2 * ld;
        const float g = __ldcg(row + k), u = __ldcg(row + ld + k);
        return round_bf16(g / (1.f + expf(-g)) * u);
      }
    }
  }
};

// rinv[b] = 1 / sqrt(mean_k v[b,k]^2 + eps) for every row, by the whole CTA
__device__ void row_rinv(const ChainRows& xl, int B, float eps, float* rinv,
                         float (*red)[CHAIN_MAX_B]) {
  float ss[CHAIN_MAX_B];
#pragma unroll
  for (int b = 0; b < CHAIN_MAX_B; ++b) ss[b] = 0.f;
  for (int k = threadIdx.x; k < xl.ld; k += GV_THREADS) {
#pragma unroll
    for (int b = 0; b < CHAIN_MAX_B; ++b) {
      if (b < B) {
        const float v = xl.norm_src(b, k);
        ss[b] = fmaf(v, v, ss[b]);
      }
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < CHAIN_MAX_B; ++b) {
    float v = ss[b];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][b] = v;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    float s = 0.f;
    for (int w = 0; w < GV_WARPS; ++w) s += red[w][threadIdx.x];
    rinv[threadIdx.x] = 1.f / sqrtf(s / (float)xl.ld + eps);
  }
  __syncthreads();
}

template <int NB, bool P4, bool SBF16, bool MINS>
__device__ __forceinline__ void phase_item(const ChainRows& xl, int nb, const PhaseDesc& ph,
                                           float* y, int u0, int nu, int n0, float* xs,
                                           float* xsum) {
  gemv_block<NB, P4, SBF16, MINS, false>(xl, nb, reinterpret_cast<const uint8_t*>(ph.qs),
                                         ph.scales, ph.mins, y, ph.N, ph.gs, ph.zp, u0, nu,
                                         n0, true, xs, xsum);
}

// NBV: rows of x per GEMV call, 1 for B = 1 (decode of one sequence), 4
// for B = 2..8 (rows in chunks of 4). The kernels are held to 64 and 128
// registers, so that 4 and 2 CTAs of 8 warps are resident per SM: the GEMV
// needs many loads in flight, and a cooperative grid cannot add CTAs
// beyond those resident. On the H100 the one-row cap took the B = 1 tails
// from 1.1x the unfused launches' time to 0.9x; a cap of 3 CTAs made the
// four-row kernel spill and lose 5%, and without a cap it took 1 CTA per
// SM and lost a third.
template <int NBV>
__global__ void __launch_bounds__(GV_THREADS, NBV == 1 ? 4 : 2) qmm_chain_kernel(ChainArgs a) {
  __shared__ float xs[GV_STAGE];
  __shared__ float xsum[GV_STAGE / 16];
  __shared__ float rinv[CHAIN_MAX_B];
  __shared__ float red[GV_WARPS][CHAIN_MAX_B];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B;
  const size_t gtid = (size_t)blockIdx.x * GV_THREADS + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * GV_THREADS;

  for (int p = 0; p < a.P; ++p) {
    float* acc = a.ph[p].acc;
    for (size_t i = gtid; i < (size_t)B * a.ph[p].N; i += gstride) acc[i] = 0.f;
  }
  grid.sync();

  for (int p = 0; p < a.P; ++p) {
    const PhaseDesc& ph = a.ph[p];
    const int items = ph.ntiles * ph.ksplit;
    if ((int)blockIdx.x < items) {  // uniform over the CTA
      ChainRows xl;
      xl.pre = ph.pre;
      xl.b0 = 0;
      xl.ld = ph.K;
      xl.x = a.x;
      xl.xres = a.xres;
      xl.prev = p > 0 ? a.ph[p - 1].acc : nullptr;
      xl.gamma = ph.gamma;
      xl.rinv = rinv;
      if (ph.pre == PRE_NORM || ph.pre == PRE_RES_NORM) row_rinv(xl, B, a.eps, rinv, red);
      const int n_units = ph.p4 ? ph.K / 64 : ph.K / 32;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int tile = item % ph.ntiles, ks = item / ph.ntiles;
        const int u0 = ks * ph.upc, nu = min(ph.upc, n_units - u0);
        for (int b0 = 0; b0 < B; b0 += GV_MAX_NB) {
          const int nb = min(GV_MAX_NB, B - b0);
          xl.b0 = b0;
          float* y = ph.acc + (size_t)b0 * ph.N;
          const int n0 = tile * GV_TILE_N;
#define CHAIN_ITEM(P, S, M) phase_item<NBV, P, S, M>(xl, nb, ph, y, u0, nu, n0, xs, xsum)
          if (ph.p4) {
            if (ph.scales_bf16) { if (ph.mins) CHAIN_ITEM(true, true, true); else CHAIN_ITEM(true, true, false); }
            else { if (ph.mins) CHAIN_ITEM(true, false, true); else CHAIN_ITEM(true, false, false); }
          } else {
            if (ph.scales_bf16) { if (ph.mins) CHAIN_ITEM(false, true, true); else CHAIN_ITEM(false, true, false); }
            else { if (ph.mins) CHAIN_ITEM(false, false, true); else CHAIN_ITEM(false, false, false); }
          }
#undef CHAIN_ITEM
        }
      }
    }
    grid.sync();
  }

  // epilogue: the residual add of a tail, or the cast of one phase
  const PhaseDesc& last = a.ph[a.P - 1];
  const size_t n_out = (size_t)B * last.N;
  for (size_t i = gtid; i < n_out; i += gstride) {
    const float v = __ldcg(last.acc + i);
    if (a.add_res) {
      const float h = round_bf16(__bfloat162float(a.xres[i]) + round_bf16(__ldcg(a.ph[0].acc + i)));
      reinterpret_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16(h + round_bf16(v));
    } else if (a.out_f32) {
      reinterpret_cast<float*>(a.out)[i] = v;
    } else {
      reinterpret_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16(v);
    }
  }
}

}  // namespace

// phases [P] (P <= 3) with every field but ntiles/ksplit/upc set; x bf16
// [B, K0] (B <= 8); xres bf16 [B, N0] or null; out [B, N_last] bf16 or f32.
// Requirements (checked by the Python wrapper): every phase's planes as
// qmm_launch takes them at B <= 16, the accumulators f32 [B, N] in device
// memory, add_res -> the last phase's N equals the first's.
// Returns a CUDA error code: nonzero when the cooperative launch is refused.
namespace {

const void* chain_kernel_for(int B) {
  return B == 1 ? (const void*)qmm_chain_kernel<1> : (const void*)qmm_chain_kernel<GV_MAX_NB>;
}

// CTAs that can be resident at once: the cooperative grid. It depends only
// on the kernel variant (B == 1 or not), so it is asked once per variant.
cudaError_t chain_grid(int B, int* grid) {
  static int cached[2] = {0, 0};
  int& g = cached[B == 1 ? 0 : 1];
  if (g == 0) {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chain_kernel_for(B), GV_THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    g = per_sm * sm_count();
  }
  *grid = g;
  return cudaSuccess;
}

}  // namespace

extern "C" int qmm_chain_launch(const PhaseDesc* phases, int P, const void* x,
                                const void* xres, void* out, int out_f32, int add_res,
                                int B, float eps, void* stream) {
  if (P < 1 || P > MAX_PHASES || B < 1 || B > CHAIN_MAX_B) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = chain_grid(B, &grid);
  if (err != cudaSuccess) return (int)err;
  ChainArgs a;
  a.P = P;
  a.B = B;
  a.x = reinterpret_cast<const __nv_bfloat16*>(x);
  a.xres = reinterpret_cast<const __nv_bfloat16*>(xres);
  a.out = out;
  a.out_f32 = out_f32;
  a.add_res = add_res;
  a.eps = eps;
  for (int p = 0; p < P; ++p) {
    a.ph[p] = phases[p];
    // at most one work item per CTA where the tiles allow: the grid is
    // persistent, so a second round for a few items would cost a whole one
    const int ntiles = (phases[p].N + GV_TILE_N - 1) / GV_TILE_N;
    const int target = max(1, grid / ntiles) * ntiles;
    const GemvSplit sp = gemv_split(phases[p].K, phases[p].N, phases[p].p4 != 0, target);
    a.ph[p].ntiles = sp.ntiles;
    a.ph[p].ksplit = sp.ksplit;
    a.ph[p].upc = sp.upc;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(chain_kernel_for(B), dim3(grid),
                                    dim3(GV_THREADS), args, 0,
                                    reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the grid the launch uses for B rows: CTAs per SM that can be resident,
// times SMs (-1 on an error)
extern "C" int qmm_chain_grid(int B) {
  int grid = 0;
  return chain_grid(B, &grid) == cudaSuccess ? grid : -1;
}
