// S1: the decode GEMV's probes for Hopper (sm_90a).
//
// Replaces the TPU package's timing probes of the fused dequantize x matmul:
// scripts/kbench3.py:54 _probe1_kernel (stream the qs plane only) and
// scripts/kbench.py:56 / scripts/kbench3.py:89 _probe_kernel (mode "dma":
// stream every plane; mode "deq": stream and dequantize, no dot). Each is
// the GEMV loop of qmm_gemv.cuh (gemv_block: K1's decode GEMV when S1 was
// ported, later K5's and K6's; none of them runs it now) with its MODE
// set, on that loop's grid and split (gemv_split, one launch per 4 rows of
// x), so that the times of GV_QS, GV_DMA, GV_DEQ and the full loop split
// its time into streaming the packed nibbles, streaming everything it
// reads, dequantizing, and the product with x. Bound by the bytes each
// mode reads.
//
// Unlike the TPU probes, which sum a slice of each block whose rows depend
// on the tile, every byte a probe loads feeds its output, so the output is
// a function of the planes and x alone (qmm_gemv.cuh gives it per mode),
// one row for each kind of load, and is checked row by row against a plain
// version (ops/cuda_probe.py).

#include "qmm_gemv.cuh"

namespace {

template <int NB, bool MINS, int MODE>
__global__ void __launch_bounds__(GV_THREADS)
qmm_probe(const __nv_bfloat16* __restrict__ x, int B, int K,
          const uint8_t* __restrict__ qs, const void* __restrict__ sc,
          const void* __restrict__ mn, float* __restrict__ y, int N, int zp,
          int upc, int atomic_out) {
  __shared__ float xs[GV_STAGE];
  __shared__ float xsum[GV_STAGE / 16];
  const int n_units = K / 64;
  const int u0 = blockIdx.y * upc;
  gemv_block<NB, true, true, MINS, MODE>(Bf16Rows{x, K}, B, qs, sc, mn, y, N, 32, zp,
                                                 u0, min(upc, n_units - u0),
                                                 blockIdx.x * GV_TILE_N, atomic_out != 0, xs,
                                                 xsum);
}

template <bool MINS, int MODE>
void launch(int nb, dim3 grid, cudaStream_t st, const __nv_bfloat16* x, int B, int K,
            const uint8_t* qs, const void* sc, const void* mn, float* y, int N, int zp,
            int upc, int atomic_out) {
  if (nb == 1)
    qmm_probe<1, MINS, MODE><<<grid, GV_THREADS, 0, st>>>(x, B, K, qs, sc, mn, y, N, zp, upc,
                                                          atomic_out);
  else if (nb == 2)
    qmm_probe<2, MINS, MODE><<<grid, GV_THREADS, 0, st>>>(x, B, K, qs, sc, mn, y, N, zp, upc,
                                                          atomic_out);
  else
    qmm_probe<4, MINS, MODE><<<grid, GV_THREADS, 0, st>>>(x, B, K, qs, sc, mn, y, N, zp, upc,
                                                          atomic_out);
}

template <bool MINS, int MODE>
void run(cudaStream_t st, const __nv_bfloat16* x, int B, int K, const uint8_t* qs,
         const void* sc, const void* mn, float* y, int N, int zp) {
  // the loop's split (qmm_kernels.cuh run); launches for more than 4 rows
  // meet in y too
  const GemvSplit sp = gemv_split(K, N, true, 2 * sm_count());
  const int atomic_out = sp.ksplit > 1 || B > GV_MAX_NB;
  if (atomic_out) cudaMemsetAsync(y, 0, sizeof(float) * GV_PROBE_ROWS * (size_t)N, st);
  dim3 grid(sp.ntiles, sp.ksplit);
  for (int b0 = 0; b0 < B; b0 += GV_MAX_NB) {
    const int nb = min(GV_MAX_NB, B - b0);
    const int nbt = nb == 1 ? 1 : (nb == 2 ? 2 : 4);
    launch<MINS, MODE>(nbt, grid, st, x + (size_t)b0 * K, nb, K, qs, sc, mn, y, N, zp, sp.upc,
                       atomic_out);
  }
}

}  // namespace

// x bf16 [B, K] (B <= 16); qs uint8 [K/2, N] p4 planes (K % 256 == 0, gs
// 32); scales and mins [K/32, N] bf16 (mins may be null); y f32
// [GV_PROBE_ROWS, N], its rows as qmm_gemv.cuh gives them.
// mode: 1 GV_QS, 2 GV_DMA, 3 GV_DEQ. Requirements checked by the wrapper.
extern "C" int qmm_probe_launch(const void* x, const void* qs, const void* scales,
                                const void* mins, void* y, int B, int K, int N, int zp,
                                int mode, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const uint8_t* q = reinterpret_cast<const uint8_t*>(qs);
  float* yf = reinterpret_cast<float*>(y);
  const bool has_m = mins != nullptr;
#define PROBE_RUN(M, MODE) run<M, MODE>(st, xb, B, K, q, scales, mins, yf, N, zp)
  if (mode == GV_QS) { if (has_m) PROBE_RUN(true, GV_QS); else PROBE_RUN(false, GV_QS); }
  else if (mode == GV_DMA) { if (has_m) PROBE_RUN(true, GV_DMA); else PROBE_RUN(false, GV_DMA); }
  else if (mode == GV_DEQ) { if (has_m) PROBE_RUN(true, GV_DEQ); else PROBE_RUN(false, GV_DEQ); }
  else return (int)cudaErrorInvalidValue;
#undef PROBE_RUN
  return (int)cudaGetLastError();
}
