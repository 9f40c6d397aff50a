// Hopper (sm_90a) building blocks shared by the port's warp-specialized
// kernels (the prefill GEMM, qmm_gemm.cuh; flash prefill, flash_prefill.cuh;
// the decode GEMV, qmm_decode.cuh; flash decode, flash_attn.cu): mbarriers,
// TMA tile loads, wgmma fences and the K-major swizzled operand descriptor,
// the 128-byte swizzle's offsets, mma.sync and ldmatrix, the cluster barrier
// and distributed shared memory loads, the exact byte-to-float trick and the
// bf16 hi/lo split, and the host side's tensor-map encoding.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// orders this thread's generic-proxy accesses of shared memory (ld.shared,
// ldmatrix, st.shared) before later async-proxy ones (TMA, wgmma): a
// consumer runs it in every lane before its warp gives a ring slot that it
// read back to the producer, whose next TMA refills the slot; a producer
// runs it after writing a slot that wgmma will read
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// descriptor of a K-major bf16 operand in the 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// byte offset of (row r, byte c) in a 128-byte-swizzled tile of 128-byte rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// d += a (16x16 bf16, registers) x b (16x8 bf16), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory, transposed: lane i gives a row
// address of matrix i / 8, and each thread receives a column pair
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 2^x (the softmax's exponent, in log2 units)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float ld_dsmem(uint32_t local, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// the integer (q - zp) of byte i of v as an f32: 2^23 + byte, minus base
// (2^23 + zp for nibbles; 2^23 + 128 + zp for int8 bytes with their sign
// bit flipped), exact
__device__ __forceinline__ float q_of(uint32_t v, int i, float base) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540 | i)) - base;
}

// two weights of consecutive k -> bf16x2 hi and lo (the lower k in the low
// half), hi + lo = w to 16 bits
__device__ __forceinline__ void split_hilo(float w0, float w1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(w0, w1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  __nv_bfloat162 l = __floats2bfloat162_rn(w0 - __uint_as_float(hi << 16),
                                           w1 - __uint_as_float(hi & 0xFFFF0000u));
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// ----------------------------------------------------------------------------
// host side: the SM count and tensor maps

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}


typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), found through the runtime's
// entry-point query (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes of make_map (beside cudaError_t's)
// the quantized matmuls' nibble planes at group size 32 (G16 false) or 16
// (G16: Q2_K, Q3_K): a 64-k chunk of x spans CG groups of GS rows (int8
// planes take gs 16 or 32 at run time; group size 256 and int8 planes at 8
// are forms of their own, GX in qmm_decode.cuh and qmm_gemm.cuh)
template <bool G16>
struct P4Groups {
  static constexpr int CG = G16 ? 4 : 2;    // group rows of one x chunk
  static constexpr int GS = G16 ? 16 : 32;  // the group size
};

constexpr int TMAP_ERR_NO_ENCODER = 9001, TMAP_ERR_ENCODE = 9002;

// a 2-D or 3-D tiled map; dims and box innermost first, strides in bytes
inline int make_map(CUtensorMap* m, CUtensorMapDataType dt, int rank, const void* base,
                    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                    CUtensorMapSwizzle swz) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return TMAP_ERR_NO_ENCODER;
  const cuuint32_t es[3] = {1, 1, 1};
  const CUresult r = fn(m, dt, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERR_ENCODE;
}

}  // namespace
