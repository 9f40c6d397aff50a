// The body of the prefill GEMM's kernels (qmm_gemm.cuh: qmm_wgmma, and
// qmm_wgmma_g16 on nibble planes at group size 16, qmm_wgmma_g256 at 256,
// qmm_wgmma_g8 on int8 planes at group size 8), included inside each of
// them after the constants P4, SBF16, MINS and G16 are in scope, and the
// macro GEMM_GX (the form of the last two; 0 when not defined). Written
// once and included, not called: as a force-inlined function (and with
// local constants in place of GemmSmem's) it moved two instructions of
// every qmm_wgmma kernel (tools/cubin_cmp.py read DIFF against the kernels
// as they were before the group-size-16 form was added). The forms' own
// geometry is read from GemmSmem (L::GFORM) likewise.
#ifndef GEMM_GX
#define GEMM_GX 0
#endif
  using L = GemmSmem<P4, SBF16, MINS, G16, GEMM_GX>;
#undef GEMM_GX
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t bars[8];  // full[0..3], empty[4..7]
  const uint32_t raw = smem_u32(dyn_smem);
  uint8_t* smem = dyn_smem + (((raw + 1023) & ~1023u) - raw);
  const uint32_t smem_a = smem_u32(smem);
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[4]);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full0 + 8 * s, a.tma_w ? 1 : GM_RAGGED_ARRIVALS);
      mbar_init(empty0 + 8 * s, GM_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= GM_CONSUMERS) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(GM_PRODUCER_REGS));
    if (threadIdx.x >= GM_CONSUMERS + 32) return;
    const int layer = a.lidx != nullptr ? __ldg(a.lidx) : 0;
    const uint8_t* qs = a.qs + (long long)layer * a.qs_ls;
    const void* sc = static_cast<const char*>(a.sc) + (long long)layer * a.s_ls;
    const void* mn =
        MINS ? static_cast<const void*>(static_cast<const char*>(a.mn) + (long long)layer * a.s_ls)
             : nullptr;
    const int g_box = (L::GFORM == 256 ? 1 : P4 ? L::CG : GM_UNIT_K / a.gs) * GM_TILE_N * L::ES;
    const uint32_t tx = 2 * L::X_CHUNK +
                        (a.tma_w ? 2 * L::W_HALF + (P4 && L::GFORM != 256 ? 2 : 1) * g_box *
                                                       (MINS ? 2 : 1)
                                 : 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
      const Item t = item_of(it, a);
      for (int u = t.u0; u < t.u1; ++u) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t st = smem_a + stage * L::STAGE, full = full0 + 8 * stage;
        uint8_t* stp = smem + stage * L::STAGE;
        // x chunks and plane rows of this unit (p4: the two chunks are the
        // low and high nibbles of the same 64 packed rows)
        const int kx0 = P4 ? 256 * (u >> 1) + 64 * (u & 1) : GM_UNIT_K * u;
        const int kx1 = kx0 + (P4 ? 128 : 64);
        const int row0 = P4 ? 128 * (u >> 1) + 64 * (u & 1) : GM_UNIT_K * u;
        if (lane == 0) {
          mbar_expect_tx(full, tx);
          tma_2d(st, &tmx, full, kx0, t.b0);
          tma_2d(st + L::X_CHUNK, &tmx, full, kx1, t.b0);
          if (a.tma_w) {
            tma_3d(st + L::W_OFF, &tmw, full, t.n0, row0, layer);
            tma_3d(st + L::W_OFF + L::W_HALF, &tmw, full, t.n0 + 128, row0, layer);
            if (L::GFORM == 256) {  // both chunks are in group kx0 / 256
              tma_3d(st + L::S_OFF, &tms, full, t.n0, kx0 / 256, layer);
              if (MINS) tma_3d(st + L::M_OFF, &tmm, full, t.n0, kx0 / 256, layer);
            } else if (P4) {
              tma_3d(st + L::S_OFF, &tms, full, t.n0, kx0 / L::GS, layer);
              tma_3d(st + L::S_OFF + g_box, &tms, full, t.n0, kx1 / L::GS, layer);
              if (MINS) {
                tma_3d(st + L::M_OFF, &tmm, full, t.n0, kx0 / L::GS, layer);
                tma_3d(st + L::M_OFF + g_box, &tmm, full, t.n0, kx1 / L::GS, layer);
              }
            } else {
              tma_3d(st + L::S_OFF, &tms, full, t.n0, kx0 / a.gs, layer);
              if (MINS) tma_3d(st + L::M_OFF, &tmm, full, t.n0, kx0 / a.gs, layer);
            }
          }
        }
        if (!a.tma_w) {
          gather_rows<P4>(stp + L::W_OFF, qs, lane, t.n0, row0, a);
          gather_groups<P4, SBF16, G16, L::GFORM>(stp + L::S_OFF, sc, lane, t.n0, kx0, kx1, a);
          if (MINS)
            gather_groups<P4, SBF16, G16, L::GFORM>(stp + L::M_OFF, mn, lane, t.n0, kx0, kx1, a);
          mbar_arrive(full);
        }
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(GM_CONSUMER_REGS));
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2, t4 = lane & 3;
  const float base = 8388608.f + (P4 ? 0.f : 128.f) + (float)a.zp;
  const int gshift = (!P4 && a.gs == 16) ? 0 : 1;  // i8: k16 steps per group, log2
  // this thread's four columns within the tile (slice j: 2 j and 2 j + 1)
  const int ncol = 128 * wg + 32 * warp + 4 * gid;
  const bool atomic_out = a.split > 1, quad_n = (a.N & 3) == 0;

  float acc[2][64];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
  uint32_t fh[2][2][4], fl[2][2][4];  // [k16 step parity][slice]: hi and lo fragments

  int stage = 0, pending = -1;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const Item t = item_of(it, a);
    for (int u = t.u0; u < t.u1; ++u) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint8_t* stp = smem + stage * L::STAGE;
      const uint8_t* wsm = stp + L::W_OFF + wg * L::W_HALF;
      const uint32_t xs = smem_a + stage * L::STAGE;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t rw[2][2];  // per slice: the byte words at k = 2 t4 and 2 t4 + 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (P4 ? h == 0 : true) {
            const int r = 16 * (P4 ? p : 2 * p + h) + 2 * t4;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int c = 32 * warp + 4 * gid + 2 * j;
              const uint32_t v0 = *reinterpret_cast<const uint16_t*>(wsm + swz(r, c));
              const uint32_t v1 = *reinterpret_cast<const uint16_t*>(wsm + swz(r + 1, c));
              const uint32_t v8 = *reinterpret_cast<const uint16_t*>(wsm + swz(r + 8, c));
              const uint32_t v9 = *reinterpret_cast<const uint16_t*>(wsm + swz(r + 9, c));
              rw[j][0] = __byte_perm(v0, v1, 0x5410);
              rw[j][1] = __byte_perm(v8, v9, 0x5410);
            }
          }
          const int chunk = P4 ? h : (2 * p + h) >> 2;
          const int kk = P4 ? p : (2 * p + h) & 3;
          // the group row (GX 256: the stage's one; GX 8: the step's first of two)
          const int grow = L::GFORM == 256 ? 0
                           : L::GFORM == 8 ? 2 * (2 * p + h)
                           : P4 ? L::CG * h + (G16 ? p : p >> 1) : (2 * p + h) >> gshift;
          const uint64_t desc = x_desc(xs + chunk * L::X_CHUNK + kk * 32);
          const int zero = (u == t.u0 && p == 0 && h == 0) ? 0 : 1;
          float sv[4], mv[4] = {0.f, 0.f, 0.f, 0.f};
          ld_quad<SBF16>(stp + L::S_OFF, grow * GM_TILE_N + ncol, sv);
          if (MINS) ld_quad<SBF16>(stp + L::M_OFF, grow * GM_TILE_N + ncol, mv);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // the set written here was last read GM_INFLIGHT + 1 groups ago
            if constexpr (L::GFORM == 8) {
              float s2[4], m2[4] = {0.f, 0.f, 0.f, 0.f};  // the step's second group
              ld_quad<SBF16>(stp + L::S_OFF, (grow + 1) * GM_TILE_N + ncol, s2);
              if (MINS) ld_quad<SBF16>(stp + L::M_OFF, (grow + 1) * GM_TILE_N + ncol, m2);
              dequant_g8<MINS>(rw[j][0], rw[j][1], base, sv[2 * j], sv[2 * j + 1], s2[2 * j],
                               s2[2 * j + 1], mv[2 * j], mv[2 * j + 1], m2[2 * j],
                               m2[2 * j + 1], fh[h][j], fl[h][j]);
            } else {
              dequant<P4, MINS>(rw[j][0], rw[j][1], P4 && h == 1, base, sv[2 * j],
                                sv[2 * j + 1], mv[2 * j], mv[2 * j + 1], fh[h][j], fl[h][j]);
            }
            wg_fence();
            wgmma_rs(acc[j], fh[h][j], desc, zero);
            wgmma_rs(acc[j], fl[h][j], desc, 1);
            wg_commit();
            wg_wait<GM_INFLIGHT>();
            if ((2 * p + h) * 2 + j == GM_INFLIGHT && pending >= 0) {
              // every matrix instruction that read the previous stage is done;
              // its planes and scales were read by ld.shared (generic proxy)
              fence_proxy_async();
              __syncwarp();
              if (lane == 0) mbar_arrive(empty0 + 8 * pending);
              pending = -1;
            }
          }
        }
      }
      pending = stage;
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * pending);
    pending = -1;

    // epilogue: slice j's d[4i + e] is (column n + 2 j, row b) and d[4i + 2 + e]
    // (n + 2 j + 1, b), with b = b0 + 8 i + 2 t4 + e
    const int n = t.n0 + ncol;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = t.b0 + 8 * i + 2 * t4 + e;
        if (b >= a.B) continue;
        float* yp = a.y + (size_t)b * a.N + n;
        const float4 v = make_float4(acc[0][4 * i + e], acc[0][4 * i + 2 + e],
                                     acc[1][4 * i + e], acc[1][4 * i + 2 + e]);
        if (quad_n && n + 3 < a.N) {
          if (atomic_out) atomicAdd(reinterpret_cast<float4*>(yp), v);
          else *reinterpret_cast<float4*>(yp) = v;
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n + c < a.N) {
              if (atomic_out) atomicAdd(yp + c, vs[c]);
              else yp[c] = vs[c];
            }
        }
      }
  }
