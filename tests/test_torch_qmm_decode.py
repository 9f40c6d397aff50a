"""The decode GEMV's arithmetic (csrc/qmm_decode.cuh, K1/K2/K7 at B <= 16),
written out in plain torch and numpy in the order and with the bit tricks
the kernel uses, and its launch plan.

The kernel takes q - zp as an exact bf16 integer and x as bf16, multiplies
them on the tensor cores with f32 accumulation over one quant group (P_g),
and folds each group into the f32 result as acc += s[g] * P_g, then
acc -= m[g] * xsum_g with xsum_g the f32 group sum of the bf16 x. Nothing
is rounded to bf16 on the way. Held here, on seeded numpy planes of every
type the kernel takes (Q4_K, Q4_0 with zero point 8, Q6_K with gs 16,
Q8_0, i8 with mins, Q2_K and Q3_K as nibble planes at gs 16, Q3_K with zero
point 4; bf16 and f32 scales), at B in {1, 3, 8, 16} and at
one K = 14336:
  * against qmm_plain, the function the card's checks hold the kernel to,
    at the card's 1e-3 of max|y| (the two orders differ by ~1e-6 of it);
  * against llm_tpu's qmm_pallas in interpret mode at the reference's own
    tolerances: 2e-4 of max|y| in f32, 2e-2 in its bf16 mode
    (tests/test_pallas_qmm.py:64,131).
The byte tricks that make the integer operands are checked over every byte
and every zero point in use, and decode_plan (the cluster size that splits
K) over every LLAMA3_8B decode shape and the ragged test shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.ops.pallas_qmm import pack_p4_kmajor as jax_pack_p4_kmajor
from llm_tpu.ops.pallas_qmm import qmm_pallas

from llm_tpu_torch.device import full_f32
from llm_tpu_torch.gguf.constants import GGMLType
from llm_tpu_torch.ops import qmatmul
from llm_tpu_torch.ops.cuda_qmm import (DECODE_MAX_CLUSTER, DECODE_TILE_N, DECODE_UNIT_K,
                                        decode_plan, qmm_plain, unpack_planes)
from llm_tpu_torch.quant.qtensor import QTensor

CASES = [  # name, layout, zp, gs, mins, N, K
    ("Q4_K", "p4", 0, 32, True, 256, 512),
    ("Q4_0", "p4", 8, 32, False, 264, 512),     # N not a multiple of 16: the gathered path
    ("Q6_K", "i8", 0, 16, False, 256, 512),
    ("Q8_0", "i8", 0, 32, False, 200, 320),     # K % 128 == 64: a half stage
    ("i8_mins", "i8", 0, 32, True, 128, 256),
    ("Q4_K_down", "p4", 0, 32, True, 128, 14336),
    ("Q2_K", "p4", 0, 16, True, 256, 512),      # nibble planes at gs 16, with mins
    ("Q3_K", "p4", 4, 16, False, 264, 512),     # gs 16, zero point 4, the gathered path
    ("TQ2_0", "p4", 1, 256, False, 256, 512),   # gs 256, zero point 1: a fold every 32 k
    ("IQ1_M", "i8", 0, 8, False, 256, 512),     # gs 8: two groups a 16-k step
]
ROWS = [1, 3, 8, 16]
CARD_REL_TOL = 1e-3  # chip_smoke.py::check_qmm, tests/test_torch_cuda.py
H100_SMS = 132


def _planes(layout, zp, gs, mins, N, K, B, scales_dtype, seed=0):
    rng = np.random.default_rng(seed)
    if layout == "p4":
        q = rng.integers(0, 16, size=(K, N)).astype(np.int16) - zp
        qs = jax_pack_p4_kmajor(q, zp, 256)
    else:
        qs = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
    scales = ((rng.random((K // gs, N)) + 0.5) * 0.01).astype(np.float32)
    m = (rng.random((K // gs, N)) * 0.05).astype(np.float32) if mins else None
    x = rng.normal(size=(B, K)).astype(np.float32)
    sc = torch.from_numpy(scales).to(scales_dtype)
    mn = None if m is None else torch.from_numpy(m).to(scales_dtype)
    qt = QTensor(torch.from_numpy(qs), sc, mn, gs, GGMLType.Q4_K, layout, zp)
    return x, qs, qt


def decode_order(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The kernel's arithmetic: per group g, P_g = x_g . (q - zp)_g in f32
    (bf16-exact operands), then acc = s[g] * P_g + acc and, with mins,
    acc = -m[g] * xsum_g + acc, group after group, in f32. At group size
    256 the fold is every 32 k, each with its group's s and m."""
    xr = x.to(torch.bfloat16).float()
    q = unpack_planes(qt).float()
    assert torch.equal(q.to(torch.bfloat16).float(), q)  # q - zp exact in bf16
    K, N = q.shape
    gs, B = min(qt.group_size, 32), xr.shape[0]
    G = K // gs
    rep = qt.group_size // gs
    s = qt.scales.float().repeat_interleave(rep, 0)
    m = None if qt.mins is None else qt.mins.float().repeat_interleave(rep, 0)
    with full_f32():
        xg = xr.reshape(B, G, gs).transpose(0, 1)            # [G, B, gs]
        p = torch.bmm(xg, q.reshape(G, gs, N))              # [G, B, N]
        xsum = xg.sum(-1)                                   # [G, B]
        acc = torch.zeros((B, N))
        for g in range(G):
            acc = s[g] * p[g] + acc
            if m is not None:
                acc = -m[g] * xsum[g][:, None] + acc
    return acc


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("scales_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,layout,zp,gs,mins,N,K", CASES, ids=[c[0] for c in CASES])
def test_decode_order_matches_plain(name, layout, zp, gs, mins, N, K, scales_dtype, B):
    x, _, qt = _planes(layout, zp, gs, mins, N, K, B, scales_dtype)
    xt = torch.from_numpy(x)
    got = decode_order(xt, qt)
    want = qmm_plain(xt, qt, torch.bfloat16)
    assert got.shape == want.shape == (B, N)
    assert _rel(got, want) <= CARD_REL_TOL
    assert _rel(got, want) <= 1e-5  # the same sum in another order


@pytest.mark.parametrize("cdtype,tol", [("f32", 2e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("name,layout,zp,gs,mins,N,K", CASES, ids=[c[0] for c in CASES])
def test_decode_order_matches_pallas(name, layout, zp, gs, mins, N, K, B, cdtype, tol):
    """Against the TPU kernel in interpret mode on the same planes (f32
    scales and mins, so both see one weight) and on x rounded to bf16, as
    the kernel takes it."""
    x, qs, qt = _planes(layout, zp, gs, mins, N, K, B, torch.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    f32 = (lambda t: None if t is None else jnp.asarray(t.float().numpy()))
    want = np.asarray(qmm_pallas(
        jnp.asarray(xb.numpy()), jnp.asarray(qs), f32(qt.scales), f32(qt.mins), gs=gs, zp=zp,
        layout=layout, tile_n=128, tile_k=256 if K % 256 == 0 else 64, interpret=True,
        compute_dtype=jnp.float32 if cdtype == "f32" else jnp.bfloat16))
    got = decode_order(xb, qt).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < tol


def _bf16_bits_to_f32(h: np.ndarray) -> np.ndarray:
    return (h.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16_rn(f: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, round to nearest even (cvt.rn.bf16x2.f32)."""
    return torch.from_numpy(np.ascontiguousarray(f, np.float32)).to(torch.bfloat16) \
        .view(torch.int16).numpy().astype(np.uint16)


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= (((both >> np.uint64(8 * src)) & np.uint64(0xFF)).astype(np.uint32) << (8 * i))
    return out


@pytest.mark.parametrize("by", [0, 1, 2, 3])
@pytest.mark.parametrize("zp", [0, 8, 4])  # Q4_K / Q4_1 / Q2_K, Q4_0, Q3_K
def test_p4_byte_trick_is_exact(zp, by):
    """Two plane rows' bytes of one column (byte `by` of their words) ->
    byte_perm -> (p & 0x000F000F) | 0x43004300 and the same of p >> 4 ->
    bf16 pairs 128 + nibble -> minus the bf16 pair 128 + zp: (low, high)
    halves are exactly (q_k - zp, q_k+1 - zp) of the low nibbles, and of the
    high nibbles, for every pair of bytes."""
    a, b = np.meshgrid(np.arange(256, dtype=np.uint32), np.arange(256, dtype=np.uint32))
    a, b = a.ravel(), b.ravel()
    fill = np.uint32(0xA5A5A5A5)  # the word's other bytes must not leak in
    keep = np.uint32(0xFF) << np.uint32(8 * by)
    wk = (fill & ~keep) | (a << np.uint32(8 * by))
    wk1 = (fill & ~keep) | (b << np.uint32(8 * by))
    sel = by | ((4 + by) << 8) | (by << 4) | ((4 + by) << 12)
    p = _byte_perm(wk, wk1, sel)
    zb = np.uint32(0x4300 | zp)
    for word, want_k, want_k1 in (((p & 0x000F000F) | 0x43004300, a & 15, b & 15),
                                  (((p >> 4) & 0x000F000F) | 0x43004300, a >> 4, b >> 4)):
        lo = _bf16_bits_to_f32((word & 0xFFFF).astype(np.uint16))
        hi = _bf16_bits_to_f32((word >> 16).astype(np.uint16))
        z = _bf16_bits_to_f32(np.array([zb], np.uint16))
        # the bf16x2 subtract: exact difference, rounded to bf16 (no-op here)
        dlo = _bf16_bits_to_f32(_f32_to_bf16_rn(lo - z))
        dhi = _bf16_bits_to_f32(_f32_to_bf16_rn(hi - z))
        assert np.array_equal(dlo, want_k.astype(np.float32) - zp)
        assert np.array_equal(dhi, want_k1.astype(np.float32) - zp)


@pytest.mark.parametrize("zp", [0, 3])  # Q8_0 / Q6_K, and the i8 zero point of the tests
def test_i8_byte_trick_is_exact(zp):
    """int8 byte (sign bit flipped) -> f32 2^23 + byte by byte_perm -> minus
    2^23 + 128 + zp -> cvt.rn bf16: exactly q - zp for every byte."""
    q = np.arange(-128, 128, dtype=np.int32)
    word = (q.astype(np.int8).view(np.uint8).astype(np.uint32) ^ 0x80) | 0x4B000000
    f = word.view(np.float32) - np.float32(8388608.0 + 128.0 + zp)
    got = _bf16_bits_to_f32(_f32_to_bf16_rn(f))
    assert np.array_equal(got, (q - zp).astype(np.float32))


# every matmul shape of the LLAMA3_8B Q4_K_M decode path (name, K, N)
DECODE_SHAPES = (("qkv", 4096, 6144), ("attn_q/o_proj", 4096, 4096),
                 ("attn_k/attn_v", 4096, 1024), ("gate_up", 4096, 28672),
                 ("down", 14336, 4096), ("lm_head", 4096, 128256))
RAGGED_SHAPES = (("ragged", 512, 264), ("ragged_tile", 1024, 1000), ("short_k", 64, 200),
                 ("half_stage", 320, 200))


@pytest.mark.parametrize("layout", ["p4", "i8"])
@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("name,K,N", DECODE_SHAPES + RAGGED_SHAPES,
                         ids=[s[0] for s in DECODE_SHAPES + RAGGED_SHAPES])
def test_decode_plan_is_valid(name, K, N, B, layout):
    """A 128-column tile and a cluster of 1..16 CTAs; each CTA gets the same
    number of 128-k stages (the last may get fewer), at least one, and the
    cluster covers every stage of K once."""
    tile, cluster = decode_plan(K, N, B, H100_SMS, layout)
    units = -(-K // DECODE_UNIT_K)
    per = -(-units // cluster)
    assert tile == DECODE_TILE_N
    assert 1 <= cluster <= min(DECODE_MAX_CLUSTER, units)
    assert (cluster - 1) * per < units <= cluster * per


# tools/gemm_splits.py --B 1,8,16 on an NVIDIA H100 80GB HBM3 (700.00 W, 132
# SMs): µs of the decode GEMV at each cluster size (PERF.md §6, PR 8),
# (name, K, N, layout, B) -> {cluster: µs}; what decode_plan's rule is
# fitted to
SWEEP_US = {
    ("qkv", 4096, 6144, "p4", 1):
        {1: 19.4, 2: 12.9, 3: 14.3, 4: 12.2, 5: 14.1, 6: 13.3, 8: 15.7, 16: 20.5},
    ("attn_q/o_proj", 4096, 4096, "p4", 1):
        {1: 19.5, 2: 13.0, 3: 10.7, 4: 11.8, 5: 11.5, 6: 10.6, 8: 10.8, 16: 14.5},
    ("attn_k", 4096, 1024, "p4", 1):
        {1: 19.4, 2: 12.6, 3: 10.1, 4: 8.6, 5: 8.2, 6: 7.7, 8: 6.5, 16: 7.0},
    ("attn_v Q6_K", 4096, 1024, "i8", 1):
        {1: 21.1, 2: 13.6, 3: 11.1, 4: 9.4, 5: 9.2, 6: 8.7, 8: 7.8, 16: 8.6},
    ("gate_up", 4096, 28672, "p4", 1):
        {1: 31.9, 2: 41.2, 3: 38.3, 4: 39.6, 5: 43.4, 6: 44.1, 8: 49.0, 16: 78.2},
    ("down", 14336, 4096, "p4", 1):
        {1: 61.1, 2: 33.8, 3: 24.8, 4: 28.1, 5: 24.7,
         6: 21.7, 8: 22.3, 9: 21.8, 12: 25.4, 16: 25.1},
    ("down Q6_K", 14336, 4096, "i8", 1):
        {1: 65.7, 2: 36.7, 3: 28.6, 4: 32.0, 5: 30.8,
         6: 30.9, 8: 39.5, 9: 37.2, 12: 36.3, 16: 38.4},
    ("lm_head Q6_K", 4096, 128256, "i8", 1):
        {1: 208.2, 2: 218.0, 3: 229.8, 4: 229.8, 5: 255.5, 6: 269.6, 8: 280.4, 16: 463.1},
    ("qkv", 4096, 6144, "p4", 8):
        {1: 20.0, 2: 14.0, 3: 15.1, 4: 12.5, 5: 15.5, 6: 13.8, 8: 15.9, 16: 21.6},
    ("attn_q/o_proj", 4096, 4096, "p4", 8):
        {1: 20.3, 2: 13.8, 3: 11.4, 4: 12.1, 5: 12.2, 6: 11.5, 8: 11.1, 16: 16.7},
    ("attn_k", 4096, 1024, "p4", 8):
        {1: 20.2, 2: 13.5, 3: 10.9, 4: 8.9, 5: 8.9, 6: 8.4, 8: 6.7, 16: 7.4},
    ("attn_v Q6_K", 4096, 1024, "i8", 8):
        {1: 21.9, 2: 14.7, 3: 12.1, 4: 9.9, 5: 9.7, 6: 9.5, 8: 8.0, 16: 9.3},
    ("gate_up", 4096, 28672, "p4", 8):
        {1: 32.7, 2: 44.0, 3: 39.8, 4: 42.4, 5: 47.3, 6: 47.8, 8: 50.9, 16: 81.7},
    ("down", 14336, 4096, "p4", 8):
        {1: 61.9, 2: 34.7, 3: 25.5, 4: 28.6, 5: 25.4,
         6: 22.4, 8: 22.7, 9: 22.3, 12: 25.3, 16: 25.5},
    ("down Q6_K", 14336, 4096, "i8", 8):
        {1: 66.2, 2: 37.8, 3: 30.0, 4: 33.1, 5: 31.8,
         6: 31.1, 8: 40.3, 9: 38.5, 12: 37.7, 16: 40.1},
    ("lm_head Q6_K", 4096, 128256, "i8", 8):
        {1: 214.6, 2: 228.2, 3: 240.0, 4: 237.3, 5: 267.7, 6: 288.5, 8: 289.8, 16: 499.6},
    ("qkv", 4096, 6144, "p4", 16):
        {1: 23.5, 2: 16.1, 3: 18.3, 4: 14.9, 5: 21.5, 6: 20.8, 8: 20.8, 16: 29.2},
    ("attn_q/o_proj", 4096, 4096, "p4", 16):
        {1: 23.7, 2: 16.1, 3: 13.4, 4: 14.5, 5: 14.7, 6: 13.6, 8: 17.1, 16: 22.3},
    ("attn_k", 4096, 1024, "p4", 16):
        {1: 24.7, 2: 16.0, 3: 13.2, 4: 10.6, 5: 10.3, 6: 9.7, 8: 7.9, 16: 8.9},
    ("attn_v Q6_K", 4096, 1024, "i8", 16):
        {1: 25.7, 2: 17.4, 3: 14.6, 4: 11.5, 5: 11.6, 6: 11.0, 8: 9.2, 16: 10.4},
    ("gate_up", 4096, 28672, "p4", 16):
        {1: 37.9, 2: 46.8, 3: 54.7, 4: 54.9, 5: 64.8, 6: 70.5, 8: 74.9, 16: 121.6},
    ("down", 14336, 4096, "p4", 16):
        {1: 70.9, 2: 40.0, 3: 29.5, 4: 34.1, 5: 30.2,
         6: 26.4, 8: 31.7, 9: 32.2, 12: 35.0, 16: 33.5},
    ("down Q6_K", 14336, 4096, "i8", 16):
        {1: 78.3, 2: 44.7, 3: 33.7, 4: 39.2, 5: 35.0,
         6: 33.8, 8: 45.4, 9: 45.4, 12: 42.3, 16: 45.9},
    ("lm_head Q6_K", 4096, 128256, "i8", 16):
        {1: 221.8, 2: 243.5, 3: 263.8, 4: 261.6, 5: 302.7, 6: 332.2, 8: 332.8, 16: 558.0},
}
PICK_SLACK = 1.05


@pytest.mark.parametrize("shape", list(SWEEP_US), ids=[f"{s[0]}-B{s[4]}" for s in SWEEP_US])
def test_decode_plan_picks_a_fastest_measured_cluster(shape):
    """At each main-path decode shape, B = 1, 8 and 16, decode_plan's pick
    was timed, and within 5% of the fastest cluster size timed there."""
    name, K, N, layout, B = shape
    us = SWEEP_US[shape]
    _, pick = decode_plan(K, N, B, H100_SMS, layout)
    assert pick in us
    assert us[pick] <= PICK_SLACK * min(us.values())


@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16],
                         ids=["none", "f32", "bf16"])
def test_qmm_out_dtype_on_the_cpu(out_dtype):
    """qmm passes out_dtype down; on the CPU the f32 result is cast once,
    as before."""
    x, _, qt = _planes("p4", 0, 32, True, 256, 512, 3, torch.bfloat16)
    xt = torch.from_numpy(x)
    got = qmatmul.qmm(xt, qt, out_dtype=out_dtype)
    want = qmm_plain(xt, qt, torch.bfloat16)
    assert got.dtype == (out_dtype or torch.float32)
    assert torch.equal(got, want.to(got.dtype))
