"""The prefill GEMM's arithmetic (csrc/qmm_gemm.cuh, K1/K2/K7 at B > 16),
written out in plain torch in the order the kernel uses, and its launch
plan.

The kernel folds the mins into the weight, w' = (q - zp) * s - m in f32,
splits w' into bf16 hi = bf16(w') and lo = bf16(w' - hi), and sums
x @ hi + x @ lo in f32 on the tensor cores, x rounded to bf16. Held here,
on seeded numpy planes of every type the kernel takes (Q4_K, Q4_0, Q6_K,
Q8_0, i8 with mins, i8 with a zero point, Q2_K and Q3_K as nibble planes at
gs 16; bf16 and f32 scales):
  * against qmm_plain, the function the card's checks hold the kernel to
    (1e-3 of max|y| there), at 1e-5 of max|y|: hi + lo keeps 16 bits of
    w' (2^-16 = 1.5e-5 of a weight at worst, 2.9e-6 of max|y| measured
    here with f32 scales, 1.2e-6 with bf16 ones), and the two sum in
    another order;
  * against llm_tpu's qmm_pallas in interpret mode: at 2e-4 of max|y| when
    the TPU kernel computes in f32 on the same bf16-rounded x (its own f32
    tolerance, test_pallas_qmm.py), and at 2e-2 in its bf16 mode, which
    rounds w' to bf16 once;
  * the single bf16 rounding (hi alone, the TPU kernel's order) misses the
    card's 1e-3 * max|y| at a main-path shape (1.4e-3 to 1.6e-3 here),
    where hi + lo stays under 1e-6: the reason for the split.
gemm_split, the wrapper's choice of K split, is a pure function of (B, N,
K, SM count): a valid split everywhere, and at each main-path shape it
picks a split that timed within 3% of the fastest on an H100."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.ops.pallas_qmm import pack_p4_kmajor as jax_pack_p4_kmajor
from llm_tpu.ops.pallas_qmm import qmm_pallas

from llm_tpu_torch.device import full_f32
from llm_tpu_torch.gguf.constants import GGMLType
from llm_tpu_torch.models.synthetic import device_synthetic_qtensor
from llm_tpu_torch.ops.cuda_qmm import (GEMM_MAX_SPLIT, GEMM_UNIT_K, gemm_split, qmm_plain,
                                        unpack_planes)
from llm_tpu_torch.quant.qtensor import QTensor

CASES = [  # name, layout, zp, gs, mins, N, K
    ("Q4_K", "p4", 0, 32, True, 256, 512),
    ("Q4_0", "p4", 8, 32, False, 264, 512),    # N not a multiple of 16: the gathered path
    ("Q6_K", "i8", 0, 16, False, 256, 512),
    ("Q8_0", "i8", 0, 32, False, 200, 320),    # K % 128 == 64: a half stage
    ("i8_mins", "i8", 0, 32, True, 128, 256),
    ("i8_zp", "i8", 3, 32, False, 128, 256),
    ("Q2_K", "p4", 0, 16, True, 256, 512),     # nibble planes at gs 16, with mins
    ("Q3_K", "p4", 4, 16, False, 264, 512),    # gs 16, zero point 4, the gathered path
    ("TQ2_0", "p4", 1, 256, False, 256, 512),  # gs 256, zero point 1
    ("IQ1_M", "i8", 0, 8, False, 264, 512),    # gs 8, the gathered path
]
B = 33
PLAIN_REL_TOL = 1e-5
CARD_REL_TOL = 1e-3  # chip_smoke.py::check_qmm, tests/test_torch_cuda.py
H100_SMS = 132


def _planes(layout, zp, gs, mins, N, K, scales_dtype, seed=0):
    rng = np.random.default_rng(seed)
    if layout == "p4":
        q = rng.integers(0, 16, size=(K, N)).astype(np.int16) - zp
        qs = jax_pack_p4_kmajor(q, zp, 256)
    else:
        qs = rng.integers(-32, 32, size=(K, N)).astype(np.int8)
    scales = ((rng.random((K // gs, N)) + 0.5) * 0.01).astype(np.float32)
    m = (rng.random((K // gs, N)) * 0.05).astype(np.float32) if mins else None
    x = rng.normal(size=(B, K)).astype(np.float32)
    # the planes' scales as the kernel reads them (bf16 ones rounded once)
    sc = torch.from_numpy(scales).to(scales_dtype)
    mn = None if m is None else torch.from_numpy(m).to(scales_dtype)
    qt = QTensor(torch.from_numpy(qs), sc, mn, gs, GGMLType.Q4_K, layout, zp)
    return x, qs, qt


def folded_weight(qt: QTensor) -> torch.Tensor:
    """w' = (q - zp) * s - m in f32, [K, N]: the mins folded into the weight
    (sum_g xsum[b,g] m[g,n] = sum_k x[b,k] m[k/gs,n])."""
    q = unpack_planes(qt).float()
    K, N = q.shape
    gs = qt.group_size
    w = q.reshape(K // gs, gs, N) * qt.scales.float()[:, None, :]
    if qt.mins is not None:
        w = w - qt.mins.float()[:, None, :]
    return w.reshape(K, N)


def gemm_order(x: torch.Tensor, qt: QTensor, lo: bool = True) -> torch.Tensor:
    """The kernel's arithmetic: x rounded to bf16; hi = bf16(w'), lo =
    bf16(w' - hi); y = x @ hi + x @ lo in f32. lo=False keeps hi alone."""
    xr = x.to(torch.bfloat16).float()
    w = folded_weight(qt)
    hi = w.to(torch.bfloat16).float()
    with full_f32():
        y = xr @ hi
        if lo:
            y = y + xr @ (w - hi).to(torch.bfloat16).float()
    return y


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("scales_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,layout,zp,gs,mins,N,K", CASES, ids=[c[0] for c in CASES])
def test_gemm_order_matches_plain(name, layout, zp, gs, mins, N, K, scales_dtype):
    x, _, qt = _planes(layout, zp, gs, mins, N, K, scales_dtype)
    xt = torch.from_numpy(x)
    got = gemm_order(xt, qt)
    want = qmm_plain(xt, qt, torch.bfloat16)
    assert got.shape == want.shape == (B, N)
    assert _rel(got, want) <= PLAIN_REL_TOL


@pytest.mark.parametrize("cdtype,tol", [("f32", 2e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("scales_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,layout,zp,gs,mins,N,K", CASES, ids=[c[0] for c in CASES])
def test_gemm_order_matches_pallas(name, layout, zp, gs, mins, N, K, scales_dtype, cdtype, tol):
    """Against the TPU kernel in interpret mode on the same planes (its
    scales and mins are the f32 values of the port's, so both see one
    weight) and on x rounded to bf16, as the kernel takes it."""
    x, qs, qt = _planes(layout, zp, gs, mins, N, K, scales_dtype)
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    f32 = (lambda t: None if t is None else jnp.asarray(t.float().numpy()))
    want = np.asarray(qmm_pallas(
        jnp.asarray(xb.numpy()), jnp.asarray(qs), f32(qt.scales), f32(qt.mins), gs=gs, zp=zp,
        layout=layout, tile_n=128, tile_k=256 if K % 256 == 0 else 64, interpret=True,
        compute_dtype=jnp.float32 if cdtype == "f32" else jnp.bfloat16))
    got = gemm_order(xb, qt).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < tol


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_single_rounding_misses_the_card_tolerance(qtype):
    """At attn_k's shape (K = 4096, N = 1024) on the port's synthetic planes:
    one bf16 rounding of w' (the TPU kernel's order) errs by more than the
    card's 1e-3 * max|y| against qmm_plain; hi + lo stays under 1e-6."""
    gen = torch.Generator().manual_seed(11)
    qt = device_synthetic_qtensor(gen, 1024, 4096, qtype)
    x = torch.randn((64, 4096), generator=gen).to(torch.bfloat16)
    want = qmm_plain(x, qt, torch.bfloat16)
    assert _rel(gemm_order(x, qt), want) <= 1e-6
    assert _rel(gemm_order(x, qt, lo=False), want) > CARD_REL_TOL


# every matmul shape of the LLAMA3_8B Q4_K_M main path (name, K, N)
MAIN_PATH = (("qkv", 4096, 6144), ("attn_q/o_proj", 4096, 4096), ("attn_k/attn_v", 4096, 1024),
             ("gate_up", 4096, 28672), ("down", 14336, 4096))


# tools/gemm_splits.py on an NVIDIA H100 80GB HBM3 (700.00 W, 132 SMs): µs
# of the prefill GEMM at each K split, the mean of two sweeps (split 5 at
# qkv B=128 from the second alone; PERF.md §6), name, K, N, B -> {split: µs}.
# The sweeps differ by 0.7% at the median split, by up to 5.4% at one.
SWEEP_US = {
    ("qkv", 4096, 6144, 512): {1: 103.1, 2: 113.9, 4: 95.0, 8: 109.4, 16: 134.2, 32: 178.5},
    ("attn_q/o_proj", 4096, 4096, 512): {1: 100.6, 2: 60.1, 4: 65.2, 8: 74.8, 16: 93.8,
                                         32: 127.7},
    ("attn_k", 4096, 1024, 512): {1: 100.4, 2: 55.6, 4: 32.7, 8: 23.3, 16: 29.8, 32: 39.9},
    ("attn_v", 4096, 1024, 512): {1: 108.2, 2: 59.7, 4: 34.5, 8: 24.2, 16: 30.6, 32: 41.0},
    ("gate_up", 4096, 28672, 512): {1: 398.3, 2: 399.6, 4: 418.3, 8: 474.8, 16: 562.8,
                                    32: 813.1},
    ("down", 14336, 4096, 512): {1: 339.2, 2: 180.4, 4: 185.7, 8: 194.8, 16: 212.7, 32: 241.1},
    ("down_q6k", 14336, 4096, 512): {1: 368.0, 2: 193.4, 4: 200.9, 8: 209.5, 16: 230.2,
                                     32: 258.4},
    ("qkv", 4096, 6144, 128): {1: 102.4, 2: 56.7, 4: 35.1, 5: 30.3, 8: 40.2, 16: 41.6, 32: 56.4},
    ("attn_q/o_proj", 4096, 4096, 128): {1: 100.6, 2: 56.0, 4: 33.2, 8: 24.3, 16: 30.1,
                                         32: 39.6},
    ("attn_k", 4096, 1024, 128): {1: 99.6, 2: 55.0, 4: 31.5, 8: 20.7, 16: 15.7, 32: 15.5},
    ("attn_v", 4096, 1024, 128): {1: 107.8, 2: 59.1, 4: 33.7, 8: 22.1, 16: 16.6, 32: 16.8},
    ("gate_up", 4096, 28672, 128): {1: 102.1, 2: 116.1, 4: 125.5, 8: 127.4, 16: 155.5,
                                    32: 218.8},
    ("down", 14336, 4096, 128): {1: 339.1, 2: 175.6, 4: 92.5, 8: 54.0, 16: 60.2, 32: 74.6},
    ("down_q6k", 14336, 4096, 128): {1: 363.5, 2: 188.2, 4: 99.3, 8: 57.8, 16: 64.0, 32: 78.9},
}
PICK_SLACK = 1.03


@pytest.mark.parametrize("shape", list(SWEEP_US), ids=[f"{s[0]}-B{s[3]}" for s in SWEEP_US])
def test_gemm_split_picks_a_fastest_measured_split(shape):
    """At each main-path shape, B = 512 and 128, gemm_split's pick was
    timed, and within 3% of the fastest split timed there."""
    name, K, N, Bx = shape
    us = SWEEP_US[shape]
    pick = gemm_split(Bx, N, K, H100_SMS)
    assert pick in us
    assert us[pick] <= PICK_SLACK * min(us.values())


@pytest.mark.parametrize("Bx", [17, 40, 128, 129, 300, 512])
@pytest.mark.parametrize("name,K,N", MAIN_PATH + (("ragged", 64, 200), ("lm_head", 4096, 128256)),
                         ids=[m[0] for m in MAIN_PATH] + ["ragged", "lm_head"])
def test_gemm_split_is_valid(name, K, N, Bx):
    """1 <= split <= the stages of K (every item has K to do) and at most
    GEMM_MAX_SPLIT."""
    split = gemm_split(Bx, N, K, H100_SMS)
    assert 1 <= split <= min(-(-K // GEMM_UNIT_K), GEMM_MAX_SPLIT)
