"""K5's arithmetic on the decode GEMV's CTA body (csrc/qmm_decode.cuh with
GDOT set), written out in plain torch in the order the kernel runs it, on
seeded numpy planes.

The kernel takes the raw nibble (0..15, no zero point) as an exact bf16
integer and x as bf16, multiplies them on the tensor cores with f32
accumulation over 16 k (mma.sync m16n8k16) and over the two 16-k steps of
a 32-group (P'_g), and folds each group into the f32 result as
acc += s[g] * P'_g with the unrounded s; then, with mins,
acc -= bf16(m[g]) * bf16(xsum_g), else acc -= zp * bf16(xsum_g) *
bf16(s[g]) (nothing at zp = 0), xsum_g the f32 sum of the bf16 x over the
group (a product with ones on the same tensor cores). Held here, for
Q4_K (mins), Q4_0 (zero point 8), a ragged N, bf16 and f32 scales, at B in
{1, 3, 8, 16} and at one K = 14336:
  * against qmm_gdot_plain, K5's plain version, at 1e-5 of max|y| (the
    card holds the kernel to it at 1e-3);
  * against llm_tpu's qmm_pallas(gdot=True) in interpret mode in bf16 at
    test_torch_gdot.py's 1e-6 of max|y| (measured <= 2.8e-7 over these
    cases; K5's plain version <= 3.2e-7).
The planes with both mins and a zero point, which no GGUF type has, are
refused on the card (one correction a kernel)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.ops.pallas_qmm import pack_p4_kmajor as jax_pack_p4_kmajor
from llm_tpu.ops.pallas_qmm import qmm_pallas

from llm_tpu_torch.device import full_f32
from llm_tpu_torch.gguf.constants import GGMLType
from llm_tpu_torch.ops.cuda_qmm import _check_decode, qmm_gdot_plain, unpack_planes
from llm_tpu_torch.quant.qtensor import QTensor

CASES = [  # name, zp, mins, N, K, gs
    ("Q4_K", 0, True, 256, 512, 32),
    ("Q4_0", 8, False, 256, 512, 32),
    ("ragged", 0, True, 200, 1024, 32),
    ("Q4_0_ragged", 8, False, 264, 512, 32),
    ("Q2_K", 0, True, 256, 512, 16),        # group size 16: a group every 16-k step
    ("Q3_K_ragged", 4, False, 264, 512, 16),
    ("TQ2_0", 1, False, 256, 512, 256),     # group size 256: folds every 32 k, one correction
]
ROWS = [1, 3, 8, 16]
PLAIN_REL_TOL = 1e-5
PALLAS_REL_TOL = 1e-6  # test_torch_gdot.py's bf16 tolerance


def _planes(zp, mins, N, K, B, scales_dtype, seed=0, gs=32):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, size=(K, N)).astype(np.int16) - zp
    qs = jax_pack_p4_kmajor(q, zp, 256)
    scales = ((rng.random((K // gs, N)) + 0.5) * 0.01).astype(np.float32)
    m = (rng.random((K // gs, N)) * 0.05).astype(np.float32) if mins else None
    x = rng.normal(size=(B, K)).astype(np.float32)
    sc = torch.from_numpy(scales).to(scales_dtype)
    mn = None if m is None else torch.from_numpy(m).to(scales_dtype)
    return x, qs, QTensor(torch.from_numpy(qs), sc, mn, gs, GGMLType.Q4_K, "p4", zp)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def gdot_decode_order(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The kernel's K5 arithmetic: per group g, P'_g = sum over its 16-k
    steps (two at group size 32, one at 16) of the f32 products of x with
    the raw nibbles, then acc = s[g] * P'_g + acc and the bf16-rounded
    correction, group after group, in f32. At group size 256 the products
    fold every 32 k (acc = s[g] * P'_32 + acc), and the correction, once a
    group, takes the x sums over all 256."""
    xr = _bf16(x)
    q = (unpack_planes(qt) + qt.zp).float()  # the raw nibbles
    assert torch.equal(_bf16(q), q) and q.min() >= 0 and q.max() <= 15
    K, N = q.shape
    fold = min(qt.group_size, 32)
    steps, per = fold // 16, qt.group_size // fold
    B, G = xr.shape[0], K // fold
    s = qt.scales.float().repeat_interleave(per, 0)
    m = None if qt.mins is None else qt.mins.float().repeat_interleave(per, 0)
    with full_f32():
        xg = xr.reshape(B, G, steps, 16).permute(1, 2, 0, 3)        # [G, steps, B, 16]
        qg = q.reshape(G, steps, 16, N)
        p16 = torch.einsum("gsbk,gskn->gsbn", xg, qg)              # each 16-k step
        xs = xg.sum(-1)                                              # [G, steps, B]
        p, xsum = p16[:, 0], xs[:, 0]
        for st in range(1, steps):
            p, xsum = p + p16[:, st], xsum + xs[:, st]              # [G, B, N], [G, B]
        xsum = _bf16(xsum.reshape(G // per, per, B).sum(1)).repeat_interleave(per, 0)
        acc = torch.zeros((B, N))
        for g in range(G):
            acc = s[g] * p[g] + acc
            if g % per != per - 1:
                continue  # the correction once a group, after its last fold
            if m is not None:
                acc = -_bf16(m[g]) * xsum[g][:, None] + acc
            else:
                acc = -(qt.zp * xsum[g])[:, None] * _bf16(s[g]) + acc
    return acc


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("scales_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,zp,mins,N,K,gs", CASES, ids=[c[0] for c in CASES])
def test_gdot_order_matches_plain(name, zp, mins, N, K, gs, scales_dtype, B):
    x, _, qt = _planes(zp, mins, N, K, B, scales_dtype, gs=gs)
    xt = torch.from_numpy(x)
    got = gdot_decode_order(xt, qt)
    want = qmm_gdot_plain(xt, qt, torch.bfloat16)
    assert got.shape == want.shape == (B, N)
    assert _rel(got, want) <= PLAIN_REL_TOL


@pytest.mark.parametrize("B", [1, 16])
def test_gdot_order_matches_plain_at_the_down_width(B):
    """K = 14336 (LLAMA3_8B's ffn_down): 448 groups folded one by one."""
    x, _, qt = _planes(0, True, 128, 14336, B, torch.bfloat16)
    xt = torch.from_numpy(x)
    assert _rel(gdot_decode_order(xt, qt), qmm_gdot_plain(xt, qt, torch.bfloat16)) \
        <= PLAIN_REL_TOL


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("scales_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,zp,mins,N,K,gs", CASES, ids=[c[0] for c in CASES])
def test_gdot_order_matches_pallas(name, zp, mins, N, K, gs, scales_dtype, B):
    """Against the TPU kernel in interpret mode, in bf16, on the same planes
    (the scales and mins as the port holds them, passed in f32)."""
    x, qs, qt = _planes(zp, mins, N, K, B, scales_dtype, gs=gs)
    f32 = (lambda t: None if t is None else jnp.asarray(t.float().numpy()))
    want = np.asarray(qmm_pallas(
        jnp.asarray(x), jnp.asarray(qs), f32(qt.scales), f32(qt.mins), gs=gs, zp=zp,
        layout="p4", tile_n=128, tile_k=256, interpret=True, compute_dtype=jnp.bfloat16,
        gdot=True))
    got = gdot_decode_order(torch.from_numpy(x), qt).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < PALLAS_REL_TOL


@pytest.mark.parametrize("zp,mins,ok", [(0, True, True), (8, False, True), (0, False, True),
                                        (8, True, False)])
def test_k5_takes_one_correction(zp, mins, ok):
    """K5 applies the mins or the zero-point correction: planes with both
    are refused on the card (K1 takes them)."""
    _, _, qt = _planes(zp, mins, 128, 256, 1, torch.bfloat16)
    _check_decode(qt)
    if ok:
        _check_decode(qt, True)
    else:
        with pytest.raises(ValueError):
            _check_decode(qt, True)
