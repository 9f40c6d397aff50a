"""K5's plain version (llm_tpu_torch.ops.cuda_qmm.qmm_gdot_plain) held
against llm_tpu's group-factored kernel, qmm_pallas(gdot=True) ->
_gdot_kernel in interpret mode, on the same planes made from a numpy seed:
the p4 cases of test_torch_qmm.py (Q4_K with mins, Q4_0 with zero point 8,
a ragged N) and the nibble planes of Q2_K (group size 16, mins) and Q3_K
(group size 16, zero point 4) at B = 1 and 8. Then qmm(gdot=True)'s routing: the shapes the
reference's gate admits take K5, every other shape K1/K2.

Tolerances, relative to max|y|: 2e-4 in f32, as test_torch_qmm.py. In bf16
both sides round x, the group sums of x, the mins and (for the zero-point
term) the scales to bf16 at the same places, and the integer dots are
exact, so what is left is the order of f32 sums: measured <= 3.2e-7 over
these cases at seeds 0-2, held at 1e-6 (test_pallas_qmm.py's bf16
tolerance is 2e-2). The CUDA
kernel is held against the same plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.gguf.constants import GGMLType
from llm_tpu.ops.pallas_qmm import pack_p4_kmajor as jax_pack_p4_kmajor
from llm_tpu.ops.pallas_qmm import qmm_pallas

from llm_tpu_torch.ops import qmatmul
from llm_tpu_torch.ops.cuda_qmm import GDOT_MAX_B, gdot_eligible, qmm_gdot_plain, qmm_plain
from llm_tpu_torch.quant.qtensor import QTensor

P4_CASES = [  # zp, mins, N, gs
    (0, True, 256, 32),    # Q4_K
    (8, False, 256, 32),   # Q4_0
    (0, True, 200, 32),    # ragged N
    (0, True, 256, 16),    # Q2_K: group size 16, mins
    (4, False, 200, 16),   # Q3_K: group size 16, zero point 4, ragged N
    (1, False, 256, 256),  # TQ2_0: group size 256, zero point 1
]


def _planes(zp, mins, N, K=512, B=5, seed=0, layout="p4", gs=32):
    rng = np.random.default_rng(seed)
    if layout == "p4":
        q = rng.integers(0, 16, size=(K, N)).astype(np.int8)
        qs = jax_pack_p4_kmajor(q.astype(np.int16) - zp, zp, 256)
    else:
        qs = rng.integers(-32, 32, size=(K, N)).astype(np.int8)
    scales = ((rng.random((K // gs, N)) + 0.5) * 0.01).astype(np.float32)
    m = ((rng.random((K // gs, N))) * 0.05).astype(np.float32) if mins else None
    x = rng.normal(size=(B, K)).astype(np.float32)
    qt = QTensor(torch.from_numpy(qs), torch.from_numpy(scales),
                 None if m is None else torch.from_numpy(m), gs, GGMLType.Q4_K, layout, zp)
    return x, qs, scales, m, qt


def _rel(got, want):
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


@pytest.mark.parametrize("cdtype,tol", [("f32", 2e-4), ("bf16", 1e-6)])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("zp,mins,N,gs", P4_CASES,
                         ids=["q4k", "q4_0", "ragged", "q2k", "q3k", "tq2_0"])
def test_gdot_plain_matches_pallas(zp, mins, N, gs, B, cdtype, tol):
    x, qs, scales, m, qt = _planes(zp, mins, N, B=B, gs=gs)
    jdt, tdt = ((jnp.float32, torch.float32) if cdtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(qmm_pallas(
        jnp.asarray(x), jnp.asarray(qs), jnp.asarray(scales),
        None if m is None else jnp.asarray(m), gs=gs, zp=zp, layout="p4",
        tile_n=128, tile_k=256, interpret=True, compute_dtype=jdt, gdot=True))
    got = qmm_gdot_plain(torch.from_numpy(x), qt, tdt).numpy()
    assert got.shape == want.shape == (B, N)
    assert _rel(got, want) < tol


@pytest.mark.parametrize("B", [1, 8, 16])
def test_qmm_gdot_routes_p4_decode_to_k5(B):
    x, _, _, _, qt = _planes(0, True, 256, B=B)
    xt = torch.from_numpy(x)
    assert gdot_eligible(qt, B)
    got = qmatmul.qmm(xt, qt, gdot=True)
    assert torch.equal(got, qmm_gdot_plain(xt, qt, torch.bfloat16))
    # without the option the same shape stays on K1
    assert torch.equal(qmatmul.qmm(xt, qt), qmm_plain(xt, qt, torch.bfloat16))


@pytest.mark.parametrize("layout,B", [("p4", GDOT_MAX_B + 1), ("i8", 1), ("i8", 8)])
def test_qmm_gdot_routes_other_shapes_to_k1_k2(layout, B):
    """p4 at B = 17 (prefill) and int8 planes (Q6_K, Q8_0) keep K1/K2's
    function under gdot=True, as the reference's gate routes them."""
    x, _, _, _, qt = _planes(0, False, 256, B=B, layout=layout, gs=32)
    xt = torch.from_numpy(x)
    assert not gdot_eligible(qt, B)
    assert torch.equal(qmatmul.qmm(xt, qt, gdot=True), qmm_plain(xt, qt, torch.bfloat16))
