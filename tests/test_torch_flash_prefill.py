"""K4/K4q's arithmetic (csrc/flash_prefill.cuh, the wgmma flash prefill),
written out in plain torch in the order the kernel uses.

The kernel forms k*cos and k*sin in f32 (exact: both factors are bf16),
splits each into bf16 hi (its upper 16 bits) and lo (the exact rest), and
sums the scores [q | q_rot | q | q_rot] . [kc_hi | ks_hi | kc_lo | ks_lo]
in f32. It walks S in blocks of 64 cells with the online softmax in log2
units (m from -1e30 log2 e, l from 0, cells past S at -inf), rounds p to
bf16 P_hi and P_lo =
bf16(p - P_hi), adds P_hi.V + P_lo.V to the f32 accumulator, and l sums the
f32 p. Held here, on seeded numpy inputs with G in {1, 2, 4, 8}, ragged S
(70, 130, 200, 300), T not a multiple of a CTA's 128/G tokens, a padding
row that sees no cell, NORM and NEOX rope, the bf16 cache and q8_0 pairs:
  * against cuda_attn.attn_plain, the function the card's checks hold the
    kernel to (atol = rtol = 1e-3 there), at 1e-5 of max|y|: the scores are
    exact products summed in another order, p keeps 16 bits;
  * against llm_tpu's flash_prefill in interpret mode, at its 5e-3
    (test_pallas_attn.py), on the same bf16 values;
  * one bf16 rounding of k*cos and k*sin, or of p (FlashAttention's
    choice), misses the card's atol = rtol = 1e-3 at T=512 S=1024 H=32
    Hkv=8 (chip_smoke.py's inputs at that shape), where the split stays
    far inside it: the reason for the split."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.ops import pallas_attn as jax_attn

from llm_tpu_torch.device import full_f32
from llm_tpu_torch.models.transformer import quantize_rows
from llm_tpu_torch.ops import cuda_attn
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORM, RopeParams, rope_angles
from llm_tpu_torch.tools.kbench_attn import attn_inputs

NEG = -1e30
LOG2E = 1.4426950408889634
SBLK = 64  # cells a block, as csrc/flash_prefill.cuh's FP_SB
D = 128
PLAIN_REL_TOL = 1e-5
PALLAS_TOL = dict(atol=5e-3, rtol=5e-3)
CARD_TOL = dict(atol=1e-3, rtol=1e-3)  # chip_smoke.py::check_attn, test_torch_cuda.py


def _hi(x: torch.Tensor) -> torch.Tensor:
    """x cut to bf16: its upper 16 bits, as f32."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def kernel_order(q, q_rot, k, v, cos, sin, bias, scale, split_k=True, split_p=True):
    """K4/K4q's arithmetic. split_k=False rounds k*cos and k*sin to bf16
    once; split_p=False rounds p to bf16 once. Returns [T, H, D] f32."""
    T, H, _ = q.shape
    kf = cuda_attn.dequant_bf16(k)
    vf = cuda_attn.dequant_bf16(v)
    Hkv, S, Dv = vf.shape
    G = H // Hkv
    kc = kf * cos.float()[None]  # exact: 8 x 8 significant bits
    ks = kf * sin.float()[None]
    if split_k:
        planes = (_hi(kc), _hi(ks), kc - _hi(kc), ks - _hi(ks))
        assert all(torch.equal(p.to(torch.bfloat16).float(), p) for p in planes)
    else:
        planes = (kc.to(torch.bfloat16).float(), ks.to(torch.bfloat16).float())
    rows = (lambda x: x.float().reshape(T, Hkv, G, -1).permute(1, 0, 2, 3)
            .reshape(Hkv, T * G, -1))
    qh, qrh = rows(q), rows(q_rot)
    lhs = (qh, qrh, qh, qrh)
    # scores in log2 units: s' = (s * scale + max(bias, -1e30)) * log2 e, p = 2^(s' - m')
    brow = torch.clamp(bias.float(), min=NEG).repeat_interleave(G, dim=0) * LOG2E  # t*G + g
    scale2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    m = torch.full((Hkv, T * G, 1), NEG) * LOG2E
    l = torch.zeros((Hkv, T * G, 1))
    o = torch.zeros((Hkv, T * G, Dv))
    with full_f32():
        for sb in range(0, S, SBLK):
            se = min(S, sb + SBLK)  # cells past S: p = 0 exactly
            sc = sum(torch.einsum("hrd,hsd->hrs", a, p[:, sb:se]) for a, p in zip(lhs, planes))
            s = sc * scale2 + brow[None, :, sb:se]
            mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - mn)
            p = torch.exp2(s - mn)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            ph = p.to(torch.bfloat16).float()
            vb = vf[:, sb:se]
            pv = ph @ vb
            if split_p:
                pv = pv + (p - ph).to(torch.bfloat16).float() @ vb
            o = o * alpha + pv
            m = mn
    out = o / torch.clamp(l, min=1e-30)
    return out.reshape(Hkv, T, G, Dv).permute(1, 0, 2, 3).reshape(T, H, Dv)


def _inputs(T, H, Hkv, S, mode, seed=0, q8=False):
    """Seeded numpy inputs rounded to bf16 (the kernel's input types), as
    torch tensors and as the f32 arrays llm_tpu's kernel takes; row 0 is a
    padding row that sees no cell, the last quarter of the cells is empty."""
    rng = np.random.default_rng(seed)
    bf = (lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16))
    q = bf(rng.normal(size=(T, H, D)))
    k = bf(rng.normal(size=(Hkv, S, D)))
    v = bf(rng.normal(size=(Hkv, S, D)))
    pos = rng.permutation(S).astype(np.int32)
    c, s = rope_angles(torch.from_numpy(pos), RopeParams(n_dims=D, mode=mode,
                                                         freq_base=10000.0))
    cos, sin = (x.to(torch.bfloat16).contiguous()
                for x in cuda_attn.expand_tables(c, s, mode, D))
    tok_pos = np.sort(rng.integers(S // 4, S, size=T))
    allowed = (pos[None, :] <= tok_pos[:, None]) & (np.arange(S) < S - S // 4)[None]
    allowed[0] = False
    bias = torch.from_numpy(np.where(allowed, 0.0, -np.inf).astype(np.float32))
    t = dict(q=q, q_rot=cuda_attn.rope_companion(q, mode).contiguous(), k=k, v=v, cos=cos,
             sin=sin, bias=bias)
    if q8:
        t["k"], t["v"] = quantize_rows(k, 1), quantize_rows(v, 1)
    return t


def _jax_args(t):
    """The same inputs for llm_tpu's flash_prefill: f32 arrays, q8_0 pairs
    as (int8, f32 scales)."""
    f32 = (lambda x: jnp.asarray(x.float().numpy()))
    cv = (lambda x: (jnp.asarray(x[0].numpy()), f32(x[1])) if isinstance(x, tuple) else f32(x))
    return {n: cv(x) for n, x in t.items()}


# name, T, H, Hkv, S: T is never a multiple of the CTA's 128 / G tokens
CASES = [
    ("g1-s70", 9, 4, 4, 70),
    ("g2-s130", 65, 8, 4, 130),
    ("g4-s300", 40, 32, 8, 300),
    ("g8-s200", 24, 16, 2, 200),
]
MODES = pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
KV = pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@KV
@MODES
@pytest.mark.parametrize("name,T,H,Hkv,S", CASES, ids=[c[0] for c in CASES])
def test_kernel_order_matches_plain(name, T, H, Hkv, S, mode, q8):
    t = _inputs(T, H, Hkv, S, mode, q8=q8)
    scale = D ** -0.5
    got = kernel_order(**t, scale=scale)
    want = cuda_attn.attn_plain(**t, scale=scale)
    assert got.shape == want.shape == (T, H, D)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= PLAIN_REL_TOL
    # the padding row (token 0) averages V over exactly S cells, as attn_plain
    assert torch.allclose(got[0], want[0], atol=1e-5, rtol=0)


@KV
@MODES
@pytest.mark.parametrize("name,T,H,Hkv,S", CASES, ids=[c[0] for c in CASES])
def test_kernel_order_matches_pallas(name, T, H, Hkv, S, mode, q8):
    """Against the TPU kernel (_prefill_kernel, or _prefill_kernel_q8 on the
    pairs) in interpret mode at test_pallas_attn.py's 5e-3. In interpret
    mode the q8 kernel dequantizes to the f32 product q * s where the TPU
    (and this kernel) round it to bf16: a difference well inside 5e-3. The
    reference takes S in one block: over a padded last block its padding
    row would also count the pad (ROADMAP, deliberate differences)."""
    t = _inputs(T, H, Hkv, S, mode, seed=1, q8=q8)
    scale = D ** -0.5
    want = np.asarray(jax_attn.flash_prefill(**_jax_args(t), scale=scale, tblk=T, sblk=S,
                                             interpret=True))
    got = kernel_order(**t, scale=scale).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **PALLAS_TOL)


@pytest.fixture(scope="module")
def card_shape():
    # chip_smoke.py's attention inputs at this shape, made on the CPU
    t, _ = attn_inputs(512, 32, 8, 1024, D, seed=1024 + 512, device="cpu")
    return t, cuda_attn.attn_plain(**t, scale=D ** -0.5)


def _close_ratio(got, want) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 fails assert_close."""
    return float(((got - want).abs() / (CARD_TOL["atol"] + CARD_TOL["rtol"] * want.abs())).max())


@pytest.mark.parametrize("split_k,split_p,passes", [(False, False, False), (True, False, False),
                                                    (False, True, False), (True, True, True)],
                         ids=["k-once-p-once", "k-split-p-once", "k-once-p-split", "k-split-p-split"])
def test_single_rounding_misses_the_card_tolerance(card_shape, split_k, split_p, passes):
    """At T=512 S=1024 H=32 Hkv=8: any single bf16 rounding misses the
    card's atol = rtol = 1e-3 against attn_plain; hi + lo on both products
    stays under a tenth of it."""
    t, want = card_shape
    ratio = _close_ratio(kernel_order(**t, scale=D ** -0.5, split_k=split_k, split_p=split_p),
                         want)
    if passes:
        assert ratio < 0.1
    else:
        assert ratio > 1.0
