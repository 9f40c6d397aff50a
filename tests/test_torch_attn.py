"""K3/K4's plain version (llm_tpu_torch.ops.cuda_attn.attn_plain, behind
flash_decode / flash_prefill on the CPU) held against llm_tpu's Pallas
flash_decode / flash_prefill in interpret mode, at test_pallas_attn.py's
5e-3: GQA, masked tail cells, a fully masked padding row, NORM and NEOX
rope folded into the scores; K3q/K4q's plain version (attn_plain on
(int8, scales) pairs) against the TPU's _kernel_q8 / _prefill_kernel_q8.
Also the rope glue (rope_angles, apply_rope, rope_companion,
expand_tables) and the mask builder with seq ids >= 32.
The CUDA kernels are held against the plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.ops import pallas_attn as jax_attn
from llm_tpu.ops.attention import build_attn_bias as jax_build_attn_bias
from llm_tpu.ops.rope import RopeParams as JaxRopeParams
from llm_tpu.ops.rope import apply_rope as jax_apply_rope
from llm_tpu.ops.rope import rope_angles as jax_rope_angles

from llm_tpu_torch.ops import cuda_attn
from llm_tpu_torch.ops.attention import attention, build_attn_bias
from llm_tpu_torch.ops.rope import (ROPE_TYPE_NEOX, ROPE_TYPE_NORM, RopeParams,
                                    apply_rope, rope_angles)


def _inputs(T, H, Hkv, S, D, mode, seed=0, masked_row=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(T, H, D)).astype(np.float32)
    k = rng.normal(size=(Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(Hkv, S, D)).astype(np.float32)
    pos = rng.permutation(S).astype(np.int32)
    rp = dict(n_dims=D, mode=mode, freq_base=10000.0)
    cos_h, sin_h = jax_rope_angles(jnp.asarray(pos), JaxRopeParams(**rp))
    cos, sin = jax_attn.expand_tables(cos_h, sin_h, mode, D)
    qr = jax_attn.rope_companion(jnp.asarray(q), mode)
    # causal-ish mask: each token sees cells with pos <= its own; the last
    # quarter of the cells are empty (masked), as in a part-filled cache
    tok_pos = np.sort(rng.integers(S // 4, S, size=T))
    allowed = (pos[None, :] <= tok_pos[:, None]) & (np.arange(S) < S - S // 4)[None]
    if masked_row is not None:
        allowed[masked_row] = False  # a padding row: nothing visible
    bias = np.where(allowed, 0.0, -np.inf).astype(np.float32)
    j = dict(q=jnp.asarray(q), q_rot=qr, k=jnp.asarray(k), v=jnp.asarray(v),
             cos=cos, sin=sin, bias=jnp.asarray(bias))
    t = {name: torch.from_numpy(np.array(a)) for name, a in j.items()}
    return j, t, rp, pos


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S", [(1, 8, 2, 256), (4, 8, 8, 200), (8, 4, 1, 512)])
def test_flash_decode_plain_matches_pallas(T, H, Hkv, S, mode):
    j, t, _, _ = _inputs(T, H, Hkv, S, 64, mode)
    scale = 64 ** -0.5
    want = np.asarray(jax_attn.flash_decode(**j, scale=scale, sblk=128, interpret=True))
    got = cuda_attn.flash_decode(**t, scale=scale).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S", [(32, 8, 2, 256), (16, 4, 4, 128)])
def test_flash_prefill_plain_matches_pallas(T, H, Hkv, S, mode):
    j, t, _, _ = _inputs(T, H, Hkv, S, 64, mode, masked_row=3)
    scale = 64 ** -0.5
    want = np.asarray(jax_attn.flash_prefill(**j, scale=scale, tblk=16, sblk=64,
                                             interpret=True))
    got = cuda_attn.flash_prefill(**t, scale=scale).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)


def test_fully_masked_row_is_finite_and_matches():
    """A padding row that sees no cell comes out finite (-inf clamped to
    -1e30), and equal to the TPU kernel's when S fills whole blocks."""
    j, t, _, _ = _inputs(4, 4, 2, 128, 64, ROPE_TYPE_NORM, masked_row=2)
    want = np.asarray(jax_attn.flash_decode(**j, scale=0.125, sblk=64, interpret=True))
    got = cuda_attn.flash_decode(**t, scale=0.125).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)


def _q8_rows(x):
    """[Hkv, S, D] f32 -> (int8, bf16 scales [Hkv, S, 1]) as numpy, one
    scale per head row, built as test_pallas_attn.py's q8 planes are."""
    amax = np.abs(x).max(axis=-1, keepdims=True)
    sc = amax / 127.0
    q = np.clip(np.round(x / np.maximum(sc, 1e-9)), -127, 127).astype(np.int8)
    return q, np.asarray(jnp.asarray(sc, jnp.bfloat16))


def _q8_pair_inputs(T, H, Hkv, S, mode, masked_row=None, seed=0):
    j, t, _, _ = _inputs(T, H, Hkv, S, 128, mode, seed=seed, masked_row=masked_row)
    for name in ("k", "v"):
        q, sc = _q8_rows(np.asarray(j[name]))
        j[name] = (jnp.asarray(q), jnp.asarray(sc))
        t[name] = (torch.from_numpy(q), torch.from_numpy(sc.astype(np.float32)).to(torch.bfloat16))
    return j, t


def _f32_product(kv):
    return kv[0].float() * kv[1].float() if isinstance(kv, tuple) else kv.float()


def _q8_oracle(j, oracle, monkeypatch):
    """The TPU kernel dequantizes bf16(q) * bf16(s) rounded to bf16. Run in
    interpret mode on the CPU, XLA folds that rounding away and llm_tpu's
    _kernel_q8 computes the exact f32 product. So each case is held two
    ways: "kernel_q8" runs _kernel_q8 / _prefill_kernel_q8 on the pairs
    against the port with its dequant set to that f32 product; "bf16"
    runs llm_tpu's dense kernels on the pairs dequantized and rounded to
    bf16 (the TPU kernel's values) against the port's own attn_plain."""
    if oracle == "kernel_q8":
        monkeypatch.setattr(cuda_attn, "dequant_bf16", _f32_product)
        return j
    jd = dict(j)
    for name in ("k", "v"):
        q, sc = j[name]
        jd[name] = jnp.asarray(np.asarray(q.astype(jnp.bfloat16) * sc))  # eager: rounded
    return jd


# Measured <= 5e-7 either way; the reference's 2e-2 compares a q8 cache
# with an unquantized one.
Q8_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("oracle", ["kernel_q8", "bf16"])
@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S,masked_row", [(1, 8, 2, 200, None), (2, 8, 8, 256, 1),
                                                  (8, 4, 1, 300, None), (8, 8, 2, 256, 5)])
def test_flash_decode_q8_plain_matches_pallas(T, H, Hkv, S, masked_row, mode, oracle,
                                              monkeypatch):
    j, t = _q8_pair_inputs(T, H, Hkv, S, mode, masked_row)
    j = _q8_oracle(j, oracle, monkeypatch)
    scale = 128 ** -0.5
    want = np.asarray(jax_attn.flash_decode(**j, scale=scale, sblk=128, interpret=True))
    got = cuda_attn.flash_decode(**t, scale=scale).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **Q8_TOL)


@pytest.mark.parametrize("oracle", ["kernel_q8", "bf16"])
@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S,masked_row", [(16, 8, 2, 200, None), (32, 4, 4, 256, 3)])
def test_flash_prefill_q8_plain_matches_pallas(T, H, Hkv, S, masked_row, mode, oracle,
                                               monkeypatch):
    j, t = _q8_pair_inputs(T, H, Hkv, S, mode, masked_row, seed=1)
    j = _q8_oracle(j, oracle, monkeypatch)
    scale = 128 ** -0.5
    want = np.asarray(jax_attn.flash_prefill(**j, scale=scale, tblk=16, sblk=64,
                                             interpret=True))
    got = cuda_attn.flash_prefill(**t, scale=scale).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **Q8_TOL)


def test_q8_dequant_rounds_to_bf16():
    """The kernels' dequant is bf16(q) * bf16(s) rounded to bf16, not the
    f32 product: some products of these scales are not bf16 values."""
    q = torch.arange(-127, 128, dtype=torch.int8).reshape(1, 255, 1).expand(1, 255, 128)
    s = torch.full((1, 255, 1), 0.0123, dtype=torch.bfloat16)
    got = cuda_attn.dequant_bf16((q.contiguous(), s))
    exact = q.float() * s.float()
    assert torch.equal(got, exact.to(torch.bfloat16).float())
    assert not torch.equal(got, exact)


def test_flash_plain_matches_unfused_roped_attention():
    """Second oracle: rope folded into the scores == attention over keys
    roped with the cell positions (the unfused path)."""
    _, t, rp, pos = _inputs(3, 8, 2, 96, 64, ROPE_TYPE_NEOX, seed=4)
    c, s = rope_angles(torch.from_numpy(pos), RopeParams(**rp))
    k_roped = apply_rope(t["k"].permute(1, 0, 2), c, s, ROPE_TYPE_NEOX, 64)
    want = attention(t["q"], k_roped, t["v"].permute(1, 0, 2), t["bias"], 0.125)
    got = cuda_attn.attn_plain(t["q"], t["q_rot"], t["k"], t["v"], t["cos"], t["sin"],
                               t["bias"], 0.125)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
def test_rope_glue_matches_reference(mode):
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 4096, size=17).astype(np.int32)
    ff = (1.0 + rng.random(32)).astype(np.float32)  # llama3-style freq factors
    x = rng.normal(size=(17, 3, 64)).astype(np.float32)
    rp = dict(n_dims=64, mode=mode, freq_base=500000.0)
    jc, js = jax_rope_angles(jnp.asarray(pos), JaxRopeParams(**rp), jnp.asarray(ff))
    tc, ts = rope_angles(torch.from_numpy(pos), RopeParams(**rp), torch.from_numpy(ff))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    want = jax_apply_rope(jnp.asarray(x), jc, js, mode, 64)
    np.testing.assert_allclose(apply_rope(torch.from_numpy(x), tc, ts, mode, 64).numpy(),
                               np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(
        cuda_attn.rope_companion(torch.from_numpy(x), mode).numpy(),
        np.asarray(jax_attn.rope_companion(jnp.asarray(x), mode)))
    for got, ref in zip(cuda_attn.expand_tables(tc, ts, mode, 80, n_dims=64),
                        jax_attn.expand_tables(jc, js, mode, 80, n_dims=64)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_attn_bias_seq_ids_above_32():
    """int64 bit-set words give the same mask as the reference's uint32
    planes, for sequence ids in every word (0..255)."""
    rng = np.random.default_rng(6)
    S, T = 64, 12
    bits = np.zeros((S, 8), np.uint32)
    for c in range(S):
        for s in rng.choice(256, size=3, replace=False):
            bits[c, s >> 5] |= np.uint32(1) << np.uint32(s & 31)
    cell_pos = rng.integers(0, 40, size=S).astype(np.int32)
    tok_seq = np.asarray([0, 31, 32, 33, 63, 64, 100, 127, 128, 200, 254, 255], np.int32)
    tok_pos = rng.integers(0, 40, size=T).astype(np.int32)
    want = np.asarray(jax_build_attn_bias(jnp.asarray(tok_pos), jnp.asarray(tok_seq),
                                          jnp.asarray(cell_pos), jnp.asarray(bits)))
    got = build_attn_bias(torch.from_numpy(tok_pos), torch.from_numpy(tok_seq),
                          torch.from_numpy(cell_pos),
                          torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).any() and np.isinf(got).any()
