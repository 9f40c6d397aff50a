"""Flash attention at every llama head dim up to 256, Dk != Dv, and every
GQA group: the port against llm_tpu on the CPU.

- K3/K4's plain version (attn_plain, behind flash_decode / flash_prefill on
  the CPU) against llm_tpu's Pallas flash_decode / flash_prefill in
  interpret mode at D = 64, 80, 96 and G = 3, at test_pallas_attn.py's 5e-3;
  K3q/K4q's at D = 80 (a head row of 80 dims keeps one scale) at 2e-2.
- The kernels hold a block as 128 dims whatever D is, the columns past D
  zero (csrc/flash_attn.cu, csrc/flash_prefill.cuh): their arithmetic in
  plain torch (the kernel_order of test_torch_flash_decode.py and
  test_torch_flash_prefill.py) on inputs zero-padded to 128 dims gives
  attn_plain at D.
- The port's forward (two layers, narrow widths) against llm_tpu's Context
  with its flash kernels in interpret mode (LLM_TPU_FLASH_FORCE=interpret)
  at D = 64, 80, 96 and G = 3, with a bf16 and a q8_0 cache: logits at the
  flash tolerances (5e-3 dense, 2e-2 q8, relative to max|logit|), greedy
  tokens exactly equal. A q8_0 cache with 32-dim group scales (D = 64, 96)
  takes the unfused attention on both sides, by the scales' shape.
- The wide kernels (Dk != Dv, heads past 128, int8 rows at 8 mod 16):
  attn_plain against llm_tpu's interpreted kernels at D = 256, Dk 192 /
  Dv 128, Dk 128 / Dv 64 and q8_0 at D = 72 and 136; their arithmetic on
  inputs zero-padded to two 128-dim chunks; the engine against llm_tpu's
  at head_dim 256 and at Dk 192 / Dv 128.
- Where attention goes (flash_route, as the reference's use_flash gate): a
  head dim that is no multiple of 8 takes the unfused attention, and so do
  heads past 256 on either device (no kernel of the port holds them; the
  reference's gate sends them to its flash kernels): the engine at
  Dk = Dv = 264 against llm_tpu's interpreted flash kernels.
The kernels themselves are held against attn_plain on the card in
test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.gguf.constants import GGMLType as JaxGGMLType
from llm_tpu.models.synthetic import make_synthetic_model as jax_make_synthetic_model
from llm_tpu.ops import pallas_attn as jax_attn
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.ops.rope import RopeParams as JaxRopeParams
from llm_tpu.ops.rope import rope_angles as jax_rope_angles
from llm_tpu.quant.qtensor import QTensor as JaxQTensor
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext

from llm_tpu_torch.convert_params import params_from_reference
from llm_tpu_torch.models import transformer
from llm_tpu_torch.models.transformer import quantize_rows
from llm_tpu_torch.ops import cuda_attn, qmatmul
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORM
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.runtime.kv_cache import kv_group

from test_torch_flash_decode import kernel_order as decode_order
from test_torch_flash_decode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_flash_prefill import kernel_order as prefill_order

PALLAS_TOL = dict(atol=5e-3, rtol=5e-3)     # test_pallas_attn.py:53
PALLAS_Q8_TOL = dict(atol=2e-2, rtol=2e-2)  # test_pallas_attn.py:116
DENSE_REL, Q8_REL = 5e-3, 2e-2              # engine logits, of max|logit|
PAD_REL_TOL = 1e-5


def _inputs(T, H, Hkv, S, D, mode, seed=0, Dv=None):
    """Seeded numpy inputs for both packages, rounded to bf16 (the kernels'
    types), V at Dv (None: D); the last quarter of the cells is empty. No padding row: over a
    ragged S it averages the TPU kernels' padded tail too (ROADMAP,
    "Deliberate differences")."""
    rng = np.random.default_rng(seed)
    bf = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)))
    q = bf(rng.normal(size=(T, H, D)))
    k = bf(rng.normal(size=(Hkv, S, D)))
    v = bf(rng.normal(size=(Hkv, S, Dv or D)))
    pos = rng.permutation(S).astype(np.int32)
    cos_h, sin_h = jax_rope_angles(jnp.asarray(pos), JaxRopeParams(n_dims=D, mode=mode))
    cos, sin = (bf(np.asarray(x)) for x in jax_attn.expand_tables(cos_h, sin_h, mode, D))
    qr = np.asarray(jax_attn.rope_companion(jnp.asarray(q), mode))
    tok_pos = np.sort(rng.integers(S // 4, S, size=T))
    allowed = (pos[None, :] <= tok_pos[:, None]) & (np.arange(S) < S - S // 4)[None]
    bias = np.where(allowed, 0.0, -np.inf).astype(np.float32)
    return dict(q=q, q_rot=qr, k=k, v=v, cos=cos, sin=sin, bias=bias)


def _torch(a: dict, dtype=torch.bfloat16) -> dict:
    return {n: (torch.from_numpy(x.copy()) if n == "bias"
                else torch.from_numpy(x.copy()).to(dtype))
            for n, x in a.items()}


def _jax(a: dict) -> dict:
    return {n: jnp.asarray(x) for n, x in a.items()}


def _q8(x: np.ndarray):
    """[Hkv, S, D] -> (int8, bf16 scales [Hkv, S, 1]) by the cache's
    quantizer, as torch and as numpy f32 (the scale's bf16 value)."""
    q, s = quantize_rows(torch.from_numpy(x.copy()), 1)
    return (q, s), (q.numpy(), s.float().numpy())


# (T, H, Hkv, S, D): head dims 64, 80, 96 at G = 4, 2, 1, and G = 3 at 128 and 64
DECODE_SHAPES = [(1, 8, 2, 256, 64), (4, 4, 2, 200, 80), (8, 2, 2, 300, 96),
                 (1, 6, 2, 256, 128), (8, 6, 2, 130, 64)]
PREFILL_SHAPES = [(32, 8, 2, 256, 64), (16, 4, 2, 200, 80), (32, 2, 2, 128, 96),
                  (48, 6, 2, 256, 128), (16, 6, 2, 130, 64)]  # T % llm_tpu's tblk 16 == 0


def _ids(shapes):
    return [f"T{t}-G{h // hk}-D{d}" for t, h, hk, _, d in shapes]


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S,D", DECODE_SHAPES, ids=_ids(DECODE_SHAPES))
def test_flash_decode_plain_matches_pallas_at_any_head_dim(T, H, Hkv, S, D, mode):
    a = _inputs(T, H, Hkv, S, D, mode)
    want = np.asarray(jax_attn.flash_decode(**_jax(a), scale=D ** -0.5, sblk=128,
                                            interpret=True))
    got = cuda_attn.flash_decode(**_torch(a), scale=D ** -0.5).numpy()
    assert got.shape == (T, H, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **PALLAS_TOL)


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S,D", PREFILL_SHAPES, ids=_ids(PREFILL_SHAPES))
def test_flash_prefill_plain_matches_pallas_at_any_head_dim(T, H, Hkv, S, D, mode):
    a = _inputs(T, H, Hkv, S, D, mode, seed=1)
    want = np.asarray(jax_attn.flash_prefill(**_jax(a), scale=D ** -0.5, tblk=16, sblk=64,
                                             interpret=True))
    got = cuda_attn.flash_prefill(**_torch(a), scale=D ** -0.5).numpy()
    assert got.shape == (T, H, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **PALLAS_TOL)


@pytest.mark.parametrize("T,H,Hkv,S", [(1, 8, 2, 256), (8, 6, 2, 200), (16, 4, 2, 200),
                                       (48, 6, 2, 256)])
def test_flash_q8_plain_matches_pallas_at_head_dim_80(T, H, Hkv, S, monkeypatch):
    """K3q/K4q's plain version on row-scaled int8 K/V at D = 80 (kv_group
    keeps one scale a row there) against llm_tpu's _kernel_q8 /
    _prefill_kernel_q8 in interpret mode. In interpret mode XLA folds the
    TPU kernel's bf16 rounding of q*s away, so the port's dequant is set to
    that f32 product here (test_torch_attn.py's "kernel_q8" oracle)."""
    D = 80
    assert kv_group(D) == D
    a = _inputs(T, H, Hkv, S, D, ROPE_TYPE_NORM, seed=2)
    t, j = _torch(a), _jax(a)
    for name in ("k", "v"):
        t[name], (q, s) = _q8(a[name])
        j[name] = (jnp.asarray(q), jnp.asarray(s, jnp.bfloat16))
    monkeypatch.setattr(cuda_attn, "dequant_bf16",
                        lambda kv: kv[0].float() * kv[1].float() if isinstance(kv, tuple)
                        else kv.float())
    if T <= 8:
        want = jax_attn.flash_decode(**j, scale=D ** -0.5, sblk=128, interpret=True)
        got = cuda_attn.flash_decode(**t, scale=D ** -0.5)
    else:
        want = jax_attn.flash_prefill(**j, scale=D ** -0.5, tblk=16, sblk=64, interpret=True)
        got = cuda_attn.flash_prefill(**t, scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_Q8_TOL)


# (T, H, Hkv, S, Dk, Dv): gemma's 256, MLA's 192 / 128, and Dv < Dk
WIDE_DECODE = [(1, 4, 2, 200, 256, 256), (8, 4, 4, 130, 192, 128), (4, 4, 2, 200, 128, 64)]
WIDE_PREFILL = [(32, 4, 2, 200, 256, 256), (16, 4, 4, 130, 192, 128),
                (32, 4, 2, 128, 128, 64)]


def _wide_ids(shapes):
    return [f"T{t}-G{h // hk}-Dk{dk}-Dv{dv}" for t, h, hk, _, dk, dv in shapes]


@pytest.mark.parametrize("T,H,Hkv,S,Dk,Dv", WIDE_DECODE + WIDE_PREFILL,
                         ids=_wide_ids(WIDE_DECODE + WIDE_PREFILL))
def test_flash_plain_matches_pallas_at_wide_heads(T, H, Hkv, S, Dk, Dv):
    """K3/K4's plain version at heads past 128 and Dk != Dv against
    llm_tpu's interpreted flash_decode / flash_prefill (which take any
    Dk, Dv that are multiples of 8), at test_pallas_attn.py's 5e-3."""
    a = _inputs(T, H, Hkv, S, Dk, ROPE_TYPE_NEOX, seed=4, Dv=Dv)
    if T <= 8:
        want = jax_attn.flash_decode(**_jax(a), scale=Dk ** -0.5, sblk=128, interpret=True)
        got = cuda_attn.flash_decode(**_torch(a), scale=Dk ** -0.5)
    else:
        want = jax_attn.flash_prefill(**_jax(a), scale=Dk ** -0.5, tblk=16, sblk=64,
                                      interpret=True)
        got = cuda_attn.flash_prefill(**_torch(a), scale=Dk ** -0.5)
    assert got.shape == (T, H, Dv) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_TOL)


@pytest.mark.parametrize("T", [1, 8, 32])
@pytest.mark.parametrize("D", [72, 136])
def test_flash_q8_plain_matches_pallas_at_8_mod_16(D, T, monkeypatch):
    """K3q/K4q's plain version on int8 rows at D = 72 and 136 (one scale a
    row: kv_group gives the whole row; the pitch is 8 mod 16 bytes, which
    the wide kernels load by 8-byte cp.async) against llm_tpu's interpreted
    _kernel_q8 / _prefill_kernel_q8, the dequant set to their f32 product,
    at test_pallas_attn.py's 2e-2."""
    assert kv_group(D) == D and D % 16 == 8
    a = _inputs(T, 4, 2, 160, D, ROPE_TYPE_NORM, seed=6)
    t, j = _torch(a), _jax(a)
    for name in ("k", "v"):
        t[name], (q, s) = _q8(a[name])
        j[name] = (jnp.asarray(q), jnp.asarray(s, jnp.bfloat16))
    monkeypatch.setattr(cuda_attn, "dequant_bf16",
                        lambda kv: kv[0].float() * kv[1].float() if isinstance(kv, tuple)
                        else kv.float())
    assert not cuda_attn.is_narrow(D, D, q8=True) and cuda_attn.is_narrow(D, D, q8=False) \
        == (D <= 128)
    if T <= 8:
        want = jax_attn.flash_decode(**j, scale=D ** -0.5, sblk=128, interpret=True)
        got = cuda_attn.flash_decode(**t, scale=D ** -0.5)
    else:
        want = jax_attn.flash_prefill(**j, scale=D ** -0.5, tblk=16, sblk=64, interpret=True)
        got = cuda_attn.flash_prefill(**t, scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_Q8_TOL)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("Dk,Dv", [(256, 256), (192, 128), (128, 64), (72, 72)])
def test_two_chunk_block_is_the_function_at_dk_dv(Dk, Dv, kind):
    """The wide kernels hold K, cos, sin and q as two 128-dim chunks and V
    as two more, the columns past Dk (past Dv) zero (TMA's and cp.async's
    zero fill): the kernels' arithmetic on inputs zero-padded so gives
    attn_plain at (Dk, Dv) in its first Dv columns and zeros past them."""
    T = 4 if kind == "decode" else 40
    a = _inputs(T, 6, 2, 200, Dk, ROPE_TYPE_NEOX, seed=3, Dv=Dv)
    t = _torch(a)
    pad = (lambda x: torch.nn.functional.pad(x, (0, 256 - x.shape[-1])))
    padded = {n: (x if n == "bias" else pad(x)) for n, x in t.items()}
    order = decode_order if kind == "decode" else prefill_order
    got = order(**padded, scale=Dk ** -0.5)
    want = cuda_attn.attn_plain(**t, scale=Dk ** -0.5)
    assert torch.equal(got[..., Dv:], torch.zeros_like(got[..., Dv:]))
    err = (got[..., :Dv] - want).abs().max().item()
    assert err <= PAD_REL_TOL * want.abs().max().item(), err


def _pad128(t: dict) -> dict:
    """Every D-wide input zero-padded to 128 dims, as the kernels' blocks
    hold it (TMA's zero fill past the maps' width D; q's zeros)."""
    pad = (lambda x: torch.nn.functional.pad(x, (0, 128 - x.shape[-1])))
    out = {}
    for n, x in t.items():
        if n == "bias":
            out[n] = x
        elif isinstance(x, tuple):
            out[n] = (pad(x[0]), x[1])
        else:
            out[n] = pad(x)
    return out


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("D", [64, 80, 96, 48, 112])
def test_padded_block_is_the_function_at_d(D, kind, q8):
    """The kernels' arithmetic on 128-dim blocks whose columns past D are
    zero gives attn_plain at D, in its first D columns, and zeros past
    them: the zeros add nothing to q.k or to P.V."""
    T = 4 if kind == "decode" else 40
    a = _inputs(T, 6, 2, 200, D, ROPE_TYPE_NEOX, seed=3)
    t = _torch(a)
    if q8:
        for name in ("k", "v"):
            t[name] = _q8(a[name])[0]
    order = decode_order if kind == "decode" else prefill_order
    got = order(**_pad128(t), scale=D ** -0.5)
    want = cuda_attn.attn_plain(**t, scale=D ** -0.5)
    assert torch.equal(got[..., D:], torch.zeros_like(got[..., D:]))
    err = (got[..., :D] - want).abs().max().item()
    assert err <= PAD_REL_TOL * want.abs().max().item(), err


# -- the forward at these shapes against llm_tpu's ------------------------------

def _to_numpy(obj):
    if isinstance(obj, JaxQTensor):
        return {f: (None if getattr(obj, f) is None else np.asarray(getattr(obj, f)))
                if f in ("qs", "scales", "mins") else getattr(obj, f)
                for f in ("qs", "scales", "mins", "group_size", "ggml_type", "layout",
                          "zp", "pack_tk", "kmajor")}
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    return None if obj is None else np.asarray(obj)


@pytest.fixture
def f32_both(monkeypatch):
    """llm_tpu in f32 with its flash kernels interpreted; the port in f32."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)
    yield


# (n_embd, n_heads, n_kv_heads, head_dim): Llama-3.2-1B's D 64 at G 4; D 80
# and 96 at G 2; Llama-3.2-3B's G 3 at D 128 and at D 64
GEOMETRIES = [(256, 4, 1, 64), (256, 2, 1, 80), (256, 4, 2, 96), (256, 3, 1, 128),
              (256, 6, 2, 64)]
GEO_IDS = [f"D{d}-G{h // hk}" for _, h, hk, d in GEOMETRIES]


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("n_embd,H,Hkv,D", GEOMETRIES, ids=GEO_IDS)
def test_engine_matches_reference_at_any_head_dim(n_embd, H, Hkv, D, kv, f32_both,
                                                  monkeypatch):
    """Two layers of Q8_0 planes from llm_tpu's synthetic model, converted:
    a prefill of 12 tokens (T > 8, K4/K4q or the unfused attention), one
    decode step (K3/K3q), then 8 greedy tokens. A q8_0 cache with one scale
    a row (D = 80, 128) runs the port's K3q/K4q plain version with its
    dequant set to the f32 product that llm_tpu's interpreted _kernel_q8
    computes (test_torch_attn.py); with group scales (D = 64, 96) both sides
    take the unfused attention."""
    geo = dict(n_embd=n_embd, n_layers=2, n_heads=H, n_kv_heads=Hkv, n_ff=256, vocab=256,
               head_dim=D)
    jp, jcfg = jax_make_synthetic_model(qtype=JaxGGMLType.Q8_0, seed=5, dtype=jnp.float32,
                                        **geo)
    params, cfg = params_from_reference(_to_numpy(jp), jcfg)
    assert cfg.head_dim == D and cfg.n_heads // cfg.n_kv_heads == H // Hkv
    _engine_agrees(jp, jcfg, params, cfg, kv, monkeypatch)


def _engine_agrees(jp, jcfg, params, cfg, kv, monkeypatch):
    """The port's Context against llm_tpu's on the same params: a prefill
    of 12 tokens, one decode step, 8 greedy tokens; which attention ran
    (flash or unfused) as the scales' shape says."""
    kv_dtype = "q8_0" if kv == "q8_0" else None
    fused = {"flash": 0, "unfused": 0}
    real_attention = transformer.attention
    monkeypatch.setattr(transformer, "attention", lambda *a, **k: (
        fused.__setitem__("unfused", fused["unfused"] + 1), real_attention(*a, **k))[1])
    for name in ("flash_decode", "flash_prefill"):
        real = getattr(transformer, name)
        monkeypatch.setattr(transformer, name, lambda *a, _f=real, **k: (
            fused.__setitem__("flash", fused["flash"] + 1), _f(*a, **k))[1])
    row = kv_group(cfg.head_dim) == cfg.head_dim and kv_group(cfg.head_dim_v) == cfg.head_dim_v
    if kv_dtype and row:
        monkeypatch.setattr(cuda_attn, "dequant_bf16",
                            lambda x: x[0].float() * x[1].float() if isinstance(x, tuple)
                            else x.float())
    ref = JaxContext(None, n_cells=48, dtype=jnp.float32, params_cfg=(jp, jcfg),
                     kv_dtype=kv_dtype)
    ctx = Context(None, n_cells=48, dtype=torch.float32, device="cpu",
                  params_cfg=(params, cfg), kv_dtype=kv_dtype)
    rel = Q8_REL if kv_dtype else DENSE_REL
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]

    def agree():
        want = np.asarray(ref.get_logits())
        got = ctx.get_logits()
        err = np.abs(got - want).max()
        assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())
        return int(np.argmax(want))

    assert ref.decode(JaxBatch.text(prompt)) == 0 and ctx.decode(Batch.text(prompt)) == 0
    first = agree()
    assert int(np.argmax(ctx.get_logits())) == first
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    nxt = agree()
    assert ctx.generate_loop(nxt, 8) == ref.generate_loop(nxt, 8)
    flash = not (kv_dtype is not None and not row) and max(cfg.head_dim, cfg.head_dim_v) <= 256
    assert (fused["unfused"] > 0, fused["flash"] > 0) == (not flash, flash)


@pytest.mark.parametrize("Dk,Dv,H,Hkv,kv", [(256, 256, 4, 2, "bf16"), (256, 256, 4, 2, "q8_0"),
                                            (192, 128, 4, 4, "bf16"), (264, 264, 4, 2, "bf16")],
                         ids=["D256-G2-bf16", "D256-G2-q8_0", "Dk192-Dv128-bf16",
                              "D264-G2-bf16"])
def test_engine_matches_reference_at_wide_heads(Dk, Dv, H, Hkv, kv, f32_both, monkeypatch):
    """Two layers at gemma's head_dim 256 (G 2) and at MLA's Dk 192 / Dv 128
    as a llama (G 1): llm_tpu's synthetic Q8_0 planes with attn_v and
    attn_output remade at Dv, converted. D = 256 keeps one q8_0 scale a
    row (the wide K3q/K4q). At D = 264 the port takes the unfused attention
    (flash_route) where llm_tpu runs its interpreted flash kernels."""
    from dataclasses import replace

    from llm_tpu.models.synthetic import synthetic_qtensor

    jp, jcfg = jax_make_synthetic_model(
        n_embd=256, n_layers=2, n_heads=H, n_kv_heads=Hkv, n_ff=256, vocab=256, head_dim=Dk,
        qtype=JaxGGMLType.Q8_0, seed=5, dtype=jnp.float32, fuse=False)
    if Dv != Dk:
        rng = np.random.default_rng(7)
        for lay in jp["layers"]:
            lay["attn_v"] = synthetic_qtensor(rng, Hkv * Dv, 256, JaxGGMLType.Q8_0)
            lay["attn_output"] = synthetic_qtensor(rng, 256, H * Dv, JaxGGMLType.Q8_0)
        jcfg = replace(jcfg, head_dim_v=Dv)
    params, cfg = params_from_reference(_to_numpy(jp), jcfg)
    assert (cfg.head_dim, cfg.head_dim_v) == (Dk, Dv)
    _engine_agrees(jp, jcfg, params, cfg, kv, monkeypatch)


@pytest.mark.parametrize("dk,dv,kv_q8,flash", [
    (64, 64, False, True), (80, 80, False, True), (96, 96, False, True),
    (128, 128, False, True), (8, 8, False, True), (72, 72, False, True),
    (64, 64, True, False), (96, 96, True, False), (80, 80, True, True), (112, 112, True, True),
    (136, 136, False, True), (100, 100, False, False), (256, 256, False, True),
    (192, 128, False, True), (72, 72, True, True), (120, 120, True, True),
    (264, 264, False, False), (256, 272, False, False)])
def test_card_refuses_what_no_kernel_takes(dk, dv, kv_q8, flash):
    """Nothing is refused on either device any more: every head up to 256
    takes the flash kernels (Dk != Dv and row-scaled q8_0 at 8 mod 16 the
    wide ones), and a head dim that is no multiple of 8 (100), a
    group-scaled q8_0 cache (64, 96) and Dk or Dv past 256 (264, 272: a
    multiple of 8, which the reference's gate sends to its flash kernels)
    the unfused attention, by flash_route; check_supported passes them all."""
    from llm_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(arch="llama", vocab_size=64, n_embd=256, n_layers=1, n_heads=4,
                      n_kv_heads=2, head_dim=dk, head_dim_v=dv, n_ff=256)
    groups = (dk // kv_group(dk), dv // kv_group(dv)) if kv_q8 else (1, 1)
    assert transformer.flash_route(dk, dv, *groups) == flash
    transformer.check_supported({"layers": [{}]}, cfg)


@pytest.mark.parametrize("dk,dv,kq8,want", [
    (128, 128, None, True), (100, 100, None, False), (256, 256, None, True),
    (192, 128, None, True), (128, 128, (1, 1), True), (64, 64, (2, 2), False),
    (128, 192, (1, 6), False), (72, 72, (1, 1), True)])
def test_flash_route_is_the_reference_gate(dk, dv, kq8, want):
    """flash_route: the reference's use_flash gate (multiples of 8, K's
    rows one scale), and the unfused attention where V's rows carry group
    scales under one K scale, which the reference's kernels misread
    (ROADMAP, "Faults in the reference")."""
    assert transformer.flash_route(dk, dv, *(kq8 or (1, 1))) == want
