"""ALiBi and rope NONE (Baichuan-13B, refact) through the port against
llm_tpu on the CPU.

- The slopes of ggml's soft_max_ext schedule (transformer.alibi_slopes, as
  f32) bit-equal to those llm_tpu's forward hands its attention, at H = 1,
  4, 8, 32, 40 (two branches of the schedule) and 64.
- K3/K4's plain version with ALiBi (attn_plain(alibi_slopes=, tok_pos=,
  cell_pos=) with no rope, the function of the narrow kernels' ALiBi
  instantiations) against llm_tpu's flash_decode /
  flash_prefill(alibi_slopes=, dist=, interpret=True) on rope NONE's
  tables (cos 1, sin 0, q_rot 0) at G = 1, 4 and 32, D = 64 and 128, bf16
  at test_pallas_attn.py's 5e-3 and q8_0 at 2e-2; the unfused attention's
  ALiBi against llm_tpu's attention().
- config_from_gguf against the reference for baichuan's 7B profile (2
  layers: NORM rope), its 13B profile (40 tiny layers: rope NONE, ALiBi 8)
  and refact (test_archs2.py's config).
- The engine on a 40-layer tiny baichuan GGUF (the 13B profile) and on
  the refact one against llm_tpu's Context on its XLA path (interpreting
  40 layers would cost minutes): logits at 2e-4 in f32, greedy tokens
  equal.
- Two layers of llm_tpu's synthetic model with rope NONE and ALiBi,
  converted by config_from_reference, against llm_tpu's Context with its
  flash kernels interpreted (LLM_TPU_FLASH_FORCE=interpret).
- Where an ALiBi step goes: flash_route sends it to the unfused attention
  where the narrow kernels do not take it (a head past 128, a softcap, int8
  rows of 8 mod 16 bytes), counted, with the same logits as llm_tpu's
  interpreted flash kernels, which take every shape; and beside a rope
  (no ALiBi kernel folds one).
The ALiBi kernels themselves are held against attn_plain on the card in
test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.gguf.constants import GGMLType as JaxGGMLType
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models import transformer as jax_transformer
from llm_tpu.models.config import config_from_gguf as jax_config_from_gguf
from llm_tpu.models.synthetic import make_synthetic_model as jax_make_synthetic_model
from llm_tpu.ops import attention as jax_attention
from llm_tpu.ops import pallas_attn as jax_attn
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext

from llm_tpu_torch.convert_params import config_from_reference, params_from_reference
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models import transformer
from llm_tpu_torch.models.config import config_from_gguf
from llm_tpu_torch.ops import attention, cuda_attn, qmatmul
from llm_tpu_torch.ops.rope import (ROPE_TYPE_NONE, ROPE_TYPE_NORM, RopeParams, apply_rope,
                                    rope_angles)
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context

from test_arch_oracles import TOKENS, _write
from test_torch_attn_dims import _engine_agrees, _jax, _q8, _to_numpy, _torch, f32_both  # noqa: F401

PALLAS_TOL = dict(atol=5e-3, rtol=5e-3)     # test_pallas_attn.py:53
PALLAS_Q8_TOL = dict(atol=2e-2, rtol=2e-2)  # test_pallas_attn.py:116
F32_TOL = dict(atol=2e-4, rtol=2e-4)        # the engine's f32 tolerance
MAX_BIAS = 8.0                              # baichuan-13B's and refact's


def _none_cfg(jcfg):
    """A reference config with rope NONE and ALiBi of max_bias 8."""
    return dataclasses.replace(jcfg, alibi_max_bias=MAX_BIAS,
                               rope=dataclasses.replace(jcfg.rope, mode=-1, n_dims=0))


@pytest.mark.parametrize("H", [1, 4, 8, 32, 40, 64])
def test_slopes_are_the_reference(H, monkeypatch):
    """One eager llm_tpu forward step of a one-layer model with H heads:
    the slopes its unfused attention receives are alibi_slopes' as f32,
    bit for bit (H = 40 runs the schedule's second branch, heads 32-39)."""
    seen = {}
    real = jax_transformer.attention

    def spy(*a, **k):
        seen["slopes"] = np.asarray(k["alibi_slopes"])
        return real(*a, **k)

    monkeypatch.setattr(jax_transformer, "attention", spy)
    jp, jcfg = jax_make_synthetic_model(n_embd=32, n_layers=1, n_heads=H, n_kv_heads=H,
                                        n_ff=32, vocab=16, head_dim=8, dtype=jnp.float32)
    jcfg = _none_cfg(jcfg)
    S = 4
    kv = [jnp.zeros((H, S, 8), jnp.float32)]
    z = jnp.zeros(1, jnp.int32)
    jax_transformer.forward(jp, jcfg, kv, list(kv), jnp.ones(1, jnp.int32), z, z, z,
                            jnp.zeros(S, jnp.int32), jnp.ones(S, jnp.uint32), z,
                            dtype=jnp.float32)
    want = seen["slopes"]
    got = transformer._slopes_tensor(H, MAX_BIAS, torch.device("cpu")).numpy()
    assert want.dtype == got.dtype == np.float32 and want.shape == (H,)
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(transformer.alibi_slopes(H, MAX_BIAS), np.float32), want)


def test_rope_none_glue_is_the_reference():
    """Rope NONE: empty angle tables, apply_rope the identity, q_rot zero,
    the full-width tables all-ones / all-zeros, as llm_tpu's."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 4, 16)).astype(np.float32))
    c, s = rope_angles(torch.arange(3), RopeParams(n_dims=0, mode=ROPE_TYPE_NONE))
    assert c.shape == s.shape == (3, 0)
    assert torch.equal(apply_rope(x, c, s, ROPE_TYPE_NONE, 0), x)
    assert torch.equal(cuda_attn.rope_companion(x, ROPE_TYPE_NONE), torch.zeros_like(x))
    want = jax_attn.expand_tables(jnp.zeros((5, 0)), jnp.zeros((5, 0)), -1, 16)
    got = cuda_attn.expand_tables(torch.zeros((5, 0)), torch.zeros((5, 0)), ROPE_TYPE_NONE, 16)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(np.asarray(jax_attn.rope_companion(jnp.asarray(x.numpy()), -1)),
                          np.zeros(x.shape, np.float32))


def _alibi_inputs(T, H, Hkv, S, D, seed=0):
    """Seeded inputs for both packages on rope NONE's tables: q, K, V
    rounded to bf16, cells at a permutation of positions 0..S-1 (the last
    quarter empty), T tokens at sorted positions in [S / 4, S) seeing the
    cells at or before them; ALiBi's slopes (max_bias 8), the positions
    tok_pos and cell_pos. Returns (inputs, slopes, tok_pos, cell_pos) as
    numpy."""
    rng = np.random.default_rng(seed)
    bf = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)))
    q = bf(rng.normal(size=(T, H, D)))
    k = bf(rng.normal(size=(Hkv, S, D)))
    v = bf(rng.normal(size=(Hkv, S, D)))
    pos = rng.permutation(S).astype(np.int32)
    tok_pos = np.sort(rng.integers(S // 4, S, size=T)).astype(np.int32)
    allowed = (pos[None, :] <= tok_pos[:, None]) & (np.arange(S) < S - S // 4)[None]
    bias = np.where(allowed, 0.0, -np.inf).astype(np.float32)
    cos, sin = (np.asarray(x, np.float32)
                for x in jax_attn.expand_tables(jnp.zeros((S, 0)), jnp.zeros((S, 0)), -1, D))
    a = dict(q=q, q_rot=np.zeros_like(q), k=k, v=v, cos=cos, sin=sin, bias=bias)
    slopes = np.asarray(transformer.alibi_slopes(H, MAX_BIAS), np.float32)
    return a, slopes, tok_pos, pos


# (T, H, Hkv, S, D): Baichuan-13B's G = 1 at 128, G = 4 at 64 and 128,
# refact's G = 32 at 64
ALIBI_DECODE = [(1, 4, 4, 200, 128), (4, 8, 2, 200, 64), (8, 32, 1, 130, 64)]
ALIBI_PREFILL = [(32, 4, 4, 200, 128), (16, 8, 2, 128, 128), (16, 32, 1, 130, 64)]


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("T,H,Hkv,S,D", ALIBI_DECODE + ALIBI_PREFILL,
                         ids=[f"T{t}-G{h // hk}-D{d}" for t, h, hk, _, d in
                              ALIBI_DECODE + ALIBI_PREFILL])
def test_alibi_plain_matches_pallas(T, H, Hkv, S, D, kv, monkeypatch):
    """attn_plain(alibi_slopes=, tok_pos=, cell_pos=) with no rope (q_rot,
    cos and sin None, as the ALiBi kernels take it) against llm_tpu's
    interpreted flash_decode / flash_prefill with the same slopes and dist
    = tok_pos - cell_pos on rope NONE's tables. On the q8_0 cache the
    port's dequant is set to the f32 product llm_tpu's interpreted
    _kernel_q8 computes (test_torch_attn.py). ALiBi bites: without it
    attn_plain is elsewhere."""
    a, slopes, tok_pos, cell_pos = _alibi_inputs(T, H, Hkv, S, D, seed=T + H)
    t, j = _torch(a), _jax(a)
    if kv == "q8_0":
        for name in ("k", "v"):
            t[name], (q, s) = _q8(a[name])
            j[name] = (jnp.asarray(q), jnp.asarray(s, jnp.bfloat16))
        monkeypatch.setattr(cuda_attn, "dequant_bf16",
                            lambda x: x[0].float() * x[1].float() if isinstance(x, tuple)
                            else x.float())
    dist = (tok_pos[:, None] - cell_pos[None, :]).astype(np.float32)
    jal = dict(alibi_slopes=jnp.asarray(slopes), dist=jnp.asarray(dist))
    tal = dict(alibi_slopes=torch.from_numpy(slopes),
               tok_pos=torch.from_numpy(tok_pos.astype(np.float32)),
               cell_pos=torch.from_numpy(cell_pos.astype(np.float32)))
    rope = dict(t)
    t.update(q_rot=None, cos=None, sin=None)
    if T <= 8:
        want = jax_attn.flash_decode(**j, scale=D ** -0.5, sblk=128, interpret=True, **jal)
        got = cuda_attn.flash_decode(**t, scale=D ** -0.5, **tal)
    else:
        want = jax_attn.flash_prefill(**j, scale=D ** -0.5, tblk=16, sblk=64, interpret=True,
                                      **jal)
        got = cuda_attn.flash_prefill(**t, scale=D ** -0.5, **tal)
    assert got.shape == (T, H, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(PALLAS_Q8_TOL if kv == "q8_0" else PALLAS_TOL))
    assert (cuda_attn.attn_plain(**rope, scale=D ** -0.5) - got).abs().max() > 0.1


def test_unfused_alibi_matches_reference():
    """The unfused attention's ALiBi (after the bias) against llm_tpu's
    attention(alibi_slopes=, cell_pos=, tok_pos=) at G = 4, H = 40's
    slopes' first heads not among them: H = 8 over 2."""
    rng = np.random.default_rng(3)
    T, S, H, Hkv, D = 6, 40, 8, 2, 16
    q = rng.normal(size=(T, H, D)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    tok_pos = np.arange(30, 30 + T, dtype=np.int32)
    cell_pos = rng.permutation(S).astype(np.int32)
    bias = np.where(cell_pos[None, :] <= tok_pos[:, None], 0.0, -np.inf).astype(np.float32)
    slopes = np.asarray(transformer.alibi_slopes(H, MAX_BIAS), np.float32)
    want = jax_attention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(bias), 0.25, alibi_slopes=jnp.asarray(slopes),
                                   cell_pos=jnp.asarray(cell_pos), tok_pos=jnp.asarray(tok_pos))
    got = attention.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(bias), 0.25,
                              alibi_slopes=torch.from_numpy(slopes),
                              cell_pos=torch.from_numpy(cell_pos),
                              tok_pos=torch.from_numpy(tok_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    plain = attention.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(bias), 0.25)
    assert (plain - got).abs().max() > 0.1


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """{"7b": baichuan's 7B profile (2 layers), "13b": its 13B profile (40
    layers of 32 wide, 4 heads: test_arch_oracles.py's), "refact"}: f32
    GGUFs written by llm_tpu's writer (test_arch_oracles._write)."""
    d = tmp_path_factory.mktemp("alibi")
    paths = {n: str(d / f"{n}.gguf") for n in ("7b", "13b", "refact")}
    _write(paths["7b"], "baichuan")
    _write(paths["13b"], "baichuan", E=32, L=40, H=4, KV=4, FF=48)
    # test_archs2.py's refact geometry (_tiny_hf_llama: 64 wide, 2 layers, 4
    # heads over 2, ff 112, vocab 97)
    _write(paths["refact"], "refact", E=64, L=2, H=4, KV=2, FF=112, V=97)
    return paths


@pytest.mark.parametrize("name,alibi", [("7b", False), ("13b", True), ("refact", True)])
def test_config_is_the_reference(ggufs, name, alibi):
    jcfg = jax_config_from_gguf(JaxGGUFReader(ggufs[name]))
    cfg = config_from_gguf(GGUFReader(ggufs[name]))
    assert cfg == config_from_reference(jcfg)
    assert (cfg.alibi_max_bias == MAX_BIAS) == alibi
    assert (cfg.rope.mode, cfg.rope.n_dims) == ((ROPE_TYPE_NONE, 0) if alibi
                                                else (ROPE_TYPE_NORM, cfg.head_dim))
    transformer.check_supported({"layers": [{}] * cfg.n_layers}, cfg)


@pytest.fixture
def f32_xla(monkeypatch):
    """llm_tpu in f32 on its XLA path; the port in f32."""
    monkeypatch.delenv("LLM_TPU_FLASH_FORCE", raising=False)
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


@pytest.mark.parametrize("name", ["13b", "refact"])
def test_engine_matches_reference(ggufs, name, f32_xla):
    """Context.decode of test_arch_oracles' 8 tokens, then 6 greedy tokens
    of generate_loop: prefill logits at 2e-4 of llm_tpu's, greedy tokens
    equal; the port runs K3/K4's plain version with ALiBi (flash_route
    admits its D = 8 and 16: narrow, no softcap) where llm_tpu runs its
    unfused attention."""
    path = ggufs[name]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    assert ctx.cfg.alibi_max_bias == MAX_BIAS
    calls = dict(attention.LAUNCHES)
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    assert attention.LAUNCHES == calls  # the flash route's plain version, not the unfused one
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(first, 6) == ref.generate_loop(first, 6)


@pytest.mark.parametrize("H,Hkv,D,kv", [(4, 4, 128, "bf16"), (4, 4, 128, "q8_0"),
                                        (32, 1, 64, "bf16")],
                         ids=["G1-D128-bf16", "G1-D128-q8_0", "G32-D64-bf16"])
def test_two_layers_match_interpreted_kernels(H, Hkv, D, kv, f32_both, monkeypatch):
    """Two layers of llm_tpu's synthetic Q8_0 planes with rope NONE and
    ALiBi (Baichuan-13B's G = 1 at 128 with both caches, refact's G = 32
    at 64), converted by config_from_reference: the port's Context against
    llm_tpu's with its flash kernels interpreted, both on the flash route
    (test_torch_attn_dims._engine_agrees: prefill, a decode step, 8 greedy
    tokens)."""
    jp, jcfg = jax_make_synthetic_model(n_embd=256, n_layers=2, n_heads=H, n_kv_heads=Hkv,
                                        n_ff=256, vocab=256, head_dim=D,
                                        qtype=JaxGGMLType.Q8_0, seed=5, dtype=jnp.float32)
    jcfg = _none_cfg(jcfg)
    params, cfg = params_from_reference(_to_numpy(jp), jcfg)
    assert cfg.alibi_max_bias == MAX_BIAS and cfg.rope.mode == ROPE_TYPE_NONE
    _engine_agrees(jp, jcfg, params, cfg, kv, monkeypatch)


@pytest.mark.parametrize("dk,dv,q8,softcap,flash", [
    (128, 128, False, 0.0, True), (128, 128, True, 0.0, True), (64, 64, False, 0.0, True),
    (80, 80, True, 0.0, True), (256, 256, False, 0.0, False), (192, 128, False, 0.0, False),
    (136, 136, False, 0.0, False), (72, 72, True, 0.0, False), (72, 72, False, 0.0, True),
    (128, 128, False, 50.0, False)])
def test_flash_route_of_an_alibi_step(dk, dv, q8, softcap, flash):
    """An ALiBi step runs the flash kernels only where the narrow, uncapped
    ones take it; without ALiBi the same shapes all run them."""
    assert transformer.flash_route(dk, dv, alibi=True, q8=q8, softcap=softcap) == flash
    assert transformer.flash_route(dk, dv, alibi=False, q8=q8, softcap=softcap)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
def test_flash_route_of_an_alibi_step_with_a_rope(q8):
    """An ALiBi step beside a rope (no model of the reference has one) runs
    the unfused attention: the ALiBi kernels fold no rope."""
    assert not transformer.flash_route(128, 128, alibi=True, q8=q8, roped=True)
    assert transformer.flash_route(128, 128, alibi=True, q8=q8, roped=False)
    assert transformer.flash_route(128, 128, alibi=False, q8=q8, roped=True)


@pytest.mark.parametrize("D,softcap", [(256, 0.0), (128, 50.0)], ids=["D256", "cap50"])
def test_alibi_past_the_narrow_kernels_runs_unfused(D, softcap, f32_both, monkeypatch):
    """Two layers with ALiBi at a head of 256 (the wide kernels take no
    ALiBi) and at 128 under a softcap of 50 (nor do the capped ones): the
    port's attention is the unfused one, counted in attention.LAUNCHES,
    and no flash function is called; its prefill and decode logits match
    llm_tpu's interpreted flash kernels, which take ALiBi at every shape."""
    jp, jcfg = jax_make_synthetic_model(n_embd=256, n_layers=2, n_heads=4, n_kv_heads=2,
                                        n_ff=256, vocab=256, head_dim=D,
                                        qtype=JaxGGMLType.Q8_0, seed=5, dtype=jnp.float32)
    jcfg = dataclasses.replace(_none_cfg(jcfg), attn_softcap=softcap)
    params, cfg = params_from_reference(_to_numpy(jp), jcfg)
    flash = []
    for name in ("flash_decode", "flash_prefill"):
        monkeypatch.setattr(transformer, name, lambda *a, _n=name, **k: flash.append(_n))
    ref = JaxContext(None, n_cells=48, dtype=jnp.float32, params_cfg=(jp, jcfg))
    ctx = Context(None, n_cells=48, dtype=torch.float32, device="cpu", params_cfg=(params, cfg))
    before = attention.LAUNCHES["unfused"]
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    assert ref.decode(JaxBatch.text(prompt)) == 0 and ctx.decode(Batch.text(prompt)) == 0
    want = np.asarray(ref.get_logits())
    assert np.abs(ctx.get_logits() - want).max() <= 5e-3 * np.abs(want).max()
    first = int(np.argmax(want))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    want = np.asarray(ref.get_logits())
    assert np.abs(ctx.get_logits() - want).max() <= 5e-3 * np.abs(want).max()
    assert flash == [] and attention.LAUNCHES["unfused"] - before == 2 * cfg.n_layers


@pytest.mark.parametrize("name,K", [("blk.0.ffn_down.weight", 13696),
                                    ("blk.1.ffn_down.weight", 13696),
                                    ("blk.1.attn_q.weight", 5120), ("blk.1.ffn_up.weight", 5120),
                                    ("blk.0.attn_v.weight", 5120)])
def test_recipe_fallback_is_the_quantizer(name, K):
    """synthetic.fallback_type on the Q4_K_M recipe's type of a Baichuan-13B
    matrix (Q6_K in the use_more_bits layers) against llm_tpu's
    quantizer: a K that no 256-block divides falls back to Q8_0."""
    from llm_tpu.tools.quantize import tensor_type_for

    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import fallback_type, use_more_bits

    il = int(name.split(".")[1])
    six = any(k in name for k in ("ffn_down", "attn_v")) and use_more_bits(il, 40)
    got = fallback_type(GGMLType.Q6_K if six else GGMLType.Q4_K, K)
    want = tensor_type_for(name, (K, 5120), "Q4_K_M", 40)
    assert got.name == want.name


def test_synthetic_alibi_models():
    """make_synthetic_model's baichuan (40 layers, or 2 cut from the 13B
    profile: alibi_profile on the returned config) and refact: the ALiBi
    profile, and with the recipe every ffn_down whose K no 256-block
    divides in Q8_0; the forward runs them."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.config import alibi_profile
    from llm_tpu_torch.models.synthetic import make_synthetic_model

    geo = dict(n_embd=256, n_heads=2, n_kv_heads=2, n_ff=96, vocab=64, head_dim=128)
    for arch, n_layers, profile, alibi in (("baichuan", 40, False, True),
                                           ("baichuan", 2, True, True),
                                           ("baichuan", 2, False, False),
                                           ("refact", 2, False, True)):
        params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, recipe="Q4_K_M", arch=arch,
                                           device="cpu", n_layers=n_layers, **geo)
        if profile:
            cfg = alibi_profile(cfg)
        assert (cfg.alibi_max_bias == MAX_BIAS, cfg.rope.mode == ROPE_TYPE_NONE) == (alibi,) * 2
        assert not cfg.tie_embeddings and cfg.arch == arch
        assert {layer["ffn_down"].ggml_type for layer in params["layers"]} == {GGMLType.Q8_0}
        ctx = Context(None, n_cells=16, dtype=torch.float32, device="cpu",
                      params_cfg=(params, cfg))
        assert ctx.decode(Batch.text([1, 2, 3])) == 0 and np.isfinite(ctx.get_logits()).all()
