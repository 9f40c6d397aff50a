"""gemma2 through the port against llm_tpu on the CPU.

- A tiny transformers Gemma2 (test_archs.py's: 4 layers, 4 heads over 2 of
  16 dims, a window of 8, softcaps 50 and 30, tied embeddings; the FFN at
  128 so that every matrix quantizes) converted by llm_tpu's
  convert_hf_llama: both packages' config_from_gguf agree; the port's
  load_params and forward against llm_tpu's (its flash kernels in
  interpret mode, LLM_TPU_FLASH_FORCE=interpret) on 12 tokens, more than
  the window, at 2e-4 in f32, and against transformers at test_archs.py's
  5e-3; the two Contexts' greedy tokens equal.
- chain=True against llm_tpu's chained path (LLM_TPU_CHAIN=1,
  LLM_TPU_CHAIN_FORCE=interpret) on a Q8_0 copy made by llm_tpu's
  tools/quantize.py: K6 runs the fused norm -> QKV heads and the final
  norm -> lm_head (counted), never a tail (the post-norms bar them, as in
  the reference). K6's tile gate takes K % 256 and N % 128, so this model
  is 256 wide (2 layers, 4 heads over 2 of 32 dims, vocab 256).
- The attention softcap in K3/K4's plain version (attn_plain(softcap=50),
  the function of the capped wide kernels) against llm_tpu's
  flash_decode / flash_prefill(softcap=50, interpret=True) at D = 256 and
  128, bf16 at test_pallas_attn.py's 5e-3 and q8_0 at 2e-2; the unfused
  attention's softcap against llm_tpu's attention().
The ISWA ring: test_torch_iswa.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models.config import config_from_gguf as jax_config_from_gguf
from llm_tpu.ops import attention as jax_attention
from llm_tpu.ops import pallas_attn as jax_attn
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model

from llm_tpu_torch.convert_params import config_from_reference
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.config import config_from_gguf
from llm_tpu_torch.models.loader import load_params
from llm_tpu_torch.models.transformer import forward
from llm_tpu_torch.ops import attention, cuda_attn, cuda_qmm_chain, qmatmul
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.runtime.kv_cache import SEQ_WORDS

from test_model_vs_hf import _run_ours
from test_tools import _test_vocab
from test_torch_attn_dims import _inputs, _jax, _q8, _torch

PALLAS_TOL = dict(atol=5e-3, rtol=5e-3)     # test_pallas_attn.py:53
PALLAS_Q8_TOL = dict(atol=2e-2, rtol=2e-2)  # test_pallas_attn.py:116
F32_TOL = dict(atol=2e-4, rtol=2e-4)        # the engine's f32 tolerance
HF_TOL = dict(atol=5e-3, rtol=5e-3)         # test_archs.py's gemma2 case
TOKENS = [5, 17, 60, 2, 33, 42, 7, 81, 64, 11, 90, 3]  # 12 > the window of 8


def hf_gemma2(hidden=64, layers=4, heads=4, kv_heads=2, head_dim=16, ff=128, vocab=97):
    cfg = transformers.Gemma2Config(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=ff,
        num_hidden_layers=layers, num_attention_heads=heads, num_key_value_heads=kv_heads,
        head_dim=head_dim, max_position_embeddings=128, rope_theta=10000.0,
        query_pre_attn_scalar=head_dim, sliding_window=8,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        tie_word_embeddings=True)
    torch.manual_seed(0)
    return transformers.Gemma2ForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def gemma2_ggufs(tmp_path_factory):
    """{"f32": the tiny model's f32 GGUF, "q8_wide": the 256-wide model's
    Q8_0 GGUF}, and the tiny transformers model."""
    d = tmp_path_factory.mktemp("gemma2")
    small = hf_gemma2()
    paths = {"f32": str(d / "f32.gguf")}
    convert_hf_llama(small, paths["f32"], arch="gemma2", vocab=_test_vocab(97))
    wide_f32 = str(d / "wide_f32.gguf")
    convert_hf_llama(hf_gemma2(hidden=256, layers=2, head_dim=32, vocab=256), wide_f32,
                     arch="gemma2")
    paths["q8_wide"] = str(d / "wide_q8.gguf")
    quantize_model(wide_f32, paths["q8_wide"], "Q8_0")
    return paths, small


@pytest.fixture
def f32_flash_interpreted(monkeypatch):
    """llm_tpu in f32 with its flash kernels interpreted; the port in f32."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def _port_forward(path, tokens, n_cells=32):
    """The port's load_params and forward over `tokens` at positions 0..,
    every row's logits (as test_model_vs_hf._run_ours runs llm_tpu's)."""
    params, cfg = load_params(GGUFReader(path), dense_dtype=torch.float32, device="cpu")
    T = len(tokens)
    kv = [torch.zeros((cfg.n_kv_heads, n_cells, cfg.head_dim)) for _ in range(2 * cfg.n_layers)]
    pos = torch.arange(T)
    cpos = torch.cat([pos, torch.zeros(n_cells - T, dtype=torch.long)])
    bits = torch.zeros((n_cells, SEQ_WORDS), dtype=torch.int64)
    bits[:T, 0] = 1
    logits, _ = forward(params, cfg, kv[:cfg.n_layers], kv[cfg.n_layers:], torch.tensor(tokens),
                        pos, torch.zeros(T, dtype=torch.long), pos, cpos, bits, pos,
                        dtype=torch.float32)
    return logits.numpy()


def test_config_is_the_reference(gemma2_ggufs):
    paths, _ = gemma2_ggufs
    for path in paths.values():
        jcfg = jax_config_from_gguf(JaxGGUFReader(path))
        cfg = config_from_gguf(GGUFReader(path))
        assert cfg == config_from_reference(jcfg)
        assert cfg.arch == "gemma2" and cfg.rope.mode == ROPE_TYPE_NEOX
        assert [cfg.layer_is_swa(il) for il in range(cfg.n_layers)] == \
            [jcfg.layer_is_swa(il) for il in range(cfg.n_layers)]


def test_forward_matches_reference_and_transformers(gemma2_ggufs, f32_flash_interpreted):
    """Every row of a 12-token prefill: the sliding window masks cells 8
    behind a row, the softcaps bend the scores and the logits."""
    paths, small = gemma2_ggufs
    got = _port_forward(paths["f32"], TOKENS)
    want = _run_ours(paths["f32"], TOKENS)
    assert got.shape == want.shape == (len(TOKENS), 97)
    np.testing.assert_allclose(got, want, **F32_TOL)
    with torch.no_grad():
        hf = small(torch.tensor([TOKENS])).logits[0].numpy()
    np.testing.assert_allclose(got, hf, **HF_TOL)
    assert np.abs(got).max() < 30.0  # the final softcap holds every logit inside 30


def test_engine_greedy_matches_reference(gemma2_ggufs, f32_flash_interpreted):
    """Context.decode of the prompt, one decode step, then generate_loop
    across the window: logits at 2e-4, greedy tokens equal."""
    path = gemma2_ggufs[0]["f32"]
    ref = JaxContext(JaxGGUFReader(path), n_cells=64, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=64, dtype=torch.float32, device="cpu")
    assert ctx.cells_swa is None  # 64 cells: a ring of 8 + 512 would save none
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, 16) == ref.generate_loop(nxt, 16)


def test_scan_option_runs_per_layer(gemma2_ggufs, f32_flash_interpreted):
    """Context(scan_layers=True) on gemma2 keeps its layers per layer (the
    scan decoder takes no sliding-window pattern) and gives the per-layer
    Context's logits bit for bit."""
    path = gemma2_ggufs[0]["q8_wide"]
    scan = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                   scan_layers=True)
    plain = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    assert not scan.scan and "layers_stacked" not in scan.params
    for c in (scan, plain):
        assert c.decode(Batch.text(TOKENS)) == 0
    assert np.array_equal(scan.get_logits(), plain.get_logits())


@pytest.fixture
def chain_reference(monkeypatch):
    """llm_tpu with its chained kernels and flash kernels interpreted."""
    for k, v in (("LLM_TPU_CHAIN", "1"), ("LLM_TPU_CHAIN_FORCE", "interpret"),
                 ("LLM_TPU_FLASH_FORCE", "interpret")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def test_chain_matches_reference(gemma2_ggufs, chain_reference, monkeypatch):
    """chain=True on the Q8_0 model: a decode step runs K6 for each fused
    head and the lm_head (its plain version on the CPU, counted) and no
    tail; prefill and decode logits at 2e-4 of llm_tpu's chained Context,
    greedy tokens equal."""
    calls = []
    real = cuda_qmm_chain.qmm_chain_plain
    monkeypatch.setattr(cuda_qmm_chain, "qmm_chain_plain",
                        lambda *a, **kw: (calls.append(kw["pres"]), real(*a, **kw))[1])
    path = gemma2_ggufs[0]["q8_wide"]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu", chain=True)
    heads = sum("attn_qkv_fused" in layer for layer in ctx.params["layers"])
    assert heads == ctx.cfg.n_layers and cuda_qmm_chain.is_kmajor_qt(ctx.params["output"])
    assert not any(cuda_qmm_chain.tail_eligible(layer) for layer in ctx.params["layers"])
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    assert calls == []  # a 12-token step runs unchained
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    assert calls == [("norm",)] * (heads + 1)  # the heads, then the lm_head
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, 8) == ref.generate_loop(nxt, 8)


# (T, H, Hkv, S, D): Gemma-2-9B's G = 2 at 256, Gemma-2-27B's at 128
CAP_DECODE = [(1, 4, 2, 200, 256), (8, 4, 2, 130, 256), (4, 4, 2, 200, 128)]
CAP_PREFILL = [(32, 4, 2, 200, 256), (16, 4, 2, 128, 128)]  # T % llm_tpu's tblk 16 == 0


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("T,H,Hkv,S,D", CAP_DECODE + CAP_PREFILL,
                         ids=[f"T{t}-G{h // hk}-D{d}" for t, h, hk, _, d in
                              CAP_DECODE + CAP_PREFILL])
def test_capped_plain_matches_pallas(T, H, Hkv, S, D, kv, monkeypatch):
    """attn_plain(softcap=50) against llm_tpu's flash_decode /
    flash_prefill(softcap=50) in interpret mode. The scores are scaled up
    so that the cap bends them (|s| up to ~60 before it), which the check
    that the uncapped function is elsewhere confirms. On the q8_0 cache
    the port's dequant is set to the f32 product llm_tpu's interpreted
    _kernel_q8 computes (test_torch_attn.py)."""
    cap, scale = 50.0, 2.0
    a = _inputs(T, H, Hkv, S, D, ROPE_TYPE_NEOX, seed=9)
    t, j = _torch(a), _jax(a)
    if kv == "q8_0":
        for name in ("k", "v"):
            t[name], (q, s) = _q8(a[name])
            j[name] = (jnp.asarray(q), jnp.asarray(s, jnp.bfloat16))
        monkeypatch.setattr(cuda_attn, "dequant_bf16",
                            lambda x: x[0].float() * x[1].float() if isinstance(x, tuple)
                            else x.float())
    if T <= 8:
        want = jax_attn.flash_decode(**j, scale=scale, softcap=cap, sblk=128, interpret=True)
        got = cuda_attn.flash_decode(**t, scale=scale, softcap=cap)
    else:
        want = jax_attn.flash_prefill(**j, scale=scale, softcap=cap, tblk=16, sblk=64,
                                      interpret=True)
        got = cuda_attn.flash_prefill(**t, scale=scale, softcap=cap)
    assert got.shape == (T, H, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(PALLAS_Q8_TOL if kv == "q8_0" else PALLAS_TOL))
    uncapped = cuda_attn.attn_plain(**t, scale=scale)
    assert (uncapped - got).abs().max() > 0.1


def test_unfused_softcap_and_window_match_reference():
    """The unfused attention's softcap and build_attn_bias's window against
    llm_tpu's attention() and build_attn_bias(swa_window=)."""
    rng = np.random.default_rng(3)
    T, S, H, Hkv, D = 6, 40, 4, 2, 16
    q = rng.normal(size=(T, H, D)).astype(np.float32) * 4
    k = rng.normal(size=(S, Hkv, D)).astype(np.float32) * 4
    v = rng.normal(size=(S, Hkv, D)).astype(np.float32)
    tok_pos = np.arange(30, 30 + T, dtype=np.int32)
    cell_pos = rng.permutation(S).astype(np.int32)
    bits = np.zeros((S, 1), np.uint32)
    bits[:36] = 1
    want_bias = jax_attention.build_attn_bias(jnp.asarray(tok_pos), jnp.zeros(T, jnp.int32),
                                              jnp.asarray(cell_pos), jnp.asarray(bits),
                                              swa_window=8)
    bias = attention.build_attn_bias(torch.from_numpy(tok_pos).long(),
                                     torch.zeros(T, dtype=torch.long),
                                     torch.from_numpy(cell_pos).long(),
                                     torch.from_numpy(bits.astype(np.int64)), swa_window=8)
    assert np.array_equal(bias.numpy(), np.asarray(want_bias))
    assert (np.isfinite(bias.numpy()).sum(axis=1) <= 8).all()
    want = jax_attention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), want_bias,
                                   0.25, softcap=5.0)
    got = attention.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              bias, 0.25, softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
