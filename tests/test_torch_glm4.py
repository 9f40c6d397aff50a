"""GLM-4 (glm4) through the port against llm_tpu on the CPU.

- test_archs.py's tiny transformers Glm4 (2 layers, 4 heads over 2 of 16
  dims, rope on the first half of each head, QKV biases, the sandwich
  post-norms, gate+up packed in ffn_up), converted by llm_tpu's
  convert_hf_llama (f32): both packages' config_from_gguf agree (NORM rope
  on 8 of 16 dims); the port's forward against llm_tpu's (its flash
  kernels interpreted) and transformers' at 2e-4; the two Contexts' greedy
  tokens equal.
- GLM-4-9B-0414's full-depth config (a GGUF of its metadata) keeps its
  partial rope (64 of 128 dims) and G = 16 through config_from_reference,
  and is models/synthetic.py's glm4_config(**GLM4_9B).
- tools/synth_gguf.py --arch glm4 at a small width (256, two heads over
  one of 128, ff 320: ffn_down falls back to Q8_0): llm_tpu loads the file
  too, the two Contexts agree at 2e-4 with equal greedy tokens, and
  make_synthetic_model(arch="glm4") makes the same keys and types.
- chain=True on a 256-wide Q8_0 copy: the biases keep every head and the
  post-norms every tail unchained, as in the reference; only the lm_head
  runs K6 (its plain version, counted), against llm_tpu's chained Context."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.gguf.writer import GGUFWriter as JaxGGUFWriter
from llm_tpu.gguf.constants import Keys as JaxKeys
from llm_tpu.models.config import config_from_gguf as jax_config_from_gguf
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model

from llm_tpu_torch.convert_params import config_from_reference
from llm_tpu_torch.gguf.constants import GGMLType
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.config import config_from_gguf
from llm_tpu_torch.models.loader import load_params
from llm_tpu_torch.models.synthetic import GLM4_9B, glm4_config, make_synthetic_model
from llm_tpu_torch.ops import cuda_qmm_chain, qmatmul
from llm_tpu_torch.ops.rope import ROPE_TYPE_NORM
from llm_tpu_torch.quant.qtensor import QTensor
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.tools import synth_gguf

from test_model_vs_hf import _run_ours
from test_tools import _test_vocab
from test_torch_gemma2 import _port_forward

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # the engine's f32 tolerance
TOKENS = [5, 17, 60, 2, 33, 42, 7, 81, 64]
# synth_gguf's glm4 file at a small width: ffn_down's K (320) is no
# multiple of 256, so the Q4_K_M recipe writes it as Q8_0, as GLM-4-9B's
SMALL = dict(n_embd=256, n_heads=2, n_kv_heads=1, n_ff=320, n_vocab=768)


def hf_glm4(hidden=64, layers=2, heads=4, kv_heads=2, head_dim=16, ff=112, vocab=97):
    cfg = transformers.Glm4Config(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=ff,
        num_hidden_layers=layers, num_attention_heads=heads, num_key_value_heads=kv_heads,
        max_position_embeddings=128, rope_theta=10000.0, pad_token_id=0,
        head_dim=head_dim, partial_rotary_factor=0.5, tie_word_embeddings=False)
    torch.manual_seed(0)
    return transformers.Glm4ForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def glm4_ggufs(tmp_path_factory):
    """{"f32": the tiny model's f32 GGUF, "q8_wide": a 256-wide one in
    Q8_0, "synth": synth_gguf's small Q4_K_M-typed file}, and the tiny
    transformers model."""
    d = tmp_path_factory.mktemp("glm4")
    small = hf_glm4()
    paths = {"f32": str(d / "f32.gguf")}
    convert_hf_llama(small, paths["f32"], arch="glm4", vocab=_test_vocab(97))
    wide_f32 = str(d / "wide_f32.gguf")
    convert_hf_llama(hf_glm4(hidden=256, head_dim=64, ff=256, vocab=256), wide_f32, arch="glm4")
    paths["q8_wide"] = str(d / "wide_q8.gguf")
    quantize_model(wide_f32, paths["q8_wide"], "Q8_0")
    paths["synth"] = str(d / "synth.gguf")
    synth_gguf.write_llama(paths["synth"], n_layers=2, rope_theta=10000.0, arch="glm4",
                           seed=3, **SMALL)
    return paths, small


@pytest.fixture
def f32_flash_interpreted(monkeypatch):
    """llm_tpu in f32 with its flash kernels interpreted; the port in f32."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def test_config_is_the_reference(glm4_ggufs):
    paths, _ = glm4_ggufs
    for path in paths.values():
        jcfg = jax_config_from_gguf(JaxGGUFReader(path))
        cfg = config_from_gguf(GGUFReader(path))
        assert cfg == config_from_reference(jcfg)
        assert cfg.arch == "glm4" and cfg.rope.mode == ROPE_TYPE_NORM
        assert cfg.rope.n_dims == cfg.head_dim // 2


def test_loaded_layers_hold_glm4_tensors(glm4_ggufs):
    """The loader's glm4 keys: gate+up packed (ffn_gateup_fused, 2 n_ff
    rows), the QKV biases, both post-norms; no ffn_gate."""
    params, cfg = load_params(GGUFReader(glm4_ggufs[0]["f32"]), dense_dtype=torch.float32,
                              device="cpu")
    for layer in params["layers"]:
        assert {"ffn_gateup_fused", "attn_q_b", "attn_k_b", "attn_v_b", "attn_post_norm",
                "ffn_post_norm"} <= set(layer)
        assert "ffn_gate" not in layer and "ffn_up" not in layer
        assert layer["ffn_gateup_fused"].shape == (2 * cfg.n_ff, cfg.n_embd)


def test_forward_matches_reference_and_transformers(glm4_ggufs, f32_flash_interpreted):
    paths, small = glm4_ggufs
    got = _port_forward(paths["f32"], TOKENS)
    want = _run_ours(paths["f32"], TOKENS)
    assert got.shape == want.shape == (len(TOKENS), 97)
    np.testing.assert_allclose(got, want, **F32_TOL)
    with torch.no_grad():
        hf = small(torch.tensor([TOKENS])).logits[0].numpy()
    np.testing.assert_allclose(got, hf, **F32_TOL)


def _engine_agrees(path, n_tokens=8):
    """The prompt's and one step's logits at 2e-4 of llm_tpu's Context,
    then n_tokens greedy tokens equal."""
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, n_tokens) == ref.generate_loop(nxt, n_tokens)
    return ctx


def test_engine_greedy_matches_reference(glm4_ggufs, f32_flash_interpreted):
    _engine_agrees(glm4_ggufs[0]["f32"])


def test_full_depth_config_keeps_partial_rope_and_gqa(tmp_path):
    """GLM-4-9B-0414's header (llm_tpu's writer, no tensors): both
    packages read the same config, convert_params carries it across, rope
    NORM on 64 of 128 dims, 32 heads over 2 (G = 16), and it is the
    synthetic glm4_config(**GLM4_9B)."""
    path = str(tmp_path / "glm4_9b_header.gguf")
    w = JaxGGUFWriter(path, arch="glm4")
    a = (lambda k: k.format(arch="glm4"))
    for key, val in ((JaxKeys.LLM.CONTEXT_LENGTH, 131072), (JaxKeys.LLM.EMBEDDING_LENGTH, 4096),
                     (JaxKeys.LLM.BLOCK_COUNT, 40), (JaxKeys.LLM.FEED_FORWARD_LENGTH, 13696),
                     (JaxKeys.Attention.HEAD_COUNT, 32), (JaxKeys.Attention.HEAD_COUNT_KV, 2),
                     (JaxKeys.Attention.KEY_LENGTH, 128), (JaxKeys.Attention.VALUE_LENGTH, 128),
                     (JaxKeys.Rope.DIMENSION_COUNT, 64), (JaxKeys.LLM.VOCAB_SIZE, 151552)):
        w.add_kv(a(key), np.uint32(val))
    w.add_kv(a(JaxKeys.Attention.LAYERNORM_RMS_EPS), np.float32(1.5625e-7))
    w.add_kv(a(JaxKeys.Rope.FREQ_BASE), np.float32(10000.0))
    w.write()
    jcfg = jax_config_from_gguf(JaxGGUFReader(path))
    cfg = config_from_reference(jcfg)
    assert cfg == config_from_gguf(GGUFReader(path))
    assert (cfg.rope.mode, cfg.rope.n_dims, cfg.head_dim) == (ROPE_TYPE_NORM, 64, 128)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.n_rep) == (32, 2, 16)
    assert cfg == glm4_config(**GLM4_9B)


def test_synth_file_matches_reference(glm4_ggufs, f32_flash_interpreted):
    """synth_gguf's glm4 file: its types are the recipe's (ffn_down Q8_0,
    K = 320), llm_tpu reads the same config and the two Contexts agree."""
    path = glm4_ggufs[0]["synth"]
    ctx = _engine_agrees(path, n_tokens=4)
    layers = ctx.params["layers"]
    assert all(layer["ffn_down"].ggml_type == GGMLType.Q8_0 for layer in layers)
    assert all(layer["ffn_gateup_fused"].ggml_type == GGMLType.Q4_K for layer in layers)


def test_synthetic_model_is_the_synth_file(glm4_ggufs):
    """make_synthetic_model(arch="glm4", recipe="Q4_K_M") makes the keys,
    shapes and plane types that loading synth_gguf's file of the same
    geometry gives."""
    path = glm4_ggufs[0]["synth"]
    loaded, lcfg = load_params(GGUFReader(path), dense_dtype=torch.float32, device="cpu")
    made, mcfg = make_synthetic_model(
        n_embd=SMALL["n_embd"], n_layers=2, n_heads=SMALL["n_heads"],
        n_kv_heads=SMALL["n_kv_heads"], n_ff=SMALL["n_ff"], vocab=lcfg.vocab_size,
        qtype=GGMLType.Q4_K, recipe="Q4_K_M", arch="glm4", device="cpu")
    geo = (lambda c: (c.rope.n_dims, c.rope.mode, c.rope.freq_base, c.head_dim, c.rms_eps))
    assert geo(mcfg) == geo(lcfg)

    def desc(v):
        if isinstance(v, QTensor):
            return (v.ggml_type, v.in_features, v.out_features)
        return tuple(v.shape)

    for lw, mw in zip(loaded["layers"], made["layers"]):
        assert {k: desc(v) for k, v in lw.items()} == {k: desc(v) for k, v in mw.items()}
    assert desc(loaded["output"]) == desc(made["output"])


@pytest.fixture
def chain_reference(monkeypatch):
    """llm_tpu with its chained kernels and flash kernels interpreted."""
    for k, v in (("LLM_TPU_CHAIN", "1"), ("LLM_TPU_CHAIN_FORCE", "interpret"),
                 ("LLM_TPU_FLASH_FORCE", "interpret")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def test_chain_runs_only_the_lm_head(glm4_ggufs, chain_reference, monkeypatch):
    """chain=True on the 256-wide Q8_0 glm4: a decode step runs K6 for the
    lm_head alone (the biases bar the heads, the post-norms the tails, as
    the reference's gates bar them); its logits at 2e-4 of llm_tpu's
    chained Context, greedy tokens equal."""
    calls = []
    real = cuda_qmm_chain.qmm_chain_plain
    monkeypatch.setattr(cuda_qmm_chain, "qmm_chain_plain",
                        lambda *a, **kw: (calls.append(kw["pres"]), real(*a, **kw))[1])
    path = glm4_ggufs[0]["q8_wide"]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu", chain=True)
    layers = ctx.params["layers"]
    assert not any(cuda_qmm_chain.head_eligible(layer) or cuda_qmm_chain.tail_eligible(layer)
                   for layer in layers)
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    assert calls == []  # a 9-token step runs unchained
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    assert calls == [("norm",)]  # the lm_head
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, 4) == ref.generate_loop(nxt, 4)
