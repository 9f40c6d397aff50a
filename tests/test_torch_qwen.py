"""qwen2 (QKV biases) and qwen3 (per-head qk-norm) through the port against
llm_tpu on the CPU.

- test_archs.py's tiny transformers Qwen2 and Qwen3 (head_dim 24),
  converted by llm_tpu's convert_hf_llama: both packages' configs equal;
  the port's load_params and forward against llm_tpu's (flash kernels
  interpreted) in f32 at 2e-4 and against transformers at test_archs.py's
  3e-3; the two Contexts' greedy tokens equal.
- chain=True on 256-wide Q8_0 copies (K6's tile gate takes K % 256 and N %
  128) against llm_tpu's chained Context (LLM_TPU_CHAIN=1,
  LLM_TPU_CHAIN_FORCE=interpret) in f32 at 2e-4, well inside the chain
  tests' 3e-2: on qwen3 a decode step runs K6 for every head (qk-norm after
  the chained QKV), every tail and the lm_head; on qwen2 the QKV biases keep
  every head unchained in both packages (their head_eligible agree), the
  tails and the lm_head chained."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models.config import config_from_gguf as jax_config_from_gguf
from llm_tpu.models.loader import load_params as jax_load_params
from llm_tpu.ops import pallas_qmm_chain as jax_chain
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model

from llm_tpu_torch.convert_params import config_from_reference
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.config import config_from_gguf
from llm_tpu_torch.models.loader import load_params
from llm_tpu_torch.ops import cuda_qmm_chain, qmatmul
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context

from test_model_vs_hf import _run_ours
from test_torch_gemma2 import _port_forward

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # the engine's f32 tolerance
HF_TOL = dict(atol=3e-3, rtol=3e-3)   # test_archs.py's qwen2 / qwen3 cases
TOKENS = [5, 17, 60, 2, 33, 42, 7, 81, 64]
ARCHS = ["qwen2", "qwen3"]


def hf_qwen(arch: str, hidden=64, ff=112, head_dim=24, vocab=97):
    """test_archs.py's tiny Qwen2 (biases) or Qwen3 (qk-norm, head_dim 24)."""
    common = dict(vocab_size=vocab, hidden_size=hidden, intermediate_size=ff,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=128, rope_theta=10000.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    if arch == "qwen2":
        return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**common)).eval()
    return transformers.Qwen3ForCausalLM(
        transformers.Qwen3Config(head_dim=head_dim, **common)).eval()


@pytest.fixture(scope="module")
def qwen_ggufs(tmp_path_factory):
    """{arch: (f32 GGUF, transformers model), arch + "_q8": the 256-wide
    model's Q8_0 GGUF (4 heads over 2 of 64, ff 512, vocab 256)}."""
    d = tmp_path_factory.mktemp("qwen")
    out = {}
    for arch in ARCHS:
        model = hf_qwen(arch)
        out[arch] = (str(d / f"{arch}.gguf"), model)
        convert_hf_llama(model, out[arch][0], arch=arch)
        wide = str(d / f"{arch}_wide.gguf")
        convert_hf_llama(hf_qwen(arch, hidden=256, ff=512, head_dim=64, vocab=256), wide,
                         arch=arch)
        out[arch + "_q8"] = (str(d / f"{arch}_q8.gguf"), None)
        quantize_model(wide, out[arch + "_q8"][0], "Q8_0")
    return out


@pytest.fixture
def f32_flash_interpreted(monkeypatch):
    """llm_tpu in f32 with its flash kernels interpreted; the port in f32."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


@pytest.mark.parametrize("key", ["qwen2", "qwen3", "qwen2_q8", "qwen3_q8"])
def test_config_is_the_reference(qwen_ggufs, key):
    path = qwen_ggufs[key][0]
    jcfg = jax_config_from_gguf(JaxGGUFReader(path))
    cfg = config_from_gguf(GGUFReader(path))
    assert cfg == config_from_reference(jcfg)
    assert cfg.rope.mode == ROPE_TYPE_NEOX and cfg.n_expert == 0
    assert cfg.attn_bias == key.startswith("qwen2") and cfg.qk_norm == key.startswith("qwen3")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_and_transformers(qwen_ggufs, f32_flash_interpreted, arch):
    path, model = qwen_ggufs[arch]
    params, _ = load_params(GGUFReader(path), dense_dtype=torch.float32, device="cpu")
    want_keys = {"attn_q_b", "attn_k_b", "attn_v_b"} if arch == "qwen2" else \
        {"attn_q_norm", "attn_k_norm"}
    assert all(want_keys <= set(layer) for layer in params["layers"])
    got = _port_forward(path, TOKENS)
    want = _run_ours(path, TOKENS)
    assert got.shape == want.shape == (len(TOKENS), 97)
    np.testing.assert_allclose(got, want, **F32_TOL)
    with torch.no_grad():
        hf = model(torch.tensor([TOKENS])).logits[0].numpy()
    np.testing.assert_allclose(got, hf, **HF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_reference(qwen_ggufs, f32_flash_interpreted, arch):
    path = qwen_ggufs[arch][0]
    ref = JaxContext(JaxGGUFReader(path), n_cells=64, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=64, dtype=torch.float32, device="cpu")
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(first, 12) == ref.generate_loop(first, 12)


@pytest.fixture
def chain_reference(monkeypatch):
    """llm_tpu with its chained kernels and flash kernels interpreted, both
    packages in f32."""
    for k, v in (("LLM_TPU_CHAIN", "1"), ("LLM_TPU_CHAIN_FORCE", "interpret"),
                 ("LLM_TPU_FLASH_FORCE", "interpret")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def chained_engines(path, monkeypatch):
    """llm_tpu's and the port's chained Contexts on path: the prompt's logits
    (a 9-token step: unchained), one decode step's (its K6 boundaries, from
    the plain version's calls), and generate_loop's 8 greedy tokens, each at
    2e-4. Returns the step's calls and the port's Context."""
    calls = []
    real = cuda_qmm_chain.qmm_chain_plain
    monkeypatch.setattr(cuda_qmm_chain, "qmm_chain_plain",
                        lambda *a, **kw: (calls.append(kw["pres"]), real(*a, **kw))[1])
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu", chain=True)
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    assert calls == []
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    step = list(calls)
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, 8) == ref.generate_loop(nxt, 8)
    return step, ctx


def test_qwen3_chain_matches_reference(qwen_ggufs, chain_reference, monkeypatch):
    """Every head (rmsnorm -> fused QKV, then qk-norm), every tail and the
    lm_head run K6 on qwen3, as in llm_tpu's chained Context."""
    step, ctx = chained_engines(qwen_ggufs["qwen3_q8"][0], monkeypatch)
    n = ctx.cfg.n_layers
    assert all(cuda_qmm_chain.head_eligible(layer) and cuda_qmm_chain.tail_eligible(layer)
               for layer in ctx.params["layers"])
    assert step == [("norm",), ("cast", "res_norm", "swiglu")] * n + [("norm",)]


def test_qwen2_biases_keep_the_head_unchained(qwen_ggufs, chain_reference, monkeypatch):
    """qwen2's QKV biases bar K6's head in both packages (the reference's
    _HEAD_BANNED); the tails and the lm_head still chain."""
    path = qwen_ggufs["qwen2_q8"][0]
    jp, _ = jax_load_params(JaxGGUFReader(path))
    tp, _ = load_params(GGUFReader(path), device="cpu")
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert "attn_qkv_fused" in tl and "attn_q_b" in tl
        assert cuda_qmm_chain.head_eligible(tl) == jax_chain.head_eligible(jl) is False
        assert cuda_qmm_chain.head_eligible({k: v for k, v in tl.items()
                                             if k not in ("attn_q_b", "attn_k_b", "attn_v_b")})
        assert cuda_qmm_chain.tail_eligible(tl) == jax_chain.tail_eligible(jl) is True
    step, ctx = chained_engines(path, monkeypatch)
    assert step == [("cast", "res_norm", "swiglu")] * ctx.cfg.n_layers + [("norm",)]
