"""The RMS-norm llama graphs with small knobs through the port against
llm_tpu on the CPU.

- phi3 (fused QKV, gate+up packed in ffn_up), olmo2 (post-norms only, qk
  norm over the whole q and k), granite (embedding, residual, logit and
  attention scales), arcee (an ungated squared relu) and ernie4_5 (the
  llama graph): test_archs.py's tiny transformers models, converted by
  llm_tpu's convert_hf_llama (f32). xverse, internlm2, exaone and minicpm
  (minicpm's scales in the file): test_arch_oracles.py's hand-built GGUFs.
  Each arch: both packages' config_from_gguf agree; the port's forward
  against llm_tpu's (its flash kernels interpreted) at 2e-4, and against
  transformers or the float64 numpy oracle at 2e-4; the two Contexts'
  greedy tokens equal.
- The chain gate (models/transformer.py::chain_gate) admits a model
  exactly where the reference's use_chain does: a residual scale (granite,
  minicpm) or a squared relu (arcee, bitnet) runs unchained; so granite's
  chained Context gives its unchained logits bit for bit on a 256-wide
  Q8_0 copy that K6's tile gate would take.
GLM-4: test_torch_glm4.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models.config import config_from_gguf as jax_config_from_gguf
from llm_tpu.ops import pallas_qmm_chain as jax_chain
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model

from llm_tpu_torch.convert_params import config_from_reference
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.config import config_from_gguf
from llm_tpu_torch.models.transformer import chain_gate
from llm_tpu_torch.ops import cuda_qmm_chain, qmatmul
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORM
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context

from test_arch_oracles import _oracle_logits, _write
from test_model_vs_hf import _run_ours, _tiny_hf_llama
from test_tools import _test_vocab
from test_torch_gemma2 import _port_forward

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # the engine's f32 tolerance
TOKENS = [5, 17, 60, 2, 33, 42, 7, 81, 64]
# the reference's rope layout of each arch (llm_tpu/models/config.py)
ROPE = {"phi3": ROPE_TYPE_NEOX, "olmo2": ROPE_TYPE_NEOX, "granite": ROPE_TYPE_NORM,
        "arcee": ROPE_TYPE_NORM, "ernie4_5": ROPE_TYPE_NORM, "xverse": ROPE_TYPE_NORM,
        "internlm2": ROPE_TYPE_NORM, "exaone": ROPE_TYPE_NEOX, "minicpm": ROPE_TYPE_NORM}
HF_ARCHS = ("phi3", "olmo2", "granite", "arcee", "ernie4_5")
ORACLE_ARCHS = ("xverse", "internlm2", "exaone", "minicpm")
ARCHS = HF_ARCHS + ORACLE_ARCHS
# minicpm's scales as test_arch_oracles.py writes them (2 layers)
MINICPM_RES = 1.4 / np.sqrt(2)
MINICPM_KV = (("minicpm.embedding_scale", 12.0), ("minicpm.residual_scale", float(MINICPM_RES)),
              ("minicpm.logit_scale", 2.0))


def hf_model(arch: str, hidden=64, layers=2, vocab=97, ff=112):
    """test_archs.py's tiny transformers model of arch (hidden 64, 2 layers,
    4 heads over 2, ff 112; phi3's vocab 1097)."""
    common = dict(vocab_size=1097 if arch == "phi3" else vocab, hidden_size=hidden,
                  intermediate_size=ff, num_hidden_layers=layers, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128, rope_theta=10000.0,
                  tie_word_embeddings=False)
    if arch != "olmo2":
        common["pad_token_id"] = 0
    if arch == "granite":
        common.update(embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=8.0,
                      attention_multiplier=0.125)
    name = {"phi3": "Phi3", "olmo2": "Olmo2", "granite": "Granite", "arcee": "Arcee",
            "ernie4_5": "Ernie4_5", "bitnet": "BitNet"}[arch]
    cfg = getattr(transformers, f"{name}Config")(**common)
    torch.manual_seed(0)
    return getattr(transformers, f"{name}ForCausalLM")(cfg).eval()


@pytest.fixture(scope="module")
def knob_ggufs(tmp_path_factory):
    """{arch: (f32 GGUF path, transformers model or the oracle's tensors)}."""
    d = tmp_path_factory.mktemp("knobs")
    out = {}
    for arch in HF_ARCHS:
        model = hf_model(arch)
        path = str(d / f"{arch}.gguf")
        convert_hf_llama(model, path, arch=arch, vocab=_test_vocab(model.config.vocab_size))
        out[arch] = (path, model)
    for arch in ORACLE_ARCHS:
        path = str(d / f"{arch}.gguf")
        ten = _write(path, arch, extra_kv=MINICPM_KV if arch == "minicpm" else ())
        out[arch] = (path, ten)
    return out


@pytest.fixture
def f32_flash_interpreted(monkeypatch):
    """llm_tpu in f32 with its flash kernels interpreted; the port in f32."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def oracle(arch: str, ten) -> np.ndarray:
    """test_arch_oracles.py's float64 logits of TOKENS for its GGUF."""
    kw = dict(H=4, KV=2, neox=ROPE[arch] == ROPE_TYPE_NEOX)
    if arch == "minicpm":
        kw.update(emb_scale=12.0, res_scale=float(MINICPM_RES), logit_scale=0.5)
    return _oracle_logits(ten, TOKENS, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference(knob_ggufs, arch):
    path = knob_ggufs[arch][0]
    jcfg = jax_config_from_gguf(JaxGGUFReader(path))
    cfg = config_from_gguf(GGUFReader(path))
    assert cfg == config_from_reference(jcfg)
    assert cfg.arch == arch and cfg.rope.mode == ROPE[arch]
    if arch == "granite":
        assert (cfg.embedding_scale, cfg.residual_scale, cfg.logit_scale, cfg.attn_scale) == \
            (12.0, pytest.approx(0.22), 1 / 8.0, 0.125)
    if arch == "minicpm":
        assert (cfg.embedding_scale, cfg.logit_scale) == (12.0, 0.5)
        assert cfg.residual_scale == pytest.approx(MINICPM_RES)
    assert cfg.qk_norm_full == (arch == "olmo2")
    assert cfg.act == ("relu2" if arch == "arcee" else "silu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(knob_ggufs, f32_flash_interpreted, arch):
    """Every row of a 9-token prefill: the port's logits at 2e-4 of
    llm_tpu's, and of transformers' (or the numpy oracle's)."""
    path, ref_model = knob_ggufs[arch]
    got = _port_forward(path, TOKENS)
    want = _run_ours(path, TOKENS)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32_TOL)
    if arch in HF_ARCHS:
        with torch.no_grad():
            other = ref_model(torch.tensor([TOKENS])).logits[0].numpy()
    else:
        other = oracle(arch, ref_model)
    np.testing.assert_allclose(got, other, **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_reference(knob_ggufs, f32_flash_interpreted, arch):
    """Context.decode of the prompt and one step (logits at 2e-4), then 8
    greedy tokens through generate_loop, equal to llm_tpu's."""
    path = knob_ggufs[arch][0]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, 8) == ref.generate_loop(nxt, 8)


@pytest.fixture(scope="module")
def gate_ggufs(knob_ggufs, tmp_path_factory):
    """knob_ggufs with a tiny llama (which both gates chain) and a tiny
    bitnet (a gated squared relu) beside them."""
    d = tmp_path_factory.mktemp("gate")
    out = {arch: v[0] for arch, v in knob_ggufs.items()}
    for arch, model in (("llama", _tiny_hf_llama(hidden=64, layers=2, vocab=97)),
                        ("bitnet", hf_model("bitnet"))):
        out[arch] = str(d / f"{arch}.gguf")
        convert_hf_llama(model, out[arch], arch=arch)
    return out


@pytest.mark.parametrize("arch", ARCHS + ("llama", "bitnet"))
def test_chain_gate_is_the_reference_gate(gate_ggufs, arch, monkeypatch):
    """A decode step under LLM_TPU_CHAIN=1: llm_tpu's forward asks its
    per-layer head gate exactly when its model-wide use_chain holds (its
    gates are stubbed to refuse, so it then runs unchained on XLA); the
    port's chain_gate says the same for the same config. A residual scale
    or a squared relu refuses; the llama recipe with post-norms, biases or
    packed tensors passes the model-wide gate."""
    asked = []
    monkeypatch.setenv("LLM_TPU_CHAIN", "1")
    monkeypatch.setenv("LLM_TPU_CHAIN_FORCE", "interpret")
    monkeypatch.setattr(jax_chain, "head_eligible", lambda layer: asked.append(1) and False)
    monkeypatch.setattr(jax_chain, "tail_eligible", lambda layer: False)
    monkeypatch.setattr(jax_chain, "_is_kmajor_qt", lambda w: False)
    path = gate_ggufs[arch]
    _run_ours(path, [5])
    cfg = config_from_gguf(GGUFReader(path))
    assert chain_gate(cfg, True, 1) == bool(asked)
    assert chain_gate(cfg, True, 1) == (arch not in ("granite", "minicpm", "arcee", "bitnet"))
    assert not chain_gate(cfg, True, 9) and not chain_gate(cfg, False, 1)


@pytest.fixture
def chain_reference(monkeypatch):
    """llm_tpu with its chained kernels and flash kernels interpreted."""
    for k, v in (("LLM_TPU_CHAIN", "1"), ("LLM_TPU_CHAIN_FORCE", "interpret"),
                 ("LLM_TPU_FLASH_FORCE", "interpret")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def test_granite_chained_logits_are_the_unchained(tmp_path, chain_reference, monkeypatch):
    """A 256-wide granite quantized to Q8_0 (K6's tile gate takes every
    head, tail and the lm_head): under chain=True the port launches no K6
    (its residual scale refuses the model, as the reference's gate does)
    and gives chain=False's logits bit for bit, and llm_tpu's chained
    Context's at 2e-4, with the same greedy tokens."""
    calls = []
    real = cuda_qmm_chain.qmm_chain_plain
    monkeypatch.setattr(cuda_qmm_chain, "qmm_chain_plain",
                        lambda *a, **kw: (calls.append(kw["pres"]), real(*a, **kw))[1])
    f32 = str(tmp_path / "granite_f32.gguf")
    convert_hf_llama(hf_model("granite", hidden=256, vocab=256, ff=256), f32, arch="granite")
    path = str(tmp_path / "granite_q8.gguf")
    quantize_model(f32, path, "Q8_0")
    chained = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                      chain=True)
    plain = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    assert all(cuda_qmm_chain.tail_eligible(layer) and cuda_qmm_chain.chain_fits(
        [layer[k] for k in ("attn_output", "ffn_gateup_fused", "ffn_down")])
        for layer in chained.params["layers"])
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    for step in (JaxBatch.text(TOKENS[:4]), JaxBatch.one(9)):
        assert ref.decode(step) == 0
    for c in (chained, plain):
        assert c.decode(Batch.text(TOKENS[:4])) == 0 and c.decode(Batch.one(9)) == 0
    assert calls == []
    assert np.array_equal(chained.get_logits(), plain.get_logits())
    np.testing.assert_allclose(chained.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert chained.generate_loop(nxt, 4) == ref.generate_loop(nxt, 4)
    assert calls == []
