"""The LayerNorm graphs through the port against llm_tpu on the CPU.

- command-r (a parallel block on one shared norm, a logit scale), falcon,
  phi2 and gptj (parallel, the FFN on the attention's normed input),
  gptneox (parallel with its own ffn_norm), starcoder2 and stablelm (QKV
  biases), nemotron (an ungated squared relu), olmo (norms without
  parameters), gpt2 and starcoder (learned positions, no rope), bloom and
  mpt (ALiBi, no rope; bloom's embedding norm): test_archs.py's tiny
  transformers models, converted by llm_tpu's own converters (f32); orion
  (LayerNorm with biases): test_arch_oracles.py's hand-built GGUF. Each
  arch: both packages' config_from_gguf agree; the port's forward against
  llm_tpu's (its flash kernels interpreted) at 2e-4, and against
  transformers or the float64 numpy oracle at the reference test's 3e-3;
  the two Contexts' greedy tokens equal.
- ops/norms.py::layer_norm against llm_tpu's on seeded inputs, with and
  without weight and bias (olmo's has neither), f32 and bf16.
- cohere2 (NoPE global layers on the sliding-window ring) is refused by
  name.
- The scan decoder (Context(scan_layers=True)) on a tiny command-r and a
  tiny gptneox (its own ffn_norm, biases) gives the per-layer Context's
  logits and greedy tokens.
- chain=True on a 256-wide Q8_0 command-r whose heads and lm_head K6's
  gates would take: chain_gate refuses the LayerNorm graph as the
  reference's use_chain does, so no K6 runs and the logits are the
  unchained ones bit for bit.
Command-R's GGUF twin (tools/synth_gguf.py --arch command-r):
test_torch_command_r.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from llm_tpu.convert import hf_llama as jax_convert
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models.config import config_from_gguf as jax_config_from_gguf
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.ops.norms import layer_norm as jax_layer_norm
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model

from llm_tpu_torch.convert_params import config_from_reference
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.config import LN_ARCHS, config_from_gguf
from llm_tpu_torch.models.transformer import chain_gate, check_supported
from llm_tpu_torch.ops import cuda_qmm_chain, qmatmul
from llm_tpu_torch.ops.norms import layer_norm
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NONE, ROPE_TYPE_NORM
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context

from test_arch_oracles import _oracle_logits, _write
from test_model_vs_hf import _run_ours
from test_torch_gemma2 import _port_forward
from test_torch_flash_decode import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # the engine's f32 tolerance
ORACLE_TOL = dict(atol=3e-3, rtol=3e-3)  # test_archs.py's and test_arch_oracles.py's
TOKENS = [5, 17, 60, 2, 33, 42, 7, 81, 64]
# the reference's rope layout of each arch (llm_tpu/models/config.py)
ROPE = {"command-r": ROPE_TYPE_NORM, "falcon": ROPE_TYPE_NEOX, "phi2": ROPE_TYPE_NEOX,
        "gptneox": ROPE_TYPE_NEOX, "gptj": ROPE_TYPE_NORM, "starcoder2": ROPE_TYPE_NEOX,
        "stablelm": ROPE_TYPE_NEOX, "orion": ROPE_TYPE_NEOX, "nemotron": ROPE_TYPE_NEOX,
        "olmo": ROPE_TYPE_NORM, "gpt2": ROPE_TYPE_NONE, "starcoder": ROPE_TYPE_NONE,
        "bloom": ROPE_TYPE_NONE, "mpt": ROPE_TYPE_NONE}
PARALLEL = ("command-r", "falcon", "phi2", "gptneox", "gptj")
GELU = ("falcon", "phi2", "gptneox", "gptj", "starcoder2", "gpt2", "starcoder", "bloom", "mpt")
ARCHS = tuple(ROPE)
COMMON = dict(vocab_size=97, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
              rope_theta=10000.0)


def _random_biases(model):
    """transformers zero-initializes biases; test_archs.py draws them so
    that they count."""
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith(".bias"):
                prm.normal_(0, 0.05)
    return model


def hf_model(arch: str, hidden: int = 64, vocab: int = 97, ff: int = 112):
    """test_archs.py's tiny transformers model of arch, and the llm_tpu
    converter that writes it (hidden / vocab / ff: command-r's 256-wide
    copy for the chain test)."""
    T = transformers
    mpt_attn = T.models.mpt.configuration_mpt.MptAttentionConfig
    common = dict(COMMON, hidden_size=hidden, vocab_size=vocab, intermediate_size=ff)
    make = {
        "starcoder2": lambda: T.Starcoder2ForCausalLM(T.Starcoder2Config(
            **common, use_bias=True, tie_word_embeddings=False)),
        "command-r": lambda: T.CohereForCausalLM(T.CohereConfig(
            **common, pad_token_id=0, logit_scale=0.25)),
        "stablelm": lambda: T.StableLmForCausalLM(T.StableLmConfig(
            **common, partial_rotary_factor=0.5, use_qkv_bias=True, tie_word_embeddings=False,
            use_parallel_residual=False, layer_norm_eps=1e-5)),
        "olmo": lambda: T.OlmoForCausalLM(T.OlmoConfig(
            **common, pad_token_id=0, tie_word_embeddings=False)),
        "nemotron": lambda: T.NemotronForCausalLM(T.NemotronConfig(
            **common, pad_token_id=0, partial_rotary_factor=0.5, tie_word_embeddings=False)),
        "gpt2": lambda: T.GPT2LMHeadModel(T.GPT2Config(
            vocab_size=vocab, n_positions=128, n_embd=hidden, n_layer=2, n_head=4,
            activation_function="gelu_new")),
        "mpt": lambda: T.MptForCausalLM(T.MptConfig(
            vocab_size=vocab, d_model=hidden, n_heads=4, n_layers=2, expansion_ratio=2,
            max_seq_len=128, attn_config=mpt_attn(alibi=True, alibi_bias_max=8), no_bias=True)),
        "phi2": lambda: T.PhiForCausalLM(T.PhiConfig(
            **dict(common, num_key_value_heads=4), partial_rotary_factor=0.5,
            tie_word_embeddings=False, hidden_act="gelu_new", layer_norm_eps=1e-5)),
        "falcon": lambda: T.FalconForCausalLM(T.FalconConfig(
            vocab_size=vocab, hidden_size=hidden, num_hidden_layers=2, num_attention_heads=4,
            multi_query=True, parallel_attn=True, new_decoder_architecture=False, bias=False,
            alibi=False, rope_theta=10000.0, tie_word_embeddings=False)),
        "bloom": lambda: T.BloomForCausalLM(T.BloomConfig(
            vocab_size=vocab, hidden_size=hidden, n_head=4, n_layer=2, layer_norm_epsilon=1e-5,
            tie_word_embeddings=True)),
        "gptneox": lambda: T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=ff, num_hidden_layers=2,
            num_attention_heads=4, rotary_pct=0.5, max_position_embeddings=128,
            rope_theta=10000.0, use_parallel_residual=True, layer_norm_eps=1e-5,
            tie_word_embeddings=False, hidden_act="gelu")),
        "gptj": lambda: T.GPTJForCausalLM(T.GPTJConfig(
            vocab_size=vocab, n_positions=128, n_embd=hidden, n_layer=2, n_head=4,
            rotary_dim=8, activation_function="gelu_new", tie_word_embeddings=False)),
        "starcoder": lambda: T.GPTBigCodeForCausalLM(T.GPTBigCodeConfig(
            vocab_size=vocab, n_positions=128, n_embd=hidden, n_layer=2, n_head=4,
            multi_query=True, activation_function="gelu_pytorch_tanh")),
    }[arch]
    convert = {"gpt2": jax_convert.convert_hf_gpt2, "mpt": jax_convert.convert_hf_mpt,
               "phi2": jax_convert.convert_hf_phi2, "falcon": jax_convert.convert_hf_falcon,
               "bloom": jax_convert.convert_hf_bloom, "gptneox": jax_convert.convert_hf_gptneox,
               "gptj": jax_convert.convert_hf_gptj,
               "starcoder": jax_convert.convert_hf_starcoder}.get(
        arch, lambda m, path: jax_convert.convert_hf_llama(m, path, arch=arch))
    torch.manual_seed(0)
    model = make().eval()
    if arch in ("starcoder2", "stablelm", "gpt2", "phi2", "bloom", "gptneox", "gptj",
                "starcoder"):
        _random_biases(model)
    return model, convert


@pytest.fixture(scope="module")
def ln_ggufs(tmp_path_factory):
    """{arch: (f32 GGUF path, transformers model or the oracle's tensors)},
    each made on first use."""
    d = tmp_path_factory.mktemp("ln")
    made = {}

    def get(arch):
        if arch not in made:
            path = str(d / f"{arch}.gguf")
            if arch == "orion":
                made[arch] = (path, _write(path, "orion", ln=True))
            else:
                model, convert = hf_model(arch)
                convert(model, path)
                made[arch] = (path, model)
        return made[arch]

    return get


@pytest.fixture
def f32_flash_interpreted(monkeypatch):
    """llm_tpu in f32 with its flash kernels interpreted; the port in f32."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight,bias", [(True, True), (True, False), (False, False)],
                         ids=["w-b", "w", "nonparam"])
def test_layer_norm_is_the_reference(weight, bias, dtype):
    """Rows of 64 with a mean far from 0 (the centring matters), eps 1e-5:
    the port's layer_norm against llm_tpu's, in f32 within 1e-6 and in
    bf16 within one bf16 step (8e-3: the f32 results may round apart)."""
    rng = np.random.default_rng(7)
    x = rng.normal(3.0, 2.0, size=(5, 64)).astype(np.float32)
    w = rng.normal(1.0, 0.1, size=64).astype(np.float32) if weight else None
    b = rng.normal(0.0, 0.1, size=64).astype(np.float32) if bias else None
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jax_layer_norm(jx, None if w is None else jnp.asarray(w),
                                     None if b is None else jnp.asarray(b), 1e-5)
                      .astype(jnp.float32))
    got = layer_norm(tx, None if w is None else torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b), 1e-5)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_archs_are_the_ln_archs():
    assert set(ARCHS) == set(LN_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference(ln_ggufs, arch):
    path = ln_ggufs(arch)[0]
    jcfg = jax_config_from_gguf(JaxGGUFReader(path))
    cfg = config_from_gguf(GGUFReader(path))
    assert cfg == config_from_reference(jcfg)
    assert cfg.arch == arch and cfg.norm_kind == "ln" and cfg.rope.mode == ROPE[arch]
    assert cfg.parallel_residual == (arch in PARALLEL)
    assert cfg.act == ("gelu" if arch in GELU else "relu2" if arch == "nemotron" else "silu")
    assert cfg.nonparam_norm == (arch == "olmo")
    assert cfg.attn_bias == (arch in ("starcoder2", "stablelm", "phi2"))
    assert (cfg.alibi_max_bias > 0) == (arch in ("bloom", "mpt"))
    # command-r's logit scale multiplies the logits (granite divides)
    assert cfg.logit_scale == (0.25 if arch == "command-r" else 1.0)
    assert not chain_gate(cfg, True, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ln_ggufs, f32_flash_interpreted, arch):
    """Every row of a 9-token prefill: the port's logits at 2e-4 of
    llm_tpu's, and at 3e-3 of transformers' (or the numpy oracle's)."""
    path, ref_model = ln_ggufs(arch)
    got = _port_forward(path, TOKENS)
    want = _run_ours(path, TOKENS)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32_TOL)
    if arch == "orion":
        other = _oracle_logits(ref_model, TOKENS, H=4, KV=2, ln=True, neox=True)
    else:
        with torch.no_grad():
            other = ref_model(torch.tensor([TOKENS])).logits[0].numpy()
    np.testing.assert_allclose(got, other, **ORACLE_TOL)


def _contexts_agree(path, n_tokens=8, **kw):
    """Context.decode of the prompt and one step (logits at 2e-4 of
    llm_tpu's), then n_tokens greedy tokens through generate_loop, equal
    to llm_tpu's. Returns the port's Context."""
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu", **kw)
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, n_tokens) == ref.generate_loop(nxt, n_tokens)
    return ctx


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_reference(ln_ggufs, f32_flash_interpreted, arch):
    _contexts_agree(ln_ggufs(arch)[0])


def test_cohere2_is_refused_by_name(tmp_path):
    """cohere2's global layers run without rope on the sliding-window ring
    (nope_global_layers): its config converts, and the forward's check
    names what is missing."""
    model = transformers.Cohere2ForCausalLM(transformers.Cohere2Config(
        **dict(COMMON, num_hidden_layers=5), sliding_window=6, sliding_window_pattern=4,
        logit_scale=0.25, tie_word_embeddings=True, layer_norm_eps=1e-5)).eval()
    path = str(tmp_path / "cohere2.gguf")
    jax_convert.convert_hf_llama(model, path, arch="cohere2")
    cfg = config_from_reference(jax_config_from_gguf(JaxGGUFReader(path)))
    assert cfg.nope_global_layers and cfg.norm_kind == "ln" and cfg.parallel_residual
    with pytest.raises(NotImplementedError, match="NoPE"):
        check_supported({"layers": [{}] * cfg.n_layers}, cfg)
    with pytest.raises(NotImplementedError, match="cohere2"):
        config_from_gguf(GGUFReader(path))


@pytest.mark.parametrize("arch", ["command-r", "gptneox"])
def test_scan_is_the_per_layer_context(ln_ggufs, arch):
    """Context(scan_layers=True) stacks the layers (their norm and bias
    vectors as [L, n] leaves) and gives the per-layer Context's logits at
    2e-4 and its greedy tokens."""
    path = ln_ggufs(arch)[0]
    scan = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                   scan_layers=True)
    plain = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    stacked = scan.params["layers_stacked"]
    assert stacked is not None and not scan.params["layers"]
    assert stacked["attn_norm"].shape == (2, 64)
    if arch == "gptneox":
        assert stacked["ffn_norm_b"].shape == (2, 64) and stacked["attn_qkv_fused_b"].dim() == 2
    for c in (scan, plain):
        assert c.decode(Batch.text(TOKENS)) == 0
    np.testing.assert_allclose(scan.get_logits(), plain.get_logits(), **F32_TOL)
    first = int(np.argmax(plain.get_logits()))
    assert scan.generate_loop(first, 8) == plain.generate_loop(first, 8)


@pytest.fixture
def chain_reference(monkeypatch):
    """llm_tpu with its chained kernels and flash kernels interpreted."""
    for k, v in (("LLM_TPU_CHAIN", "1"), ("LLM_TPU_CHAIN_FORCE", "interpret"),
                 ("LLM_TPU_FLASH_FORCE", "interpret")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def test_command_r_chained_logits_are_the_unchained(tmp_path, chain_reference, monkeypatch):
    """A 256-wide command-r quantized to Q8_0, whose fused QKV heads and
    lm_head K6's per-layer gates take: under chain=True the port launches
    no K6 (LayerNorm and the parallel block refuse the model, as the
    reference's use_chain does) and gives chain=False's logits bit for
    bit, and llm_tpu's chained Context's at 2e-4, with the same greedy
    tokens."""
    calls = []
    real = cuda_qmm_chain.qmm_chain_plain
    monkeypatch.setattr(cuda_qmm_chain, "qmm_chain_plain",
                        lambda *a, **kw: (calls.append(kw["pres"]), real(*a, **kw))[1])
    model, convert = hf_model("command-r", hidden=256, vocab=256, ff=256)
    f32 = str(tmp_path / "command_r_f32.gguf")
    convert(model, f32)
    path = str(tmp_path / "command_r_q8.gguf")
    quantize_model(f32, path, "Q8_0")
    chained = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                      chain=True)
    plain = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    params = chained.params
    assert all(cuda_qmm_chain.head_eligible(layer) for layer in params["layers"])
    assert cuda_qmm_chain.is_kmajor_qt(params["output"])
    assert cuda_qmm_chain.chain_fits([params["output"]])
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
