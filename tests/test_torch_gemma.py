"""gemma (v1) and K6's gelu (GeGLU) term through the port against llm_tpu
on the CPU.

- test_archs.py's tiny transformers Gemma (4 heads over 2 of 16, tied
  embeddings, gelu_pytorch_tanh), converted by llm_tpu's convert_hf_llama
  (its (1 + w) norms): both packages' configs equal; the port's
  load_params and forward against llm_tpu's (flash kernels interpreted) in
  f32 at 2e-4 and against transformers at test_archs.py's 3e-3; the two
  Contexts' greedy tokens equal.
- K6's plain version with the "geglu" boundary (layer_tail(act="gelu"))
  against llm_tpu's layer_tail(act="gelu") -> _chain_kernel in interpret
  mode at B = 1 and 8: f32 at 2e-4, bf16 at test_torch_chain.py's 3e-2;
  and apart from silu, so the activation is live.
- chain=True on a 256-wide Q8_0 Gemma (K6's tile gate takes K % 256 and N %
  128) against llm_tpu's chained Context (LLM_TPU_CHAIN=1,
  LLM_TPU_CHAIN_FORCE=interpret) in f32 at 2e-4: a decode step runs K6 on
  every head, a GeGLU tail on every layer and the lm_head."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.constants import GGMLType
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
from llm_tpu_torch.ops import qmatmul
from llm_tpu_torch.ops.cuda_qmm_chain import layer_tail
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context

from test_model_vs_hf import _run_ours
from test_torch_chain import EPS, TOL_BF16, TOL_F32, TYPES, _rel, _tail_case
from test_torch_gemma2 import _port_forward
from test_torch_qwen import chain_reference, chained_engines  # noqa: F401 (a fixture)

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # the engine's f32 tolerance
HF_TOL = dict(atol=3e-3, rtol=3e-3)   # test_archs.py's gemma (v1) case
TOKENS = [5, 17, 60, 2, 33, 42, 7, 81, 64]


def hf_gemma(hidden=64, ff=112, head_dim=16, vocab=97):
    """test_archs.py's tiny Gemma."""
    cfg = transformers.GemmaConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=ff, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=head_dim,
        max_position_embeddings=128, rope_theta=10000.0, tie_word_embeddings=True,
        hidden_activation="gelu_pytorch_tanh")
    torch.manual_seed(0)
    return transformers.GemmaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def gemma_ggufs(tmp_path_factory):
    """{"f32": the tiny model's GGUF, "q8": the 256-wide model's Q8_0 GGUF
    (4 heads over 2 of 64, ff 512, vocab 256)}, and the tiny model."""
    d = tmp_path_factory.mktemp("gemma")
    small = hf_gemma()
    paths = {"f32": str(d / "f32.gguf"), "q8": str(d / "q8.gguf")}
    convert_hf_llama(small, paths["f32"], arch="gemma")
    wide = str(d / "wide.gguf")
    convert_hf_llama(hf_gemma(hidden=256, ff=512, head_dim=64, vocab=256), wide, arch="gemma")
    quantize_model(wide, paths["q8"], "Q8_0")
    return paths, small


@pytest.fixture
def f32_flash_interpreted(monkeypatch):
    """llm_tpu in f32 with its flash kernels interpreted; the port in f32."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def test_config_is_the_reference(gemma_ggufs):
    for path in gemma_ggufs[0].values():
        jcfg = jax_config_from_gguf(JaxGGUFReader(path))
        cfg = config_from_gguf(GGUFReader(path))
        assert cfg == config_from_reference(jcfg)
        assert cfg.arch == "gemma" and cfg.act == "gelu" and cfg.rope.mode == ROPE_TYPE_NEOX
        assert cfg.embedding_scale == cfg.n_embd ** 0.5 and cfg.swa_window == 0
        assert cfg.attn_softcap == cfg.final_softcap == 0.0


def test_forward_matches_reference_and_transformers(gemma_ggufs, f32_flash_interpreted):
    paths, small = gemma_ggufs
    got = _port_forward(paths["f32"], TOKENS)
    want = _run_ours(paths["f32"], TOKENS)
    assert got.shape == want.shape == (len(TOKENS), 97)
    np.testing.assert_allclose(got, want, **F32_TOL)
    with torch.no_grad():
        hf = small(torch.tensor([TOKENS])).logits[0].numpy()
    np.testing.assert_allclose(got, hf, **HF_TOL)


def test_engine_greedy_matches_reference(gemma_ggufs, f32_flash_interpreted):
    path = gemma_ggufs[0]["f32"]
    ref = JaxContext(JaxGGUFReader(path), n_cells=64, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=64, dtype=torch.float32, device="cpu")
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(first, 12) == ref.generate_loop(first, 12)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("types", TYPES, ids=lambda t: "-".join(x.name for x in t))
def test_geglu_tail_matches_reference(types, B):
    """The chain with the gelu boundary, llm_tpu's _chain_kernel interpreted
    with act="gelu": f32 at 2e-4 (and apart from the SwiGLU tail), bf16 at
    3e-2."""
    pairs, att, xres, gamma = _tail_case(types, 11, B)
    want = jax_chain.layer_tail(jnp.asarray(att), jnp.asarray(xres), jnp.asarray(gamma),
                                *(p[0] for p in pairs), eps=EPS, act="gelu",
                                compute_dtype=jnp.float32, interpret=True)
    args = (torch.from_numpy(att), torch.from_numpy(xres), torch.from_numpy(gamma),
            *(p[1] for p in pairs))
    got = layer_tail(*args, eps=EPS, act="gelu", compute_dtype=torch.float32)
    assert got.shape == (B, att.shape[1]) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL_F32
    silu = layer_tail(*args, eps=EPS, act="silu", compute_dtype=torch.float32)
    assert _rel(silu.numpy(), want) > 100 * TOL_F32
    bf = jnp.bfloat16
    want = jax_chain.layer_tail(jnp.asarray(att, bf), jnp.asarray(xres, bf),
                                jnp.asarray(gamma), *(p[0] for p in pairs), eps=EPS, act="gelu",
                                compute_dtype=bf, interpret=True)
    tb = (lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, bf), np.float32))
          .to(torch.bfloat16))
    got = layer_tail(tb(att), tb(xres), torch.from_numpy(gamma), *(p[1] for p in pairs),
                     eps=EPS, act="gelu", compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) < TOL_BF16


def test_chain_matches_reference(gemma_ggufs, chain_reference, monkeypatch):
    """chain=True: every head, a GeGLU tail on every layer and the lm_head on
    K6's plain version, as llm_tpu's chained Context runs them."""
    step, ctx = chained_engines(gemma_ggufs[0]["q8"], monkeypatch)
    assert ctx.params["layers"][0]["ffn_gateup_fused"].ggml_type == GGMLType.Q8_0
    assert step == [("norm",), ("cast", "res_norm", "geglu")] * ctx.cfg.n_layers + [("norm",)]
