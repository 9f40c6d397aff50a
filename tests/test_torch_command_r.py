"""Command-R (command-r) through the port against llm_tpu on the CPU: the
GGUF twin that chip_smoke.py loads on the card, at a small width.

- Command-R v01's full-depth config (a GGUF of its metadata, the LN eps
  under llama.cpp's layer_norm_epsilon) reads the same in both packages,
  its logit scale 0.0625 a multiplier, and is models/synthetic.py's
  command_r_config(**COMMAND_R_35B).
- tools/synth_gguf.py --arch command-r at 256 wide (two heads over two of
  128, G = 1 as Command-R's, ff 512): LayerNorm weights only and no
  ffn_norm, a tied Q6_K table and no output.weight, command-r.logit_scale;
  both packages' config_from_gguf agree; the port's forward against
  llm_tpu's (flash interpreted) at 2e-4 in f32 and the two Contexts'
  greedy tokens equal; make_synthetic_model(arch="command-r") makes the
  same keys, shapes and plane types."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.gguf.constants import Keys as JaxKeys
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.gguf.writer import GGUFWriter as JaxGGUFWriter
from llm_tpu.models.config import config_from_gguf as jax_config_from_gguf
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext

from llm_tpu_torch.convert_params import config_from_reference
from llm_tpu_torch.gguf.constants import GGMLType
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.config import config_from_gguf
from llm_tpu_torch.models.loader import load_params
from llm_tpu_torch.models.synthetic import (COMMAND_R_35B, command_r_config,
                                            make_synthetic_model)
from llm_tpu_torch.ops import qmatmul
from llm_tpu_torch.ops.rope import ROPE_TYPE_NORM
from llm_tpu_torch.quant.qtensor import QTensor
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.tools import synth_gguf

from test_model_vs_hf import _run_ours
from test_torch_gemma2 import _port_forward
from test_torch_flash_decode import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # the engine's f32 tolerance
TOKENS = [5, 17, 60, 2, 33, 42, 7, 81, 64]
# synth_gguf's command-r file at a small width; ff 512, a multiple of 256
# as Command-R's 22528, keeps ffn_down Q4_K / Q6_K
SMALL = dict(n_embd=256, n_heads=2, n_kv_heads=2, n_ff=512, n_vocab=768)


@pytest.fixture(scope="module")
def synth_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("command_r") / "command_r_synth.gguf")
    synth_gguf.write_llama(path, n_layers=2, seed=3, arch="command-r", **SMALL)
    return path


@pytest.fixture
def f32_flash_interpreted(monkeypatch):
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def test_full_depth_config_is_command_r_config(tmp_path):
    """Command-R v01's header (llm_tpu's writer, no tensors): both packages
    read the same config (eps: the reference reads only
    layer_norm_rms_epsilon, so llama.cpp's layer_norm_epsilon leaves both at
    1e-5), LayerNorm, the parallel block, the logit scale as a multiplier,
    G = 1; and it is the synthetic command_r_config(**COMMAND_R_35B)."""
    path = str(tmp_path / "command_r_header.gguf")
    w = JaxGGUFWriter(path, arch="command-r")
    a = (lambda k: k.format(arch="command-r"))
    for key, val in ((JaxKeys.LLM.CONTEXT_LENGTH, 8192), (JaxKeys.LLM.EMBEDDING_LENGTH, 8192),
                     (JaxKeys.LLM.BLOCK_COUNT, 40), (JaxKeys.LLM.FEED_FORWARD_LENGTH, 22528),
                     (JaxKeys.Attention.HEAD_COUNT, 64), (JaxKeys.Attention.HEAD_COUNT_KV, 64),
                     (JaxKeys.LLM.VOCAB_SIZE, 256000)):
        w.add_kv(a(key), np.uint32(val))
    w.add_kv(a(JaxKeys.Attention.LAYERNORM_EPS), np.float32(1e-5))
    w.add_kv(a(JaxKeys.Rope.FREQ_BASE), np.float32(10000.0))
    w.add_kv(a("{arch}.logit_scale"), np.float32(0.0625))
    w.write()
    cfg = config_from_reference(jax_config_from_gguf(JaxGGUFReader(path)))
    assert cfg == config_from_gguf(GGUFReader(path))
    assert (cfg.norm_kind, cfg.parallel_residual, cfg.logit_scale, cfg.rms_eps) == \
        ("ln", True, 0.0625, 1e-5)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.rope.mode) == \
        (64, 64, 128, ROPE_TYPE_NORM)
    assert cfg == command_r_config(**COMMAND_R_35B)


def test_synth_file_is_command_r(synth_path):
    """The file's tensors: one LayerNorm weight a layer and no bias, a tied
    Q6_K table (the lm_head's type) and no output.weight; its config is
    llm_tpu's."""
    r = GGUFReader(synth_path)
    names = set(r.tensors)
    assert "output.weight" not in names and not any(n.endswith(".bias") for n in names)
    assert not any("ffn_norm" in n for n in names)
    assert r.tensors["token_embd.weight"].ggml_type == GGMLType.Q6_K
    cfg = config_from_gguf(r)
    assert cfg == config_from_reference(jax_config_from_gguf(JaxGGUFReader(synth_path)))
    assert (cfg.arch, cfg.logit_scale, cfg.n_ff, cfg.n_rep) == ("command-r", 0.0625, 512, 1)


def test_forward_and_contexts_match_reference(synth_path, f32_flash_interpreted):
    """The port's forward of a 9-token prefill at 2e-4 of llm_tpu's; then
    each Context's prompt and one step (logits at 2e-4) and 4 greedy
    tokens, equal."""
    got, want = _port_forward(synth_path, TOKENS), _run_ours(synth_path, TOKENS)
    np.testing.assert_allclose(got, want, **F32_TOL)
    ref = JaxContext(JaxGGUFReader(synth_path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(synth_path), n_cells=32, dtype=torch.float32, device="cpu")
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, 4) == ref.generate_loop(nxt, 4)


def test_synthetic_model_is_the_synth_file(synth_path):
    """make_synthetic_model(arch="command-r", recipe="Q4_K_M") makes the
    keys, shapes and plane types that loading synth_gguf's file of the same
    geometry gives (the lm_head the table's K-major copy)."""
    loaded, lcfg = load_params(GGUFReader(synth_path), dense_dtype=torch.float32, device="cpu")
    made, mcfg = make_synthetic_model(
        n_embd=SMALL["n_embd"], n_layers=2, n_heads=SMALL["n_heads"],
        n_kv_heads=SMALL["n_kv_heads"], n_ff=SMALL["n_ff"], vocab=lcfg.vocab_size,
        qtype=GGMLType.Q4_K, recipe="Q4_K_M", arch="command-r", device="cpu")
    assert mcfg == command_r_config(SMALL["n_embd"], 2, SMALL["n_heads"], SMALL["n_kv_heads"],
                                    SMALL["n_ff"], lcfg.vocab_size)
    geo = (lambda c: (c.norm_kind, c.parallel_residual, c.logit_scale, c.rope.mode,
                      c.rope.freq_base, c.head_dim, c.rms_eps))
    assert geo(mcfg) == geo(lcfg)

    def desc(v):
        if isinstance(v, QTensor):
            return (v.ggml_type, v.in_features, v.out_features, v.kmajor)
        return tuple(v.shape)

    for lw, mw in zip(loaded["layers"], made["layers"]):
        assert {k: desc(v) for k, v in lw.items()} == {k: desc(v) for k, v in mw.items()}
    for key in ("tok_embd", "output", "output_norm"):
        assert desc(loaded[key]) == desc(made[key]), key
