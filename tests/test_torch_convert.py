"""params_from_reference / config_from_reference against llm_tpu's config:
every reference ModelConfig field the port does not model must be at the
reference's default, or the conversion raises (a tree re-laid shard-major
for a tp mesh, fused_tp = 2, ran silently wrong before); check_supported
refuses top-level tensors that the port's forward would ignore; the
reference's default config still converts."""

import dataclasses

import numpy as np
import pytest
import torch

from llm_tpu.gguf.constants import GGMLType
from llm_tpu.models.config import ModelConfig as JaxModelConfig
from llm_tpu.models.synthetic import make_synthetic_model as jax_make_synthetic_model
from llm_tpu.parallel.sharding import interleave_fused
from llm_tpu.quant.qtensor import QTensor as JaxQTensor

from llm_tpu_torch.convert_params import (UNMODELED_DEFAULTS, config_from_reference,
                                          params_from_reference)
from llm_tpu_torch.models.config import ModelConfig
from llm_tpu_torch.models.transformer import check_supported

GEO = dict(n_embd=256, n_layers=2, n_heads=4, n_kv_heads=2, n_ff=512, vocab=256)


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


@pytest.fixture(scope="module")
def q8_model():
    return jax_make_synthetic_model(qtype=GGMLType.Q8_0, seed=3, **GEO)


def test_unmodeled_table_is_the_reference_defaults():
    """The port's table lists exactly the reference fields its config lacks,
    each with the reference's default."""
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    ref = {f.name: f for f in dataclasses.fields(JaxModelConfig)}
    assert set(UNMODELED_DEFAULTS) == set(ref) - port
    for name, default in UNMODELED_DEFAULTS.items():
        assert ref[name].default == default, name


def test_interleaved_tp2_tree_raises(q8_model):
    """The tree a tp=2 mesh Context holds: fused QKV and gate+up re-laid
    shard-major, cfg.fused_tp = 2. llm_tpu's logits on it equal its
    unsharded ones; the port would split the planes segment-major, so it
    must refuse the config."""
    jp, jcfg = q8_model
    sharded, tp = interleave_fused(jp, jcfg, 2)
    assert tp == 2
    with pytest.raises(NotImplementedError, match="fused_tp"):
        params_from_reference(_to_numpy(sharded), dataclasses.replace(jcfg, fused_tp=tp))


def _off_default(name, default, jcfg):
    if name == "rope_swa":
        return jcfg.rope
    if default is None:
        return (1, 0)
    if isinstance(default, bool):
        return not default
    if isinstance(default, str):
        return "sigmoid"
    return default + 1


@pytest.mark.parametrize("name", sorted(UNMODELED_DEFAULTS))
def test_unmodeled_field_off_default_raises(q8_model, name):
    _, jcfg = q8_model
    cfg = dataclasses.replace(jcfg, **{name: _off_default(name, UNMODELED_DEFAULTS[name], jcfg)})
    with pytest.raises(NotImplementedError, match=name):
        config_from_reference(cfg)


def test_default_config_converts(q8_model):
    """The reference's own config, every unmodeled field at its default,
    converts, each field the port models carried over (the converted model
    running like llm_tpu's is test_torch_engine.py's
    test_params_from_reference_synthetic)."""
    _, jcfg = q8_model
    cfg = config_from_reference(jcfg)
    for f in dataclasses.fields(ModelConfig):
        want = getattr(jcfg, f.name)
        if f.name == "rope":
            assert dataclasses.asdict(cfg.rope) == dataclasses.asdict(want)
        elif want is not None:
            assert getattr(cfg, f.name) == want, f.name


def test_gemma2_config_converts(tmp_path):
    """A gemma2 config as llm_tpu's config_from_gguf reads it (the window
    on every other layer, both softcaps, gelu, the embedding scale, NEOX
    rope) converts, swa_pattern with it; its layer_is_swa is the
    reference's at every layer, and the port's own config_from_gguf reads
    the same file into the same config."""
    from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
    from llm_tpu.gguf.writer import GGUFWriter as JaxGGUFWriter
    from llm_tpu.models.config import config_from_gguf as jax_config_from_gguf

    from llm_tpu_torch.gguf.reader import GGUFReader
    from llm_tpu_torch.models.config import config_from_gguf

    path = str(tmp_path / "gemma2.gguf")
    w = JaxGGUFWriter(path, arch="gemma2")
    for key, val in (("context_length", 8192), ("embedding_length", 64), ("block_count", 5),
                     ("feed_forward_length", 128), ("attention.head_count", 4),
                     ("attention.head_count_kv", 2), ("attention.key_length", 32),
                     ("attention.value_length", 32), ("attention.sliding_window", 8),
                     ("attention.layer_norm_rms_epsilon", 1e-6), ("vocab_size", 96),
                     ("attn_logit_softcapping", 50.0), ("final_logit_softcapping", 30.0)):
        w.add_kv(f"gemma2.{key}", val)
    w.write()
    jcfg = jax_config_from_gguf(JaxGGUFReader(path))
    assert jcfg.swa_pattern == 2
    cfg = config_from_reference(jcfg)
    assert cfg == config_from_gguf(GGUFReader(path))
    assert (cfg.swa_pattern, cfg.swa_window, cfg.attn_softcap, cfg.act) == (2, 8, 50.0, "gelu")
    assert [cfg.layer_is_swa(il) for il in range(5)] == \
        [jcfg.layer_is_swa(il) for il in range(5)] == [True, False, True, False, True]


@pytest.mark.parametrize("key", ["pos_embd", "tok_norm", "output_norm_b", "output_b"])
def test_check_supported_refuses_unused_top_level_tensors(q8_model, key):
    """The LayerNorm graphs' top-level tensors (learned positions, the
    embedding norm, the output norm's and lm_head's biases) are read by the
    forward and pass; beside each, a tensor that no forward of the port
    reads (the reference's per-layer embedding table of gemma3n) is refused
    by name."""
    jp, jcfg = q8_model
    params, cfg = params_from_reference(_to_numpy(jp), jcfg)
    check_supported(params, cfg)
    check_supported({**params, key: None}, cfg)  # an absent tensor
    check_supported({**params, key: torch.zeros(cfg.n_embd)}, cfg)
    with pytest.raises(NotImplementedError, match="per_layer_token_embd"):
        check_supported({**params, key: torch.zeros(cfg.n_embd),
                         "per_layer_token_embd": torch.zeros(cfg.n_embd)}, cfg)
