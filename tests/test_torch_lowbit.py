"""Q3_K_M and Q2_K models through both packages, on the CPU.

A tiny transformers llama (256 wide, 2 layers, 4 query heads over one KV
head, so that the Q2_K recipe's attn_v is Q4_K as at LLAMA3_8B's 4 query
heads a KV head), converted by llm_tpu's convert_hf_llama and quantized by
llm_tpu's quantize_model to Q3_K_M (Q3_K with Q5_K attn_v and Q4_K
ffn_down in layers 0-1, Q6_K lm_head) and to Q2_K (Q2_K with Q4_K attn_v,
Q3_K ffn_down in the use_more_bits layers). Both packages' load_params read
the same planes; both Contexts give the same greedy tokens and logits
within 2e-4 in f32 (test_torch_engine.py's tolerance), the port's
quantized matmuls on the plain versions of K1/K2 (gs 16 nibble planes for
Q2_K and Q3_K), with gdot (K5) and chain (K6) against llm_tpu's
interpreted kernels, and with use_planes=False (every matrix dequantized
at load) against llm_tpu's dense load. Then the type mix of
tools/synth_gguf.py's files and of models/synthetic.py's recipes against
llm_tpu's tensor_type_for."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.constants import GGMLType as JaxGGMLType
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models.loader import load_params as jax_load_params
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model, tensor_type_for

from llm_tpu_torch.gguf.constants import GGMLType
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.loader import load_params
from llm_tpu_torch.models.synthetic import RECIPES, make_synthetic_model
from llm_tpu_torch.ops import cuda_qmm, cuda_qmm_chain, qmatmul
from llm_tpu_torch.quant.qtensor import QTensor
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.tools import synth_gguf

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
TOL = dict(atol=2e-4, rtol=2e-4)
FTYPES = ("Q3_K_M", "Q2_K")


@pytest.fixture(scope="module")
def lowbit_ggufs(tmp_path_factory):
    cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False, attention_bias=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp("lowbit")
    f32 = str(d / "f32.gguf")
    convert_hf_llama(model, f32)
    paths = {}
    for ftype in FTYPES:
        paths[ftype] = str(d / f"{ftype}.gguf")
        quantize_model(f32, paths[ftype], ftype)
    return paths


def _types(path):
    return {name: ti.ggml_type.name for name, ti in JaxGGUFReader(path).tensors.items()}


def test_files_hold_the_recipes_types(lowbit_ggufs):
    q3, q2 = _types(lowbit_ggufs["Q3_K_M"]), _types(lowbit_ggufs["Q2_K"])
    assert q3["blk.0.attn_q.weight"] == "Q3_K" and q3["blk.0.attn_v.weight"] == "Q5_K"
    assert q3["blk.1.ffn_down.weight"] == "Q4_K" and q3["output.weight"] == "Q6_K"
    assert q2["blk.0.ffn_gate.weight"] == "Q2_K" and q2["blk.0.attn_v.weight"] == "Q4_K"
    assert q2["blk.0.ffn_down.weight"] == "Q3_K"  # use_more_bits


@pytest.mark.parametrize("ftype", FTYPES)
def test_load_params_planes_equal_reference(lowbit_ggufs, ftype):
    """Every matrix of both layers: the same planes in both packages; gate
    and up fused into gs 16 nibble planes (QKV stays unfused: attn_v's
    type differs)."""
    path = lowbit_ggufs[ftype]
    jp, _ = jax_load_params(JaxGGUFReader(path))
    tp, _ = load_params(GGUFReader(path), device="cpu")
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert set(jl) == set(tl) and "attn_qkv_fused" not in tl
        for key, t in tl.items():
            if isinstance(t, QTensor):
                j = jl[key]
                assert (t.layout, t.group_size, t.zp) == (j.layout, j.group_size, j.zp), key
                for f in ("qs", "scales", "mins"):
                    a, b = getattr(t, f), getattr(j, f)
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert np.array_equal(a.numpy(), np.asarray(b)), (key, f)
        gu = tl["ffn_gateup_fused"]
        assert (gu.layout, gu.group_size) == ("p4", 16)


def _f32(monkeypatch):
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def _compare(ref, ctx):
    """Prefill logits, one decode step, then 8 greedy tokens."""
    assert ref.decode(JaxBatch.text(PROMPT)) == 0
    assert ctx.decode(Batch.text(PROMPT)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **TOL)
    first = int(np.argmax(ref.get_logits()))
    assert int(np.argmax(ctx.get_logits())) == first
    assert ref.decode(JaxBatch.one(first)) == 0
    assert ctx.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, 8) == ref.generate_loop(nxt, 8)


@pytest.mark.parametrize("ftype", FTYPES)
def test_engine_matches_reference(lowbit_ggufs, monkeypatch, ftype):
    _f32(monkeypatch)
    path = lowbit_ggufs[ftype]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    _compare(ref, ctx)


def test_engine_chain_gdot_matches_reference(lowbit_ggufs, monkeypatch):
    """Q3_K_M with chain=True, gdot=True against llm_tpu's chained and
    group-factored kernels in interpret mode: K6 takes each layer's tail
    (a Q3_K o_proj and gate+up beside a Q4_K down) and the lm_head, K5 the
    unfused Q3_K attn_q and attn_k, at group size 16."""
    _f32(monkeypatch)
    for k, v in (("LLM_TPU_CHAIN", "1"), ("LLM_TPU_CHAIN_FORCE", "interpret"),
                 ("LLM_TPU_GDOT", "force"), ("LLM_TPU_FLASH_FORCE", "interpret")):
        monkeypatch.setenv(k, v)
    calls = {"K6": 0, "K5": 0}
    for mod, name, key in ((cuda_qmm_chain, "qmm_chain_plain", "K6"),
                           (cuda_qmm, "qmm_gdot_plain", "K5")):
        def counted(*a, _fn=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    jax_qmatmul.set_backend("pallas", interpret=True)
    try:
        path = lowbit_ggufs["Q3_K_M"]
        ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
        ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                      chain=True, gdot=True)
        _compare(ref, ctx)
    finally:
        jax_qmatmul.set_backend("auto")
    # the 10-token prompt (T > 8: no chain) takes K5 for its five p4
    # matmuls a layer (attn_q, attn_k, o_proj, gate+up, down; the Q5_K
    # attn_v is int8: K2); each of the 9 decode steps runs both tails and
    # the lm_head on K6, attn_q and attn_k of both layers on K5
    assert calls == {"K6": 9 * 3, "K5": 2 * 5 + 9 * 4}


def test_dense_load_matches_reference(lowbit_ggufs, monkeypatch):
    """use_planes=False in both packages on the Q3_K_M file: every matrix
    dequantized to dense f32 at load (the CLI's --no-planes; each type's
    dense weights against llm_tpu's in test_torch_qtensor.py)."""
    _f32(monkeypatch)
    path = lowbit_ggufs["Q3_K_M"]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32, use_planes=False)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                  use_planes=False)
    assert not any(isinstance(v, QTensor) for layer in ctx.params["layers"]
                   for v in layer.values())
    _compare(ref, ctx)


@pytest.mark.parametrize("ftype", list(RECIPES))
def test_synth_gguf_types_follow_the_reference_recipe(tmp_path, ftype):
    """tools/synth_gguf.py's file: each tensor's type is llm_tpu's
    tensor_type_for at the file's n_gqa (4: LLAMA3_8B's), the file type
    its ftype's, and both packages' loaders read its planes alike."""
    path = str(tmp_path / f"{ftype}.gguf")
    n_layers = 8  # use_more_bits: layers 0, 2, 5, 7
    info = synth_gguf.write_llama(path, n_layers=n_layers, n_embd=256, n_heads=4,
                                  n_kv_heads=1, n_ff=512, n_vocab=512, ftype=ftype)
    r = JaxGGUFReader(path)
    from llm_tpu.gguf.constants import FileType
    from llm_tpu_torch.gguf.constants import FileType as PortFileType
    # llama.cpp's file type ids; llm_tpu's enum lacks those of IQ2_XXS,
    # IQ1_M, TQ1_0 and TQ2_0 (19, 31, 36, 37)
    want_ft = FileType[f"MOSTLY_{ftype}"] if f"MOSTLY_{ftype}" in FileType.__members__ \
        else PortFileType[f"MOSTLY_{ftype}"]
    assert r.get("general.file_type") == want_ft
    for name, ti in r.tensors.items():
        if ti.ggml_type == JaxGGMLType.F32:
            continue
        want = tensor_type_for(name, tuple(ti.shape), ftype, n_layers, n_gqa=4)
        assert ti.ggml_type == want, (name, ti.ggml_type.name, want.name)
    assert sum(info["tensors"].values()) == len(r.tensors)
    jp, _ = jax_load_params(r)
    tp, _ = load_params(GGUFReader(path), device="cpu")
    out = tp["output"]
    assert np.array_equal(out.qs.numpy(), np.asarray(jp["output"].qs))


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_synthetic_recipe_types_follow_the_reference(recipe):
    """make_synthetic_model(recipe=) on the card's path (planes made by a
    generator, here on the CPU): each matrix takes llm_tpu's
    tensor_type_for type (8 layers, 4 query heads a KV head), the lm_head
    and the embedding table too, Q2_K and Q3_K as nibble planes at group
    size 16."""
    n_layers = 8
    params, _ = make_synthetic_model(n_embd=256, n_layers=n_layers, n_heads=4, n_kv_heads=1,
                                     n_ff=512, vocab=512, qtype=GGMLType.Q4_K, device="cpu",
                                     on_device=True, recipe=recipe, fuse=False)
    for il, layer in enumerate(params["layers"]):
        for key, qt in layer.items():
            if not isinstance(qt, QTensor):
                continue
            name = f"blk.{il}.{key}.weight"
            want = tensor_type_for(name, (qt.in_features, qt.out_features), recipe, n_layers,
                                   n_gqa=4)
            assert qt.ggml_type.name == want.name, (name, qt.ggml_type.name, want.name)
            if want.name in ("Q2_K", "Q3_K"):
                assert (qt.layout, qt.group_size, qt.zp) == ("p4", 16, 4 * (want.name == "Q3_K"))
    for key, name in (("output", "output.weight"), ("tok_embd", "token_embd.weight")):
        want = tensor_type_for(name, (256, 512), recipe, n_layers, n_gqa=4)
        assert params[key].ggml_type.name == want.name, (key, want.name)
