"""The IQ grid and ternary types and the bitnet graph through both packages,
on the CPU.

tools/synth_gguf.py writes tiny files (256 wide, 2 layers, 4 query heads
over one KV head, so that the IQ recipes' attn_v is Q4_K as at LLAMA3_8B's
4 query heads a KV head) at llama.cpp's IQ2_XXS and IQ1_M recipes (IQ2_XXS
or IQ1_M with Q4_K attn_v, IQ3_XXS ffn_down in layers 0-1, a Q5_K lm_head,
a Q2_K table) and, with the bitnet graph (a gated squared relu, RMS
sub-norms before o_proj and ffn_down), at TQ2_0 and TQ1_0 (the base type
everywhere, a Q6_K lm_head). Both packages load the same planes (IQ1_M
int8 at group size 8, TQ1_0 / TQ2_0 nibbles at group size 256 with zero
point 1); both Contexts give the same greedy tokens and logits within 2e-4
in f32 (test_torch_engine.py's tolerance), the port's quantized matmuls on
the plain versions of K1/K2, with chain=True, gdot=True (K6, K5) against
llm_tpu's interpreted kernels, with scan_layers=True (K7), and with
use_planes=False. A tiny transformers BitNetForCausalLM converted by
llm_tpu's convert_hf_llama gives transformers' logits (at
tests/test_archs.py's tolerance) and llm_tpu's (2e-4). The port's recipes
give llm_tpu's type for every tensor of LLAMA3_8B and BitNet b1.58 2B4T."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models.loader import load_params as jax_load_params
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import tensor_type_for

from llm_tpu_torch.convert_params import params_from_reference
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models import synthetic
from llm_tpu_torch.models.loader import load_params
from llm_tpu_torch.models.transformer import forward
from llm_tpu_torch.ops import cuda_qmm, cuda_qmm_chain, qmatmul
from llm_tpu_torch.quant.qtensor import QTensor
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.runtime.kv_cache import SEQ_WORDS
from llm_tpu_torch.tools import synth_gguf

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
TOL = dict(atol=2e-4, rtol=2e-4)
FTYPES = ("IQ2_XXS", "IQ1_M", "TQ2_0", "TQ1_0")
# the group-size form each base type's matmuls run
FORMS = {"IQ2_XXS": ("i8", 32), "IQ1_M": ("i8", 8), "TQ2_0": ("p4", 256),
         "TQ1_0": ("p4", 256)}


@pytest.fixture(scope="module")
def iq_ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("iq")
    paths = {}
    for ftype in FTYPES:
        paths[ftype] = str(d / f"{ftype}.gguf")
        synth_gguf.write_llama(paths[ftype], n_layers=2, n_embd=256, n_heads=4, n_kv_heads=1,
                               n_ff=512, n_vocab=512, ftype=ftype,
                               arch="bitnet" if ftype.startswith("TQ") else "llama")
    return paths


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


def _count(monkeypatch, names):
    """Wrap the plain versions the CPU runs for the kernels: {key: calls}."""
    calls = {key: 0 for _, _, key in names}
    for mod, name, key in names:
        def counted(*a, _fn=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("ftype", FTYPES)
def test_load_params_planes_equal_reference(iq_ggufs, ftype):
    """Every matrix of both layers and the lm_head: the same planes in both
    packages, the base type's at its group-size form; bitnet's sub-norms
    load as vectors."""
    path = iq_ggufs[ftype]
    jp, jcfg = jax_load_params(JaxGGUFReader(path))
    tp, tcfg = load_params(GGUFReader(path), device="cpu")
    assert (tcfg.arch, tcfg.act) == (jcfg.arch, jcfg.act)
    for jl, tl in zip(jp["layers"] + [{"output": jp["output"]}],
                      tp["layers"] + [{"output": tp["output"]}]):
        assert set(jl) == set(tl)
        for key, t in tl.items():
            j = jl[key]
            if isinstance(t, QTensor):
                assert (t.layout, t.group_size, t.zp) == (j.layout, j.group_size, j.zp), key
                for f in ("qs", "scales", "mins"):
                    a, b = getattr(t, f), getattr(j, f)
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert np.array_equal(a.numpy(), np.asarray(b)), (key, f)
            else:
                assert np.array_equal(t.numpy(), np.asarray(j)), key
    gu = tp["layers"][1]["ffn_gateup_fused"]
    assert (gu.layout, gu.group_size) == FORMS[ftype]
    if ftype.startswith("TQ"):
        assert tcfg.act == "relu2" and gu.zp == 1
        assert {"attn_sub_norm", "ffn_sub_norm"} <= set(tp["layers"][0])


@pytest.mark.parametrize("ftype", FTYPES)
def test_engine_matches_reference(iq_ggufs, monkeypatch, ftype):
    _f32(monkeypatch)
    path = iq_ggufs[ftype]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    _compare(ref, ctx)


@pytest.mark.parametrize("ftype", ["IQ1_M", "TQ2_0"])
def test_engine_chain_gdot_matches_reference(iq_ggufs, monkeypatch, ftype):
    """chain=True, gdot=True against llm_tpu's chained and group-factored
    kernels in interpret mode. IQ1_M: K6 takes each layer's tail (IQ1_M
    o_proj and gate+up at group size 8 beside an IQ3_XXS down) and the
    Q5_K lm_head; K5 only the p4 Q4_K attn_v. TQ2_0 (bitnet): its squared
    relu keeps the whole model unchained (chain_gate, as the reference's
    use_chain), every TQ2_0 matmul on K5."""
    _f32(monkeypatch)
    for k, v in (("LLM_TPU_CHAIN", "1"), ("LLM_TPU_CHAIN_FORCE", "interpret"),
                 ("LLM_TPU_GDOT", "force"), ("LLM_TPU_FLASH_FORCE", "interpret")):
        monkeypatch.setenv(k, v)
    calls = _count(monkeypatch, ((cuda_qmm_chain, "qmm_chain_plain", "K6"),
                                 (cuda_qmm, "qmm_gdot_plain", "K5")))
    jax_qmatmul.set_backend("pallas", interpret=True)
    try:
        path = iq_ggufs[ftype]
        ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
        ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                      chain=True, gdot=True)
        _compare(ref, ctx)
    finally:
        jax_qmatmul.set_backend("auto")
    # the 10-token prompt (T > 8: no chain) takes K5 for its p4 matmuls; each
    # of the 9 decode steps runs the chained kernels (IQ1_M: both tails and
    # the lm_head; bitnet: none) and K5 for the rest
    if ftype == "IQ1_M":
        assert calls == {"K6": 9 * 3, "K5": 2 * 1 + 9 * 2}
    else:
        assert calls == {"K6": 0, "K5": 2 * 4 + 9 * 2 * 4}


@pytest.mark.parametrize("ftype", ["IQ1_M", "TQ2_0"])
def test_engine_scan_matches_reference(iq_ggufs, monkeypatch, ftype):
    """scan_layers=True in both packages: the two layers' planes stack (both
    hold the same types, layers 0-1's IQ3_XXS down among them), every layer
    matmul of every step on K7 (its plain version), against llm_tpu's scan
    Context."""
    _f32(monkeypatch)
    calls = _count(monkeypatch, ((cuda_qmm, "qmm_stacked_plain", "K7"),))
    path = iq_ggufs[ftype]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32, scan_layers=True)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                  scan_layers=True)
    assert ctx.scan and ctx.params["layers"] == []
    stacked = ctx.params["layers_stacked"]["ffn_gateup_fused"]
    assert (stacked.layout, stacked.group_size) == FORMS[ftype]
    _compare(ref, ctx)
    # QKV (fused for bitnet; q, k, v apart for IQ1_M), o_proj, gate+up and
    # down, in both layers, on the prompt and 9 decode steps
    per_layer = 4 if ftype.startswith("TQ") else 6
    assert calls["K7"] == 10 * 2 * per_layer


def test_dense_load_matches_reference(iq_ggufs, monkeypatch):
    """use_planes=False in both packages on the IQ1_M file: every matrix
    dequantized to dense f32 at load (the CLI's --no-planes)."""
    _f32(monkeypatch)
    path = iq_ggufs["IQ1_M"]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32, use_planes=False)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                  use_planes=False)
    assert not any(isinstance(v, QTensor) for layer in ctx.params["layers"]
                   for v in layer.values())
    _compare(ref, ctx)


def test_bitnet_matches_transformers_and_reference(tmp_path, monkeypatch):
    """test_archs.py::test_bitnet's tiny transformers BitNetForCausalLM,
    converted by llm_tpu's convert_hf_llama (f32): the port's forward gives
    transformers' logits at that test's tolerance (3e-3), llm_tpu's at
    2e-4, and the Contexts the same greedy tokens."""
    _f32(monkeypatch)
    cfg = transformers.BitNetConfig(
        vocab_size=97, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0, pad_token_id=0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.BitNetForCausalLM(cfg).eval()
    path = str(tmp_path / "bitnet.gguf")
    convert_hf_llama(model, path, arch="bitnet")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=9).tolist()
    params, pcfg = load_params(GGUFReader(path), dense_dtype=torch.float32, device="cpu")
    assert (pcfg.arch, pcfg.act) == ("bitnet", "relu2")
    T, n_cells = len(tokens), 32
    kv = [torch.zeros((pcfg.n_kv_heads, n_cells, pcfg.head_dim))
          for _ in range(2 * pcfg.n_layers)]
    pos = torch.arange(T)
    cpos = torch.cat([pos, torch.zeros(n_cells - T, dtype=torch.long)])
    bits = torch.zeros((n_cells, SEQ_WORDS), dtype=torch.int64)
    bits[:T, 0] = 1
    ours, _ = forward(params, pcfg, kv[:pcfg.n_layers], kv[pcfg.n_layers:], torch.tensor(tokens),
                      pos, torch.zeros(T, dtype=torch.long), pos, cpos, bits, pos,
                      dtype=torch.float32)
    with torch.no_grad():
        want = model(torch.tensor([tokens])).logits[0].numpy()
    np.testing.assert_allclose(ours.numpy(), want, atol=3e-3, rtol=3e-3)
    # llm_tpu's params through convert_params: the sub-norms and relu2 kept
    jp, jcfg = jax_load_params(JaxGGUFReader(path))
    conv, ccfg = params_from_reference(_to_numpy(jp), jcfg)
    assert ccfg == pcfg and {"attn_sub_norm", "ffn_sub_norm"} <= set(conv["layers"][1])
    assert torch.equal(conv["layers"][1]["ffn_sub_norm"], params["layers"][1]["ffn_sub_norm"])
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    assert ref.decode(JaxBatch.text(tokens)) == 0 and ctx.decode(Batch.text(tokens)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **TOL)
    np.testing.assert_allclose(ctx.get_logits(), want[-1], atol=3e-3, rtol=3e-3)
    first = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(first, 8) == ref.generate_loop(first, 8)


def _to_numpy(obj):
    """llm_tpu's params as convert_params takes them (numpy leaves)."""
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    return None if obj is None else np.asarray(obj)


_LAYER_RE = re.compile(r"blk\.(\d+)\.")


@pytest.mark.parametrize("ftype", FTYPES)
def test_recipes_follow_the_reference(ftype):
    """models/synthetic.py's tensor_type_for against llm_tpu's over every
    tensor of LLAMA3_8B and of BitNet b1.58 2B4T (its shapes, n_gqa 4)."""
    for geo in (synthetic.LLAMA3_8B, synthetic.BITNET_B158_2B):
        E, F, hd = geo["n_embd"], geo["n_ff"], geo["head_dim"]
        H, KV, L = geo["n_heads"], geo["n_kv_heads"], geo["n_layers"]
        names = [("token_embd.weight", E), ("output.weight", E)]
        for il in range(L):
            names += [(f"blk.{il}.{k}.weight", kk) for k, kk in (
                ("attn_q", E), ("attn_k", E), ("attn_v", E), ("attn_output", H * hd),
                ("ffn_gate", E), ("ffn_up", E), ("ffn_down", F))]
        for name, k in names:
            m = _LAYER_RE.match(name)
            il = int(m.group(1)) if m else 0
            want = tensor_type_for(name, (k, 128), ftype, L, n_gqa=H // KV)
            got = synthetic.tensor_type_for(name, k, ftype, il, L, H // KV)
            assert got.name == want.name, (geo, name, got.name, want.name)
