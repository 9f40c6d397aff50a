"""K6's plain version (llm_tpu_torch.ops.cuda_qmm_chain) held against
llm_tpu's chained kernel (pallas_qmm_chain.layer_tail / norm_mm ->
_chain_kernel in interpret mode) on the cases of test_qmm_chain.py, the
two packages' gates against each other, and the chained decode path end
to end: Context(chain=True, gdot=True) against llm_tpu's Context run with
LLM_TPU_CHAIN=1, LLM_TPU_CHAIN_FORCE=interpret, LLM_TPU_GDOT=force and
LLM_TPU_FLASH_FORCE=interpret, on a tiny llama whose widths are 128-aligned
(so that the fused head, the mixed Q4_K/Q6_K tail and the lm_head engage).

Tolerances. In f32 both sides compute the same function: 2e-4 of max|y|
(the reference's f32 tolerance). In bf16 the TPU kernel rounds each
dequantized weight (q - zp) * s, and the mins correction's operands, to
bf16; the port keeps them in f32 as its K1/K2 do (ROADMAP Queue 3). The
chain's outputs then differ by those roundings, carried through bf16
boundaries: measured below, and held at about 3x the worst reading."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.constants import GGMLType
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models.loader import load_params as jax_load_params
from llm_tpu.models.synthetic import make_synthetic_model as jax_make_synthetic_model
from llm_tpu.ops import pallas_qmm_chain as jax_chain
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.quant import codecs
from llm_tpu.quant.qtensor import qtensor_from_gguf as jax_qtensor_from_gguf
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model

from llm_tpu_torch.convert_params import params_from_reference
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.loader import load_params
from llm_tpu_torch.models.transformer import check_supported
from llm_tpu_torch.ops import cuda_qmm, cuda_qmm_chain, qmatmul
from llm_tpu_torch.ops.cuda_qmm_chain import (TAIL_BANNED, chain_fits, head_eligible,
                                              layer_tail, norm_mm, tail_eligible)
from llm_tpu_torch.quant.qtensor import qtensor_from_gguf
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context

E, F = 512, 1024
EPS = 1e-5
TOL_F32 = 2e-4
# bf16 chain against llm_tpu's bf16 chain, relative to max|out|. The
# tail's output is bf16, so one rounding step is 2^-8 of a value; the
# tails differ by up to 4 such steps of max|out|: measured <= 1.68e-2 over
# seeds 1-3 and 8 of the cases below (Q8_0, whose weights need no mins,
# <= 6.9e-3). Held at test_qmm_chain.py's 3e-2, which a 3x margin would
# loosen. norm_mm's f32 output: measured <= 7.6e-3, held at 2e-2.
TOL_BF16 = 3e-2
TOL_NORM_BF16 = 2e-2


def _mk(rng, n, k, qtype):
    """The same GGUF bytes as both packages' planes."""
    w = (rng.normal(size=(n, k)) * 0.05).astype(np.float32)
    raw = codecs.quantize(w, qtype)
    return jax_qtensor_from_gguf(raw, qtype, (k, n)), qtensor_from_gguf(raw, qtype, (k, n))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tail_case(types, seed, B, e=E, f=F):
    rng = np.random.default_rng(seed)
    pairs = [_mk(rng, e, e, types[0]), _mk(rng, 2 * f, e, types[1]), _mk(rng, e, f, types[2])]
    att = (rng.normal(size=(B, e)) * 0.1).astype(np.float32)
    xres = (rng.normal(size=(B, e)) * 0.1).astype(np.float32)
    gamma = (rng.normal(size=(e,)) * 0.1 + 1.0).astype(np.float32)
    return pairs, att, xres, gamma


TYPES = [(GGMLType.Q4_K, GGMLType.Q4_K, GGMLType.Q6_K),
         (GGMLType.Q8_0, GGMLType.Q8_0, GGMLType.Q8_0),
         (GGMLType.Q4_0, GGMLType.Q4_K, GGMLType.Q4_K)]
# Q3_K_M's and Q2_K's tails: nibble planes at group size 16
LOWBIT_TYPES = [(GGMLType.Q3_K, GGMLType.Q3_K, GGMLType.Q4_K),
                (GGMLType.Q2_K, GGMLType.Q2_K, GGMLType.Q3_K)]
# IQ1_M's tail (int8 planes at group size 8, an IQ3_XXS down) and TQ2_0's
# (nibble planes at group size 256, zero point 1), at 256 wide (the
# interpreted reference chain takes ~25 s a case at E, F)
IQ_TYPES = [(GGMLType.IQ1_M, GGMLType.IQ1_M, GGMLType.IQ3_XXS),
            (GGMLType.TQ2_0, GGMLType.TQ2_0, GGMLType.TQ2_0)]


@pytest.mark.parametrize("cdtype,tol", [("f32", TOL_F32), ("bf16", TOL_BF16)])
@pytest.mark.parametrize("types", IQ_TYPES, ids=lambda t: "-".join(x.name for x in t))
def test_layer_tail_matches_reference_at_group_sizes_256_and_8(types, cdtype, tol):
    """test_layer_tail_{f32,bf16}_matches_reference's checks on the IQ1_M
    and TQ2_0 tails at E = F = 256."""
    B = 5 if cdtype == "f32" else 8
    pairs, att, xres, gamma = _tail_case(types, 9, B, 256, 256)
    jdt, tdt = (jnp.float32, torch.float32) if cdtype == "f32" else (jnp.bfloat16,
                                                                     torch.bfloat16)
    want = jax_chain.layer_tail(jnp.asarray(att, jdt), jnp.asarray(xres, jdt),
                                jnp.asarray(gamma), *(p[0] for p in pairs), eps=EPS,
                                compute_dtype=jdt, interpret=True)
    tt = (lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, jdt), np.float32)).to(tdt))
    got = layer_tail(tt(att), tt(xres), torch.from_numpy(gamma), *(p[1] for p in pairs),
                     eps=EPS, compute_dtype=tdt)
    assert got.shape == (B, 256) and got.dtype == tdt
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("types", TYPES + LOWBIT_TYPES,
                         ids=lambda t: "-".join(x.name for x in t))
def test_layer_tail_f32_matches_reference(types):
    pairs, att, xres, gamma = _tail_case(types, 7, 5)
    want = jax_chain.layer_tail(jnp.asarray(att), jnp.asarray(xres), jnp.asarray(gamma),
                                *(p[0] for p in pairs), eps=EPS,
                                compute_dtype=jnp.float32, interpret=True)
    got = layer_tail(torch.from_numpy(att), torch.from_numpy(xres), torch.from_numpy(gamma),
                     *(p[1] for p in pairs), eps=EPS, compute_dtype=torch.float32)
    assert got.shape == (5, E) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL_F32


@pytest.mark.parametrize("types", TYPES + LOWBIT_TYPES,
                         ids=lambda t: "-".join(x.name for x in t))
def test_layer_tail_bf16_matches_reference(types):
    """The bf16 dtype walk (bf16 residual, norm and SwiGLU boundaries) at
    B = 8, as test_qmm_chain.py's bf16 case."""
    pairs, att, xres, gamma = _tail_case(types, 8, 8)
    bf = jnp.bfloat16
    want = jax_chain.layer_tail(jnp.asarray(att, bf), jnp.asarray(xres, bf),
                                jnp.asarray(gamma), *(p[0] for p in pairs), eps=EPS,
                                compute_dtype=bf, interpret=True)
    tb = (lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, bf), np.float32))
          .to(torch.bfloat16))
    got = layer_tail(tb(att), tb(xres), torch.from_numpy(gamma), *(p[1] for p in pairs),
                     eps=EPS, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) < TOL_BF16


@pytest.mark.parametrize("cdtype", ["f32", "bf16"])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K], ids=lambda t: t.name)
def test_norm_mm_matches_reference(qtype, cdtype):
    rng = np.random.default_rng(9)
    jw, tw = _mk(rng, 3 * E, E, qtype)
    x = (rng.normal(size=(3, E)) * 0.3).astype(np.float32)
    gamma = (rng.normal(size=(E,)) * 0.1 + 1.0).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if cdtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_chain.norm_mm(jnp.asarray(x), jnp.asarray(gamma), jw, eps=EPS,
                             compute_dtype=jdt, out_dtype=jnp.float32, interpret=True)
    got = norm_mm(torch.from_numpy(x), torch.from_numpy(gamma), tw, eps=EPS,
                  compute_dtype=tdt, out_dtype=torch.float32)
    assert got.shape == (3, 3 * E) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < (TOL_F32 if cdtype == "f32" else TOL_NORM_BF16)


@pytest.mark.parametrize("dims", [
    ((E, E), (E, 2 * F), (F, E)),          # the tail
    ((E, 3 * E),),                          # a head
    ((E, 96),),                             # N = 96: no 128 tile
    ((E, 384), (384, 256)),                 # N = 384 (128 divides it)
    ((384, 512),),                          # K = 384: no 256 K tile
    ((768, 1024), (1024, 768)),             # K = 768
    ((E, 200),),                            # ragged N
])
def test_gate_agrees_with_plan_phases(dims):
    rng = np.random.default_rng(10)
    pairs = [_mk(rng, n, k, GGMLType.Q8_0 if k % 256 else GGMLType.Q4_K) for k, n in dims]
    pres = ("cast", "res_norm", "swiglu")[:len(dims)]
    want = jax_chain.plan_phases(tuple(p[0] for p in pairs), pres) is not None
    assert chain_fits([p[1] for p in pairs]) == want


@pytest.fixture(scope="module")
def chain_ggufs(tmp_path_factory):
    """test_chain_e2e.py's tiny llama (128-aligned widths) at Q4_K_M (Q6_K
    attn_v and ffn_down in the use_more_bits layer 0, whose QKV stays
    unfused, a fused head in layer 1, a Q6_K lm_head) and Q8_0."""
    cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False, attention_bias=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp("chain")
    f32 = str(d / "f32.gguf")
    convert_hf_llama(model, f32)
    paths = {}
    for ftype in ("Q4_K_M", "Q8_0"):
        paths[ftype] = str(d / f"{ftype}.gguf")
        quantize_model(f32, paths[ftype], ftype)
    return paths


def test_gates_agree_on_loaded_layers(chain_ggufs):
    for path in chain_ggufs.values():
        jp, _ = jax_load_params(JaxGGUFReader(path))
        tp, tcfg = load_params(GGUFReader(path), device="cpu")
        for jl, tl in zip(jp["layers"], tp["layers"]):
            assert head_eligible(tl) == jax_chain.head_eligible(jl)
            assert tail_eligible(tl) == jax_chain.tail_eligible(jl)
            want = jax_chain.plan_phases(
                (jl["attn_output"], jl["ffn_gateup_fused"], jl["ffn_down"]),
                ("cast", "res_norm", "swiglu")) is not None
            assert chain_fits((tl["attn_output"], tl["ffn_gateup_fused"], tl["ffn_down"])) == want
        # every banned key (gemma2's post-norms and bitnet's sub-norms among
        # them): both gates refuse the tail; the forward runs the sub-norms
        # (unchained), and a layer key it does not run (a LoRA adapter)
        # check_supported refuses with the whole layer before any gate is
        # asked
        assert tail_eligible(tl)
        for key in TAIL_BANNED:
            assert not tail_eligible({**tl, key: None})
            assert not jax_chain.tail_eligible({**jl, key: None})
        check_supported({"layers": [{**tl, "attn_sub_norm": None, "ffn_sub_norm": None}]
                         * tcfg.n_layers}, tcfg)
        with pytest.raises(NotImplementedError):
            check_supported({"layers": [{**tl, "attn_output.lora": None}]}, tcfg)
    q4, _ = load_params(GGUFReader(chain_ggufs["Q4_K_M"]), device="cpu")
    assert [head_eligible(layer) for layer in q4["layers"]] == [False, True]


@pytest.fixture
def chain_reference(monkeypatch):
    """llm_tpu with its chained kernels and gdot forced, in interpret mode."""
    for k, v in (("LLM_TPU_CHAIN", "1"), ("LLM_TPU_CHAIN_FORCE", "interpret"),
                 ("LLM_TPU_GDOT", "force"), ("LLM_TPU_FLASH_FORCE", "interpret")):
        monkeypatch.setenv(k, v)
    jax_qmatmul.set_backend("pallas", interpret=True)
    try:
        yield
    finally:
        jax_qmatmul.set_backend("auto")


@pytest.fixture
def counted(monkeypatch):
    """Calls of K6's and K5's plain versions (what runs them on the CPU)."""
    n = {"K6": 0, "K5": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted_fn(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted_fn)
    wrap(cuda_qmm_chain, "qmm_chain_plain", "K6")
    wrap(cuda_qmm, "qmm_gdot_plain", "K5")
    return n


def _f32(monkeypatch):
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def _engines(ref, ctx, prompt, tol, counted=None, per_step=None):
    """Prefill logits (T = 10: unchained, gdot at the 16-row bucket), one
    chained decode step, then 8 greedy tokens of generate_loop."""
    assert ref.decode(JaxBatch.text(prompt)) == 0
    assert ctx.decode(Batch.text(prompt)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **tol)
    first = int(np.argmax(ref.get_logits()))
    assert int(np.argmax(ctx.get_logits())) == first
    before = dict(counted) if counted is not None else None
    assert ref.decode(JaxBatch.one(first)) == 0
    assert ctx.decode(Batch.one(first)) == 0
    if counted is not None:
        assert {k: counted[k] - before[k] for k in counted} == per_step
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **tol)
    nxt = int(np.argmax(ref.get_logits()))
    assert int(np.argmax(ctx.get_logits())) == nxt
    return ref.generate_loop(nxt, 8), ctx.generate_loop(nxt, 8)


def _per_step(params):
    """K6 and K5 calls of one chained decode step, from the params: a head
    per fused QKV, a tail per layer, the lm_head; the unfused QKV's p4
    matmuls on K5."""
    k6 = sum(1 + ("attn_qkv_fused" in layer) for layer in params["layers"])
    k6 += cuda_qmm_chain.is_kmajor_qt(params.get("output"))
    k5 = sum(params["layers"][i][k].layout == "p4" for i in range(len(params["layers"]))
             for k in ("attn_q", "attn_k", "attn_v") if k in params["layers"][i])
    return {"K6": k6, "K5": k5}


PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]


def _to_numpy(obj):
    """llm_tpu's params as convert_params takes them (numpy leaves)."""
    if hasattr(obj, "qs") and hasattr(obj, "ggml_type"):
        return {f: (None if getattr(obj, f) is None else np.asarray(getattr(obj, f)))
                if f in ("qs", "scales", "mins") else getattr(obj, f)
                for f in ("qs", "scales", "mins", "group_size", "ggml_type", "layout",
                          "zp", "pack_tk", "kmajor")}
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    return None if obj is None else np.asarray(obj)


@pytest.mark.parametrize("ftype", ["Q4_K_M", "Q8_0"])
def test_engine_chain_f32_matches_reference(chain_ggufs, chain_reference, counted,
                                            monkeypatch, ftype):
    _f32(monkeypatch)
    path = chain_ggufs[ftype]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                  chain=True, gdot=True)
    want, got = _engines(ref, ctx, PROMPT, dict(atol=2e-4, rtol=2e-4), counted,
                         _per_step(ctx.params))
    assert got == want


@pytest.mark.parametrize("ftype", ["Q4_K_M", "Q8_0"])
def test_engine_chain_bf16_matches_reference(chain_ggufs, chain_reference, ftype):
    """In bf16, at test_chain_e2e.py's tolerance (atol 0.15, rtol 0.05),
    argmax equal at every compared step."""
    path = chain_ggufs[ftype]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.bfloat16)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.bfloat16, device="cpu",
                  chain=True, gdot=True)
    _engines(ref, ctx, PROMPT, dict(atol=0.15, rtol=0.05))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, dict(atol=2e-4, rtol=2e-4)),
                                       (torch.bfloat16, dict(atol=0.15, rtol=0.05))],
                         ids=["f32", "bf16"])
def test_engine_chain_matches_own_unfused_path(chain_ggufs, monkeypatch, dtype, tol):
    if dtype == torch.float32:
        monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)
    path = chain_ggufs["Q4_K_M"]
    plain = Context(GGUFReader(path), n_cells=32, dtype=dtype, device="cpu")
    fused = Context(GGUFReader(path), n_cells=32, dtype=dtype, device="cpu",
                    chain=True, gdot=True)
    for c in (plain, fused):
        assert c.decode(Batch.text(PROMPT)) == 0
    first = int(np.argmax(plain.get_logits()))
    for c in (plain, fused):
        assert c.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(fused.get_logits(), plain.get_logits(), **tol)
    nxt = int(np.argmax(plain.get_logits()))
    assert int(np.argmax(fused.get_logits())) == nxt
    assert fused.generate_loop(nxt, 6) == plain.generate_loop(nxt, 6)


def test_converted_params_drive_the_chain(chain_reference, counted, monkeypatch):
    """llm_tpu's synthetic params through convert_params, unchanged, run the
    chained path (a fused head and a Q4_K tail in every layer) and agree
    with llm_tpu's chained Context in f32."""
    _f32(monkeypatch)
    geo = dict(n_embd=256, n_layers=2, n_heads=2, n_kv_heads=1, n_ff=512, vocab=256)
    jp, jcfg = jax_make_synthetic_model(qtype=GGMLType.Q4_K, seed=4, **geo)
    params, cfg = params_from_reference(_to_numpy(jp), jcfg)
    ref = JaxContext(None, n_cells=32, dtype=jnp.float32, params_cfg=(jp, jcfg))
    ctx = Context(None, n_cells=32, dtype=torch.float32, device="cpu",
                  params_cfg=(params, cfg), chain=True, gdot=True)
    assert all(head_eligible(layer) and tail_eligible(layer) for layer in ctx.params["layers"])
    want, got = _engines(ref, ctx, PROMPT, dict(atol=2e-4, rtol=2e-4), counted,
                         _per_step(ctx.params))
    assert got == want
