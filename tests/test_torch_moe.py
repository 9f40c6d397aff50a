"""The mixture-of-experts FFN through the port against llm_tpu on the CPU.

- The tiny transformers Mixtral, Qwen2Moe and Qwen3Moe of test_archs.py
  (4 experts, 2 a token; Qwen2Moe with its sigmoid-gated shared expert and
  unnormalized top-k weights, Qwen3Moe with qk-norm), converted by
  llm_tpu's convert_hf_llama: both packages' configs equal; the port's
  load_params and forward against llm_tpu's (flash kernels interpreted) in
  f32 at 2e-4, at T = 9 (the grouped dispatch) and T = 5 (the per-(token,
  k) gather); the two Contexts' greedy tokens equal; Context(scan_layers=
  True) runs the model per layer.
- A Q8_0 file made by llm_tpu's quantize_model: every expert stack's planes
  byte-equal to llm_tpu's, the forward at 2e-4; expert_qtensor_from_gguf's
  planes byte-equal to llm_tpu's for Q4_K, Q6_K, Q8_0, Q4_0 and Q4_1, and
  dequantize_qtensor equal to llm_tpu's on them.
- dispatch_tables (buckets, weights, drops) and moe_ffn_grouped at
  test_moe_cf.py's fixture and capacity-factor grid, equal to llm_tpu's.
- moe_ffn at the function level against llm_tpu's _moe_ffn: softmax and
  sigmoid gating with ffn_exp_probs_b, both expert_weight_before branches,
  quantized stacks in bf16, and router ties (two experts with the same
  router row), which both packages break to the lower expert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.constants import GGMLType as JaxGGMLType
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models import transformer as jax_transformer
from llm_tpu.models.config import ModelConfig as JaxModelConfig
from llm_tpu.models.config import config_from_gguf as jax_config_from_gguf
from llm_tpu.models.loader import load_params as jax_load_params
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.parallel import moe as jax_moe
from llm_tpu.quant import codecs
from llm_tpu.quant.qtensor import dequantize_qtensor as jax_dequantize_qtensor
from llm_tpu.quant.qtensor import expert_qtensor_from_gguf as jax_expert_qtensor_from_gguf
from llm_tpu.quant.qtensor import qtensor_from_gguf as jax_qtensor_from_gguf
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model

from llm_tpu_torch.convert_params import config_from_reference
from llm_tpu_torch.gguf.constants import GGMLType
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.config import config_from_gguf
from llm_tpu_torch.models.loader import load_params
from llm_tpu_torch.models.transformer import moe_ffn, top_k
from llm_tpu_torch.ops import qmatmul
from llm_tpu_torch.parallel import moe
from llm_tpu_torch.quant.qtensor import (QTensor, dequantize_qtensor, expert_qtensor_from_gguf,
                                         qtensor_from_gguf)
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context

from test_model_vs_hf import _run_ours
from test_moe_cf import _fixture as cf_fixture
from test_torch_gemma2 import _port_forward

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # the engine's f32 tolerance
HF_TOL = dict(atol=5e-3, rtol=5e-3)   # test_archs.py's mixtral case
TOKENS = [5, 17, 60, 2, 33, 42, 7, 81, 64]
CFS = [0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0]  # test_moe_cf.py's grid


def hf_moe(arch: str, moe_ff: int = 48):
    """test_archs.py's tiny transformers model of arch, and the arch name
    its GGUF is written under (mixtral's as llama, as test_archs.py does)."""
    common = dict(vocab_size=97, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                  rope_theta=10000.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    if arch == "mixtral":
        cfg = transformers.MixtralConfig(num_local_experts=4, num_experts_per_tok=2, **common)
        return transformers.MixtralForCausalLM(cfg).eval(), "llama"
    if arch == "qwen2moe":
        cfg = transformers.Qwen2MoeConfig(
            moe_intermediate_size=moe_ff, shared_expert_intermediate_size=80, num_experts=4,
            num_experts_per_tok=2, norm_topk_prob=False, decoder_sparse_step=1, **common)
        return transformers.Qwen2MoeForCausalLM(cfg).eval(), "qwen2moe"
    cfg = transformers.Qwen3MoeConfig(
        moe_intermediate_size=moe_ff, head_dim=16, num_experts=4, num_experts_per_tok=2,
        norm_topk_prob=True, decoder_sparse_step=1, **common)
    return transformers.Qwen3MoeForCausalLM(cfg).eval(), "qwen3moe"


ARCHS = ["mixtral", "qwen2moe", "qwen3moe"]


@pytest.fixture(scope="module")
def moe_ggufs(tmp_path_factory):
    """{arch: (f32 GGUF, transformers model)}, and "q8": a Q8_0 Qwen2Moe
    (experts of 64, which Q8_0's blocks divide) made by quantize_model."""
    d = tmp_path_factory.mktemp("moe")
    out = {}
    for arch in ARCHS:
        model, gguf_arch = hf_moe(arch)
        path = str(d / f"{arch}.gguf")
        convert_hf_llama(model, path, arch=gguf_arch)
        out[arch] = (path, model)
    f32 = str(d / "q2m_f32.gguf")
    convert_hf_llama(hf_moe("qwen2moe", moe_ff=64)[0], f32, arch="qwen2moe")
    out["q8"] = (str(d / "q2m_q8.gguf"), None)
    quantize_model(f32, out["q8"][0], "Q8_0")
    return out


@pytest.fixture
def f32_flash_interpreted(monkeypatch):
    """llm_tpu in f32 with its flash kernels interpreted; the port in f32."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


@pytest.mark.parametrize("arch", ARCHS + ["q8"])
def test_config_is_the_reference(moe_ggufs, arch):
    path = moe_ggufs[arch][0]
    jcfg = jax_config_from_gguf(JaxGGUFReader(path))
    cfg = config_from_gguf(GGUFReader(path))
    assert cfg == config_from_reference(jcfg)
    assert cfg.n_expert == 4 and cfg.n_expert_used == 2
    assert cfg.expert_weights_norm == (arch in ("mixtral", "qwen3moe"))
    assert cfg.attn_bias == (arch in ("qwen2moe", "q8")) and cfg.qk_norm == (arch == "qwen3moe")


@pytest.mark.parametrize("T", [9, 5], ids=["grouped", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(moe_ggufs, f32_flash_interpreted, arch, T, monkeypatch):
    """Every row's logits at 2e-4 of llm_tpu's; T = 9 runs the grouped
    dispatch in both packages (counted), T = 5 the gather; at T = 9 also
    transformers' logits at test_archs.py's tolerance."""
    path, model = moe_ggufs[arch]
    calls = []
    real = moe.moe_ffn_grouped
    monkeypatch.setattr("llm_tpu_torch.models.transformer.moe_ffn_grouped",
                        lambda *a, **kw: (calls.append(a[0].shape[0]), real(*a, **kw))[1])
    got = _port_forward(path, TOKENS[:T])
    want = _run_ours(path, TOKENS[:T])
    assert got.shape == want.shape == (T, 97)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert calls == ([T, T] if T > 8 else [])
    if T > 8:
        with torch.no_grad():
            hf = model(torch.tensor([TOKENS[:T]])).logits[0].numpy()
        np.testing.assert_allclose(got, hf, **HF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_reference(moe_ggufs, f32_flash_interpreted, arch):
    """Context.decode of the prompt (padded to 16 rows: the grouped
    dispatch), one decode step (the gather), generate_loop: logits at 2e-4,
    greedy tokens equal."""
    path = moe_ggufs[arch][0]
    ref = JaxContext(JaxGGUFReader(path), n_cells=64, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=64, dtype=torch.float32, device="cpu")
    assert ref.decode(JaxBatch.text(TOKENS)) == 0 and ctx.decode(Batch.text(TOKENS)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0 and ctx.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **F32_TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, 12) == ref.generate_loop(nxt, 12)


def test_scan_option_runs_per_layer(moe_ggufs, f32_flash_interpreted):
    """Context(scan_layers=True) on a MoE model keeps its layers per layer
    (the reference's scan takes no experts) and gives the per-layer
    Context's logits bit for bit."""
    path = moe_ggufs["q8"][0]
    scan = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                   scan_layers=True)
    plain = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu")
    assert not scan.scan and "layers_stacked" not in scan.params
    for c in (scan, plain):
        assert c.decode(Batch.text(TOKENS)) == 0
    assert np.array_equal(scan.get_logits(), plain.get_logits())


def test_q8_expert_planes_match_reference(moe_ggufs, f32_flash_interpreted):
    """The Q8_0 file's expert stacks: rows-layout planes [E, N, K] byte-equal
    to llm_tpu's (the shared expert and the attention K-major, as 2-D
    weights are), the forward and a Context's greedy tokens as llm_tpu's."""
    path = moe_ggufs["q8"][0]
    jp, _ = jax_load_params(JaxGGUFReader(path), dense_dtype=jnp.float32)
    tp, _ = load_params(GGUFReader(path), dense_dtype=torch.float32, device="cpu")
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert set(tl) >= {"ffn_gate_exps", "ffn_up_exps", "ffn_down_exps", "ffn_gate_inp",
                           "ffn_up_shexp", "ffn_gate_inp_shexp", "attn_q_b"}
        for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
            j, t = jl[key], tl[key]
            assert isinstance(t, QTensor) and not t.kmajor and t.qs.shape[0] == 4
            assert t.ggml_type == GGMLType.Q8_0 and t.layout == j.layout
            for f in ("qs", "scales", "mins"):
                a, b = getattr(j, f), getattr(t, f)
                assert (a is None) == (b is None)
                if a is not None:
                    assert np.asarray(a).tobytes() == b.numpy().tobytes()
    got = _port_forward(path, TOKENS)
    np.testing.assert_allclose(got, _run_ours(path, TOKENS), **F32_TOL)
    ref = JaxContext(JaxGGUFReader(path), n_cells=64, dtype=jnp.float32)
    ctx = Context(GGUFReader(path), n_cells=64, dtype=torch.float32, device="cpu")
    assert ref.decode(JaxBatch.text(TOKENS[:4])) == 0 and ctx.decode(Batch.text(TOKENS[:4])) == 0
    first = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(first, 8) == ref.generate_loop(first, 8)


@pytest.mark.parametrize("qtype", ["Q4_K", "Q6_K", "Q8_0", "Q4_0", "Q4_1"])
def test_expert_planes_byte_equal(qtype):
    """expert_qtensor_from_gguf on one 3-D tensor ne = (K, N, E): every plane
    byte-equal to llm_tpu's, and dequantize_qtensor (f32 [E, N, K]) equal to
    llm_tpu's dequantize_qtensor and to the dequantized bytes."""
    rng = np.random.default_rng(4)
    E, N, K = 3, 40, 512
    w = (rng.normal(size=(E * N, K)) * 0.05).astype(np.float32)
    raw = codecs.quantize(w, JaxGGMLType[qtype])
    j = jax_expert_qtensor_from_gguf(raw, JaxGGMLType[qtype], (K, N, E))
    t = expert_qtensor_from_gguf(raw, GGMLType[qtype], (K, N, E))
    assert t.qs.shape[:2] == (E, N) and t.layout == j.layout and t.zp == j.zp
    for f in ("qs", "scales", "mins"):
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.asarray(a).dtype == b.numpy().dtype
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
    got = dequantize_qtensor(t).numpy()
    assert got.shape == (E, N, K)
    np.testing.assert_array_equal(got, jax_dequantize_qtensor(j))
    deq = codecs.dequantize(raw, JaxGGMLType[qtype], K).reshape(E, N, K)
    np.testing.assert_allclose(got, deq, atol=1e-6, rtol=1e-6)
    # the same bytes as one K-major matrix [E * N, K]: dequantize_qtensor reads
    # those planes too
    km = dequantize_qtensor(qtensor_from_gguf(raw, GGMLType[qtype], (K, E * N))).numpy()
    np.testing.assert_array_equal(km, jax_dequantize_qtensor(
        jax_qtensor_from_gguf(raw, JaxGGMLType[qtype], (K, E * N))))


def _cf_inputs():
    up, gate, down, h, topi, topw = cf_fixture()
    t = (lambda a: torch.from_numpy(np.array(a)))
    return (up, gate, down, h, topi, topw), tuple(t(a) for a in (up, gate, down, h, topi, topw))


@pytest.mark.parametrize("cf", CFS + [0.0])
def test_dispatch_tables_match_reference(cf):
    """Buckets, combine weights and drop counts at test_moe_cf.py's skewed
    routing (E 8, T 128, k 2) and capacity-factor grid."""
    (_, _, _, _, jtopi, jtopw), (_, _, _, _, topi, topw) = _cf_inputs()
    T, k = topi.shape
    cap = moe.cap_from_cf(cf, T, k, 8)
    assert cap == jax_moe._cap_from_cf(cf, T, k, 8)
    jt, jw, jd = jax_moe.dispatch_tables(jtopi, jtopw, 0, 8, cap)
    tt, tw, td = moe.dispatch_tables(topi, topw, 8, cap)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert int(td) == int(jd)
    if cf == 0.5:
        assert int(td) > 0  # the skewed fixture overflows (test_moe_cf.py)


@pytest.mark.parametrize("cf", [0.0, 1.0, 2.0])
def test_grouped_matches_reference(cf):
    """moe_ffn_grouped over dense f32 stacks at test_moe_cf.py's fixture:
    [T, D] f32 within 1e-5 of llm_tpu's; rows that lost an expert to the
    capacity differ from the exact ones, and only they."""
    (jup, jgate, jdown, jh, jtopi, jtopw), (up, gate, down, h, topi, topw) = _cf_inputs()
    want = np.asarray(jax_moe.moe_ffn_grouped(jh, jup, jgate, jdown, jtopi, jtopw,
                                              jax.nn.silu, cf=cf))
    got = moe.moe_ffn_grouped(h, up, gate, down, topi, topw, torch.nn.functional.silu, cf=cf)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    exact = moe.moe_ffn_grouped(h, up, gate, down, topi, topw, torch.nn.functional.silu)
    T, k = topi.shape
    tok, _, dropped = moe.dispatch_tables(topi, topw, 8, moe.cap_from_cf(cf, T, k, 8))
    kept = np.zeros(T, np.int64)
    np.add.at(kept, tok[tok >= 0].long().numpy(), 1)
    lost = kept < k
    assert int(lost.sum() > 0) == int(int(dropped) > 0)
    np.testing.assert_array_equal(got.numpy()[~lost], exact.numpy()[~lost])
    assert (got.numpy()[lost] != exact.numpy()[lost]).any(axis=1).all()


E_F, D_F, N_F = 6, 64, 32  # the function-level layer: experts, width, expert width


def _layer(seed: int, quantized: bool = False, tie_rows=(), probs_b: bool = False):
    """A random MoE layer for moe_ffn, as (llm_tpu's, the port's): a dense
    f32 router [E, D] (rows in tie_rows copied from row 0, so that those
    experts tie with expert 0), and stacks of E experts, dense f32 or Q8_0
    planes; ffn_exp_probs_b [E] if probs_b."""
    rng = np.random.default_rng(seed)
    router = (rng.normal(size=(E_F, D_F)) * 0.3).astype(np.float32)
    for r in tie_rows:
        router[r] = router[0]
    jl, tl = {"ffn_gate_inp": jnp.asarray(router)}, {"ffn_gate_inp": torch.from_numpy(router)}
    for key, (n, k) in (("ffn_gate_exps", (N_F, D_F)), ("ffn_up_exps", (N_F, D_F)),
                        ("ffn_down_exps", (D_F, N_F))):
        w = (rng.normal(size=(E_F, n, k)) * 0.2).astype(np.float32)
        if quantized:
            raw = codecs.quantize(w.reshape(E_F * n, k), JaxGGMLType.Q8_0)
            jl[key] = jax_expert_qtensor_from_gguf(raw, JaxGGMLType.Q8_0, (k, n, E_F))
            tl[key] = expert_qtensor_from_gguf(raw, GGMLType.Q8_0, (k, n, E_F))
        else:
            jl[key], tl[key] = jnp.asarray(w), torch.from_numpy(w)
    if probs_b:
        b = (rng.normal(size=(E_F,)) * 0.5).astype(np.float32)
        jl["ffn_exp_probs_b"], tl["ffn_exp_probs_b"] = jnp.asarray(b), torch.from_numpy(b)
    return jl, tl


def _cfgs(k: int, **kw):
    """llm_tpu's ModelConfig for a MoE layer of E_F experts, k a token, and
    the port's (config_from_reference of it), and expert_weight_before:
    set on llm_tpu's config, and moe_ffn's weight_before (the converter
    refuses the flag: llama4's)."""
    before = kw.pop("expert_weight_before", False)
    jcfg = JaxModelConfig(arch="llama", vocab_size=16, n_embd=D_F, n_layers=1, n_heads=4,
                          n_kv_heads=4, head_dim=16, head_dim_v=16, n_ff=N_F, n_expert=E_F,
                          n_expert_used=k, **kw)
    cfg = config_from_reference(jcfg)
    return dataclasses.replace(jcfg, expert_weight_before=before), cfg, before


def _h(T: int, seed: int = 1):
    return (np.random.default_rng(seed).normal(size=(T, D_F))).astype(np.float32)


CASES = {
    "softmax-norm": dict(expert_weights_norm=True),
    "softmax-scaled": dict(expert_weights_scale=2.5),
    "sigmoid-probs_b": dict(expert_gating_func="sigmoid", expert_weights_norm=True),
    "weight_before-k1": dict(expert_weight_before=True),
    "weight_before-k2": dict(expert_weight_before=True),
}


@pytest.mark.parametrize("T", [3, 12], ids=["gather", "grouped"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case, T):
    """moe_ffn against llm_tpu's _moe_ffn in f32 at 2e-4: the gating
    functions, the top-k weights' norm and scale, sigmoid gating with the
    selection bias ffn_exp_probs_b, and both expert_weight_before branches
    (k = 1 scales the input and runs the usual paths; k = 2 its own)."""
    k = 1 if case.endswith("k1") else 2
    jl, tl = _layer(5, probs_b=case.startswith("sigmoid"))
    jcfg, cfg, before = _cfgs(k, **CASES[case])
    h = _h(T)
    want = np.asarray(jax_transformer._moe_ffn(jnp.asarray(h), jl, jcfg))
    got = moe_ffn(torch.from_numpy(h), tl, cfg, weight_before=before)
    assert got.shape == (T, D_F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("T", [3, 12], ids=["gather", "grouped"])
def test_moe_ffn_bf16_quantized_matches_reference(T):
    """Q8_0 expert stacks and a bf16 h: the experts dequantized in bf16,
    products rounded to bf16, as llm_tpu's; within 2 bf16 steps of
    max|out|."""
    jl, tl = _layer(6, quantized=True)
    jcfg, cfg, _ = _cfgs(2, expert_weights_norm=True)
    h = _h(T, 2)
    want = np.asarray(jax_transformer._moe_ffn(jnp.asarray(h, jnp.bfloat16), jl, jcfg),
                      np.float32)
    hb = torch.from_numpy(np.asarray(jnp.asarray(h, jnp.bfloat16), np.float32)).to(
        torch.bfloat16)
    got = moe_ffn(hb, tl, cfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 * 2.0 ** -8 * np.abs(want).max(), err


@pytest.mark.parametrize("T", [3, 12], ids=["gather", "grouped"])
def test_router_ties_take_the_lower_expert(T):
    """Experts 0, 2 and 4 share a router row: their probabilities tie
    exactly. jax.lax.top_k takes the lower expert first; so does top_k, and
    moe_ffn's output is llm_tpu's."""
    jl, tl = _layer(7, tie_rows=(2, 4))
    jcfg, cfg, _ = _cfgs(2, expert_weights_norm=True)
    h = _h(T, 3)
    probs = torch.softmax(torch.from_numpy(h) @ tl["ffn_gate_inp"].T, dim=-1)
    assert torch.equal(probs[:, 0], probs[:, 2]) and torch.equal(probs[:, 0], probs[:, 4])
    for k in (2, 3):
        _, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
        np.testing.assert_array_equal(top_k(probs, k).numpy(), np.asarray(want_i))
    # some row takes some of the tied experts and not all: a wrong order of
    # ties would take another
    got_i = top_k(probs, 2)
    assert ((got_i == 0).any(-1) & ~(got_i == 4).any(-1)).any()
    want = np.asarray(jax_transformer._moe_ffn(jnp.asarray(h), jl, jcfg))
    np.testing.assert_allclose(moe_ffn(torch.from_numpy(h), tl, cfg).numpy(), want, **F32_TOL)


@pytest.mark.parametrize("fault", [None, "near_tie", "moved_row", "other_input"])
def test_route_twin_follows_only_near_ties(fault):
    """chip_smoke.py's RouteTwin over moe_ffn: a run recorded on a layer
    whose experts 0 and 2 tie, then followed. The same run, or one whose
    router row 2 leans 1e-3 off row 0 (a near tie: the follower would pick
    expert 2 where the record has 0), follows and takes the recorded
    experts; both planted faults are refused. A router row whose weights
    moved, or another input, is refused."""
    from chip_smoke import RouteTwin

    _, tl = _layer(8, tie_rows=(2,))
    _, cfg, _ = _cfgs(1, expert_weights_norm=True)
    h = torch.from_numpy(_h(12, 4))
    follower, h2 = dict(tl), h
    router = tl["ffn_gate_inp"].clone()
    if fault == "near_tie":
        router[2] = router[0] * 1.001
    elif fault == "moved_row":
        router[3] = router[3] * 3
    elif fault == "other_input":
        h2 = torch.from_numpy(_h(12, 9))
    follower["ffn_gate_inp"] = router
    with RouteTwin() as route:
        route.mode = "record"
        want = moe_ffn(h, tl, cfg)
        route.follow()
        if fault in ("moved_row", "other_input"):
            with pytest.raises(AssertionError):
                moe_ffn(h2, follower, cfg)
            return
        got = moe_ffn(h2, follower, cfg)
    route.followed_all("the follower")
    route.planted_fault()
    assert (route.flips > 0) == (fault == "near_tie")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-5)
