"""The port's engine end to end against llm_tpu's on the same tiny Q4_K_M
GGUF (made by llm_tpu's HF converter and quantizer, so it carries Q4_K
and Q6_K tensors): prefill logits, one decode step, greedy generate_loop
tokens, sequence ids >= 32, drop-mode padding writes, and
params_from_reference on a synthetic model. The q8_0 KV cache likewise:
its quantizing scatter against _kv_write, and the engine with a q8 cache
against llm_tpu's with group scales (head_dim 64, the unfused path on both
sides) and per-row scales (head_dim 128, llm_tpu's _kernel_q8 against the
port's plain K3q/K4q).

Both sides compute in f32 for the tight comparison: llm_tpu's qmm is
forced through its Pallas kernel in interpret mode with an f32 compute
dtype, and its flash kernels run in interpret mode
(LLM_TPU_FLASH_FORCE=interpret), as tests/test_flash_e2e.py does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.constants import GGMLType
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models.synthetic import make_synthetic_model as jax_make_synthetic_model
from llm_tpu.models.transformer import _kv_write as jax_kv_write
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.quant.qtensor import QTensor as JaxQTensor
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model

from llm_tpu_torch.convert_params import params_from_reference
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.synthetic import make_synthetic_model
from llm_tpu_torch.models.transformer import kv_write
from llm_tpu_torch.ops import cuda_attn, qmatmul
from llm_tpu_torch.quant.qtensor import QTensor
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def q4km_gguf(tmp_path_factory):
    cfg = transformers.LlamaConfig(
        vocab_size=384, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attention_bias=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp("q4km")
    f32 = str(d / "tiny_f32.gguf")
    out = str(d / "tiny_q4km.gguf")
    convert_hf_llama(model, f32)
    quantize_model(f32, out, "Q4_K_M")
    return out


@pytest.fixture
def f32_both(monkeypatch):
    """llm_tpu in f32 through its interpreted kernels; the port in f32."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)
    jax_qmatmul.set_backend("pallas", interpret=True)
    try:
        yield
    finally:
        jax_qmatmul.set_backend("auto")


def test_gguf_has_q4k_and_q6k(q4km_gguf):
    types = {t.ggml_type for t in GGUFReader(q4km_gguf).tensors.values()}
    assert {GGMLType.Q4_K, GGMLType.Q6_K} <= types


def test_engine_matches_reference(q4km_gguf, f32_both):
    prompt = [5, 17, 300, 2, 99, 42, 7, 381, 64, 11]  # T=10 -> bucket 16, prefill path
    ref = JaxContext(JaxGGUFReader(q4km_gguf), n_cells=64, dtype=jnp.float32)
    ctx = Context(GGUFReader(q4km_gguf), n_cells=64, dtype=torch.float32, device="cpu")
    assert "attn_qkv_fused" not in ctx.params["layers"][0]  # Q6_K attn_v: unfused
    assert "attn_qkv_fused" in ctx.params["layers"][1]

    assert ref.decode(JaxBatch.text(prompt)) == 0
    assert ctx.decode(Batch.text(prompt)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **TOL)

    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0
    assert ctx.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **TOL)

    nxt = int(np.argmax(ref.get_logits()))
    want = ref.generate_loop(nxt, 8, seq_id=0)
    got = ctx.generate_loop(nxt, 8, seq_id=0)
    assert got == want
    assert ctx.seq_pos_max(0) == ref.seq_pos_max(0) == len(prompt) + 8


def test_generate_loop_matches_serial_decode(q4km_gguf, f32_both):
    ctx = Context(GGUFReader(q4km_gguf), n_cells=64, dtype=torch.float32, device="cpu")
    ctx2 = Context(GGUFReader(q4km_gguf), n_cells=64, dtype=torch.float32, device="cpu")
    for c in (ctx, ctx2):
        assert c.decode(Batch.text([1, 2, 3, 4])) == 0
    first = int(np.argmax(ctx.get_logits()))
    serial = []
    tok = first
    for _ in range(5):
        assert ctx2.decode(Batch.one(tok)) == 0
        tok = int(np.argmax(ctx2.get_logits()))
        serial.append(tok)
    assert ctx.generate_loop(first, 5) == serial
    sampled = ctx.generate_loop(3, 4, temp=0.8, top_k=10, seed=1, seq_id=1)
    assert len(sampled) == 4 and all(0 <= t < 384 for t in sampled)


def _dense_ctx(n_cells=64):
    params, cfg = make_synthetic_model(n_embd=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                       n_ff=128, vocab=64, qtype=None,
                                       dtype=torch.float32, fuse=False, device="cpu")
    return Context(None, n_cells=n_cells, dtype=torch.float32, device="cpu",
                   params_cfg=(params, cfg))


def test_context_shift_is_metadata_only():
    """K is cached unroped, so shifting a sequence's positions (seq_add)
    gives the logits of the same text decoded at the shifted positions;
    seq_div halves them as self-extend does; generate_loop stops at EOG."""
    toks = [3, 1, 4, 1, 5, 9]
    a, b = _dense_ctx(), _dense_ctx()
    assert a.decode(Batch.text(toks)) == 0
    a.seq_add(0, 0, -1, 10)
    assert a.seq_pos_max(0) == 15
    assert a.decode(Batch.one(2)) == 0  # position 16
    assert b.decode(Batch.text(toks, pos_start=10)) == 0
    assert b.decode(Batch.one(2)) == 0
    np.testing.assert_allclose(a.get_logits(), b.get_logits(), atol=1e-5, rtol=1e-5)
    a.seq_div(0, 0, -1, 2)
    assert a.seq_pos_max(0) == 8
    c, d = _dense_ctx(), _dense_ctx()
    for ctx in (c, d):
        assert ctx.decode(Batch.text(toks)) == 0
    free = c.generate_loop(7, 6)
    assert d.generate_loop(7, 6, eog_ids=(free[2],)) == free[:free.index(free[2]) + 1]


def test_seq_ids_above_32():
    """As llm_tpu's test_engine.py::test_seq_ids_above_32, on the port:
    high sequence ids (multi-word bit-sets) are isolated."""
    params, cfg = make_synthetic_model(n_embd=64, n_layers=2, n_heads=4, n_kv_heads=4,
                                       n_ff=128, vocab=64, qtype=None,
                                       dtype=torch.float32, fuse=False, device="cpu")
    ctx = Context(None, n_cells=64, dtype=torch.float32, device="cpu",
                  params_cfg=(params, cfg))
    toks = [3, 1, 4, 1, 5]
    assert ctx.decode(Batch.text(toks, seq_id=2)) == 0
    ref = ctx.get_logits()
    assert ctx.decode(Batch.text(toks, seq_id=40)) == 0
    np.testing.assert_allclose(ctx.get_logits(), ref, atol=1e-6)
    assert ctx.decode(Batch.text([9, 9, 9], seq_id=63)) == 0
    assert ctx.decode(Batch.one(7, pos=len(toks), seq_id=40)) == 0
    got40 = ctx.get_logits()
    assert ctx.decode(Batch.one(7, pos=len(toks), seq_id=2)) == 0
    np.testing.assert_allclose(ctx.get_logits(), got40, atol=1e-6)
    ctx.seq_rm(63)
    assert ctx.seq_pos_max(63) == -1
    assert ctx.decode(Batch.text(toks, seq_id=255)) == 0
    np.testing.assert_allclose(ctx.get_logits(), ref, atol=1e-6)
    ctx.seq_cp(255, 130)
    assert ctx.decode(Batch.one(7, pos=len(toks), seq_id=130)) == 0
    np.testing.assert_allclose(ctx.get_logits(), got40, atol=1e-6)
    ctx.seq_keep(130)
    assert ctx.seq_pos_max(255) == -1 and ctx.seq_pos_max(130) == len(toks)
    assert ctx.decode(Batch.one(1, seq_id=256)) == -1


def test_drop_mode_padding_writes():
    """Padding tokens carry write index == n_cells and are dropped, as the
    reference's .at[].set(mode="drop") scatter drops them."""
    rng = np.random.default_rng(0)
    cache = rng.normal(size=(2, 8, 4)).astype(np.float32)
    val = rng.normal(size=(4, 2, 4)).astype(np.float32)
    idx = np.asarray([5, 1, 8, 8], np.int32)  # two padding rows
    want = np.asarray(jax_kv_write(jnp.asarray(cache), jnp.asarray(idx), jnp.asarray(val)))
    got = torch.from_numpy(cache.copy())
    kv_write(got, torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), want)

    params, cfg = make_synthetic_model(n_embd=64, n_layers=1, n_heads=4, n_kv_heads=2,
                                       n_ff=128, vocab=64, qtype=None, dtype=torch.float32,
                                       device="cpu")
    ctx = Context(None, n_cells=16, dtype=torch.float32, device="cpu",
                  params_cfg=(params, cfg))
    assert ctx.decode(Batch.text([1, 2, 3, 4, 5])) == 0  # T=8: three padding rows
    written = ctx.kv.k[0].abs().sum(dim=(0, 2)) > 0
    assert written.tolist() == [True] * 5 + [False] * 11


def test_synthetic_model_defaults_to_the_card():
    """Like Context, make_synthetic_model runs on the card unless the
    caller names the CPU: without a GPU the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is valid here")
    with pytest.raises(RuntimeError):
        make_synthetic_model(n_layers=1)
    params, _ = make_synthetic_model(n_layers=1, device="cpu")
    assert params["output_norm"].device.type == "cpu"


def _near_tie(vf, d, n_groups):
    """|v * inv - (n + 1/2)| for the quantizer's f32 arithmetic, per element."""
    g = vf.reshape(*vf.shape[:-1], n_groups, d // n_groups)
    scale = np.abs(g).max(axis=-1, keepdims=True) / np.float32(127.0)
    with np.errstate(divide="ignore"):
        inv = np.where(scale > 0, np.float32(1.0) / scale, np.float32(0.0)).astype(np.float32)
    x = (g * inv).astype(np.float32)
    return np.abs(x - (np.floor(x) + np.float32(0.5))).reshape(vf.shape)


@pytest.mark.parametrize("D,n_groups", [(128, 1), (64, 2)], ids=["per-row", "group32"])
def test_q8_kv_scatter_matches_reference(D, n_groups):
    """kv_write on an (int8, scales) pair against llm_tpu's _kv_write, with
    two padding rows (write index == n_cells) that both drop: the bf16
    scales bit-equal, the int8 planes equal but for a step at a rounding
    tie (|v*inv - (n + 1/2)| < 1e-5). Both quantize in f32 with the same
    operations; on these inputs no element differs."""
    rng = np.random.default_rng(11)
    Hkv, S, T = 3, 16, 6
    q8 = rng.integers(-127, 128, size=(Hkv, S, D)).astype(np.int8)
    sc = np.asarray(jnp.asarray(rng.random((Hkv, S, n_groups)), jnp.bfloat16))
    val = (rng.normal(size=(T, Hkv, D)) * rng.random((T, Hkv, 1)) * 4).astype(np.float32)
    val[3, 1] = 0.0  # an all-zero row (head 1 of cell 9): scale 0, q 0
    idx = np.asarray([5, 1, S, 9, 0, S], np.int32)
    wq, ws = jax_kv_write((jnp.asarray(q8), jnp.asarray(sc)), jnp.asarray(idx),
                          jnp.asarray(val))
    got = (torch.from_numpy(q8.copy()),
           torch.from_numpy(sc.astype(np.float32)).to(torch.bfloat16))
    kv_write(got, torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(val))
    gs = got[1].view(torch.int16).numpy()
    np.testing.assert_array_equal(gs, np.asarray(ws).view(np.int16))
    diff = got[0].numpy().astype(np.int16) - np.asarray(wq).astype(np.int16)
    assert np.abs(diff).max() <= 1
    tie = _near_tie(val, D, n_groups).transpose(1, 0, 2)  # head-major like the cache
    kept = [0, 1, 3, 4]
    moved = diff[:, idx[kept]] != 0
    assert (tie[:, kept][moved] < 1e-5).all()
    assert int(moved.sum()) == 0
    untouched = np.setdiff1d(np.arange(S), idx[kept])
    np.testing.assert_array_equal(got[0].numpy()[:, untouched], q8[:, untouched])
    np.testing.assert_array_equal(gs[:, untouched], sc.view(np.int16)[:, untouched])
    assert (got[0].numpy()[1, 9] == 0).all() and gs[1, 9].tolist() == [0] * n_groups


def _q8_engines_agree(ref, ctx, prompt, tol=TOL):
    """Prefill logits and one decode step within tol, then 8 greedy tokens
    of generate_loop equal."""
    assert ref.decode(JaxBatch.text(prompt)) == 0
    assert ctx.decode(Batch.text(prompt)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **tol)
    first = int(np.argmax(ref.get_logits()))
    assert ref.decode(JaxBatch.one(first)) == 0
    assert ctx.decode(Batch.one(first)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **tol)
    nxt = int(np.argmax(ref.get_logits()))
    assert ctx.generate_loop(nxt, 8) == ref.generate_loop(nxt, 8)


def test_engine_q8_cache_group_scales_matches_reference(q4km_gguf, f32_both):
    """head_dim 64: 32-group scales, dequantized to the unfused attention."""
    prompt = [5, 17, 300, 2, 99, 42, 7, 381, 64, 11]
    ref = JaxContext(JaxGGUFReader(q4km_gguf), n_cells=64, dtype=jnp.float32,
                     kv_dtype="q8_0")
    ctx = Context(GGUFReader(q4km_gguf), n_cells=64, dtype=torch.float32, device="cpu",
                  kv_dtype="q8_0")
    kq, ks = ctx.kv.k[0]
    assert kq.dtype == torch.int8 and tuple(ks.shape) == (2, 64, 2)
    _q8_engines_agree(ref, ctx, prompt)


def _f32_product(kv):
    return kv[0].float() * kv[1].float() if isinstance(kv, tuple) else kv.float()


@pytest.mark.parametrize("dequant", ["f32-product", "bf16"])
def test_engine_q8_cache_row_scales_matches_reference(f32_both, monkeypatch, dequant):
    """head_dim 128: one scale per head row, llm_tpu's flash kernels in
    interpret mode (_kernel_q8, _prefill_kernel_q8) against the port's
    plain K3q/K4q.

    The TPU kernel dequantizes as bf16(q) * bf16(s) rounded to bf16, and so
    does the port. In interpret mode on the CPU, XLA folds that rounding
    away (convert-to-bf16, multiply, convert-to-f32 becomes the exact f32
    product), so llm_tpu computes q * s unrounded here. With the port's
    dequant set to that f32 product the engines agree at 2e-4 (measured
    <= 6.3e-6 over 6 prompts); with the port's own bf16 rounding, each K/V
    element moves by at most 2^-9 of itself and the logits by up to 0.011
    of max|logit| ~2.3 (6 prompts), so that case is held at 3e-2, about 3x
    the worst reading. Greedy tokens are equal in both."""
    if dequant == "f32-product":
        monkeypatch.setattr(cuda_attn, "dequant_bf16", _f32_product)
    tol = TOL if dequant == "f32-product" else dict(atol=3e-2, rtol=0)
    geo = dict(n_embd=256, n_layers=2, n_heads=2, n_kv_heads=1, n_ff=512, vocab=256)
    jp, jcfg = jax_make_synthetic_model(qtype=GGMLType.Q4_K, seed=4, **geo)
    params, cfg = params_from_reference(_to_numpy(jp), jcfg)
    assert cfg.head_dim == 128
    ref = JaxContext(None, n_cells=48, dtype=jnp.float32, params_cfg=(jp, jcfg),
                     kv_dtype="q8_0")
    ctx = Context(None, n_cells=48, dtype=torch.float32, device="cpu",
                  params_cfg=(params, cfg), kv_dtype="q8_0")
    assert tuple(ctx.kv.v[1][1].shape) == (1, 48, 1)
    _q8_engines_agree(ref, ctx, [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8], tol)


def test_quantized_kv_cache_close_to_bf16(q4km_gguf):
    """As llm_tpu's test_engine.py::test_quantized_kv_cache_close_to_bf16,
    on the port: a q8_0 cache keeps the top-1 token and the logits close."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    ref = Context(GGUFReader(q4km_gguf), n_cells=64, dtype=torch.float32, device="cpu")
    ref.decode(Batch.text(prompt))
    want = ref.get_logits()
    qctx = Context(GGUFReader(q4km_gguf), n_cells=64, dtype=torch.float32, device="cpu",
                   kv_dtype="q8_0")
    assert qctx.decode(Batch.text(prompt)) == 0
    got = qctx.get_logits()
    assert int(np.argmax(got)) == int(np.argmax(want))
    assert np.max(np.abs(got - want)) < 0.05
    assert qctx.decode(Batch.one(int(np.argmax(got)))) == 0


def test_generate_loop_q8_cache(q4km_gguf):
    """As llm_tpu's test_engine.py::test_generate_loop_q8_cache, on the
    port: generate_loop over the q8_0 cache matches serial decode."""
    prompt = [3, 1, 4, 1, 5]
    serial = Context(GGUFReader(q4km_gguf), n_cells=64, dtype=torch.float32, device="cpu",
                     kv_dtype="q8_0")
    assert serial.decode(Batch.text(prompt, seq_id=0)) == 0
    toks = [int(np.argmax(serial.get_logits()))]
    for i in range(7):
        assert serial.decode(Batch.one(toks[-1], pos=len(prompt) + i, seq_id=0)) == 0
        toks.append(int(np.argmax(serial.get_logits())))
    ctx = Context(GGUFReader(q4km_gguf), n_cells=64, dtype=torch.float32, device="cpu",
                  kv_dtype="q8_0")
    assert ctx.decode(Batch.text(prompt, seq_id=0)) == 0
    assert ctx.generate_loop(toks[0], 7, seq_id=0) == toks[1:8]


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


def test_params_from_reference_synthetic(f32_both):
    geo = dict(n_embd=256, n_layers=2, n_heads=4, n_kv_heads=2, n_ff=512, vocab=256)
    jp, jcfg = jax_make_synthetic_model(qtype=GGMLType.Q4_K, seed=3, **geo)
    params, cfg = params_from_reference(_to_numpy(jp), jcfg)
    assert cfg.n_heads == 4 and cfg.head_dim == 64 and cfg.rope.mode == jcfg.rope.mode
    # the port's own host generator makes the same planes from the same seed
    own, _ = make_synthetic_model(qtype=GGMLType.Q4_K, seed=3, device="cpu", **geo)
    a, b = params["layers"][1]["ffn_gateup_fused"], own["layers"][1]["ffn_gateup_fused"]
    assert isinstance(a, QTensor) and torch.equal(a.qs, b.qs)
    assert torch.equal(a.scales, b.scales) and torch.equal(a.mins, b.mins)

    toks = [3, 1, 4, 1, 5, 9, 2, 6]
    ref = JaxContext(None, n_cells=32, dtype=jnp.float32, params_cfg=(jp, jcfg))
    ctx = Context(None, n_cells=32, dtype=torch.float32, device="cpu",
                  params_cfg=(params, cfg))
    assert ref.decode(JaxBatch.text(toks)) == 0 and ctx.decode(Batch.text(toks)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **TOL)
