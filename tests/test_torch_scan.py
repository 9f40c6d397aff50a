"""The scan decoder of the port (layers stacked into [L, ...] leaves, every
layer matmul on K7 = K1/K2/K5 on one layer of the stacked planes) held
against llm_tpu's: K7's plain version against qmm_pallas(lidx=...,
interpret=True), stack_layers of both packages, forward with
layers_stacked, Context(scan_layers=True) on a Q8_0 GGUF and on llm_tpu's
scan-mode params through convert_params (with gdot, and with chain, where
only the lm_head chains), the port's scan Context against its per-layer
one, and state files on a scan Context.

llm_tpu runs its kernels in interpret mode (set_backend("pallas",
interpret=True), LLM_TPU_FLASH_FORCE=interpret), as test_torch_chain.py
does, and a counter on llm_tpu.ops.qmatmul.qmm_pallas shows that it took
the stacked (lidx) path: its tile picker sends N below 128 to
_slice_stacked, so every width here is 128-aligned. Tolerances as
test_pallas_qmm.py: 2e-4 of max|y| when both sides compute in f32, 2e-2 in
bf16."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.constants import GGMLType
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.models.loader import load_params as jax_load_params
from llm_tpu.models.loader import stack_layers as jax_stack_layers
from llm_tpu.models.synthetic import make_synthetic_model as jax_make_synthetic_model
from llm_tpu.models.transformer import forward as jax_forward
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.ops.pallas_qmm import pack_p4_kmajor as jax_pack_p4_kmajor
from llm_tpu.ops.pallas_qmm import qmm_pallas
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.tools.quantize import quantize_model

from llm_tpu_torch.convert_params import params_from_reference
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.models.loader import load_params, stack_layers
from llm_tpu_torch.models.transformer import forward, layer_views
from llm_tpu_torch.ops import cuda_qmm, cuda_qmm_chain, qmatmul
from llm_tpu_torch.ops.cuda_qmm import qmm_gdot_plain, qmm_plain, qmm_stacked_plain
from llm_tpu_torch.quant.qtensor import QTensor, StackedWeight
from llm_tpu_torch.runtime import state
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.runtime.kv_cache import SEQ_WORDS, new_kv_arrays

L = 3
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
TOL = dict(atol=2e-4, rtol=2e-4)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _stack_planes(layout, zp, gs, mins, K=512, N=256, B=5, seed=0):
    """L layers of random planes, each different, stacked; x [B, K]."""
    rng = np.random.default_rng(seed)
    qs, sc, mn = [], [], []
    for _ in range(L):
        if layout == "p4":
            q = rng.integers(0, 16, size=(K, N)).astype(np.int16)
            qs.append(jax_pack_p4_kmajor(q - zp, zp, 256))
        else:
            qs.append(rng.integers(-32, 32, size=(K, N)).astype(np.int8))
        sc.append(((rng.random((K // gs, N)) + 0.5) * 0.01).astype(np.float32))
        mn.append((rng.random((K // gs, N)) * 0.05).astype(np.float32))
    qs, sc = np.stack(qs), np.stack(sc)
    mn = np.stack(mn) if mins else None
    x = rng.normal(size=(B, K)).astype(np.float32)
    qt = QTensor(torch.from_numpy(qs), torch.from_numpy(sc),
                 None if mn is None else torch.from_numpy(mn), gs, GGMLType.Q4_K, layout, zp)
    return x, qs, sc, mn, qt


K7_CASES = [  # layout, zp, gs, mins, gdot
    ("p4", 0, 32, True, False),   # Q4_K: stacked K1
    ("p4", 8, 32, False, False),  # Q4_0
    ("i8", 0, 16, False, False),  # Q6_K: stacked K2
    ("i8", 0, 32, False, False),  # Q8_0
    ("p4", 0, 32, True, True),    # Q4_K, group-factored: stacked K5
    ("p4", 0, 16, True, False),   # Q2_K: nibble planes at group size 16
    ("p4", 4, 16, False, True),   # Q3_K (zero point 4), group-factored
    ("p4", 1, 256, False, False),  # TQ2_0: nibble planes at group size 256
    ("p4", 1, 256, False, True),   # TQ2_0, group-factored
    ("i8", 0, 8, False, False),    # IQ1_M: int8 planes at group size 8
]


@pytest.mark.parametrize("cdtype,tol", [("f32", 2e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("layout,zp,gs,mins,gdot", K7_CASES,
                         ids=["q4k", "q4_0", "q6k", "q8_0", "q4k-gdot", "q2k", "q3k-gdot",
                              "tq2_0", "tq2_0-gdot", "iq1_m"])
def test_k7_plain_matches_pallas(layout, zp, gs, mins, gdot, cdtype, tol):
    x, qs, sc, mn, qt = _stack_planes(layout, zp, gs, mins)
    jdt, tdt = ((jnp.float32, torch.float32) if cdtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    for il in (0, L - 1):
        want = np.asarray(qmm_pallas(
            jnp.asarray(x), jnp.asarray(qs), jnp.asarray(sc),
            None if mn is None else jnp.asarray(mn), gs=gs, zp=zp, layout=layout,
            tile_n=128, tile_k=256, interpret=True, compute_dtype=jdt,
            lidx=jnp.asarray([il], jnp.int32), gdot=gdot))
        sw = StackedWeight(qt, torch.tensor([il], dtype=torch.int32))
        got = qmm_stacked_plain(torch.from_numpy(x), sw, tdt, gdot=gdot).numpy()
        assert got.shape == want.shape == (x.shape[0], qt.qs.shape[-1])
        assert _rel(got, want) < tol
        # the layer's planes through the unstacked function: the same numbers
        layer = qt.map(lambda t: t[il])
        plain = (qmm_gdot_plain if gdot else qmm_plain)(torch.from_numpy(x), layer, tdt)
        assert torch.equal(torch.from_numpy(got), plain)


@pytest.mark.parametrize("gdot", [False, True])
def test_qmm_routes_stacked_planes_to_k7(monkeypatch, gdot):
    """qmm(x, StackedWeight) takes K7 (its gdot variant where the layer's
    shape passes K5's gate); a dense stacked weight takes the layer's copy."""
    calls = []
    monkeypatch.setattr(cuda_qmm, "qmm_stacked_plain",
                        lambda *a: calls.append(a[3]) or qmm_stacked_plain(*a))
    x, _, _, _, qt = _stack_planes("p4", 0, 32, True, B=3)
    xt = torch.from_numpy(x)
    sw = StackedWeight(qt, torch.tensor([1], dtype=torch.int32))
    got = qmatmul.qmm(xt, sw, gdot=gdot)
    want = (qmm_gdot_plain if gdot else qmm_plain)(xt, qt.map(lambda t: t[1]), torch.bfloat16)
    assert torch.equal(got, want) and calls == [gdot]
    dense = torch.from_numpy(np.random.default_rng(1).normal(size=(L, 7, 512))).float()
    y = qmatmul.qmm(xt, StackedWeight(dense, torch.tensor([2], dtype=torch.int32)))
    assert torch.equal(y, xt @ dense[2].T)


def test_stack_layers_refuses_what_differs():
    _, _, _, _, qt = _stack_planes("p4", 0, 32, True)
    one = qt.map(lambda t: t[0])
    base = {"attn_norm": torch.ones(512), "w": one}
    assert stack_layers([]) is None
    stacked = stack_layers([base, dict(base)])
    assert stacked["w"].qs.shape == (2,) + one.qs.shape
    assert stacked["attn_norm"].shape == (2, 512) and stacked["w"].ggml_type == one.ggml_type
    for other in ({"attn_norm": torch.ones(512)},                        # keys
                  {**base, "attn_norm": torch.ones(256)},                # a shape
                  {**base, "attn_norm": torch.ones(512, dtype=torch.float64)},  # a dtype
                  {**base, "w": QTensor(one.qs, one.scales, None, 32, one.ggml_type, "p4")},
                  {**base, "w": QTensor(one.qs, one.scales, one.mins, 16, one.ggml_type, "p4")},
                  {**base, "w": QTensor(one.qs, one.scales, one.mins, 32, GGMLType.Q4_0, "p4")},
                  {**base, "w": torch.ones(3)}):                         # not a QTensor
        assert stack_layers([base, other]) is None


@pytest.fixture(scope="module")
def scan_ggufs(tmp_path_factory):
    """test_torch_chain.py's tiny llama (128-aligned widths) at Q4_K_M
    (whose Q6_K use_more_bits layer keeps its layers from stacking) and
    Q8_0 (uniform: it stacks)."""
    cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False, attention_bias=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp("scan")
    f32 = str(d / "f32.gguf")
    convert_hf_llama(model, f32)
    paths = {}
    for ftype in ("Q4_K_M", "Q8_0"):
        paths[ftype] = str(d / f"{ftype}.gguf")
        quantize_model(f32, paths[ftype], ftype)
    return paths


def test_stack_layers_agrees_with_reference(scan_ggufs):
    jp, _ = jax_load_params(JaxGGUFReader(scan_ggufs["Q4_K_M"]))
    tp, _ = load_params(GGUFReader(scan_ggufs["Q4_K_M"]), device="cpu")
    assert jax_stack_layers(jp["layers"]) is None and stack_layers(tp["layers"]) is None
    jp, _ = jax_load_params(JaxGGUFReader(scan_ggufs["Q8_0"]))
    tp, _ = load_params(GGUFReader(scan_ggufs["Q8_0"]), device="cpu")
    js, ts = jax_stack_layers(jp["layers"]), stack_layers(tp["layers"])
    assert js is not None and ts is not None and set(js) == set(ts)
    for key, tv in ts.items():
        jv = js[key]
        if isinstance(tv, QTensor):
            for f in ("group_size", "layout", "zp", "pack_tk", "kmajor"):
                assert getattr(tv, f) == getattr(jv, f)
            assert int(tv.ggml_type) == int(jv.ggml_type)
            pairs = [(tv.qs, jv.qs), (tv.scales, jv.scales)]
            assert (tv.mins is None) == (jv.mins is None)
        else:
            pairs = [(tv, jv)]
        for t, j in pairs:
            assert t.numpy().tobytes() == np.asarray(j).tobytes()
    # loading with scan_layers stacks the uniform file and not the mixed one
    q8, _ = load_params(GGUFReader(scan_ggufs["Q8_0"]), device="cpu", scan_layers=True)
    q4, _ = load_params(GGUFReader(scan_ggufs["Q4_K_M"]), device="cpu", scan_layers=True)
    assert q8["layers"] == [] and "layers_stacked" in q8
    assert "layers_stacked" not in q4 and len(q4["layers"]) == 2


@pytest.fixture
def reference(monkeypatch):
    """llm_tpu with its kernels in interpret mode, f32 on both sides, and a
    count of the reference's qmm_pallas calls that carry a layer index."""
    monkeypatch.setenv("LLM_TPU_FLASH_FORCE", "interpret")
    monkeypatch.setenv("LLM_TPU_GDOT", "0")
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)
    n = {"lidx": 0}

    def counted(*a, **kw):
        n["lidx"] += kw.get("lidx") is not None
        return qmm_pallas(*a, **kw)
    monkeypatch.setattr(jax_qmatmul, "qmm_pallas", counted)
    jax_qmatmul.set_backend("pallas", interpret=True)
    try:
        yield n
    finally:
        jax_qmatmul.set_backend("auto")


@pytest.fixture
def k7_calls(monkeypatch):
    """Calls of K7's plain version and of K6's (what runs them on the CPU)."""
    n = {"K7": 0, "K6": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    wrap(cuda_qmm, "qmm_stacked_plain", "K7")
    wrap(cuda_qmm_chain, "qmm_chain_plain", "K6")
    return n


def _engines(ref, ctx, calls, per_step):
    """Prefill (10 tokens), one decode step (counted), 8 greedy tokens."""
    assert ref.decode(JaxBatch.text(PROMPT)) == 0
    assert ctx.decode(Batch.text(PROMPT)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **TOL)
    first = int(np.argmax(ref.get_logits()))
    before = dict(calls)
    assert ref.decode(JaxBatch.one(first)) == 0
    assert ctx.decode(Batch.one(first)) == 0
    assert {k: calls[k] - before[k] for k in calls} == per_step
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()), **TOL)
    nxt = int(np.argmax(ref.get_logits()))
    assert int(np.argmax(ctx.get_logits())) == nxt
    assert ctx.generate_loop(nxt, 8) == ref.generate_loop(nxt, 8)


def test_engine_scan_gguf_matches_reference(scan_ggufs, reference, k7_calls):
    """Q8_0 (uniform, so both packages stack it): every layer matmul on K7's
    int8 planes, the lm_head on K2."""
    path = scan_ggufs["Q8_0"]
    ref = JaxContext(JaxGGUFReader(path), n_cells=32, dtype=jnp.float32, scan_layers=True)
    ctx = Context(GGUFReader(path), n_cells=32, dtype=torch.float32, device="cpu",
                  scan_layers=True)
    assert "layers_stacked" in ref.params and ctx.scan and ctx.params["layers"] == []
    _engines(ref, ctx, k7_calls, {"K7": 4 * 2, "K6": 0})
    assert reference["lidx"] > 0


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


GEO = dict(n_embd=256, n_layers=L, n_heads=2, n_kv_heads=1, n_ff=512, vocab=256)


@pytest.mark.parametrize("opts", [{}, {"gdot": True}, {"chain": True, "gdot": True}],
                         ids=["plain", "gdot", "chain"])
def test_converted_scan_params_match_reference(reference, k7_calls, monkeypatch, opts):
    """llm_tpu's scan-mode params (Context(scan_layers=True) stacks them:
    "layers_stacked", "layers" empty) through params_from_reference keep
    their stacked layers and give llm_tpu's logits and greedy tokens. With
    gdot every layer matmul takes K7's group-factored variant; with chain
    the layers stay unchained (K6's gates refuse stacked planes, in both
    packages) and only the final norm -> lm_head runs K6."""
    if opts.get("gdot"):
        monkeypatch.setenv("LLM_TPU_GDOT", "force")
    if opts.get("chain"):
        monkeypatch.setenv("LLM_TPU_CHAIN", "1")
        monkeypatch.setenv("LLM_TPU_CHAIN_FORCE", "interpret")
    jp, jcfg = jax_make_synthetic_model(qtype=GGMLType.Q4_K, seed=4, **GEO)
    ref = JaxContext(None, n_cells=32, dtype=jnp.float32, params_cfg=(jp, jcfg),
                     scan_layers=True)
    assert ref.params["layers"] == [] and "layers_stacked" in ref.params
    params, cfg = params_from_reference(_to_numpy(ref.params), ref.cfg)
    assert params["layers"] == [] and params["layers_stacked"]["ffn_down"].qs.shape[0] == L
    ctx = Context(None, n_cells=32, dtype=torch.float32, device="cpu",
                  params_cfg=(params, cfg), **opts)
    assert ctx.scan
    _engines(ref, ctx, k7_calls, {"K7": 4 * L, "K6": int(bool(opts.get("chain")))})
    assert reference["lidx"] > 0


def test_forward_stacked_matches_reference(reference):
    """One prefill step of forward with layers_stacked against llm_tpu's
    scan forward (lax.scan over StackedWeight layers), in f32."""
    jp, jcfg = jax_make_synthetic_model(qtype=GGMLType.Q4_K, seed=6, **GEO)
    jst = dict(jp, layers_stacked=jax_stack_layers(jp["layers"]), layers=[])
    params, cfg = params_from_reference(_to_numpy(jst), jcfg)
    S, T = 16, len(PROMPT)
    hd = jcfg.head_dim
    kv = (jnp.zeros((L, jcfg.n_kv_heads, S, hd), jnp.float32),) * 2
    bits = np.zeros((S, SEQ_WORDS), np.uint32)
    bits[:T, 0] = 1
    cpos = np.full(S, -1, np.int64)
    cpos[:T] = np.arange(T)
    steps = dict(tokens=np.asarray(PROMPT), pos=np.arange(T), seq=np.zeros(T, np.int64),
                 widx=np.arange(T), cpos=cpos)
    i32 = {k: jnp.asarray(v, jnp.int32) for k, v in steps.items()}
    want = jax_forward(jst, jcfg, kv[0], kv[1], i32["tokens"], i32["pos"], i32["seq"],
                       i32["widx"], i32["cpos"], jnp.asarray(bits),
                       jnp.arange(T, dtype=jnp.int32), dtype=jnp.float32)[0]
    tkv = new_kv_arrays(L, S, cfg.n_kv_heads, hd, hd, torch.float32, "cpu")
    t64 = {k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in steps.items()}
    got, _ = forward(params, cfg, tkv.k, tkv.v, t64["tokens"], t64["pos"], t64["seq"],
                     t64["widx"], t64["cpos"], torch.from_numpy(bits.astype(np.int64)),
                     torch.arange(T), dtype=torch.float32,
                     stacked_layers=layer_views(params["layers_stacked"]))
    assert reference["lidx"] > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("opts", [{}, {"gdot": True}, {"kv_dtype": "q8_0"},
                                  {"chain": True, "gdot": True}],
                         ids=["plain", "gdot", "q8_0", "chain"])
def test_scan_context_equals_per_layer_context(scan_ggufs, opts):
    """On the CPU the scan path computes exactly the per-layer path's
    function (K7's plain version is K1/K2/K5's on the layer's copy): equal
    logits, bit for bit, and equal greedy tokens. Under chain both run
    unchained steps for the 10-token prefill; the decode steps of the
    per-layer path chain, so there only the prefill is held equal."""
    path = scan_ggufs["Q8_0"]
    per_layer = Context(GGUFReader(path), n_cells=32, device="cpu", **opts)
    scan = Context(GGUFReader(path), n_cells=32, device="cpu", scan_layers=True, **opts)
    assert scan.scan and not per_layer.scan
    for c in (per_layer, scan):
        assert c.decode(Batch.text(PROMPT)) == 0
    assert np.array_equal(scan.get_logits(), per_layer.get_logits())
    if opts.get("chain"):
        return
    first = int(np.argmax(scan.get_logits()))
    assert scan.generate_loop(first, 6) == per_layer.generate_loop(first, 6)
    for c in (per_layer, scan):
        assert c.decode(Batch.one(7)) == 0
    assert np.array_equal(scan.get_logits(), per_layer.get_logits())


@pytest.mark.parametrize("kv_dtype", [None, "q8_0"])
def test_state_round_trip_on_scan_context(scan_ggufs, tmp_path, kv_dtype):
    """Full and per-sequence state files of a scan Context: loaded into a
    fresh scan Context and into a per-layer one, the next step's logits
    equal the uninterrupted Context's."""
    path = scan_ggufs["Q8_0"]
    mk = (lambda **kw: Context(GGUFReader(path), n_cells=32, device="cpu",
                               kv_dtype=kv_dtype, **kw))
    ctx = mk(scan_layers=True)
    assert ctx.decode(Batch.text(PROMPT)) == 0
    state.state_save(ctx, str(tmp_path / "full.npz"), tokens=PROMPT)
    state.state_seq_save(ctx, 0, str(tmp_path / "seq.npz"))
    assert ctx.decode(Batch.one(7, pos=len(PROMPT))) == 0
    want = ctx.get_logits().copy()
    for kw in ({"scan_layers": True}, {}):
        for fn, name in ((state.state_load, "full.npz"), (state.state_seq_load, "seq.npz")):
            fresh = mk(**kw)
            args = (fresh, str(tmp_path / name)) if name == "full.npz" else \
                (fresh, 0, str(tmp_path / name))
            fn(*args)
            assert fresh.decode(Batch.one(7, pos=len(PROMPT))) == 0
            assert np.array_equal(fresh.get_logits(), want)
