"""The port's server (llm_tpu_torch/server: the slot engine core.py and the
stdlib HTTP layer app.py) against llm_tpu's on a tiny GGUF, on the CPU in
f32.

- The core (tests/test_server.py:53-141's cases): one task, parallel tasks
  equal to serial ones, the batched fast path with sampled slots
  (fast_chunks_total), stop strings on the fast path, prefix-cache reuse,
  a grammar-constrained task; greedy text equal to llm_tpu's
  InferenceServer's. The port's own: KV pressure (NoFreeCells) alone sends
  the fast path to the scalar one, any other error reaches the task, and
  prewarm runs every batched shape and raises what fails.
- HTTP: the port's ThreadingHTTPServer (urllib) against llm_tpu's aiohttp
  ServerApp under aiohttp's TestClient, on every route of app.py:586-605,
  streaming included: equal status codes, content types and JSON bodies
  after dropping ids and timestamps (embeddings and rerank scores within
  1e-4). The port's /metrics adds fast_chunks_total; POST /lora-adapters
  answers 501 naming its ROADMAP item."""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("aiohttp")
pytest.importorskip("transformers")

from aiohttp.test_utils import TestClient, TestServer

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.samplers import SamplingParams as JaxSamplingParams
from llm_tpu.server.app import ServerApp as JaxServerApp
from llm_tpu.server.core import GenTask as JaxGenTask
from llm_tpu.server.core import InferenceServer as JaxInferenceServer
from llm_tpu.tokenizers import tokenizer_from_gguf as jax_tokenizer_from_gguf

from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.samplers import SamplingParams
from llm_tpu_torch.server.app import ServerApp
from llm_tpu_torch.server.core import GenTask, InferenceServer
from llm_tpu_torch.tokenizers import tokenizer_from_gguf

from test_model_vs_hf import _tiny_hf_llama
from test_tools import _test_vocab


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both engines (3 slots, n_batch 32) on one GGUF, the port's HTTP
    server on a free port and llm_tpu's ServerApp under a TestClient whose
    event loop runs on a thread of its own."""
    path = str(tmp_path_factory.mktemp("srv") / "m.gguf")
    convert_hf_llama(_tiny_hf_llama(hidden=64, layers=2, vocab=97), path,
                     vocab=_test_vocab(97))
    reader = GGUFReader(path)
    eng = InferenceServer(Context(reader, n_cells=256, dtype=torch.float32, device="cpu"),
                          tokenizer_from_gguf(reader), n_slots=3, n_batch=32)
    jreader = JaxGGUFReader(path)
    jeng = JaxInferenceServer(JaxContext(jreader, n_cells=256, n_ubatch=32, dtype=jnp.float32),
                              jax_tokenizer_from_gguf(jreader), n_slots=3, n_batch=32)
    eng.start()
    jeng.start()
    server, _ = ServerApp(eng, model_name="tiny").serve_in_thread()
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    client = TestClient(TestServer(JaxServerApp(jeng, model_name="tiny").build()), loop=loop)
    asyncio.run_coroutine_threadsafe(client.start_server(), loop).result(60)
    yield dict(eng=eng, jeng=jeng, port=server.server_address[1], client=client, loop=loop)
    asyncio.run_coroutine_threadsafe(client.close(), loop).result(60)
    loop.call_soon_threadsafe(loop.stop)
    th.join(10)
    server.shutdown()
    server.server_close()
    eng.stop()
    jeng.stop()


def _drain(task):
    pieces = []
    while True:
        ev = task.events.get(timeout=180)
        if ev.get("done"):
            return pieces, ev
        pieces.append(ev)


def _greedy(eng, task_cls, params_cls, text, n=5, **kw):
    toks = eng.tok.encode(text, add_special=True)
    pieces, meta = _drain(eng.submit(task_cls(prompt_tokens=toks, params=params_cls(
        temp=0.0, **kw), n_predict=n)))
    return [e["token"] for e in pieces], meta


# -- the core -----------------------------------------------------------------

def test_core_single_task_is_the_reference(servers):
    got, meta = _greedy(servers["eng"], GenTask, SamplingParams, "hello world", 6)
    want, jmeta = _greedy(servers["jeng"], JaxGenTask, JaxSamplingParams, "hello world", 6)
    assert got == want and len(got) <= 6
    assert meta["stop_reason"] == jmeta["stop_reason"] in ("length", "eos")
    assert meta["n_prompt"] == jmeta["n_prompt"]


def test_core_parallel_tasks_match_serial_and_reference(servers):
    eng = servers["eng"]
    prompts = ["abc def", "hello world, this", "x y z 1 2 3"]
    serial = [_greedy(eng, GenTask, SamplingParams, p)[0] for p in prompts]
    tasks = [eng.submit(GenTask(prompt_tokens=eng.tok.encode(p, add_special=True),
                                params=SamplingParams(temp=0.0), n_predict=5))
             for p in prompts]
    parallel = [[e["token"] for e in _drain(t)[0]] for t in tasks]
    assert parallel == serial
    assert serial == [_greedy(servers["jeng"], JaxGenTask, JaxSamplingParams, p)[0]
                      for p in prompts]


def test_core_batch_fast_path_multislot(servers):
    """Concurrent sampled tasks at llama.cpp's defaults advance through
    generate_loop_batch (fast_chunks_total rises)."""
    eng = servers["eng"]
    base = eng.metrics.get("fast_chunks_total", 0)
    tasks = [eng.submit(GenTask(prompt_tokens=eng.tok.encode(p, add_special=True),
                                params=SamplingParams(temp=0.8, top_k=40, top_p=0.95,
                                                      min_p=0.05, seed=100 + i),
                                n_predict=12))
             for i, p in enumerate(["abc def", "hello world", "x y z"])]
    for t in tasks:
        pieces, meta = _drain(t)
        assert meta["stop_reason"] in ("length", "eos") and len(pieces) <= 12
    assert eng.metrics.get("fast_chunks_total", 0) > base


def test_core_stop_string_on_fast_path(servers):
    eng = servers["eng"]
    toks = eng.tok.encode("abc def", add_special=True)
    pieces, _ = _drain(eng.submit(GenTask(prompt_tokens=toks, params=SamplingParams(temp=0.0),
                                          n_predict=8)))
    texts = [e["text"] for e in pieces]
    stop = texts[3] if texts[3].strip() else "".join(texts[2:5])
    p2, meta = _drain(eng.submit(GenTask(prompt_tokens=toks, params=SamplingParams(temp=0.0),
                                         n_predict=8, stop=[stop])))
    assert meta["stop_reason"] == "stop_string" and len(p2) <= len(pieces)


def test_core_prefix_cache_reuse(servers):
    eng = servers["eng"]
    out1, _ = _greedy(eng, GenTask, SamplingParams, "the quick brown fox jumps", 3)
    before = eng.metrics["tokens_prompt_total"]
    out2, _ = _greedy(eng, GenTask, SamplingParams, "the quick brown fox jumps", 3)
    assert out1 == out2 and eng.metrics["tokens_prompt_total"] - before <= 2


def test_core_grammar_task_is_the_reference(servers):
    kw = dict(grammar="%regex yes|no|maybe")
    got, meta = _greedy(servers["eng"], GenTask, SamplingParams, "hello", 8, **kw)
    want, jmeta = _greedy(servers["jeng"], JaxGenTask, JaxSamplingParams, "hello", 8, **kw)
    assert got == want and meta["stop_reason"] == jmeta["stop_reason"]


@pytest.fixture(scope="module")
def lone_engine(tmp_path_factory):
    """A maker of the port's engine alone (4 slots, n_batch 8) on a fresh
    Context of its own tiny GGUF, its loop not started."""
    path = str(tmp_path_factory.mktemp("lone") / "m.gguf")
    convert_hf_llama(_tiny_hf_llama(hidden=64, layers=2, vocab=97), path,
                     vocab=_test_vocab(97))
    reader = GGUFReader(path)
    tok = tokenizer_from_gguf(reader)
    return lambda: InferenceServer(Context(reader, n_cells=64, dtype=torch.float32,
                                           device="cpu"), tok, n_slots=4, n_batch=8)


def _run_one(eng, text="abc def", n=6):
    eng.start()
    try:
        return _greedy(eng, GenTask, SamplingParams, text, n)
    finally:
        eng.stop()


def test_core_fast_path_takes_kv_pressure_to_the_scalar_path(lone_engine):
    """NoFreeCells from the batched loop (the one error it catches) sends
    the slot down the scalar path, which gives the same greedy tokens."""
    from llm_tpu_torch.runtime.engine import NoFreeCells

    fast = lone_engine()
    want, _ = _run_one(fast)
    assert fast.metrics.get("fast_chunks_total", 0) > 0

    def full(*a, **kw):
        raise NoFreeCells("generate_loop_batch: no free KV cells")

    eng = lone_engine()
    eng.ctx.generate_loop_batch = full
    got, meta = _run_one(eng)
    assert got == want and meta["stop_reason"] in ("length", "eos")
    assert eng.metrics.get("fast_chunks_total", 0) == 0


def test_core_fast_path_errors_reach_the_task(lone_engine):
    """Any other error of the batched loop (a refused launch, a failed
    build) ends the task with it: no quiet switch to the scalar path."""
    eng = lone_engine()

    def refused(*a, **kw):
        raise RuntimeError("flash_decode_launch: launch refused")

    eng.ctx.generate_loop_batch = refused
    _, meta = _run_one(eng)
    assert meta["stop_reason"] == "error:flash_decode_launch: launch refused"


def test_core_prewarm_runs_every_batched_shape_and_raises(lone_engine):
    """prewarm decodes each prompt bucket and runs the batched loop at 1, 2
    and 4 slots, leaving no cell occupied; an error inside it is raised,
    not swallowed."""
    eng = lone_engine()
    eng.prewarm()
    assert eng.ctx.batch_loop_shapes == {(1, eng.FAST_CHUNK), (2, eng.FAST_CHUNK),
                                         (4, eng.FAST_CHUNK)}
    assert eng.ctx.cells.n_used == 0

    def refused(*a, **kw):
        raise RuntimeError("qmm_decode_launch: launch refused")

    eng.ctx._step = refused
    with pytest.raises(RuntimeError, match="launch refused"):
        eng.prewarm()


# -- HTTP ---------------------------------------------------------------------

def _port(servers, method, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{servers['port']}{path}", method=method,
                                 data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=180) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _ref(servers, method, path, body=None):
    async def go():
        r = await servers["client"].request(method, path, json=body)
        return r.status, r.headers["Content-Type"], await r.read()

    return asyncio.run_coroutine_threadsafe(go(), servers["loop"]).result(180)


_VOLATILE = {"id", "created"}


def _norm(obj):
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


def _same(got, want, path="$"):
    """Equal JSON values, floats (probabilities, log-probabilities) within
    1e-5 relative: the two packages sum their f32 logits in other orders."""
    if isinstance(want, float) and isinstance(got, (float, int)):
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (path, got, want)
    elif isinstance(want, dict) and isinstance(got, dict):
        assert got.keys() == want.keys(), (path, got.keys(), want.keys())
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list) and isinstance(got, list):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _events(body: bytes):
    """SSE bytes -> the JSON payloads, and whether each event was
    `data: ...` followed by a blank line and the stream ended with
    `data: [DONE]`."""
    parts = body.decode().split("\n\n")
    assert parts[-1] == "" and parts[-2] == "data: [DONE]"
    assert all(p.startswith("data: ") for p in parts[:-1])
    return [json.loads(p[len("data: "):]) for p in parts[:-2]]


ROUTES = [
    ("GET", "/", None), ("GET", "/health", None), ("GET", "/props", None),
    ("GET", "/v1/models", None), ("GET", "/slots", None), ("GET", "/lora-adapters", None),
    ("POST", "/tokenize", {"content": "hello world, this", "add_special": True}),
    ("POST", "/tokenize", {"content": "abc"}),
    ("POST", "/detokenize", {"tokens": [5, 9, 13, 20]}),
    ("POST", "/completion", {"prompt": "hello world", "n_predict": 6, "temperature": 0}),
    ("POST", "/completions", {"prompt": "abc def", "max_tokens": 4, "temperature": 0,
                              "stop": ["zzz"]}),
    ("POST", "/v1/completions", {"prompt": "x y z", "n_predict": 5, "temperature": 0,
                                 "n_probs": 3}),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "max_tokens": 5, "temperature": 0}),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "max_tokens": 3, "temperature": 0, "logprobs": True,
                                      "top_logprobs": 2}),
    ("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "pick"}], "max_tokens": 6, "temperature": 0,
        "response_format": {"type": "json_schema", "json_schema": {
            "schema": {"type": "string", "enum": ["yes", "no"]}}}}),
    ("POST", "/completion", {"prompt": "hello", "n_predict": 6, "temperature": 0,
                             "grammar": 'root ::= "a"+'}),
    ("POST", "/infill", {"input_prefix": "a", "input_suffix": "b"}),
    ("POST", "/slots/99?action=save", {}), ("POST", "/slots/0?action=bogus", {}),
    ("POST", "/slots/1?action=erase", {}),
]


@pytest.mark.parametrize("method,path,body", ROUTES,
                         ids=[f"{m} {p} {i}" for i, (m, p, _) in enumerate(ROUTES)])
def test_http_route_is_the_reference(servers, method, path, body):
    got = _port(servers, method, path, body)
    want = _ref(servers, method, path, body)
    assert got[0] == want[0] and got[1] == want[1]
    if path == "/slots":  # n_past and n_decoded follow each engine's own history
        g, w = json.loads(got[2]), json.loads(want[2])
        assert [(s["id"], s["state"], sorted(s)) for s in g] == \
            [(s["id"], s["state"], sorted(s)) for s in w]
    elif got[1].startswith("application/json"):
        _same(_norm(json.loads(got[2])), _norm(json.loads(want[2])))
    else:
        assert got[2] == want[2]


@pytest.mark.parametrize("path,body", [
    ("/completion", {"prompt": "hello world", "n_predict": 6, "temperature": 0,
                     "stream": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                              "max_tokens": 5, "temperature": 0, "stream": True}),
    ("/v1/completions", {"prompt": "x y", "n_predict": 3, "temperature": 0, "stream": True,
                         "n_probs": 2})])
def test_http_streaming_is_the_reference(servers, path, body):
    """The same SSE events (text/event-stream, `data: {...}` then
    `data: [DONE]`), and the stream's text equals the unstreamed answer."""
    got = _port(servers, "POST", path, body)
    want = _ref(servers, "POST", path, body)
    assert got[0] == want[0] == 200
    assert got[1].startswith("text/event-stream") and want[1].startswith("text/event-stream")
    ev, jev = _events(got[2]), _events(want[2])
    _same(_norm(ev), _norm(jev))
    plain = json.loads(_port(servers, "POST", path, {**body, "stream": False})[2])
    if "chat" in path:
        text = "".join(e["choices"][0]["delta"].get("content", "") for e in ev)
        assert text == plain["choices"][0]["message"]["content"]
    else:
        assert "".join(e["choices"][0]["text"] for e in ev) == plain["content"]


@pytest.mark.parametrize("path,body", [
    ("/embeddings", {"content": "hello world"}),
    ("/v1/embeddings", {"input": ["abc", "x y z"]}),
    ("/rerank", {"query": "abc", "documents": ["abc def", "xyz", "hello"], "top_n": 2}),
    ("/v1/rerank", {"query": "hi", "documents": ["a", "b"]})])
def test_http_embeddings_and_rerank_are_the_reference(servers, path, body):
    got, want = (json.loads(f(servers, "POST", path, body)[2]) for f in (_port, _ref))
    if "rerank" in path:
        assert [r["index"] for r in got["results"]] == [r["index"] for r in want["results"]]
        np.testing.assert_allclose([r["relevance_score"] for r in got["results"]],
                                   [r["relevance_score"] for r in want["results"]], atol=1e-4)
        return
    assert len(got["data"]) == len(want["data"])
    for g, w in zip(got["data"], want["data"]):
        assert g["index"] == w["index"] and len(g["embedding"]) == len(w["embedding"])
        np.testing.assert_allclose(g["embedding"], w["embedding"], atol=1e-4, rtol=1e-4)
    assert {k: v for k, v in got.items() if k != "data"} == \
        {k: v for k, v in want.items() if k != "data"}


def test_http_slot_save_restore_round_trip(servers, tmp_path):
    """/slots/0?action=save then restore: the same n_tokens as llm_tpu's,
    and the port's restored slot continues with the same greedy text."""
    body = {"prompt": "the quick brown", "n_predict": 4, "temperature": 0}
    for f in (_port, _ref):
        f(servers, "POST", "/completion", body)
    for f, name in ((_port, "p.npz"), (_ref, "r.npz")):
        fn = str(tmp_path / name)
        s = json.loads(f(servers, "POST", "/slots/0?action=save", {"filename": fn})[2])
        r = json.loads(f(servers, "POST", "/slots/0?action=restore", {"filename": fn})[2])
        assert s["n_tokens"] == r["n_tokens"] > 0
    got = json.loads(_port(servers, "POST", "/completion", body)[2])["content"]
    assert got == json.loads(_ref(servers, "POST", "/completion", body)[2])["content"]


def test_http_metrics_and_lora_post(servers):
    """/metrics: llm_tpu's counters in its order and format, then
    fast_chunks_total; POST /lora-adapters: 501 naming the ROADMAP item."""
    got = _port(servers, "GET", "/metrics")
    want = _ref(servers, "GET", "/metrics")
    assert got[0] == want[0] == 200 and got[1] == want[1]
    names = (lambda b: [ln.split()[0] if not ln.startswith("#") else ln
                        for ln in b.decode().splitlines()])
    assert names(got[2])[:-2] == names(want[2])
    assert names(got[2])[-2:] == ["# TYPE llm_tpu_fast_chunks_total counter",
                                  "llm_tpu_fast_chunks_total"]
    status, _, body = _port(servers, "POST", "/lora-adapters", [{"id": 0, "scale": 0.5}])
    assert status == 501 and "ROADMAP Queue 1 item 9.1" in json.loads(body)["error"]
    assert _port(servers, "GET", "/nope")[0] == 404


@pytest.mark.parametrize("extra,item", [
    (["--lora", "a.gguf"], "Queue 1 item 9.1"), (["-tp", "2"], "Queue 1 item 10")])
def test_server_flags_the_port_cannot_honour_exit_naming_the_roadmap(extra, item, capsys):
    """`python -m llm_tpu_torch.server.app` exits before loading anything on
    a flag whose module is not ported, naming its ROADMAP item."""
    from llm_tpu_torch.server import app

    with pytest.raises(SystemExit) as e:
        app.main(["-m", "absent.gguf", "--device", "cpu", *extra])
    assert e.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


def test_server_ep_capacity_factor_reaches_the_context(tmp_path, monkeypatch):
    """--ep-capacity-factor on the server: its Context (server_contexts)
    caps a mixture-of-experts model's expert buckets as llm_tpu's server
    does (its flag sets LLM_TPU_EP_CF, which its Context reads): the same
    ep_cf in both configs, and the prefill logits of a 30-token prompt,
    one step whose cap of 8 tokens an expert drops assignments, within
    2e-4 of llm_tpu's."""
    from llm_tpu.tools.args import apply_ep_cf

    from llm_tpu_torch.server import app
    from test_torch_cli import moe_gguf_with_vocab

    path = moe_gguf_with_vocab(str(tmp_path / "moe.gguf"))
    monkeypatch.setenv("LLM_TPU_EP_CF", "0")
    args = app._parser().parse_args(["-m", path, "--device", "cpu", "--f32", "-c", "64",
                                     "--ep-capacity-factor", "0.5"])
    ctx, _ = app.server_contexts(args, GGUFReader(path), torch.device("cpu"))
    apply_ep_cf(args.ep_capacity_factor)
    ref = JaxContext(JaxGGUFReader(path), n_cells=64, dtype=jnp.float32)
    assert ctx.cfg.ep_cf == ref.cfg.ep_cf == 0.5
    toks = [(i * 7) % 90 + 3 for i in range(30)]
    from llm_tpu.runtime.batch import Batch as JaxBatch

    from llm_tpu_torch.runtime.batch import Batch
    assert ctx.decode(Batch.text(toks)) == 0 and ref.decode(JaxBatch.text(toks)) == 0
    np.testing.assert_allclose(ctx.get_logits(), np.asarray(ref.get_logits()),
                               atol=2e-4, rtol=2e-4)


def test_server_default_device_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from llm_tpu_torch.server import app

    with pytest.raises(SystemExit) as e:
        app.main(["-m", "absent.gguf"])
    assert e.value.code != 0
    assert "CUDA" in capsys.readouterr().err
