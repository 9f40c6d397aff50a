"""OpenAI-compatible HTTP server on the standard library. Counterpart of
llm_tpu/server/app.py, which is written on aiohttp; the card's machine has
no aiohttp, so this one is http.server's ThreadingHTTPServer.

Parity target: llama-server's endpoint surface (llama.cpp's
tools/server/server.cpp:4832-4862): /completion, /v1/completions,
/v1/chat/completions, /tokenize, /detokenize, /v1/models, /health, /props,
/metrics (Prometheus), /slots, /embeddings, /infill, /rerank,
/lora-adapters, with SSE streaming. Every route answers with llm_tpu's JSON
bodies, status codes and SSE bytes (`data: {...}\\n\\n`, then
`data: [DONE]\\n\\n`); /metrics adds one counter, fast_chunks_total (calls of
the batched generation loop). The port has no LoRA: GET /lora-adapters
lists none, as llm_tpu does with none attached, and POST answers 501 with
an error that names the ROADMAP item. A GGUF's own Jinja chat template
renders as chatml (server/chat.py).

    python -m llm_tpu_torch.server.app -m model.gguf --port 8080 -np 4

runs on the card (--device cuda, the default) unless --device cpu is
given. A request thread per connection; ONE inference thread (server/core.py).
Responses are HTTP/1.0: a JSON body carries its Content-Length, a stream
ends when the connection closes.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
import uuid
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator
from urllib.parse import parse_qs, urlsplit

from ..samplers import SamplingParams
from .core import GenTask, InferenceServer

LORA_TODO = "LoRA adapters are not ported yet (ROADMAP Queue 1 item 9.1)"


def _grammar_from_request(d: dict) -> str:
    """server.cpp request fields: `grammar` (GBNF or '%regex ...'),
    `json_schema`, and the OpenAI `response_format` envelope
    (json_object / json_schema), all reduced to GBNF text."""
    grammar = str(d.get("grammar") or "")
    if grammar:
        return grammar
    js = d.get("json_schema")
    rf = d.get("response_format")
    if js is None and isinstance(rf, dict):
        t = rf.get("type")
        if t == "json_object":
            js = {}
        elif t == "json_schema":
            js = (rf.get("json_schema") or {}).get("schema", {})
    if js is None:
        return ""
    from ..grammar.json_schema import json_schema_to_gbnf

    return json_schema_to_gbnf(js)


def _logit_bias_from_request(d: dict) -> dict:
    """OpenAI dict {"123": -5.0} or llama.cpp list [[123, -5.0], ...]."""
    lb = d.get("logit_bias") or {}
    if isinstance(lb, dict):
        return {int(k): float(v) for k, v in lb.items()}
    return {int(k): float(v) for k, v in lb}


def _sampling_from_request(d: dict) -> SamplingParams:
    seed = d.get("seed", -1)
    return SamplingParams(
        grammar=_grammar_from_request(d),
        temp=float(d.get("temperature", d.get("temp", 0.8))),
        top_k=int(d.get("top_k", 40)),
        top_p=float(d.get("top_p", 0.95)),
        min_p=float(d.get("min_p", 0.05)),
        typical_p=float(d.get("typical_p", d.get("typ_p", 1.0))),
        min_keep=int(d.get("min_keep", 0)),
        xtc_probability=float(d.get("xtc_probability", 0.0)),
        xtc_threshold=float(d.get("xtc_threshold", 0.1)),
        top_n_sigma=float(d.get("top_n_sigma", -1.0)),
        dry_multiplier=float(d.get("dry_multiplier", 0.0)),
        dry_base=float(d.get("dry_base", 1.75)),
        dry_allowed_length=int(d.get("dry_allowed_length", 2)),
        dry_penalty_last_n=int(d.get("dry_penalty_last_n", -1)),
        dry_sequence_breakers=tuple(d.get("dry_sequence_breakers") or ()),
        logit_bias=_logit_bias_from_request(d),
        penalty_repeat=float(d.get("repeat_penalty", 1.0)),
        penalty_freq=float(d.get("frequency_penalty", 0.0)),
        penalty_present=float(d.get("presence_penalty", 0.0)),
        penalty_last_n=int(d.get("repeat_last_n", 64)),
        mirostat=int(d.get("mirostat", 0)),
        mirostat_tau=float(d.get("mirostat_tau", 5.0)),
        mirostat_eta=float(d.get("mirostat_eta", 0.1)),
        seed=seed if seed is not None and seed >= 0 else 0xFFFFFFFF,
    )


@dataclass
class Response:
    """A route's answer: a whole body, or `stream` (SSE chunks) when set."""

    status: int = 200
    body: bytes = b""
    content_type: str = "application/json; charset=utf-8"
    stream: Iterator[bytes] | None = None


def json_response(obj, status: int = 200) -> Response:
    """aiohttp's web.json_response: json.dumps with its default separators."""
    return Response(status, json.dumps(obj).encode())


def text_response(text: str, content_type: str) -> Response:
    return Response(200, text.encode(), f"{content_type}; charset=utf-8")


def _sse(payload) -> bytes:
    return f"data: {json.dumps(payload)}\n\n".encode()


def _lp(p):
    return math.log(max(p, 1e-30)) if p is not None else None


class ServerApp:
    def __init__(self, engine: InferenceServer, model_name: str = "llm-tpu",
                 chat_template: str | None = None):
        self.engine = engine
        self.tok = engine.tok
        self.model_name = model_name
        self.chat_template_override = chat_template
        self.t_start = time.time()
        # (method, path pattern) -> handler(body, match, query)
        self.routes = [
            ("GET", "/", self.webui), ("GET", "/health", self.health),
            ("GET", "/props", self.props), ("GET", "/v1/models", self.models),
            ("GET", "/slots", self.slots), ("POST", "/slots/{id}", self.slot_action),
            ("GET", "/metrics", self.metrics), ("POST", "/tokenize", self.tokenize),
            ("POST", "/embeddings", self.embeddings), ("POST", "/v1/embeddings", self.embeddings),
            ("POST", "/detokenize", self.detokenize), ("POST", "/infill", self.infill),
            ("POST", "/rerank", self.rerank), ("POST", "/v1/rerank", self.rerank),
            ("GET", "/lora-adapters", self.lora_adapters_get),
            ("POST", "/lora-adapters", self.lora_adapters_post),
            ("POST", "/completion", self.completion), ("POST", "/completions", self.completion),
            ("POST", "/v1/completions", self.completion),
            ("POST", "/v1/chat/completions", self.chat_completions),
        ]

    # -- helpers ----------------------------------------------------------------

    def _make_task(self, d: dict, prompt_text: str | None = None) -> GenTask:
        if prompt_text is None:
            prompt = d.get("prompt", "")
            if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
                toks = list(prompt)
            else:
                toks = self.tok.encode(str(prompt), add_special=True, parse_special=True)
        else:
            toks = self.tok.encode(prompt_text, add_special=True, parse_special=True)
        stop = d.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        n_predict = int(d.get("n_predict", d.get("max_tokens", 128)) or 128)
        # n_probs (native) / logprobs+top_logprobs (OpenAI)
        n_probs = int(d.get("n_probs", 0) or 0)
        lp = d.get("logprobs")
        if not n_probs:
            if lp is True:
                n_probs = int(d.get("top_logprobs", 0) or 0) or 1
            elif isinstance(lp, int) and not isinstance(lp, bool):
                n_probs = lp
        return GenTask(
            prompt_tokens=toks,
            params=_sampling_from_request(d),
            n_predict=n_predict,
            stop=list(stop),
            stream=bool(d.get("stream", False)),
            n_probs=n_probs,
        )

    @staticmethod
    def _collect(task: GenTask):
        """Drain events until done."""
        pieces, events = [], []
        while True:
            ev = task.events.get()
            if ev.get("done"):
                meta = ev
                break
            pieces.append(ev["text"])
            events.append(ev)
        meta["events"] = events
        return "".join(pieces), meta

    # -- endpoints ----------------------------------------------------------------

    def webui(self, d, match, query):
        from .webui import INDEX_HTML

        return text_response(INDEX_HTML, "text/html")

    def health(self, d, match, query):
        return json_response({"status": "ok"})

    def props(self, d, match, query):
        cfg = self.engine.ctx.cfg
        return json_response({
            "model": self.model_name,
            "n_ctx": self.engine.ctx.n_cells,
            "n_slots": self.engine.n_slots,
            "arch": cfg.arch,
            "n_layers": cfg.n_layers,
            "vocab_size": cfg.vocab_size,
            "chat_template": self.tok.vocab.chat_template,
        })

    def models(self, d, match, query):
        return json_response({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "created": int(self.t_start), "owned_by": "llm-tpu"}],
        })

    def tokenize(self, d, match, query):
        toks = self.tok.encode(
            d.get("content", ""), add_special=bool(d.get("add_special", False)),
            parse_special=bool(d.get("parse_special", True)),
        )
        return json_response({"tokens": toks})

    def detokenize(self, d, match, query):
        return json_response(
            {"content": self.tok.decode([int(t) for t in d.get("tokens", [])])})

    def slot_action(self, d, match, query):
        """POST /slots/{id}?action=save|restore|erase (server.cpp slot
        save/restore endpoints)."""
        from ..runtime.state import state_seq_load, state_seq_save

        sid = int(match["id"])
        if not (0 <= sid < self.engine.n_slots):
            return json_response({"error": "invalid slot"}, status=400)
        action = query.get("action", "")
        filename = d.get("filename", f"slot{sid}.npz")
        slot = self.engine.slots[sid]
        if action == "save":
            with self.engine.ctx_lock:
                state_seq_save(self.engine.ctx, sid, filename, tokens=slot.cache_tokens)
            return json_response({"saved": filename, "n_tokens": len(slot.cache_tokens)})
        if action == "restore":
            with self.engine.ctx_lock:
                toks = state_seq_load(self.engine.ctx, sid, filename)
            slot.cache_tokens = toks
            return json_response({"restored": filename, "n_tokens": len(toks)})
        if action == "erase":
            self.engine.ctx.seq_rm(sid)
            slot.cache_tokens = []
            return json_response({"erased": sid})
        return json_response({"error": "unknown action"}, status=400)

    def slots(self, d, match, query):
        return json_response([{"id": s.id, "state": s.state.name,
                               "n_past": len(s.cache_tokens), "n_decoded": s.n_decoded}
                              for s in self.engine.slots])

    def metrics(self, d, match, query):
        m = self.engine.metrics
        lines = [
            "# TYPE llm_tpu_requests_total counter",
            f"llm_tpu_requests_total {m['requests_total']}",
            "# TYPE llm_tpu_tokens_predicted_total counter",
            f"llm_tpu_tokens_predicted_total {m['tokens_predicted_total']}",
            "# TYPE llm_tpu_tokens_prompt_total counter",
            f"llm_tpu_tokens_prompt_total {m['tokens_prompt_total']}",
            "# TYPE llm_tpu_busy_slots gauge",
            f"llm_tpu_busy_slots {m['busy_slots']}",
            "# TYPE llm_tpu_draft_proposed_total counter",
            f"llm_tpu_draft_proposed_total {m.get('draft_proposed_total', 0)}",
            "# TYPE llm_tpu_draft_accepted_total counter",
            f"llm_tpu_draft_accepted_total {m.get('draft_accepted_total', 0)}",
            "# TYPE llm_tpu_fast_chunks_total counter",
            f"llm_tpu_fast_chunks_total {m.get('fast_chunks_total', 0)}",
        ]
        return text_response("\n".join(lines) + "\n", "text/plain")

    def _embed(self, text: str, pooling: str = "mean"):
        toks = self.tok.encode(str(text), add_special=True, parse_special=True)
        # a dedicated seq id above the slot range
        with self.engine.ctx_lock:
            return self.engine.ctx.encode(toks, pooling, seq_id=self.engine.n_slots)

    def embeddings(self, d, match, query):
        """/v1/embeddings (OpenAI) + /embeddings (native)."""
        inputs = d.get("input", d.get("content", ""))
        if isinstance(inputs, str):
            inputs = [inputs]
        pooling = d.get("pooling", "mean")
        out = []
        for i, text in enumerate(inputs):
            emb = self._embed(text, pooling)
            out.append({"object": "embedding", "index": i,
                        "embedding": [float(x) for x in emb.reshape(-1)]})
        return json_response({
            "object": "list", "data": out, "model": self.model_name,
            "usage": {"prompt_tokens": 0, "total_tokens": 0},
        })

    def infill(self, d, match, query):
        """/infill: fill-in-the-middle completion (server.cpp
        handle_infill): prompt = FIM_PRE + prefix + FIM_SUF + suffix +
        FIM_MID (+ optional extra prompt after MID)."""
        v = self.tok.vocab
        if v.fim_pre_id < 0 or v.fim_suf_id < 0 or v.fim_mid_id < 0:
            return json_response({"error": "model has no FIM tokens"}, status=400)
        pre = self.tok.encode(str(d.get("input_prefix", "")), add_special=False)
        suf = self.tok.encode(str(d.get("input_suffix", "")), add_special=False)
        toks = []
        if v.add_bos and v.bos_id >= 0:
            toks.append(v.bos_id)
        toks += [v.fim_pre_id] + pre + [v.fim_suf_id] + suf + [v.fim_mid_id]
        if d.get("prompt"):
            toks += self.tok.encode(str(d["prompt"]), add_special=False)
        task = GenTask(
            prompt_tokens=toks,
            params=_sampling_from_request(d),
            n_predict=int(d.get("n_predict", d.get("max_tokens", 128)) or 128),
            stop=list(d.get("stop") or []),
            stream=False,
        )
        self.engine.submit(task)
        text, meta = self._collect(task)
        return json_response({"content": text, "stop_reason": meta.get("stop_reason"),
                              "usage": _usage(meta)})

    def rerank(self, d, match, query):
        """/rerank + /v1/rerank: score documents against a query by the
        cosine similarity of mean-pooled embeddings (generative checkpoints
        have no classifier head; check_supported refuses one)."""
        import numpy as np

        query_text = str(d.get("query", ""))
        docs = d.get("documents", d.get("texts", [])) or []
        qv = self._embed(query_text)
        qv = qv / (np.linalg.norm(qv) + 1e-8)
        results = []
        for i, doc in enumerate(docs):
            dv = self._embed(doc)
            dv = dv / (np.linalg.norm(dv) + 1e-8)
            results.append({"index": i, "relevance_score": float(np.dot(qv, dv))})
        results.sort(key=lambda r: -r["relevance_score"])
        if d.get("top_n"):
            results = results[: int(d["top_n"])]
        return json_response({
            "model": self.model_name, "object": "list", "results": results,
            "usage": {"prompt_tokens": 0, "total_tokens": 0},
        })

    def lora_adapters_get(self, d, match, query):
        """GET /lora-adapters: none attached."""
        return json_response([])

    def lora_adapters_post(self, d, match, query):
        return json_response({"error": LORA_TODO}, status=501)

    # completions (native + OpenAI) ------------------------------------------------

    def completion(self, d, match, query):
        task = self.engine.submit(self._make_task(d))
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        if task.stream:
            def chunks():
                try:
                    while True:
                        ev = task.events.get()
                        if ev.get("done"):
                            yield _sse(self._oai_completion_chunk(rid, "", ev))
                            yield b"data: [DONE]\n\n"
                            break
                        yield _sse(self._oai_completion_chunk(rid, ev["text"], None, ev=ev))
                finally:
                    task.cancel()

            return Response(200, content_type="text/event-stream", stream=chunks())

        text, meta = self._collect(task)
        out = {
            "id": rid, "object": "text_completion",
            "created": int(time.time()), "model": self.model_name,
            "choices": [{"index": 0, "text": text,
                         "finish_reason": _finish_reason(meta)}],
            "usage": _usage(meta),
            "content": text,  # llama-server native field
            "stop_reason": meta.get("stop_reason"),
        }
        if task.n_probs:
            evs = meta.get("events", [])
            # native field (server.cpp send_final_response n_probs)
            out["completion_probabilities"] = [
                {"id": ev["token"], "token": ev["text"],
                 "prob": ev.get("prob"), "top_probs": ev.get("top_probs", [])}
                for ev in evs]
            # OpenAI completions logprobs envelope
            out["choices"][0]["logprobs"] = {
                "tokens": [ev["text"] for ev in evs],
                "token_logprobs": [_lp(ev.get("prob")) for ev in evs],
                "top_logprobs": [
                    {tp["token"]: _lp(tp["prob"]) for tp in ev.get("top_probs", [])}
                    for ev in evs],
            }
        return json_response(out)

    def _oai_completion_chunk(self, rid, text, done_meta, ev=None):
        out = {
            "id": rid, "object": "text_completion", "model": self.model_name,
            "created": int(time.time()),
            "choices": [{
                "index": 0, "text": text,
                "finish_reason": _finish_reason(done_meta) if done_meta else None,
            }],
        }
        if ev is not None and ev.get("top_probs") is not None:
            # native per-chunk probs (server.cpp send_partial_response)
            out["completion_probabilities"] = [{
                "id": ev["token"], "token": ev["text"],
                "prob": ev.get("prob"), "top_probs": ev["top_probs"]}]
        return out

    def chat_completions(self, d, match, query):
        messages = list(d.get("messages", []))
        tools = d.get("tools") or []
        if tools:
            from .toolcall import render_tools_prompt

            messages = [{"role": "system", "content": render_tools_prompt(tools)}] + messages
        prompt = self._render_chat(messages)
        task = self.engine.submit(self._make_task(d, prompt_text=prompt))
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"

        if d.get("stream"):
            def chunks():
                first = True
                try:
                    while True:
                        ev = task.events.get()
                        delta = {}
                        if first and not ev.get("done"):
                            delta["role"] = "assistant"
                            first = False
                        finish = None
                        if ev.get("done"):
                            finish = _finish_reason(ev)
                        else:
                            delta["content"] = ev["text"]
                        choice = {"index": 0, "delta": delta, "finish_reason": finish}
                        if task.n_probs and ev.get("top_probs") is not None:
                            choice["logprobs"] = {"content": [{
                                "token": ev["text"],
                                "logprob": math.log(max(ev.get("prob", 0.0), 1e-30)),
                                "top_logprobs": [
                                    {"token": tp["token"],
                                     "logprob": math.log(max(tp["prob"], 1e-30))}
                                    for tp in ev["top_probs"]],
                            }]}
                        yield _sse({
                            "id": rid, "object": "chat.completion.chunk",
                            "created": int(time.time()), "model": self.model_name,
                            "choices": [choice],
                        })
                        if ev.get("done"):
                            yield b"data: [DONE]\n\n"
                            break
                finally:
                    task.cancel()

            return Response(200, content_type="text/event-stream", stream=chunks())

        text, meta = self._collect(task)
        message = {"role": "assistant", "content": text}
        finish = _finish_reason(meta)
        if tools:
            from .toolcall import extract_tool_calls

            calls, content = extract_tool_calls(text)
            if calls:
                message = {"role": "assistant", "content": content or None,
                           "tool_calls": calls}
                finish = "tool_calls"
        choice = {"index": 0, "message": message, "finish_reason": finish}
        if task.n_probs:
            choice["logprobs"] = {"content": [
                {"token": ev["text"], "logprob": _lp(ev.get("prob")),
                 "top_logprobs": [{"token": tp["token"], "logprob": _lp(tp["prob"])}
                                  for tp in ev.get("top_probs", [])]}
                for ev in meta.get("events", [])]}
        return json_response({
            "id": rid, "object": "chat.completion",
            "created": int(time.time()), "model": self.model_name,
            "choices": [choice],
            "usage": _usage(meta),
        })

    def _render_chat(self, messages: list[dict]) -> str:
        from .chat import TEMPLATES, apply_template

        if self.chat_template_override:
            return apply_template(self.chat_template_override, messages)
        template = self.tok.vocab.chat_template
        if template:
            return apply_template(template, messages)
        return TEMPLATES["chatml"](messages)

    # -- wiring ---------------------------------------------------------------------

    def dispatch(self, method: str, target: str, body: bytes) -> Response:
        """The route for (method, target) called on the JSON body: 404 for
        no such path, 405 for a path without the method, 500 (the error's
        text) where the handler raised."""
        url = urlsplit(target)
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        found = False
        for m, pattern, fn in self.routes:
            rx = "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
            hit = re.match(rx, url.path)
            if hit is None:
                continue
            found = True
            if m != method:
                continue
            try:
                d = json.loads(body) if body else {}
                return fn(d, hit.groupdict(), query)
            except Exception as e:  # noqa: BLE001 - the client gets the error
                return json_response({"error": f"{type(e).__name__}: {e}"}, status=500)
        if found:
            return Response(405, b"405: Method Not Allowed", "text/plain; charset=utf-8")
        return Response(404, b"404: Not Found", "text/plain; charset=utf-8")

    def make_server(self, host: str = "127.0.0.1", port: int = 8080) -> ThreadingHTTPServer:
        """A ThreadingHTTPServer (not yet serving) bound to host:port
        (port 0: a free one, server.server_address[1])."""
        app = self

        class Handler(BaseHTTPRequestHandler):
            def _serve(self, method):
                n = int(self.headers.get("Content-Length") or 0)
                resp = app.dispatch(method, self.path, self.rfile.read(n) if n else b"")
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                if resp.stream is None:
                    self.send_header("Content-Length", str(len(resp.body)))
                    self.end_headers()
                    self.wfile.write(resp.body)
                    return
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                try:
                    for chunk in resp.stream:
                        self.wfile.write(chunk)
                        self.wfile.flush()
                finally:
                    resp.stream.close()  # a client gone mid-stream cancels its task

            def do_GET(self):
                self._serve("GET")

            def do_POST(self):
                self._serve("POST")

            def log_message(self, format, *args):  # noqa: A002 - the base's name
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        server.daemon_threads = True
        return server

    def serve_in_thread(self, host: str = "127.0.0.1", port: int = 0):
        """Start serving on a daemon thread; returns (server, thread).
        server.shutdown() then server.server_close() stop it."""
        server = self.make_server(host, port)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        return server, th


def _finish_reason(meta):
    if not meta:
        return None
    r = meta.get("stop_reason", "")
    if r == "length":
        return "length"
    if r and r.startswith("error"):
        return r
    return "stop"


def _usage(meta):
    return {
        "prompt_tokens": meta.get("n_prompt", 0),
        "completion_tokens": meta.get("n_decoded", 0),
        "total_tokens": meta.get("n_prompt", 0) + meta.get("n_decoded", 0),
    }


# option -> (the value that means "not used", what it needs)
_NOT_PORTED = {
    "lora": ([], LORA_TODO),
    "tensor_parallel": (1, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "seq_parallel": (1, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "dist_coordinator": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "dist_num_processes": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "dist_process_id": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "platform": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "n_virtual_devices": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
}


def _parser():
    import argparse

    from ..tools.args import add_override_kv, env_default as ed, required_unless_env

    ap = argparse.ArgumentParser(description="llm-tpu OpenAI-compatible server (PyTorch port)")
    ap.add_argument("-m", "--model", default=ed("model", None),
                    required=required_unless_env("model"))
    ap.add_argument("--host", default=ed("host", "127.0.0.1"))
    ap.add_argument("--port", type=int, default=ed("port", 8080))
    ap.add_argument("-c", "--ctx-size", type=int, default=ed("ctx-size", 4096))
    ap.add_argument("-np", "--n-parallel", type=int, default=ed("n-parallel", 4))
    ap.add_argument("-b", "--n-batch", type=int, default=ed("n-batch", 256))
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--alias", default=None, help="model name served")
    ap.add_argument("--chat-template", default=None,
                    help="builtin template name (chatml/llama2/llama3/gemma/...)")
    ap.add_argument("--lora", action="append", default=[], help="(not ported yet)")
    ap.add_argument("-md", "--model-draft", default=None,
                    help="draft model GGUF: per-slot speculative decoding")
    ap.add_argument("--draft-max", type=int, default=8,
                    help="max draft tokens per step (llama-server --draft-max)")
    ap.add_argument("--lookup-ngram", action="store_true",
                    help="draft from prompt n-gram stats (no draft model)")
    ap.add_argument("--prewarm", action="store_true",
                    help="run every prompt-length bucket and batched loop once "
                         "before accepting traffic")
    add_override_kv(ap)
    # the reference's mesh flags (tools/mesh_args.py) and MoE capacity factor
    ap.add_argument("-tp", "--tensor-parallel", type=int, default=1, help="(not ported yet)")
    ap.add_argument("-sp", "--seq-parallel", type=int, default=1, help="(not ported yet)")
    ap.add_argument("--dist-coordinator", default=None, help="(not ported yet)")
    ap.add_argument("--dist-num-processes", type=int, default=None, help="(not ported yet)")
    ap.add_argument("--dist-process-id", type=int, default=None, help="(not ported yet)")
    ap.add_argument("--platform", default=None, help="(not ported yet)")
    ap.add_argument("--n-virtual-devices", type=int, default=None, help="(not ported yet)")
    ap.add_argument("--ep-capacity-factor", type=float,
                    default=ed("ep-capacity-factor", 0.0), metavar="F",
                    help="MoE expert capacity factor (0 = exact, no drops). "
                         "Env: LLM_TPU_ARG_EP_CAPACITY_FACTOR")
    ap.add_argument("--device", default=ed("device", "cuda"),
                    help="torch device: cuda (default; the card) or cpu. "
                         "Env: LLM_TPU_ARG_DEVICE")
    return ap


def server_contexts(args, reader, device):
    """The server's Context on reader and its draft model's (None without
    --model-draft). -b is each Context's n_ubatch and -np the sequences
    that size the ISWA ring, as the reference's server gives them."""
    import torch

    from ..gguf.reader import GGUFReader
    from ..runtime.engine import Context

    dtype = torch.float32 if args.f32 else torch.bfloat16
    ctx = Context(reader, n_cells=args.ctx_size, n_ubatch=args.n_batch, dtype=dtype,
                  device=device, n_seq_hint=args.n_parallel, ep_cf=args.ep_capacity_factor)
    draft_ctx = None
    if args.model_draft:
        draft_ctx = Context(GGUFReader(args.model_draft), n_cells=args.ctx_size,
                            n_ubatch=args.n_batch, dtype=dtype, device=device)
    return ctx, draft_ctx


def main(argv=None):
    from ..device import resolve_device
    from ..gguf.reader import GGUFReader
    from ..tokenizers import tokenizer_from_gguf
    from ..tools.args import apply_kv_overrides

    ap = _parser()
    args = ap.parse_args(argv)
    for name, (unused, why) in _NOT_PORTED.items():
        if getattr(args, name) != unused:
            ap.error(f"--{name.replace('_', '-')}: {why}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(2, f"{ap.prog}: error: {e}\n")
    reader = GGUFReader(args.model)
    apply_kv_overrides(reader, args.override_kv)
    tok = tokenizer_from_gguf(reader)
    ctx, draft_ctx = server_contexts(args, reader, device)
    engine = InferenceServer(ctx, tok, n_slots=args.n_parallel, n_batch=args.n_batch,
                             draft_ctx=draft_ctx, n_draft=args.draft_max,
                             lookup_ngram=args.lookup_ngram)
    if args.prewarm:
        t0 = time.time()
        engine.prewarm()
        print(f"prewarm: {time.time() - t0:.1f}s", flush=True)
    engine.start()
    name = args.alias or args.model.rsplit("/", 1)[-1]
    server = ServerApp(engine, model_name=name,
                       chat_template=args.chat_template).make_server(args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
