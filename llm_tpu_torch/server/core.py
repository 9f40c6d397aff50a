"""Continuous-batching inference core. The port's own copy of
llm_tpu/server/core.py, its lazy imports pointed at the port's modules.

Parity target: llama-server's slot engine (llama.cpp's
tools/server/server.cpp): slot state machine (:46-52), update_slots (:2961)
mixing prompt-processing chunks and per-slot generation tokens into one
decode batch, prompt-prefix cache reuse, task queue + deferred queue
(:1581-1744), per-slot sampling and incremental detokenize.

Architecture: HTTP threads submit GenTasks to a queue; ONE inference thread
runs the update loop against the Context (the analogue of the reference's
single inference thread over llama_decode). When every busy slot is
generating with a device-eligible sampler, the slots advance together
through Context.generate_loop_batch, FAST_CHUNK tokens a call (the
metrics' fast_chunks_total counts those calls).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from ..runtime.batch import Batch
from ..runtime.engine import TOKEN_BUCKETS, NoFreeCells
from ..samplers import SamplingParams, build_chain


class SlotState(Enum):
    IDLE = 0
    PROCESSING_PROMPT = 1
    GENERATING = 2


@dataclass
class GenTask:
    prompt_tokens: list[int]
    params: SamplingParams
    n_predict: int = 128
    stop: list[str] = field(default_factory=list)
    stream: bool = False
    n_probs: int = 0  # top-N token probabilities per generated token
    # events: dicts {"token": id, "text": piece, "done": bool, ...}
    events: queue.Queue = field(default_factory=queue.Queue)
    id: int = 0
    t_submit: float = field(default_factory=time.time)
    cancelled: bool = False

    def cancel(self):
        self.cancelled = True


@dataclass
class Slot:
    id: int
    state: SlotState = SlotState.IDLE
    task: GenTask | None = None
    cache_tokens: list[int] = field(default_factory=list)
    n_prompt_done: int = 0
    n_decoded: int = 0
    chain: object = None
    text_tail: str = ""
    t_start_prompt: float = 0.0
    t_first_token: float = 0.0
    # speculative decoding state (per-slot draft, server.cpp:2069-2077)
    n_draft_past: int = 0  # draft-model KV depth for this slot's seq
    ngram: object = None  # per-slot NgramCache (lookup drafting)
    ngram_done: int = 0  # cache_tokens prefix already folded into ngram


def common_prefix_len(a: list[int], b: list[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class InferenceServer:
    def __init__(self, ctx, tok, n_slots: int = 4, n_batch: int = 256,
                 draft_ctx=None, n_draft: int = 8, lookup_ngram: bool = False):
        """draft_ctx: a Context over a small draft model — enables per-slot
        speculative decoding (the reference's server speculation,
        server.cpp:2069-2077,3062): each generation step proposes up to
        n_draft tokens, the target verifies them in ONE batched decode and
        accepts the longest matching prefix. lookup_ngram: draft from
        prompt n-gram statistics instead (no draft model,
        common/ngram-cache.h)."""
        self.ctx = ctx
        self.tok = tok
        self.n_slots = n_slots
        self.n_batch = n_batch
        self.draft_ctx = draft_ctx
        self.n_draft = n_draft
        self.lookup_ngram = lookup_ngram
        self.slots = [Slot(id=i) for i in range(n_slots)]
        self.tasks: queue.Queue[GenTask] = queue.Queue()
        self._next_task_id = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Context is not thread-safe; the inference loop and any side-channel
        # users (embeddings endpoint, slot save/restore) must hold this lock.
        self.ctx_lock = threading.Lock()
        # loaded LoRA adapters: {"path", "scale", "tensors", "alpha"}
        # (surfaced/updated via the /lora-adapters endpoints)
        self.loras: list[dict] = []
        self.metrics = {
            "requests_total": 0,
            "tokens_predicted_total": 0,
            "tokens_prompt_total": 0,
            "busy_slots": 0,
            "draft_proposed_total": 0,
            "draft_accepted_total": 0,
        }

    # -- public API -----------------------------------------------------------

    def submit(self, task: GenTask) -> GenTask:
        task.id = self._next_task_id
        self._next_task_id += 1
        self.metrics["requests_total"] += 1
        self.tasks.put(task)
        return task

    def prewarm(self, max_prompt: int | None = None):
        """Run every step shape serving will hit once before traffic: one
        decode per prompt-length bucket up to max_prompt (default n_batch),
        the single-token decode, and the batched loop at each power-of-two
        slot count (the reference compiles a program for each; here the
        first calls build the kernels and warm the allocator)."""
        limit = max_prompt or self.n_batch
        buckets = [t for t in TOKEN_BUCKETS if t <= min(limit,
                                                        self.ctx.n_cells)]
        with self.ctx_lock:
            for T in buckets:
                self.ctx.seq_rm(0)
                self.ctx.decode(Batch.text([1] * T, seq_id=0))
            self.ctx.seq_rm(0)
            B = 1
            while B <= self.n_slots and self._batch_ctx_ok():
                seqs = list(range(B))
                for s in seqs:
                    self.ctx.seq_rm(s)
                    self.ctx.decode(Batch.text([1], seq_id=s))
                self.ctx.generate_loop_batch([1] * B, self.FAST_CHUNK, seq_ids=seqs)
                for s in seqs:
                    self.ctx.seq_rm(s)
                B *= 2

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    # -- inference loop ---------------------------------------------------------

    def _assign_tasks(self):
        for slot in self.slots:
            if slot.state != SlotState.IDLE:
                continue
            try:
                task = self.tasks.get_nowait()
            except queue.Empty:
                return
            if task.cancelled:
                # still notify the waiting client (a task cancelled while
                # queued must not strand its consumer)
                task.events.put({"done": True, "stop_reason": "cancelled",
                                 "n_prompt": len(task.prompt_tokens),
                                 "n_decoded": 0})
                continue
            # prompt-prefix reuse (server.cpp prompt caching)
            prefix = common_prefix_len(slot.cache_tokens, task.prompt_tokens)
            # always re-decode at least the final prompt token to get logits
            prefix = min(prefix, len(task.prompt_tokens) - 1)
            if prefix > 0:
                self.ctx.seq_rm(slot.id, prefix, -1)
                slot.cache_tokens = slot.cache_tokens[:prefix]
            else:
                self.ctx.seq_rm(slot.id)
                slot.cache_tokens = []
            slot.task = task
            slot.state = SlotState.PROCESSING_PROMPT
            slot.n_prompt_done = prefix
            slot.n_decoded = 0
            slot.text_tail = ""
            chain = build_chain(task.params, self.ctx.cfg.vocab_size)
            # the sampler sees the FULL prompt (common_sampler_accept over
            # every prompt token — penalties/DRY context), grammar does not
            for t in task.prompt_tokens:
                chain.accept(t)
            if task.params.grammar:
                # constrain generated text only (the grammar never sees the
                # prompt) — wrap after prompt acceptance
                from ..grammar import constrained_chain

                chain = constrained_chain(chain, self.tok,
                                          grammar=task.params.grammar)
            slot.chain = chain
            slot.t_start_prompt = time.time()
            if self.draft_ctx is not None:
                keep = min(prefix, slot.n_draft_past)
                self.draft_ctx.seq_rm(slot.id, keep, -1)
                slot.n_draft_past = keep
            if self.lookup_ngram:
                from ..runtime.speculative import NgramCache

                slot.ngram = NgramCache()
                slot.ngram_done = 0

    def _finish(self, slot: Slot, reason: str):
        task = slot.task
        n_prompt = len(task.prompt_tokens) if task else 0
        if task:
            task.events.put({
                "done": True, "stop_reason": reason,
                "n_prompt": n_prompt, "n_decoded": slot.n_decoded,
                "t_prompt": (slot.t_first_token or time.time()) - slot.t_start_prompt,
            })
        slot.task = None
        slot.state = SlotState.IDLE

    def _top_probs(self, logits: np.ndarray, tid: int, n: int):
        """softmax over the raw logits -> top-n + the sampled token's
        probability (server.cpp n_probs, pre-sampling distribution)."""
        z = logits.astype(np.float64)
        z = np.exp(z - z.max())
        p = z / z.sum()
        top = np.argsort(-p)[:n]
        entries = [{"id": int(i), "token": self.tok.piece(int(i)),
                    "prob": float(p[i])} for i in top]
        return entries, float(p[tid])

    def _sample_token(self, slot: Slot, logits: np.ndarray):
        task = slot.task
        tid = slot.chain.sample(logits)
        slot.chain.accept(tid)
        slot.n_decoded += 1
        if slot.n_decoded == 1:
            slot.t_first_token = time.time()
        self.metrics["tokens_predicted_total"] += 1
        slot.cache_tokens.append(tid)

        if self.tok.vocab.is_eog(tid):
            self._finish(slot, "eos")
            return
        piece = self.tok.piece(tid)
        slot.text_tail = (slot.text_tail + piece)[-64:]
        ev = {"done": False, "token": int(tid), "text": piece}
        if task.n_probs:
            ev["top_probs"], ev["prob"] = self._top_probs(
                logits, tid, task.n_probs)
        task.events.put(ev)
        for s in task.stop:
            if s and s in slot.text_tail:
                self._finish(slot, "stop_string")
                return
        if slot.n_decoded >= task.n_predict:
            self._finish(slot, "length")
        elif task.cancelled:
            self._finish(slot, "cancelled")

    def _gen_draft(self, slot: Slot) -> list[int]:
        """Draft-token proposal for a generating slot (draft model or
        n-gram lookup). Leaves the draft model's KV pruned back to the
        confirmed context so the next proposal starts clean."""
        if self.draft_ctx is not None:
            from ..runtime.speculative import gen_draft_tokens

            ctxt = slot.cache_tokens
            draft = gen_draft_tokens(
                self.draft_ctx, None, ctxt, slot.n_draft_past,
                self.n_draft, seq_id=slot.id)
            # drop the draft model's own speculative cells
            self.draft_ctx.seq_rm(slot.id, len(ctxt), -1)
            slot.n_draft_past = len(ctxt)
            return draft
        if self.lookup_ngram and slot.ngram is not None:
            # fold newly confirmed tokens into the per-slot n-gram stats
            toks = slot.cache_tokens
            if slot.ngram_done < len(toks):
                start = max(0, slot.ngram_done - slot.ngram.MAX_N)
                slot.ngram.update(toks[start:])
                slot.ngram_done = len(toks)
            return slot.ngram.draft(toks, self.n_draft)
        return []

    def _apply_chunk(self, slot: Slot, toks: list[int]) -> None:
        """Fold a device-generated token chunk into slot state: accept into
        the sampler chain, emit stream events, finish on EOG / stop string /
        length / cancel, then drop overshoot cells past the kept stream
        (the final sampled token is undecoded by construction)."""
        task = slot.task
        for tid in toks:
            if slot.task is None:
                break
            slot.chain.accept(tid)
            slot.n_decoded += 1
            if slot.n_decoded == 1:
                slot.t_first_token = time.time()
            self.metrics["tokens_predicted_total"] += 1
            slot.cache_tokens.append(tid)
            if self.tok.vocab.is_eog(tid):
                self._finish(slot, "eos")
                break
            piece = self.tok.piece(tid)
            slot.text_tail = (slot.text_tail + piece)[-64:]
            task.events.put({"done": False, "token": int(tid),
                             "text": piece})
            if any(s and s in slot.text_tail for s in task.stop):
                self._finish(slot, "stop_string")
                break
            if slot.n_decoded >= task.n_predict:
                self._finish(slot, "length")
                break
            if task.cancelled:
                self._finish(slot, "cancelled")
                break
        with self.ctx_lock:
            self.ctx.seq_rm(slot.id, len(slot.cache_tokens) - 1, -1)

    FAST_CHUNK = 8  # tokens per device dispatch on the fast path

    def _batch_ctx_ok(self) -> bool:
        """generate_loop_batch refuses the ISWA ring: a ring Context takes
        the scalar loop, as the reference's does."""
        return self.ctx.cells_swa is None

    def _fast_generate_batch(self, gen: list[Slot]) -> bool:
        """Step ALL generating slots one chunk forward in one call
        (Context.generate_loop_batch): the reference batches every
        generating slot into one llama_decode per token (server.cpp:2961
        update_slots); here each token of the chunk is one batched step
        over the slots with per-slot sampling on the card. Falls back to
        the scalar path (returns False) on KV pressure."""
        n = self.FAST_CHUNK
        v = self.tok.vocab
        eogs = tuple(i for i in (v.eos_id, getattr(v, "eot_id", -1))
                     if i is not None and i >= 0)
        temps, top_ks, top_ps, min_ps, seeds, lims = [], [], [], [], [], []
        for s in gen:
            p = s.task.params
            temps.append(p.temp)
            top_ks.append(p.top_k)
            top_ps.append(p.top_p)
            min_ps.append(p.min_p)
            if p.seed != 0xFFFFFFFF:
                base = p.seed
            else:
                base = s.task.id * 0x9E3779B1 + 12345
            # vary the device sampler's streams per chunk, deterministically
            # under a fixed request seed
            seeds.append((base * 1000003 + s.n_decoded) & 0x7FFFFFFF)
            lims.append(max(1, s.task.n_predict - s.n_decoded))
        with self.ctx_lock:
            try:
                rows = self.ctx.generate_loop_batch(
                    [s.cache_tokens[-1] for s in gen], n,
                    seq_ids=[s.id for s in gen], temps=temps, top_ks=top_ks,
                    top_ps=top_ps, min_ps=min_ps, seeds=seeds,
                    n_limits=lims, eog_ids=eogs)
            except NoFreeCells:
                return False  # the scalar path handles eviction
        if not any(rows):
            return False
        self.metrics["fast_chunks_total"] = \
            self.metrics.get("fast_chunks_total", 0) + 1
        for slot, toks in zip(gen, rows):
            self._apply_chunk(slot, toks)
        return True

    def _update_slots(self) -> bool:
        """One iteration of the continuous-batching loop; returns True if any
        work was done."""
        self._assign_tasks()

        # fast path: every generating slot's sampling config runs on the card and
        # there is no prompt/draft work to interleave -> advance ALL of them
        # one device chunk in a single dispatch
        from ..samplers.device import device_eligible

        gen = [s for s in self.slots if s.state == SlotState.GENERATING]
        fastable = (
            bool(gen) and self.draft_ctx is None and not self.lookup_ngram
            and self.tasks.empty()
            and all(s.task is not None and not s.task.n_probs
                    and device_eligible(s.task.params) for s in gen)
            and not any(s.state == SlotState.PROCESSING_PROMPT
                        for s in self.slots))
        if fastable and self._batch_ctx_ok() and self._fast_generate_batch(gen):
            return True

        batch = Batch()
        # (slot, [batch indices], kind, draft tokens)
        entries: list[tuple[Slot, list[int], str, list[int]]] = []
        # snapshot for rollback on KV-full (decode() failure rollback,
        # llama-context.cpp:1015-1035 analogue at the slot level)
        snap = {
            s.id: (s.n_prompt_done, len(s.cache_tokens)) for s in self.slots
        }
        spec = self.draft_ctx is not None or self.lookup_ngram

        # generation slots first: one token each (+ draft tokens to verify)
        for slot in self.slots:
            if slot.state == SlotState.GENERATING:
                pos = len(slot.cache_tokens) - 1
                draft = self._gen_draft(slot) if spec else []
                if draft:
                    self.metrics["draft_proposed_total"] += len(draft)
                batch.add(slot.cache_tokens[-1], pos, (slot.id,), logits=True)
                idxs = [len(batch) - 1]
                for j, t in enumerate(draft):
                    batch.add(t, pos + 1 + j, (slot.id,), logits=True)
                    idxs.append(len(batch) - 1)
                entries.append((slot, idxs, "gen", draft))

        # prompt-processing slots: fill remaining budget
        budget = self.n_batch - len(batch)
        for slot in self.slots:
            if slot.state != SlotState.PROCESSING_PROMPT or budget <= 0:
                continue
            task = slot.task
            remaining = task.prompt_tokens[slot.n_prompt_done :]
            take = min(len(remaining), budget)
            last = slot.n_prompt_done + take == len(task.prompt_tokens)
            for i, t in enumerate(remaining[:take]):
                pos = slot.n_prompt_done + i
                need_logits = last and i == take - 1
                batch.add(t, pos, (slot.id,), logits=need_logits)
                if need_logits:
                    entries.append((slot, [len(batch) - 1], "prompt_end", []))
            slot.n_prompt_done += take
            slot.cache_tokens.extend(remaining[:take])
            self.metrics["tokens_prompt_total"] += take
            budget -= take

        if len(batch) == 0:
            return False

        with self.ctx_lock:
            rc = self.ctx.decode(batch)
            logits_by_entry = (
                {bi: self.ctx.get_logits(bi)
                 for _, idxs, _, _ in entries for bi in idxs}
                if rc == 0 else {}
            )
        if rc == 1:
            # cache full: roll back in-flight bookkeeping + any partially
            # written cells, then evict the newest active task
            for slot in self.slots:
                pd, cl = snap[slot.id]
                if slot.state == SlotState.PROCESSING_PROMPT:
                    self.ctx.seq_rm(slot.id, pd, -1)
                    slot.n_prompt_done = pd
                    slot.cache_tokens = slot.cache_tokens[:pd]
                elif slot.state == SlotState.GENERATING:
                    self.ctx.seq_rm(slot.id, cl - 1, -1)
            for slot in reversed(self.slots):
                if slot.state != SlotState.IDLE and slot.task:
                    slot.task.events.put(
                        {"done": True, "stop_reason": "error:kv_full"})
                    self.ctx.seq_rm(slot.id)
                    slot.cache_tokens = []
                    slot.task = None
                    slot.state = SlotState.IDLE
                    break
            return True
        if rc != 0:
            raise RuntimeError(f"decode failed rc={rc}")

        for slot, idxs, kind, draft in entries:
            if slot.task is None:
                continue
            if kind == "prompt_end":
                slot.state = SlotState.GENERATING
                self._sample_token(slot, logits_by_entry[idxs[0]])
                continue
            # generation: sample at the last token, then verify each draft
            # position — accept while the target samples the drafted token
            # (server.cpp:3062 verify loop)
            pos = len(slot.cache_tokens) - 1  # position of idxs[0]'s token
            n_acc = 0
            for i, bi in enumerate(idxs):
                if slot.task is None:
                    break
                self._sample_token(slot, logits_by_entry[bi])
                tid = slot.cache_tokens[-1]
                if i < len(draft) and tid == draft[i] and slot.task is not None:
                    n_acc += 1
                    continue
                break
            if draft:
                self.metrics["draft_accepted_total"] += n_acc
                # drop KV cells of the rejected draft tail (cells were
                # written at pos+1 .. pos+len(draft) by this decode)
                if n_acc < len(draft):
                    self.ctx.seq_rm(slot.id, pos + 1 + n_acc, -1)
        return True

    def _run(self):
        while not self._stop.is_set():
            try:
                busy = self._update_slots()
            except Exception as e:  # surface errors to all active tasks
                for slot in self.slots:
                    if slot.task:
                        slot.task.events.put(
                            {"done": True, "stop_reason": f"error:{e}"})
                        slot.task = None
                        slot.state = SlotState.IDLE
                busy = False
            self.metrics["busy_slots"] = sum(
                1 for s in self.slots if s.state != SlotState.IDLE
            )
            if not busy:
                time.sleep(0.005)
