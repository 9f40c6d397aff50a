"""(The port's own copy of llm_tpu/runtime/speculative.py, on its Batch.) Speculative decoding + n-gram lookup drafting.

Parity targets:
  * draft-model speculation: common_speculative_gen_draft
    (llama.cpp's common/speculative.cpp:137) + the server's per-slot
    verify loop (server.cpp:3062): draft proposes up to n_draft tokens,
    the target verifies them in ONE batched decode and accepts the longest
    prefix that matches its own sampling.
  * prompt n-gram lookup: common_ngram_cache_draft
    (llama.cpp's common/ngram-cache.h:84) — draft continuations from
    n-gram statistics of the context, no draft model needed.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .batch import Batch


class NgramCache:
    """N-gram -> next-token frequency maps for sizes 1..4
    (common/ngram-cache.h semantics, simplified to one merged cache)."""

    MIN_N = 1
    MAX_N = 4

    def __init__(self):
        self.maps = {n: defaultdict(lambda: defaultdict(int))
                     for n in range(self.MIN_N, self.MAX_N + 1)}

    def update(self, tokens: list[int]) -> None:
        for n in range(self.MIN_N, self.MAX_N + 1):
            for i in range(len(tokens) - n):
                key = tuple(tokens[i : i + n])
                self.maps[n][key][tokens[i + n]] += 1

    def _best(self, context: list[int]) -> int | None:
        # prefer longer n-grams; require a clearly dominant continuation
        for n in range(self.MAX_N, self.MIN_N - 1, -1):
            if len(context) < n:
                continue
            key = tuple(context[-n:])
            cand = self.maps[n].get(key)
            if not cand:
                continue
            tok, cnt = max(cand.items(), key=lambda kv: kv[1])
            total = sum(cand.values())
            if cnt >= 2 and cnt * 2 > total:
                return tok
        return None

    def draft(self, context: list[int], n_draft: int) -> list[int]:
        out: list[int] = []
        ctx = list(context)
        for _ in range(n_draft):
            t = self._best(ctx)
            if t is None:
                break
            out.append(t)
            ctx.append(t)
        return out


def gen_draft_tokens(
    draft_ctx,
    draft_chain,
    context_tokens: list[int],
    n_past_drafted: int,
    n_draft: int,
    seq_id: int = 0,
) -> list[int]:
    """Greedy draft proposal from a (smaller) draft model context.

    `n_past_drafted`: how many of context_tokens are already in the draft
    model's KV; the rest is prefilled first.
    """
    todo = context_tokens[n_past_drafted:]
    if todo:
        rc = draft_ctx.decode(
            Batch.text(todo, seq_id=seq_id, pos_start=n_past_drafted)
        )
        if rc != 0:
            return []
    out = []
    pos = len(context_tokens)
    for _ in range(n_draft):
        logits = draft_ctx.get_logits()
        t = int(np.argmax(logits))
        out.append(t)
        if draft_ctx.decode(Batch.one(t, pos=pos, seq_id=seq_id)) != 0:
            break
        pos += 1
    return out


def verify_draft(
    ctx,
    chain,
    last_token: int,
    draft: list[int],
    n_past: int,
    seq_id: int = 0,
):
    """Target-model verification: decode [last_token, draft...] in one batch,
    sample at each position, accept the longest matching prefix.

    Returns (accepted_tokens, next_token, n_accepted). The KV cache is left
    consistent: cells for rejected draft positions are removed.
    """
    b = Batch()
    b.add(last_token, n_past, (seq_id,), logits=True)
    for i, t in enumerate(draft):
        b.add(t, n_past + 1 + i, (seq_id,), logits=True)
    rc = ctx.decode(b)
    if rc != 0:
        raise RuntimeError(f"verify decode failed rc={rc}")

    accepted: list[int] = []
    for i in range(len(draft) + 1):
        sampled = chain.sample(ctx.get_logits(i))
        chain.accept(sampled)
        if i < len(draft) and sampled == draft[i]:
            accepted.append(sampled)
            continue
        # first mismatch (or end): drop KV of unconfirmed draft tail
        ctx.seq_rm(seq_id, n_past + 1 + i, -1)
        return accepted, sampled, len(accepted)
    return accepted, None, len(accepted)
