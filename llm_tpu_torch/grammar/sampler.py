"""Grammar-constrained sampling: the port's own copy of
llm_tpu/grammar/sampler.py, on the standard `re`.

Parity target: llama_sampler_init_grammar + the grammar-aware resample loop
in common_sampler_sample (llama.cpp's common/sampling.cpp:338-355):
sample freely first, validate against the grammar, and only on rejection
apply the full grammar mask and resample. Lazy grammars activate on trigger
tokens or trigger patterns (llama.h:1323, llama-grammar.h:124-132).
"""

from __future__ import annotations

import re

from ..samplers.chain import Candidates, Chain, Sampler
from ..tokenizers.uclass import translate
from .gbnf import Grammar

NEG_INF = float("-inf")


class GrammarSampler(Sampler):
    name = "grammar"

    def __init__(
        self,
        grammar: Grammar,
        tok,
        lazy: bool = False,
        trigger_tokens: tuple[int, ...] = (),
        trigger_patterns: tuple[str, ...] = (),
    ):
        self.grammar = grammar
        self.tok = tok
        self.lazy = lazy
        self.active = not lazy
        self.trigger_tokens = set(trigger_tokens)
        # the standard re, \\p{..} classes rewritten by tokenizers/uclass.py
        self.trigger_patterns = [re.compile(translate(p), re.DOTALL) for p in trigger_patterns]
        self._text = ""
        self._piece_cache: dict[int, str] = {}

    def _piece(self, tid: int) -> str:
        p = self._piece_cache.get(tid)
        if p is None:
            p = self.tok.piece(int(tid))
            self._piece_cache[tid] = p
        return p

    def valid(self, tid: int) -> bool:
        if not self.active:
            return True
        if self.tok.vocab.is_eog(tid):
            return self.grammar.can_end
        piece = self._piece(tid)
        if not piece:
            # reference rejects empty-piece (control) tokens under an
            # active grammar (llama_grammar_apply_impl:1147)
            return False
        return self.grammar.can_accept(piece)

    def apply(self, cur: Candidates) -> None:
        if not self.active:
            return
        for i, tid in enumerate(cur.ids):
            if not self.valid(int(tid)):
                cur.logits[i] = NEG_INF

    def accept(self, token: int) -> None:
        token = int(token)
        if not self.active:
            if token in self.trigger_tokens:
                self.active = True
                return
            if self.trigger_patterns:
                self._text += self._piece(token)
                for pat in self.trigger_patterns:
                    m = pat.search(self._text)
                    if m:
                        self.active = True
                        # feed the matched suffix into the grammar
                        self.grammar.accept_string(m.group(0))
                        return
            return
        if self.tok.vocab.is_eog(token):
            return
        piece = self._piece(token)
        if piece:
            self.grammar.accept_string(piece)

    def reset(self) -> None:
        self.grammar.reset()
        self.active = not self.lazy
        self._text = ""


class GrammarChain:
    """The reference's grammar-aware sampler wrapper: free sample -> check ->
    constrained resample (common_sampler_sample)."""

    def __init__(self, chain: Chain, grammar_sampler: GrammarSampler):
        self.chain = chain
        self.gs = grammar_sampler

    def sample(self, logits) -> int:
        tid = self.chain.sample(logits)
        if self.gs.valid(tid):
            return tid
        cur = Candidates.from_logits(logits)
        self.gs.apply(cur)
        self.chain.apply(cur)
        if cur.selected < 0:
            import numpy as np

            cur.selected = int(np.argmax(cur.logits))
        return int(cur.ids[cur.selected])

    def accept(self, token: int) -> None:
        self.chain.accept(token)
        self.gs.accept(token)

    def reset(self) -> None:
        self.chain.reset()
        self.gs.reset()
