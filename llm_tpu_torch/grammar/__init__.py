"""Grammar-constrained decoding: GBNF engine, JSON-schema converter,
regex translation (the llguidance-analogue subset), sampler wiring. The
port's own copy of llm_tpu/grammar (plain Python)."""

from __future__ import annotations


def constrained_chain(chain, tok, grammar: str = "",
                      json_schema: dict | str | None = None,
                      lazy: bool = False,
                      trigger_tokens: tuple[int, ...] = (),
                      trigger_patterns: tuple[str, ...] = ()):
    """Wrap a sampler chain with a grammar constraint built from any of the
    server/CLI-facing specs:

    - `grammar`: GBNF text, or "%regex <pattern>" (llguidance-style inline
      regex, full-match semantics)
    - `json_schema`: dict/str -> GBNF via json_schema_to_gbnf

    Returns the chain unchanged when no constraint is given.
    """
    from .gbnf import Grammar
    from .json_schema import json_schema_to_gbnf
    from .regex import regex_to_gbnf
    from .sampler import GrammarChain, GrammarSampler

    text = grammar or ""
    if text.startswith("%regex"):
        text = regex_to_gbnf(text[len("%regex"):].strip())
    elif not text and json_schema is not None:
        text = json_schema_to_gbnf(json_schema)
    if not text:
        return chain
    gs = GrammarSampler(Grammar.from_string(text), tok, lazy=lazy,
                        trigger_tokens=trigger_tokens,
                        trigger_patterns=trigger_patterns)
    return GrammarChain(chain, gs)


__all__ = ["constrained_chain"]
