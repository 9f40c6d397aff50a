"""Byte-level BPE tokenizer with per-model pre-tokenizer regexes.

The port's own copy of llm_tpu/tokenizers/bpe.py. Parity target:
llm_tokenizer_bpe (llama.cpp's src/llama-vocab.cpp:278) and the
pre-tokenizer registry (llama_vocab_pre_type, llama.h:83-119). The
patterns are the models' published pre-tokenizer definitions (also found
in each model's tokenizer.json), written with `\\p{..}` classes; llm_tpu
compiles them with the `regex` package, the port with the standard `re`
after uclass.translate has spelled the classes out (the port carries no
`regex`).
"""

from __future__ import annotations

import re

from .uclass import translate
from .vocab import TokenType, Vocab

_GPT2 = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
_LLAMA3 = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_QWEN2 = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# the non-ASCII class tables below are the models' published pre-tokenizer
# definitions (tokenizer.json data, also tabulated in llama-vocab.cpp)
_DS_LLM_LETTERS = '\\s?[A-Za-z\xb5\xc0-\xd6\xd8-\xf6\xf8-\u01ba\u01bc-\u01bf\u01c4-\u0293\u0295-\u02af\u0370-\u0373\u0376\u0377\u037b-\u037d\u037f\u0386\u0388-\u038a\u038c\u038e-\u03a1\u03a3-\u03f5\u03f7-\u0481\u048a-\u052f\u0531-\u0556\u10a0-\u10c5\u13a0-\u13f5\u13f8-\u13fd\u1c90-\u1cba\u1cbd-\u1cbf\u1d00-\u1d2b\u1d6b-\u1d77\u1d79-\u1d9a\u1e00-\u1f15\u1f18-\u1f1d\u1f20-\u1f45\u1f48-\u1f4d\u1f50-\u1f57\u1f59\u1f5b\u1f5d\u1f5f-\u1f7d\u1f80-\u1fb4\u1fb6-\u1fbc\u1fbe\u1fc2-\u1fc4\u1fc6-\u1fcc\u1fd0-\u1fd3\u1fd6-\u1fdb\u1fe0-\u1fec\u1ff2-\u1ff4\u1ff6-\u1ffc\u2102\u2107\u210a-\u2113\u2115\u2119-\u211d\u2124\u2126\u2128\u212a-\u212d\u212f-\u2134\u2139\u213c-\u213f\u2145-\u2149\u214e\u2183\u2184\u2c00-\u2c7b\u2c7e-\u2ce4\u2ceb-\u2cee\u2cf2\u2cf3\ua640-\ua66d\ua680-\ua69b\ua722-\ua76f\ua771-\ua787\ua78b-\ua78e\uab70-\uabbf\ufb00-\ufb06\ufb13-\ufb17\uff21-\uff3a\uff41-\uff5a\U00010400-\U0001044f\U000104b0-\U000104d3\U000104d8-\U000104fb\U00010c80-\U00010cb2\U00010cc0-\U00010cf2\U000118a0-\U000118df\U0001e900-\U0001e943]+'
_CJK = "[一-龥ࠀ-一가-퟿]+"

# gpt-4o / llama4 (tokenizer.json original; llama.cpp transliterates the
# (?i:) groups for its engine — `re` takes them natively)
_GPT4O = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
    r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
    r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# mistral-nemo "tekken" (tokenizer.json original)
_TEKKEN = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_PORO = " ?[^(\\s|.,!?…。，、।۔،)]+"

PRE_PATTERNS: dict[str, list[str]] = {
    "default": [_GPT2],
    "gpt-2": [_GPT2],
    "gpt2": [_GPT2],
    "phi-2": [_GPT2],
    "mpt": [_GPT2],
    "olmo": [_GPT2],
    "jais": [_GPT2],
    "trillion": [_GPT2],
    "jina-es": [_GPT2],
    "jina-de": [_GPT2],
    "jina-v1-en": [_GPT2],
    "jina-v2-es": [_GPT2],
    "jina-v2-de": [_GPT2],
    "jina-v2-code": [_GPT2],
    "roberta-bpe": [_GPT2],
    "gigachat": [_GPT2],
    "llama3": [_LLAMA3],
    "llama-bpe": [_LLAMA3],
    "llama-v3": [_LLAMA3],
    "falcon3": [_LLAMA3],
    "pixtral": [_LLAMA3],
    "smaug-bpe": [_LLAMA3],
    "dbrx": [_LLAMA3],
    "glm4": [_LLAMA3],
    "chatglm-bpe": [_LLAMA3],
    "qwen2": [_QWEN2],
    "deepseek-r1-qwen": [_QWEN2],
    "megrez": [_QWEN2],
    "stablelm2": [_QWEN2],
    "gpt-4o": [_GPT4O],
    "llama4": [_GPT4O],
    "tekken": [_TEKKEN],
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)",
        r"[0-9][0-9][0-9]",
    ],
    "deepseek-llm": [
        r"[\r\n]", _DS_LLM_LETTERS,
        "\\s?[!-/:-~！-／：-～‘-‟　-。]+", r"\s+$", _CJK, r"\p{N}+",
    ],
    "deepseek-coder": [
        r"[\r\n]", r"\s?\p{L}+", r"\s?\p{P}+", _CJK, r"\p{N}",
    ],
    "deepseek-v3": [
        r"\p{N}{1,3}",
        "[一-龥぀-ゟ゠-ヿ]+",
        "[!\"#$%&'()*+,\\-./:;<=>?@\\[\\\\\\]^_`{|}~][A-Za-z]+"
        r"|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*"
        r"|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "starcoder": [r"\p{N}", _GPT2],
    "refact": [r"\p{N}", _GPT2],
    "command-r": [r"\p{N}", _GPT2],
    "smollm": [r"\p{N}", _GPT2],
    "codeshell": [r"\p{N}", _GPT2],
    "exaone": [r"\p{N}", _GPT2],
    "minerva-7b": [r"\p{N}", _GPT2],
    "poro-chat": [_PORO],
    "bloom": [_PORO],
    "gpt3-finnish": [_PORO],
    "viking": [_PORO, r"\p{N}"],
    "superbpe": [r"\p{N}+", r"(?=(\d{3})+(?!\d))"],
    "bailingmoe": [
        # tokenizer.json original (possessive quantifiers are native to re)
        r"'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}"
        r"| ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+",
    ],
    "seed-coder": [
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1}"
        r"| ?[^\s\p{L}\p{N}\r\n]+|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "chameleon": [
        r"<sentinel:[0-9]+>",
        r"(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z",
        "([\\t\\n]|    |  )",
        r"\p{N}",
        r"[\p{P}!-/:-@\[-`{-~]",
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)",
    ],
}


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte<->printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_ENC = bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}


class BpeTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        pats = PRE_PATTERNS.get(vocab.pre, PRE_PATTERNS["default"])
        self._regexes = [re.compile(translate(p)) for p in pats]
        self.ranks = {}
        for rank, m in enumerate(vocab.merges):
            a, sep, b = m.partition(" ")
            if sep:
                self.ranks[(a, b)] = rank

    def _bpe_word(self, word: str, out: list[int]) -> None:
        v = self.vocab
        parts = list(word)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        for p in parts:
            tid = v.token_to_id.get(p)
            if tid is not None:
                out.append(tid)
            else:
                for ch in p:  # byte-level fallback per mapped char
                    tid = v.token_to_id.get(ch)
                    if tid is not None:
                        out.append(tid)
                    elif v.unk_id >= 0:
                        out.append(v.unk_id)

    def _tokenize_fragment(self, text: str, out: list[int]) -> None:
        # sequential within-piece splitting, keeping unmatched gaps
        # (llama.cpp: unicode_regex_split, src/unicode.cpp)
        pieces = [text]
        for rx in self._regexes:
            nxt = []
            for p in pieces:
                last = 0
                for m in rx.finditer(p):
                    if m.start() > last:
                        nxt.append(p[last : m.start()])
                    if m.end() > m.start():
                        nxt.append(m.group(0))
                    last = m.end()
                if last < len(p):
                    nxt.append(p[last:])
            pieces = nxt
        for p in pieces:
            mapped = "".join(_BYTE_ENC[b] for b in p.encode("utf-8"))
            self._bpe_word(mapped, out)

    def encode(self, text: str, add_special: bool = True, parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if add_special and v.add_bos and v.bos_id >= 0:
            out.append(v.bos_id)
        for frag, tid in v.split_on_specials(text, parse_special):
            if tid is not None:
                out.append(tid)
            else:
                self._tokenize_fragment(frag, out)
        if add_special and v.add_eos and v.eos_id >= 0:
            out.append(v.eos_id)
        return out

    def piece(self, tid: int, special: bool = False) -> str:
        v = self.vocab
        if v.types[tid] == TokenType.CONTROL and not special:
            return ""
        tok = v.tokens[tid]
        if v.types[tid] in (TokenType.CONTROL, TokenType.USER_DEFINED):
            return tok
        return bytes(_BYTE_DEC.get(c, ord(" ")) for c in tok).decode(
            "utf-8", errors="replace"
        )

    def decode(self, ids: list[int], special: bool = False) -> str:
        v = self.vocab
        buf = bytearray()
        for tid in ids:
            if v.types[tid] == TokenType.CONTROL and not special:
                continue
            tok = v.tokens[tid]
            if v.types[tid] in (TokenType.CONTROL, TokenType.USER_DEFINED):
                buf += tok.encode("utf-8")
            else:
                buf += bytes(_BYTE_DEC.get(c, ord(" ")) for c in tok)
        return buf.decode("utf-8", errors="replace")
