"""WordPiece tokenizer (BERT-family).

The port's own copy of llm_tpu/tokenizers/wpm.py.

Behavioral parity with the reference's llm_tokenizer_wpm
(llama.cpp's src/llama-vocab.cpp:626-733): NFD-normalize, lowercase,
strip control chars, split into words on whitespace with punctuation /
ASCII symbols / CJK chars as single-char words, then greedy longest-match
against the vocab with the U+2581 phantom-space prefix; a word with no
full tokenization becomes a single UNK.
"""

from __future__ import annotations

import unicodedata

from .vocab import Vocab


def _is_cjk(cp: int) -> bool:
    # CJK ranges used by BERT's basic tokenizer (llama-vocab.cpp:718-729)
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B920 <= cp <= 0x2CEAF  # HF quirk: 0x2B920, not 0x2B820
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WpmTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.max_token_len = max((len(t.encode("utf-8")) for t in vocab.tokens), default=0)

    # -- preprocessing (llm_tokenizer_wpm_session::preprocess) --------------
    def _words(self, text: str) -> list[str]:
        # the reference's NFD maps each codepoint to the FIRST codepoint of
        # its canonical decomposition (unicode.cpp:608-619) — combining
        # marks of precomposed chars are dropped, i.e. accents stripped
        nfd = "".join(unicodedata.normalize("NFD", ch)[0] for ch in text)
        words: list[str] = [""]
        for ch in nfd:
            cp = ord(ch)
            cat = unicodedata.category(ch)
            if cat == "Zs" or ch in "\t\n\r\x0b\x0c" or cat == "Zl" or cat == "Zp":
                if words[-1]:
                    words.append("")
                continue
            if cp == 0 or cp == 0xFFFD or cat.startswith("C"):
                continue
            s = ch.lower()
            is_punct = cat.startswith("P")
            is_symbol = cat.startswith("S")
            if is_punct or (cp < 0x7F and is_symbol) or _is_cjk(cp):
                if words[-1]:
                    words.append("")
                words[-1] = s
                words.append("")
            else:
                words[-1] += s
        if words and not words[-1]:
            words.pop()
        return words

    def encode(self, text: str, add_special: bool = True, parse_special: bool = False) -> list[int]:
        out: list[int] = []
        v = self.vocab
        if add_special and v.add_bos and v.bos_id >= 0:
            out.append(v.bos_id)
        for frag, tid in v.split_on_specials(text, parse_special):
            if tid is not None:
                out.append(tid)
                continue
            self._tokenize_fragment(frag, out)
        if add_special and v.add_eos and v.eos_id >= 0:
            out.append(v.eos_id)
        return out

    def _tokenize_fragment(self, text: str, out: list[int]) -> None:
        v = self.vocab
        for word in self._words(text):
            if not word:
                continue
            word1 = "▁" + word
            n = len(word1)
            start_len = len(out)
            i = 0
            ok = True
            while i < n:
                match = False
                for j in range(min(n, i + self.max_token_len + 1), i, -1):
                    tid = v.token_to_id.get(word1[i:j])
                    if tid is not None:
                        out.append(tid)
                        i = j
                        match = True
                        break
                if not match:
                    del out[start_len:]
                    ok = False
                    break
            if not ok or len(out) == start_len:
                out.append(v.unk_id)

    def decode(self, ids, skip_special: bool = False) -> str:
        v = self.vocab
        parts = []
        for tid in ids:
            if skip_special and v.is_special(int(tid)):
                continue
            parts.append(v.tokens[int(tid)])
        return "".join(parts).replace("▁", " ").lstrip(" ")

    def piece(self, tid: int, special: bool = False) -> str:
        return self.vocab.tokens[int(tid)]
