"""UGM (SentencePiece Unigram) tokenizer — T5 family.

The port's own copy of llm_tpu/tokenizers/ugm.py.

Behavioral parity with llm_tokenizer_ugm
(llama.cpp's src/llama-vocab.cpp:738-1090):
  * normalization through the model's precompiled charsmap — an
    XOR-compressed compact double array (XCDA) of prefix → replacement
    rules, stored verbatim in GGUF (tokenizer.ggml.precompiled_charsmap)
  * space handling per vocab flags (escape to U+2581, optional prefix
    space, optional extra-whitespace merging)
  * optimal-path Viterbi over a token trie with double-precision scores,
    user-defined tokens scoring 0.0 and unknowns scoring
    min_score - 10.0, with consecutive unknowns merged
"""

from __future__ import annotations

import struct

from .vocab import TokenType, Vocab

_ESCAPED_SPACE = "▁"  # lower one eighth block
_UNKNOWN_PENALTY = 10.0


class _Trie:
    __slots__ = ("children", "value")

    def __init__(self):
        self.children: dict[int, _Trie] = {}
        self.value: int | None = None

    def insert(self, key: bytes, value: int) -> None:
        node = self
        for b in key:
            nxt = node.children.get(b)
            if nxt is None:
                nxt = node.children[b] = _Trie()
            node = nxt
        node.value = value


class _Xcda:
    """View over the XCDA blob (llama-vocab.cpp xcda_array_view:972-1004).

    Each packed uint32 entry: BASE in bits 10-30 (shifted left 6 more when
    bit 9 is set), LCHECK in bits 0-7 plus bit 31, LEAF in bit 8."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        if size + 4 > len(blob):
            raise ValueError("precompiled charsmap: XCDA blob out of bounds")
        n = size // 4
        self.nodes = struct.unpack_from(f"<{n}I", blob, 4)
        self.replacements = blob[4 + size:]

    def _node(self, i: int) -> int:
        if i >= len(self.nodes):
            raise IndexError("XCDA index out of bounds")
        return self.nodes[i]

    def base(self, i: int) -> int:
        p = self._node(i)
        return (p >> 10) << ((p & (1 << 9)) >> 6)

    def lcheck(self, i: int) -> int:
        p = self._node(i)
        return p & ((1 << 31) | 0xFF)

    def leaf(self, i: int) -> bool:
        return bool((self._node(i) >> 8) & 1)

    def value(self, i: int) -> int:
        return self._node(i) & ((1 << 31) - 1)


def _utf8_len(b: int) -> int:
    if b < 0x80:
        return 1
    if b >> 5 == 0b110:
        return 2
    if b >> 4 == 0b1110:
        return 3
    if b >> 3 == 0b11110:
        return 4
    return 1


def _valid_utf8_prefix(data: bytes, off: int) -> int:
    """Length of one valid UTF-8 codepoint at off, or 0."""
    n = _utf8_len(data[off])
    if off + n > len(data):
        return 0
    if n == 1:
        return 0 if data[off] >= 0x80 else 1
    for k in range(1, n):
        if data[off + k] >> 6 != 0b10:
            return 0
    return n


class UgmTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.trie = _Trie()
        self.user_defined = _Trie()
        min_score = float("inf")
        for i, tok in enumerate(vocab.tokens):
            t = vocab.types[i]
            if t == TokenType.NORMAL:
                min_score = min(min_score, float(vocab.scores[i]))
            if t in (TokenType.NORMAL, TokenType.USER_DEFINED, TokenType.UNUSED):
                self.trie.insert(tok.encode("utf-8"), i)
            if t == TokenType.USER_DEFINED:
                self.user_defined.insert(tok.encode("utf-8"), i)
        self.unknown_token_score = (
            min_score if min_score != float("inf") else 0.0
        ) - _UNKNOWN_PENALTY
        self.xcda = _Xcda(vocab.precompiled_charsmap) if vocab.precompiled_charsmap else None
        # reference flags: escape_whitespaces is always true for UGM models;
        # treat_whitespace_as_suffix is false for every supported arch
        self.escape_whitespaces = True

    # -- normalization (llm_tokenizer_ugm_session::normalize) ---------------
    def _normalize_prefix(self, data: bytes, off: int) -> tuple[bytes, int]:
        """-> (normalized bytes, consumed input bytes)."""
        # user-defined tokens pass through unmodified (longest match)
        node = self.user_defined
        best = 0
        for k in range(off, len(data)):
            node = node.children.get(data[k])
            if node is None:
                break
            if node.value is not None:
                best = k - off + 1
        if best:
            return data[off:off + best], best

        if self.xcda is not None:
            longest_len = 0
            longest_val = 0
            try:
                idx = self.xcda.base(0)
                for k in range(off, len(data)):
                    c = data[k]
                    if c == 0:
                        break
                    idx ^= c
                    if self.xcda.lcheck(idx) != c:
                        break
                    is_leaf = self.xcda.leaf(idx)
                    idx ^= self.xcda.base(idx)
                    if is_leaf:
                        longest_len = k - off + 1
                        longest_val = self.xcda.value(idx)
            except IndexError:
                pass
            if longest_len:
                rep = self.xcda.replacements
                end = rep.index(b"\0", longest_val)
                return rep[longest_val:end], longest_len

        n = _valid_utf8_prefix(data, off)
        if n:
            return data[off:off + n], n
        return b"\xef\xbf\xbd", 1  # U+FFFD for invalid bytes

    def _normalize(self, text: str) -> bytes:
        v = self.vocab
        data = text.encode("utf-8")
        space = _ESCAPED_SPACE.encode("utf-8") if self.escape_whitespaces else b" "
        prepend = v.add_space_prefix
        merge = v.remove_extra_whitespaces

        out = bytearray()
        space_prepended = False
        in_word = False
        off = 0
        while off < len(data):
            norm, consumed = self._normalize_prefix(data, off)
            for c in norm:
                if c != 0x20:
                    if not in_word:
                        in_word = True
                        if (prepend and not space_prepended) or merge:
                            out += space
                            space_prepended = True
                    out.append(c)
                else:
                    if in_word:
                        in_word = False
                    if not merge:
                        out += space
            off += consumed
        return bytes(out)

    # -- Viterbi (llm_tokenizer_ugm_session::tokenize) ----------------------
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

    def _tokenize_fragment(self, text: str, out: list[int]) -> None:
        v = self.vocab
        data = self._normalize(text)
        n = len(data)
        if n == 0:
            return
        NEG = float("-inf")
        best_tok = [v.unk_id] * (n + 1)
        best_src = [0] * (n + 1)
        best_score = [NEG] * (n + 1)
        best_score[0] = 0.0

        off = 0
        while off < n:
            cur = best_score[off]
            n_units = _valid_utf8_prefix(data, off) or 1
            n_units = min(n_units, n - off)
            single_cpt_found = False
            node = self.trie.children.get(data[off])
            k = off + 1
            while node is not None:
                if node.value is not None:
                    if k - off == n_units:
                        single_cpt_found = True
                    tid = node.value
                    score = 0.0 if v.types[tid] == TokenType.USER_DEFINED else float(v.scores[tid])
                    cand = cur + score
                    if cand > best_score[k]:
                        best_tok[k], best_src[k], best_score[k] = tid, off, cand
                if k >= n:
                    break
                node = node.children.get(data[k])
                k += 1
            if not single_cpt_found:
                k = off + n_units
                cand = cur + self.unknown_token_score
                if cand > best_score[k]:
                    best_tok[k], best_src[k], best_score[k] = v.unk_id, off, cand
            off += n_units

        # backtrack, merging consecutive unknowns
        rev: list[int] = []
        pos = n
        prev_unk = False
        while True:
            tid = best_tok[pos]
            is_unk = tid == v.unk_id
            if not (prev_unk and is_unk):
                rev.append(tid)
            if best_src[pos] == 0:
                break
            prev_unk = is_unk
            pos = best_src[pos]
        out.extend(reversed(rev))

    def decode(self, ids, skip_special: bool = False) -> str:
        v = self.vocab
        parts = []
        for tid in ids:
            tid = int(tid)
            if skip_special and v.is_special(tid):
                continue
            parts.append(v.tokens[tid])
        text = "".join(parts).replace(_ESCAPED_SPACE, " ")
        return text[1:] if text.startswith(" ") and v.add_space_prefix else text

    def piece(self, tid: int, special: bool = False) -> str:
        return self.vocab.tokens[int(tid)]
