"""SentencePiece-style tokenizer (greedy best-score bigram merging).

The port's own copy of llm_tpu/tokenizers/spm.py.

Parity target: llm_tokenizer_spm (llama.cpp's src/llama-vocab.cpp:109):
whitespace escaped to U+2581, UTF-8 character symbols merged bottom-up by
vocabulary score, byte fallback to <0xXX> tokens, recursive resegmentation
of unmatched symbols.
"""

from __future__ import annotations

import heapq

from .vocab import TokenType, Vocab

SPIECE_UNDERLINE = "▁"


class SpmTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    # -- core ---------------------------------------------------------------

    def _tokenize_fragment(self, text: str, out: list[int]) -> None:
        v = self.vocab
        text = text.replace(" ", SPIECE_UNDERLINE)
        if not text:
            return
        # symbols: list of (start, end) spans over `text`
        chars = list(text)
        n = len(chars)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        pieces = chars[:]  # current text of each live symbol
        alive = [True] * n
        rev_merge: dict[str, tuple[str, str]] = {}

        def bigram(i):
            j = nxt[i]
            if j >= n:
                return None
            cat = pieces[i] + pieces[j]
            tid = v.token_to_id.get(cat)
            if tid is None or v.types[tid] != TokenType.NORMAL:
                return None
            # heap orders by (-score, left index): best score first,
            # leftmost on ties — matches the reference's priority queue
            return (-float(v.scores[tid]), i, len(cat))

        heap = []
        for i in range(n - 1):
            b = bigram(i)
            if b:
                heapq.heappush(heap, b)

        while heap:
            negscore, i, size = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j >= n or not alive[j]:
                continue
            if len(pieces[i]) + len(pieces[j]) != size:
                continue  # stale entry
            cat = pieces[i] + pieces[j]
            rev_merge[cat] = (pieces[i], pieces[j])
            pieces[i] = cat
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prev[nxt[i]] = i
            for b in (bigram(i), bigram(prev[i]) if prev[i] >= 0 else None):
                if b:
                    heapq.heappush(heap, b)

        def resegment(piece: str) -> None:
            tid = v.token_to_id.get(piece)
            if tid is not None:
                out.append(tid)
                return
            if piece in rev_merge:
                a, b = rev_merge[piece]
                resegment(a)
                resegment(b)
                return
            for byte in piece.encode("utf-8"):
                out.append(v.byte_id(byte))

        i = 0
        while i < n:
            if alive[i]:
                resegment(pieces[i])
            i = nxt[i] if alive[i] else i + 1

    # -- public api ----------------------------------------------------------

    def encode(self, text: str, add_special: bool = True, parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if add_special and v.add_bos and v.bos_id >= 0:
            out.append(v.bos_id)
        first_raw = True
        for frag, tid in v.split_on_specials(text, parse_special):
            if tid is not None:
                out.append(tid)
                continue
            if first_raw and v.add_space_prefix and frag:
                frag = " " + frag
            first_raw = False
            self._tokenize_fragment(frag, out)
        if add_special and v.add_eos and v.eos_id >= 0:
            out.append(v.eos_id)
        return out

    def piece(self, tid: int, special: bool = False) -> str:
        v = self.vocab
        t = v.types[tid]
        if t == TokenType.BYTE:
            for b, i in v._byte_ids.items():
                if i == tid:
                    return chr(b)
            return ""
        if t in (TokenType.CONTROL, TokenType.UNKNOWN) and not special:
            return ""
        return v.tokens[tid].replace(SPIECE_UNDERLINE, " ")

    def decode(self, ids: list[int], special: bool = False) -> str:
        buf = bytearray()
        for tid in ids:
            t = self.vocab.types[tid]
            if t == TokenType.BYTE:
                tok = self.vocab.tokens[tid]
                buf += bytes([int(tok[3:5], 16)])
            else:
                buf += self.piece(tid, special).encode("utf-8")
        s = buf.decode("utf-8", errors="replace")
        # the reference strips the injected leading space on detokenize
        if self.vocab.add_space_prefix and s.startswith(" "):
            s = s[1:]
        return s
