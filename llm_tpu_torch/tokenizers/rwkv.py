"""RWKV world tokenizer: greedy longest-match over raw bytes.

The port's own copy of llm_tpu/tokenizers/rwkv.py.

Behavioral parity with llm_tokenizer_rwkv
(llama.cpp's src/llama-vocab.cpp:1093-1190): vocab entries are stored
escaped (\\n \\r \\t \\xNN \\\\); unescape to raw bytes at build time, then
tokenize with a byte trie taking the longest match at each position.
"""

from __future__ import annotations

from .vocab import Vocab


def unescape_rwkv_token(escaped: str) -> bytes:
    out = bytearray()
    it = iter(escaped.encode("utf-8", "surrogateescape"))
    esc = False
    hex_left = 0
    hex_acc = 0
    for b in it:
        if hex_left:
            c = chr(b)
            hex_acc = (hex_acc << 4) + (ord(c) - ord("a") + 10 if c >= "a" else ord(c) - ord("0"))
            hex_left -= 1
            if hex_left == 0:
                out.append(hex_acc & 0xFF)
                hex_acc = 0
            continue
        if esc:
            if b == ord("t"):
                out.append(9)
            elif b == ord("n"):
                out.append(10)
            elif b == ord("r"):
                out.append(13)
            elif b == ord("x"):
                hex_left = 2
            else:
                out.append(b)
            esc = False
            continue
        if b == ord("\\"):
            esc = True
            continue
        out.append(b)
    return bytes(out)


class RwkvTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.trie: dict = {}
        self.raw: list[bytes] = []
        for i, tok in enumerate(vocab.tokens):
            raw = unescape_rwkv_token(tok)
            self.raw.append(raw)
            node = self.trie
            for b in raw:
                node = node.setdefault(b, {})
            node[-1] = i  # value sentinel

    def encode(self, text: str, add_special: bool = True, parse_special: bool = False) -> list[int]:
        out: list[int] = []
        data = text.encode("utf-8")
        pos = 0
        n = len(data)
        while pos < n:
            node = self.trie.get(data[pos])
            if node is None:
                out.append(self.vocab.unk_id)
                pos += 1
                continue
            best_id, best_end = None, pos + 1
            k = pos + 1
            while node is not None:
                if -1 in node:
                    best_id, best_end = node[-1], k
                if k >= n:
                    break
                node = node.get(data[k])
                k += 1
            if best_id is None:
                out.append(self.vocab.unk_id)
                pos += 1
            else:
                out.append(best_id)
                pos = best_end
        return out

    def decode(self, ids, skip_special: bool = False) -> str:
        v = self.vocab
        buf = bytearray()
        for tid in ids:
            tid = int(tid)
            if skip_special and v.is_special(tid):
                continue
            buf += self.raw[tid]
        return buf.decode("utf-8", "replace")

    def piece(self, tid: int, special: bool = False) -> str:
        return self.raw[int(tid)].decode("utf-8", "replace")
