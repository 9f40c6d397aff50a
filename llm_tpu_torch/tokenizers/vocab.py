"""Vocabulary loaded from GGUF tokenizer metadata.

The port's own copy of llm_tpu/tokenizers/vocab.py.

Parity target: llama_vocab (llama.cpp's src/llama-vocab.cpp/h):
token pieces, scores, types, special-token ids and flags, byte-fallback
tokens, and special-token aware text fragmentation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..gguf.constants import Keys


# token attribute types (llama.h llama_token_type)
class TokenType:
    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


@dataclass
class Vocab:
    model: str  # "llama" (spm) | "gpt2" (bpe) | "bert" (wpm) | ...
    pre: str
    tokens: list[str]
    scores: np.ndarray
    types: np.ndarray
    merges: list[str] = field(default_factory=list)
    bos_id: int = -1
    eos_id: int = -1
    eot_id: int = -1
    unk_id: int = -1
    sep_id: int = -1
    pad_id: int = -1
    fim_pre_id: int = -1
    fim_suf_id: int = -1
    fim_mid_id: int = -1
    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = True
    remove_extra_whitespaces: bool = False
    precompiled_charsmap: bytes = b""
    chat_template: str = ""

    token_to_id: dict = field(default_factory=dict)
    _byte_ids: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        for i, t in enumerate(self.tokens):
            if self.types[i] == TokenType.BYTE and len(t) == 6 and t.startswith("<0x"):
                self._byte_ids[int(t[3:5], 16)] = i

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def byte_id(self, b: int) -> int:
        return self._byte_ids.get(b, self.unk_id)

    def is_special(self, tid: int) -> bool:
        return self.types[tid] in (TokenType.CONTROL, TokenType.USER_DEFINED)

    def is_eog(self, tid: int) -> bool:
        return tid in (self.eos_id, self.eot_id) and tid != -1

    def special_tokens(self) -> list[tuple[str, int]]:
        """(text, id) of control/user-defined tokens, longest first."""
        out = [
            (self.tokens[i], i)
            for i in range(len(self.tokens))
            if self.is_special(i) and self.tokens[i]
        ]
        out.sort(key=lambda p: -len(p[0]))
        return out

    def split_on_specials(self, text: str, parse_special: bool):
        """Yield fragments: (str, None) for raw text, (piece, id) for special
        tokens (partitioning step of llama_vocab::tokenize). USER_DEFINED
        tokens are always matched; CONTROL/UNKNOWN only when parse_special
        (reference: tokenizer_st_partition, llama-vocab.cpp:2237-2244)."""
        specials = [
            (t, i)
            for t, i in self.special_tokens()
            if parse_special or self.types[i] == TokenType.USER_DEFINED
        ]
        if not specials:
            yield (text, None)
            return
        frags = [(text, None)]
        for piece, tid in specials:
            nxt = []
            for frag, fid in frags:
                if fid is not None:
                    nxt.append((frag, fid))
                    continue
                parts = frag.split(piece)
                for j, part in enumerate(parts):
                    if part:
                        nxt.append((part, None))
                    if j != len(parts) - 1:
                        nxt.append((piece, tid))
            frags = nxt
        yield from frags


def _get(reader, key, default=None):
    v = reader.get(key, default)
    if isinstance(v, np.generic):
        v = v.item()
    return v


def vocab_from_gguf(reader) -> Vocab:
    K = Keys.Tokenizer
    tokens = list(_get(reader, K.LIST, []))
    n = len(tokens)
    scores = np.asarray(_get(reader, K.SCORES, np.zeros(n, np.float32)), np.float32)
    types = np.asarray(_get(reader, K.TOKEN_TYPE, np.full(n, TokenType.NORMAL)), np.int32)
    model = str(_get(reader, K.MODEL, "llama"))
    if len(scores) != n:
        scores = np.zeros(n, np.float32)
    if len(types) != n:
        types = np.full(n, TokenType.NORMAL, np.int32)

    default_add_bos = model == "llama"
    v = Vocab(
        model=model,
        pre=str(_get(reader, K.PRE, "default")),
        tokens=tokens,
        scores=scores,
        types=types,
        merges=list(_get(reader, K.MERGES, [])),
        bos_id=int(_get(reader, K.BOS_ID, 1 if model == "llama" else -1)),
        eos_id=int(_get(reader, K.EOS_ID, 2 if model == "llama" else -1)),
        eot_id=int(_get(reader, K.EOT_ID, -1)),
        unk_id=int(_get(reader, K.UNK_ID, 0 if model == "llama" else -1)),
        sep_id=int(_get(reader, K.SEP_ID, -1)),
        pad_id=int(_get(reader, K.PAD_ID, -1)),
        fim_pre_id=int(_get(reader, K.FIM_PRE_ID, _get(reader, K.PREFIX_ID, -1))),
        fim_suf_id=int(_get(reader, K.FIM_SUF_ID, _get(reader, K.SUFFIX_ID, -1))),
        fim_mid_id=int(_get(reader, K.FIM_MID_ID, _get(reader, K.MIDDLE_ID, -1))),
        add_bos=bool(_get(reader, K.ADD_BOS, default_add_bos)),
        add_eos=bool(_get(reader, K.ADD_EOS, False)),
        add_space_prefix=bool(_get(reader, K.ADD_SPACE_PREFIX, model == "llama")),
        remove_extra_whitespaces=bool(_get(reader, K.REMOVE_EXTRA_WS, False)),
        precompiled_charsmap=_charsmap_bytes(_get(reader, K.PRECOMPILED_CHARSMAP, b"")),
        chat_template=str(_get(reader, K.CHAT_TEMPLATE, "")),
    )
    return v


def _charsmap_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, np.ndarray):
        return v.astype(np.uint8).tobytes()
    if isinstance(v, (list, tuple)):
        return bytes(int(x) & 0xFF for x in v)
    return bytes(v) if v else b""
