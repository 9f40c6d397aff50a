"""Tokenizers: SPM / byte-level BPE / WPM / UGM / RWKV, constructed from
GGUF metadata (tokenizer.ggml.model dispatch, parity with llama_vocab's
tokenizer factory in llama.cpp's src/llama-vocab.cpp).

The port's own copy of llm_tpu/tokenizers: numpy and plain Python, and no
`regex` package (bpe.py compiles its pre-tokenizer patterns with the
standard `re`, the Unicode classes built by uclass.py)."""

from .bpe import BpeTokenizer
from .rwkv import RwkvTokenizer
from .spm import SpmTokenizer
from .ugm import UgmTokenizer
from .vocab import TokenType, Vocab, vocab_from_gguf
from .wpm import WpmTokenizer


def tokenizer_from_vocab(vocab: Vocab):
    if vocab.model in ("llama", "spm"):
        return SpmTokenizer(vocab)
    if vocab.model in ("gpt2", "bpe"):
        return BpeTokenizer(vocab)
    if vocab.model == "bert":
        return WpmTokenizer(vocab)
    if vocab.model in ("t5", "ugm"):
        return UgmTokenizer(vocab)
    if vocab.model == "rwkv":
        return RwkvTokenizer(vocab)
    raise ValueError(f"unsupported tokenizer model {vocab.model!r}")


def tokenizer_from_gguf(reader):
    return tokenizer_from_vocab(vocab_from_gguf(reader))


__all__ = [
    "BpeTokenizer",
    "RwkvTokenizer",
    "SpmTokenizer",
    "UgmTokenizer",
    "WpmTokenizer",
    "TokenType",
    "Vocab",
    "tokenizer_from_gguf",
    "tokenizer_from_vocab",
    "vocab_from_gguf",
]
