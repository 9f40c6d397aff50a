"""A llama GGUF with random Q4_K_M-typed blocks and a byte-level BPE vocab,
made from a seed, written with the port's GGUF writer: a file the CLI loads
and answers from like a downloaded checkpoint, with no download.

    python -m llm_tpu_torch.tools.synth_gguf out.gguf [--layers 32] [--seed 0]

The type mix is llama.cpp's Q4_K_M recipe (llm_tpu/tools/quantize.py
tensor_type_for): Q4_K everywhere, Q6_K for the lm_head and for attn_v and
ffn_down of the use_more_bits layers, f32 norms. A block's quant and scale
bytes are random; its f16 `d` and `dmin` are finite, sized so that weights
come out ~1e-2. The vocab (`bpe_vocab`) is byte-level BPE with
`tokenizer.ggml.pre = "llama-bpe"`: the 256 byte tokens, merges each of
which builds a new token from two earlier ones, and Llama 3's special
tokens (<|begin_of_text|> = 128000, ..., 256 of them at the top of the
vocab).

The geometry defaults to LLAMA3_8B (models/synthetic.py). `chip_smoke.py`
writes the 32-layer file on the card's machine; the tests write tiny ones.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..gguf.constants import GGMLType, Keys, type_traits
from ..gguf.writer import GGUFWriter
from ..models.synthetic import LLAMA3_8B
from ..tokenizers.bpe import bytes_to_unicode

N_LLAMA3_SPECIAL = 256
_NAMED_SPECIALS = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 4: "<|finetune_right_pad_id|>",
                   6: "<|start_header_id|>", 7: "<|end_header_id|>", 8: "<|eom_id|>",
                   9: "<|eot_id|>", 10: "<|python_tag|>"}


def llama3_specials(n: int = N_LLAMA3_SPECIAL) -> list[str]:
    """Llama 3.1's special tokens in id order (128000 + i): the named ones,
    the rest <|reserved_special_token_k|>."""
    out, k = [], 0
    for i in range(n):
        if i in _NAMED_SPECIALS:
            out.append(_NAMED_SPECIALS[i])
        else:
            out.append(f"<|reserved_special_token_{k}|>")
            k += 1
    return out


def bpe_vocab(n_vocab: int, seed: int = 0, n_special: int = N_LLAMA3_SPECIAL,
              pre: str = "llama-bpe") -> dict:
    """GGUF tokenizer metadata of a byte-level BPE vocab of n_vocab tokens:
    the 256 byte tokens, n_vocab - 256 - n_special merged tokens (each the
    concatenation of two earlier tokens, its merge "a b" ranked by id; the
    pairs are drawn from the seed, favouring the letters, digits and space
    of ASCII text and earlier merges so that text merges deep), then the
    specials (CONTROL)."""
    rng = np.random.default_rng(seed)
    byte_tok = bytes_to_unicode()
    tokens = [byte_tok[b] for b in range(256)]
    common = [byte_tok[b] for b in b" etaoinshrdlucmfwypvbgkjqxzETAOINSHRDLUCMFWYPVBGKJQXZ"
              b"0123456789.,'\n"]
    seen = set(tokens)
    merges = []
    n_merged = n_vocab - 256 - n_special
    if n_merged < 0:
        raise ValueError(f"n_vocab {n_vocab} holds no 256 byte tokens and {n_special} specials")
    while len(merges) < n_merged:
        n = len(tokens)
        pick = rng.random(2)
        a = common[int(pick[0] * len(common))] if pick[0] < 0.3 or n == 256 \
            else tokens[256 + int(rng.integers(0, n - 256))]
        b = common[int(pick[1] * len(common))] if pick[1] < 0.6 or n == 256 \
            else tokens[256 + int(rng.integers(0, n - 256))]
        t = a + b
        if t in seen or len(t) > 16:
            continue
        seen.add(t)
        tokens.append(t)
        merges.append(f"{a} {b}")
    specials = llama3_specials(n_special)
    bos = len(tokens)
    tokens += specials
    types = np.ones(len(tokens), np.int32)
    types[bos:] = 3  # CONTROL
    K = Keys.Tokenizer
    return {K.MODEL: "gpt2", K.PRE: pre, K.LIST: tokens, K.TOKEN_TYPE: types,
            K.MERGES: merges, K.BOS_ID: bos, K.EOS_ID: bos + 1, K.EOT_ID: bos + 9,
            K.ADD_BOS: True, K.ADD_EOS: False}


def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama.cpp's use_more_bits: the first and last eighth and every 3rd
    layer between (llm_tpu/tools/quantize.py:60)."""
    return (i_layer < n_layers / 8 or i_layer >= 7 * n_layers / 8
            or (i_layer - n_layers // 8) % 3 == 2)


def random_blocks(rng: np.random.Generator, ggml_type: GGMLType, n_rows: int,
                  n_per_row: int) -> np.ndarray:
    """Raw blocks of a [n_rows, n_per_row] tensor: random bytes, with each
    block's f16 d (and Q4_K's dmin) set finite."""
    tt = type_traits(ggml_type)
    nb = n_rows * n_per_row // tt.block_size
    raw = np.frombuffer(rng.bytes(nb * tt.type_size), np.uint8).reshape(nb, tt.type_size).copy()
    if ggml_type == GGMLType.Q4_K:  # d, dmin, 12 scale/min bytes, 128 nibble bytes
        dm = (rng.random((nb, 2), np.float32) * 1e-4 + 1e-4).astype(np.float16)
        raw[:, 0:4] = dm.view(np.uint8)
    elif ggml_type == GGMLType.Q6_K:  # ql, qh, 16 int8 scales, then d
        d = (rng.random(nb, np.float32) * 1e-5 + 1e-5).astype(np.float16)
        raw[:, tt.type_size - 2:] = d.view(np.uint8).reshape(nb, 2)
    else:
        raise ValueError(f"random_blocks makes Q4_K and Q6_K, not {ggml_type.name}")
    return raw


def write_llama_q4km(path: str, n_layers: int = LLAMA3_8B["n_layers"],
                     n_embd: int = LLAMA3_8B["n_embd"], n_heads: int = LLAMA3_8B["n_heads"],
                     n_kv_heads: int = LLAMA3_8B["n_kv_heads"], n_ff: int = LLAMA3_8B["n_ff"],
                     vocab: dict | None = None, n_vocab: int = LLAMA3_8B["vocab"],
                     seed: int = 0, context_length: int = 8192,
                     rope_theta: float = 500000.0) -> dict:
    """Write the file; returns what it wrote (bytes, tensors by type, the
    seconds to make the vocab and blocks and to write them)."""
    t0 = time.perf_counter()
    vocab = bpe_vocab(n_vocab, seed) if vocab is None else vocab
    n_vocab = len(vocab[Keys.Tokenizer.LIST])
    t_vocab = time.perf_counter() - t0
    arch = "llama"
    w = GGUFWriter(path, arch=arch)
    a = (lambda k: k.format(arch=arch))
    w.add_kv(Keys.General.NAME, f"synthetic llama Q4_K_M seed {seed}")
    w.add_kv(Keys.General.FILE_TYPE, np.uint32(15))  # MOSTLY_Q4_K_M
    w.add_kv(a(Keys.LLM.CONTEXT_LENGTH), np.uint32(context_length))
    w.add_kv(a(Keys.LLM.EMBEDDING_LENGTH), np.uint32(n_embd))
    w.add_kv(a(Keys.LLM.BLOCK_COUNT), np.uint32(n_layers))
    w.add_kv(a(Keys.LLM.FEED_FORWARD_LENGTH), np.uint32(n_ff))
    w.add_kv(a(Keys.LLM.VOCAB_SIZE), np.uint32(n_vocab))
    w.add_kv(a(Keys.Attention.HEAD_COUNT), np.uint32(n_heads))
    w.add_kv(a(Keys.Attention.HEAD_COUNT_KV), np.uint32(n_kv_heads))
    w.add_kv(a(Keys.Attention.LAYERNORM_RMS_EPS), np.float32(1e-5))
    w.add_kv(a(Keys.Rope.DIMENSION_COUNT), np.uint32(n_embd // n_heads))
    w.add_kv(a(Keys.Rope.FREQ_BASE), np.float32(rope_theta))
    for k, v in vocab.items():
        w.add_kv(k, v)
    rng = np.random.default_rng(seed)
    hd = n_embd // n_heads
    types: dict[str, int] = {}

    def mat(name, ggml_type, n_rows, n_per_row):
        w.add_tensor(name, None, ggml_type=ggml_type, shape=(n_per_row, n_rows),
                     raw=random_blocks(rng, ggml_type, n_rows, n_per_row))
        types[ggml_type.name] = types.get(ggml_type.name, 0) + 1

    def ones(name, n):
        w.add_tensor(name, np.ones(n, np.float32))
        types["F32"] = types.get("F32", 0) + 1

    Q4K, Q6K = GGMLType.Q4_K, GGMLType.Q6_K
    mat("token_embd.weight", Q4K, n_vocab, n_embd)
    for il in range(n_layers):
        more = use_more_bits(il, n_layers)
        p = f"blk.{il}."
        ones(p + "attn_norm.weight", n_embd)
        mat(p + "attn_q.weight", Q4K, n_heads * hd, n_embd)
        mat(p + "attn_k.weight", Q4K, n_kv_heads * hd, n_embd)
        mat(p + "attn_v.weight", Q6K if more else Q4K, n_kv_heads * hd, n_embd)
        mat(p + "attn_output.weight", Q4K, n_embd, n_heads * hd)
        ones(p + "ffn_norm.weight", n_embd)
        mat(p + "ffn_gate.weight", Q4K, n_ff, n_embd)
        mat(p + "ffn_up.weight", Q4K, n_ff, n_embd)
        mat(p + "ffn_down.weight", Q6K if more else Q4K, n_embd, n_ff)
    ones("output_norm.weight", n_embd)
    mat("output.weight", Q6K, n_vocab, n_embd)
    t_blocks = time.perf_counter() - t0 - t_vocab
    t1 = time.perf_counter()
    w.write()
    return dict(path=path, n_layers=n_layers, n_vocab=n_vocab, file_bytes=os.path.getsize(path),
                tensors=types, vocab_s=t_vocab, blocks_s=t_blocks,
                write_s=time.perf_counter() - t1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--layers", type=int, default=LLAMA3_8B["n_layers"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(write_llama_q4km(args.out, n_layers=args.layers, seed=args.seed))


if __name__ == "__main__":
    main()
