"""A llama (or bitnet, glm4 or command-r) GGUF with random blocks typed as a Q4_K_M, Q3_K_M,
Q2_K, IQ2_XXS, IQ1_M, TQ2_0 or TQ1_0 file is, and a byte-level BPE vocab,
made from a seed, written with the port's GGUF writer: a file the CLI
loads and answers from like a downloaded checkpoint, with no download.

    python -m llm_tpu_torch.tools.synth_gguf out.gguf [--layers 32] [--seed 0] \
        [--ftype {Q4_K_M,Q3_K_M,Q2_K,IQ2_XXS,IQ1_M,TQ2_0,TQ1_0}] \
        [--arch {llama,bitnet,glm4,command-r}]

The type mix is llama.cpp's recipe for the ftype
(models/synthetic.py::tensor_type_for, the port's copy of
llm_tpu/tools/quantize.py tensor_type_for), f32 norms: Q4_K_M (the
default) is Q4_K everywhere, Q6_K for the lm_head and for attn_v and
ffn_down of the use_more_bits layers; Q3_K_M is Q3_K with attn_v Q5_K in
layers 0-1 and Q4_K after, ffn_down Q4_K in layers 0-1, a Q6_K lm_head;
Q2_K is Q2_K with attn_v Q4_K (LLAMA3_8B's 4 query heads a KV head),
ffn_down Q3_K in the use_more_bits layers, a Q6_K lm_head; IQ2_XXS and
IQ1_M are their base type with attn_v Q4_K, ffn_down IQ3_XXS in layers
0-1, a Q5_K lm_head and a Q2_K embedding table; TQ2_0 and TQ1_0 their
base type everywhere but a Q6_K lm_head; a matrix whose K the type's
block does not divide is Q8_0 (GLM-4's ffn_down, K = 13696). A block's quant and scale bytes
are random (TQ2_0's 2-bit codes drawn from 0..2, the trits); its f16 `d`
(and `dmin`) are finite, sized (_D_FIELDS) so that the weights' rms is
~0.02 for the types with signed scales and zero-mean weights (Q6_K, Q3_K,
the IQ and TQ types) and ~0.04-0.05 for those with mins (Q4_K, Q5_K,
Q2_K), whose random mins leave each row a mean of 0.01-0.03. IQ1_M keeps
its d in the top nibbles of its four scale words. The vocab (`bpe_vocab`) is byte-level BPE
with `tokenizer.ggml.pre = "llama-bpe"`: the 256 byte tokens, merges each
of which builds a new token from two earlier ones, and Llama 3's special
tokens (<|begin_of_text|> = 128000, ..., 256 of them at the top of the
vocab).

The geometry defaults to LLAMA3_8B (models/synthetic.py), or to
BITNET_B158_2B with `--arch bitnet` (a squared relu, the sub-norms
attn_sub_norm and ffn_sub_norm as f32 ones), or to GLM4_9B with `--arch
glm4` (gate+up packed in ffn_up [2 n_ff, n_embd], random f32 biases on q,
k and v, the post-norms attn_post_norm and ffn_post_norm as f32 ones,
rope.dimension_count half the head, rope base 10000, rms eps 1.5625e-7),
or to COMMAND_R_35B with `--arch command-r` (LayerNorm weights as f32
ones and no biases, an attn_norm and no ffn_norm a layer, a tied
embedding table in the lm_head's type and no output.weight,
command-r.logit_scale 0.0625, rope base 10000, and the LN eps 1e-5 under
llama.cpp's key layer_norm_epsilon, which the reference does not read: its
1e-5 default is the same value).
`chip_smoke.py` writes the 2-layer Q4_K_M file and 2-layer Q3_K_M, Q2_K,
IQ1_M, bitnet TQ2_0, glm4 and command-r Q4_K_M ones on the card's machine;
the tests write tiny ones.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..gguf.constants import FileType, GGMLType, Keys, type_traits
from ..gguf.writer import GGUFWriter
from ..models.synthetic import (BITNET_B158_2B, COMMAND_R_35B, GLM4_9B, LLAMA3_8B, RECIPES,
                                tensor_type_for)
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


# each type's f16 scale fields (byte offsets) and the low end m of the
# range [m, 2m) a field's value is drawn from: the weights' rms is ~0.02
# for Q6_K and Q3_K (signed sub-scales, zero mean), ~0.04-0.05 for the
# types with mins (a Q3_K at Q4_K's rms, m = 7e-4, made a two-layer
# LLAMA3_8B-wide Q3_K_M file 3-5x as sensitive to bf16 rounding as a
# Q4_K_M one: PERF.md, PR 16)
_D_FIELDS = {
    GGMLType.Q4_K: ((0, 4), 1e-4),     # d, dmin; 6-bit sub-scales, 4-bit codes
    GGMLType.Q6_K: ((208, 210), 1e-5),  # d; int8 sub-scales, 6-bit codes
    GGMLType.Q5_K: ((0, 4), 5e-5),     # d, dmin; 6-bit sub-scales, 5-bit codes
    GGMLType.Q3_K: ((108, 110), 3e-4),  # d; signed 6-bit sub-scales, codes -4..3
    GGMLType.Q2_K: ((80, 84), 2e-3),   # d, dmin; 4-bit sub-scales, codes 0..3
    GGMLType.IQ2_XXS: ((0, 2), 2.5e-4),  # d; 4-bit sub-scales, grid values 8..43
    GGMLType.IQ3_XXS: ((0, 2), 9e-5),    # d; 4-bit sub-scales, grid values 4..62
    GGMLType.IQ1_M: (None, 1.8e-3),      # d in the scale words' top nibbles
    GGMLType.TQ1_0: ((52, 54), 1.6e-2),  # d; trits
    GGMLType.TQ2_0: ((64, 66), 1.6e-2),  # d; trits
    GGMLType.Q8_0: ((0, 2), 2e-4),       # d; int8 codes (a fallback type)
}
# the archs write_llama writes, and each one's geometry
GEOMETRY = {"llama": LLAMA3_8B, "bitnet": BITNET_B158_2B, "glm4": GLM4_9B,
            "command-r": COMMAND_R_35B}
# command-r's logit scale (c4ai-command-r-v01's, CohereConfig's default)
COMMAND_R_LOGIT_SCALE = 0.0625


def _iq1m_set_d(raw: np.ndarray, d: np.ndarray) -> None:
    """IQ1_M's f16 d: nibble i of its bits in the top nibble of scale word
    i (bytes 48..55), as ggml's iq1m_scale_t unpacks it."""
    bits = d.view(np.uint16).astype(np.uint16).reshape(-1)
    sc = np.ascontiguousarray(raw[:, 48:56]).view("<u2")
    for i in range(4):
        sc[:, i] = (sc[:, i] & 0x0FFF) | (((bits >> (4 * i)) & 0xF) << 12)
    raw[:, 48:56] = sc.view(np.uint8)


def _tq2_trits(rng: np.random.Generator, raw: np.ndarray) -> None:
    """TQ2_0's 2-bit codes (bytes 0..63) drawn from 0..2, the trits + 1
    (code 3 is no trit)."""
    c = rng.integers(0, 3, size=(raw.shape[0], 64, 4), dtype=np.uint8)
    raw[:, 0:64] = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


def random_blocks(rng: np.random.Generator, ggml_type: GGMLType, n_rows: int,
                  n_per_row: int) -> np.ndarray:
    """Raw blocks of a [n_rows, n_per_row] tensor: random bytes, with each
    block's f16 d (and dmin) set finite (_D_FIELDS) and TQ2_0's codes
    trits."""
    tt = type_traits(ggml_type)
    nb = n_rows * n_per_row // tt.block_size
    raw = np.frombuffer(rng.bytes(nb * tt.type_size), np.uint8).reshape(nb, tt.type_size).copy()
    if ggml_type not in _D_FIELDS:
        raise ValueError(f"random_blocks makes {', '.join(t.name for t in _D_FIELDS)}, "
                         f"not {ggml_type.name}")
    field, mag = _D_FIELDS[ggml_type]
    lo, hi = field or (0, 2)
    d = (rng.random((nb, (hi - lo) // 2), np.float32) * mag + mag).astype(np.float16)
    if field is None:
        _iq1m_set_d(raw, d)
    else:
        raw[:, lo:hi] = d.view(np.uint8).reshape(nb, hi - lo)
    if ggml_type == GGMLType.TQ2_0:
        _tq2_trits(rng, raw)
    return raw


def write_llama(path: str, n_layers: int = LLAMA3_8B["n_layers"],
                n_embd: int = LLAMA3_8B["n_embd"], n_heads: int = LLAMA3_8B["n_heads"],
                n_kv_heads: int = LLAMA3_8B["n_kv_heads"], n_ff: int = LLAMA3_8B["n_ff"],
                vocab: dict | None = None, n_vocab: int = LLAMA3_8B["vocab"],
                seed: int = 0, context_length: int = 8192,
                rope_theta: float | None = None, ftype: str = "Q4_K_M",
                arch: str = "llama") -> dict:
    """Write the file; returns what it wrote (bytes, tensors by type, the
    seconds to make the vocab and blocks and to write them). arch "bitnet"
    adds each layer's sub-norms (attn_sub_norm, ffn_sub_norm); arch "glm4"
    packs gate+up in ffn_up, adds QKV biases and post-norms, ropes half of
    each head and takes GLM-4's rms eps; arch "command-r" writes one
    LayerNorm weight a layer (attn_norm), a tied table and its logit scale.
    rope_theta None: 10000 for glm4 and command-r, 500000 (Llama 3's)
    otherwise."""
    t0 = time.perf_counter()
    vocab = bpe_vocab(n_vocab, seed) if vocab is None else vocab
    n_vocab = len(vocab[Keys.Tokenizer.LIST])
    t_vocab = time.perf_counter() - t0
    if arch not in GEOMETRY:
        raise ValueError(f"arch {arch!r}: one of {', '.join(GEOMETRY)}")
    glm4, cmdr = arch == "glm4", arch == "command-r"
    if rope_theta is None:
        rope_theta = 10000.0 if glm4 or cmdr else 500000.0
    w = GGUFWriter(path, arch=arch)
    a = (lambda k: k.format(arch=arch))
    if ftype not in RECIPES:
        raise ValueError(f"ftype {ftype!r}: one of {', '.join(RECIPES)}")
    w.add_kv(Keys.General.NAME, f"synthetic {arch} {ftype} seed {seed}")
    w.add_kv(Keys.General.FILE_TYPE, np.uint32(FileType[f"MOSTLY_{ftype}"]))
    w.add_kv(a(Keys.LLM.CONTEXT_LENGTH), np.uint32(context_length))
    w.add_kv(a(Keys.LLM.EMBEDDING_LENGTH), np.uint32(n_embd))
    w.add_kv(a(Keys.LLM.BLOCK_COUNT), np.uint32(n_layers))
    w.add_kv(a(Keys.LLM.FEED_FORWARD_LENGTH), np.uint32(n_ff))
    w.add_kv(a(Keys.LLM.VOCAB_SIZE), np.uint32(n_vocab))
    w.add_kv(a(Keys.Attention.HEAD_COUNT), np.uint32(n_heads))
    w.add_kv(a(Keys.Attention.HEAD_COUNT_KV), np.uint32(n_kv_heads))
    if cmdr:  # llama.cpp's key for a LayerNorm's eps, and the logit scale
        w.add_kv(a(Keys.Attention.LAYERNORM_EPS), np.float32(1e-5))
        w.add_kv(a("{arch}.logit_scale"), np.float32(COMMAND_R_LOGIT_SCALE))
    else:
        w.add_kv(a(Keys.Attention.LAYERNORM_RMS_EPS), np.float32(1.5625e-7 if glm4 else 1e-5))
    w.add_kv(a(Keys.Rope.DIMENSION_COUNT), np.uint32(n_embd // n_heads // (2 if glm4 else 1)))
    w.add_kv(a(Keys.Rope.FREQ_BASE), np.float32(rope_theta))
    for k, v in vocab.items():
        w.add_kv(k, v)
    rng = np.random.default_rng(seed)
    hd = n_embd // n_heads
    types: dict[str, int] = {}

    def mat(name, n_rows, n_per_row, il=0):
        ggml_type = tensor_type_for(name, n_per_row, ftype, il, n_layers,
                                    n_heads // n_kv_heads, has_output=not cmdr)
        w.add_tensor(name, None, ggml_type=ggml_type, shape=(n_per_row, n_rows),
                     raw=random_blocks(rng, ggml_type, n_rows, n_per_row))
        types[ggml_type.name] = types.get(ggml_type.name, 0) + 1

    def ones(name, n):
        w.add_tensor(name, np.ones(n, np.float32))
        types["F32"] = types.get("F32", 0) + 1

    def bias(name, n):
        w.add_tensor(name, (rng.standard_normal(n) * 0.1).astype(np.float32))
        types["F32"] = types.get("F32", 0) + 1

    mat("token_embd.weight", n_vocab, n_embd)
    for il in range(n_layers):
        p = f"blk.{il}."
        ones(p + "attn_norm.weight", n_embd)
        mat(p + "attn_q.weight", n_heads * hd, n_embd, il)
        mat(p + "attn_k.weight", n_kv_heads * hd, n_embd, il)
        mat(p + "attn_v.weight", n_kv_heads * hd, n_embd, il)
        if glm4:
            for key, n in (("attn_q", n_heads * hd), ("attn_k", n_kv_heads * hd),
                           ("attn_v", n_kv_heads * hd)):
                bias(p + key + ".bias", n)
        if arch == "bitnet":
            ones(p + "attn_sub_norm.weight", n_heads * hd)
        mat(p + "attn_output.weight", n_embd, n_heads * hd, il)
        if glm4:
            ones(p + "attn_post_norm.weight", n_embd)
        if not cmdr:  # command-r's FFN reads the attention's normed input
            ones(p + "ffn_norm.weight", n_embd)
        if glm4:  # [gate; up] in one tensor
            mat(p + "ffn_up.weight", 2 * n_ff, n_embd, il)
        else:
            mat(p + "ffn_gate.weight", n_ff, n_embd, il)
            mat(p + "ffn_up.weight", n_ff, n_embd, il)
        if arch == "bitnet":
            ones(p + "ffn_sub_norm.weight", n_ff)
        mat(p + "ffn_down.weight", n_embd, n_ff, il)
        if glm4:
            ones(p + "ffn_post_norm.weight", n_embd)
    ones("output_norm.weight", n_embd)
    if not cmdr:  # command-r's lm_head is the embedding table
        mat("output.weight", n_vocab, n_embd)
    t_blocks = time.perf_counter() - t0 - t_vocab
    t1 = time.perf_counter()
    w.write()
    return dict(path=path, n_layers=n_layers, n_vocab=n_vocab, file_bytes=os.path.getsize(path),
                tensors=types, vocab_s=t_vocab, blocks_s=t_blocks,
                write_s=time.perf_counter() - t1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers (default: the geometry's: 32, BitNet's 30, GLM-4's and "
                         "Command-R's 40)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ftype", choices=list(RECIPES), default="Q4_K_M")
    ap.add_argument("--arch", choices=tuple(GEOMETRY), default="llama",
                    help="bitnet: BITNET_B158_2B's geometry and sub-norms; glm4: GLM4_9B's "
                         "geometry, biases, post-norms and packed gate+up; command-r: "
                         "COMMAND_R_35B's geometry, LayerNorm weights, a tied table")
    args = ap.parse_args(argv)
    geo = GEOMETRY[args.arch]
    n_layers = geo["n_layers"] if args.layers is None else args.layers
    print(write_llama(args.out, n_layers=n_layers, n_embd=geo["n_embd"],
                      n_heads=geo["n_heads"], n_kv_heads=geo["n_kv_heads"], n_ff=geo["n_ff"],
                      n_vocab=geo["vocab"], seed=args.seed, ftype=args.ftype, arch=args.arch))


if __name__ == "__main__":
    main()
