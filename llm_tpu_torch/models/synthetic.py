"""Random-weight models at any scale, with quantized weights made directly
as packed planes. Counterpart of llm_tpu/models/synthetic.py.

* On the host from a numpy Generator (`synthetic_qtensor`,
  `make_synthetic_model(on_device=False)`): the same draws in the same
  order as the JAX package, so a seed gives identical planes in both.
* On the device from a torch.Generator (`device_synthetic_qtensor`,
  `make_synthetic_model(on_device=True)`): LLAMA3_8B's ~4.7 GB of Q4_K
  planes in seconds, with no host-to-device upload. These draws differ
  from the JAX package's (another generator), and are for benchmarks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.constants import GGMLType
from ..ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORM, RopeParams
from ..quant.codecs import KVALUES_IQ4NL
from ..quant.qtensor import QTensor, pack_p4, pack_p4_kmajor
from .config import BAICHUAN_13B_LAYERS, ModelConfig, alibi_profile
from .loader import fuse_projections

# Llama-3-8B geometry, the flagship configuration
LLAMA3_8B = dict(n_embd=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                 n_ff=14336, vocab=128256, head_dim=128)
# Gemma-2-9B (google/gemma-2-9b config.json): 16 query heads over 8 KV
# heads of 256 dims, a 4096-cell window on every other layer, softcaps 50
# (attention) and 30 (logits), tied embeddings; gemma2_config adds the rest
GEMMA2_9B = dict(n_embd=3584, n_layers=42, n_heads=16, n_kv_heads=8,
                 n_ff=14336, vocab=256000, head_dim=256)
# Gemma-2-27B (google/gemma-2-27b config.json): hidden 4608, 46 layers, 32
# query heads over 16 KV heads of 128 dims, ff 36864, query_pre_attn_scalar
# 144 = 4608 / 32 (gemma2_config's 46-layer profile), softcaps 50 and 30, a
# 4096-cell window on every other layer, tied embeddings
GEMMA2_27B = dict(n_embd=4608, n_layers=46, n_heads=32, n_kv_heads=16,
                  n_ff=36864, vocab=256000, head_dim=128)
# Baichuan-13B (baichuan-inc/Baichuan-13B-Base config.json): 40 heads over
# 40 KV heads of 128 dims, ff 13696 (no multiple of 256: a Q4_K_M-style
# recipe writes its ffn_down as Q8_0), untied lm_head; 40 layers select
# the 13B profile, rope NONE and ALiBi (baichuan_config)
BAICHUAN_13B = dict(n_embd=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                    n_ff=13696, vocab=64000, head_dim=128)
# GLM-4-9B-0414 (THUDM/GLM-4-9B-0414, the defaults of transformers'
# Glm4Config): 32 query heads over 2 KV heads of 128 (G = 16), rope NORM on
# the first 64 of the 128 dims, ff 13696 (no multiple of 256: a Q4_K_M
# recipe writes its ffn_down as Q8_0), QKV biases, post-norms after
# attention and after the FFN, gate+up packed in ffn_up, untied lm_head;
# glm4_config adds the rest
GLM4_9B = dict(n_embd=4096, n_layers=40, n_heads=32, n_kv_heads=2,
               n_ff=13696, vocab=151552, head_dim=128)
# Refact-1.6B (smallcloudai/Refact-1_6B-fim config.json): 32 query heads
# over one KV head of 64 dims (G = 32), ff 5632, ALiBi, no rope
REFACT_1_6B = dict(n_embd=2048, n_layers=32, n_heads=32, n_kv_heads=1,
                   n_ff=5632, vocab=49216, head_dim=64)
# Gemma-7B (google/gemma-7b config.json): 16 heads over 16 KV heads of 256
# dims (q 4096 wide beside a hidden of 3072), ff 24576, gelu, tied
# embeddings; gemma_config adds the rest
GEMMA_7B = dict(n_embd=3072, n_layers=28, n_heads=16, n_kv_heads=16,
                n_ff=24576, vocab=256000, head_dim=256)
# Qwen2.5-7B (Qwen/Qwen2.5-7B config.json): 28 heads over 4 KV heads of
# 128, ff 18944, QKV biases, untied; qwen2_config adds the rest
QWEN2_5_7B = dict(n_embd=3584, n_layers=28, n_heads=28, n_kv_heads=4,
                  n_ff=18944, vocab=152064, head_dim=128)
# Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B config.json): 32 heads over 4 KV heads
# of 128 (q 4096 wide beside a hidden of 2048), qk-norm, every layer a
# mixture of 128 experts of 768, 8 a token, their weights normalized; ff
# 6144 (the dense width, which no layer uses), untied; qwen3moe_config adds
# the rest
QWEN3_30B_A3B = dict(n_embd=2048, n_layers=48, n_heads=32, n_kv_heads=4,
                     n_ff=6144, vocab=151936, head_dim=128, n_expert=128,
                     n_expert_used=8, n_ff_expert=768)
# BitNet b1.58 2B4T (transformers.BitNetConfig's defaults, which name
# microsoft/bitnet-b1.58-2B-4T): 20 heads over 5 KV heads of 128, ff 6912,
# a gated squared relu and RMS sub-norms before o_proj and ffn_down, rope
# theta 500000, untied; every K a multiple of 256, so TQ1_0 / TQ2_0 planes
# pack as nibbles everywhere; bitnet_config adds the rest
BITNET_B158_2B = dict(n_embd=2560, n_layers=30, n_heads=20, n_kv_heads=5,
                      n_ff=6912, vocab=128256, head_dim=128)
# Command-R v01 (transformers.CohereConfig's defaults, which name
# CohereForAI/c4ai-command-r-v01): 64 query heads over 64 KV heads of 128
# (G = 1), ff 22528, SwiGLU, LayerNorm without a bias (eps 1e-5), one norm
# shared by attention and the FFN in a parallel block, logits times 0.0625,
# rope NORM, tied embeddings; command_r_config adds the rest
COMMAND_R_35B = dict(n_embd=8192, n_layers=40, n_heads=64, n_kv_heads=64,
                     n_ff=22528, vocab=256000, head_dim=128)


def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """The Q4_K_M recipe's Q6_K layers (llama-quant.cpp use_more_bits; own
    copy of llm_tpu/tools/quantize.py::_use_more_bits): the first and last
    eighth of the layers and every third one between."""
    return (i_layer < n_layers / 8 or i_layer >= 7 * n_layers / 8
            or (i_layer - n_layers // 8) % 3 == 2)


# the group size of each type's planes (quant/qtensor.py), 32 where absent
_GS = {GGMLType.Q6_K: 16, GGMLType.Q2_K: 16, GGMLType.Q3_K: 16, GGMLType.IQ2_XS: 16,
       GGMLType.IQ2_S: 16, GGMLType.IQ1_M: 8, GGMLType.TQ1_0: 256, GGMLType.TQ2_0: 256}


def _gs(qtype) -> int:
    return _GS.get(qtype, 32)


# the block (weights a block along K) of the types the recipes write
_BLOCK = {GGMLType.Q2_K: 256, GGMLType.Q3_K: 256, GGMLType.Q4_K: 256, GGMLType.Q5_K: 256,
          GGMLType.Q6_K: 256, GGMLType.Q8_0: 32, GGMLType.IQ2_XXS: 256, GGMLType.IQ3_XXS: 256,
          GGMLType.IQ1_M: 256, GGMLType.TQ1_0: 256, GGMLType.TQ2_0: 256}


def fallback_type(qtype: GGMLType, k: int) -> GGMLType:
    """The type a matrix of K inputs takes: qtype where its block divides
    K, else Q8_0 (the quantizer's block-size fallback; own copy of
    llm_tpu/tools/quantize.py:141-147, whose F16 step no K of a
    supported model reaches)."""
    return qtype if k % _BLOCK.get(qtype, 32) == 0 else GGMLType.Q8_0


# the recipes a synthetic model or file may follow, and their base type
RECIPES = {"Q4_K_M": GGMLType.Q4_K, "Q3_K_M": GGMLType.Q3_K, "Q2_K": GGMLType.Q2_K,
           "IQ2_XXS": GGMLType.IQ2_XXS, "IQ1_M": GGMLType.IQ1_M, "TQ2_0": GGMLType.TQ2_0,
           "TQ1_0": GGMLType.TQ1_0}
# the sub-4-bit IQ recipes (the reference's _IQ_LOW, of those above)
_IQ_LOW = ("IQ2_XXS", "IQ1_M")


def tensor_type_for(name: str, k: int, recipe: str, i_layer: int, n_layers: int,
                    n_gqa: int = 1, n_expert: int = 0, has_output: bool = True) -> GGMLType:
    """The type llama.cpp's recipe gives tensor `name` (a GGUF name, or its
    suffix: "attn_v.weight", "ffn_down_exps.weight", ...) of K inputs in
    layer i_layer: the port's own copy of the Q4_K_M, Q3_K_M, Q2_K,
    IQ2_XXS, IQ1_M, TQ2_0 and TQ1_0 branches of
    llm_tpu/tools/quantize.py::tensor_type_for, n_gqa the query heads a KV
    head, has_output False for a tied embedding table (then
    "token_embd.weight" is the output). The IQ recipes give the lm_head
    Q5_K, an untied table Q2_K, attn_v Q4_K at 4 or more query heads a KV
    head (else IQ3_S) and ffn_down IQ3_XXS in layers 0-1; the TQ ones give
    the base type everywhere but the lm_head's Q6_K."""
    base = RECIPES[recipe]
    t = base
    more = use_more_bits(i_layer, n_layers)
    iq = recipe in _IQ_LOW
    if name == "output.weight" or (not has_output and name == "token_embd.weight"):
        t = GGMLType.Q5_K if iq else GGMLType.Q6_K
    elif name == "token_embd.weight" and iq:
        t = GGMLType.Q2_K
    elif "attn_v.weight" in name:
        if iq:
            t = GGMLType.Q4_K if n_gqa >= 4 else GGMLType.IQ3_S
        elif recipe == "Q2_K":
            t = GGMLType.Q4_K if n_gqa >= 4 else GGMLType.Q3_K
        elif recipe == "Q3_K_M":
            t = GGMLType.Q5_K if i_layer < 2 else GGMLType.Q4_K
        elif recipe == "Q4_K_M" and more:
            t = GGMLType.Q6_K
        if n_expert == 8:
            t = GGMLType.Q8_0
    elif "ffn_down" in name:
        if iq:
            t = GGMLType.IQ3_XXS if i_layer < 2 else base
        elif recipe == "Q2_K":
            t = GGMLType.Q3_K if more else base
        elif recipe == "Q3_K_M":
            t = GGMLType.Q4_K if i_layer < 2 else base
        elif recipe == "Q4_K_M" and more:
            t = GGMLType.Q6_K
    elif "attn_qkv.weight" in name:
        t = GGMLType.Q5_K if recipe == "Q4_K_M" else (
            GGMLType.Q4_K if recipe == "Q3_K_M" else base)
    return fallback_type(t, k)


def synthetic_qtensor(rng: np.random.Generator, n: int, k: int,
                      qtype: GGMLType = GGMLType.Q4_K,
                      pack_tk: int = 256, kmajor: bool = True,
                      device="cpu") -> QTensor:
    """Random quantized planes shaped like a loaded weight (the JAX
    package's draws, whose group size is 16 for Q6_K, Q2_K and Q3_K and 32
    for every other type)."""
    gs = 16 if qtype in (GGMLType.Q6_K, GGMLType.Q2_K, GGMLType.Q3_K) else 32
    scale_mag = 0.02 / np.sqrt(k) * 8

    def orient(a):  # scales/mins: [K//gs, N] kmajor else [N, K//gs]
        return a if kmajor else np.ascontiguousarray(a.T)

    def put(a):  # float planes are f32, as jnp.asarray makes them in the JAX package
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64 else a).to(device)

    scales = orient(rng.random((k // gs, n), dtype=np.float32) * scale_mag)
    if qtype in (GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q4_1):
        q = rng.integers(0, 16, size=(k, n), dtype=np.int16).astype(np.int8)
        zp, mins = 8, None
        if qtype in (GGMLType.Q4_K, GGMLType.Q4_1):
            mins = orient(rng.random((k // gs, n), dtype=np.float32) * scale_mag * 8)
            zp = 0
        qsub = (q - zp).astype(np.int8)
        if k % pack_tk == 0:
            packed = (pack_p4_kmajor(qsub, zp, pack_tk) if kmajor
                      else pack_p4(np.ascontiguousarray(qsub.T), zp, pack_tk))
            return QTensor(put(packed), put(scales), put(mins), gs, qtype, "p4",
                           zp, pack_tk, kmajor)
        qi = qsub if kmajor else np.ascontiguousarray(qsub.T)
        return QTensor(put(qi), put(scales), put(mins), gs, qtype, "i8", 0,
                       pack_tk, kmajor)
    q = rng.integers(-32, 32, size=(k, n), dtype=np.int16).astype(np.int8)
    q = q if kmajor else np.ascontiguousarray(q.T)
    mins = None
    if qtype == GGMLType.Q5_K:
        mins = orient(rng.random((k // gs, n), dtype=np.float32) * scale_mag * 8)
    return QTensor(put(q), put(scales), put(mins), gs, qtype, "i8", 0, pack_tk, kmajor)


# the magnitude of the IQ grid types' plane values (their grids' range,
# quant/iq_codecs.py: 8 * grid +- 1 for IQ1_*)
IQ_RANGE = {GGMLType.IQ1_S: 9, GGMLType.IQ1_M: 9, GGMLType.IQ2_XXS: 43, GGMLType.IQ2_XS: 43,
            GGMLType.IQ2_S: 43, GGMLType.IQ3_XXS: 62, GGMLType.IQ3_S: 62}


def device_synthetic_qtensor(gen: torch.Generator, n: int, k: int,
                             qtype: GGMLType = GGMLType.Q4_K,
                             scales_dtype=torch.bfloat16, kmajor: bool = True,
                             pack_tk: int = 256) -> QTensor:
    """Random planes made on gen's device, in the layout that loading a
    file of qtype gives: Q4_K as random packed nibbles with scales and
    mins; Q2_K (values 0..3, with mins) and Q3_K (-4..3, zero point 4) as
    nibble planes at group size 16; Q5_K, Q5_1 (0..31, with mins), Q5_0
    (-16..15), IQ4_NL and IQ4_XS (the IQ4 codebook's values) as int8
    planes; TQ1_0 and TQ2_0 as nibble planes of trits 0..2 at zero point 1
    and group size 256; the IQ grid types as int8 planes inside their
    grids' range (IQ1_* +-9, IQ2_* +-43, IQ3_* +-62; IQ1_M at group size 8,
    IQ2_XS and IQ2_S at 16), their scales sized so that the weights reach
    Q4_K's +-7.5 steps (at the [-31, 31] planes' magnitude, four times
    that, a random 30-layer BitNet is chaotic: the split-K order alone
    moved its prefill logits by half their range, chip_smoke.py phase 16);
    other types as int8 planes in [-31, 31]. Each group's weights
    have mean zero (mins = the mean value times the scale), as trained
    weights nearly do; a shared nonzero mean would add the same component
    to every row's logits and pin greedy decoding to one token. Types
    without mins whose values have a nonzero mean (Q3_K, Q5_0, the IQ4
    codebook) take scales of random sign, as Q3_K's signed 6-bit scales
    have, so that the means cancel between groups."""
    dev = gen.device
    gs = _gs(qtype)
    scale_mag = 0.02 / np.sqrt(k) * 8
    gshape = (k // gs, n) if kmajor else (n, k // gs)

    def uniform(lo, hi, mag):
        u = torch.rand(gshape, generator=gen, device=dev, dtype=torch.float32)
        return ((lo + (hi - lo) * u) * mag).to(scales_dtype)

    def signed(s):
        flip = torch.randint(0, 2, gshape, generator=gen, device=dev, dtype=torch.int8)
        return torch.where(flip.bool(), -s, s)

    def with_mean(s, mean):
        return (s.float() * mean).to(scales_dtype)

    if qtype in (GGMLType.TQ1_0, GGMLType.TQ2_0):
        qshape = (k // 2, n) if kmajor else (n, k // 2)
        lo, hi = (torch.randint(0, 3, qshape, generator=gen, device=dev, dtype=torch.uint8)
                  for _ in range(2))
        return QTensor(lo | (hi << 4), uniform(0.2, 1.0, scale_mag * 7.5), None, gs, qtype,
                       "p4", 1, pack_tk, kmajor)
    if qtype in IQ_RANGE:
        r = IQ_RANGE[qtype]
        qs = torch.randint(-r, r + 1, (k, n) if kmajor else (n, k), generator=gen, device=dev,
                           dtype=torch.int8)
        return QTensor(qs, uniform(0.2, 1.0, scale_mag * 7.5 / r), None, gs, qtype, "i8", 0,
                       pack_tk, kmajor)
    scales = uniform(0.2, 1.0, scale_mag)
    if qtype in (GGMLType.Q4_K, GGMLType.Q2_K, GGMLType.Q3_K):
        qshape = (k // 2, n) if kmajor else (n, k // 2)
        qs = torch.randint(0, 256, qshape, generator=gen, device=dev, dtype=torch.uint8)
        if qtype == GGMLType.Q4_K:
            return QTensor(qs, scales, with_mean(scales, 7.5), gs, qtype, "p4", 0, pack_tk,
                           kmajor)
        if qtype == GGMLType.Q2_K:
            return QTensor(qs & 0x33, scales, with_mean(scales, 1.5), gs, qtype, "p4", 0,
                           pack_tk, kmajor)
        return QTensor(qs & 0x77, signed(scales), None, gs, qtype, "p4", 4, pack_tk, kmajor)
    qshape = (k, n) if kmajor else (n, k)
    if qtype in (GGMLType.Q5_K, GGMLType.Q5_1):
        qs = torch.randint(0, 32, qshape, generator=gen, device=dev, dtype=torch.int8)
        return QTensor(qs, scales, with_mean(scales, 15.5), gs, qtype, "i8", 0, pack_tk,
                       kmajor)
    if qtype == GGMLType.Q5_0:
        qs = torch.randint(-16, 16, qshape, generator=gen, device=dev, dtype=torch.int8)
        return QTensor(qs, signed(scales), None, gs, qtype, "i8", 0, pack_tk, kmajor)
    if qtype in (GGMLType.IQ4_NL, GGMLType.IQ4_XS):
        idx = torch.randint(0, 16, qshape, generator=gen, device=dev, dtype=torch.int64)
        book = torch.from_numpy(KVALUES_IQ4NL).to(dev, torch.int8)
        return QTensor(book[idx], signed(scales), None, gs, qtype, "i8", 0, pack_tk, kmajor)
    qs = torch.randint(-31, 32, qshape, generator=gen, device=dev, dtype=torch.int8)
    return QTensor(qs, scales, None, gs, qtype, "i8", 0, pack_tk, kmajor)


def llama_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab,
                 head_dim=None, head_dim_v=None) -> ModelConfig:
    head_dim = head_dim or n_embd // n_heads
    return ModelConfig(
        arch="llama", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        head_dim_v=head_dim_v or head_dim, n_ff=n_ff, rms_eps=1e-5,
        rope=RopeParams(n_dims=head_dim, mode=ROPE_TYPE_NORM),
        tie_embeddings=True, context_length=4096)


def gemma2_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab, head_dim=None,
                  swa_window: int = 4096) -> ModelConfig:
    """A gemma2 config as config_from_gguf reads Gemma-2's: NEOX rope at
    base 10000, rms eps 1e-6, gelu, the embedding scaled by sqrt(n_embd),
    the window on every other layer, softcaps 50 and 30, head_dim^-0.5
    (query_pre_attn_scalar = head_dim; 27B's 46 layers scale by
    n_embd / n_heads), tied embeddings."""
    head_dim = head_dim or n_embd // n_heads
    return ModelConfig(
        arch="gemma2", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, head_dim_v=head_dim,
        n_ff=n_ff, rms_eps=1e-6, rope=RopeParams(n_dims=head_dim, mode=ROPE_TYPE_NEOX),
        attn_scale=(n_embd / n_heads) ** -0.5 if n_layers == 46 else head_dim ** -0.5,
        tie_embeddings=True, act="gelu", context_length=8192, attn_softcap=50.0,
        final_softcap=30.0, swa_window=swa_window, swa_pattern=2,
        embedding_scale=float(n_embd) ** 0.5)


def gemma2_27b_config(n_layers: int) -> ModelConfig:
    """Gemma-2-27B's config cut to n_layers: built at its 46 layers, which
    select the scale (n_embd / n_heads)^-0.5 = 144^-0.5, then cut; a gemma2
    config built at another depth scales by head_dim^-0.5."""
    return dataclasses.replace(gemma2_config(**GEMMA2_27B), n_layers=n_layers)


def gemma_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab,
                 head_dim=None) -> ModelConfig:
    """A gemma (v1) config as config_from_gguf reads Gemma's: the llama
    graph with NEOX rope at base 10000, rms eps 1e-6, gelu, the embedding
    scaled by sqrt(n_embd), tied embeddings."""
    head_dim = head_dim or n_embd // n_heads
    return ModelConfig(
        arch="gemma", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, head_dim_v=head_dim,
        n_ff=n_ff, rms_eps=1e-6, rope=RopeParams(n_dims=head_dim, mode=ROPE_TYPE_NEOX),
        tie_embeddings=True, act="gelu", context_length=8192,
        embedding_scale=float(n_embd) ** 0.5)


def bitnet_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab,
                  head_dim=None) -> ModelConfig:
    """A bitnet config as config_from_gguf reads BitNet b1.58's: the llama
    graph with NEOX rope at base 500000, rms eps 1e-5, a gated squared
    relu, an untied lm_head (the sub-norms are layer tensors)."""
    head_dim = head_dim or n_embd // n_heads
    return ModelConfig(
        arch="bitnet", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, head_dim_v=head_dim,
        n_ff=n_ff, rms_eps=1e-5,
        rope=RopeParams(n_dims=head_dim, mode=ROPE_TYPE_NEOX, freq_base=500000.0),
        act="relu2", context_length=4096)


def glm4_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab,
                head_dim=None) -> ModelConfig:
    """A glm4 config as config_from_gguf reads GLM-4-0414's: NORM rope at
    base 10000 on the first half of each head (rope.dimension_count
    head_dim / 2, partial_rotary_factor 0.5), rms eps 1.5625e-7 (as the
    file's f32 holds it), a context of 131072, an untied lm_head (the
    biases, post-norms and packed gate+up are tensors)."""
    head_dim = head_dim or n_embd // n_heads
    ctx = 131072
    return ModelConfig(
        arch="glm4", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, head_dim_v=head_dim,
        n_ff=n_ff, rms_eps=float(np.float32(1.5625e-7)),
        rope=RopeParams(n_dims=head_dim // 2, mode=ROPE_TYPE_NORM, n_ctx_orig=ctx),
        context_length=ctx)


def command_r_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab,
                     head_dim=None) -> ModelConfig:
    """A command-r config as config_from_gguf reads Command-R v01's: NORM
    rope at base 10000 (transformers.CohereConfig's default rope_theta; the
    checkpoint's own config is not in this repo, so its base is not taken
    from it), LayerNorm at eps 1e-5, a parallel block, SwiGLU, the logits
    times logit_scale 0.0625 (a multiplier, not granite's divisor) and a
    context of 8192 (the tied table is a tensor matter: no output.weight)."""
    head_dim = head_dim or n_embd // n_heads
    ctx = 8192
    return ModelConfig(
        arch="command-r", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, head_dim_v=head_dim,
        n_ff=n_ff, rms_eps=1e-5,
        rope=RopeParams(n_dims=head_dim, mode=ROPE_TYPE_NORM, n_ctx_orig=ctx),
        norm_kind="ln", parallel_residual=True, logit_scale=0.0625, context_length=ctx)


def qwen2_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab,
                 head_dim=None) -> ModelConfig:
    """A qwen2 config as config_from_gguf reads Qwen2.5's: NEOX rope at
    base 1e6, rms eps 1e-6, QKV biases, an untied lm_head."""
    head_dim = head_dim or n_embd // n_heads
    return ModelConfig(
        arch="qwen2", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, head_dim_v=head_dim,
        n_ff=n_ff, rms_eps=1e-6,
        rope=RopeParams(n_dims=head_dim, mode=ROPE_TYPE_NEOX, freq_base=1e6),
        context_length=32768, attn_bias=True)


def qwen3moe_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab, head_dim=None,
                    n_expert=128, n_expert_used=8, n_ff_expert=768) -> ModelConfig:
    """A qwen3moe config as config_from_gguf reads Qwen3-30B-A3B's: NEOX
    rope at base 1e6, rms eps 1e-6, per-head qk-norm, softmax routing to
    n_expert_used of n_expert experts of n_ff_expert, their weights
    normalized, an untied lm_head."""
    head_dim = head_dim or n_embd // n_heads
    return ModelConfig(
        arch="qwen3moe", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, head_dim_v=head_dim,
        n_ff=n_ff, rms_eps=1e-6,
        rope=RopeParams(n_dims=head_dim, mode=ROPE_TYPE_NEOX, freq_base=1e6),
        context_length=40960, qk_norm=True, n_expert=n_expert,
        n_expert_used=n_expert_used, n_ff_expert=n_ff_expert, expert_weights_norm=True)


def baichuan_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab,
                    head_dim=None) -> ModelConfig:
    """A baichuan config as config_from_gguf reads one: the llama graph,
    NORM rope at base 10000, rms eps 1e-6, an untied lm_head; the 13B
    profile (rope NONE, ALiBi of max_bias 8) where the model has 40 layers
    (a model cut below 40 takes it from alibi_profile)."""
    head_dim = head_dim or n_embd // n_heads
    cfg = ModelConfig(
        arch="baichuan", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, head_dim_v=head_dim,
        n_ff=n_ff, rms_eps=1e-6, rope=RopeParams(n_dims=head_dim, mode=ROPE_TYPE_NORM),
        context_length=4096)
    return alibi_profile(cfg) if n_layers == BAICHUAN_13B_LAYERS else cfg


def refact_config(n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab,
                  head_dim=None) -> ModelConfig:
    """A refact config as config_from_gguf reads one: the llama graph,
    rms eps 1e-5, rope NONE and ALiBi of max_bias 8, an untied lm_head."""
    head_dim = head_dim or n_embd // n_heads
    return alibi_profile(ModelConfig(
        arch="refact", vocab_size=vocab, n_embd=n_embd, n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, head_dim_v=head_dim,
        n_ff=n_ff, rms_eps=1e-5, rope=RopeParams(n_dims=head_dim, mode=ROPE_TYPE_NEOX),
        context_length=4096))


def kmajor_copy(qt: QTensor) -> QTensor:
    """The K-major planes of a rows-layout int8 QTensor (a tied embedding
    table's lm_head copy, the same weights)."""
    if qt.kmajor or qt.layout != "i8":
        raise ValueError("kmajor_copy takes rows-layout int8 planes")
    t = (lambda a: None if a is None else a.t().contiguous())
    return QTensor(t(qt.qs), t(qt.scales), t(qt.mins), qt.group_size, qt.ggml_type, "i8",
                   qt.zp, qt.pack_tk, True)


def make_synthetic_model(n_embd: int = 64, n_layers: int = 2, n_heads: int = 8,
                         n_kv_heads: int = 8, n_ff: int = 256, vocab: int = 256,
                         head_dim: int | None = None, head_dim_v: int | None = None,
                         qtype: GGMLType | None = None, seed: int = 0,
                         dtype=torch.bfloat16, device=None,
                         on_device: bool = False, scales_dtype=torch.bfloat16,
                         fuse: bool = True, recipe: str | None = None,
                         arch: str = "llama", swa_window: int = 4096,
                         n_expert: int = 0, n_expert_used: int = 0, n_ff_expert: int = 0
                         ) -> tuple[dict, ModelConfig]:
    """(params, cfg) for a llama-shaped model with random weights, on
    `device` (None = the card; pass "cpu" for the host).
    qtype None gives dense weights in `dtype`. recipe "Q4_K_M", "Q3_K_M"
    or "Q2_K" mixes types as such a file does (tensor_type_for at the
    model's n_heads / n_kv_heads; qtype then only says that the model is
    quantized; IQ2_XXS, IQ1_M, TQ2_0 and TQ1_0 as tensor_type_for gives
    them): Q4_K_M is Q4_K with Q6_K for the lm_head and for attn_v and
    ffn_down of the use_more_bits layers (those layers' QKV then stays
    unfused); Q3_K_M is Q3_K with attn_v Q5_K in layers 0-1 and Q4_K
    after, ffn_down Q4_K in layers 0-1, a Q6_K lm_head; Q2_K is Q2_K with
    attn_v Q4_K (at 4 or more query heads a KV head), ffn_down Q3_K in the
    use_more_bits layers, a Q6_K lm_head. On the card (on_device) Q2_K and
    Q3_K are nibble planes at group size 16 (device_synthetic_qtensor);
    the host draws follow the JAX package's, which makes int8 planes of
    every type but Q4_0, Q4_1 and Q4_K.
    head_dim_v: V's head dim where it differs from K's (MLA's 128 beside
    192), for attn_v's rows and attn_output's columns. arch "gemma2":
    gemma2_config (swa_window its window), a post-norm after attention and
    after the FFN of every layer, and a tied embedding: with the recipe the
    table is Q6_K (llama.cpp's Q4_K_M type for a tied token_embd) and the
    lm_head its K-major copy. arch "baichuan": baichuan_config (at 40
    layers rope NONE and ALiBi; the weights do not depend on the profile,
    so a cut model takes it by alibi_profile on the returned config);
    "refact": refact_config. arch "gemma": gemma_config, the table tied as
    gemma2's, no post-norms. arch "qwen2": qwen2_config, with random f32
    biases on q, k and v (attn_q_b, attn_k_b, attn_v_b). arch "qwen3moe":
    qwen3moe_config with n_expert experts of n_ff_expert, n_expert_used a
    token: per layer qk-norm weights, a dense router ffn_gate_inp [E,
    n_embd] in dtype (a GGUF keeps it F32, loaded in the dense dtype), and
    the expert stacks ffn_{gate,up,down}_exps as stacked-expert planes
    (rows layout, [E, ...]; the recipe's Q6_K for ffn_down_exps in the
    use_more_bits layers) or dense [E, N, K], in place of the FFN. arch
    "bitnet": bitnet_config, with the sub-norms attn_sub_norm and
    ffn_sub_norm in every layer. arch "glm4": glm4_config, with random f32
    biases on q, k and v as qwen2's, the post-norms as gemma2's, and gate
    and up as one matrix ffn_gateup_fused [2 n_ff, n_embd] of ffn_up's type
    (the GGUF packs them in ffn_up). arch "command-r": command_r_config,
    an attn_norm (LayerNorm weights, no bias) and no ffn_norm in every
    layer (the parallel block's FFN reads the attention's normed input),
    and a tied embedding as gemma2's. With the
    recipe a matrix whose K its type's block does not divide takes Q8_0
    (fallback_type; Baichuan-13B's ffn_down, K = 13696)."""
    if recipe is not None and recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}")
    if arch not in ("llama", "gemma", "gemma2", "baichuan", "refact", "qwen2", "qwen3moe",
                    "bitnet", "glm4", "command-r"):
        raise ValueError(f"unknown arch {arch!r}")
    device = resolve_device(device)
    tied = arch in ("gemma", "gemma2", "command-r")
    moe = arch == "qwen3moe"
    geo = (n_embd, n_layers, n_heads, n_kv_heads, n_ff, vocab, head_dim)
    if arch == "gemma2":
        cfg = gemma2_config(*geo, swa_window)
    elif arch == "gemma":
        cfg = gemma_config(*geo)
    elif arch == "qwen2":
        cfg = qwen2_config(*geo)
    elif moe:
        cfg = qwen3moe_config(*geo, n_expert, n_expert_used, n_ff_expert)
    elif arch == "baichuan":
        cfg = baichuan_config(*geo)
    elif arch == "refact":
        cfg = refact_config(*geo)
    elif arch == "bitnet":
        cfg = bitnet_config(*geo)
    elif arch == "glm4":
        cfg = glm4_config(*geo)
    elif arch == "command-r":
        cfg = command_r_config(*geo)
    else:
        cfg = llama_config(*geo, head_dim_v)
    hd, hdv = cfg.head_dim, cfg.head_dim_v
    rng = np.random.default_rng(seed)
    gen = None
    if on_device:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def mat(n, k, kmajor=True, name=None, il=0):
        qt = qtype
        if recipe and qt is not None and name is not None:
            qt = tensor_type_for(name, k, recipe, il, n_layers, n_heads // n_kv_heads,
                                 n_expert, has_output=not tied)
        if on_device:
            if qt is None:
                w = torch.randn((n, k), generator=gen, device=device) * 0.02
                return w.to(dtype)
            return device_synthetic_qtensor(gen, n, k, qt, scales_dtype, kmajor)
        if qt is None:
            w = rng.normal(size=(n, k)).astype(np.float32) * 0.02
            return torch.from_numpy(w).to(device, dtype)
        return synthetic_qtensor(rng, n, k, qt, kmajor=kmajor, device=device)

    def vec(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    def dense(n, k, std=0.02, dt=None):  # a dense [n, k] in dt (dtype when None)
        if on_device:
            w = torch.randn((n, k), generator=gen, device=device) * std
        else:
            w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32) * std)
        return w.to(device, dt or dtype)

    def stack(n, k, name, il):  # n_expert experts of [n, k], rows layout
        w = mat(n * n_expert, k, kmajor=False, name=name, il=il)
        if isinstance(w, QTensor):
            return w.map(lambda t: t.reshape(n_expert, n, -1))
        return w.reshape(n_expert, n, k)

    layers = []
    for il in range(n_layers):
        def lmat(key, n, k):
            return mat(n, k, name=f"blk.{il}.{key}.weight", il=il)

        layers.append({
            "attn_norm": vec(n_embd),
            "attn_q": lmat("attn_q", n_heads * hd, n_embd),
            "attn_k": lmat("attn_k", n_kv_heads * hd, n_embd),
            "attn_v": lmat("attn_v", n_kv_heads * hdv, n_embd),
            "attn_output": lmat("attn_output", n_embd, n_heads * hdv),
            "ffn_norm": vec(n_embd),
        })
        if moe:
            layers[-1].update(
                attn_q_norm=vec(hd), attn_k_norm=vec(hd),
                ffn_gate_inp=dense(n_expert, n_embd),
                ffn_gate_exps=stack(n_ff_expert, n_embd, f"blk.{il}.ffn_gate_exps.weight", il),
                ffn_up_exps=stack(n_ff_expert, n_embd, f"blk.{il}.ffn_up_exps.weight", il),
                ffn_down_exps=stack(n_embd, n_ff_expert, f"blk.{il}.ffn_down_exps.weight",
                                    il))
        elif arch == "glm4":  # gate+up packed in one matrix, ffn_up's type
            layers[-1].update(ffn_gateup_fused=lmat("ffn_up", 2 * n_ff, n_embd),
                              ffn_down=lmat("ffn_down", n_embd, n_ff))
        else:
            layers[-1].update(ffn_gate=lmat("ffn_gate", n_ff, n_embd),
                              ffn_up=lmat("ffn_up", n_ff, n_embd),
                              ffn_down=lmat("ffn_down", n_embd, n_ff))
        if arch in ("gemma2", "glm4"):
            layers[-1].update(attn_post_norm=vec(n_embd), ffn_post_norm=vec(n_embd))
        if arch == "bitnet":
            layers[-1].update(attn_sub_norm=vec(n_heads * hdv), ffn_sub_norm=vec(n_ff))
        if arch == "command-r":  # one norm for both halves of the parallel block
            del layers[-1]["ffn_norm"]
        if arch in ("qwen2", "glm4"):
            for key, n in (("attn_q_b", n_heads * hd), ("attn_k_b", n_kv_heads * hd),
                           ("attn_v_b", n_kv_heads * hdv)):
                layers[-1][key] = dense(1, n, std=0.1, dt=torch.float32)[0]
        if fuse and qtype is not None:
            fuse_projections(layers[-1:])
    tok = mat(vocab, n_embd, kmajor=False, name="token_embd.weight")
    if tied:  # the lm_head is the embedding table
        out = kmajor_copy(tok) if isinstance(tok, QTensor) else tok
    else:
        out = mat(vocab, n_embd, name="output.weight")
    params = {"layers": layers, "tok_embd": tok, "output": out, "output_norm": vec(n_embd)}
    return params, cfg
