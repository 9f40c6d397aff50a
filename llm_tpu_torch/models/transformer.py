"""The llama decoder forward. Counterpart of
llm_tpu/models/transformer.py::forward on its llama, gemma, gemma2, ALiBi
(baichuan-13B, refact), qwen2 / qwen3 and mixture-of-experts (mixtral,
qwen2moe, qwen3moe) paths:

  qembed -> per layer: rms_norm -> fused QKV (K1/K2) -> split -> rope on q
  -> scatter unroped K/V into the head-major cache (quantizing for a q8_0
  cache) -> flash_decode (K3, or K3q on the int8 cache; T <= 8) /
  flash_prefill (K4 / K4q) -> o_proj -> residual -> rms_norm -> fused
  gate+up -> SwiGLU -> down -> residual; final norm -> lm_head on the
  out_idx rows.

gemma (v1) runs the llama graph with a gelu (tanh) FFN and the embedding
scaled by sqrt(n_embd) in f32. gemma2 (cfg.arch "gemma2") adds, as the
reference does: the embedding scaled by sqrt(n_embd) in f32; the
attention logit softcap inside the flash kernels (their capped
instantiations: K3w_cap at decode, K4_cap at a prefill step whose heads
the narrow kernels take, else K4w_cap, and the q8 ones) and the unfused
attention; a sliding window on every other layer (cfg.layer_is_swa), as a
second bias; post-norms (attn_post_norm, ffn_post_norm) on the attention
and FFN outputs before each residual; a gelu (tanh) FFN; and the final
logit softcap after the lm_head. With the
ISWA dual cache (the Context's ring, runtime/kv_cache.py SWACellTable) the
sliding-window layers read and write their own smaller cache: swa_cell_pos,
swa_cell_seq_bits and swa_write_idx describe it, with its own rope tables
and bias; without them those layers use the full cache (swa_full).

ALiBi (cfg.alibi_max_bias > 0: baichuan-13B, refact, with rope NONE), as
the reference does (transformer.py:338-348, :434-437): the slopes of
ggml's soft_max_ext schedule (alibi_slopes) and the positions tok_pos and
cell_pos as f32, made once a step, go to the narrow flash kernels' ALiBi
instantiations (K3_alibi, K3q_alibi, K4_alibi, K4q_alibi), which fold no
rope: no q_rot and no tables (the reference passes zeros and the identity
tables, :556-561, to kernels that fold them). The wide and capped kernels
take no ALiBi, nor does any kernel take ALiBi beside a rope: flash_route
sends such a step to the unfused attention, which subtracts slope *
(tok_pos - cell_pos) after the bias (ROADMAP, "Deliberate differences").

qwen2 (cfg.attn_bias) adds its q, k and v biases to the fused QKV's
slices; qwen3 (cfg.qk_norm) RMS-normalizes each head of q and k (before
rope, and k before it enters the cache). A mixture-of-experts layer
(ffn_gate_inp: the router, and the stacks ffn_{gate,up,down}_exps) runs
moe_ffn in place of the FFN, the reference's _moe_ffn: softmax (or
sigmoid) router probabilities, the top n_expert_used experts of a token
(ties to the lower expert, as jax.lax.top_k), their weights normalized and
scaled as the config says; at T <= 8 the chosen experts' planes are
gathered and dequantized per (token, k) ([T, k, N, K], gather_experts)
and multiplied in f32, at T > 8 the grouped dispatch of parallel/moe.py
runs each expert once over its tokens; a shared expert (qwen2moe:
ffn_*_shexp), gated by sigmoid(h @ ffn_gate_inp_shexp) where that is
given, is added. The experts' products are plain PyTorch, as the
reference computes them outside its Pallas kernels (ROADMAP Queue 2 holds
their kernel as later work).

With chain=True (the reference's LLM_TPU_CHAIN=1) a step of T <= 8 tokens
runs the chained kernel K6 (ops/cuda_qmm_chain.py) where its gates admit
the layer: attn_norm -> fused QKV as one norm_mm, the whole tail o_proj ->
residual -> ffn_norm -> gate+up -> SwiGLU or GeGLU -> down -> residual as
one layer_tail, and the final norm -> lm_head on the out_idx rows as one
norm_mm. The reference's gates hold: QKV biases keep a head unchained,
a mixture-of-experts layer's tail runs unchained, and qk-norm runs after
the chained QKV. With gdot=True (LLM_TPU_GDOT=force) every quantized
matmul that stays unfused routes p4 planes at B <= 16 through K5.

With params["layers_stacked"] (uniform layers stacked by stack_layers, the
reference's scan decoder, transformer.py:658-688) the layers run from the
stacked dict: each layer's small leaves (norms) are its row, and its big
leaves (QTensors, tensors of ndim >= 3) a StackedWeight on the layer's
index, whose matmuls run K7 on the stacked planes, the index read on the
card. K6's gates refuse a StackedWeight, as the reference's refuse anything
but a QTensor: under chain the layers run unchained, the lm_head on K6.

Attention takes the reference's route (its use_flash gate,
llm_tpu/models/transformer.py:355-392), chosen by flash_route on either
device: head dims Dk and Dv that are multiples of 8 up to 256 run
K3/K3q/K4/K4q; heads past 256, which the reference's gate sends to its
flash kernels and no kernel of the port takes, go through the unfused
attention on either device (ROADMAP, "Deliberate differences"), and so do
a head dim that is no multiple of 8 and a q8_0 cache whose rows carry
group scales (kv_cache.kv_group: head_dim 64 or 96, any multiple of 32 but
not of 128), the cache dequantized by kv_read. The reference looks at K's scales only; with V's
rows group-scaled under one K scale a row (Dk 128, Dv 192) its kernels read
V's first group scale for the whole row (ROADMAP, "Faults in the
reference"), so the port takes the unfused attention there.

The RMS-norm llama graphs with small knobs run the same loop, as the
reference's does (transformer.py:489-652): granite and minicpm scale the
embedding in f32 (cfg.embedding_scale), the attention and FFN outputs
before each residual (cfg.residual_scale) and the logits
(cfg.logit_scale); olmo2 has no input norms (a missing attn_norm or
ffn_norm passes x through), post-norms before each residual, and an RMS
norm over the whole flattened q and k (cfg.qk_norm_full); glm4 adds its
QKV biases and post-norms and packs gate+up in ffn_up, as phi3 does
beside its fused QKV (models/loader.py); arcee's FFN is a squared relu of
up without a gate; ernie4_5, xverse, internlm2 and exaone are the llama
graph. The chained kernel takes only the recipe it implements
(chain_gate, the reference's use_chain): a residual scale or a squared
relu runs the whole model unchained, post-norms and biases keep their
tail or head unchained.

The LayerNorm graphs (cfg.norm_kind "ln": command-r, falcon, phi2,
gptneox, gptj, starcoder2, stablelm, orion, nemotron, olmo, gpt2,
starcoder, bloom, mpt) run the same loop with the reference's norm
dispatch (norm, its _norm: LayerNorm with the tensor's bias where one is
given, olmo's without weight or bias), learned positions added after the
embedding (pos_embd, gpt2 and starcoder) and an embedding norm after them
(tok_norm, bloom), a fused QKV's bias added before the split
(attn_qkv_fused_b), biases on o_proj, up, gate and down and on the
logits, and the parallel block (cfg.parallel_residual): the FFN reads its
own ffn_norm of the layer's input (gptneox) or, without one, the
attention's normed input (command-r, falcon, gptj, phi2), and the layer
returns x + ffn_out + attn_out, summed in that order as the reference
sums it. None of them chains (chain_gate).

It runs eagerly and updates the KV cache tensors in place (the JAX
package donates them to a jitted step instead). Variants of the llama
graph that the JAX package supports and the port does not run yet raise
NotImplementedError.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..device import full_f32
from ..ops.attention import attention, build_attn_bias
from ..ops.cuda_attn import (MAX_HEAD_DIM, expand_tables, flash_decode, flash_prefill,
                             is_narrow, rope_companion)
from ..ops.cuda_qmm_chain import head_eligible, is_kmajor_qt, layer_tail, norm_mm, tail_eligible
from ..ops.norms import layer_norm, rms_norm
from ..ops.qmatmul import dequant_expert_rows, qembed, qmm
from ..ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NONE, ROPE_TYPE_NORM, apply_rope, rope_angles
from ..parallel.moe import moe_ffn_grouped
from ..quant.qtensor import QTensor, StackedWeight
from .config import ModelConfig

_UNSUPPORTED = (
    ("kv_lora_rank", 0, "MLA"), ("rope_sections", None, "M-RoPE"),
    ("nope_global_layers", False, "cohere2's global layers without rope (NoPE)"),
)
# the norms (the reference's _norm): RMS, or LayerNorm with a bias
NORM_KINDS = ("rms", "ln")
# the activations the chained tail implements (K6: SwiGLU, GeGLU)
CHAIN_ACTS = ("silu", "gelu")
# the FFN activations (the reference's ACTIVATIONS): the gated SiLU of
# llama, the gated gelu (tanh) of gemma and gemma2, and the squared relu,
# gated in bitnet and ungated in arcee (no ffn_gate)
ACTIVATIONS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
               "relu2": lambda x: torch.square(F.relu(x))}
# the router's probabilities (the reference's expert_gating_func)
GATING = ("softmax", "sigmoid")
# steps of at most this many tokens gather their experts' planes per (token,
# k); longer ones take the grouped dispatch (the reference's T > 8)
MOE_GATHER_MAX_T = 8
_TOP_KEYS = {"tok_embd", "layers", "layers_stacked", "output", "output_norm", "rope_freqs",
             "output_norm_b", "output_b", "pos_embd", "tok_norm", "tok_norm_b"}
_LAYER_KEYS = {"attn_norm", "ffn_norm", "attn_q", "attn_k", "attn_v", "attn_qkv_fused",
               "attn_output", "ffn_gate", "ffn_up", "ffn_gateup_fused", "ffn_down",
               "attn_post_norm", "ffn_post_norm", "attn_q_b", "attn_k_b", "attn_v_b",
               "attn_q_norm", "attn_k_norm", "ffn_gate_inp", "ffn_exp_probs_b",
               "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps", "ffn_gate_shexp",
               "ffn_up_shexp", "ffn_down_shexp", "ffn_gate_inp_shexp", "attn_sub_norm",
               "ffn_sub_norm", "attn_norm_b", "ffn_norm_b", "attn_qkv_fused_b", "attn_output_b",
               "ffn_up_b", "ffn_gate_b", "ffn_down_b"}


def flash_route(dk: int, dv: int, k_groups: int = 1, v_groups: int = 1,
                alibi: bool = False, q8: bool = False, softcap: float = 0.0,
                roped: bool = False) -> bool:
    """Whether attention runs the flash kernels (else the unfused
    attention): Dk and Dv multiples of 8 up to MAX_HEAD_DIM, and on a q8_0
    cache one scale a row of K and of V (k_groups, v_groups: scales a row;
    1 for a dense cache). The reference's use_flash gate, which reads K's
    scales only and takes any multiple of 8; no kernel of the port holds a
    head past 256 (ROADMAP, "Deliberate differences"). An ALiBi step
    (alibi) runs the flash kernels only where the narrow, uncapped ones
    take it (is_narrow on the cache type q8, no softcap) and its rope is
    NONE (not roped): the wide and capped kernels have no ALiBi
    instantiation, and the ALiBi ones fold no rope."""
    if alibi and (roped or not (is_narrow(dk, dv, q8) and softcap <= 0.0)):
        return False
    return (dk % 8 == 0 and dv % 8 == 0 and max(dk, dv) <= MAX_HEAD_DIM
            and k_groups == 1 and v_groups == 1)


def alibi_slopes(n_heads: int, max_bias: float) -> list[float]:
    """The ALiBi slope of each head, ggml's soft_max_ext max_bias schedule
    (the reference's transformer.py:338-348), in Python floats: n2 = 2 **
    floor(log2 H), m0 = 2 ** (-max_bias / n2), m1 = 2 ** (-max_bias / 2 /
    n2); head h < n2 takes m0 ** (h + 1), the rest m1 ** (2 (h - n2) + 1)."""
    n2 = 2 ** math.floor(math.log2(n_heads))
    m0 = 2.0 ** (-max_bias / n2)
    m1 = 2.0 ** (-max_bias / 2.0 / n2)
    return [m0 ** (h + 1) if h < n2 else m1 ** (2 * (h - n2) + 1) for h in range(n_heads)]


@functools.lru_cache(maxsize=8)
def _slopes_tensor(n_heads: int, max_bias: float, device: torch.device) -> torch.Tensor:
    """alibi_slopes cast to f32 [H] on device, made once."""
    return torch.tensor(alibi_slopes(n_heads, max_bias), dtype=torch.float32, device=device)


def check_supported(params: dict, cfg: ModelConfig) -> None:
    """Refuse what the forward does not port (every head dim and cache
    layout runs: flash_route picks the attention)."""
    for name, default, what in _UNSUPPORTED:
        if getattr(cfg, name) != default:
            raise NotImplementedError(f"{what} is not ported yet")
    if cfg.norm_kind not in NORM_KINDS:
        raise NotImplementedError(f"norm kind {cfg.norm_kind!r} is not ported")
    if cfg.act not in ACTIVATIONS:
        raise NotImplementedError(f"FFN activation {cfg.act!r} is not ported yet")
    if cfg.expert_gating_func not in GATING:
        raise NotImplementedError(f"expert gating {cfg.expert_gating_func!r} is not ported")
    if cfg.rope.mode not in (ROPE_TYPE_NORM, ROPE_TYPE_NEOX, ROPE_TYPE_NONE):
        raise NotImplementedError(f"rope mode {cfg.rope.mode} is not ported yet")
    extra = {k for k, v in params.items() if v is not None} - _TOP_KEYS
    if extra:  # adapters, the reference's other models' tensors
        raise NotImplementedError(f"model tensors {sorted(extra)} are not ported yet")
    stacked = params.get("layers_stacked")
    for layer in params["layers"] + ([stacked] if stacked is not None else []):
        extra = set(layer) - _LAYER_KEYS
        if extra:  # LoRA adapters, control vectors
            raise NotImplementedError(f"layer tensors {sorted(extra)} are not ported yet")
    n_layers = n_stacked(stacked) if stacked is not None else len(params["layers"])
    if n_layers != cfg.n_layers:
        raise ValueError(f"params hold {n_layers} layers, the config {cfg.n_layers}")


def chain_gate(cfg: ModelConfig, chain: bool, T: int) -> bool:
    """Whether a step of T tokens may run K6 at all: chain asked for, T <= 8,
    and the model-wide recipe K6 implements, as the reference's use_chain
    gate (llm_tpu/models/transformer.py:404-412) has it on the port's
    fields: RMS norms, a sequential residual without a scale, a SiLU or
    gelu FFN (no squared relu: bitnet and arcee run unchained). The
    reference's nonparam_norm comes only with LayerNorm, and its fused_tp >
    1 is refused by config_from_reference; the per-layer gates are
    head_eligible and tail_eligible."""
    return (chain and T <= 8 and cfg.norm_kind == "rms" and not cfg.parallel_residual
            and cfg.residual_scale == 1.0 and cfg.act in CHAIN_ACTS)


def norm(x: torch.Tensor, w: torch.Tensor | None, cfg: ModelConfig,
         b: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's _norm: RMS (a bias is not read) or LayerNorm with
    the weight and bias given, at cfg.rms_eps."""
    if cfg.norm_kind == "rms":
        return rms_norm(x, w, cfg.rms_eps)
    return layer_norm(x, w, b, cfg.rms_eps)


def _bias(t: torch.Tensor, layer: dict, key: str) -> torch.Tensor:
    """t plus layer[key] in t's dtype where the layer has that bias (the
    reference's _maybe_add)."""
    b = layer.get(key)
    return t if b is None else t + b.to(t.dtype)


def _leaf(v) -> torch.Tensor:
    return v.qs if isinstance(v, QTensor) else v


def n_stacked(stacked: dict) -> int:
    """The layer count of a stacked layer dict (stack_layers)."""
    return _leaf(next(iter(stacked.values()))).shape[0]


def layer_views(stacked: dict) -> list[dict]:
    """The layers of a stacked dict, one dict each, made once per model
    (the Context keeps them): small leaves (norm vectors) as the layer's
    row, big ones (QTensors, tensors of ndim >= 3) as a StackedWeight on
    lids[il:il+1], lids the layer indices int32 [L] made once on the
    leaves' device (the reference's scan xs and StackedWeight split)."""
    big = {k: v for k, v in stacked.items() if isinstance(v, QTensor) or v.dim() >= 3}
    small = {k: v for k, v in stacked.items() if k not in big}
    n = n_stacked(stacked)
    lids = torch.arange(n, dtype=torch.int32,
                        device=_leaf(next(iter(stacked.values()))).device)
    return [{**{k: v[il] for k, v in small.items()},
             **{k: StackedWeight(w, lids[il:il + 1]) for k, w in big.items()}}
            for il in range(n)]


def kept_rows(idx: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Rows whose write index is in range. Padding tokens carry
    idx == n_cells and are dropped (the reference scatters with
    mode="drop"; torch has none). One host sync, once per step and cache
    (twice with the ISWA ring)."""
    return torch.nonzero(idx < n_cells).flatten()


def quantize_rows(val: torch.Tensor, n_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q8_0 rows: val [..., D] -> (int8 [..., D], bf16 scales [..., n_groups]).
    Per group of D // n_groups dims: scale = amax / 127 in f32, q =
    clip(round(v / scale), +-127) with round half to even (as jnp.round),
    the scale stored as bf16. The reference's _kv_write and state loader."""
    d = val.shape[-1]
    vf = val.float().reshape(*val.shape[:-1], n_groups, d // n_groups)
    scale = vf.abs().amax(dim=-1, keepdim=True) / 127.0
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    q = torch.clamp(torch.round(vf * inv), -127, 127).to(torch.int8)
    return q.reshape(val.shape), scale.squeeze(-1).to(torch.bfloat16)


def kv_write(cache, idx: torch.Tensor, val: torch.Tensor,
             keep: torch.Tensor | None = None) -> None:
    """Scatter token-major rows val [T, Hkv, D] into the head-major cache
    [Hkv, S, D] at cells idx [T], in place, dropping padding rows; a q8_0
    (int8, scales) pair gets the rows quantized by quantize_rows."""
    if keep is None:
        keep = kept_rows(idx, (cache[0] if isinstance(cache, tuple) else cache).shape[1])
    cells, rows = idx[keep].long(), val[keep]
    if isinstance(cache, tuple):
        q8, sc = cache
        q, s = quantize_rows(rows, sc.shape[-1])
        q8.index_copy_(1, cells, q.transpose(0, 1))
        sc.index_copy_(1, cells, s.transpose(0, 1))
        return
    cache.index_copy_(1, cells, rows.transpose(0, 1).to(cache.dtype))


def kv_read(cache, dtype) -> torch.Tensor:
    """The cache CELL-MAJOR [S, Hkv, D] in dtype, a q8_0 pair dequantized
    in f32 (q * s), for the unfused attention."""
    if isinstance(cache, tuple):
        q8, sc = cache
        h, s, d = q8.shape
        g = d // sc.shape[-1]
        vf = q8.float().reshape(h, s, d // g, g) * sc.float()[..., None]
        return vf.reshape(h, s, d).transpose(0, 1).to(dtype)
    return cache.transpose(0, 1).to(dtype)


def ffn(h: torch.Tensor, layer: dict, cfg: ModelConfig, dtype, gdot: bool = False
        ) -> torch.Tensor:
    """The gated FFN of h [T, D] in dtype: fused gate+up, or gate and up
    apart (the shared expert's ffn_gate / ffn_up), each with its bias where
    given, act(g) * u in f32, down and its bias (the reference's _ffn),
    with bitnet's ffn_sub_norm before down."""
    act = ACTIVATIONS[cfg.act]
    if "ffn_gateup_fused" in layer:
        g, up = torch.split(qmm(h, layer["ffn_gateup_fused"], gdot=gdot), cfg.n_ff, dim=-1)
        cur = (act(g) * up).to(dtype)
    else:
        up = _bias(qmm(h, layer["ffn_up"], out_dtype=dtype, gdot=gdot), layer, "ffn_up_b")
        if layer.get("ffn_gate") is not None:
            g = act(_bias(qmm(h, layer["ffn_gate"], gdot=gdot), layer, "ffn_gate_b"))
            cur = (g * up.float()).to(dtype)
        else:
            cur = act(up.float()).to(dtype)
    if "ffn_sub_norm" in layer:  # bitnet: a norm before ffn_down
        cur = rms_norm(cur, layer["ffn_sub_norm"], cfg.rms_eps)
    return _bias(qmm(cur, layer["ffn_down"], out_dtype=dtype, gdot=gdot), layer, "ffn_down_b")


def gather_experts(stack, topi: torch.Tensor, dtype) -> torch.Tensor:
    """The experts topi [T, k] of a stack, dequantized: [T, k, N, K] in
    dtype (a stacked-expert QTensor's planes gathered, or a dense [E, N, K]
    stack's rows; the reference's _gather_experts)."""
    if isinstance(stack, QTensor):
        return dequant_expert_rows(stack, topi, dtype=dtype)
    return stack[topi].to(dtype)


def top_k(sel: torch.Tensor, k: int) -> torch.Tensor:
    """The indices [T, k] of the k largest entries of each row of sel [T,
    E], largest first, and of equal entries the lower index first, as
    jax.lax.top_k orders them (torch.topk promises no order of ties)."""
    return torch.sort(sel, dim=-1, descending=True, stable=True).indices[:, :k]


def moe_ffn(h: torch.Tensor, layer: dict, cfg: ModelConfig,
            weight_before: bool = False) -> torch.Tensor:
    """The mixture-of-experts FFN of h [T, D] (the reference's _moe_ffn):
    router logits h @ ffn_gate_inp, their softmax (or sigmoid) in f32; the
    top n_expert_used experts of each token by the probabilities plus
    ffn_exp_probs_b where given (the weights stay the unbiased
    probabilities), normalized to sum 1 if expert_weights_norm, times
    expert_weights_scale. weight_before (llama4's expert_weight_before,
    which the port's config does not model: config_from_reference refuses
    it) scales the expert's input by the weight instead. T <= MOE_GATHER_MAX_T: each (token, k)'s expert
    gathered and dequantized in cdtype (f32 when h is, else bf16), its
    products in f32 rounded to cdtype, act in f32, the k outputs weighted
    and summed in f32; longer steps take parallel/moe.py's grouped
    dispatch. Returns [T, D] in h's dtype."""
    T = h.shape[0]
    logits = qmm(h, layer["ffn_gate_inp"])  # [T, E] f32
    if cfg.expert_gating_func == "sigmoid":
        probs = torch.sigmoid(logits.float())
    else:
        probs = torch.softmax(logits.float(), dim=-1)
    sel = probs
    if "ffn_exp_probs_b" in layer:  # biases which experts, not their weights
        sel = probs + layer["ffn_exp_probs_b"].float()
    topi = top_k(sel, cfg.n_expert_used)
    topw = torch.gather(probs, -1, topi)
    if cfg.expert_weights_norm:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    topw = topw * cfg.expert_weights_scale
    act = ACTIVATIONS[cfg.act]
    cdtype = torch.float32 if h.dtype == torch.float32 else torch.bfloat16
    gate = layer.get("ffn_gate_exps")

    def mm(a: torch.Tensor, w: torch.Tensor, eq: str) -> torch.Tensor:
        # an einsum of cdtype operands, exact products summed in f32, the
        # result in cdtype (XLA's dot of two cdtype operands)
        with full_f32():
            return torch.einsum(eq, a.to(cdtype).float(), w.float()).to(cdtype)

    if weight_before:
        # llama4: the weight scales the expert's input (build_moe_ffn
        # weight_before_ffn)
        if cfg.n_expert_used == 1:
            h = (h.float() * topw[:, :1]).to(h.dtype)
            topw = torch.ones_like(topw)
        else:
            hk = (h.float()[:, None, :] * topw[..., None]).to(cdtype)  # [T, k, K]
            up = mm(hk, gather_experts(layer["ffn_up_exps"], topi, cdtype), "tki,tkni->tkn")
            if gate is not None:
                g = act(mm(hk, gather_experts(gate, topi, cdtype), "tki,tkni->tkn").float())
                cur = (g * up.float()).to(cdtype)
            else:
                cur = act(up.float()).to(cdtype)
            out = mm(cur, gather_experts(layer["ffn_down_exps"], topi, cdtype), "tkf,tkef->tke")
            return out.float().sum(dim=1).to(h.dtype)
    if T > MOE_GATHER_MAX_T:
        return moe_ffn_grouped(h, layer["ffn_up_exps"], gate, layer["ffn_down_exps"], topi,
                               topw.float(), act, cf=cfg.ep_cf).to(h.dtype)
    up = mm(h, gather_experts(layer["ffn_up_exps"], topi, cdtype), "ti,tkni->tkn")
    if gate is not None:
        g = act(mm(h, gather_experts(gate, topi, cdtype), "ti,tkni->tkn").float())
        cur = (g * up.float()).to(h.dtype)
    else:
        cur = act(up.float()).to(h.dtype)
    out = mm(cur, gather_experts(layer["ffn_down_exps"], topi, cdtype), "tkf,tkef->tke")
    return (out.float() * topw[..., None]).sum(dim=1).to(h.dtype)


def forward(params: dict, cfg: ModelConfig, kv_k: list, kv_v: list,
            tokens: torch.Tensor, tok_pos: torch.Tensor, tok_seq: torch.Tensor,
            write_idx: torch.Tensor, cell_pos: torch.Tensor,
            cell_seq_bits: torch.Tensor, out_idx: torch.Tensor,
            dtype=torch.bfloat16, chain: bool = False,
            gdot: bool = False, stacked_layers: list | None = None,
            swa_cell_pos: torch.Tensor | None = None,
            swa_cell_seq_bits: torch.Tensor | None = None,
            swa_write_idx: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode/prefill step over T tokens. cell_seq_bits: [S, W] int64
    bit-set words. Updates kv_k/kv_v in place. Returns (logits [O, vocab]
    f32, hidden [O, n_embd] f32) for the out_idx rows. chain / gdot: the
    chained kernel and the group-factored matmul (module docstring).
    stacked_layers: for params with "layers_stacked", the per-layer dicts
    that layer_views makes of them, which the caller makes once.
    swa_cell_pos [Ss], swa_cell_seq_bits [Ss, W], swa_write_idx [T]: the
    ISWA ring of the sliding-window layers, whose caches then have Ss cells
    (None: they share the full cache's cells)."""
    check_supported(params, cfg)
    rope = cfg.rope
    ff = params.get("rope_freqs")
    H, Hkv, Dk, Dv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim_v
    T = tokens.shape[0]
    scale = cfg.attn_scale if cfg.attn_scale is not None else Dk ** -0.5
    use_chain = chain_gate(cfg, chain, T)

    x = qembed(params["tok_embd"], tokens, dtype=dtype)
    if cfg.embedding_scale != 1.0:
        x = (x.float() * cfg.embedding_scale).to(dtype)
    if params.get("pos_embd") is not None:  # learned positions (gpt2, starcoder)
        x = x + params["pos_embd"][tok_pos.long()].to(dtype)
    if params.get("tok_norm") is not None:  # the embedding norm (bloom)
        x = norm(x, params["tok_norm"], cfg, params.get("tok_norm_b"))
    dual = swa_cell_pos is not None

    alibi = cfg.alibi_max_bias > 0.0
    slopes = _slopes_tensor(H, cfg.alibi_max_bias, x.device) if alibi else None
    tok_pos_f = tok_pos.float().contiguous() if alibi else None

    def tables(cpos):
        """Half-width rope tables of the cells, their full-width bf16
        expansion for the flash kernels (None under ALiBi, whose kernels
        fold no rope), and the cells' positions in f32 for ALiBi (else
        None)."""
        ch, sh = rope_angles(cpos, rope, ff)
        if alibi:
            return ch, sh, None, None, cpos.float().contiguous()
        cf, sf = expand_tables(ch, sh, rope.mode, Dk, n_dims=rope.n_dims)
        return ch, sh, cf.to(dtype).contiguous(), sf.to(dtype).contiguous(), None

    cos_t, sin_t = rope_angles(tok_pos, rope, ff)
    tab = tables(cell_pos)
    keep = kept_rows(write_idx, cell_pos.shape[0])
    bias = build_attn_bias(tok_pos, tok_seq, cell_pos, cell_seq_bits)
    tab_swa, keep_swa, bias_swa = tab, keep, None
    if dual:
        tab_swa = tables(swa_cell_pos)
        keep_swa = kept_rows(swa_write_idx, swa_cell_pos.shape[0])
    if cfg.swa_window > 0:
        bias_swa = build_attn_bias(tok_pos, tok_seq,
                                   swa_cell_pos if dual else cell_pos,
                                   swa_cell_seq_bits if dual else cell_seq_bits,
                                   swa_window=cfg.swa_window)
    fattn = flash_decode if T <= 8 else flash_prefill
    # the reference's use_flash gate, on either device (module docstring)
    q8 = isinstance(kv_k[0], tuple)
    unfused = not flash_route(Dk, Dv, kv_k[0][1].shape[-1] if q8 else 1,
                              kv_v[0][1].shape[-1] if q8 else 1, alibi=alibi, q8=q8,
                              softcap=cfg.attn_softcap, roped=rope.mode != ROPE_TYPE_NONE)

    layers = params["layers"]
    if params.get("layers_stacked") is not None:
        if stacked_layers is None:
            raise ValueError("stacked params run from layer_views' per-layer dicts, "
                             "made once by the caller")
        layers = stacked_layers
    for il, layer in enumerate(layers):
        is_swa = cfg.layer_is_swa(il)
        qkv = None
        if use_chain and head_eligible(layer):
            qkv = norm_mm(x, layer["attn_norm"], layer["attn_qkv_fused"], eps=cfg.rms_eps,
                          compute_dtype=dtype, out_dtype=dtype)
        if qkv is None:
            # post-norm graphs (olmo2) have no input norm: attend over x;
            # olmo's non-parametric norm runs without a tensor
            h = norm(x, layer.get("attn_norm"), cfg, layer.get("attn_norm_b")) \
                if ("attn_norm" in layer or cfg.nonparam_norm) else x
            if "attn_qkv_fused" in layer:  # its fused bias before the split (gpt2, bloom)
                qkv = _bias(qmm(h, layer["attn_qkv_fused"], out_dtype=dtype, gdot=gdot), layer,
                            "attn_qkv_fused_b")
        if qkv is not None:
            q, k, v = torch.split(qkv, (H * Dk, Hkv * Dk, Hkv * Dv), dim=-1)
        else:
            q, k, v = (qmm(h, layer[key], out_dtype=dtype, gdot=gdot)
                       for key in ("attn_q", "attn_k", "attn_v"))
        # qwen2, glm4, starcoder2, stablelm, phi2: biases on q, k and v (the
        # fused QKV's slices or apart)
        q, k, v = (_bias(t, layer, b) for t, b in ((q, "attn_q_b"), (k, "attn_k_b"),
                                                   (v, "attn_v_b")))
        q, k = q.reshape(T, H, Dk), k.reshape(T, Hkv, Dk)
        if cfg.qk_norm_full:  # olmo2: q and k normed whole, k before the cache
            q = rms_norm(q.reshape(T, H * Dk), layer.get("attn_q_norm"),
                         cfg.rms_eps).reshape(T, H, Dk)
            k = rms_norm(k.reshape(T, Hkv * Dk), layer.get("attn_k_norm"),
                         cfg.rms_eps).reshape(T, Hkv, Dk)
        elif cfg.qk_norm:  # qwen3: each head of q and k, k before the cache
            q = rms_norm(q, layer.get("attn_q_norm"), cfg.rms_eps)
            k = rms_norm(k, layer.get("attn_k_norm"), cfg.rms_eps)
        q = apply_rope(q, cos_t, sin_t, rope.mode, rope.n_dims)
        ring = dual and is_swa  # the layer's cache is the ring
        widx, lkeep = (swa_write_idx, keep_swa) if ring else (write_idx, keep)
        kv_write(kv_k[il], widx, k, lkeep)  # K enters unroped
        kv_write(kv_v[il], widx, v.reshape(T, Hkv, Dv), lkeep)
        cos_c, sin_c, cos_cf, sin_cf, cpos_f = tab_swa if ring else tab
        lbias = bias_swa if is_swa else bias
        if unfused:
            k_all = apply_rope(kv_read(kv_k[il], dtype), cos_c, sin_c, rope.mode, rope.n_dims)
            att = attention(q, k_all, kv_read(kv_v[il], dtype), lbias, scale,
                            softcap=cfg.attn_softcap, alibi_slopes=slopes, cell_pos=cpos_f,
                            tok_pos=tok_pos_f)
        else:
            q_rot = None if alibi else rope_companion(q, rope.mode, rope.n_dims).contiguous()
            att = fattn(q.contiguous(), q_rot, kv_k[il], kv_v[il], cos_cf, sin_cf, lbias, scale,
                        softcap=cfg.attn_softcap, alibi_slopes=slopes, tok_pos=tok_pos_f,
                        cell_pos=cpos_f)
        att = att.reshape(T, H * Dv)
        if use_chain and tail_eligible(layer):
            out = layer_tail(att, x, layer["ffn_norm"], layer["attn_output"],
                             layer["ffn_gateup_fused"], layer["ffn_down"], eps=cfg.rms_eps,
                             act=cfg.act, compute_dtype=dtype)
            if out is not None:
                x = out
                continue
        if "attn_sub_norm" in layer:  # bitnet: a norm before o_proj
            att = rms_norm(att, layer["attn_sub_norm"], cfg.rms_eps)
        attn_out = _bias(qmm(att, layer["attn_output"], out_dtype=dtype, gdot=gdot), layer,
                         "attn_output_b")
        if "attn_post_norm" in layer:  # gemma2, glm4, olmo2: a norm before the residual
            attn_out = norm(attn_out, layer["attn_post_norm"], cfg)
        if cfg.residual_scale != 1.0:  # granite, minicpm
            attn_out = attn_out * cfg.residual_scale
        if cfg.parallel_residual:
            # the parallel block: the FFN reads its own norm of the layer's
            # input (gptneox) or the attention's normed input (command-r)
            h2 = norm(x, layer["ffn_norm"], cfg, layer.get("ffn_norm_b")) \
                if "ffn_norm" in layer else h
        else:
            x = x + attn_out
            h2 = norm(x, layer.get("ffn_norm"), cfg, layer.get("ffn_norm_b")) \
                if ("ffn_norm" in layer or cfg.nonparam_norm) else x
        if cfg.n_expert > 0 and "ffn_gate_inp" in layer:
            ffn_out = moe_ffn(h2, layer, cfg)
            if "ffn_up_shexp" in layer:  # the shared expert (qwen2moe)
                shared = ffn(h2, {"ffn_gate": layer.get("ffn_gate_shexp"),
                                  "ffn_up": layer["ffn_up_shexp"],
                                  "ffn_down": layer["ffn_down_shexp"]}, cfg, dtype, gdot)
                if "ffn_gate_inp_shexp" in layer:  # its sigmoid gate
                    gate = torch.sigmoid(qmm(h2, layer["ffn_gate_inp_shexp"]).float())
                    shared = (shared.float() * gate).to(shared.dtype)
                ffn_out = ffn_out + shared
        else:
            ffn_out = ffn(h2, layer, cfg, dtype, gdot)
        if "ffn_post_norm" in layer:
            ffn_out = norm(ffn_out, layer["ffn_post_norm"], cfg)
        if cfg.residual_scale != 1.0:
            ffn_out = ffn_out * cfg.residual_scale
        # the reference's order of the parallel sum: (x + ffn_out) + attn_out
        x = x + ffn_out + attn_out if cfg.parallel_residual else x + ffn_out

    out_w = params.get("output")
    out_w = params["tok_embd"] if out_w is None else out_w
    norm_w = params.get("output_norm")
    logits = None
    if use_chain and norm_w is not None and is_kmajor_qt(out_w):
        # fused final norm + lm_head: norm only the output rows
        hs_pre = x[out_idx]
        logits = norm_mm(hs_pre, norm_w, out_w, eps=cfg.rms_eps, compute_dtype=dtype,
                         out_dtype=torch.float32)
        if logits is not None:
            hs = rms_norm(hs_pre, norm_w, cfg.rms_eps)
    if logits is None:
        hs = norm(x, norm_w, cfg, params.get("output_norm_b"))[out_idx]
        logits = qmm(hs, out_w, gdot=gdot)
    if params.get("output_b") is not None:  # phi2, gptj
        logits = logits + params["output_b"].to(logits.dtype)
    if cfg.logit_scale != 1.0:  # granite, minicpm, command-r
        logits = logits * cfg.logit_scale
    if cfg.final_softcap > 0.0:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits, hs.float()
