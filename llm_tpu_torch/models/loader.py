"""Build model params (a dict of QTensors and dense tensors) from a GGUF
file. Counterpart of llm_tpu/models/loader.py, for the llama tensors (also
those of gemma, baichuan, refact and qwen2 / qwen3, which name theirs as
llama does), gemma2's post-norms (attn_post_norm, ffn_post_norm, the
names llm_tpu's converter writes; llama.cpp's own post_attention_norm /
post_ffw_norm are refused, ROADMAP "Faults in the reference"), qwen2's
QKV biases (attn_{q,k,v}_b), qwen3's qk-norms (attn_q_norm, attn_k_norm),
bitnet's sub-norms (attn_sub_norm, ffn_sub_norm), phi3's fused QKV
(attn_qkv, as attn_qkv_fused), the gate+up that phi3 and glm4 pack into
ffn_up (as ffn_gateup_fused, the reference loader's rule), glm4's and
olmo2's post-norms (attn_post_norm, ffn_post_norm: the names llm_tpu's
converter writes for both), the LayerNorm graphs' biases (each under its
tensor's key + "_b": the norms', o_proj's, up's, gate's and down's, and
the fused QKV's as attn_qkv_fused_b), the learned positions
(position_embd as pos_embd, dense f32 [n_ctx, n_embd]), the embedding norm
(token_embd_norm as tok_norm, tok_norm_b) and the output norm's and
lm_head's biases (output_norm_b, output_b), and a
mixture-of-experts layer's router (ffn_gate_inp, and exp_probs_b as
ffn_exp_probs_b), expert stacks (ffn_{gate,up,down}_exps) and shared
expert (ffn_{gate,up,down}_shexp, ffn_gate_inp_shexp).

Quantized matrices become K-major QTensor planes (the embedding table
keeps the rows layout, and a 3-D expert stack rows-layout planes with a
leading expert dim, quant/qtensor.py::expert_qtensor_from_gguf);
F32/F16/BF16 matrices stay dense [N, K] (expert stacks [E, N, K]); norms,
biases and rope factors are f32 vectors. QKV and gate+up are fused into single
QTensors when their recipes match, so each runs as one kernel launch. With
scan_layers, uniform layers are stacked into one dict of [L, ...] leaves
(stack_layers) for the scan decoder, whose matmuls read a layer of the
stacked planes through K7 (not a mixture-of-experts model's, which runs per
layer as in the reference).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..quant.codecs import dequantize_dense
from ..quant.qtensor import (PLANE_TYPES, QTensor, concat_qtensors, dequantize_qtensor,
                             expert_qtensor_from_gguf, qtensor_from_gguf)
from .config import ModelConfig, config_from_gguf

_BLK_RE = re.compile(r"^blk\.(\d+)\.(.+?)\.(weight|bias)$")
_LAYER_MATS = ("attn_q", "attn_k", "attn_v", "attn_qkv", "attn_output", "ffn_gate", "ffn_up",
               "ffn_down", "ffn_gate_inp", "ffn_gate_shexp", "ffn_up_shexp",
               "ffn_down_shexp", "ffn_gate_inp_shexp")
_LAYER_VECS = ("attn_norm", "ffn_norm", "attn_post_norm", "ffn_post_norm", "attn_q_norm",
               "attn_k_norm", "attn_sub_norm", "ffn_sub_norm")
_LAYER_STACKS = ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")
# biases, each under its tensor's key + "_b" (the fused QKV's under
# attn_qkv_fused_b, the expert-selection bias exp_probs_b.bias under
# ffn_exp_probs_b, as the reference loader keys them)
_LAYER_BIASES = {"attn_q": "attn_q_b", "attn_k": "attn_k_b", "attn_v": "attn_v_b",
                 "exp_probs_b": "ffn_exp_probs_b", "attn_qkv": "attn_qkv_fused_b",
                 "attn_output": "attn_output_b", "ffn_up": "ffn_up_b", "ffn_gate": "ffn_gate_b",
                 "ffn_down": "ffn_down_b", "attn_norm": "attn_norm_b", "ffn_norm": "ffn_norm_b"}
# the model's vectors and dense tables outside the layers, by tensor name
_TOP_VECS = {"output_norm.weight": "output_norm", "output_norm.bias": "output_norm_b",
             "output.bias": "output_b", "token_embd_norm.weight": "tok_norm",
             "token_embd_norm.bias": "tok_norm_b", "rope_freqs.weight": "rope_freqs"}
_DENSE = (GGMLType.F32, GGMLType.F16, GGMLType.BF16)
# archs whose GGUF packs [gate; up] into ffn_up (llm_tpu/models/loader.py)
GATEUP_PACKED_ARCHS = ("phi3", "glm4")


def layer_key(base: str, arch: str) -> str:
    """The params key of a layer matrix: fused QKV as attn_qkv_fused, and
    ffn_up as ffn_gateup_fused where the arch packs gate+up into it."""
    if base == "attn_qkv":
        return "attn_qkv_fused"
    if base == "ffn_up" and arch in GATEUP_PACKED_ARCHS:
        return "ffn_gateup_fused"
    return base


def _vector(reader: GGUFReader, name: str, device) -> torch.Tensor:
    ti = reader.tensors[name]
    arr = dequantize_dense(reader.data(name), ti.ggml_type, ti.shape).reshape(-1)
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)


def _dense(reader: GGUFReader, name: str, dense_dtype, device) -> torch.Tensor:
    """A dense tensor in numpy order [(E,) N, K]: F32/F16/BF16 as stored, a
    quantized type dequantized in f32 from its planes (q - zp) * s - m (the
    reference's use_planes=False, llm_tpu/models/loader.py::_to_dense)."""
    ti = reader.tensors[name]
    if ti.ggml_type in _DENSE:
        arr = torch.from_numpy(np.ascontiguousarray(
            dequantize_dense(reader.data(name), ti.ggml_type, ti.shape)))
    elif ti.ggml_type in PLANE_TYPES:
        shape = tuple(int(d) for d in ti.shape)
        qt = (expert_qtensor_from_gguf(reader.data(name), ti.ggml_type, shape)
              if len(shape) == 3 else
              qtensor_from_gguf(reader.data(name), ti.ggml_type, shape, kmajor=False))
        arr = dequantize_qtensor(qt)
    else:
        raise NotImplementedError(f"{name}: type {ti.ggml_type.name} is not on the port's path")
    return arr.to(device, dense_dtype)


def _matrix(reader: GGUFReader, name: str, dense_dtype, device,
            kmajor: bool = True, use_planes: bool = True):
    ti = reader.tensors[name]
    if use_planes and ti.ggml_type in PLANE_TYPES and len(ti.shape) == 2:
        return qtensor_from_gguf(reader.data(name), ti.ggml_type, ti.shape,
                                 device=device, kmajor=kmajor)
    return _dense(reader, name, dense_dtype, device)


def _expert_stack(reader: GGUFReader, name: str, dense_dtype, device,
                  use_planes: bool = True):
    """A 3-D expert stack ne = (K, N, E): stacked-expert planes, or dense
    [E, N, K]."""
    ti = reader.tensors[name]
    if use_planes and ti.ggml_type in PLANE_TYPES:
        return expert_qtensor_from_gguf(reader.data(name), ti.ggml_type, ti.shape, device=device)
    return _dense(reader, name, dense_dtype, device)


def fuse_projections(layers: list[dict]) -> None:
    """Fuse QKV and gate+up into single K-major QTensors when the quant
    recipes match; the forward slices the fused outputs."""
    for layer in layers:
        for keys, fused_key in ((("attn_q", "attn_k", "attn_v"), "attn_qkv_fused"),
                                (("ffn_gate", "ffn_up"), "ffn_gateup_fused")):
            if not all(isinstance(layer.get(k), QTensor) for k in keys):
                continue
            fused = concat_qtensors([layer[k] for k in keys])
            if fused is not None:
                layer[fused_key] = fused
                for k in keys:
                    del layer[k]


_QT_META = ("group_size", "ggml_type", "layout", "zp", "pack_tk", "kmajor")


def stack_layers(layers: list[dict]) -> dict | None:
    """Per-layer dicts -> one dict whose leaves carry a leading layer dim
    [L, ...] (QTensor planes stacked, meta kept), for the scan decoder. None
    unless the layers are uniform: the same keys, each leaf the same shape
    and dtype in every layer, and each QTensor the same meta and presence of
    mins (llm_tpu/models/loader.py::stack_layers, whose tree map refuses the
    same)."""
    if not layers:
        return None
    keys = list(layers[0])
    if any(set(layer) != set(keys) for layer in layers):
        return None

    def stack(ts):
        if any(t.shape != ts[0].shape or t.dtype != ts[0].dtype for t in ts):
            raise ValueError("leaves differ")
        return torch.stack(ts)

    out = {}
    try:
        for key in keys:
            vals = [layer[key] for layer in layers]
            v0 = vals[0]
            if isinstance(v0, QTensor):
                if any(not isinstance(v, QTensor) or (v.mins is None) != (v0.mins is None)
                       or any(getattr(v, f) != getattr(v0, f) for f in _QT_META)
                       for v in vals):
                    return None
                out[key] = QTensor(
                    stack([v.qs for v in vals]), stack([v.scales for v in vals]),
                    None if v0.mins is None else stack([v.mins for v in vals]),
                    v0.group_size, v0.ggml_type, v0.layout, v0.zp, v0.pack_tk, v0.kmajor)
            elif isinstance(v0, torch.Tensor) and all(isinstance(v, torch.Tensor)
                                                      for v in vals):
                out[key] = stack(vals)
            else:
                return None
    except ValueError:
        return None
    return out


def scan_stack(layers: list[dict], cfg: ModelConfig) -> dict | None:
    """stack_layers for the scan decoder, which runs no model with a
    sliding-window pattern (gemma2) or experts: their layers stay per
    layer, as the reference's scan takes neither."""
    return None if cfg.swa_pattern or cfg.n_expert else stack_layers(layers)


def load_params(reader: GGUFReader, dense_dtype=torch.bfloat16, device="cuda",
                fuse: bool = True, scan_layers: bool = False,
                use_planes: bool = True) -> tuple[dict, ModelConfig]:
    """Returns (params, cfg); the layout is documented in
    models/transformer.py::forward. use_planes False: every quantized
    matrix dequantized to dense dense_dtype at load (the CLI's --no-planes).
    scan_layers: stack uniform layers into
    params["layers_stacked"] (params["layers"] then empty); layers that
    scan_stack refuses stay per layer, as in the reference."""
    cfg = config_from_gguf(reader)
    layers: list[dict] = [{} for _ in range(cfg.n_layers)]
    params: dict = {"layers": layers}
    for name in reader.tensors:
        m = _BLK_RE.match(name)
        if m:
            il, base, kind = int(m.group(1)), m.group(2), m.group(3)
            if kind == "weight" and base in _LAYER_MATS:
                layers[il][layer_key(base, cfg.arch)] = _matrix(reader, name, dense_dtype,
                                                                device, use_planes=use_planes)
            elif kind == "weight" and base in _LAYER_STACKS:
                layers[il][base] = _expert_stack(reader, name, dense_dtype, device, use_planes)
            elif kind == "weight" and base in _LAYER_VECS:
                layers[il][base] = _vector(reader, name, device)
            elif kind == "bias" and base in _LAYER_BIASES:
                layers[il][_LAYER_BIASES[base]] = _vector(reader, name, device)
            else:
                raise NotImplementedError(f"{name}: not on the port's llama path")
        elif name == "token_embd.weight":
            params["tok_embd"] = _matrix(reader, name, dense_dtype, device, kmajor=False,
                                         use_planes=use_planes)
        elif name == "output.weight":
            params["output"] = _matrix(reader, name, dense_dtype, device,
                                       use_planes=use_planes)
        elif name in _TOP_VECS:
            params[_TOP_VECS[name]] = _vector(reader, name, device)
        elif name == "position_embd.weight":
            params["pos_embd"] = _dense(reader, name, torch.float32, device)
        else:
            raise NotImplementedError(f"{name}: not on the port's llama path")
    if "output" not in params:
        # tied lm_head: a K-major copy of the embedding table for the kernel
        tok = params["tok_embd"]
        params["output"] = (_matrix(reader, "token_embd.weight", dense_dtype, device)
                            if isinstance(tok, QTensor) else tok)
    if fuse:
        fuse_projections(layers)
    if scan_layers:
        stacked = scan_stack(layers, cfg)
        if stacked is not None:
            params["layers_stacked"] = stacked
            params["layers"] = []
    return params, cfg
