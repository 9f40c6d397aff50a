"""Carry weights across from the JAX package's parameter layout.

`params_from_reference(params, cfg)` takes llm_tpu's params and config
already turned into plain Python by the caller: arrays as numpy arrays,
quantized weights as objects or dicts with the QTensor fields (qs, scales,
mins, group_size, ggml_type, layout, zp, pack_tk, kmajor), the config as
an object or dict with the ModelConfig fields. It returns the port's
(params, cfg) on the CPU, so both packages compute the same model. A
scan-mode tree (params["layers_stacked"], params["layers"] empty, as
llm_tpu's Context(scan_layers=True) and stack_layers make it) keeps its
stacked layout: QTensor leaves with [L, ...] planes and their meta, small
leaves as [L, ...] tensors. A mixture-of-experts layer's stacked-expert
QTensors (rows-layout planes with a leading expert dim [E, ...]) and dense
[E, N, K] stacks come across as they are, and so do the config's expert
fields; so do layer vectors such as bitnet's sub-norms (attn_sub_norm,
ffn_sub_norm) and its act "relu2", and the knobs of the RMS-norm llama
graphs (embedding_scale, residual_scale, logit_scale, qk_norm_full, a
partial rope's n_dims), and those of the LayerNorm graphs (norm_kind,
parallel_residual, nonparam_norm, attn_bias) with their bias vectors,
learned positions (pos_embd) and embedding norm (tok_norm); cohere2's
nope_global_layers comes across too, for the forward to refuse. This
module reads no llm_tpu code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .gguf.constants import GGMLType
from .models.config import ModelConfig
from .ops.rope import RopeParams
from .quant.qtensor import QTensor

_QT_FIELDS = ("qs", "scales", "mins", "group_size", "ggml_type", "layout", "zp",
              "pack_tk", "kmajor")


def _get(obj, name, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from JAX
        return torch.from_numpy(a.view(np.uint16).astype(np.int32) << 16).view(
            torch.float32).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _is_qtensor(obj) -> bool:
    return all((k in obj) if isinstance(obj, dict) else hasattr(obj, k)
               for k in ("qs", "scales", "group_size", "layout"))


def _convert(obj):
    if obj is None:
        return None
    if _is_qtensor(obj):
        mins = _get(obj, "mins")
        return QTensor(
            qs=_tensor(_get(obj, "qs")), scales=_tensor(_get(obj, "scales")),
            mins=None if mins is None else _tensor(mins),
            group_size=int(_get(obj, "group_size")),
            ggml_type=GGMLType(int(_get(obj, "ggml_type"))),
            layout=str(_get(obj, "layout")), zp=int(_get(obj, "zp", 0)),
            pack_tk=int(_get(obj, "pack_tk", 256)), kmajor=bool(_get(obj, "kmajor", True)))
    if isinstance(obj, dict):
        return {k: _convert(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_convert(v) for v in obj]
    return _tensor(obj)


# the reference ModelConfig's fields that the port's config does not model,
# with the reference's defaults (llm_tpu/models/config.py): a config that
# sets one of them describes a graph the port would run wrongly (fused_tp:
# shard-major fused QKV and gate+up planes, which the port would split as
# segment-major), so config_from_reference refuses it
UNMODELED_DEFAULTS = {
    "qk_norm_ln": False, "rope_swa": None, "swa_chunked": False, "attn_temp_scale": 0.0,
    "attn_temp_floor": 8192, "qk_l2_norm": False, "expert_weight_before": False,
    "ssm_d_conv": 0, "ssm_d_inner": 0, "ssm_d_state": 0, "ssm_dt_rank": 0,
    "ssm_n_group": 0, "ssm_dt_b_c_rms": False, "wkv_head_size": 0, "rescale_every_n": 0,
    "q_lora_rank": 0, "qk_rope_dim": 0, "t5_rel_buckets": 0, "dec_start_token": -1,
    "moe_every_n": 0, "altup_n": 0, "altup_act": 0, "n_embd_altup": 0, "n_kv_layers": 0,
    "act_sparsity": None, "swa_layers": None, "n_heads_list": None,
    "n_kv_heads_list": None, "fused_tp": 1,
}
_MISSING = object()


def config_from_reference(cfg) -> ModelConfig:
    """The port's ModelConfig for a reference config. Raises
    NotImplementedError when a field the port does not model is set off the
    reference's default."""
    for name, default in UNMODELED_DEFAULTS.items():
        value = _get(cfg, name, _MISSING)
        if value is not _MISSING and value != default:
            raise NotImplementedError(f"config field {name}={value!r} is not ported yet "
                                      f"(the port runs only {name}={default!r})")
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {name: _get(cfg, name) for name in fields if _get(cfg, name) is not None}
    rope = _get(cfg, "rope")
    rfields = [f.name for f in dataclasses.fields(RopeParams)]
    kw["rope"] = RopeParams(**{n: _get(rope, n) for n in rfields if _get(rope, n) is not None})
    if kw.get("rope_sections") is not None:
        kw["rope_sections"] = tuple(kw["rope_sections"])
    return ModelConfig(**kw)


def params_from_reference(params, cfg) -> tuple[dict, ModelConfig]:
    out = {k: _convert(v) for k, v in dict(params).items()}
    return out, config_from_reference(cfg)
