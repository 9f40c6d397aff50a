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
leaves as [L, ...] tensors. This module reads no llm_tpu code.
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


def config_from_reference(cfg) -> ModelConfig:
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
