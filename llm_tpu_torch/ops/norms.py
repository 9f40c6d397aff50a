"""RMS and layer normalization (ggml RMS_NORM / NORM semantics: f32
accumulation, eps inside the sqrt). Counterpart of
llm_tpu/ops/norms.py::rms_norm and ::layer_norm."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None, eps: float) -> torch.Tensor:
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """x minus its mean, times the reciprocal square root of the centred
    x's variance plus eps, in f32; then the weight and the bias where given
    (olmo's non-parametric norm has neither)."""
    xf = x.float()
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    out = xc * torch.reciprocal(torch.sqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps))
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
