"""Rotary position embeddings with linear + YaRN scaling and per-dim
frequency factors (ggml_rope_ext semantics). Counterpart of
llm_tpu/ops/rope.py.

  * NORM (mode 0): rotate adjacent pairs (x[2i], x[2i+1]).
  * NEOX (mode 2): rotate split halves (x[i], x[i + n_rot/2]).
  * NONE (mode -1): no rotation (ALiBi and learned-position archs: the
    config sets n_dims = 0); the tables are empty and apply_rope is the
    identity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ROPE_TYPE_NONE = -1
ROPE_TYPE_NORM = 0
ROPE_TYPE_NEOX = 2


@dataclass(frozen=True)
class RopeParams:
    n_dims: int  # number of rotated dims (<= head_dim)
    mode: int = ROPE_TYPE_NEOX
    freq_base: float = 10000.0
    freq_scale: float = 1.0  # 1/scaling_factor for linear/yarn interp
    ext_factor: float = 0.0  # YaRN extrapolation mix (0 = off)
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    n_ctx_orig: int = 0  # original training context (YaRN)


def _yarn_corr_dims(p: RopeParams) -> tuple[float, float]:
    """ggml_rope_yarn_corr_dims: ramp window in rotated-dim index space."""

    def corr_dim(n_rot: float) -> float:
        return (p.n_dims * math.log(max(p.n_ctx_orig, 1) / (n_rot * 2 * math.pi))
                / (2 * math.log(p.freq_base)))

    start = math.floor(corr_dim(p.beta_fast))
    end = math.ceil(corr_dim(p.beta_slow))
    return max(0.0, start), min(float(p.n_dims - 1), end)


def rope_angles(positions: torch.Tensor, p: RopeParams,
                freq_factors=None) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 cos/sin tables of shape [*positions.shape, n_dims//2].
    freq_factors: optional per-dim divisors (llama3-style rope_freqs).
    n_dims = 0 (rope NONE): empty tables."""
    half = p.n_dims // 2
    if half == 0:
        empty = torch.zeros((*positions.shape, 0), dtype=torch.float32, device=positions.device)
        return empty, empty
    dim_idx = np.arange(half, dtype=np.float32)
    inv_freq = np.power(p.freq_base, -2.0 * dim_idx / p.n_dims).astype(np.float32)
    inv = torch.from_numpy(inv_freq).to(positions.device)
    if freq_factors is not None:
        ff = torch.as_tensor(freq_factors, dtype=torch.float32,
                             device=positions.device)
        inv = inv / ff[:half]
    theta_extrap = positions.to(torch.float32)[..., None] * inv
    theta_interp = p.freq_scale * theta_extrap
    mscale = p.attn_factor
    if p.ext_factor != 0.0:
        low, high = _yarn_corr_dims(p)
        y = (dim_idx - low) / max(0.001, high - low)
        ramp = torch.from_numpy(
            ((1.0 - np.clip(y, 0.0, 1.0)) * p.ext_factor).astype(np.float32)
        ).to(positions.device)
        theta = theta_interp * (1.0 - ramp) + theta_extrap * ramp
        mscale *= 1.0 + 0.1 * math.log(1.0 / p.freq_scale)
    else:
        theta = theta_interp
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               mode: int, n_dims: int) -> torch.Tensor:
    """Rotate the first n_dims of the last axis of x [..., heads, head_dim]
    in f32; cos/sin [..., n_dims//2] broadcast over heads. Mode NONE (or
    n_dims = 0) is the identity."""
    if mode == ROPE_TYPE_NONE or n_dims == 0:
        return x
    dtype = x.dtype
    rot, rest = x[..., :n_dims].float(), x[..., n_dims:]
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    if mode == ROPE_TYPE_NORM:
        x0, x1 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(rot.shape)
    elif mode == ROPE_TYPE_NEOX:
        half = n_dims // 2
        x0, x1 = rot[..., :half], rot[..., half:]
        out = torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    else:
        raise ValueError(f"unsupported rope mode {mode}")
    if n_dims < x.shape[-1]:
        out = torch.cat([out, rest.float()], dim=-1)
    return out.to(dtype)
