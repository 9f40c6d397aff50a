"""Sampling: composable sampler chain + params-driven construction
(parity: common/sampling.cpp common_sampler_init chain order).

The port's own copy of llm_tpu/samplers/__init__.py (numpy, on the host).
The device-side batched sampler (llm_tpu/samplers/device.py) comes with the
server slice (ROADMAP Queue 1 item 7)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .chain import (
    XTC,
    Candidates,
    Chain,
    Dist,
    Dry,
    Greedy,
    LogitBias,
    MinP,
    MirostatV1,
    MirostatV2,
    Penalties,
    Sampler,
    Temp,
    TempExt,
    TopK,
    TopNSigma,
    TopP,
    Typical,
)


@dataclass
class SamplingParams:
    """common_params_sampling analogue (common/common.h)."""

    seed: int = 0xFFFFFFFF
    n_prev: int = 64
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typical_p: float = 1.0
    temp: float = 0.8
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    top_n_sigma: float = -1.0
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_penalty_last_n: int = -1
    dry_sequence_breakers: tuple = ()
    mirostat: int = 0  # 0 off, 1 v1, 2 v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    min_keep: int = 0
    logit_bias: dict = field(default_factory=dict)
    grammar: str = ""


def build_chain(params: SamplingParams, n_vocab: int, grammar_sampler=None) -> Chain:
    """Standard chain order from common_sampler_init."""
    p = params
    min_keep = max(1, p.min_keep)
    samplers: list[Sampler] = []
    if p.logit_bias:
        samplers.append(LogitBias(p.logit_bias))
    samplers.append(
        Penalties(p.penalty_last_n, p.penalty_repeat, p.penalty_freq, p.penalty_present)
    )
    if p.dry_multiplier > 0:
        samplers.append(
            Dry(p.dry_multiplier, p.dry_base, p.dry_allowed_length,
                p.dry_penalty_last_n, tuple(p.dry_sequence_breakers))
        )
    if grammar_sampler is not None:
        samplers.append(grammar_sampler)

    if p.mirostat == 1:
        samplers.append(Temp(p.temp))
        samplers.append(MirostatV1(n_vocab, p.mirostat_tau, p.mirostat_eta, seed=p.seed))
    elif p.mirostat == 2:
        samplers.append(Temp(p.temp))
        samplers.append(MirostatV2(p.mirostat_tau, p.mirostat_eta, seed=p.seed))
    elif p.temp <= 0.0:
        samplers.append(Greedy())
    else:
        if p.top_n_sigma >= 0:
            samplers.append(TopK(p.top_k))
            samplers.append(Temp(p.temp))
            samplers.append(TopNSigma(p.top_n_sigma))
        else:
            samplers.append(TopK(p.top_k))
            samplers.append(Typical(p.typical_p, min_keep))
            samplers.append(TopP(p.top_p, min_keep))
            samplers.append(MinP(p.min_p, min_keep))
            if p.xtc_probability > 0:
                samplers.append(XTC(p.xtc_probability, p.xtc_threshold, min_keep, p.seed))
            samplers.append(TempExt(p.temp, p.dynatemp_range, p.dynatemp_exponent))
        samplers.append(Dist(p.seed))
    return Chain(samplers)


__all__ = [
    "Candidates", "Chain", "Dist", "Dry", "Greedy", "LogitBias", "MinP",
    "MirostatV1", "MirostatV2", "Penalties", "Sampler", "SamplingParams",
    "Temp", "TempExt", "TopK", "TopNSigma", "TopP", "Typical", "XTC",
    "build_chain",
]
