"""On-device sampling for the batched generation loop. Counterpart of
llm_tpu/samplers/device.py.

Mirrors the host chain's standard-dist subset, TopK -> TopP -> MinP ->
Temp -> Dist (build_chain's order, itself llama.cpp's common_sampler_init
order), as torch ops on the logits' device over a batch of rows with
PER-ROW parameters.

The candidate set is prefiltered to the top K_CAP logits of a row. The
result is EXACTLY the host chain whenever top_k is in [1, K_CAP] (the
device-eligibility rule; llama.cpp's default top_k = 40 qualifies): TopK
runs first, so no later sampler can bring back a candidate outside the
top-k prefix. Greedy rows (temp <= 0) take a full-row argmax.

Draws: each row has its own torch.Generator on the logits' device, seeded
from the row's seed; a draw is the Gumbel-max of the processed logits with
uniforms from that generator (an exact draw from their softmax). The host
Dist sampler draws from numpy streams and llm_tpu from JAX's counter-based
PRNG: the same distributions, different streams, so sampled SEQUENCES of
the three differ (each reproducible under its own seed). Greedy rows are
bit-identical to the host chain.
"""

from __future__ import annotations

import torch

# top-logit prefilter width; device eligibility requires top_k <= K_CAP
K_CAP = 256


def device_eligible(p) -> bool:
    """True when SamplingParams p reduces to the on-device subset: the
    standard dist chain with every stateful or host-only modifier at its
    no-op default, and a top_k that makes the K_CAP prefilter exact.
    (Greedy, temp <= 0, is always eligible modulo the same modifiers.)"""
    clean = (
        p.mirostat == 0
        and not p.grammar
        and not p.logit_bias
        and p.penalty_repeat == 1.0
        and p.penalty_freq == 0.0
        and p.penalty_present == 0.0
        and p.dry_multiplier == 0.0
        and p.xtc_probability == 0.0
        and p.typical_p >= 1.0
        and p.dynatemp_range <= 0.0
        and p.top_n_sigma < 0
        and p.min_keep <= 1
    )
    if not clean:
        return False
    if p.temp <= 0.0:
        return True
    return 1 <= p.top_k <= K_CAP


def process_rows(lg: torch.Tensor, temp: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, min_p: torch.Tensor):
    """Apply TopK -> TopP -> MinP -> Temp to [B, V] logits with per-row
    parameters ([B] tensors on lg's device). Returns (vals, idx): vals
    [B, K] processed logits in descending pre-mask order (-inf = removed),
    idx [B, K] token ids.

    Per-sampler semantics mirror samplers/chain.py (min_keep = 1):
      TopK:  k <= 0 or k >= V is a no-op, else keep the k largest.
      TopP:  renormalize over survivors, keep the smallest prefix whose
             cumulative probability reaches p (inclusive); p >= 1 no-op.
      MinP:  drop logits below max_logit + log(p); p <= 0 no-op. The top
             candidate always survives.
      Temp:  divide by temp (the caller guarantees temp > 0 for sampled rows).
    """
    B, V = lg.shape
    K = min(K_CAP, V)
    lg = lg.float()
    vals, idx = torch.topk(lg, K, dim=-1)
    ar = torch.arange(K, device=lg.device)[None, :]
    neg = torch.full_like(vals, float("-inf"))

    k_eff = torch.where((top_k > 0) & (top_k < V), torch.clamp(top_k, max=K),
                        torch.full_like(top_k, K))
    vals = torch.where(ar < k_eff[:, None], vals, neg)

    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=lg.device),
                        cum[:, :-1] < top_p[:, None]], dim=1)
    keep_p |= top_p[:, None] >= 1.0
    vals = torch.where(keep_p, vals, neg)

    thresh = vals[:, :1] + torch.log(torch.clamp(min_p, min=1e-30))[:, None]
    keep_m = (min_p[:, None] <= 0.0) | (vals >= thresh)
    vals = torch.where(keep_m, vals, neg)

    vals = vals / torch.clamp(temp, min=1e-6)[:, None]
    return vals, idx


def row_generators(seeds, device) -> list[torch.Generator]:
    """One torch.Generator a row on `device`, seeded from the row's seed."""
    gens = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(s) & 0xFFFFFFFFFFFFFFFF)
        gens.append(g)
    return gens


def sample_rows(lg: torch.Tensor, temp: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor, min_p: torch.Tensor, gens) -> torch.Tensor:
    """One token a row of lg [B, V] (int64 [B] on lg's device). Rows with
    temp <= 0 take the full-row argmax (host Greedy); the others draw from
    the processed candidate set with their own generator (gens[b])."""
    greedy = torch.argmax(lg, dim=-1)
    vals, idx = process_rows(lg, temp, top_k, top_p, min_p)
    u = torch.stack([torch.rand(vals.shape[1], generator=g, device=lg.device) for g in gens])
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20, max=1.0 - 1e-7)))
    choice = torch.argmax(vals + gumbel, dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    return torch.where(temp <= 0.0, greedy, sampled)
