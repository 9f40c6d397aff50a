"""Cache-aware attention mask and the unfused attention. Counterpart of
llm_tpu/ops/attention.py.

The mask is computed from the cache's cell metadata (positions and
sequence bit-sets), never built on the host. K is cached unroped and
rotated on read, so context shift is a metadata edit.

Sequence bit-sets: the host keeps [S, W] uint32 words (32 sequences per
word). torch's uint32 supports few ops, so the device copy holds the same
32-bit words widened to int64; shifts and masks on int64 are exact.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")
# calls of the unfused attention (the route of heads that are no multiple
# of 8 or past 256, of group-scaled q8_0 caches, and of ALiBi steps the
# narrow kernels do not take): no kernel, counted beside the flash
# kernels' launches
LAUNCHES = {"unfused": 0}


def build_attn_bias(tok_pos: torch.Tensor, tok_seq: torch.Tensor,
                    cell_pos: torch.Tensor, cell_seq_bits: torch.Tensor,
                    swa_window: int = 0, causal: bool = True) -> torch.Tensor:
    """Additive f32 bias [T, S]: 0 where attention is allowed, -inf
    elsewhere. cell_seq_bits: [S, W] int64 words of 32 sequence bits each.
    Unused cells have no bits set and are masked. swa_window > 0: a token
    sees only cells less than the window behind it (the reference's
    is_masked_swa: tok_pos - cell_pos >= window is masked)."""
    tok_seq = tok_seq.long()
    word = cell_seq_bits[:, tok_seq >> 5].T  # [T, S]
    allowed = ((word >> (tok_seq[:, None] & 31)) & 1) > 0
    if causal:
        allowed = allowed & (cell_pos[None, :] <= tok_pos[:, None])
    if swa_window > 0:
        allowed = allowed & ((tok_pos[:, None] - cell_pos[None, :]) < swa_window)
    bias = torch.zeros(allowed.shape, dtype=torch.float32, device=allowed.device)
    return bias.masked_fill_(~allowed, NEG_INF)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor, scale: float, softcap: float = 0.0,
              alibi_slopes: torch.Tensor | None = None,
              cell_pos: torch.Tensor | None = None,
              tok_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-query attention with an f32 softmax over roped keys.
    q [T, H, D]; k [S, Hkv, D]; v [S, Hkv, Dv]; bias [T, S]. Returns
    [T, H, Dv] f32. Head h reads KV head h // (H // Hkv). softcap > 0:
    scores = tanh(scores / softcap) * softcap after the scale, before the
    bias (gemma2). alibi_slopes [H] with cell_pos [S] and tok_pos [T]:
    scores -= slope_h * (tok_pos - cell_pos) in f32 after the bias, as the
    reference's unfused attention does (ggml's soft_max_ext max_bias
    path)."""
    LAUNCHES["unfused"] += 1
    T, H, D = q.shape
    S, Hkv, _ = k.shape
    rep = H // Hkv
    qf = q.float().reshape(T, Hkv, rep, D)
    scores = torch.einsum("tgrd,sgd->tgrs", qf, k.float()) * scale
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores + bias[:, None, None, :]
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(Hkv, rep)
        dist = (tok_pos[:, None] - cell_pos[None, :]).float()
        scores = scores - slopes[None, :, :, None] * dist[:, None, None, :]
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(scores - m)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("tgrs,sgd->tgrd", p, v.float())
    return out.reshape(T, H, -1)
