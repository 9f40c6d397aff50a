"""The mixture-of-experts FFN's grouped dispatch on one device.
Counterpart of the single-device half of llm_tpu/parallel/moe.py
(dispatch_tables, _cap_from_cf, _expert_ffn, _grouped_block,
moe_ffn_grouped); its expert-parallel moe_ffn_ep waits for the port's
meshes (ROADMAP Queue 1 item 10).

A step of more than 8 tokens (models/transformer.py::moe_ffn) compacts its
(token, k) assignments into per-expert buckets and runs each expert's FFN
once over its bucket's rows, so each expert's planes are read once a step
instead of once an assignment. Capacity C = T is exact (a token's k experts
are distinct); a capacity factor cf > 0 caps a bucket at
min(T, max(8, ceil(cf * T * k / E))) rows and drops the assignments past
it, the first C of an expert in (token, k) order kept.

The reference pads every bucket to C rows and masks the padding; the port
runs only each expert's routed rows, which the padding rows add nothing to.
The sum is the reference's: each expert's contribution y * w added into an
f32 [T, D], experts 0..E-1 in order. The buckets' sizes are read on the
host (one sync a call), which the decode path at T <= 8 never does.
"""

from __future__ import annotations

import torch

from ..ops.qmatmul import qmm
from ..quant.qtensor import QTensor, StackedWeight


def n_experts(stack) -> int:
    """E of an expert stack: a stacked-expert QTensor or a dense [E, N, K]."""
    return (stack.qs if isinstance(stack, QTensor) else stack).shape[0]


def expert_ffn(x: torch.Tensor, w_up, w_gate, w_down, e: torch.Tensor, act, dtype
               ) -> torch.Tensor:
    """The FFN of expert e (int tensor [1] on the stacks' device) over x
    [.., D]: the reference's _expert_ffn, each matmul a qmm on the expert
    sliced out of its stack. Returns [.., D] f32."""
    up = qmm(x, StackedWeight(w_up, e), dtype=dtype)
    if w_gate is not None:
        g = act(qmm(x, StackedWeight(w_gate, e), dtype=dtype).float())
        cur = (g * up.float()).to(dtype)
    else:
        cur = act(up.float()).to(dtype)
    return qmm(cur, StackedWeight(w_down, e), dtype=dtype)


def dispatch_tables(topi: torch.Tensor, topw: torch.Tensor, E: int, cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (token, k) assignments of topi [T, k] to experts 0..E-1,
    compacted into per-expert buckets of cap slots in (token, k) order:
    (tok_table [E, cap] int32, the token or -1; w_table [E, cap] f32, the
    combine weight from topw [T, k]; dropped, int32 [], the assignments
    past a bucket's capacity). The reference's dispatch_tables with e_base
    0 and e_local E (its expert shards wait for the port's meshes)."""
    T, k = topi.shape
    dev = topi.device
    flat_e = topi.long().reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(E, device=dev)[None, :]).int()
    slot = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=1)  # rank in bucket
    over = slot >= cap
    dropped = over.sum(dtype=torch.int32)
    kept = ~over
    tok = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)
    tok_table = torch.full((E, cap), -1, dtype=torch.int32, device=dev)
    tok_table[flat_e[kept], slot[kept]] = tok[kept]
    w_table = torch.zeros((E, cap), dtype=torch.float32, device=dev)
    w_table[flat_e[kept], slot[kept]] = topw.reshape(-1).float()[kept]
    return tok_table, w_table, dropped


def cap_from_cf(cf: float, T: int, k: int, E: int) -> int:
    """A bucket's capacity for capacity factor cf: T (exact) when cf <= 0,
    else min(T, max(8, ceil(cf * T * k / E))) (the reference's
    _cap_from_cf, cf given: the Context folds it into the config)."""
    return T if cf <= 0 else min(T, max(8, -(-int(cf * T * k) // E)))


def grouped_block(h: torch.Tensor, w_up, w_gate, w_down, topi: torch.Tensor,
                  topw: torch.Tensor, act, cap: int, dtype) -> torch.Tensor:
    """The grouped FFN of every expert of the stacks over h [T, D]: [T, D]
    f32, each expert's bucket rows through its FFN, y * w added in expert
    order."""
    T, D = h.shape
    E = n_experts(w_up)
    tok_table, w_table, _ = dispatch_tables(topi, topw, E, cap)
    # a bucket's rows fill its first slots: its size is its count of tokens
    sizes = (tok_table >= 0).sum(dim=1).tolist()
    eids = torch.arange(E, dtype=torch.int32, device=h.device)
    acc = torch.zeros((T, D), dtype=torch.float32, device=h.device)
    for e, n in enumerate(sizes):
        if n == 0:
            continue
        rows = tok_table[e, :n].long()
        y = expert_ffn(h[rows], w_up, w_gate, w_down, eids[e:e + 1], act, dtype)
        acc.index_add_(0, rows, y.float() * w_table[e, :n, None])
    return acc


def moe_ffn_grouped(h: torch.Tensor, w_up, w_gate, w_down, topi: torch.Tensor,
                    topw: torch.Tensor, act, cf: float = 0.0) -> torch.Tensor:
    """The token-routed grouped MoE FFN of h [T, D] on one device: w_* the
    expert stacks (stacked-expert QTensors or dense [E, N, K]; w_gate may
    be None), topi [T, k] the experts, topw [T, k] f32 their weights, the
    buckets' capacity cap_from_cf(cf). Returns [T, D] f32."""
    cap = cap_from_cf(cf, h.shape[0], topi.shape[1], n_experts(w_up))
    return grouped_block(h, w_up, w_gate, w_down, topi, topw, act, cap, h.dtype)
