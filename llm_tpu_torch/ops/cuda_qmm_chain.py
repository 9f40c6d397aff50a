"""K6: a chain of quantized matmuls with their glue in one launch.
Counterpart of llm_tpu/ops/pallas_qmm_chain.py (qmm_chain -> _chain_kernel,
with its wrappers layer_tail and norm_mm and its gates).

    layer tail:  y1 = att @ Wo;  h = x_res + y1;  hn = rmsnorm(h) * gamma
                 gu = hn @ Wgu;  cur = act(g) * u;   out = h + cur @ Wd
    norm + mm:   out = (rmsnorm(x) * gamma) @ W

act is silu (the "swiglu" boundary) or gelu's tanh form (the "geglu"
boundary: gemma), the reference's _act_f32. The dtype walk is the
reference's (the unfused path's): h = x_res + cdtype(y1) rounded to
cdtype, hn = cdtype(rms(f32 h) * gamma), cur = cdtype(act(g) * u) from the
f32 gu, out = h + cdtype(y3), or the f32 y cast to out_dtype. Each phase is the port's K1/K2 function (qmm_plain; the
CUDA kernel runs the decode GEMV's CTA body, exact integer products with s
and m applied per group in f32), where the TPU kernel rounds (q - zp) * s
and the corrections' operands to bf16.

`qmm_chain_plain` is the chain in plain PyTorch, `qmm_chain_cuda`
launches csrc/qmm_chain.cu (one cooperative launch of thread block
clusters of qmm_chain_tc, or of qmm_chain_tc_gelu for a GeGLU tail,
counted apart as K6_gelu, or of qmm_chain_tc_g16 where a phase's nibble
planes have group size 16, counted as K6_gs16, qmm_chain_tc_g256 where
they have group size 256 (K6_gs256), qmm_chain_tc_g8 where a phase's
int8 planes have group size 8 (K6_gs8); `chain_plan` picks each
phase's K split within a cluster), and
`qmm_chain` dispatches on the device of x: CPU tensors take the plain
version, CUDA tensors the kernel (which raises rather than fall back).
`layer_tail` / `norm_mm` return None where the geometry gate says no, on
both devices alike, and the caller runs the unfused path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..quant.qtensor import QTensor
from . import cuda_build
from .cuda_qmm import DECODE_TILE_N, DECODE_UNIT_K, _check_decode, check_planes, qmm_plain
from .norms import rms_norm

# launches of the kernels, counted where the wrapper launches them: K6 the
# SwiGLU kernel (every head and lm_head, and llama's tails), K6_gelu the
# GeGLU one (gemma's tails), K6_gs16 the kernel of a chain with a phase on
# nibble planes at group size 16 (Q2_K, Q3_K), K6_gs256 one with a phase
# on nibble planes at group size 256 (TQ1_0, TQ2_0), K6_gs8 one with a
# phase on int8 planes at group size 8 (IQ1_M), each with either act
LAUNCHES = {"K6": 0, "K6_gelu": 0, "K6_gs16": 0, "K6_gs256": 0, "K6_gs8": 0}
# rows the kernel takes: the chain serves decode steps (T <= 8)
CHAIN_MAX_B = 8
PRE = {"cast": 0, "norm": 1, "res_norm": 2, "swiglu": 3, "geglu": 4}
# the gated boundaries and their activations (the reference's _act_f32)
GLU = {"swiglu": F.silu, "geglu": lambda g: F.gelu(g, approximate="tanh")}
# the boundary of the tail's last phase for the FFN's activation
GLU_OF_ACT = {"silu": "swiglu", "gelu": "geglu"}
EPI = {"f32": 0, "bf16": 1, "res": 2}
# the kernel's grid: as many clusters of C CTAs as the card holds at once
# (qmm_chain_clusters; two CTAs an SM), C one of CHAIN_CLUSTERS, picked with
# each phase's K split by chain_plan
CHAIN_CLUSTERS = (4, 6, 8)
# chain_plan's cost of a work item beyond its stages, in stages (the ring's
# fill and the group's reduction), fitted to tools/gemm_splits.py --chain on
# an H100 (PERF.md)
CHAIN_ITEM_UNITS = 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def is_kmajor_qt(w) -> bool:
    return isinstance(w, QTensor) and w.kmajor


# layer keys that put a tail outside the chain's recipe (the reference's
# _TAIL_BANNED): gemma2's post-norms among them
TAIL_BANNED = (
    "attn_sub_norm", "attn_post_norm", "ffn_post_norm", "ffn_sub_norm",
    "ffn_norm_exps", "ffn_gate_inp", "attn_output_b", "ffn_down_b",
    "ffn_norm_b", "attn_output.lora", "ffn_down.lora",
    "ffn_gateup_fused.lora", "ffn_up_b", "ffn_gate_b", "cross_attn_norm",
)


def tail_eligible(layer: dict) -> bool:
    """The layer's tail is the llama recipe the chain implements: o_proj,
    fused gate+up, down and ffn_norm, K-major planes, and none of
    TAIL_BANNED (the reference's tail_eligible: biases, post-norms, LoRA and
    MoE; of these the port's forward runs gemma2's post-norms and the MoE
    router ffn_gate_inp)."""
    if any(k not in layer for k in
           ("attn_output", "ffn_gateup_fused", "ffn_down", "ffn_norm")):
        return False
    if any(k in layer for k in TAIL_BANNED):
        return False
    return all(is_kmajor_qt(layer[k])
               for k in ("attn_output", "ffn_gateup_fused", "ffn_down"))


# layer keys that put a head outside the chain's recipe (the reference's
# _HEAD_BANNED): qwen2's QKV biases among them
HEAD_BANNED = (
    "attn_qkv_fused_b", "attn_q_b", "attn_k_b", "attn_v_b", "attn_norm_b",
    "attn_qkv_fused.lora",
)


def head_eligible(layer: dict) -> bool:
    """The layer head is rmsnorm -> fused QKV with none of HEAD_BANNED (the
    reference's head_eligible: no biases, no LoRA)."""
    if "attn_qkv_fused" not in layer or "attn_norm" not in layer:
        return False
    if any(k in layer for k in HEAD_BANNED):
        return False
    return is_kmajor_qt(layer["attn_qkv_fused"])


def chain_fits(qts) -> bool:
    """The tiling gate of the reference's plan_phases: a shared N tile of
    128 or more (every N % 128 == 0), a K tile that is a multiple of the
    256-row pack tile (every K % 256 == 0), p4 planes packed at 256. The
    reference also shrinks its tiles to fit the TPU's scoped VMEM, which
    the card has no counterpart of. And one of K6's kernels takes every
    phase (chain_kernel): no chain mixes group sizes 16, 256 and 8, which
    no GGUF recipe does."""
    for qt in qts:
        if qt.out_features % 128 or qt.in_features % 256:
            return False
        if qt.layout == "p4" and qt.pack_tk != 256:
            return False
    return chain_kernel(qts) is not None


def qmm_chain_plain(x: torch.Tensor, qts, gammas=(), x_res: torch.Tensor | None = None, *,
                    pres, eps: float, final: str = "cast", cdtype=torch.bfloat16,
                    out_dtype=None) -> torch.Tensor:
    """The chain step by step: x [B, K0] -> [B, N_last]."""
    gam = iter(gammas)
    prev = h = None
    for qt, pre in zip(qts, pres):
        if pre == "cast":
            xin = x.to(cdtype)
        elif pre == "norm":
            xin = rms_norm(x.to(cdtype), next(gam), eps)
        elif pre == "res_norm":
            h = x_res.to(cdtype) + prev.to(cdtype)
            xin = rms_norm(h, next(gam), eps)
        elif pre in GLU:
            g, u = prev.chunk(2, dim=-1)
            xin = (GLU[pre](g) * u).to(cdtype)
        else:
            raise ValueError(pre)
        prev = qmm_plain(xin, qt, cdtype)
    if final == "add_res":
        return h + prev.to(cdtype)
    return prev.to(out_dtype or cdtype)


def _splits(units: int, cluster: int):
    """The K splits a phase may take: divisors of the cluster size that
    leave every CTA of a group at least one stage."""
    for split in range(1, cluster + 1):
        if cluster % split == 0 and (split - 1) * -(-units // split) < units:
            yield split


def _phase_plan(K: int, N: int, n_clusters: int, cluster: int) -> tuple[int, int, int]:
    """(cost, split, last split) of one phase of K x N on n_clusters clusters
    of `cluster` CTAs: the split CTAs of a group share a 128-column tile, a
    cluster's cluster / split groups take that many tiles a round; the tiles
    that the full rounds leave may take one more round at a larger split
    (the last split), so that its few tiles spread over more CTAs. The cost
    is the stages a CTA runs, a round's stages + CHAIN_ITEM_UNITS each. The
    fewest; ties go to the smaller splits."""
    tiles, units = -(-N // DECODE_TILE_N), -(-K // DECODE_UNIT_K)
    splits = list(_splits(units, cluster))
    best = None
    for split in splits:
        per_round = n_clusters * (cluster // split)
        item = -(-units // split) + CHAIN_ITEM_UNITS
        cands = [(-(-tiles // per_round) * item, split, split)]
        full, rest = divmod(tiles, per_round)
        cands += [(full * item + -(-units // last) + CHAIN_ITEM_UNITS, split, last)
                  for last in splits if last > split and full and rest
                  and rest <= n_clusters * (cluster // last)]
        for cand in cands:
            if best is None or cand[0] < best[0]:
                best = cand
    return best


def chain_plan(dims, n_clusters: dict) -> tuple[int, tuple[int, ...], tuple[int, ...]]:
    """(cluster size, each phase's K split, each phase's last split) for
    phases of (K, N), given the clusters the card holds at once for each
    cluster size ({C: clusters}): the cluster size whose phases cost the
    fewest stages a CTA in all (_phase_plan), ties to the smaller."""
    best = None
    for cluster in sorted(n_clusters):
        plans = [_phase_plan(K, N, n_clusters[cluster], cluster) for K, N in dims]
        cost = sum(p[0] for p in plans)
        if best is None or cost < best[0]:
            best = (cost, cluster, tuple(p[1] for p in plans), tuple(p[2] for p in plans))
    return best[1:]


def chain_items(K: int, N: int, split: int, n_clusters: int, cluster: int, last=None):
    """The work items of one phase as the kernel deals them: (cluster, rank,
    round, tile, first stage, end stage) of every CTA that has one."""
    last = split if last is None else last
    tiles, units = -(-N // DECODE_TILE_N), -(-K // DECODE_UNIT_K)
    per_round = n_clusters * (cluster // split)
    full = -(-tiles // per_round) if last == split else tiles // per_round
    for k in range(full + (last != split)):
        sp = split if k < full else last
        upr = -(-units // sp)
        for q in range(n_clusters):
            for rank in range(cluster):
                grp, kr = divmod(rank, sp)
                u0 = min(units, kr * upr)
                u1 = min(units, u0 + upr)
                tile = min(k, full) * per_round + q * (cluster // sp) + grp
                if tile < tiles:
                    yield q, rank, k, tile, u0, u1


class _ChainPhase(ctypes.Structure):
    """csrc/qmm_chain.cu::ChainPhase."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("qs", "scales", "mins", "gamma", "src", "x",
                                               "y", "res")] + [
        (n, ctypes.c_int) for n in ("K", "N", "gs", "zp", "p4", "scales_bf16", "pre", "epi",
                                    "split", "split_last")]


_CLUSTERS: dict = {}


def _lib():
    lib = cuda_build.load("qmm_chain")
    fn = lib.qmm_chain_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.qmm_chain_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.qmm_chain_clusters.restype = ctypes.c_int
    return lib


# K6's kernels (csrc/qmm_chain.cu::chain_kernel), by their launch count
KERNEL_KINDS = {"K6": 0, "K6_gelu": 1, "K6_gs16": 2, "K6_gs256": 3, "K6_gs8": 4}


def chain_kernel(qts, gelu: bool = False) -> str | None:
    """The kernel (its LAUNCHES key) a chain of these phases launches:
    K6_gs16, K6_gs256 or K6_gs8 where a phase's planes take a group-size
    form of their own (nibble planes at 16 or 256, int8 planes at 8), else
    K6_gelu for a GeGLU boundary, else K6. None where phases of two of those
    forms meet: no kernel takes them."""
    forms = {f"K6_gs{qt.group_size}" for qt in qts
             if (qt.layout == "p4" and qt.group_size in (16, 256))
             or (qt.layout != "p4" and qt.group_size == 8)}
    if len(forms) > 1:
        return None
    return forms.pop() if forms else ("K6_gelu" if gelu else "K6")


def chain_clusters(kernel: str = "K6") -> dict:
    """{cluster size: clusters the card holds at once} for the grid of K6's
    kernel `kernel` (chain_kernel), every CTA resident."""
    if kernel not in _CLUSTERS:
        counts = {}
        for c in CHAIN_CLUSTERS:
            n = _lib().qmm_chain_clusters(c, KERNEL_KINDS[kernel])
            if n < 1:
                raise RuntimeError(f"qmm_chain_clusters: the card holds no cluster of {c} of "
                                   f"{kernel}'s CTAs")
            counts[c] = n
        _CLUSTERS[kernel] = counts
    return _CLUSTERS[kernel]


def launch_plan(qts, gelu: bool = False) -> tuple[int, tuple[int, ...], tuple[int, ...]]:
    """The (cluster size, splits, last splits) K6 launches these phases
    with on this card (gelu: a GeGLU boundary), on its kernel's grid."""
    return chain_plan(tuple((qt.in_features, qt.out_features) for qt in qts),
                      chain_clusters(chain_kernel(qts, gelu)))


def qmm_chain_cuda(x: torch.Tensor, qts, gammas=(), x_res: torch.Tensor | None = None, *,
                   pres, eps: float, final: str = "cast", out_dtype=None) -> torch.Tensor:
    """Launch K6 on the card: x bf16 [B, K0] (B <= 8), the chain in bf16."""
    return _chain_launch(x, qts, gammas, x_res, pres=pres, eps=eps, final=final,
                         out_dtype=out_dtype)


def _chain_launch(x, qts, gammas=(), x_res=None, *, pres, eps, final="cast", out_dtype=None,
                  plan=None):
    """qmm_chain_cuda with the (cluster size, splits[, last splits]) given
    (chain_plan's when None; tools/gemm_splits.py times the others)."""
    B = x.shape[0]
    bf = torch.bfloat16
    out_dtype = out_dtype or bf
    if not x.is_cuda or x.dtype != bf or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("qmm_chain_cuda: x must be a contiguous, 16-byte aligned bf16 CUDA "
                         "tensor")
    P = len(qts)
    if not 1 <= B <= CHAIN_MAX_B or not 1 <= P <= 3 or len(pres) != P:
        raise ValueError(f"qmm_chain_cuda: B={B} (1..{CHAIN_MAX_B}), {P} phases (1..3)")
    if out_dtype not in (bf, torch.float32) or (final == "add_res" and out_dtype != bf):
        raise ValueError(f"qmm_chain_cuda: out_dtype {out_dtype}")
    if not chain_fits(qts):
        raise ValueError("qmm_chain_cuda: a phase's N % 128 or K % 256 is not 0")
    if pres[0] not in ("cast", "norm") or any(p not in ("res_norm", *GLU) for p in pres[1:]) \
            or len({p for p in pres if p in GLU}) > 1:
        raise ValueError(f"qmm_chain_cuda: boundaries {pres}: phase 0 reads x, the others "
                         "the previous phase, with one activation")
    gelu = "geglu" in pres
    k_in = x.shape[1]
    for qt, pre in zip(qts, pres):
        k_in = k_in // 2 if pre in GLU else k_in
        if qt.in_features != k_in:
            raise ValueError("qmm_chain_cuda: the phases' widths do not chain")
        check_planes(qt, B, k_in)
        _check_decode(qt)
        k_in = qt.out_features
    N0 = qts[0].out_features
    if "res_norm" in pres or final == "add_res":
        if x_res is None or not x_res.is_cuda or x_res.dtype != bf \
                or not x_res.is_contiguous() or tuple(x_res.shape) != (B, N0):
            raise ValueError("qmm_chain_cuda: x_res must be a contiguous bf16 CUDA tensor "
                             "[B, N0]")
    if any(pres[p + 1] == "res_norm" and qts[p].out_features != N0 for p in range(P - 1)):
        raise ValueError("qmm_chain_cuda: the residual's width differs from h's")
    if final == "add_res" and ("res_norm" not in pres or qts[-1].out_features != N0):
        raise ValueError("qmm_chain_cuda: add_res needs the h of a res_norm boundary and the "
                         "residual's width")
    cluster, splits, *lasts = launch_plan(qts, gelu) if plan is None else plan
    lasts = lasts[0] if lasts else splits
    dev = x.device
    gam = iter(gammas)
    keep = []  # tensors the launch reads: alive until it is enqueued
    descs = (_ChainPhase * P)()
    prev = h = out = None
    for p, (d, qt, pre) in enumerate(zip(descs, qts, pres)):
        K, N = qt.in_features, qt.out_features
        if pre == "cast":
            xin = x
        else:
            d.src = (x if pre == "norm" else prev).data_ptr()
            xin = torch.empty((B, K), dtype=bf, device=dev)
        if pre in ("norm", "res_norm"):
            g = next(gam).to(device=dev, dtype=torch.float32).contiguous()
            if g.numel() != K:
                raise ValueError("qmm_chain_cuda: gamma's width differs from the phase's K")
            if g.data_ptr() % 16:
                g = g.clone()
            keep.append(g)
            d.gamma = g.data_ptr()
        # the output as what follows reads it: h for a res_norm, gu for a
        # swiglu or geglu, the chain's out for the last phase
        nxt = pres[p + 1] if p + 1 < P else None
        if nxt == "res_norm":
            y = h = torch.empty((B, N), dtype=bf, device=dev)
            d.epi, d.res = EPI["res"], x_res.data_ptr()
        elif nxt in GLU:
            y = torch.empty((B, N), dtype=torch.float32, device=dev)
            d.epi = EPI["f32"]
        else:
            y = out = torch.empty((B, N), dtype=out_dtype, device=dev)
            if final == "add_res":
                d.epi, d.res = EPI["res"], h.data_ptr()
            else:
                d.epi = EPI["f32" if out_dtype == torch.float32 else "bf16"]
        keep += [xin, y]
        d.qs, d.scales = qt.qs.data_ptr(), qt.scales.data_ptr()
        d.mins = qt.mins.data_ptr() if qt.mins is not None else None
        d.x, d.y = xin.data_ptr(), y.data_ptr()
        d.K, d.N, d.gs, d.zp = K, N, qt.group_size, qt.zp
        d.p4, d.scales_bf16 = int(qt.layout == "p4"), int(qt.scales.dtype == bf)
        d.pre, d.split, d.split_last = PRE[pre], splits[p], lasts[p]
        prev = y
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().qmm_chain_launch(descs, P, B, float(eps), cluster, stream)
    cuda_build.check(rc, "qmm_chain_launch")
    LAUNCHES[chain_kernel(qts, gelu)] += 1
    return out


def qmm_chain(x, qts, gammas=(), x_res=None, *, pres, eps, final="cast",
              cdtype=torch.bfloat16, out_dtype=None):
    """The chain by device: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.is_cuda:
        if cdtype != torch.bfloat16:
            raise ValueError("the CUDA chain kernel computes in bf16")
        return qmm_chain_cuda(x.to(torch.bfloat16).contiguous(), qts, gammas,
                              None if x_res is None else x_res.to(torch.bfloat16).contiguous(),
                              pres=pres, eps=eps, final=final, out_dtype=out_dtype)
    return qmm_chain_plain(x, qts, gammas, x_res, pres=pres, eps=eps, final=final,
                           cdtype=cdtype, out_dtype=out_dtype)


def layer_tail(att, x_res, ffn_gamma, wo, wgu, wd, *, eps, act="silu",
               compute_dtype=torch.bfloat16):
    """One-launch decoder-layer tail:
    out = h + glu(rmsnorm(h := x_res + att @ Wo) @ Wgu) @ Wd, glu(gu) =
    act(g) * u with act "silu" (SwiGLU, K6) or "gelu" (GeGLU, K6_gelu), or
    None when the geometry gate says no."""
    if not chain_fits((wo, wgu, wd)):
        return None
    return qmm_chain(att, (wo, wgu, wd), (ffn_gamma,), x_res,
                     pres=("cast", "res_norm", GLU_OF_ACT[act]), eps=eps, final="add_res",
                     cdtype=compute_dtype)


def norm_mm(x, gamma, w, *, eps, compute_dtype=torch.bfloat16, out_dtype=None):
    """One-launch rmsnorm + quantized matmul, (rmsnorm(x) * gamma) @ W: the
    attn_norm -> QKV head and the final norm -> lm_head. None when the
    geometry gate says no."""
    if not chain_fits((w,)):
        return None
    return qmm_chain(x, (w,), (gamma,), None, pres=("norm",), eps=eps, final="cast",
                     cdtype=compute_dtype, out_dtype=out_dtype)
