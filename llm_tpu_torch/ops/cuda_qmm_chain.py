"""K6: a chain of quantized matmuls with their glue in one launch.
Counterpart of llm_tpu/ops/pallas_qmm_chain.py (qmm_chain -> _chain_kernel,
with its wrappers layer_tail and norm_mm and its gates).

    layer tail:  y1 = att @ Wo;  h = x_res + y1;  hn = rmsnorm(h) * gamma
                 gu = hn @ Wgu;  cur = silu(g) * u;  out = h + cur @ Wd
    norm + mm:   out = (rmsnorm(x) * gamma) @ W

The dtype walk is the reference's (the unfused path's): h = x_res +
cdtype(y1) rounded to cdtype, hn = cdtype(rms(f32 h) * gamma), cur =
cdtype(silu(g) * u) from the f32 gu, out = h + cdtype(y3), or the f32 y
cast to out_dtype. Each phase is the port's K1/K2 function (qmm_plain;
the CUDA kernel shares their GEMV loop): weights dequantized in f32 and
the mins correction in f32, where the TPU kernel rounds (q - zp) * s and
the corrections' operands to bf16.

`qmm_chain_plain` is the chain in plain PyTorch, `qmm_chain_cuda`
launches csrc/qmm_chain.cu, and `qmm_chain` dispatches on the device of x:
CPU tensors take the plain version, CUDA tensors the kernel (which raises
rather than fall back). `layer_tail` / `norm_mm` return None where the
geometry gate says no, on both devices alike, and the caller runs the
unfused path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..quant.qtensor import QTensor
from . import cuda_build
from .cuda_qmm import check_planes, qmm_plain
from .norms import rms_norm

# launches of the kernel, counted where the wrapper launches it
LAUNCHES = {"K6": 0}
# rows the kernel takes: the chain serves decode steps (T <= 8)
CHAIN_MAX_B = 8
PRE = {"cast": 0, "norm": 1, "res_norm": 2, "swiglu": 3}

def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def is_kmajor_qt(w) -> bool:
    return isinstance(w, QTensor) and w.kmajor


def tail_eligible(layer: dict) -> bool:
    """The layer's tail is the llama recipe the chain implements: o_proj,
    fused gate+up, down and ffn_norm, K-major planes (the reference's
    tail_eligible). The reference also refuses biases, post-norms, LoRA and
    MoE; forward's check_supported refuses every such layer before it runs."""
    if any(k not in layer for k in
           ("attn_output", "ffn_gateup_fused", "ffn_down", "ffn_norm")):
        return False
    return all(is_kmajor_qt(layer[k])
               for k in ("attn_output", "ffn_gateup_fused", "ffn_down"))


def head_eligible(layer: dict) -> bool:
    """The layer head is rmsnorm -> fused QKV (check_supported refuses
    biases and LoRA, as the reference's head_eligible does)."""
    if "attn_qkv_fused" not in layer or "attn_norm" not in layer:
        return False
    return is_kmajor_qt(layer["attn_qkv_fused"])


def chain_fits(qts) -> bool:
    """The tiling gate of the reference's plan_phases: a shared N tile of
    128 or more (every N % 128 == 0), a K tile that is a multiple of the
    256-row pack tile (every K % 256 == 0), p4 planes packed at 256. The
    reference also shrinks its tiles to fit the TPU's scoped VMEM, which
    the card has no counterpart of."""
    for qt in qts:
        if qt.out_features % 128 or qt.in_features % 256:
            return False
        if qt.layout == "p4" and qt.pack_tk != 256:
            return False
    return True


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
        elif pre == "swiglu":
            g, u = prev.chunk(2, dim=-1)
            xin = (F.silu(g) * u).to(cdtype)
        else:
            raise ValueError(pre)
        prev = qmm_plain(xin, qt, cdtype)
    if final == "add_res":
        return h + prev.to(cdtype)
    return prev.to(out_dtype or cdtype)


class _PhaseDesc(ctypes.Structure):
    """csrc/qmm_chain.cu::PhaseDesc."""
    _fields_ = [("qs", ctypes.c_void_p), ("scales", ctypes.c_void_p),
                ("mins", ctypes.c_void_p), ("gamma", ctypes.c_void_p),
                ("acc", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("K", "N", "gs", "zp", "p4", "scales_bf16", "pre",
                                    "ntiles", "ksplit", "upc")]


def _lib():
    lib = cuda_build.load("qmm_chain")
    fn = lib.qmm_chain_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.qmm_chain_grid.argtypes = [ctypes.c_int]
        lib.qmm_chain_grid.restype = ctypes.c_int
    return lib


def chain_grid(B: int) -> int:
    """CTAs of K6's cooperative grid for B rows on this card."""
    return _lib().qmm_chain_grid(B)


def qmm_chain_cuda(x: torch.Tensor, qts, gammas=(), x_res: torch.Tensor | None = None, *,
                   pres, eps: float, final: str = "cast", out_dtype=None) -> torch.Tensor:
    """Launch K6 on the card: x bf16 [B, K0] (B <= 8), the chain in bf16."""
    B = x.shape[0]
    out_dtype = out_dtype or torch.bfloat16
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("qmm_chain_cuda: x must be a contiguous bf16 CUDA tensor")
    if not 1 <= B <= CHAIN_MAX_B or not 1 <= len(qts) <= 3 or len(pres) != len(qts):
        raise ValueError(f"qmm_chain_cuda: B={B} (1..{CHAIN_MAX_B}), {len(qts)} phases (1..3)")
    if out_dtype not in (torch.bfloat16, torch.float32) or (
            final == "add_res" and out_dtype != torch.bfloat16):
        raise ValueError(f"qmm_chain_cuda: out_dtype {out_dtype}")
    if not chain_fits(qts):
        raise ValueError("qmm_chain_cuda: a phase's N % 128 or K % 256 is not 0")
    if pres[0] not in ("cast", "norm") or any(p not in ("res_norm", "swiglu") for p in pres[1:]):
        raise ValueError(f"qmm_chain_cuda: boundaries {pres}: phase 0 reads x, the others "
                         "the previous phase")
    gam = iter(gammas)
    keep = []  # tensors the launch reads: alive until it is enqueued
    k_in = x.shape[1]
    for qt, pre in zip(qts, pres):
        k_in = k_in // 2 if pre == "swiglu" else k_in
        if qt.in_features != k_in:
            raise ValueError("qmm_chain_cuda: the phases' widths do not chain")
        check_planes(qt, B, k_in)
        k_in = qt.out_features
    N0, N_last = qts[0].out_features, qts[-1].out_features
    if "res_norm" in pres or final == "add_res":
        if x_res is None or not x_res.is_cuda or x_res.dtype != torch.bfloat16 \
                or not x_res.is_contiguous() or tuple(x_res.shape) != (B, N0):
            raise ValueError("qmm_chain_cuda: x_res must be a contiguous bf16 CUDA tensor "
                             "[B, N0]")
    if final == "add_res" and N_last != N0:
        raise ValueError("qmm_chain_cuda: the residual's width differs from the output's")
    acc = torch.empty(sum(B * qt.out_features for qt in qts), dtype=torch.float32,
                      device=x.device)
    descs = (_PhaseDesc * len(qts))()
    off = 0
    for d, qt, pre in zip(descs, qts, pres):
        g = None
        if pre in ("norm", "res_norm"):
            g = next(gam).to(device=x.device, dtype=torch.float32).contiguous()
            if g.numel() != qt.in_features:
                raise ValueError("qmm_chain_cuda: gamma's width differs from the phase's K")
            keep.append(g)
        d.qs, d.scales = qt.qs.data_ptr(), qt.scales.data_ptr()
        d.mins = qt.mins.data_ptr() if qt.mins is not None else None
        d.gamma = g.data_ptr() if g is not None else None
        d.acc = acc.data_ptr() + 4 * off
        d.K, d.N, d.gs, d.zp = qt.in_features, qt.out_features, qt.group_size, qt.zp
        d.p4, d.scales_bf16 = int(qt.layout == "p4"), int(qt.scales.dtype == torch.bfloat16)
        d.pre = PRE[pre]
        off += B * qt.out_features
    out = torch.empty((B, N_last), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().qmm_chain_launch(
        descs, len(qts), x.data_ptr(), x_res.data_ptr() if x_res is not None else None,
        out.data_ptr(), int(out_dtype == torch.float32), int(final == "add_res"), B,
        float(eps), stream)
    cuda_build.check(rc, "qmm_chain_launch")
    LAUNCHES["K6"] += 1
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


def layer_tail(att, x_res, ffn_gamma, wo, wgu, wd, *, eps, compute_dtype=torch.bfloat16):
    """One-launch decoder-layer tail:
    out = h + swiglu(rmsnorm(h := x_res + att @ Wo) @ Wgu) @ Wd,
    or None when the geometry gate says no. SwiGLU only: check_supported
    refuses every other activation."""
    if not chain_fits((wo, wgu, wd)):
        return None
    return qmm_chain(att, (wo, wgu, wd), (ffn_gamma,), x_res,
                     pres=("cast", "res_norm", "swiglu"), eps=eps, final="add_res",
                     cdtype=compute_dtype)


def norm_mm(x, gamma, w, *, eps, compute_dtype=torch.bfloat16, out_dtype=None):
    """One-launch rmsnorm + quantized matmul, (rmsnorm(x) * gamma) @ W: the
    attn_norm -> QKV head and the final norm -> lm_head. None when the
    geometry gate says no."""
    if not chain_fits((w,)):
        return None
    return qmm_chain(x, (w,), (gamma,), None, pres=("norm",), eps=eps, final="cast",
                     cdtype=compute_dtype, out_dtype=out_dtype)
