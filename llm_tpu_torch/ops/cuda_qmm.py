"""K1/K2: the fused dequantize x matmul, K5, its group-factored decode
form, and K7, any of them on one layer of depth-stacked planes. Counterpart
of llm_tpu/ops/pallas_qmm.py::qmm_pallas (K1: p4 planes, K2: i8 planes; K5:
qmm_pallas(gdot=True) -> _gdot_kernel; K7: qmm_pallas(lidx=...), whose
scalar-prefetch index maps pick the layer's blocks).

    y[b,n] = sum_k x[b,k] * (q[k,n] - zp) * s[k//gs,n] - sum_g xsum[b,g] * m[g,n]

x is rounded to the compute dtype (bf16 on the card), weights are
dequantized in f32 as (q - zp) * s, and the mins correction uses the f32
group sums of the rounded x. K5 computes the same sum as the TPU's gdot
kernel does: per quant group the dot of x with the raw nibbles, times s[g] in
f32, then the mins and zero-point terms from the group sums of x, their
operands rounded to the compute dtype. `qmm_plain` / `qmm_gdot_plain` are
these functions step by step in PyTorch. `qmm_cuda` launches, at B <= 16,
the decode GEMV of csrc/qmm_decode.cu (a library of its own: mma.sync on
exact integer operands over a TMA ring, K split over a thread block
cluster whose size `decode_plan` chooses, y written in the caller's
dtype), K1/K2's kernel or, with gdot, K5's, the same CTA with the
group-factored sum; at B > 16 the prefill GEMM of csrc/qmm.cu
(csrc/qmm_gemm.cuh, whose K split over CTAs `gemm_split` chooses). K7
computes exactly what K1/K2/K5 compute on layer idx of a StackedWeight: its
plain version is theirs on the layer's copy (`qmm_stacked_plain`), and
`qmm_stacked_cuda` launches the same kernels (the decode GEMV's stacked
entry points; the GEMM built apart, from csrc/qmm_stacked.cu) with the
stacked base pointers, the per-layer strides and a pointer to the device
index, which every CTA reads once. Nibble planes have group size 32, 16
(Q2_K, Q3_K: kernels of their own, counted as K1_gs16, K5_gs16, K7_gs16)
or 256 (TQ1_0, TQ2_0: K1_gs256, K5_gs256, K7_gs256); int8 planes 32, 16
or 8 (IQ1_M: kernels of their own, K2_gs8, K7_gs8).
`quant_matmul` dispatches on the device of x: CPU tensors take the plain
version, CUDA tensors the kernel (which raises rather than fall back).
"""

from __future__ import annotations

import ctypes

import torch

from ..device import full_f32
from ..quant.qtensor import QTensor, StackedWeight, slice_stacked
from . import cuda_build

# launches of each kernel, counted where the wrapper launches it; on nibble
# planes at group size 16 (Q2_K, Q3_K) K1, K5 and K7 run kernels of their
# own (qmm_decode_g16, qmm_decode_gdot_g16, qmm_wgmma_g16), counted apart,
# and so do K1, K5 and K7 on nibble planes at group size 256 (TQ1_0,
# TQ2_0: qmm_decode_g256, qmm_decode_gdot_g256, qmm_wgmma_g256) and K2 and
# K7 on int8 planes at group size 8 (IQ1_M: qmm_decode_g8, qmm_wgmma_g8)
LAUNCHES = {"K1": 0, "K2": 0, "K5": 0, "K7": 0, "K1_gs16": 0, "K5_gs16": 0, "K7_gs16": 0,
            "K1_gs256": 0, "K5_gs256": 0, "K7_gs256": 0, "K2_gs8": 0, "K7_gs8": 0}
# the group sizes each layout's kernels take
P4_GROUP_SIZES, I8_GROUP_SIZES = (16, 32, 256), (8, 16, 32)
# rows up to which the reference takes the group-factored path (and up to
# which K1/K2/K5/K7 run the decode GEMV, csrc/qmm_decode.cu)
GDOT_MAX_B = 16
# the decode GEMV: a CTA computes 128 columns of y over stages of 128 k; the
# CTAs of one column tile (a thread block cluster, at most 16) split K
DECODE_TILE_N, DECODE_UNIT_K, DECODE_MAX_CLUSTER = 128, 128, 16
# decode_plan's rule, fitted to a sweep of the cluster size at the LLAMA3_8B
# decode shapes at B = 1, 8 and 16 on an H100 (tools/gemm_splits.py,
# PERF.md): CTAs on every SM (p4; i8, whose CTA holds a ring of 88 KB of
# shared memory), at most 8 CTAs a cluster (portable), at least 4 stages a
# CTA
DECODE_CTAS_PER_SM = {"p4": 1.5, "i8": 0.75}
DECODE_PLAN_MAX_CLUSTER, DECODE_MIN_UNITS = 8, 4
# the prefill GEMM (csrc/qmm_gemm.cuh, B > 16): a tile is 256 columns x 128
# rows of y, a stage 128 k; an item is a tile over one of `split` K ranges
GEMM_TILE_N, GEMM_TILE_B, GEMM_UNIT_K = 256, 128, 128
GEMM_MAX_SPLIT = 32
# an item's epilogue, in stages of matrix work: plain stores, and 16-byte f32
# atomics into a zeroed y when K is split (fitted to a sweep of splits at the
# LLAMA3_8B prefill shapes on an H100, PERF.md)
GEMM_EPI_UNITS, GEMM_EPI_ATOMIC_UNITS = 1.5, 2.5


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def unpack_planes(qt: QTensor) -> torch.Tensor:
    """Integer planes (q - zp) as int16, K-major [K, N]."""
    if qt.layout != "p4":
        return qt.qs.to(torch.int16) - qt.zp
    kh, n = qt.qs.shape
    half = qt.pack_tk // 2
    p = qt.qs.reshape(kh // half, half, n).to(torch.int16)
    q = torch.stack([p & 0xF, p >> 4], dim=1)  # [tiles, {lo, hi}, half, N]
    return q.reshape(kh * 2, n) - qt.zp


def qmm_plain(x: torch.Tensor, qt: QTensor, cdtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x [B, K] -> y [B, N] f32."""
    assert qt.kmajor
    gs = qt.group_size
    xr = x.to(cdtype).float()
    q = unpack_planes(qt).float()
    K, N = q.shape
    w = (q.reshape(K // gs, gs, N) * qt.scales.float()[:, None, :]).reshape(K, N)
    with full_f32():
        y = xr @ w
        if qt.mins is not None:
            xsum = xr.reshape(xr.shape[0], K // gs, gs).sum(-1)
            y = y - xsum @ qt.mins.float()
    return y


def gemm_split(B: int, N: int, K: int, n_sm: int) -> int:
    """The prefill GEMM's K split for x [B, K] and N columns on n_sm SMs:
    the split that minimises the modelled time, the number of waves of
    items (tiles x split, one persistent CTA per SM) times an item's stages
    and epilogue; ties go to the smaller split. The launch owns the items
    and the grid."""
    tiles = -(-N // GEMM_TILE_N) * -(-B // GEMM_TILE_B)
    units = -(-K // GEMM_UNIT_K)
    best = None
    for split in range(1, min(units, GEMM_MAX_SPLIT) + 1):
        epi = GEMM_EPI_ATOMIC_UNITS if split > 1 else GEMM_EPI_UNITS
        cost = -(-tiles * split // n_sm) * (-(-units // split) + epi)
        if best is None or cost < best[0]:
            best = (cost, split)
    return best[1]


def decode_plan(K: int, N: int, B: int, n_sm: int, layout: str = "p4") -> tuple[int, int]:
    """The decode GEMV's (tile width, cluster size) for x [B <= 16, K] and N
    columns of `layout` planes on n_sm SMs: as many CTAs as
    DECODE_CTAS_PER_SM on every SM allow, at most DECODE_PLAN_MAX_CLUSTER a
    cluster and at least DECODE_MIN_UNITS stages of 128 k a CTA; then the
    fewest CTAs that give each the same number of stages (none without
    one). The kernel reads the planes once whatever B is, so B does not
    enter."""
    tiles = -(-N // DECODE_TILE_N)
    units = -(-K // DECODE_UNIT_K)
    target = min(DECODE_PLAN_MAX_CLUSTER, max(1, units // DECODE_MIN_UNITS),
                 max(1, int(DECODE_CTAS_PER_SM[layout] * n_sm) // tiles))
    per = -(-units // target)
    return DECODE_TILE_N, -(-units // per)


_SM_COUNT: dict = {}


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def _split(x: torch.Tensor, N: int, layout: str) -> int:
    """The prefill GEMM's K split (B > 16) or the decode GEMV's cluster size."""
    B, K = x.shape
    if B > GDOT_MAX_B:
        return gemm_split(B, N, K, sm_count(x.device))
    return decode_plan(K, N, B, sm_count(x.device), layout)[1]


def gdot_eligible(qt: QTensor, B: int) -> bool:
    """The reference's gate for the group-factored path (llm_tpu/ops/
    qmatmul.py::qmm under LLM_TPU_GDOT=force): p4 planes, at most
    GDOT_MAX_B rows, K a multiple of the pack tile. Shapes only, so both
    devices route alike."""
    return (qt.kmajor and qt.layout == "p4" and B <= GDOT_MAX_B
            and qt.in_features % 256 == 0)


def qmm_gdot_plain(x: torch.Tensor, qt: QTensor, cdtype=torch.bfloat16) -> torch.Tensor:
    """K5's function in plain PyTorch: x [B, K] -> y [B, N] f32."""
    assert qt.kmajor and qt.layout == "p4"
    gs = qt.group_size
    xr = x.to(cdtype).float()
    q = (unpack_planes(qt) + qt.zp).float()  # the raw nibbles 0..15
    K, N = q.shape
    B, G = xr.shape[0], K // gs
    xg3 = xr.reshape(B, G, gs)
    with full_f32():
        part = torch.bmm(xg3.transpose(0, 1), q.reshape(G, gs, N))  # [G, B, N]
        y = (part * qt.scales.float()[:, None, :]).sum(0)
        if qt.mins is not None or qt.zp:
            xg = xg3.sum(-1).to(cdtype).float()
            if qt.mins is not None:
                y = y - xg @ qt.mins.to(cdtype).float()
            if qt.zp:
                y = y - qt.zp * (xg @ qt.scales.to(cdtype).float())
    return y


def qmm_stacked_plain(x: torch.Tensor, sw: StackedWeight, cdtype=torch.bfloat16,
                      gdot: bool = False) -> torch.Tensor:
    """K7's function in plain PyTorch: K1/K2's (K5's with gdot) on layer
    sw.idx of the stacked planes."""
    return (qmm_gdot_plain if gdot else qmm_plain)(x, slice_stacked(sw.w, sw.idx), cdtype)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# entry points of each library: K1/K2 at B > 16 (csrc/qmm.cu), K7's
# (csrc/qmm_stacked.cu), K1/K2/K5/K7 at B <= 16 (csrc/qmm_decode.cu)
_ARGTYPES = {"qmm_decode": {"qmm_decode_launch": [_P] * 5 + [_I] * 9 + [_P],
                            "qmm_decode_stacked_launch": [_P] * 5 + [_I] * 9
                            + [_L, _L, _I, _P, _P],
                            "qmm_gdot_decode_launch": [_P] * 5 + [_I] * 8 + [_P],
                            "qmm_gdot_decode_stacked_launch": [_P] * 5 + [_I] * 8
                            + [_L, _L, _I, _P, _P]},
             "qmm": {"qmm_launch": [_P] * 5 + [_I] * 8 + [_P]},
             "qmm_stacked": {"qmm_stacked_launch": [_P] * 5 + [_I] * 8 + [_L, _L, _I, _P, _P]}}


def _lib(name: str = "qmm"):
    lib = cuda_build.load(name)
    fns = _ARGTYPES[name]
    if getattr(lib, next(iter(fns))).argtypes is None:
        for fname, args in fns.items():
            getattr(lib, fname).argtypes = args
            getattr(lib, fname).restype = ctypes.c_int
    return lib


def check_planes(qt: QTensor, B: int, K: int) -> None:
    """Raise unless the decode GEMV (csrc/qmm_decode.cu) or the prefill GEMM
    (csrc/qmm.cu) takes these planes for x [B, K] (the chained kernel's
    phases take the same)."""
    p4 = qt.layout == "p4"
    if not (qt.qs.is_cuda and qt.scales.is_cuda):
        raise ValueError("qmm_cuda needs CUDA tensors")
    if not qt.kmajor or qt.in_features != K:
        raise ValueError("qmm_cuda: weight must be K-major with K matching x")
    sdt = qt.scales.dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qmm_cuda: scales dtype {sdt}")
    for t in [qt.qs, qt.scales] + ([qt.mins] if qt.mins is not None else []):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qmm_cuda: planes must be contiguous and 16-byte aligned")
    if qt.mins is not None and qt.mins.dtype != sdt:
        raise ValueError("qmm_cuda: scales and mins must share a dtype")
    if p4:
        ok = qt.qs.dtype == torch.uint8 and qt.group_size in P4_GROUP_SIZES \
            and qt.pack_tk == 256 and K % 256 == 0
    else:
        ok = qt.qs.dtype == torch.int8 and qt.group_size in I8_GROUP_SIZES and K % 32 == 0
    if not ok or (B > 16 and K % 64):
        raise ValueError(f"qmm_cuda: unsupported planes layout={qt.layout} "
                         f"gs={qt.group_size} K={K} B={B}")


def _check_decode(qt: QTensor, gdot: bool = False) -> None:
    """The decode GEMV's integer operands: q - zp exact in bf16 (p4: 128 + zp
    as a bf16 of the nibbles' exponent; i8: |q - zp| <= 256). K5 applies
    either the mins or the zero-point correction (no GGUF type has both)."""
    if not (0 <= qt.zp <= 15 if qt.layout == "p4" else -128 <= qt.zp <= 128):
        raise ValueError(f"qmm_cuda: zero point {qt.zp} outside the decode GEMV's range")
    if gdot and qt.mins is not None and qt.zp:
        raise ValueError("qmm_cuda: K5 takes mins or a zero point, not both")


def _out(B: int, N: int, x: torch.Tensor, out_dtype) -> tuple[torch.Tensor, int]:
    """y for the decode GEMV (K1/K2/K5/K7 at B <= 16), which writes f32 or
    bf16 (other dtypes: f32, cast by the caller), and whether it is bf16."""
    bf16 = out_dtype == torch.bfloat16
    return torch.empty((B, N), dtype=torch.bfloat16 if bf16 else torch.float32,
                       device=x.device), int(bf16)


def kernel_name(name: str, qt: QTensor) -> str:
    """The LAUNCHES key of K1, K5 or K7 on these planes: K2 for K1 on int8
    planes; the group-size-16 and -256 forms' on such nibble planes (Q2_K,
    Q3_K; TQ1_0, TQ2_0), the group-size-8 form's on such int8 planes
    (IQ1_M)."""
    if qt.layout != "p4":
        name = "K2" if name == "K1" else name
        return f"{name}_gs8" if qt.group_size == 8 else name
    return f"{name}_gs{qt.group_size}" if qt.group_size in (16, 256) else name


def _cast(y: torch.Tensor, out_dtype) -> torch.Tensor:
    return y if out_dtype is None or y.dtype == out_dtype else y.to(out_dtype)


def qmm_cuda(x: torch.Tensor, qt: QTensor, gdot: bool = False, out_dtype=None) -> torch.Tensor:
    """Launch K1 (p4) or K2 (i8), or K5 with gdot. x bf16 [B, K] on the card;
    y in out_dtype (f32 when None): at B <= 16 the kernel writes bf16 or f32
    itself, above it f32 is cast."""
    return _qmm_launch(x, qt, gdot, None, out_dtype)


def _qmm_launch(x: torch.Tensor, qt: QTensor, gdot: bool, split: int | None,
                out_dtype=None) -> torch.Tensor:
    """qmm_cuda with the prefill GEMM's K split at B > 16, or the decode
    GEMV's cluster size at B <= 16, given (gemm_split's or decode_plan's
    when None; tools/gemm_splits.py times the others)."""
    B, K = x.shape
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("qmm_cuda: x must be a contiguous, 16-byte aligned bf16 CUDA tensor")
    check_planes(qt, B, K)
    N = qt.out_features
    p4 = qt.layout == "p4"
    if gdot and not gdot_eligible(qt, B):
        raise ValueError(f"qmm_cuda: K5 takes p4 planes at B <= {GDOT_MAX_B}, "
                         f"K % 256 == 0 (layout={qt.layout} B={B} K={K})")
    if B == 0:
        return torch.empty((0, N), dtype=out_dtype or torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mins = qt.mins.data_ptr() if qt.mins is not None else None
    sbf16 = int(qt.scales.dtype == torch.bfloat16)
    split = _split(x, N, qt.layout) if split is None else split
    if gdot:
        _check_decode(qt, True)
        y, obf16 = _out(B, N, x, out_dtype)
        rc = _lib("qmm_decode").qmm_gdot_decode_launch(
            x.data_ptr(), qt.qs.data_ptr(), qt.scales.data_ptr(), mins, y.data_ptr(), B, K, N,
            qt.group_size, qt.zp, sbf16, split, obf16, stream)
        cuda_build.check(rc, "qmm_gdot_decode_launch")
        LAUNCHES[kernel_name("K5", qt)] += 1
        return _cast(y, out_dtype)
    if B <= GDOT_MAX_B:
        _check_decode(qt)
        y, obf16 = _out(B, N, x, out_dtype)
        rc = _lib("qmm_decode").qmm_decode_launch(
            x.data_ptr(), qt.qs.data_ptr(), qt.scales.data_ptr(), mins, y.data_ptr(), B, K, N,
            qt.group_size, qt.zp, int(p4), sbf16, split, obf16, stream)
        cuda_build.check(rc, "qmm_decode_launch")
    else:
        y = torch.empty((B, N), dtype=torch.float32, device=x.device)
        rc = _lib().qmm_launch(x.data_ptr(), qt.qs.data_ptr(), qt.scales.data_ptr(), mins,
                               y.data_ptr(), B, K, N, qt.group_size, qt.zp, int(p4), sbf16,
                               split, stream)
        cuda_build.check(rc, "qmm_launch")
    LAUNCHES[kernel_name("K1", qt)] += 1
    return _cast(y, out_dtype)


def qmm_stacked_cuda(x: torch.Tensor, sw: StackedWeight, gdot: bool = False,
                     out_dtype=None) -> torch.Tensor:
    """Launch K7: K1/K2 (K5 with gdot) on layer sw.idx of stacked K-major
    planes, the index read on the card. x bf16 [B, K] on the card; y in
    out_dtype as qmm_cuda's."""
    qt = sw.w
    if not isinstance(qt, QTensor) or qt.qs.dim() != 3:
        raise ValueError("qmm_stacked_cuda: needs a QTensor with [L, ...] planes")
    B, K = x.shape
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("qmm_stacked_cuda: x must be a contiguous, 16-byte aligned bf16 "
                         "CUDA tensor")
    layer = sw.probe
    check_planes(layer, B, K)  # layer 0's base; the strides below carry it to every layer
    idx = sw.idx
    if not (idx.is_cuda and idx.dtype == torch.int32 and idx.numel() == 1):
        raise ValueError("qmm_stacked_cuda: the layer index must be an int32 [1] CUDA tensor")
    if sw.layer_bytes is None or any(b % 16 for b in sw.layer_bytes):
        raise ValueError("qmm_stacked_cuda: every layer's planes must start 16-byte aligned")
    qs_ls, s_ls = sw.layer_bytes
    if gdot and not gdot_eligible(layer, B):
        raise ValueError(f"qmm_stacked_cuda: K5 takes p4 planes at B <= {GDOT_MAX_B}, "
                         f"K % 256 == 0 (layout={layer.layout} B={B} K={K})")
    N = layer.out_features
    if B == 0:
        return torch.empty((0, N), dtype=out_dtype or torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mins = qt.mins.data_ptr() if qt.mins is not None else None
    sbf16 = int(qt.scales.dtype == torch.bfloat16)
    p4 = int(qt.layout == "p4")
    if gdot:
        _check_decode(layer, True)
        y, obf16 = _out(B, N, x, out_dtype)
        rc = _lib("qmm_decode").qmm_gdot_decode_stacked_launch(
            x.data_ptr(), qt.qs.data_ptr(), qt.scales.data_ptr(), mins, y.data_ptr(), B, K, N,
            qt.group_size, qt.zp, sbf16, _split(x, N, qt.layout), obf16, qs_ls, s_ls,
            qt.qs.shape[0], idx.data_ptr(), stream)
    elif B <= GDOT_MAX_B:
        _check_decode(layer)
        y, obf16 = _out(B, N, x, out_dtype)
        rc = _lib("qmm_decode").qmm_decode_stacked_launch(
            x.data_ptr(), qt.qs.data_ptr(), qt.scales.data_ptr(), mins, y.data_ptr(), B, K, N,
            qt.group_size, qt.zp, p4, sbf16, _split(x, N, qt.layout), obf16, qs_ls, s_ls,
            qt.qs.shape[0], idx.data_ptr(), stream)
    else:
        y = torch.empty((B, N), dtype=torch.float32, device=x.device)
        rc = _lib("qmm_stacked").qmm_stacked_launch(
            x.data_ptr(), qt.qs.data_ptr(), qt.scales.data_ptr(), mins, y.data_ptr(), B, K, N,
            qt.group_size, qt.zp, p4, sbf16, _split(x, N, qt.layout), qs_ls, s_ls,
            qt.qs.shape[0], idx.data_ptr(), stream)
    cuda_build.check(rc, "qmm_stacked_launch")
    LAUNCHES[kernel_name("K7", layer)] += 1
    return _cast(y, out_dtype)


def quant_matmul(x: torch.Tensor, qt: "QTensor | StackedWeight", cdtype=torch.bfloat16,
                 gdot: bool = False, out_dtype=None) -> torch.Tensor:
    """x [B, K] @ W -> [B, N] in out_dtype (f32 when None), by device: the
    kernel for CUDA tensors (the decode GEMV writes bf16 itself), the plain
    version, whose f32 is cast, for CPU tensors. gdot: K5 (the caller has
    checked gdot_eligible) in place of K1. A StackedWeight of K-major
    planes takes K7."""
    stacked = isinstance(qt, StackedWeight)
    if x.is_cuda:
        if cdtype != torch.bfloat16:
            raise ValueError("the CUDA qmm kernels compute in bf16")
        xb = x.to(torch.bfloat16).contiguous()
        if stacked:
            return qmm_stacked_cuda(xb, qt, gdot, out_dtype)
        return qmm_cuda(xb, qt, gdot, out_dtype)
    if stacked:
        y = qmm_stacked_plain(x, qt, cdtype, gdot)
    else:
        y = (qmm_gdot_plain if gdot else qmm_plain)(x, qt, cdtype)
    return _cast(y, out_dtype)
