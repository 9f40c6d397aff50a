"""S1: the decode GEMV's probes. Counterpart of the TPU package's timing
probes scripts/kbench3.py::probe1 (_probe1_kernel: stream the qs plane) and
scripts/kbench.py / kbench3.py::probe (_probe_kernel, modes "dma" and
"deq"), which split the fused dequantize x matmul's time into streaming and
dequantizing.

`probe_cuda(mode, x, qt)` launches csrc/qmm_probe.cu: the GEMV loop of
csrc/qmm_gemv.cuh (K1's decode GEMV when S1 was ported, later K5's and
K6's; none of them runs it now) on that loop's grid with its MODE set, over p4
planes with bf16 scales, x bf16 [B <= 16, K]. Each mode writes f32 [3, N],
to which every byte it loads contributes (the compiler can drop no load),
one row for each kind of load; per column n, with C the number of the
loop's launches (one per 4 rows of x) and X the sum of x:

    row 0, "qs" and "dma":  C * sum_r qs[r, n]                (packed bytes)
    row 1, "dma":           C * (sum_g s[g, n] + sum_g m[g, n])
           "deq":           C * sum_k ((q[k, n] - zp) * s[k//gs, n] - m[k//gs, n])
    row 2, "dma" and "deq": X

and 0 where a mode does not feed a row. `probe_plain` computes the same in
PyTorch; with magnitude=True it sums each term's absolute value instead,
the scale of the f32 rounding of a sum taken in another order (the
kernel's "deq" sums cancel: the weights have mean zero). `tolerance` holds
each row at a bound of its own size: were the byte sums and the scales in
one row, the byte sums' rounding bound would swamp a probe that never
loaded a scale. The TPU probes summed a slice of each block whose rows
depend on the tile, so their outputs were not a function of the planes
alone; these are.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.qtensor import QTensor
from . import cuda_build
from .cuda_qmm import check_planes, unpack_planes

MODES = {"qs": 1, "dma": 2, "deq": 3}
OUT_ROWS = 3  # rows of a probe's output (module docstring)
# row 0 sums integers below 2^24, exact in f32 in any order; rows 1 and 2
# add f32 values in another order (atomics across CTAs), held at this share
# of the sum of the row's magnitudes, some 170 f32 roundings of it
REL_TOL = 1e-5
# launches of the probe kernel, counted where the wrapper launches it
LAUNCHES = {"S1": 0}
ROWS_PER_LAUNCH = 4  # the qmm_gemv.cuh loop takes x 4 rows at a time


def reset_launches() -> None:
    LAUNCHES["S1"] = 0


def probe_plain(mode: str, x: torch.Tensor, qt: QTensor,
                magnitude: bool = False) -> torch.Tensor:
    """The probe's output [3, N] f32 in plain PyTorch (module docstring);
    magnitude: the same sums over the terms' absolute values."""
    if mode not in MODES:
        raise ValueError(f"probe mode {mode!r} not in {sorted(MODES)}")
    f = torch.abs if magnitude else (lambda t: t)
    C = -(-x.shape[0] // ROWS_PER_LAUNCH)
    N = qt.out_features
    out = torch.zeros((OUT_ROWS, N), dtype=torch.float32, device=qt.qs.device)
    if mode in ("qs", "dma"):
        out[0] = C * qt.qs.to(torch.int64).sum(0).float()
    if mode == "dma":
        planes = f(qt.scales.float()).sum(0)
        if qt.mins is not None:
            planes = planes + f(qt.mins.float()).sum(0)
        out[1] = C * planes
    if mode == "deq":
        gs = qt.group_size
        q = unpack_planes(qt).float()
        K = q.shape[0]
        w = q.reshape(K // gs, gs, N) * qt.scales.float()[:, None, :]
        if qt.mins is not None:
            w = w - qt.mins.float()[:, None, :]
        out[1] = C * f(w).reshape(K, N).sum(0)
    if mode != "qs":
        out[2] = f(x.to(torch.bfloat16).float()).sum()
    return out


def tolerance(mode: str, x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The bound [3, 1] on each row's max|probe - probe_plain|: 0 for the
    byte sums, REL_TOL of the row's largest sum of magnitudes for the
    others."""
    tol = REL_TOL * probe_plain(mode, x, qt, magnitude=True).amax(1, keepdim=True)
    tol[0] = 0.0
    return tol


def _lib():
    lib = cuda_build.load("qmm_probe")
    fn = lib.qmm_probe_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def probe_cuda(mode: str, x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Launch the probe in `mode` on the card: x bf16 [B <= 16, K], p4
    planes with bf16 scales (the decode GEMV's K1 shapes)."""
    if mode not in MODES:
        raise ValueError(f"probe mode {mode!r} not in {sorted(MODES)}")
    B, K = x.shape
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("probe_cuda: x must be a contiguous, 16-byte aligned bf16 CUDA tensor")
    check_planes(qt, B, K)
    if qt.layout != "p4" or qt.scales.dtype != torch.bfloat16 or not 1 <= B <= 16:
        raise ValueError(f"probe_cuda: p4 planes with bf16 scales at 1 <= B <= 16 "
                         f"(layout={qt.layout} scales={qt.scales.dtype} B={B})")
    N = qt.out_features
    y = torch.empty((OUT_ROWS, N), dtype=torch.float32, device=x.device)
    mins = qt.mins.data_ptr() if qt.mins is not None else None
    rc = _lib().qmm_probe_launch(x.data_ptr(), qt.qs.data_ptr(), qt.scales.data_ptr(), mins,
                                 y.data_ptr(), B, K, N, qt.zp, MODES[mode],
                                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "qmm_probe_launch")
    LAUNCHES["S1"] += 1
    return y


def probe(mode: str, x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The probe by device: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    return probe_cuda(mode, x, qt) if x.is_cuda else probe_plain(mode, x, qt)
