"""Quantized matmul and embedding gather. Counterpart of
llm_tpu/ops/qmatmul.py::qmm / qembed.

qmm sends K-major QTensors through K1/K2 (ops/cuda_qmm.py), which pick the
kernel or its plain version by device; with gdot=True (the reference's
LLM_TPU_GDOT=force) the shapes its gate admits go to K5 instead. A
StackedWeight (the scan decoder's layer of [L, ...] planes) of K-major
planes goes to K7, which reads the layer on the card; other stacked weights
take a copy of the layer (the reference's _slice_stacked): an expert of a
mixture-of-experts stack (rows-layout planes [E, ...]), dequantized in the
compute dtype and multiplied in f32, as the reference computes it outside
its Pallas kernels (_dequant_w and an XLA dot). Any other rows-layout
QTensor goes to K1/K2, which refuse it on the card. Dense weights ([N, K],
as GGUF stores F32/F16 tensors) are a plain matmul. qembed is a row gather plus dequantization, and
dequant_expert_rows a gather of experts' planes plus dequantization
(the MoE FFN's decode path), plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from ..device import full_f32
from ..quant.qtensor import QTensor, StackedWeight, slice_stacked, unpack_p4_rows
from .cuda_qmm import gdot_eligible, quant_matmul

# compute dtype of the quantized matmul unless the caller names one
DEFAULT_DTYPE = torch.bfloat16


def qmm(x: torch.Tensor, w: "QTensor | torch.Tensor | StackedWeight", dtype=None,
        out_dtype=None, gdot: bool = False) -> torch.Tensor:
    """y[..., n] = sum_k x[..., k] * W[k, n], accumulated in f32 and given
    in out_dtype (f32 when None; the decode GEMV writes it, elsewhere the
    f32 result is cast). gdot:
    p4 planes at B <= 16 rows with K % 256 == 0 take the group-factored
    K5; every other shape K1/K2, as the reference routes them. A
    StackedWeight of K-major planes takes K7 (with gdot where the layer's
    shape passes the same gate); a StackedWeight of rows-layout planes (an
    expert of a MoE stack) is sliced, dequantized in dtype and multiplied
    in f32."""
    dtype = dtype or DEFAULT_DTYPE
    lead, k = x.shape[:-1], x.shape[-1]
    if isinstance(w, StackedWeight) and not (isinstance(w.w, QTensor) and w.w.kmajor):
        w = slice_stacked(w.w, w.idx)
        if isinstance(w, QTensor):  # an expert's rows-layout planes
            with full_f32():
                y = x.to(dtype).float() @ dequant_rows(w, dtype).float().T
            return y if out_dtype is None else y.to(out_dtype)
    if isinstance(w, (QTensor, StackedWeight)):
        x2 = x.reshape(-1, k)
        geo = w.probe if isinstance(w, StackedWeight) else w
        use_gdot = gdot and gdot_eligible(geo, x2.shape[0])
        return quant_matmul(x2, w, dtype, use_gdot, out_dtype).reshape(*lead, -1)
    xw = x.to(w.dtype) if w.dtype != torch.float32 else x
    y = xw.float() @ w.float().T
    return y if out_dtype is None else y.to(out_dtype)


def _dequant_planes(qs, scales, mins, qt: QTensor, dtype) -> torch.Tensor:
    """Rows-layout planes [..., N, K(/2)] with their scales and mins [..., N,
    K//gs] -> weights [..., N, K] in dtype: (q - zp) * s - m, each operand
    and product in dtype (the reference's _dequant_w and
    dequant_expert_rows)."""
    q = unpack_p4_rows(qs, qt.pack_tk, qt.zp) if qt.layout == "p4" else qs
    g, k = qt.group_size, q.shape[-1]
    w = q.to(dtype).reshape(*q.shape[:-1], k // g, g) * scales.to(dtype)[..., None]
    if mins is not None:
        w = w - mins.to(dtype)[..., None]
    return w.reshape(*q.shape[:-1], k)


def dequant_rows(qt: QTensor, dtype) -> torch.Tensor:
    """A rows-layout QTensor's weights [..., N, K] in dtype."""
    assert not qt.kmajor
    return _dequant_planes(qt.qs, qt.scales, qt.mins, qt, dtype)


def dequant_expert_rows(qt: QTensor, idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The experts idx [...] of a stacked-expert QTensor (qs [E, N, K(/2)],
    quant/qtensor.py::expert_qtensor_from_gguf), gathered and dequantized:
    [..., N, K] in dtype. Only the chosen experts' planes are read; the
    expansion is a temporary (llm_tpu/ops/qmatmul.py::dequant_expert_rows)."""
    assert not qt.kmajor
    take = (lambda t: None if t is None else t[idx])
    return _dequant_planes(take(qt.qs), take(qt.scales), take(qt.mins), qt, dtype)


def qembed(w: "QTensor | torch.Tensor", ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Embedding rows for token ids: gather, then dequantize in f32."""
    dtype = dtype or DEFAULT_DTYPE
    if not isinstance(w, QTensor):
        return w[ids].to(dtype)
    assert not w.kmajor, "embedding tables use the rows layout"
    q = w.qs[ids]
    q = unpack_p4_rows(q, w.pack_tk, w.zp) if w.layout == "p4" else q
    q = q.float()
    g = w.group_size
    out = q.reshape(*q.shape[:-1], -1, g) * w.scales[ids].float()[..., None]
    if w.mins is not None:
        out = out - w.mins[ids].float()[..., None]
    return out.reshape(q.shape).to(dtype)
