"""QTensor: the device representation of a block-quantized weight, as
torch tensors. Counterpart of llm_tpu/quant/qtensor.py, with the same
fields and the same planes (the tests hold them byte-equal):

    W[k, n] = (q[k, n] - zp) * scales[k//gs, n] - mins[k//gs, n]

Matmul weights are K-major (qs [K(/2), N], scales [K//gs, N]); embedding
tables keep the rows layout (qs [N, K(/2)], scales [N, K//gs]) so token
gathers are row gathers, and so do a mixture-of-experts layer's expert
stacks, with a leading expert dim (qs [E, N, K(/2)], scales [E, N, K//gs];
expert_qtensor_from_gguf), so a token's experts are a gather of rows. Layout "p4" nibble-packs 4-bit types along K with
pairing stride pack_tk: within each 256-row tile, byte t holds k=t in the
low nibble and k=t+128 in the high nibble. Layout "i8" keeps int8 planes.

All bit-unpacking happens here in numpy at load time.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.constants import GGMLType, type_traits
from .codecs import KVALUES_IQ4NL, _q3k_scales, _read_f16, _u8, _unpack2, _unpack_k4_scales
from .iq_codecs import PLANE_FNS

PACK_TK = 256


@dataclass
class QTensor:
    qs: torch.Tensor  # kmajor: [K(/2), N]; rows: [N, K(/2)]
    scales: torch.Tensor  # kmajor: [K//gs, N]; rows: [N, K//gs]
    mins: torch.Tensor | None
    group_size: int
    ggml_type: GGMLType
    layout: str = "i8"
    zp: int = 0
    pack_tk: int = PACK_TK
    kmajor: bool = True

    @property
    def in_features(self) -> int:
        k = self.qs.shape[0] if self.kmajor else self.qs.shape[-1]
        return k * 2 if self.layout == "p4" else k

    @property
    def out_features(self) -> int:
        return self.qs.shape[-1] if self.kmajor else self.qs.shape[0]

    def to(self, device) -> "QTensor":
        return self.map(lambda t: t.to(device))

    def map(self, fn) -> "QTensor":
        """The same meta with fn applied to each plane (mins may be None)."""
        return QTensor(fn(self.qs), fn(self.scales),
                       None if self.mins is None else fn(self.mins),
                       self.group_size, self.ggml_type, self.layout, self.zp,
                       self.pack_tk, self.kmajor)


class StackedWeight:
    """Layer `idx` of depth-stacked weights, for the scan decoder.
    Counterpart of llm_tpu/ops/qmatmul.py::StackedWeight: w is a QTensor
    whose planes carry a leading layer dim [L, ...] (the meta is every
    layer's), or a dense [L, N, K] tensor; idx is an int32 tensor [1] on
    w's device, the counterpart of the reference's scalar-prefetch operand.
    K7 reads the index on the card, so no launch waits on the host.

    Made once per layer and weight (models/transformer.py::scan_layers), so
    what K7's wrapper needs of the planes is worked out here, not per call:
    `probe`, layer 0's planes as views, gives the per-layer geometry
    (in_features, out_features, the K-major layout), which a stacked
    QTensor's own properties would read off the layer dim (the reference's
    `probe`); `layer_bytes` is (qs, scales) bytes from one layer's planes to
    the next, None unless every plane is contiguous."""

    __slots__ = ("w", "idx", "probe", "layer_bytes")

    def __init__(self, w, idx: torch.Tensor):
        self.w = w
        self.idx = idx
        self.probe = self.layer_bytes = None
        if isinstance(w, QTensor):
            self.probe = w.map(lambda t: t[0])
            planes = [t for t in (w.qs, w.scales, w.mins) if t is not None]
            if all(t.is_contiguous() for t in planes):
                self.layer_bytes = tuple(t[0].numel() * t.element_size()
                                         for t in (w.qs, w.scales))


def slice_stacked(w, idx: torch.Tensor):
    """Layer idx of stacked weights, copied out by an index on the device
    (no host sync): the reference's _slice_stacked."""
    take = (lambda t: t.index_select(0, idx).squeeze(0))
    return w.map(take) if isinstance(w, QTensor) else take(w)


def pack_p4(qs_i8, zp: int, tile_k: int = PACK_TK) -> np.ndarray:
    """Row-major packing [N, K] -> [N, K//2] (embedding tables). Within each
    K-tile, byte t holds k=t (low) and k=t+tile_k//2 (high), both offset
    by zp so storage is unsigned 0..15."""
    q = (np.asarray(qs_i8, np.uint8) + np.uint8(zp)) & np.uint8(0xF)
    N, K = q.shape
    tile_k = min(tile_k, K)
    assert K % tile_k == 0
    qt = q.reshape(N, K // tile_k, 2, tile_k // 2)
    return (qt[:, :, 0] | (qt[:, :, 1] << np.uint8(4))).reshape(N, K // 2)


def pack_p4_kmajor(qs_i8, zp: int, tile_k: int = PACK_TK) -> np.ndarray:
    """K-major packing [K, N] -> [K//2, N]: row t of each K-tile packs
    k=t (low nibble) and k=t+tile_k//2 (high nibble)."""
    q = (np.asarray(qs_i8, np.uint8) + np.uint8(zp)) & np.uint8(0xF)
    K, N = q.shape
    tile_k = min(tile_k, K)
    assert K % tile_k == 0
    qt = q.reshape(K // tile_k, 2, tile_k // 2, N)
    return (qt[:, 0] | (qt[:, 1] << np.uint8(4))).reshape(K // 2, N)


def planes_from_raw(raw: np.ndarray, ggml_type: GGMLType, n_per_row: int):
    """Raw row-major GGUF bytes -> (qs int8, scales f32, mins f32|None,
    group_size), per block: qs (blocks, block_size), scales (blocks, n_groups)."""
    t = GGMLType(ggml_type)
    if t == GGMLType.Q8_0:
        b = _u8(raw, 34)
        return b[:, 2:].view(np.int8), _read_f16(b[:, 0:2]), None, 32
    if t == GGMLType.Q4_0:
        b = _u8(raw, 18)
        qs = b[:, 2:]
        q = np.concatenate([qs & 0xF, qs >> 4], axis=-1).astype(np.int8) - 8
        return q, _read_f16(b[:, 0:2]), None, 32
    if t == GGMLType.Q4_1:
        b = _u8(raw, 20)
        qs = b[:, 4:]
        q = np.concatenate([qs & 0xF, qs >> 4], axis=-1).astype(np.int8)
        # the block stores +m; the plane convention subtracts mins
        return q, _read_f16(b[:, 0:2]), -_read_f16(b[:, 2:4]), 32
    if t in (GGMLType.Q5_0, GGMLType.Q5_1):
        # Q5_0: d, 4 bytes of fifth bits, 16 nibble bytes; Q5_1: d, m, then the same
        one = t == GGMLType.Q5_1
        b = _u8(raw, 24 if one else 22)
        o = 4 if one else 2
        qh = np.ascontiguousarray(b[:, o:o + 4]).view("<u4").reshape(-1).astype(np.uint32)
        qs = b[:, o + 4:]
        j = np.arange(16)
        xh0 = ((qh[:, None] >> j) << 4) & 0x10
        xh1 = (qh[:, None] >> (j + 12)) & 0x10
        q = np.concatenate([(qs & 0x0F) | xh0, (qs >> 4) | xh1], axis=-1).astype(np.int8)
        d = _read_f16(b[:, 0:2])
        return (q, d, -_read_f16(b[:, 2:4]), 32) if one else (q - 16, d, None, 32)
    if t == GGMLType.Q4_K:
        b = _u8(raw, 144)
        B = b.shape[0]
        d = _read_f16(b[:, 0:2])
        dmin = _read_f16(b[:, 2:4])
        ls, lm = _unpack_k4_scales(b[:, 4:16])
        qs = b[:, 16:].reshape(B, 4, 32)
        q = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(B, 256).astype(np.int8)
        return q, d * ls.astype(np.float32), dmin * lm.astype(np.float32), 32
    if t == GGMLType.Q6_K:
        b = _u8(raw, 210)
        B = b.shape[0]
        ql = b[:, 0:128].reshape(B, 2, 2, 32)
        qh = b[:, 128:192].reshape(B, 2, 32)
        sc = b[:, 192:208].view(np.int8).astype(np.float32)
        d = _read_f16(b[:, 208:210])
        q1 = ((ql[:, :, 0] & 0xF) | (((qh >> 0) & 3) << 4)).astype(np.int32) - 32
        q2 = ((ql[:, :, 1] & 0xF) | (((qh >> 2) & 3) << 4)).astype(np.int32) - 32
        q3 = ((ql[:, :, 0] >> 4) | (((qh >> 4) & 3) << 4)).astype(np.int32) - 32
        q4 = ((ql[:, :, 1] >> 4) | (((qh >> 6) & 3) << 4)).astype(np.int32) - 32
        q = np.stack([q1, q2, q3, q4], axis=2).reshape(B, 256).astype(np.int8)
        return q, d * sc, None, 16
    if t == GGMLType.Q5_K:
        b = _u8(raw, 176)
        B = b.shape[0]
        d, dmin = _read_f16(b[:, 0:2]), _read_f16(b[:, 2:4])
        ls, lm = _unpack_k4_scales(b[:, 4:16])
        qh = b[:, 16:48]
        qs = b[:, 48:].reshape(B, 4, 32)
        lo, hi = (qs & 0xF).astype(np.int32), (qs >> 4).astype(np.int32)
        parts = []
        for n4 in range(4):
            parts.append(lo[:, n4] + np.where((qh & (1 << (2 * n4))) > 0, 16, 0))
            parts.append(hi[:, n4] + np.where((qh & (2 << (2 * n4))) > 0, 16, 0))
        q = np.stack(parts, axis=1).reshape(B, 256).astype(np.int8)
        return q, d * ls.astype(np.float32), dmin * lm.astype(np.float32), 32
    if t == GGMLType.Q2_K:
        b = _u8(raw, 84)
        sc = b[:, 0:16]
        q = _unpack2(b[:, 16:80]).astype(np.int8)
        d, dmin = _read_f16(b[:, 80:82]), _read_f16(b[:, 82:84])
        return q, d * (sc & 0xF).astype(np.float32), dmin * (sc >> 4).astype(np.float32), 16
    if t == GGMLType.Q3_K:
        b = _u8(raw, 110)
        B = b.shape[0]
        hm = b[:, 0:32]
        q2 = _unpack2(b[:, 32:96]).astype(np.int8)
        sc6 = _q3k_scales(b[:, 96:108])
        d = _read_f16(b[:, 108:110])
        hbits = np.stack([(hm >> kk) & 1 for kk in range(8)], axis=1).reshape(B, 256)
        q = (q2 - np.where(hbits > 0, 0, 4)).astype(np.int8)
        return q, d * sc6.astype(np.float32), None, 16
    if t == GGMLType.IQ4_NL:
        b = _u8(raw, 18)
        qs = b[:, 2:]
        q = np.concatenate([KVALUES_IQ4NL[qs & 0xF], KVALUES_IQ4NL[qs >> 4]],
                           axis=-1).astype(np.int8)
        return q, _read_f16(b[:, 0:2]), None, 32
    if t == GGMLType.IQ4_XS:
        b = _u8(raw, 136)
        B = b.shape[0]
        d = _read_f16(b[:, 0:2])
        scales_h = np.ascontiguousarray(b[:, 2:4]).view("<u2").reshape(-1).astype(np.int32)
        scales_l = b[:, 4:8]
        qs = b[:, 8:].reshape(B, 8, 16)
        ls = np.empty((B, 8), np.int32)
        for ib in range(8):
            lo = (scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0xF
            ls[:, ib] = (lo.astype(np.int32) | (((scales_h >> (2 * ib)) & 3) << 4)) - 32
        q = np.stack([KVALUES_IQ4NL[qs & 0xF], KVALUES_IQ4NL[qs >> 4]],
                     axis=2).reshape(B, 256).astype(np.int8)
        return q, d * ls.astype(np.float32), None, 32
    fn = PLANE_FNS.get(t.name)
    if fn is not None:  # the IQ grid and ternary types (quant/iq_codecs.py)
        return fn(raw)
    raise ValueError(f"no plane unpacker for {t.name}")


# types whose plane values fit a nibble, with the zero point that makes
# them 0..15: the 4-bit ones, Q2_K (0..3) and Q3_K (-4..3), which a 2- or
# 3-bit model reads at 4 bits a weight rather than 8, and the ternary
# TQ1_0 / TQ2_0 (-1..1, one scale a 256-value block)
_PACK4 = {GGMLType.Q4_0: 8, GGMLType.Q4_1: 0, GGMLType.Q4_K: 0, GGMLType.Q2_K: 0,
          GGMLType.Q3_K: 4, GGMLType.TQ1_0: 1, GGMLType.TQ2_0: 1}

# every type the loader builds planes of (the reference's
# supported_plane_types): the IQ grid types as int8 planes at group size
# 32, 16 (IQ2_XS, IQ2_S) or 8 (IQ1_M)
PLANE_TYPES = (GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
               GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
               GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.IQ2_XXS, GGMLType.IQ2_XS,
               GGMLType.IQ2_S, GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S,
               GGMLType.IQ1_M, GGMLType.TQ1_0, GGMLType.TQ2_0)


# a matrix of at least this many weights has its rows unpacked in
# LOAD_THREADS chunks at once (numpy releases the GIL in its array work);
# rows are independent, so the planes are the same bytes
THREADED_MIN_WEIGHTS = 1 << 24
LOAD_THREADS = min(8, os.cpu_count() or 1)


def _planes_of_rows(raw: np.ndarray, t: GGMLType, K: int, N: int, kmajor: bool):
    """(q, scales, mins, group size, zp, packed) of N rows of K weights in
    the layout the QTensor keeps: K-major [K(/2), N] and [K/gs, N], or rows
    [N, K(/2)] and [N, K/gs]."""
    q, scales, mins, gs = planes_from_raw(raw, t, K)
    q = q.reshape(N, K)
    scales = scales.reshape(N, K // gs)
    mins = mins.reshape(N, K // gs) if mins is not None else None
    do_pack = t in _PACK4 and K % PACK_TK == 0
    zp = _PACK4[t] if do_pack else 0
    if kmajor:
        q = np.ascontiguousarray(q.T)
        q = pack_p4_kmajor(q, zp) if do_pack else q
        scales = scales.T
        mins = mins.T if mins is not None else None
    elif do_pack:
        q = pack_p4(q, zp)
    return q, scales, mins, gs, zp, do_pack


def qtensor_from_gguf(raw: np.ndarray, ggml_type: GGMLType,
                      ne_shape: tuple[int, ...], device="cpu",
                      kmajor: bool = True) -> QTensor:
    """Build a QTensor from raw GGUF tensor bytes. GGUF matrices have
    ne=(K, N): N rows of length K. Matmul weights become K-major; embedding
    tables pass kmajor=False. Scales and mins stay f32. A large matrix's
    rows are unpacked in LOAD_THREADS chunks on threads and joined."""
    t = GGMLType(ggml_type)
    K, N = int(ne_shape[0]), int(np.prod(ne_shape[1:], dtype=np.int64))
    n_chunks = min(LOAD_THREADS, N) if N * K >= THREADED_MIN_WEIGHTS else 1
    if n_chunks > 1:
        tt = type_traits(t)
        row_bytes = K // tt.block_size * tt.type_size
        raw8 = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
        bounds = [N * i // n_chunks for i in range(n_chunks + 1)]
        with ThreadPoolExecutor(n_chunks) as pool:
            parts = list(pool.map(
                lambda i: _planes_of_rows(raw8[bounds[i] * row_bytes:bounds[i + 1] * row_bytes],
                                          t, K, bounds[i + 1] - bounds[i], kmajor),
                range(n_chunks)))
        axis = 1 if kmajor else 0
        join = (lambda j: None if parts[0][j] is None
                else np.concatenate([p[j] for p in parts], axis=axis))
        q, scales, mins = join(0), join(1), join(2)
        gs, zp, do_pack = parts[0][3:]
    else:
        q, scales, mins, gs, zp, do_pack = _planes_of_rows(raw, t, K, N, kmajor)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return QTensor(
        qs=put(q), scales=put(scales.astype(np.float32)),
        mins=put(mins.astype(np.float32)) if mins is not None else None,
        group_size=gs, ggml_type=t, layout="p4" if do_pack else "i8", zp=zp,
        pack_tk=PACK_TK, kmajor=kmajor,
    )


def concat_qtensors(tensors: list) -> QTensor | None:
    """Concatenate K-major QTensors along the output dim, to fuse QKV and
    gate+up into one kernel launch. None when the recipes differ."""
    first = tensors[0]
    for t in tensors:
        if (not isinstance(t, QTensor) or not t.kmajor
                or t.layout != first.layout or t.group_size != first.group_size
                or t.zp != first.zp or t.pack_tk != first.pack_tk
                or t.qs.shape[0] != first.qs.shape[0]
                or t.scales.dtype != first.scales.dtype
                or (t.mins is None) != (first.mins is None)):
            return None
    cat = (lambda ts: torch.cat(ts, dim=1).contiguous())
    return QTensor(
        qs=cat([t.qs for t in tensors]),
        scales=cat([t.scales for t in tensors]),
        mins=cat([t.mins for t in tensors]) if first.mins is not None else None,
        group_size=first.group_size, ggml_type=first.ggml_type,
        layout=first.layout, zp=first.zp, pack_tk=first.pack_tk, kmajor=True,
    )


def expert_qtensor_from_gguf(raw: np.ndarray, ggml_type: GGMLType,
                             ne_shape: tuple[int, ...], device="cpu") -> QTensor:
    """Stacked expert planes from a 3-D GGUF tensor ne = (K, N, E): a
    rows-layout QTensor whose planes carry a leading expert dim, qs [E, N,
    K(/2)] and scales / mins [E, N, K//gs] (f32), the experts kept at their
    stored bit-width (llm_tpu/quant/qtensor.py::expert_qtensor_from_gguf)."""
    K, N, E = (int(d) for d in ne_shape)
    flat = qtensor_from_gguf(raw, ggml_type, (K, N * E), device=device, kmajor=False)
    return flat.map(lambda t: t.reshape(E, N, -1))


def unpack_p4_rows(packed: torch.Tensor, pack_tk: int, zp: int) -> torch.Tensor:
    """Nibble planes packed along the last dim [..., K//2] -> int16 q - zp
    [..., K]: within each pack_tk tile, byte t holds k = t (low nibble) and
    k = t + pack_tk // 2 (high). (K-major planes [K//2, N] unpack as their
    transpose.)"""
    lead, kh = packed.shape[:-1], packed.shape[-1]
    half = pack_tk // 2
    p = packed.reshape(*lead, kh // half, half).to(torch.int16)
    q = torch.stack([p & 0xF, p >> 4], dim=-2)
    return q.reshape(*lead, kh * 2) - zp


def dequantize_qtensor(qt: QTensor) -> torch.Tensor:
    """The weights of any QTensor in f32, [..., N, K] whatever its layout:
    K-major planes, rows-layout ones, and rows-layout ones with leading dims
    (an expert stack's [E, N, K]). Counterpart of
    llm_tpu/quant/qtensor.py::dequantize_qtensor."""
    rows = (lambda t: None if t is None else (t.T if qt.kmajor else t))
    q, s, m = rows(qt.qs), rows(qt.scales).float(), rows(qt.mins)
    q = unpack_p4_rows(q, qt.pack_tk, qt.zp) if qt.layout == "p4" else q
    w = q.float() * s.repeat_interleave(qt.group_size, dim=-1)
    if m is not None:
        w = w - m.float().repeat_interleave(qt.group_size, dim=-1)
    return w
