"""Importance-grid (IQ) and ternary (TQ) planes: the port's own copy of the
plane unpackers of llm_tpu/quant/iq_codecs.py (the quantizers stay there).

Every IQ/TQ value is a scale times an integer: a codebook entry times its
sign, or a trit. IQ1's +-0.125 delta folds in exactly as q = 8 * grid +- 1
with the scale over 8. So each type becomes int8 planes with a scale a
group, or, for the ternary types, nibble planes (quant/qtensor.py _PACK4).
The codebooks (ggml-common.h) are format data, shipped in iq_grids.npz, a
byte-identical copy of the reference's file.

Element order inside a 256-value super-block is ggml's: 8 sub-blocks of
32, each made of four (IQ2*, IQ1*) or eight (IQ3*) codebook words of 8 or
4 values.
"""

from __future__ import annotations

import os

import numpy as np

QK_K = 256

_GRIDS = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "iq_grids.npz"))

# the grids as (codes, values a code) arrays
GRID_IQ2XXS = _GRIDS["iq2xxs_grid"].view(np.uint8).reshape(256, 8).astype(np.float32)
GRID_IQ2XS = _GRIDS["iq2xs_grid"].view(np.uint8).reshape(512, 8).astype(np.float32)
GRID_IQ2S = _GRIDS["iq2s_grid"].view(np.uint8).reshape(1024, 8).astype(np.float32)
GRID_IQ3XXS = _GRIDS["iq3xxs_grid"].view(np.uint8).reshape(256, 4).astype(np.float32)
GRID_IQ3S = _GRIDS["iq3s_grid"].view(np.uint8).reshape(512, 4).astype(np.float32)
GRID_IQ1S = _GRIDS["iq1s_grid"].view(np.int8).reshape(2048, 8).astype(np.float32)

KSIGNS = _GRIDS["ksigns_iq2xs"]  # (128,) uint8; bit j = sign of element j
# (128, 8) multipliers +1 / -1
KSIGN_MULT = np.where((KSIGNS[:, None] >> np.arange(8)[None, :]) & 1, -1.0, 1.0
                      ).astype(np.float32)


def _read_f16(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view("<f2").astype(np.float32).reshape(b.shape[0])


def _u8(raw: np.ndarray, ts: int) -> np.ndarray:
    return np.ascontiguousarray(raw).view(np.uint8).reshape(-1, ts)


def _u16(b: np.ndarray) -> np.ndarray:
    """little-endian uint16 view of a (..., 2k) uint8 array -> (..., k) int64"""
    return np.ascontiguousarray(b).view("<u2").astype(np.int64)


def _u32(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view("<u4").astype(np.int64)


def _signs8(signs: np.ndarray) -> np.ndarray:
    """Sign bytes (...,) -> (..., 8) multipliers, bit j the sign of value j."""
    return np.where((signs[..., None] >> np.arange(8)) & 1, -1.0, 1.0).astype(np.float32)


def _nibbles(scales: np.ndarray) -> np.ndarray:
    """(B, n) bytes -> (B, n, 2) f32 low and high nibbles."""
    return np.stack([scales & 0xF, scales >> 4], axis=-1).astype(np.float32)


def planes_iq2_xxs(raw: np.ndarray):
    b = _u8(raw, 66)
    B = b.shape[0]
    d = _read_f16(b[:, 0:2])
    body = b[:, 2:].reshape(B, 8, 8)
    idx = body[:, :, 0:4].astype(np.int64)
    sig = _u32(body[:, :, 4:8].reshape(B, 8, 4)).reshape(B, 8)
    db = (0.5 + (sig >> 28).astype(np.float32)) * 0.25 * d[:, None]
    s7 = (sig[:, :, None] >> (7 * np.arange(4))[None, None, :]) & 127
    vals = GRID_IQ2XXS[idx] * KSIGN_MULT[s7]
    return vals.reshape(B, QK_K).astype(np.int8), db, None, 32


def planes_iq2_xs(raw: np.ndarray):
    b = _u8(raw, 74)
    B = b.shape[0]
    d = _read_f16(b[:, 0:2])
    qs = _u16(b[:, 2:66]).reshape(B, 8, 4)
    db = (0.5 + _nibbles(b[:, 66:74].astype(np.int64))) * 0.25 * d[:, None, None]
    vals = GRID_IQ2XS[qs & 511] * KSIGN_MULT[qs >> 9]
    return vals.reshape(B, QK_K).astype(np.int8), db.reshape(B, 16), None, 16


def planes_iq2_s(raw: np.ndarray):
    b = _u8(raw, 82)
    B = b.shape[0]
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:34].astype(np.int64).reshape(B, 8, 4)
    signs = b[:, 34:66].astype(np.int64).reshape(B, 8, 4)
    qh = b[:, 66:74].astype(np.int64)
    idx = qs | ((qh[:, :, None] << (8 - 2 * np.arange(4))[None, None, :]) & 0x300)
    db = (0.5 + _nibbles(b[:, 74:82].astype(np.int64))) * 0.25 * d[:, None, None]
    vals = GRID_IQ2S[idx] * _signs8(signs)
    return vals.reshape(B, QK_K).astype(np.int8), db.reshape(B, 16), None, 16


def planes_iq3_xxs(raw: np.ndarray):
    b = _u8(raw, 98)
    B = b.shape[0]
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:66].astype(np.int64).reshape(B, 8, 8)
    sas = _u32(b[:, 66:98]).reshape(B, 8)
    db = (0.5 + (sas >> 28).astype(np.float32)) * 0.5 * d[:, None]
    s7 = (sas[:, :, None] >> (7 * np.arange(4))[None, None, :]) & 127
    vals = GRID_IQ3XXS[qs].reshape(B, 8, 4, 8) * KSIGN_MULT[s7]
    return vals.reshape(B, QK_K).astype(np.int8), db, None, 32


def planes_iq3_s(raw: np.ndarray):
    b = _u8(raw, 110)
    B = b.shape[0]
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:66].astype(np.int64).reshape(B, 8, 8)
    qh = b[:, 66:74].astype(np.int64)
    signs = b[:, 74:106].astype(np.int64).reshape(B, 8, 4)
    idx = qs | (((qh[:, :, None] >> np.arange(8)[None, None, :]) & 1) << 8)
    vals = GRID_IQ3S[idx].reshape(B, 8, 4, 8) * _signs8(signs)
    nib = _nibbles(b[:, 106:110].astype(np.int64)).reshape(B, 8)
    db = (1.0 + 2.0 * nib) * d[:, None]
    return vals.reshape(B, QK_K).astype(np.int8), db, None, 32


def planes_iq1_s(raw: np.ndarray):
    b = _u8(raw, 50)
    B = b.shape[0]
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:34].astype(np.int64).reshape(B, 8, 4)
    qh = _u16(b[:, 34:50]).reshape(B, 8)
    dl = (2.0 * ((qh >> 12) & 7).astype(np.float32) + 1.0) * d[:, None]
    delta8 = np.where(qh & 0x8000, -1.0, 1.0).astype(np.float32)  # 8 * delta
    idx = qs | (((qh[:, :, None] >> (3 * np.arange(4))[None, None, :]) & 7) << 8)
    q = 8.0 * GRID_IQ1S[idx] + delta8[:, :, None, None]
    return q.reshape(B, QK_K).astype(np.int8), dl * 0.125, None, 32


def planes_iq1_m(raw: np.ndarray):
    b = _u8(raw, 56)
    B = b.shape[0]
    qs = b[:, 0:32].astype(np.int64).reshape(B, 8, 4)
    qh = b[:, 32:48].astype(np.int64).reshape(B, 8, 2)
    sc = _u16(b[:, 48:56]).reshape(B, 4)
    du16 = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00)
            | (sc[:, 3] & 0xF000))
    d = du16.astype("<u2").view("<f2").astype(np.float32)
    ib = np.arange(8)
    scw = sc[:, ib // 2]
    dl1 = 2.0 * ((scw >> (6 * (ib % 2))) & 7).astype(np.float32) + 1.0
    dl2 = 2.0 * ((scw >> (6 * (ib % 2) + 3)) & 7).astype(np.float32) + 1.0
    dl = np.stack([dl1, dl1, dl2, dl2], axis=-1) * d[:, None, None]  # (B, 8, 4)
    idx = np.empty((B, 8, 4), np.int64)
    idx[:, :, 0] = qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700)
    idx[:, :, 1] = qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700)
    idx[:, :, 2] = qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700)
    idx[:, :, 3] = qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)
    hbit = np.stack([qh[:, :, 0] & 0x08, qh[:, :, 0] & 0x80, qh[:, :, 1] & 0x08,
                     qh[:, :, 1] & 0x80], axis=-1)
    delta8 = np.where(hbit != 0, -1.0, 1.0).astype(np.float32)
    q = 8.0 * GRID_IQ1S[idx] + delta8[..., None]
    # one scale a codebook word of 8 values: group size 8
    return q.reshape(B, QK_K).astype(np.int8), (dl * 0.125).reshape(B, 32), None, 8


_POW3 = np.array([1, 3, 9, 27, 81, 243], np.uint16)


def _trits(q: np.ndarray, n: int) -> np.ndarray:
    """uint8 q -> (..., n) trits in {-1, 0, 1}: digit k is ((q * 3^k mod
    256) * 3) >> 8, ggml's multiply trick."""
    q = q.astype(np.uint16)
    return np.stack([((((q * _POW3[k]) & 0xFF) * 3) >> 8).astype(np.int8) - 1
                     for k in range(n)], axis=-1)


def planes_tq1_0(raw: np.ndarray):
    b = _u8(raw, 54)
    B = b.shape[0]
    d = _read_f16(b[:, 52:54])
    q = np.empty((B, QK_K), np.int8)
    q[:, 0:160] = np.moveaxis(_trits(b[:, 0:32], 5), -1, 1).reshape(B, 160)
    q[:, 160:240] = np.moveaxis(_trits(b[:, 32:48], 5), -1, 1).reshape(B, 80)
    q[:, 240:256] = np.moveaxis(_trits(b[:, 48:52], 4), -1, 1).reshape(B, 16)
    return q, d.reshape(B, 1), None, QK_K


def planes_tq2_0(raw: np.ndarray):
    b = _u8(raw, 66)
    B = b.shape[0]
    qs = b[:, 0:64].reshape(B, 2, 32)
    d = _read_f16(b[:, 64:66])
    shifts = (2 * np.arange(4))[None, None, :, None]
    q = ((qs[:, :, None, :] >> shifts) & 3).astype(np.int8) - 1
    return q.reshape(B, QK_K), d.reshape(B, 1), None, QK_K


# by GGML type name
PLANE_FNS = {
    "IQ2_XXS": planes_iq2_xxs, "IQ2_XS": planes_iq2_xs, "IQ2_S": planes_iq2_s,
    "IQ3_XXS": planes_iq3_xxs, "IQ3_S": planes_iq3_s, "IQ1_S": planes_iq1_s,
    "IQ1_M": planes_iq1_m, "TQ1_0": planes_tq1_0, "TQ2_0": planes_tq2_0,
}
