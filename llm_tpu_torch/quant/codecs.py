"""GGUF block-format helpers (numpy): the port's own copy of the parts of
llm_tpu/quant/codecs.py that plane unpacking and dense loading read."""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType

# IQ4's non-linear 4-bit codebook (ggml-common.h kvalues_iq4nl)
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.float32,
)


def _u8(raw: np.ndarray, ts: int) -> np.ndarray:
    """Raw bytes -> [n_blocks, ts] uint8 rows of one block each."""
    raw = np.ascontiguousarray(raw).view(np.uint8)
    if raw.size % ts:
        raise ValueError(f"raw size {raw.size} not a multiple of block size {ts}")
    return raw.reshape(-1, ts)


def _read_f16(b: np.ndarray) -> np.ndarray:
    """View consecutive uint8 pairs (last axis) as little-endian f16 -> f32."""
    return (
        np.ascontiguousarray(b).view(np.dtype("<f2")).astype(np.float32).reshape(b.shape[0], -1)
    )


def _unpack_k4_scales(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12 bytes -> 8 6-bit (scale, min) pairs (get_scale_min_k4 layout)."""
    B = sc.shape[0]
    ls = np.empty((B, 8), np.int32)
    lm = np.empty((B, 8), np.int32)
    for j in range(8):
        if j < 4:
            ls[:, j] = sc[:, j] & 63
            lm[:, j] = sc[:, j + 4] & 63
        else:
            ls[:, j] = (sc[:, j + 4] & 0xF) | ((sc[:, j - 4] >> 6) << 4)
            lm[:, j] = (sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4)
    return ls, lm


def _unpack2(qs: np.ndarray) -> np.ndarray:
    """Q2_K / Q3_K's 2-bit field (B, 64) -> (B, 256) values 0..3: per
    128-value half, byte l holds values l, l + 32, l + 64 and l + 96."""
    B = qs.shape[0]
    q = qs.reshape(B, 2, 32)
    out = np.stack([(q >> s) & 3 for s in (0, 2, 4, 6)], axis=2)  # (B, 2, 4, 32)
    return out.reshape(B, 256)


def _q3k_scales(sc_bytes: np.ndarray) -> np.ndarray:
    """Q3_K's 12-byte field -> 16 signed 6-bit scales."""
    B = sc_bytes.shape[0]
    out = np.empty((B, 16), np.int32)
    for j in range(16):
        lo = sc_bytes[:, j] & 0xF if j < 8 else sc_bytes[:, j - 8] >> 4
        hi = (sc_bytes[:, 8 + j % 4] >> (2 * (j // 4))) & 3
        out[:, j] = (lo.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32
    return out


def dequantize_dense(raw: np.ndarray, ggml_type: GGMLType | int,
                     shape: tuple[int, ...]) -> np.ndarray:
    """F32 / F16 / BF16 tensor bytes -> f32 array in numpy order (the GGUF
    ne shape reversed)."""
    t = GGMLType(ggml_type)
    raw = np.ascontiguousarray(raw)
    if t == GGMLType.F32:
        out = raw.view("<f4").astype(np.float32)
    elif t == GGMLType.F16:
        out = raw.view("<f2").astype(np.float32)
    elif t == GGMLType.BF16:
        out = (raw.view("<u2").astype(np.uint32) << 16).view(np.float32)
    else:
        raise ValueError(f"{t.name} is not a dense type")
    return out.reshape(tuple(reversed(shape)) if shape else (1,))
