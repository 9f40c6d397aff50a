"""GGUF v3 writer: the port's own copy of llm_tpu/gguf/writer.py (numpy,
the same bytes for the same calls).

Produces files readable by any GGUF consumer (the public GGUF v3 layout:
header, metadata, tensor infos, aligned tensor data). chip_smoke.py writes
its LLAMA3_8B Q4_K_M-typed file with it; the tests write tiny ones.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    Keys,
    tensor_nbytes,
)

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<B",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
    np.dtype(bool): GGUFValueType.BOOL,
}


def _infer_vtype(val) -> GGUFValueType:
    if isinstance(val, bool):
        return GGUFValueType.BOOL
    if isinstance(val, int):
        if val < 0:
            return GGUFValueType.INT64 if val < -(2**31) else GGUFValueType.INT32
        return GGUFValueType.UINT64 if val >= 2**32 else GGUFValueType.UINT32
    if isinstance(val, float):
        return GGUFValueType.FLOAT32
    if isinstance(val, str):
        return GGUFValueType.STRING
    if isinstance(val, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    if isinstance(val, np.generic):
        return _NP_TO_VTYPE[val.dtype]
    raise TypeError(f"cannot infer GGUF value type for {type(val)}")


@dataclass
class _PendingTensor:
    name: str
    shape: tuple[int, ...]
    ggml_type: GGMLType
    raw: np.ndarray  # uint8 on-disk bytes


class GGUFWriter:
    def __init__(self, path: str, arch: str | None = None,
                 alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self._kv: dict[str, tuple[GGUFValueType, object]] = {}
        self._tensors: list[_PendingTensor] = []
        if arch is not None:
            self.add_kv(Keys.General.ARCHITECTURE, arch)
        if alignment != GGUF_DEFAULT_ALIGNMENT:
            self.add_kv(Keys.General.ALIGNMENT, np.uint32(alignment))

    # -- metadata -----------------------------------------------------------

    def add_kv(self, key: str, val, vtype: GGUFValueType | None = None) -> None:
        if key in self._kv:
            raise ValueError(f"duplicate metadata key {key!r}")
        self._kv[key] = (_infer_vtype(val) if vtype is None else vtype, val)

    # -- tensors ------------------------------------------------------------

    def add_tensor(self, name: str, array: np.ndarray,
                   ggml_type: GGMLType | None = None,
                   raw: np.ndarray | None = None,
                   shape: tuple[int, ...] | None = None) -> None:
        """Add a tensor. Either `array` is a float/int array stored directly
        (F32/F16/BF16/I*), or `raw` holds pre-quantized bytes with the logical
        `shape` given in ne order (shape[0] = row length).

        Note: numpy arrays use C order (last axis fastest); GGUF `ne` is
        fastest-first, so a numpy array of shape (a, b) becomes ne=(b, a).
        """
        if any(t.name == name for t in self._tensors):
            raise ValueError(f"duplicate tensor {name!r}")
        if raw is not None:
            assert ggml_type is not None and shape is not None
            expect = tensor_nbytes(ggml_type, shape)
            raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
            if raw.nbytes != expect:
                raise ValueError(
                    f"tensor {name!r}: raw size {raw.nbytes} != expected {expect}")
            self._tensors.append(_PendingTensor(name, tuple(shape), ggml_type, raw))
            return

        array = np.ascontiguousarray(array)
        ne = tuple(reversed(array.shape)) if array.ndim else (1,)
        if ggml_type is None:
            ggml_type = {
                np.dtype(np.float32): GGMLType.F32,
                np.dtype(np.float16): GGMLType.F16,
                np.dtype(np.int32): GGMLType.I32,
                np.dtype(np.int64): GGMLType.I64,
                np.dtype(np.int16): GGMLType.I16,
                np.dtype(np.int8): GGMLType.I8,
            }[array.dtype]
        elif ggml_type == GGMLType.F32:
            array = array.astype(np.float32)
        elif ggml_type == GGMLType.F16:
            array = array.astype(np.float16)
        elif ggml_type == GGMLType.BF16:
            u = array.astype(np.float32).view(np.uint32).astype(np.uint64)
            array = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
        else:
            raise ValueError(f"add_tensor cannot encode {ggml_type} directly; "
                             "pass raw= with pre-quantized bytes")
        self._tensors.append(
            _PendingTensor(name, ne, ggml_type, array.view(np.uint8).reshape(-1)))

    # -- serialization ------------------------------------------------------

    @staticmethod
    def _pack_string(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _pack_value(self, vtype: GGUFValueType, val) -> bytes:
        if vtype == GGUFValueType.STRING:
            return self._pack_string(str(val))
        if vtype == GGUFValueType.ARRAY:
            if isinstance(val, np.ndarray) and val.dtype != object:
                etype = _NP_TO_VTYPE[val.dtype]
                hdr = struct.pack("<IQ", int(etype), val.size)
                if etype == GGUFValueType.BOOL:
                    return hdr + val.astype(np.uint8).tobytes()
                return hdr + np.ascontiguousarray(val).tobytes()
            val = list(val)
            etype = _infer_vtype(val[0]) if val else GGUFValueType.STRING
            out = [struct.pack("<IQ", int(etype), len(val))]
            for v in val:
                out.append(self._pack_value(etype, v))
            return b"".join(out)
        if vtype in (GGUFValueType.FLOAT32, GGUFValueType.FLOAT64):
            return struct.pack(_SCALAR_FMT[vtype], float(val))
        return struct.pack(_SCALAR_FMT[vtype], int(val))

    def write(self) -> None:
        align = self.alignment
        header = [GGUF_MAGIC, struct.pack("<IQQ", GGUF_VERSION,
                                          len(self._tensors), len(self._kv))]
        for key, (vtype, val) in self._kv.items():
            header.append(self._pack_string(key))
            header.append(struct.pack("<I", int(vtype)))
            header.append(self._pack_value(vtype, val))

        offset = 0
        offsets = []
        for t in self._tensors:
            offsets.append(offset)
            offset += (t.raw.nbytes + align - 1) // align * align
        for t, off in zip(self._tensors, offsets):
            header.append(self._pack_string(t.name))
            header.append(struct.pack("<I", len(t.shape)))
            header.append(struct.pack(f"<{len(t.shape)}Q", *t.shape))
            header.append(struct.pack("<IQ", int(t.ggml_type), off))

        head = b"".join(header)
        pad = (-len(head)) % align
        with open(self.path, "wb") as f:
            f.write(head)
            f.write(b"\x00" * pad)
            pos = 0
            for t in self._tensors:
                f.write(t.raw.tobytes())
                pos += t.raw.nbytes
                fill = (-pos) % align
                f.write(b"\x00" * fill)
                pos += fill
