"""Unified KV cache: device tensors plus a host-side cell table.
Counterpart of llm_tpu/runtime/kv_cache.py (dense and q8_0 caches, and
the ISWA ring: SWACellTable, the cell table of the sliding-window layers'
smaller cache).

Cell metadata (position, sequence bit-set) lives on the host in numpy; each
step ships the cell positions and bit-sets to the device, where the mask
is built. K is cached unroped, so seq_add / seq_div (context shift,
self-extend) are metadata edits. Cells need not be contiguous: steps
scatter K/V rows to arbitrary cells.

The cache is HEAD-MAJOR: k[il], v[il] are [Hkv, n_cells, D], so each KV
head's cells are one contiguous plane for the flash kernels. A q8_0 cache
(llama.cpp's --cache-type-k/v q8_0) holds per layer an (int8 [Hkv, S, D],
bf16 scales [Hkv, S, D // g]) pair: one scale per head row when D is a
multiple of 128 (the layout K3q/K4q read), else per 32-group.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MAX_SEQS = 256  # sequence ids 0..255
SEQ_WORDS = MAX_SEQS // 32  # [n_cells, SEQ_WORDS] uint32 bit-set words
KV_QUANT_GROUP = 32


def seq_bit_row(seq_id: int) -> np.ndarray:
    """[SEQ_WORDS] uint32 bit-set with only `seq_id` set."""
    row = np.zeros(SEQ_WORDS, np.uint32)
    row[seq_id >> 5] = np.uint32(1) << np.uint32(seq_id & 31)
    return row


def pack_seq_sets(seq_sets) -> np.ndarray:
    """list of seq-id iterables -> [n, SEQ_WORDS] uint32 bit-sets."""
    bits = np.zeros((len(seq_sets), SEQ_WORDS), np.uint32)
    for i, ss in enumerate(seq_sets):
        for s in ss:
            bits[i, s >> 5] |= np.uint32(1) << np.uint32(s & 31)
    return bits


def planes_from_u64(bits64: np.ndarray) -> np.ndarray:
    """Legacy uint64 [n] bit-sets -> [n, SEQ_WORDS] uint32 planes (old
    state files stored the 64-sequence single-word form)."""
    out = np.zeros((len(bits64), SEQ_WORDS), np.uint32)
    out[:, 0] = (bits64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 1] = (bits64 >> np.uint64(32)).astype(np.uint32)
    return out


def kv_group(d: int) -> int:
    """q8_0 scale group along a head row of d dims: the whole row when d is
    a multiple of 128 (one scale per row, as the flash kernels read it),
    else 32 where it divides d, else d."""
    if d % 128 == 0:
        return d
    return KV_QUANT_GROUP if d % KV_QUANT_GROUP == 0 else d


@dataclass
class KVArrays:
    # per layer [Hkv, n_cells, D] tensors (K unroped), or (int8, bf16
    # scales [Hkv, n_cells, D // g]) pairs for a q8_0 cache
    k: list
    v: list

    @property
    def n_cells(self) -> int:
        a = self.k[0]
        return (a[0] if isinstance(a, tuple) else a).shape[1]


def new_kv_arrays(n_layers: int, n_cells: int, n_kv_heads: int, head_dim_k: int,
                  head_dim_v: int, dtype=torch.bfloat16, device="cuda",
                  row_counts=None) -> KVArrays:
    """dtype: a torch dtype for a dense cache, or "q8_0" for int8 rows with
    bf16 scales (kv_group). row_counts: each layer's cells (the ISWA ring's
    for its sliding-window layers); None: n_cells for every layer."""
    rows = list(row_counts) if row_counts is not None else [n_cells] * n_layers

    def plane(n, d):
        if dtype == "q8_0":
            return (torch.zeros((n_kv_heads, n, d), dtype=torch.int8, device=device),
                    torch.zeros((n_kv_heads, n, d // kv_group(d)),
                                dtype=torch.bfloat16, device=device))
        return torch.zeros((n_kv_heads, n, d), dtype=dtype, device=device)

    return KVArrays(k=[plane(n, head_dim_k) for n in rows],
                    v=[plane(n, head_dim_v) for n in rows])


class CellTable:
    """Host metadata for each cache cell (llama_kv_cells analogue)."""

    def __init__(self, n_cells: int):
        self.n_cells = n_cells
        self.pos = np.full(n_cells, -1, np.int32)
        self.seq_bits = np.zeros((n_cells, SEQ_WORDS), np.uint32)

    def used_mask(self) -> np.ndarray:
        return self.seq_bits.any(axis=1)

    @property
    def n_used(self) -> int:
        return int(np.count_nonzero(self.used_mask()))

    def seq_mask(self, seq_id: int) -> np.ndarray:
        bit = np.uint32(1) << np.uint32(seq_id & 31)
        return (self.seq_bits[:, seq_id >> 5] & bit) != 0

    def device_bits(self, device) -> torch.Tensor:
        """[n_cells, SEQ_WORDS] bit-set words as int64 on device (torch's
        uint32 supports few ops; each word keeps its 32 bits)."""
        return torch.from_numpy(self.seq_bits.astype(np.int64)).to(device)

    def seq_pos_min(self, seq_id: int) -> int:
        m = self.seq_mask(seq_id)
        return int(self.pos[m].min()) if m.any() else -1

    def seq_pos_max(self, seq_id: int) -> int:
        m = self.seq_mask(seq_id)
        return int(self.pos[m].max()) if m.any() else -1

    def n_seq_cells(self, seq_id: int) -> int:
        return int(np.count_nonzero(self.seq_mask(seq_id)))

    def find_slots(self, n: int) -> np.ndarray | None:
        """Indices of n free cells, or None if the cache is full."""
        free = np.flatnonzero(~self.used_mask())
        if len(free) < n:
            return None
        return free[:n].astype(np.int32)

    def occupy(self, idx: np.ndarray, pos: np.ndarray, seq_ids: np.ndarray) -> None:
        self.pos[idx] = pos
        seq_ids = np.asarray(seq_ids, np.int64)
        self.seq_bits[idx] = 0
        self.seq_bits[idx, seq_ids >> 5] = np.uint32(1) << (seq_ids & 31).astype(np.uint32)

    def release(self, idx: np.ndarray) -> None:
        self.pos[idx] = -1
        self.seq_bits[idx] = 0

    def _range_mask(self, seq_id: int, p0: int, p1: int) -> np.ndarray:
        p0 = max(p0, 0)
        p1 = np.iinfo(np.int32).max if p1 < 0 else p1
        return self.seq_mask(seq_id) & (self.pos >= p0) & (self.pos < p1)

    def seq_rm(self, seq_id: int, p0: int = -1, p1: int = -1) -> None:
        m = self._range_mask(seq_id, p0, p1)
        self.seq_bits[m, seq_id >> 5] &= ~(np.uint32(1) << np.uint32(seq_id & 31))
        self.pos[m & ~self.used_mask()] = -1

    def seq_cp(self, src: int, dst: int, p0: int = -1, p1: int = -1) -> None:
        m = self._range_mask(src, p0, p1)
        self.seq_bits[m, dst >> 5] |= np.uint32(1) << np.uint32(dst & 31)

    def seq_keep(self, seq_id: int) -> None:
        keep = self.seq_mask(seq_id)
        self.seq_bits[:] = 0
        self.seq_bits[keep, seq_id >> 5] = np.uint32(1) << np.uint32(seq_id & 31)
        self.pos[~keep] = -1

    def seq_add(self, seq_id: int, p0: int, p1: int, delta: int) -> None:
        """Shift positions (context shift); cells pushed below 0 are removed."""
        m = self._range_mask(seq_id, p0, p1)
        self.pos[m] += delta
        dead = m & (self.pos < 0)
        self.seq_bits[dead] = 0
        self.pos[dead] = -1

    def seq_div(self, seq_id: int, p0: int, p1: int, d: int) -> None:
        """Divide positions (self-extend group attention)."""
        m = self._range_mask(seq_id, p0, p1)
        self.pos[m] = self.pos[m] // d

    def clear(self) -> None:
        self.pos[:] = -1
        self.seq_bits[:] = 0


class SWACellTable(CellTable):
    """Ring cell table for sliding-window layers (the small half of the
    ISWA dual cache; llm_tpu/runtime/kv_cache.py SWACellTable): cells whose
    position has slid out of every member sequence's window are pruned when
    space is needed, exactly the cells the window mask would hide anyway, so
    pruning never changes outputs."""

    def __init__(self, n_cells: int, window: int):
        super().__init__(n_cells)
        self.window = window

    def prune(self) -> None:
        occupied = self.used_mask()
        if not occupied.any():
            return
        live = np.zeros(self.n_cells, bool)
        all_bits = np.bitwise_or.reduce(self.seq_bits, axis=0)
        for s in range(MAX_SEQS):
            if not (int(all_bits[s >> 5]) >> (s & 31)) & 1:
                continue
            m = self.seq_mask(s)
            pmax = int(self.pos[m].max())
            # visible to some future query of seq s: qp - pos < window with
            # qp >= pmax + 1, so pos > pmax + 1 - window
            live |= m & (self.pos > pmax + 1 - self.window)
        dead = occupied & ~live
        self.seq_bits[dead] = 0
        self.pos[dead] = -1

    def find_slots(self, n: int) -> np.ndarray | None:
        r = super().find_slots(n)
        if r is None:
            self.prune()
            r = super().find_slots(n)
        return r
