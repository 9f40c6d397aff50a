"""Context state files: full-context and per-sequence. Counterpart of
llm_tpu/runtime/state.py (llama.cpp's llama_state_* and llama_state_seq_*,
used for --prompt-cache and the server's slot save/restore).

The format is the JAX package's, key for key, so a file written by either
package loads in the other: an npz with the magic string, the occupied
cells' positions and sequence bit-sets, the token history, the layer count,
and each layer's K and V rows TOKEN-MAJOR [n, Hkv, D] in f32, whatever the
cache's layout or type. A q8_0 cache is dequantized on save (q * s in f32)
and quantized again on load by the cache's own quantizer; for rows that
quantizer wrote, that round trip gives back the same int8 and scale bits.

With the ISWA dual cache the sliding-window layers' rows come from their
ring, whose occupied cells are saved with their metadata under swa_* keys
(swa_pos, and swa_seq_bits in a full-context file), and a ring Context
loads them back into its ring; a ring Context refuses a file without
them. A Context without a ring ignores swa_* keys, as llm_tpu's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.transformer import quantize_rows
from .kv_cache import planes_from_u64, seq_bit_row

MAGIC = "llm_tpu_state_v1"


def _bits_planes(arr: np.ndarray) -> np.ndarray:
    """[n, SEQ_WORDS] uint32 planes (current files) or legacy [n] uint64
    single-word bit-sets."""
    if arr.ndim == 1:
        return planes_from_u64(arr)
    return np.asarray(arr, np.uint32)


def _rows_to_f32(cache, idx: np.ndarray) -> np.ndarray:
    """Cells idx of a head-major cache as token-major f32 rows [n, Hkv, D];
    a q8_0 pair dequantized as q * s in f32."""
    if isinstance(cache, tuple):
        q8, sc = cache
        ii = torch.as_tensor(idx, dtype=torch.long, device=q8.device)
        q = q8[:, ii].float()
        s = sc[:, ii].float().repeat_interleave(q.shape[-1] // sc.shape[-1], dim=-1)
        rows = q * s
    else:
        rows = cache[:, torch.as_tensor(idx, dtype=torch.long, device=cache.device)].float()
    return rows.transpose(0, 1).cpu().numpy()


def _set_rows(cache, idx: np.ndarray, rows_f32: np.ndarray) -> None:
    """Write token-major f32 rows [n, Hkv, D] into cells idx of a
    head-major cache, in place, quantizing for a q8_0 pair."""
    first = cache[0] if isinstance(cache, tuple) else cache
    ii = torch.as_tensor(idx, dtype=torch.long, device=first.device)
    rows = torch.from_numpy(np.asarray(rows_f32, np.float32)).to(first.device)
    if isinstance(cache, tuple):
        q8, sc = cache
        q, s = quantize_rows(rows, sc.shape[-1])
        q8.index_copy_(1, ii, q.transpose(0, 1))
        sc.index_copy_(1, ii, s.transpose(0, 1))
        return
    cache.index_copy_(1, ii, rows.transpose(0, 1).to(cache.dtype))


def _check(ctx, d, magic: str) -> None:
    if str(d["magic"]) != magic:
        raise ValueError(f"not a llm_tpu {'per-seq ' if magic != MAGIC else ''}state file")
    if int(d["n_layers"]) != ctx.cfg.n_layers:
        raise ValueError("layer count mismatch")
    if ctx.cells_swa is not None and "swa_pos" not in d.files:
        raise ValueError("state file lacks SWA ring data for this model")


def _ring_layer(ctx, il: int) -> bool:
    return ctx.cells_swa is not None and ctx.cfg.layer_is_swa(il)


def _save(ctx, path: str, magic: str, used: np.ndarray, used_swa, tokens,
          extra: dict) -> None:
    """used: the full table's cells to save; used_swa: the ring's (None
    without a ring)."""
    data = {
        "magic": np.asarray(magic),
        "pos": ctx.cells.pos[used],
        **extra,
        "tokens": np.asarray(tokens if tokens is not None else [], np.int32),
        "n_layers": np.asarray(ctx.cfg.n_layers),
    }
    if used_swa is not None:
        data["swa_pos"] = ctx.cells_swa.pos[used_swa]
    for il in range(ctx.cfg.n_layers):
        src = used_swa if _ring_layer(ctx, il) else used
        data[f"k{il}"] = _rows_to_f32(ctx.kv.k[il], src)
        data[f"v{il}"] = _rows_to_f32(ctx.kv.v[il], src)
    np.savez_compressed(path, **data)


def _load_rows(ctx, d, slots: np.ndarray, slots_swa) -> None:
    for il in range(ctx.cfg.n_layers):
        dst = slots_swa if _ring_layer(ctx, il) else slots
        _set_rows(ctx.kv.k[il], dst, d[f"k{il}"])
        _set_rows(ctx.kv.v[il], dst, d[f"v{il}"])


def state_save(ctx, path: str, tokens: list[int] | None = None) -> None:
    """Full context state: every occupied cell and its KV rows (with the
    ring, its occupied cells and their rows too)."""
    used = np.flatnonzero(ctx.cells.used_mask()).astype(np.int32)
    extra, used_swa = {"seq_bits": ctx.cells.seq_bits[used]}, None
    if ctx.cells_swa is not None:
        used_swa = np.flatnonzero(ctx.cells_swa.used_mask()).astype(np.int32)
        extra["swa_seq_bits"] = ctx.cells_swa.seq_bits[used_swa]
    _save(ctx, path, MAGIC, used, used_swa, tokens, extra)


def state_load(ctx, path: str) -> list[int]:
    """Restore a full-context state; returns the saved token history."""
    with np.load(path, allow_pickle=False) as d:
        _check(ctx, d, MAGIC)
        n = len(d["pos"])
        ctx.clear()
        slots = ctx.cells.find_slots(n)
        if slots is None:
            raise ValueError(f"cache too small for saved state ({n} cells)")
        ctx.cells.pos[slots] = d["pos"]
        ctx.cells.seq_bits[slots] = _bits_planes(d["seq_bits"])
        slots_swa = None
        if ctx.cells_swa is not None:
            slots_swa = ctx.cells_swa.find_slots(len(d["swa_pos"]))
            if slots_swa is None:
                raise ValueError("SWA ring too small for saved state")
            ctx.cells_swa.pos[slots_swa] = d["swa_pos"]
            ctx.cells_swa.seq_bits[slots_swa] = _bits_planes(d["swa_seq_bits"])
        _load_rows(ctx, d, slots, slots_swa)
        return [int(t) for t in d["tokens"]]


def state_seq_save(ctx, seq_id: int, path: str, tokens: list[int] | None = None) -> None:
    """One sequence's cells, in position order (llama_state_seq_get_data);
    with the ring, its cells of the sequence too."""
    used = np.flatnonzero(ctx.cells.seq_mask(seq_id)).astype(np.int32)
    used = used[np.argsort(ctx.cells.pos[used], kind="stable")]
    used_swa = None
    if ctx.cells_swa is not None:
        used_swa = np.flatnonzero(ctx.cells_swa.seq_mask(seq_id)).astype(np.int32)
        used_swa = used_swa[np.argsort(ctx.cells_swa.pos[used_swa], kind="stable")]
    _save(ctx, path, MAGIC + "_seq", used, used_swa, tokens, {})


def state_seq_load(ctx, seq_id: int, path: str) -> list[int]:
    """Restore a sequence into `seq_id` (llama_state_seq_set_data);
    returns the saved token history."""
    with np.load(path, allow_pickle=False) as d:
        _check(ctx, d, MAGIC + "_seq")
        ctx.seq_rm(seq_id)
        n = len(d["pos"])
        slots = ctx.cells.find_slots(n)
        if slots is None:
            raise ValueError("no KV space for sequence state")
        ctx.cells.pos[slots] = d["pos"]
        ctx.cells.seq_bits[slots] = seq_bit_row(seq_id)
        slots_swa = None
        if ctx.cells_swa is not None:
            slots_swa = ctx.cells_swa.find_slots(len(d["swa_pos"]))
            if slots_swa is None:
                raise ValueError("no SWA ring space for sequence state")
            ctx.cells_swa.pos[slots_swa] = d["swa_pos"]
            ctx.cells_swa.seq_bits[slots_swa] = seq_bit_row(seq_id)
        _load_rows(ctx, d, slots, slots_swa)
        return [int(t) for t in d["tokens"]]
