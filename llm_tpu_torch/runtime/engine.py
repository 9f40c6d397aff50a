"""Context: the execution engine. Counterpart of
llm_tpu/runtime/engine.py::Context for the llama path: decode(batch) with
ubatch splitting, KV slot allocation and the logits output map; an
eager generation loop (greedy, or temperature/top-k through a
torch.Generator); the sequence ops on the cell table; and the perf
counters (PerfCounters, ctx.perf) that tools/cli.py prints, counted as the
reference counts them: a ubatch of more than one token is prefill, a
one-token decode and every token of generate_loop is decode.

Steps run eagerly on `device` (default: the card). Token counts are padded
to TOKEN_BUCKETS so every step has one of a few static shapes (what a
later CUDA-graph capture of decode needs). Padding tokens write to cell
n_cells, which the KV scatter drops.

Return codes follow llama_decode: 0 ok, 1 no KV slot, -1 invalid.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.loader import load_params, stack_layers
from ..models.transformer import check_supported, forward, layer_views
from ..quant.qtensor import QTensor
from .batch import Batch, sanitize, split_simple
from .kv_cache import MAX_SEQS, CellTable, new_kv_arrays, pack_seq_sets

TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
N_UBATCH = 512  # tokens per step; longer batches are split


def _bucket(n: int, buckets=TOKEN_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


@dataclass
class PerfCounters:
    """llama_perf_context analogue (llama.h:1440-1447); the reference's
    PerfCounters, with the same summary text."""

    t_load_ms: float = 0.0
    t_prefill_ms: float = 0.0
    t_decode_ms: float = 0.0
    n_prefill: int = 0
    n_decode: int = 0

    def summary(self) -> str:
        pp = self.n_prefill / self.t_prefill_ms * 1e3 if self.t_prefill_ms else 0.0
        tg = self.n_decode / self.t_decode_ms * 1e3 if self.t_decode_ms else 0.0
        return (
            f"load {self.t_load_ms:.0f} ms | "
            f"prefill {self.n_prefill} tok @ {pp:.2f} t/s | "
            f"decode {self.n_decode} tok @ {tg:.2f} t/s"
        )


def params_to(params, device):
    """Move a params tree (dicts, lists, QTensors, tensors) to device."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    if isinstance(params, (QTensor, torch.Tensor)):
        return params.to(device)
    return params


class Context:
    def __init__(self, reader=None, n_cells: int = 4096, dtype=torch.bfloat16,
                 device=None, params_cfg=None, kv_dtype=None, chain: bool = False,
                 gdot: bool = False, scan_layers: bool = False):
        """Load from a GGUFReader, or take (params, cfg) as made by
        models/synthetic.py or convert_params.py. device None = the card.
        kv_dtype: the cache type, None for `dtype`, a torch dtype, or
        "q8_0" for int8 rows with bf16 scales (llama.cpp's
        --cache-type-k/v q8_0). chain: decode steps (T <= 8) run the
        chained kernel K6 where its gates admit a layer (the reference's
        LLM_TPU_CHAIN=1); gdot: unfused p4 matmuls at B <= 16 run K5
        (LLM_TPU_GDOT=force). Both are off by default, as in the reference.
        scan_layers: stack uniform layers (the reference's lax.scan decoder;
        here a loop whose matmuls read one layer of the stacked planes, K7);
        layers that do not stack run per layer, as in the reference. Params
        that come stacked (params["layers_stacked"]) run stacked whatever the
        option."""
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        if params_cfg is not None:
            params, self.cfg = params_cfg
            self.params = params_to(params, self.device)
            if scan_layers and "layers_stacked" not in self.params:
                stacked = stack_layers(self.params["layers"])
                if stacked is not None:
                    self.params = {**self.params, "layers_stacked": stacked, "layers": []}
        else:
            self.params, self.cfg = load_params(reader, dense_dtype=dtype,
                                                device=self.device, scan_layers=scan_layers)
        self.kv_dtype = kv_dtype if kv_dtype is not None else dtype
        check_supported(self.params, self.cfg, kv_q8=self.kv_dtype == "q8_0")
        self.scan = "layers_stacked" in self.params
        # the layers' dicts of StackedWeights on the stacked planes, made once
        self.stacked_layers = (layer_views(self.params["layers_stacked"])
                               if self.scan else None)
        self.dtype = dtype
        self.chain, self.gdot = chain, gdot
        self.n_cells = n_cells
        self.cells = CellTable(n_cells)
        cfg = self.cfg
        self.kv = new_kv_arrays(cfg.n_layers, n_cells, cfg.n_kv_heads, cfg.head_dim,
                                cfg.head_dim_v, self.kv_dtype, self.device)
        self._logits: dict[int, np.ndarray] = {}
        self.rslots = None  # recurrent state slots: no recurrent model is ported
        self.perf = PerfCounters()
        self.perf.t_load_ms = (time.perf_counter() - t0) * 1e3

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64)).to(self.device)

    def _step(self, tokens, pos, seq, widx, cpos, cbits, oidx):
        logits, _ = forward(self.params, self.cfg, self.kv.k, self.kv.v,
                            tokens, pos, seq, widx, cpos, cbits, oidx,
                            dtype=self.dtype, chain=self.chain, gdot=self.gdot,
                            stacked_layers=self.stacked_layers)
        return logits

    def decode(self, batch: Batch) -> int:
        if len(batch) == 0:
            return -1
        for seqs in batch.seq_ids:
            for s in seqs or (0,):
                if not (0 <= s < MAX_SEQS):
                    return -1
        batch = sanitize(batch, self.cells)
        self._logits.clear()
        for ub in split_simple(batch, N_UBATCH):
            n = len(ub.tokens)
            slots = self.cells.find_slots(n)
            if slots is None:
                return 1
            t0 = time.perf_counter()
            T = _bucket(n)
            out_rows = np.flatnonzero(ub.out_mask)
            O = _bucket(max(1, len(out_rows)))
            tokens = np.zeros(T, np.int64)
            pos = np.zeros(T, np.int64)
            seq = np.zeros(T, np.int64)
            widx = np.full(T, self.n_cells, np.int64)  # padding -> dropped
            tokens[:n], pos[:n], seq[:n], widx[:n] = ub.tokens, ub.pos, ub.seq_primary, slots
            oidx = np.zeros(O, np.int64)
            oidx[: len(out_rows)] = out_rows
            # occupy cells BEFORE the step so the ubatch attends to itself
            self.cells.pos[slots] = ub.pos
            self.cells.seq_bits[slots] = pack_seq_sets(ub.seq_sets)
            try:
                logits = self._step(self._t(tokens), self._t(pos), self._t(seq),
                                    self._t(widx), self._t(self.cells.pos),
                                    self.cells.device_bits(self.device), self._t(oidx))
            except Exception:
                self.cells.release(slots)
                raise
            logits_np = logits[: len(out_rows)].float().cpu().numpy()
            for i, bi in enumerate(ub.orig_index[out_rows]):
                self._logits[int(bi)] = logits_np[i]
            dt = (time.perf_counter() - t0) * 1e3
            if n > 1:
                self.perf.t_prefill_ms += dt
                self.perf.n_prefill += n
            else:
                self.perf.t_decode_ms += dt
                self.perf.n_decode += 1
        return 0

    def get_logits(self, i: int = -1) -> np.ndarray:
        """Logits for batch token index i (llama_get_logits_ith)."""
        if i == -1:
            i = max(self._logits.keys())
        return self._logits[i]

    def generate_loop(self, first_token: int, n_tokens: int, *, seq_id: int = 0,
                      temp: float = 0.0, top_k: int = 0, seed: int = 0,
                      eog_ids=()) -> list[int]:
        """Decode up to n_tokens one token at a time from first_token,
        sampling in-graph (greedy at temp 0, else temperature and top-k from
        a torch.Generator seeded with `seed`); stops after an EOG token.
        Cells are allocated and labeled with their positions up front; each
        step makes its own cell visible to the sequence."""
        if not (0 <= seq_id < MAX_SEQS):
            raise ValueError(f"bad seq_id {seq_id}")
        n = int(n_tokens)
        if n <= 0:
            return []
        slots = self.cells.find_slots(n)
        if slots is None:
            raise RuntimeError("generate_loop: no free KV cells")
        pos0 = self.cells.seq_pos_max(seq_id) + 1
        t0 = time.perf_counter()
        cpos = self.cells.pos.astype(np.int64)
        cpos[slots] = pos0 + np.arange(n)
        cpos = self._t(cpos)
        cbits = self.cells.device_bits(self.device)
        word, bit = seq_id >> 5, 1 << (seq_id & 31)
        seq = self._t([seq_id])
        oidx = self._t([0])
        slots_d = self._t(slots)
        gen = None
        if temp > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        eogs = set(int(e) for e in eog_ids)
        tok = self._t([first_token])
        out: list[int] = []
        for i in range(n):
            cbits[slots[i], word] |= bit
            logits = self._step(tok, self._t([pos0 + i]), seq, slots_d[i:i + 1],
                                cpos, cbits, oidx)[0]
            if temp <= 0.0:
                nxt = torch.argmax(logits)
            else:
                lg = logits / temp
                if top_k > 0:
                    kth = torch.topk(lg, top_k).values[-1]
                    lg = torch.where(lg < kth, torch.full_like(lg, float("-inf")), lg)
                nxt = torch.multinomial(torch.softmax(lg, -1), 1, generator=gen)[0]
            tok = nxt.reshape(1)
            out.append(int(nxt))  # the per-token host sync of this eager loop
            if out[-1] in eogs:
                break
        cnt = len(out)
        self.cells.occupy(slots[:cnt], pos0 + np.arange(cnt, dtype=np.int32),
                          np.full(cnt, seq_id, np.int64))
        self._logits.clear()
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1e3
        self.perf.n_decode += cnt
        return out

    # -- memory (seq) API ------------------------------------------------------

    def seq_rm(self, seq_id, p0=-1, p1=-1):
        self.cells.seq_rm(seq_id, p0, p1)
        return True

    def seq_cp(self, src, dst, p0=-1, p1=-1):
        self.cells.seq_cp(src, dst, p0, p1)

    def seq_keep(self, seq_id):
        self.cells.seq_keep(seq_id)

    def seq_add(self, seq_id, p0, p1, delta):
        self.cells.seq_add(seq_id, p0, p1, delta)

    def seq_div(self, seq_id, p0, p1, d):
        self.cells.seq_div(seq_id, p0, p1, d)

    def seq_pos_max(self, seq_id):
        return self.cells.seq_pos_max(seq_id)

    def clear(self):
        self.cells.clear()
