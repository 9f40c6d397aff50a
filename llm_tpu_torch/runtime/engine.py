"""Context: the execution engine. Counterpart of
llm_tpu/runtime/engine.py::Context for the llama path: decode(batch) with
ubatch splitting, KV slot allocation and the logits and hidden-row output
maps; an eager generation loop (greedy, or temperature/top-k through a
torch.Generator); the batched loop of the server (generate_loop_batch: B
sequences, one batched one-token step a token, per-row sampling on the
card); encode (pooled hidden rows); the sequence ops on the cell table;
and the perf
counters (PerfCounters, ctx.perf) that tools/cli.py prints, counted as the
reference counts them: a ubatch of more than one token is prefill, a
one-token decode and every token of generate_loop is decode.

A model with interleaved sliding-window layers (gemma2) gets the ISWA dual
cache unless swa_full: those layers keep a ring of n_seq_hint * (window +
n_ubatch) cells (when that is fewer than n_cells) with its own cell table,
SWACellTable, whose out-of-window cells are pruned and reused; decode takes
a ring slot for every token beside its cell in the full table, and
generate_loop plans the ring slots of its tokens on the host up front, as
the reference's loop does (generate_loop_batch refuses a ring Context, as
the reference's does).

Steps run eagerly on `device` (default: the card). Token counts are padded
to TOKEN_BUCKETS so every step has one of a few static shapes (what a
later CUDA-graph capture of decode needs). Padding tokens write to cell
n_cells, which the KV scatter drops.

Return codes follow llama_decode: 0 ok, 1 no KV slot, -1 invalid.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.loader import load_params, scan_stack
from ..models.transformer import check_supported, forward, layer_views
from ..quant.qtensor import QTensor
from .batch import Batch, sanitize, split_simple
from ..samplers.device import row_generators, sample_rows
from .kv_cache import MAX_SEQS, CellTable, SWACellTable, new_kv_arrays, pack_seq_sets

TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


class NoFreeCells(RuntimeError):
    """The KV cache has no run of free cells for a decode loop (the
    reference's RuntimeError; callers evict and retry on this alone)."""


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
                 gdot: bool = False, scan_layers: bool = False, n_ubatch: int = 512,
                 swa_full: bool = False, n_seq_hint: int = 1, ep_cf: float = 0.0,
                 use_planes: bool = True):
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
        layers that do not stack run per layer, as in the reference, and so
        do a sliding-window model's. Params that come stacked
        (params["layers_stacked"]) run stacked whatever the option.
        n_ubatch: tokens a step (longer batches are split). swa_full: give
        the sliding-window layers full-size caches instead of the ISWA ring
        (the reference's --swa-full); n_seq_hint: the sequences expected at
        once, which size the ring at n_seq_hint * (window + n_ubatch)
        cells. ep_cf: a mixture-of-experts model's capacity factor, folded
        into the config where it has none (the reference's LLM_TPU_EP_CF /
        --ep-capacity-factor): steps of more than 8 tokens cap each
        expert's tokens and drop the rest (parallel/moe.py); 0 is exact.
        use_planes False: a GGUF's quantized matrices dequantized to dense
        `dtype` at load (the reference's use_planes, the CLI's --no-planes)."""
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        if params_cfg is not None:
            params, self.cfg = params_cfg
            self.params = params_to(params, self.device)
            if scan_layers and "layers_stacked" not in self.params:
                stacked = scan_stack(self.params["layers"], self.cfg)
                if stacked is not None:
                    self.params = {**self.params, "layers_stacked": stacked, "layers": []}
        else:
            self.params, self.cfg = load_params(reader, dense_dtype=dtype,
                                                device=self.device, scan_layers=scan_layers,
                                                use_planes=use_planes)
        if ep_cf > 0 and self.cfg.n_expert > 0 and self.cfg.ep_cf == 0.0:
            self.cfg = dataclasses.replace(self.cfg, ep_cf=float(ep_cf))
        self.kv_dtype = kv_dtype if kv_dtype is not None else dtype
        check_supported(self.params, self.cfg)
        self.scan = "layers_stacked" in self.params
        # the layers' dicts of StackedWeights on the stacked planes, made once
        self.stacked_layers = (layer_views(self.params["layers_stacked"])
                               if self.scan else None)
        self.dtype = dtype
        self.chain, self.gdot = chain, gdot
        self.n_cells = n_cells
        self.n_ubatch = n_ubatch
        self.cells = CellTable(n_cells)
        cfg = self.cfg
        # the ISWA ring (the reference's sizing rule), used only where it
        # saves cells
        self.cells_swa = None
        row_counts = None
        if not swa_full and cfg.swa_window > 0 and cfg.swa_pattern > 0:
            n_swa = min(n_cells, n_seq_hint * (cfg.swa_window + n_ubatch))
            if n_swa < n_cells:
                self.cells_swa = SWACellTable(n_swa, cfg.swa_window)
                row_counts = [n_swa if cfg.layer_is_swa(il) else n_cells
                              for il in range(cfg.n_layers)]
        self.kv = new_kv_arrays(cfg.n_layers, n_cells, cfg.n_kv_heads, cfg.head_dim,
                                cfg.head_dim_v, self.kv_dtype, self.device, row_counts)
        self._logits: dict[int, np.ndarray] = {}
        self._embd: dict[int, np.ndarray] = {}  # batch index -> final-norm hidden row
        self.rslots = None  # recurrent state slots: no recurrent model is ported
        # the (B_pad, n) shapes generate_loop_batch has run: the reference
        # compiles one program for each ("gloopb", B_pad, n)
        self.batch_loop_shapes: set[tuple[int, int]] = set()
        self.perf = PerfCounters()
        self.perf.t_load_ms = (time.perf_counter() - t0) * 1e3

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64)).to(self.device)

    def _step(self, tokens, pos, seq, widx, cpos, cbits, oidx, swa=(None, None, None)):
        """One forward: (logits, final-norm hidden rows) of the oidx rows.
        swa: the ring's (cell positions, bit-sets, write indices) on the
        device, or Nones without a ring."""
        spos, sbits, swidx = swa
        return forward(self.params, self.cfg, self.kv.k, self.kv.v,
                       tokens, pos, seq, widx, cpos, cbits, oidx,
                       dtype=self.dtype, chain=self.chain, gdot=self.gdot,
                       stacked_layers=self.stacked_layers, swa_cell_pos=spos,
                       swa_cell_seq_bits=sbits, swa_write_idx=swidx)

    def _swa_step_inputs(self, T: int, n: int, slots_swa) -> tuple:
        """The ring's device metadata for a step of T rows (n real):
        (cell positions, bit-sets, write indices; padding rows write to
        cell n_swa, which the scatter drops)."""
        widx = np.full(T, self.cells_swa.n_cells, np.int64)
        widx[:n] = slots_swa
        return (self._t(self.cells_swa.pos), self.cells_swa.device_bits(self.device),
                self._t(widx))

    def _plan_swa_slots(self, seq_id: int, pos0: int, n: int):
        """The ring slot of each of n generated tokens at positions
        pos0.., planned on the host up front (the reference's
        _plan_swa_slots): free cells first, then this sequence's oldest
        cell that no other sequence holds, once it is out of the window of
        the token that takes it (pos <= p - window; positions only grow, so
        a dead cell stays dead). [n] int32, a cell possibly more than once,
        or None when the ring cannot host the schedule."""
        import heapq

        ct = self.cells_swa
        this = ct.seq_mask(seq_id)
        bits = ct.seq_bits.copy()
        bits[:, seq_id >> 5] &= ~(np.uint32(1) << np.uint32(seq_id & 31))
        shared = bits.any(axis=1)  # a member of some other sequence too
        free_list = [int(c) for c in np.flatnonzero(~ct.used_mask())]
        heap = [(int(ct.pos[c]), int(c)) for c in np.flatnonzero(this & ~shared)]
        heapq.heapify(heap)
        slots = np.empty(n, np.int32)
        for i in range(n):
            p = pos0 + i
            if free_list:
                c = free_list.pop()
            elif heap and heap[0][0] <= p - ct.window:
                c = heapq.heappop(heap)[1]
            else:
                return None
            slots[i] = c
            heapq.heappush(heap, (p, c))
        return slots

    def decode(self, batch: Batch) -> int:
        if len(batch) == 0:
            return -1
        for seqs in batch.seq_ids:
            for s in seqs or (0,):
                if not (0 <= s < MAX_SEQS):
                    return -1
        batch = sanitize(batch, self.cells)
        self._logits.clear()
        self._embd.clear()
        for ub in split_simple(batch, self.n_ubatch):
            n = len(ub.tokens)
            slots = self.cells.find_slots(n)
            if slots is None:
                return 1
            slots_swa = None
            if self.cells_swa is not None:
                slots_swa = self.cells_swa.find_slots(n)
                if slots_swa is None:
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
            bits = pack_seq_sets(ub.seq_sets)
            self.cells.pos[slots] = ub.pos
            self.cells.seq_bits[slots] = bits
            swa = (None, None, None)
            if slots_swa is not None:
                self.cells_swa.pos[slots_swa] = ub.pos
                self.cells_swa.seq_bits[slots_swa] = bits
                swa = self._swa_step_inputs(T, n, slots_swa)
            try:
                logits, hidden = self._step(self._t(tokens), self._t(pos), self._t(seq),
                                            self._t(widx), self._t(self.cells.pos),
                                            self.cells.device_bits(self.device),
                                            self._t(oidx), swa)
            except Exception:
                self.cells.release(slots)
                if slots_swa is not None:
                    self.cells_swa.release(slots_swa)
                raise
            logits_np = logits[: len(out_rows)].float().cpu().numpy()
            hidden_np = hidden[: len(out_rows)].float().cpu().numpy()
            for i, bi in enumerate(ub.orig_index[out_rows]):
                self._logits[int(bi)] = logits_np[i]
                self._embd[int(bi)] = hidden_np[i]
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
        step makes its own cell visible to the sequence. With the ISWA ring
        the tokens' ring slots are planned up front (_plan_swa_slots) and
        each step relabels its slot, which may reuse a cell that slid out of
        the window; the host tables take only the emitted tokens' cells."""
        if not (0 <= seq_id < MAX_SEQS):
            raise ValueError(f"bad seq_id {seq_id}")
        n = int(n_tokens)
        if n <= 0:
            return []
        slots = self.cells.find_slots(n)
        if slots is None:
            raise NoFreeCells("generate_loop: no free KV cells")
        pos0 = self.cells.seq_pos_max(seq_id) + 1
        plan = None
        if self.cells_swa is not None:
            plan = self._plan_swa_slots(seq_id, pos0, n)
            if plan is None:
                raise NoFreeCells("generate_loop: no SWA ring space")
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
        swa = (None, None, None)
        if plan is not None:
            spos, sbits = self._t(self.cells_swa.pos), self.cells_swa.device_bits(self.device)
            plan_d = self._t(plan)
        out: list[int] = []
        for i in range(n):
            cbits[slots[i], word] |= bit
            if plan is not None:  # the planned ring slot takes this token
                spos[plan[i]] = pos0 + i
                sbits[plan[i], word] |= bit
                swa = (spos, sbits, plan_d[i:i + 1])
            logits = self._step(tok, self._t([pos0 + i]), seq, slots_d[i:i + 1],
                                cpos, cbits, oidx, swa)[0][0]
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
        if plan is not None and cnt > 0:
            # each ring slot's position is its last write's
            final = {int(c): pos0 + i for i, c in enumerate(plan[:cnt])}
            cells = np.fromiter(final.keys(), np.int32, len(final))
            self.cells_swa.occupy(cells, np.fromiter(final.values(), np.int32, len(final)),
                                  np.full(len(final), seq_id, np.int64))
            self.cells_swa.prune()
        self._logits.clear()
        self._embd.clear()
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1e3
        self.perf.n_decode += cnt
        return out

    def generate_loop_batch(self, first_tokens, n_tokens: int, *, seq_ids,
                            temps=None, top_ks=None, top_ps=None,
                            min_ps=None, seeds=None, n_limits=None,
                            eog_ids=()) -> list[list[int]]:
        """Decode up to n_tokens for B sequences at once: per token one
        batched one-token step over the B rows (K3 at T = B, each row
        masked to its own sequence's cells) and per-row sampling on the
        card (samplers/device.py; one torch.Generator a row, seeded from
        seeds[b]). The reference runs the same loop inside one jitted
        while_loop; here it is eager, with one host sync a step (whether
        every row is done).

        first_tokens/seq_ids: length-B lists. temps/top_ks/top_ps/min_ps/
        seeds/n_limits: optional per-row lists (defaults: greedy, no limit
        within n_tokens). A row stops at any eog_ids token (up to 8) or at
        its n_limits; finished rows coast (their tokens are not recorded and
        their remaining cells are not occupied). Returns B token lists of at
        most n_tokens each.

        B is padded to a power of two (the reference's compiled-program
        bucket): pad rows decode under the scratch sequence MAX_SEQS - 1
        into one shared run of spare cells that nothing occupies. A ring
        Context (the ISWA dual cache) is refused, as the reference refuses
        it: its callers take generate_loop."""
        if self.rslots is not None or self.cells_swa is not None:
            raise ValueError("generate_loop_batch: unsupported memory kind")
        B = len(seq_ids)
        n = int(n_tokens)
        if B == 0 or n <= 0:
            return [[] for _ in seq_ids]
        if len(first_tokens) != B:
            raise ValueError("first_tokens/seq_ids length mismatch")
        for s in seq_ids:
            if not (0 <= s < MAX_SEQS):
                raise ValueError(f"bad seq_id {s}")
        scratch = MAX_SEQS - 1
        B_pad = 1 << (B - 1).bit_length()
        n_extra = n if (B_pad > B and scratch not in seq_ids) else 0
        flat = self.cells.find_slots(B * n + n_extra)
        if flat is None and n_extra:
            B_pad, n_extra = B, 0  # KV pressure: exact B, no spares
            flat = self.cells.find_slots(B * n)
        if flat is None:
            raise NoFreeCells("generate_loop_batch: no free KV cells")
        if not n_extra:
            B_pad = B
        slots_mat = flat[: B * n].reshape(B, n)
        pos0 = np.asarray([self.cells.seq_pos_max(s) + 1 for s in seq_ids], np.int64)

        t0 = time.perf_counter()
        cpos = self.cells.pos.astype(np.int64)
        cpos[slots_mat] = pos0[:, None] + np.arange(n)
        temps = np.zeros(B, np.float32) if temps is None else np.asarray(temps, np.float32)
        top_ks = np.zeros(B, np.int64) if top_ks is None else np.asarray(top_ks, np.int64)
        top_ps = np.ones(B, np.float32) if top_ps is None else np.asarray(top_ps, np.float32)
        min_ps = np.zeros(B, np.float32) if min_ps is None else np.asarray(min_ps, np.float32)
        n_lim = (np.full(B, n, np.int64) if n_limits is None
                 else np.minimum(np.asarray(n_limits, np.int64), n))
        seeds = list(seeds) if seeds is not None else list(range(B))
        first = np.asarray(first_tokens, np.int64)
        seq_arr = np.asarray(seq_ids, np.int64)
        if B_pad > B:
            pad = B_pad - B
            slots_mat = np.concatenate([slots_mat, np.broadcast_to(flat[B * n:], (pad, n))])
            first = np.concatenate([first, np.zeros(pad, np.int64)])
            seq_arr = np.concatenate([seq_arr, np.full(pad, scratch, np.int64)])
            pos0 = np.concatenate([pos0, np.zeros(pad, np.int64)])
            n_lim = np.concatenate([n_lim, np.ones(pad, np.int64)])
            temps = np.concatenate([temps, np.zeros(pad, np.float32)])
            top_ks = np.concatenate([top_ks, np.zeros(pad, np.int64)])
            top_ps = np.concatenate([top_ps, np.ones(pad, np.float32)])
            min_ps = np.concatenate([min_ps, np.zeros(pad, np.float32)])
            seeds = seeds + [seeds[0]] * pad

        dev = self.device
        f32 = (lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev))
        temps_d, top_ps_d, min_ps_d = f32(temps), f32(top_ps), f32(min_ps)
        top_ks_d, n_lim_d = self._t(top_ks), self._t(n_lim)
        # all rows greedy (known here): a full-row argmax, no candidate set
        # and no draws
        greedy = not bool((temps > 0.0).any())
        gens = None if greedy else row_generators(seeds, dev)
        eogs = self._t(list(eog_ids)[:8] or [-1])
        cpos_d, cbits = self._t(cpos), self.cells.device_bits(dev)
        slots_d, pos0_d, seq_d = self._t(slots_mat), self._t(pos0), self._t(seq_arr)
        words, bits = seq_d >> 5, torch.ones_like(seq_d) << (seq_d & 31)
        oidx = self._t(np.arange(B_pad))
        tok = self._t(first)
        done = torch.zeros(B_pad, dtype=torch.bool, device=dev)
        toks = torch.full((B_pad, n), -1, dtype=torch.int64, device=dev)
        for i in range(n):
            cells_i = slots_d[:, i]
            # each row's pre-labeled cell becomes visible to its own sequence
            cbits[cells_i, words] = cbits[cells_i, words] | bits
            logits, _ = self._step(tok, pos0_d + i, seq_d, cells_i, cpos_d, cbits, oidx)
            nxt = (torch.argmax(logits, dim=-1) if greedy
                   else sample_rows(logits, temps_d, top_ks_d, top_ps_d, min_ps_d, gens))
            # finished rows keep feeding their last token; their cells stay
            # unoccupied on the host, so what they write is never read
            nxt = torch.where(done, tok, nxt)
            toks[:, i] = torch.where(done, -1, nxt)
            done = done | torch.isin(nxt, eogs) | (i + 1 >= n_lim_d)
            tok = nxt
            if bool(done.all()):  # the step's host sync
                break
        toks = toks.cpu().numpy()
        self.batch_loop_shapes.add((B_pad, n))  # recorded once its steps ran
        out: list[list[int]] = []
        total = 0
        for b in range(B):
            row = toks[b]
            stop = np.flatnonzero(row == -1)
            cnt = int(stop[0]) if len(stop) else n
            self.cells.occupy(slots_mat[b, :cnt], pos0[b] + np.arange(cnt, dtype=np.int32),
                              np.full(cnt, seq_ids[b], np.int64))
            out.append([int(t) for t in row[:cnt]])
            total += cnt
        self._logits.clear()
        self._embd.clear()
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1e3
        self.perf.n_decode += total
        return out

    def encode(self, tokens: list[int], pooling: str = "mean", seq_id: int = 0):
        """Sequence embedding with pooling (llama_encode + pooling_type
        semantics: none/mean/cls/last) over the final-norm hidden rows."""
        self.cells.seq_rm(seq_id)
        b = Batch()
        for i, t in enumerate(tokens):
            b.add(t, i, (seq_id,), logits=True)
        rc = self.decode(b)
        if rc != 0:
            raise RuntimeError(f"encode failed rc={rc}")
        rows = np.stack([self._embd[i] for i in range(len(tokens))])
        self.cells.seq_rm(seq_id)
        if pooling == "none":
            return rows
        if pooling == "cls":
            return rows[0]
        if pooling == "last":
            return rows[-1]
        return rows.mean(axis=0)

    # -- memory (seq) API ------------------------------------------------------

    def _tables(self) -> list:
        """The cell tables every sequence edit applies to: the full one and
        the ring's."""
        return [self.cells] + ([self.cells_swa] if self.cells_swa is not None else [])

    def seq_rm(self, seq_id, p0=-1, p1=-1):
        for t in self._tables():
            t.seq_rm(seq_id, p0, p1)
        return True

    def seq_cp(self, src, dst, p0=-1, p1=-1):
        for t in self._tables():
            t.seq_cp(src, dst, p0, p1)

    def seq_keep(self, seq_id):
        for t in self._tables():
            t.seq_keep(seq_id)

    def seq_add(self, seq_id, p0, p1, delta):
        for t in self._tables():
            t.seq_add(seq_id, p0, p1, delta)

    def seq_div(self, seq_id, p0, p1, d):
        for t in self._tables():
            t.seq_div(seq_id, p0, p1, d)

    def seq_pos_max(self, seq_id):
        return self.cells.seq_pos_max(seq_id)

    def clear(self):
        for t in self._tables():
            t.clear()
