"""Composable sampler chain.

The port's own copy of llm_tpu/samplers/chain.py (numpy).

Parity target: llama.cpp's vtable-based samplers
(llama.cpp's src/llama-sampling.cpp: chain :473, greedy :547, dist :608,
top-k :679, top-p :745, min-p :841, typical :940, temp/temp-ext :984-1094,
XTC :1185, top-n-sigma, mirostat v1/v2, penalties, DRY, logit-bias).
Samplers operate on a candidate array (ids + logits) on the host — sampling
is O(vocab) numpy work per token, exactly like the reference's CPU samplers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Candidates:
    """llama_token_data_array analogue."""

    ids: np.ndarray  # int32 [n]
    logits: np.ndarray  # float32 [n]
    selected: int = -1  # index into ids
    sorted: bool = False

    @classmethod
    def from_logits(cls, logits: np.ndarray) -> "Candidates":
        return cls(
            ids=np.arange(len(logits), dtype=np.int32),
            logits=np.asarray(logits, np.float32).copy(),
        )

    def probs(self) -> np.ndarray:
        m = self.logits.max()
        p = np.exp(self.logits - m)
        return p / p.sum()

    def keep(self, mask_or_idx) -> None:
        self.ids = self.ids[mask_or_idx]
        self.logits = self.logits[mask_or_idx]

    def sort_desc(self) -> None:
        if not self.sorted:
            order = np.argsort(-self.logits, kind="stable")
            self.keep(order)
            self.sorted = True


class Sampler:
    name = "base"

    def apply(self, cur: Candidates) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def accept(self, token: int) -> None:
        pass

    def reset(self) -> None:
        pass


class Greedy(Sampler):
    name = "greedy"

    def apply(self, cur: Candidates) -> None:
        cur.selected = int(np.argmax(cur.logits))


class Dist(Sampler):
    """Terminal sampler: draws from the softmax distribution."""

    name = "dist"

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = np.random.default_rng(seed if seed != 0xFFFFFFFF else None)

    def apply(self, cur: Candidates) -> None:
        p = cur.probs()
        cur.selected = int(self.rng.choice(len(p), p=p))

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.seed if self.seed != 0xFFFFFFFF else None)


class TopK(Sampler):
    name = "top-k"

    def __init__(self, k: int):
        self.k = k

    def apply(self, cur: Candidates) -> None:
        k = self.k
        if k <= 0 or k >= len(cur.ids):
            return
        cur.sort_desc()
        cur.keep(slice(0, k))


class TopP(Sampler):
    name = "top-p"

    def __init__(self, p: float, min_keep: int = 1):
        self.p = p
        self.min_keep = max(1, min_keep)

    def apply(self, cur: Candidates) -> None:
        if self.p >= 1.0:
            return
        cur.sort_desc()
        probs = cur.probs()
        cum = np.cumsum(probs)
        # keep tokens until cumulative prob exceeds p (inclusive)
        n = int(np.searchsorted(cum, self.p) + 1)
        n = max(n, self.min_keep)
        cur.keep(slice(0, n))


class MinP(Sampler):
    name = "min-p"

    def __init__(self, p: float, min_keep: int = 1):
        self.p = p
        self.min_keep = max(1, min_keep)

    def apply(self, cur: Candidates) -> None:
        if self.p <= 0.0 or len(cur.ids) == 0:
            return
        max_l = cur.logits.max()
        thresh = max_l + np.log(self.p)
        mask = cur.logits >= thresh
        if mask.sum() < self.min_keep:
            cur.sort_desc()
            cur.keep(slice(0, self.min_keep))
        else:
            cur.keep(mask)


class Typical(Sampler):
    name = "typical"

    def __init__(self, p: float, min_keep: int = 1):
        self.p = p
        self.min_keep = max(1, min_keep)

    def apply(self, cur: Candidates) -> None:
        if self.p >= 1.0:
            return
        probs = cur.probs()
        ent = -np.sum(probs * np.log(np.maximum(probs, 1e-30)))
        shifted = np.abs(-np.log(np.maximum(probs, 1e-30)) - ent)
        order = np.argsort(shifted, kind="stable")
        cum = np.cumsum(probs[order])
        n = max(int(np.searchsorted(cum, self.p) + 1), self.min_keep)
        cur.keep(order[:n])
        cur.sorted = False


class Temp(Sampler):
    name = "temp"

    def __init__(self, t: float):
        self.t = t

    def apply(self, cur: Candidates) -> None:
        if self.t <= 0.0:
            # temp <= 0 = argmax spike (reference keeps max only)
            cur.selected = -1
            best = int(np.argmax(cur.logits))
            cur.keep(slice(best, best + 1))
            return
        cur.logits /= self.t


class TempExt(Sampler):
    """Entropy-adaptive temperature (llama-sampling.cpp temp_ext)."""

    name = "temp-ext"

    def __init__(self, t: float, delta: float = 0.0, exponent: float = 1.0):
        self.t, self.delta, self.exponent = t, delta, exponent

    def apply(self, cur: Candidates) -> None:
        if self.delta <= 0.0 or len(cur.ids) <= 1:
            Temp(self.t).apply(cur)
            return
        if self.t <= 0.0:
            Temp(self.t).apply(cur)
            return
        min_t = max(0.0, self.t - self.delta)
        max_t = self.t + self.delta
        probs = cur.probs()
        ent = -np.sum(probs * np.log(np.maximum(probs, 1e-30)))
        max_ent = np.log(len(probs))
        norm = ent / max_ent if max_ent > 0 else 0.0
        dyn_t = min_t + (max_t - min_t) * (norm ** self.exponent)
        cur.logits /= max(dyn_t, 1e-6)


class XTC(Sampler):
    """Exclude-top-choices sampler (llama-sampling.cpp:1185)."""

    name = "xtc"

    def __init__(self, p: float, t: float, min_keep: int = 1, seed: int = 0):
        self.p, self.t, self.min_keep = p, t, max(1, min_keep)
        self.seed = seed
        self.rng = np.random.default_rng(seed if seed != 0xFFFFFFFF else None)

    def apply(self, cur: Candidates) -> None:
        if self.p <= 0.0 or self.t > 0.5 or len(cur.ids) < 2:
            return
        if self.rng.random() >= self.p:
            return
        probs = cur.probs()
        above = np.flatnonzero(probs >= self.t)
        if len(above) < 2:
            return
        order = np.argsort(-probs[above], kind="stable")
        drop = above[order[:-1]]  # drop all but the LEAST probable above t
        mask = np.ones(len(cur.ids), bool)
        mask[drop] = False
        if mask.sum() >= self.min_keep:
            cur.keep(mask)

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.seed if self.seed != 0xFFFFFFFF else None)


class TopNSigma(Sampler):
    name = "top-n-sigma"

    def __init__(self, n: float):
        self.n = n

    def apply(self, cur: Candidates) -> None:
        if self.n <= 0.0:
            return
        finite = cur.logits[np.isfinite(cur.logits)]
        if len(finite) == 0:
            return
        mx, std = finite.max(), finite.std()
        cur.keep(cur.logits >= mx - self.n * std)


class Penalties(Sampler):
    """repeat/frequency/presence penalties over the last n accepted tokens."""

    name = "penalties"

    def __init__(self, last_n: int = 64, repeat: float = 1.0,
                 freq: float = 0.0, present: float = 0.0):
        self.last_n, self.repeat, self.freq, self.present = last_n, repeat, freq, present
        self.prev: list[int] = []

    def accept(self, token: int) -> None:
        if self.last_n > 0:
            self.prev.append(token)
            if len(self.prev) > self.last_n:
                self.prev.pop(0)

    def reset(self) -> None:
        self.prev.clear()

    def apply(self, cur: Candidates) -> None:
        if not self.prev or (self.repeat == 1.0 and self.freq == 0.0 and self.present == 0.0):
            return
        counts: dict[int, int] = {}
        for t in self.prev:
            counts[t] = counts.get(t, 0) + 1
        identity = len(cur.ids) > 0 and cur.ids[0] == 0 and cur.ids[-1] == len(cur.ids) - 1 and not cur.sorted
        id_to_row = None if identity else {int(t): i for i, t in enumerate(cur.ids)}
        for t, c in counts.items():
            if id_to_row is None:
                row = t if 0 <= t < len(cur.ids) else None
            else:
                row = id_to_row.get(t)
            if row is None:
                continue
            l = cur.logits[row]
            if self.repeat != 1.0:
                l = l / self.repeat if l > 0 else l * self.repeat
            l -= c * self.freq + self.present
            cur.logits[row] = l


class LogitBias(Sampler):
    name = "logit-bias"

    def __init__(self, bias: dict[int, float]):
        self.bias = dict(bias)

    def apply(self, cur: Candidates) -> None:
        for t, b in self.bias.items():
            if 0 <= t < len(cur.ids) and cur.ids[t] == t:
                cur.logits[t] += b
            else:
                rows = np.flatnonzero(cur.ids == t)
                if len(rows):
                    cur.logits[rows[0]] += b


class MirostatV2(Sampler):
    name = "mirostat-v2"

    def __init__(self, tau: float = 5.0, eta: float = 0.1, seed: int = 0):
        self.tau, self.eta = tau, eta
        self.mu = 2.0 * tau
        self.seed = seed
        self.rng = np.random.default_rng(seed if seed != 0xFFFFFFFF else None)

    def apply(self, cur: Candidates) -> None:
        probs = cur.probs()
        surprise = -np.log2(np.maximum(probs, 1e-30))
        mask = surprise <= self.mu
        if not mask.any():
            mask = probs == probs.max()
        cur.keep(mask)
        p = cur.probs()
        sel = int(self.rng.choice(len(p), p=p))
        cur.selected = sel
        observed = -np.log2(max(p[sel], 1e-30))
        self.mu -= self.eta * (observed - self.tau)

    def reset(self) -> None:
        self.mu = 2.0 * self.tau
        self.rng = np.random.default_rng(self.seed if self.seed != 0xFFFFFFFF else None)


class MirostatV1(Sampler):
    name = "mirostat-v1"

    def __init__(self, n_vocab: int, tau: float = 5.0, eta: float = 0.1,
                 m: int = 100, seed: int = 0):
        self.n_vocab, self.tau, self.eta, self.m = n_vocab, tau, eta, m
        self.mu = 2.0 * tau
        self.rng = np.random.default_rng(seed if seed != 0xFFFFFFFF else None)
        self.seed = seed

    def apply(self, cur: Candidates) -> None:
        cur.sort_desc()
        probs = cur.probs()
        m = min(self.m, len(probs) - 1)
        if m >= 2:
            idx = np.arange(1, m)
            t_i = np.log(idx + 2.0) - np.log(idx + 1.0)
            b_i = np.log(probs[:m - 1] / np.maximum(probs[1:m], 1e-30))
            s_hat = np.sum(t_i * b_i) / np.sum(t_i * t_i)
        else:
            s_hat = 1.0
        eps = s_hat - 1
        k = ((eps * (2 ** self.mu)) / (1 - self.n_vocab ** (-eps))) ** (1 / s_hat)
        k = int(np.clip(k, 1, len(probs)))
        cur.keep(slice(0, k))
        p = cur.probs()
        sel = int(self.rng.choice(len(p), p=p))
        cur.selected = sel
        observed = -np.log2(max(p[sel], 1e-30))
        self.mu -= self.eta * (observed - self.tau)

    def reset(self) -> None:
        self.mu = 2.0 * self.tau
        self.rng = np.random.default_rng(self.seed if self.seed != 0xFFFFFFFF else None)


class Dry(Sampler):
    """DRY sequence-repetition penalty (llama.h:1341 semantics: penalize
    tokens that would extend a repeated suffix of the recent context)."""

    name = "dry"

    def __init__(self, multiplier: float = 0.0, base: float = 1.75,
                 allowed_length: int = 2, penalty_last_n: int = 512,
                 seq_breakers: tuple[int, ...] = ()):
        self.multiplier, self.base = multiplier, base
        self.allowed_length = allowed_length
        self.last_n = penalty_last_n
        self.breakers = set(seq_breakers)
        self.prev: list[int] = []

    def accept(self, token: int) -> None:
        self.prev.append(token)
        if self.last_n > 0 and len(self.prev) > self.last_n:
            self.prev.pop(0)

    def reset(self) -> None:
        self.prev.clear()

    def apply(self, cur: Candidates) -> None:
        if self.multiplier <= 0.0 or len(self.prev) < self.allowed_length:
            return
        ctx = self.prev
        n = len(ctx)
        # longest suffix of ctx that reappears earlier ending at position i,
        # candidate continuation token is ctx[i+1]
        penalties: dict[int, float] = {}
        max_scan = min(n - 1, self.last_n if self.last_n > 0 else n - 1)
        for i in range(n - 2, max(-1, n - 2 - max_scan), -1):
            tok_next = ctx[i + 1]
            if tok_next in self.breakers:
                continue
            # match length of ctx suffix vs ctx ending at i
            l = 0
            while (
                l <= i
                and l < n - 1
                and ctx[i - l] == ctx[n - 1 - l]
                and ctx[i - l] not in self.breakers
            ):
                l += 1
            if l >= self.allowed_length:
                pen = self.multiplier * (self.base ** (l - self.allowed_length))
                penalties[tok_next] = max(penalties.get(tok_next, 0.0), pen)
        if not penalties:
            return
        for t, pen in penalties.items():
            rows = np.flatnonzero(cur.ids == t)
            if len(rows):
                cur.logits[rows[0]] -= pen


class Chain(Sampler):
    """llama_sampler_chain analogue."""

    name = "chain"

    def __init__(self, samplers: list[Sampler]):
        self.samplers = list(samplers)

    def apply(self, cur: Candidates) -> None:
        for s in self.samplers:
            s.apply(cur)

    def accept(self, token: int) -> None:
        for s in self.samplers:
            s.accept(token)

    def reset(self) -> None:
        for s in self.samplers:
            s.reset()

    def sample(self, logits: np.ndarray) -> int:
        cur = Candidates.from_logits(logits)
        self.apply(cur)
        if cur.selected < 0:
            cur.selected = int(np.argmax(cur.logits))
        tok = int(cur.ids[cur.selected])
        return tok


class Infill(Sampler):
    """Infill sampler (llama_sampler_init_infill, llama.h:1357-1377; impl
    llama-sampling.cpp:2308): meant to run after top_k + top_p. Biases
    toward EOG when text probability is weak, merges candidates sharing a
    text prefix, applies the 0.2 / 1/(n+1) probability floors, and falls
    back to EOT when nothing survives."""

    name = "infill"
    THOLD = 0.2

    def __init__(self, tok):
        self.tok = tok  # tokenizer (piece + vocab eog/eot ids)

    def apply(self, cur: Candidates) -> None:
        p = cur.probs()
        vocab = self.tok.vocab
        eog = np.array([vocab.is_eog(int(t)) for t in cur.ids])
        p_eog = float(p[eog].sum())
        p_txt = float(p[~eog].sum())

        # 1. EOG dominance: keep only EOG candidates
        if 3.0 * p_eog * len(cur.ids) > p_txt:
            cur.keep(eog)
            cur.logits = np.log(np.maximum(p[eog] / max(p_eog, 1e-30), 1e-30))
            return

        # 2. merge tokens whose text is a prefix of another candidate's
        pieces = [self.tok.piece(int(t)) for t in cur.ids]
        order = np.argsort(-p, kind="stable")
        alive = np.ones(len(cur.ids), bool)
        pm = p.copy()
        for i0 in range(len(cur.ids)):
            for i1 in range(len(cur.ids)):
                if i0 == i1 or not alive[i0] or not alive[i1]:
                    continue
                t0, t1 = pieces[i0], pieces[i1]
                if t0 and len(t0) <= len(t1) and t1.startswith(t0):
                    dst, src = (i0, i1) if pm[i0] >= pm[i1] else (i1, i0)
                    pm[dst] += pm[src]
                    pm[src] = 0.0
                    alive[src] = False

        # 3. drop low-probability non-EOG tokens (thold 0.2)
        keep = alive & (eog | (pm >= self.THOLD))
        n_non_eog = int((keep & ~eog).sum())
        if n_non_eog == 0:
            # 4. nothing textual left -> single EOT
            eot = vocab.eot_id if vocab.eot_id >= 0 else vocab.eos_id
            cur.ids = np.asarray([eot], np.int32)
            cur.logits = np.asarray([1.0], np.float32)
            return
        pm = pm * keep
        pm = pm / pm.sum()
        thold2 = 1.0 / (n_non_eog + 1)
        keep2 = keep & (eog | (pm >= thold2))
        pm2 = pm * keep2
        pm2 = pm2 / pm2.sum()
        sel = np.flatnonzero(keep2)
        cur.keep(sel)
        cur.logits = np.log(np.maximum(pm2[sel], 1e-30)).astype(np.float32)
        _ = order  # merge order parity is by probability, handled via pm
