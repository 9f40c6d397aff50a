"""The port's device sampler (llm_tpu_torch/samplers/device.py) against
llm_tpu's (samplers/device.py) and the host chain, on the CPU: process_rows'
masked distributions on tests/test_gloop_batch.py's grid (the same
candidate sets, probabilities within 1e-5), per-row parameters in one call,
device_eligible's answer on every case of that file, and sample_rows:
greedy rows are the full-row argmax, sampled rows draw from the masked set
with the masked probabilities (a frequency check) and repeat under their
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu.samplers import SamplingParams as JaxSamplingParams
from llm_tpu.samplers.device import device_eligible as jax_device_eligible
from llm_tpu.samplers.device import process_rows as jax_process_rows

from llm_tpu_torch.samplers import SamplingParams
from llm_tpu_torch.samplers.chain import Candidates, MinP, Temp, TopK, TopP
from llm_tpu_torch.samplers.device import (K_CAP, device_eligible, process_rows,
                                           row_generators, sample_rows)

GRID = [(0.8, 40, 0.95, 0.05), (1.0, 1, 1.0, 0.0), (0.5, 200, 0.5, 0.0), (1.3, 16, 1.0, 0.2),
        (0.7, 256, 0.9, 0.0)]


def _host_masked_probs(logits, temp, top_k, top_p, min_p):
    cur = Candidates.from_logits(logits)
    TopK(top_k).apply(cur)
    TopP(top_p, 1).apply(cur)
    MinP(min_p, 1).apply(cur)
    Temp(temp).apply(cur)
    p = cur.probs()
    return {int(i): float(v) for i, v in zip(cur.ids, p)}


def _masked(vals, idx):
    """{token: probability} over the candidates a row keeps."""
    alive = vals > -np.inf
    z = np.exp(vals[alive] - vals[alive].max())
    return dict(zip(idx[alive].tolist(), (z / z.sum()).tolist()))


def _params(cfgs):
    t = torch.tensor
    return (t([c[0] for c in cfgs], dtype=torch.float32), t([c[1] for c in cfgs]),
            t([c[2] for c in cfgs], dtype=torch.float32),
            t([c[3] for c in cfgs], dtype=torch.float32))


@pytest.mark.parametrize("cfg", GRID)
def test_process_rows_matches_reference_and_host_chain(cfg):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(4, 997)) * 3).astype(np.float32)
    vals, idx = process_rows(torch.from_numpy(logits), *_params([cfg] * 4))
    jv, ji = jax_process_rows(jnp.asarray(logits), *(jnp.asarray(p.numpy())
                                                     for p in _params([cfg] * 4)))
    for b in range(4):
        got = _masked(vals[b].numpy(), idx[b].numpy())
        for want in (_masked(np.asarray(jv[b]), np.asarray(ji[b])),
                     _host_masked_probs(logits[b], *cfg)):
            assert set(got) == set(want)
            assert max(abs(got[i] - want[i]) for i in got) < 1e-5


def test_process_rows_per_row_params_differ():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(4, 512)) * 2).astype(np.float32)
    cfgs = [(0.8, 40, 0.95, 0.05), (1.0, 1, 1.0, 0.0), (0.5, 100, 0.7, 0.0),
            (2.0, 8, 1.0, 0.3)]
    vals, idx = process_rows(torch.from_numpy(logits), *_params(cfgs))
    for b, cfg in enumerate(cfgs):
        assert set(_masked(vals[b].numpy(), idx[b].numpy())) == \
            set(_host_masked_probs(logits[b], *cfg))


CASES = [dict(), dict(temp=0.0, top_k=0), dict(grammar='root ::= "a"'),
         dict(logit_bias={3: 1.0}), dict(penalty_repeat=1.2), dict(mirostat=2),
         dict(dry_multiplier=0.5), dict(xtc_probability=0.3), dict(typical_p=0.9),
         dict(dynatemp_range=0.4), dict(top_n_sigma=2.0), dict(top_k=0), dict(top_k=5000),
         dict(min_keep=4), dict(top_k=K_CAP), dict(temp=0.0, penalty_freq=0.1),
         dict(penalty_present=0.5)]


@pytest.mark.parametrize("kw", CASES, ids=[str(sorted(c)) + str(i) for i, c in enumerate(CASES)])
def test_device_eligible_is_the_reference(kw):
    assert device_eligible(SamplingParams(**kw)) == jax_device_eligible(JaxSamplingParams(**kw))


def test_sample_rows_greedy_and_masked_draws():
    """Greedy rows (temp 0) are the full-row argmax; a sampled row's draws
    lie in its masked set with frequencies within 0.03 of its masked
    probabilities over 3000 draws; the same seeds give the same draws."""
    rng = np.random.default_rng(2)
    V = 64
    logits = torch.from_numpy((rng.normal(size=(3, V)) * 1.5).astype(np.float32))
    cfgs = [(0.0, 0, 1.0, 0.0), (0.9, 8, 0.9, 0.02), (1.2, 5, 1.0, 0.0)]
    params = _params(cfgs)
    gens = row_generators([7, 11, 13], "cpu")
    draws = torch.stack([sample_rows(logits, *params, gens) for _ in range(3000)])
    assert (draws[:, 0] == torch.argmax(logits[0])).all()
    for b in (1, 2):
        want = _host_masked_probs(logits[b].numpy(), *cfgs[b])
        got = np.bincount(draws[:, b].numpy(), minlength=V) / len(draws)
        assert set(np.flatnonzero(got)) <= set(want)
        assert max(abs(got[i] - p) for i, p in want.items()) < 0.03
    again = row_generators([7, 11, 13], "cpu")
    assert torch.equal(torch.stack([sample_rows(logits, *params, again) for _ in range(20)]),
                       draws[:20])
