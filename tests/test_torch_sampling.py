"""The port's host sampler chain (llm_tpu_torch/samplers) against llm_tpu's
on the same seeded logits: for each sampler, the candidates it leaves (ids
and logits, bit for bit), the pick, and the state it accepts; for
build_chain at several SamplingParams and seeds, the token stream of 24
steps, each fed back through accept(). Both are numpy; the port's is a copy
of llm_tpu's, so everything is held exactly."""

import numpy as np
import pytest

from llm_tpu import samplers as jax_samplers
from llm_tpu.samplers import chain as jax_chain

from llm_tpu_torch import samplers
from llm_tpu_torch.samplers import chain

N_VOCAB = 512


def _logits(seed, n=N_VOCAB):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32) * 3
    x[rng.integers(0, n, 5)] += 6  # a few strong candidates
    return x


def _history(seed, n=40):
    return np.random.default_rng(seed + 100).integers(0, 24, n).tolist()


# (class name, constructor args): every sampler of chain.py but Infill,
# which takes a tokenizer (the CLI does not build it)
SAMPLERS = [
    ("Greedy", ()), ("Dist", (7,)), ("TopK", (20,)), ("TopK", (0,)), ("TopP", (0.9, 1)),
    ("TopP", (0.5, 3)), ("MinP", (0.05, 1)), ("MinP", (0.3, 2)), ("Typical", (0.8, 1)),
    ("Temp", (0.7,)), ("Temp", (0.0,)), ("TempExt", (0.8, 0.5, 1.5)), ("TempExt", (1.2,)),
    ("XTC", (0.9, 0.05, 1, 3)), ("TopNSigma", (1.5,)), ("Penalties", (16, 1.3, 0.2, 0.1)),
    ("LogitBias", ({3: 5.0, 9: -np.inf, 11: -2.5},)), ("MirostatV2", (5.0, 0.1, 11)),
    ("MirostatV1", (N_VOCAB, 4.0, 0.2, 13)), ("Dry", (0.8, 1.75, 2, 32, (2, 5)))]


def _pair(name, args):
    return getattr(jax_chain, name)(*args), getattr(chain, name)(*args)


def _state(s):
    """What a sampler accepted: its attributes other than the generator."""
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(s).items() if k != "rng" and not callable(v)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,args", SAMPLERS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(SAMPLERS)])
def test_each_sampler_matches(name, args, seed):
    ref, got = _pair(name, args)
    for t in _history(seed):
        ref.accept(t)
        got.accept(t)
    assert _state(got) == _state(ref)
    for step in range(3):
        lg = _logits(seed * 10 + step)
        a, b = jax_chain.Candidates.from_logits(lg), chain.Candidates.from_logits(lg)
        if name in ("TopP", "MinP", "Typical", "MirostatV1", "MirostatV2", "TopNSigma"):
            a.sort_desc()
            b.sort_desc()
        ref.apply(a)
        got.apply(b)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.logits, a.logits)
        assert (b.selected, b.sorted) == (a.selected, a.sorted)
        tok = int(a.ids[a.selected]) if a.selected >= 0 else int(a.ids[np.argmax(a.logits)])
        ref.accept(tok)
        got.accept(tok)
        assert _state(got) == _state(ref)
    ref.reset()
    got.reset()
    assert _state(got) == _state(ref)


PARAMS = [
    dict(temp=0.0),
    dict(temp=0.8, seed=1),
    dict(temp=1.1, top_k=8, top_p=0.8, min_p=0.02, seed=2),
    dict(temp=0.7, typical_p=0.9, penalty_repeat=1.2, penalty_freq=0.1,
         penalty_present=0.2, seed=3),
    dict(temp=0.9, xtc_probability=0.5, xtc_threshold=0.05, seed=4),
    dict(temp=0.9, top_n_sigma=1.0, seed=5),
    dict(temp=0.8, dynatemp_range=0.4, dynatemp_exponent=1.3, seed=6),
    dict(temp=0.8, mirostat=1, seed=7),
    dict(temp=0.8, mirostat=2, mirostat_tau=4.0, seed=8),
    dict(temp=0.8, dry_multiplier=0.8, dry_sequence_breakers=(3,), seed=9),
    dict(temp=0.8, logit_bias={5: 3.0, 6: -np.inf}, min_keep=3, seed=10),
    dict(temp=0.0, penalty_repeat=1.3, penalty_last_n=8),
]


@pytest.mark.parametrize("kw", PARAMS, ids=[str(i) for i in range(len(PARAMS))])
def test_build_chain_streams_match(kw):
    """The chain that build_chain makes from the same SamplingParams: the
    same samplers in the same order, and 24 steps of sample + accept give
    the same tokens."""
    ref = jax_samplers.build_chain(jax_samplers.SamplingParams(**kw), N_VOCAB)
    got = samplers.build_chain(samplers.SamplingParams(**kw), N_VOCAB)
    assert [type(s).__name__ for s in got.samplers] == [type(s).__name__ for s in ref.samplers]
    for t in _history(3, 8):
        ref.accept(t)
        got.accept(t)
    want, have = [], []
    for step in range(24):
        lg = _logits(1000 + step)
        want.append(ref.sample(lg))
        have.append(got.sample(lg))
        ref.accept(want[-1])
        got.accept(want[-1])
    assert have == want
    for r, g in zip(ref.samplers, got.samplers):
        assert _state(g) == _state(r)


def test_sampling_params_defaults_match():
    assert vars(samplers.SamplingParams()) == vars(jax_samplers.SamplingParams())
    assert set(samplers.__all__) == set(jax_samplers.__all__)
