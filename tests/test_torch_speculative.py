"""The port's runtime/speculative.py (NgramCache, gen_draft_tokens,
verify_draft on its Batch and Context) against llm_tpu's on
tests/test_speculative.py's cases: equal drafts, equal verified tokens,
and the cache left as llm_tpu leaves it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.runtime.speculative import NgramCache as JaxNgramCache
from llm_tpu.runtime.speculative import gen_draft_tokens as jax_gen_draft
from llm_tpu.runtime.speculative import verify_draft as jax_verify
from llm_tpu.samplers import SamplingParams as JaxSamplingParams
from llm_tpu.samplers import build_chain as jax_build_chain

from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.runtime.speculative import NgramCache, gen_draft_tokens, verify_draft
from llm_tpu_torch.samplers import SamplingParams, build_chain

from test_model_vs_hf import _tiny_hf_llama


@pytest.mark.parametrize("seq,ctx,n", [
    ([1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3, 4], [3, 4], 4), ([1, 2, 3], [9, 9], 4),
    ([5, 6, 5, 6, 5, 7, 5, 6], [5], 3), ([1, 1, 1, 1, 1], [1], 6),
    (list(np.random.default_rng(0).integers(0, 6, 200)), [2, 3], 8)])
def test_ngram_drafts_are_the_reference(seq, ctx, n):
    ours, ref = NgramCache(), JaxNgramCache()
    ours.update([int(t) for t in seq])
    ref.update([int(t) for t in seq])
    assert ours.draft(ctx, n) == ref.draft(ctx, n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spec") / "m.gguf")
    convert_hf_llama(_tiny_hf_llama(), path)
    return path


def _pair(path):
    return (Context(GGUFReader(path), n_cells=64, dtype=torch.float32, device="cpu"),
            JaxContext(JaxGGUFReader(path), n_cells=64, dtype=jnp.float32))


def test_draft_and_verify_are_the_reference(tiny):
    """A self-draft proposal, then the target's verification of it and of a
    nonsense draft: equal drafts, equal accepted tokens and next token, and
    the same cells left for the sequence."""
    prompt = [5, 3, 8, 2]
    (drf, jdrf), (tgt, jtgt) = _pair(tiny), _pair(tiny)
    draft = gen_draft_tokens(drf, None, prompt, 0, n_draft=4)
    assert draft == jax_gen_draft(jdrf, None, prompt, 0, n_draft=4) and len(draft) == 4
    chain = build_chain(SamplingParams(temp=0.0), tgt.cfg.vocab_size)
    jchain = jax_build_chain(JaxSamplingParams(temp=0.0), jtgt.cfg.vocab_size)
    assert tgt.decode(Batch.text(prompt[:-1])) == 0
    assert jtgt.decode(JaxBatch.text(prompt[:-1])) == 0
    for d in (draft, [96, 95, 94]):
        got = verify_draft(tgt, chain, prompt[-1], d, len(prompt) - 1)
        want = jax_verify(jtgt, jchain, prompt[-1], d, len(prompt) - 1)
        assert got == want
        assert tgt.cells.seq_pos_max(0) == jtgt.cells.seq_pos_max(0)
        tgt.seq_rm(0, len(prompt) - 1, -1)
        jtgt.seq_rm(0, len(prompt) - 1, -1)
    assert verify_draft(tgt, chain, prompt[-1], draft, len(prompt) - 1)[2] == len(draft)
