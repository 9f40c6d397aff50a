"""Context.generate_loop_batch (the server's batched loop) and
Context.encode in the port against llm_tpu's, on the CPU in f32, through
tests/test_gloop_batch.py's behaviours: greedy rows equal llm_tpu's and
single-sequence decoding, EOG and per-row limits, sampled runs that repeat
under their seeds, mixed greedy and sampled rows, the power-of-two padding
under the scratch sequence, the same refusals, and the cell table after a
call equal to llm_tpu's. Sampled streams are compared as distributions
only (samplers/device.py): their draws come from other generators."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext

from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.runtime.kv_cache import MAX_SEQS

from test_model_vs_hf import _tiny_hf_llama

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7]]


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "tiny.gguf")
    convert_hf_llama(_tiny_hf_llama(), path)
    return path


def _ctx(path, n_cells=96):
    return Context(GGUFReader(path), n_cells=n_cells, dtype=torch.float32, device="cpu")


def _ref(path, n_cells=96):
    return JaxContext(JaxGGUFReader(path), n_cells=n_cells, dtype=jnp.float32)


def _prefill(ctx, prompt, seq_id, batch=Batch):
    assert ctx.decode(batch.text(list(prompt), seq_id=seq_id)) == 0
    return int(np.argmax(ctx.get_logits()))


def _cells(ctx):
    return ctx.cells.pos.copy(), ctx.cells.seq_bits.copy()


def test_greedy_rows_equal_reference_and_single_sequence(tiny_gguf):
    """Three greedy rows equal llm_tpu's rows and each prompt decoded alone
    (generate_loop); the cell table after the call equals llm_tpu's; a
    second chunk continues exactly."""
    n = 8
    ctx, ref = _ctx(tiny_gguf), _ref(tiny_gguf)
    firsts = [_prefill(ctx, p, i) for i, p in enumerate(PROMPTS)]
    jfirsts = [_prefill(ref, p, i, JaxBatch) for i, p in enumerate(PROMPTS)]
    assert firsts == jfirsts
    rows = ctx.generate_loop_batch(firsts, n - 1, seq_ids=[0, 1, 2])
    assert rows == ref.generate_loop_batch(jfirsts, n - 1, seq_ids=[0, 1, 2])
    pos, bits = _cells(ctx)
    assert np.array_equal(pos, np.asarray(ref.cells.pos)[:len(pos)])
    assert np.array_equal(bits, np.asarray(ref.cells.seq_bits)[:len(bits)])
    for i, (prompt, row) in enumerate(zip(PROMPTS, rows)):
        alone = _ctx(tiny_gguf)
        f = _prefill(alone, prompt, 0)
        assert [f] + alone.generate_loop(f, n - 1) == [firsts[i]] + row
        assert ctx.cells.seq_pos_max(i) == len(prompt) + n - 2
    more = ctx.generate_loop_batch([r[-1] for r in rows], 4, seq_ids=[0, 1, 2])
    assert more == ref.generate_loop_batch([r[-1] for r in rows], 4, seq_ids=[0, 1, 2])
    assert ctx.perf.n_decode == ref.perf.n_decode


def test_eog_and_limits(tiny_gguf):
    ctx, ref = _ctx(tiny_gguf), _ref(tiny_gguf)
    firsts = [_prefill(ctx, p, i) for i, p in enumerate(PROMPTS)]
    full = ctx.generate_loop_batch(firsts, 8, seq_ids=[0, 1, 2])
    ctx2 = _ctx(tiny_gguf)
    f2 = [_prefill(ctx2, p, i) for i, p in enumerate(PROMPTS)]
    jf2 = [_prefill(ref, p, i, JaxBatch) for i, p in enumerate(PROMPTS)]
    kw = dict(seq_ids=[0, 1, 2], n_limits=[8, 8, 2], eog_ids=(full[1][2],))
    rows = ctx2.generate_loop_batch(f2, 8, **kw)
    assert rows == ref.generate_loop_batch(jf2, 8, **kw)
    assert rows[1] == full[1][:3] and rows[2] == full[2][:2]
    if full[0][2] != full[1][2]:  # row 0 may share the EOG id
        assert rows[0] == full[0]
    # only emitted tokens occupy cells, as in llm_tpu's table
    assert ctx2.cells.seq_pos_max(1) == len(PROMPTS[1]) + 3 - 1
    assert ctx2.cells.seq_pos_max(2) == len(PROMPTS[2]) + 2 - 1
    pos, bits = _cells(ctx2)
    assert np.array_equal(pos, np.asarray(ref.cells.pos)[:len(pos)])
    assert np.array_equal(bits, np.asarray(ref.cells.seq_bits)[:len(bits)])


def test_sampled_reproducible_and_mixed_rows(tiny_gguf):
    """Sampled rows repeat under their seeds (six tokens each); a greedy
    row beside a sampled one equals single-sequence greedy decoding."""
    kw = dict(seq_ids=[0, 1], temps=[0.8, 1.2], top_ks=[20, 40], top_ps=[0.95, 0.8],
              min_ps=[0.05, 0.0], seeds=[7, 11])

    def run(**over):
        ctx = _ctx(tiny_gguf)
        firsts = [_prefill(ctx, p, i) for i, p in enumerate(PROMPTS[:2])]
        return ctx.generate_loop_batch(firsts, 6, **{**kw, **over})

    a, b = run(), run()
    assert a == b and all(len(r) == 6 for r in a)
    mixed = run(temps=[0.0, 0.9], top_ks=[0, 30], top_ps=[1.0, 0.9], seeds=[0, 3])
    alone = _ctx(tiny_gguf)
    f0 = _prefill(alone, PROMPTS[0], 0)
    assert mixed[0] == alone.generate_loop(f0, 6)


def test_pow2_padding_under_the_scratch_sequence(tiny_gguf):
    """B = 3 runs as B = 4 (llm_tpu compiles ("gloopb", 4, 4) and no B = 3
    program); the pad row's cells stay unoccupied."""
    ctx, ref = _ctx(tiny_gguf), _ref(tiny_gguf)
    firsts = [_prefill(ctx, p, i) for i, p in enumerate(PROMPTS)]
    jfirsts = [_prefill(ref, p, i, JaxBatch) for i, p in enumerate(PROMPTS)]
    assert ctx.generate_loop_batch(firsts, 4, seq_ids=[0, 1, 2]) == \
        ref.generate_loop_batch(jfirsts, 4, seq_ids=[0, 1, 2])
    keys = {k[1:] for k in ref._steps if k[0] == "gloopb"}
    assert ctx.batch_loop_shapes == keys == {(4, 4)}
    assert ctx.cells.n_seq_cells(MAX_SEQS - 1) == 0 == ref.cells.n_seq_cells(MAX_SEQS - 1)


@pytest.mark.parametrize("call,exc", [
    (dict(first_tokens=[1, 2], n_tokens=32, seq_ids=[0, 1]), RuntimeError),
    (dict(first_tokens=[1], n_tokens=4, seq_ids=[0, 1]), ValueError),
    (dict(first_tokens=[1], n_tokens=4, seq_ids=[MAX_SEQS]), ValueError)])
def test_refusals_are_the_reference(tiny_gguf, call, exc):
    """No free cells for 2 x 32 tokens in 32 cells; mismatched lengths; a
    sequence id out of range: the same exceptions on both sides, and
    nothing occupied."""
    ctx, ref = _ctx(tiny_gguf, 32), _ref(tiny_gguf, 32)
    for c in (ctx, ref):
        with pytest.raises(exc):
            c.generate_loop_batch(**call)
    assert ctx.cells.n_used == 0
    assert ctx.generate_loop_batch([1], 0, seq_ids=[0]) == \
        ref.generate_loop_batch([1], 0, seq_ids=[0]) == [[]]


def test_kv_pressure_is_no_free_cells_and_a_failed_step_records_no_shape(tiny_gguf):
    """KV pressure raises NoFreeCells (a RuntimeError, as llm_tpu's); a step
    that fails mid-loop raises its own error, records no loop shape and
    occupies no cell."""
    from llm_tpu_torch.runtime.engine import NoFreeCells

    ctx = _ctx(tiny_gguf, 32)
    with pytest.raises(NoFreeCells):
        ctx.generate_loop_batch([1, 2], 32, seq_ids=[0, 1])
    firsts = [_prefill(ctx, p, i) for i, p in enumerate(PROMPTS[:2])]
    used = ctx.cells.n_used
    step, calls = ctx._step, []

    def fails_second(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("flash_decode_launch: launch refused")
        return step(*a)

    ctx._step = fails_second
    with pytest.raises(RuntimeError, match="launch refused") as e:
        ctx.generate_loop_batch(firsts, 4, seq_ids=[0, 1])
    assert not isinstance(e.value, NoFreeCells)
    assert ctx.batch_loop_shapes == set() and ctx.cells.n_used == used
    ctx._step = step
    assert len(ctx.generate_loop_batch(firsts, 4, seq_ids=[0, 1])[0]) == 4
    assert ctx.batch_loop_shapes == {(2, 4)}


@pytest.mark.parametrize("pooling", ["mean", "cls", "last", "none"])
def test_encode_is_the_reference(tiny_gguf, pooling):
    """encode's pooled final-norm hidden rows (the /embeddings and /rerank
    rows) within 1e-4 of llm_tpu's, its sequence left empty."""
    ctx, ref = _ctx(tiny_gguf), _ref(tiny_gguf)
    got = ctx.encode(PROMPTS[2], pooling, seq_id=4)
    want = np.asarray(ref.encode(PROMPTS[2], pooling, seq_id=4))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert ctx.cells.n_seq_cells(4) == 0
