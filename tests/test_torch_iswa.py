"""The ISWA dual cache (runtime/kv_cache.py SWACellTable, the ring parts of
runtime/engine.py and runtime/state.py) against llm_tpu's, on the tiny
transformers Gemma2 of test_torch_gemma2.py (a window of 8, every other
layer sliding), on the CPU in f32.

With n_ubatch 8 the ring holds 1 * (8 + 8) = 16 cells beside 64 full ones
(the reference's sizing rule), so a 12-token prompt and 30 generated tokens
wrap it. The port's ring Context against its swa_full Context and against
llm_tpu's ring Context (tests/test_engine.py:196, 234, 490): logits at 2e-4
after the prompt, after generate_loop and after single decode steps past
the wrap; greedy tokens equal; the ring's host table equal to llm_tpu's
cell for cell. Sequence edits reach both tables. State files with swa_*
keys go both ways between the packages, and a ring Context refuses a file
without them. The server sizes the ring by its slots, as llm_tpu's does.
generate_loop_batch refuses a ring Context, and the server core then takes
its scalar loop, as llm_tpu's does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("transformers")

from llm_tpu.convert.hf_llama import convert_hf_llama
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.ops import qmatmul as jax_qmatmul
from llm_tpu.runtime import state as jax_state
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext

from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.ops import qmatmul
from llm_tpu_torch.runtime import state
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context
from llm_tpu_torch.samplers import SamplingParams
from llm_tpu_torch.server import app
from llm_tpu_torch.server.core import GenTask, InferenceServer
from llm_tpu_torch.tokenizers import tokenizer_from_gguf

from test_tools import _test_vocab
from test_torch_gemma2 import TOKENS, hf_gemma2

TOL = dict(atol=2e-4, rtol=2e-4)
N_CELLS, N_UBATCH, RING = 64, 8, 16


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("iswa") / "gemma2.gguf")
    convert_hf_llama(hf_gemma2(), p, arch="gemma2", vocab=_test_vocab(97))
    return p


@pytest.fixture(autouse=True)
def f32(monkeypatch):
    monkeypatch.setattr(jax_qmatmul, "_DEFAULT_DTYPE", jnp.float32)
    monkeypatch.setattr(qmatmul, "DEFAULT_DTYPE", torch.float32)


def _port(path, **kw):
    return Context(GGUFReader(path), n_cells=N_CELLS, n_ubatch=N_UBATCH, dtype=torch.float32,
                   device="cpu", **kw)


def _ref(path):
    return JaxContext(JaxGGUFReader(path), n_cells=N_CELLS, n_ubatch=N_UBATCH,
                      dtype=jnp.float32)


def _same_ring(ctx, ref):
    """The two ring tables hold the same cells, positions and sequences."""
    assert np.array_equal(ctx.cells_swa.pos, ref.cells_swa.pos)
    assert np.array_equal(ctx.cells_swa.seq_bits, np.asarray(ref.cells_swa.seq_bits))


def test_ring_is_sized_as_the_reference(path):
    ring, full, ref = _port(path), _port(path, swa_full=True), _ref(path)
    assert ring.cells_swa.n_cells == ref.cells_swa.n_cells == RING
    assert full.cells_swa is None
    cfg = ring.cfg
    assert [k.shape[1] for k in ring.kv.k] == \
        [RING if cfg.layer_is_swa(il) else N_CELLS for il in range(cfg.n_layers)]
    assert [k.shape[1] for k in ring.kv.v] == [k.shape[1] for k in ring.kv.k]
    assert all(k.shape[1] == N_CELLS for k in full.kv.k)
    # a hint of 8 sequences asks for 128 cells: no ring, as in the reference
    assert _port(path, n_seq_hint=8).cells_swa is None


def test_ring_matches_swa_full_and_reference_after_it_wraps(path):
    """Prompt, generate_loop of 30 tokens (42 positions in a 16-cell ring),
    then single decode steps: the three Contexts agree."""
    ring, full, ref = _port(path), _port(path, swa_full=True), _ref(path)
    for c in (ring, full):
        assert c.decode(Batch.text(TOKENS)) == 0
    assert ref.decode(JaxBatch.text(TOKENS)) == 0
    want = np.asarray(ref.get_logits())
    for c in (ring, full):
        np.testing.assert_allclose(c.get_logits(), want, **TOL)
    _same_ring(ring, ref)
    first = int(np.argmax(want))
    toks = ring.generate_loop(first, 30)
    assert toks == full.generate_loop(first, 30) == ref.generate_loop(first, 30)
    _same_ring(ring, ref)
    assert ring.cells_swa.n_used < RING  # pruned after the loop: only the window is live
    assert ring.cells.n_used == full.cells.n_used == len(TOKENS) + 30
    for t in toks[-5:]:  # one-token decode steps, each taking a pruned cell
        for c in (ring, full):
            assert c.decode(Batch.one(t)) == 0
        assert ref.decode(JaxBatch.one(t)) == 0
        want = np.asarray(ref.get_logits())
        np.testing.assert_allclose(ring.get_logits(), want, **TOL)
        np.testing.assert_allclose(full.get_logits(), want, **TOL)
    _same_ring(ring, ref)


def test_generate_loop_stops_at_eog_and_occupies_only_its_tokens(path):
    ring, ref = _port(path), _ref(path)
    assert ring.decode(Batch.text(TOKENS)) == 0 and ref.decode(JaxBatch.text(TOKENS)) == 0
    first = int(np.argmax(ring.get_logits()))
    stream = _port(path)
    assert stream.decode(Batch.text(TOKENS)) == 0
    eog = stream.generate_loop(first, 12)[6]
    got = ring.generate_loop(first, 12, eog_ids=(eog,))
    assert got == ref.generate_loop(first, 12, eog_ids=(eog,))
    assert got[-1] == eog and len(got) <= 7
    assert ring.cells.n_used == len(TOKENS) + len(got)
    _same_ring(ring, ref)


def test_sequence_edits_reach_both_tables(path):
    ring, ref = _port(path), _ref(path)
    for c, b in ((ring, Batch), (ref, JaxBatch)):
        assert c.decode(b.text(TOKENS)) == 0
        c.seq_cp(0, 3)
        c.seq_rm(0, 8, -1)
        c.seq_add(3, 0, -1, 2)
    _same_ring(ring, ref)
    assert np.array_equal(ring.cells.pos, ref.cells.pos)
    for c in (ring, ref):
        c.seq_keep(3)
    _same_ring(ring, ref)
    ring.clear()
    assert ring.cells.n_used == ring.cells_swa.n_used == 0


def test_state_files_cross_with_the_ring(path, tmp_path):
    """Full and per-sequence files of a wrapped ring: port -> port, port ->
    llm_tpu and llm_tpu -> port; the next step's logits of the loaded
    Context equal the uninterrupted one's. A ring Context refuses a file
    without swa_* keys (the swa_full Context's)."""
    ring, ref = _port(path), _ref(path)
    assert ring.decode(Batch.text(TOKENS)) == 0 and ref.decode(JaxBatch.text(TOKENS)) == 0
    first = int(np.argmax(ring.get_logits()))
    toks = ring.generate_loop(first, 20)
    assert ref.generate_loop(first, 20) == toks
    nxt = toks[-1]
    files = {}
    for kind, save_port, save_ref in (
            ("full", lambda p: state.state_save(ring, p, TOKENS),
             lambda p: jax_state.state_save(ref, p, TOKENS)),
            ("seq", lambda p: state.state_seq_save(ring, 0, p, TOKENS),
             lambda p: jax_state.state_seq_save(ref, 0, p, TOKENS))):
        files[kind] = (str(tmp_path / f"port_{kind}.npz"), str(tmp_path / f"ref_{kind}.npz"))
        save_port(files[kind][0])
        save_ref(files[kind][1])
        with np.load(files[kind][0]) as d:
            assert "swa_pos" in d.files and ("swa_seq_bits" in d.files) == (kind == "full")
    assert ring.decode(Batch.one(nxt)) == 0
    want = ring.get_logits()
    for kind, (port_file, ref_file) in files.items():
        load = state.state_load if kind == "full" else (
            lambda c, p: state.state_seq_load(c, 0, p))
        jload = jax_state.state_load if kind == "full" else (
            lambda c, p: jax_state.state_seq_load(c, 0, p))
        for src in (port_file, ref_file):  # into the port
            c = _port(path)
            assert load(c, src) == TOKENS
            assert c.decode(Batch.one(nxt)) == 0
            np.testing.assert_allclose(c.get_logits(), want, **TOL)
        j = _ref(path)  # the port's file into llm_tpu
        assert jload(j, port_file) == TOKENS
        assert j.decode(JaxBatch.one(nxt)) == 0
        np.testing.assert_allclose(np.asarray(j.get_logits()), want, **TOL)
    full = _port(path, swa_full=True)
    assert full.decode(Batch.text(TOKENS)) == 0
    plain = str(tmp_path / "no_ring.npz")
    state.state_save(full, plain)
    with pytest.raises(ValueError, match="lacks SWA ring data"):
        state.state_load(_port(path), plain)


@pytest.mark.parametrize("n_parallel", [1, 8])
def test_server_sizes_the_ring_by_its_slots_as_the_reference(path, n_parallel):
    """server/app.py's Context gets -b as n_ubatch and -np as n_seq_hint, as
    llm_tpu's server passes them: -c 64 -b 8 keeps a 16-cell ring for one
    slot and none for eight (8 * 16 >= 64), as llm_tpu's Context does."""
    args = app._parser().parse_args(["-m", path, "-c", str(N_CELLS), "-b", str(N_UBATCH),
                                     "-np", str(n_parallel), "--f32"])
    ctx, draft = app.server_contexts(args, GGUFReader(path), "cpu")
    ref = JaxContext(JaxGGUFReader(path), n_cells=N_CELLS, n_ubatch=N_UBATCH,
                     dtype=jnp.float32, n_seq_hint=n_parallel)
    assert draft is None and ctx.n_ubatch == N_UBATCH
    assert (ctx.cells_swa is None) == (ref.cells_swa is None) == (n_parallel == 8)
    if n_parallel == 1:
        assert ctx.cells_swa.n_cells == ref.cells_swa.n_cells == RING


def test_batched_loop_refuses_the_ring_and_the_server_takes_the_scalar_loop(path):
    """generate_loop_batch raises on a ring Context, as llm_tpu's does; the
    server core's gate (_batch_ctx_ok) keeps it from the batched loop
    (prewarm too), so greedy tasks decode through the scalar loop and give
    Context.decode + decode steps' tokens."""
    ring = _port(path)
    with pytest.raises(ValueError, match="unsupported memory kind"):
        ring.generate_loop_batch([1], 4, seq_ids=[0])
    reader = GGUFReader(path)
    tok = tokenizer_from_gguf(reader)
    eng = InferenceServer(_port(path), tok, n_slots=2, n_batch=8)

    def never(*a, **kw):
        raise AssertionError("generate_loop_batch on a ring Context")

    eng.ctx.generate_loop_batch = never
    assert not eng._batch_ctx_ok()
    eng.prewarm()
    prompt = tok.encode("hello world", add_special=True)
    eng.start()
    try:
        task = eng.submit(GenTask(prompt_tokens=prompt, params=SamplingParams(temp=0.0),
                                  n_predict=12))
        got = []
        while True:
            ev = task.events.get(timeout=180)
            if ev.get("done"):
                break
            got.append(ev["token"])
    finally:
        eng.stop()
    assert eng.metrics.get("fast_chunks_total", 0) == 0 and 0 < len(got) <= 12
    solo = _port(path)
    assert solo.decode(Batch.text(prompt)) == 0
    want = [int(np.argmax(solo.get_logits()))]
    while len(want) < len(got):
        assert solo.decode(Batch.one(want[-1])) == 0
        want.append(int(np.argmax(solo.get_logits())))
    assert got == want
