"""Session state files (llm_tpu_torch.runtime.state) against llm_tpu's
state module: the same npz format both ways, for dense and q8_0 caches.

- port save -> port load: the loaded cells' K/V planes are bit-equal to
  the saved ones (for a q8_0 cache the f32 dequant on save and the
  quantizer on load give back the same int8 and bf16 scale bits:
  127 * s / 127 == s), and continuation logits are equal to 1e-6;
- llm_tpu save -> port load and port save -> llm_tpu load, full and
  per-sequence: continuation logits agree at 2e-4;
- legacy uint64 seq bit-sets still load; wrong magic, a layer-count
  mismatch and a cache too small raise; a file with a sliding-window ring's
  keys loads into a Context without a ring, as into llm_tpu's.

Models are dense f32 synthetic llama models made by llm_tpu and carried
over with params_from_reference, so both packages compute the same model.
head_dim 64 gives a q8_0 cache 32-group scales (the unfused attention on
both sides), head_dim 128 one scale per row (the port's K3q/K4q path).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.models.synthetic import make_synthetic_model as jax_make_synthetic_model
from llm_tpu.runtime import state as jax_state
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext

from llm_tpu_torch.convert_params import params_from_reference
from llm_tpu_torch.ops import cuda_attn
from llm_tpu_torch.runtime import state
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context

TOL = dict(atol=2e-4, rtol=2e-4)
PROMPT = [5, 17, 60, 2, 33, 42, 7, 81, 64, 11]
NEXT = 19


def _model(head_dim, n_layers=2):
    geo = dict(n_embd=2 * head_dim, n_layers=n_layers, n_heads=2, n_kv_heads=1,
               n_ff=256, vocab=96)
    jp, jcfg = jax_make_synthetic_model(seed=7, dtype=jnp.float32, **geo)
    return (jp, jcfg), params_from_reference(_to_numpy(jp), jcfg)


def _to_numpy(obj):
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    return None if obj is None else np.asarray(obj)


@pytest.fixture(scope="module")
def models():
    return {hd: _model(hd) for hd in (64, 128)}


def _port(models, hd, kv, n_cells=32):
    params, cfg = models[hd][1]
    kv_dtype = "q8_0" if kv == "q8_0" else getattr(torch, kv)
    return Context(None, n_cells=n_cells, dtype=torch.float32, device="cpu",
                   params_cfg=(params, cfg), kv_dtype=kv_dtype)


def _jax(models, hd, kv):
    jp, jcfg = models[hd][0]
    kv_dtype = "q8_0" if kv == "q8_0" else getattr(jnp, kv)
    return JaxContext(None, n_cells=32, dtype=jnp.float32, params_cfg=(jp, jcfg),
                      kv_dtype=kv_dtype)


def _planes(cache, cells):
    """A layer's cache (a tensor or an (int8, scales) pair) at cells, as
    numpy arrays to compare bit for bit (bf16 viewed as int16)."""
    parts = cache if isinstance(cache, tuple) else (cache,)
    rows = [p[:, torch.as_tensor(cells, dtype=torch.long)] for p in parts]
    return [(r.view(torch.int16) if r.dtype == torch.bfloat16 else r).numpy() for r in rows]


def _continue(ctx, batch_cls, seq_id=0):
    pos = ctx.seq_pos_max(seq_id) + 1
    assert ctx.decode(batch_cls.one(NEXT, pos=pos, seq_id=seq_id)) == 0
    return np.asarray(ctx.get_logits())


@pytest.mark.parametrize("kv,hd", [("bfloat16", 128), ("q8_0", 128), ("q8_0", 64)])
def test_port_round_trip_is_exact(models, tmp_path, kv, hd):
    a = _port(models, hd, kv)
    assert a.decode(Batch.text(PROMPT)) == 0
    assert a.decode(Batch.text([9, 8, 7], seq_id=3)) == 0
    path = str(tmp_path / "full.npz")
    state.state_save(a, path, tokens=PROMPT)
    b = _port(models, hd, kv)
    assert b.decode(Batch.text([1, 2, 3, 4, 5, 6])) == 0  # replaced by the load
    assert state.state_load(b, path) == PROMPT
    used = np.flatnonzero(a.cells.used_mask())
    slots = np.flatnonzero(b.cells.used_mask())
    assert len(slots) == len(used) == len(PROMPT) + 3 == b.cells.n_used
    np.testing.assert_array_equal(b.cells.pos[slots], a.cells.pos[used])
    np.testing.assert_array_equal(b.cells.seq_bits[slots], a.cells.seq_bits[used])
    for il in range(a.cfg.n_layers):
        for x, y in ((a.kv.k[il], b.kv.k[il]), (a.kv.v[il], b.kv.v[il])):
            for p, q in zip(_planes(x, used), _planes(y, slots)):
                np.testing.assert_array_equal(q, p)
    np.testing.assert_allclose(_continue(b, Batch), _continue(a, Batch), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_continue(b, Batch, 3), _continue(a, Batch, 3),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("kv,hd", [("bfloat16", 128), ("q8_0", 128), ("q8_0", 64)])
def test_port_seq_round_trip(models, tmp_path, kv, hd):
    """One sequence saved, loaded under another id into a fresh context
    (bit-equal planes, logits to 1e-6) and into one that holds another
    sequence (which it leaves alone)."""
    a = _port(models, hd, kv)
    assert a.decode(Batch.text([9, 8, 7], seq_id=1)) == 0
    assert a.decode(Batch.text(PROMPT, seq_id=4)) == 0
    path = str(tmp_path / "seq.npz")
    state.state_seq_save(a, 4, path, tokens=[1, 2])
    cells = np.flatnonzero(a.cells.seq_mask(4))
    b = _port(models, hd, kv)
    assert state.state_seq_load(b, 0, path) == [1, 2]
    slots = np.flatnonzero(b.cells.seq_mask(0))
    assert b.cells.n_seq_cells(0) == len(PROMPT) == a.cells.n_seq_cells(4)
    assert b.cells.seq_pos_min(0) == 0 and b.cells.seq_pos_max(0) == len(PROMPT) - 1
    for il in range(a.cfg.n_layers):
        for x, y in ((a.kv.k[il], b.kv.k[il]), (a.kv.v[il], b.kv.v[il])):
            for p, q in zip(_planes(x, cells), _planes(y, slots)):
                np.testing.assert_array_equal(q, p)
    want = _continue(a, Batch, 4)
    np.testing.assert_allclose(_continue(b, Batch, 0), want, atol=1e-6, rtol=0)

    c = _port(models, hd, kv)
    assert c.decode(Batch.text([3, 3, 3, 3], seq_id=2)) == 0
    before = _planes(c.kv.k[0], np.flatnonzero(c.cells.seq_mask(2)))
    state.state_seq_load(c, 6, path)
    assert c.cells.n_seq_cells(2) == 4 and c.cells.n_seq_cells(6) == len(PROMPT)
    for p, q in zip(before, _planes(c.kv.k[0], np.flatnonzero(c.cells.seq_mask(2)))):
        np.testing.assert_array_equal(q, p)
    np.testing.assert_allclose(_continue(c, Batch, 6), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("per_seq", [False, True], ids=["full", "seq"])
@pytest.mark.parametrize("kv,hd", [("float32", 64), ("q8_0", 64), ("q8_0", 128)])
def test_state_files_cross_packages(models, tmp_path, monkeypatch, kv, hd, per_seq):
    """llm_tpu -> port and port -> llm_tpu. At head_dim 128 llm_tpu on the
    CPU attends over its f32 dequant (q * s, unrounded), so the port's
    dequant is set to that product here; the rounding is held in
    test_torch_attn.py."""
    if hd == 128:
        monkeypatch.setattr(cuda_attn, "dequant_bf16",
                            lambda c: c[0].float() * c[1].float()
                            if isinstance(c, tuple) else c.float())
    save, load = ((state.state_seq_save, state.state_seq_load) if per_seq
                  else (state.state_save, state.state_load))
    jsave, jload = ((jax_state.state_seq_save, jax_state.state_seq_load) if per_seq
                    else (jax_state.state_save, jax_state.state_load))
    args = (0,) if per_seq else ()
    j, p = _jax(models, hd, kv), _port(models, hd, kv)
    assert j.decode(JaxBatch.text(PROMPT)) == 0 and p.decode(Batch.text(PROMPT)) == 0
    fj, fp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsave(j, *args, fj, tokens=PROMPT)
    save(p, *args, fp, tokens=PROMPT)

    p2, j2 = _port(models, hd, kv), _jax(models, hd, kv)
    assert load(p2, *args, fj) == PROMPT
    assert jload(j2, *args, fp) == PROMPT
    if kv == "q8_0":  # the port's quantizer gives back llm_tpu's bytes
        for il in range(p.cfg.n_layers):
            kq, ks = p2.kv.k[il]
            jq, js = j.kv.k[il]
            np.testing.assert_array_equal(kq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ks.view(torch.int16).numpy(),
                                          np.asarray(js).view(np.int16))
    want_j, want_p = _continue(j, JaxBatch), _continue(p, Batch)
    np.testing.assert_allclose(_continue(p2, Batch), want_j, **TOL)
    np.testing.assert_allclose(_continue(j2, JaxBatch), want_p, **TOL)


def test_legacy_u64_seq_bits_load(models, tmp_path):
    a = _port(models, 64, "float32")
    assert a.decode(Batch.text(PROMPT[:4], seq_id=1)) == 0
    assert a.decode(Batch.text(PROMPT[:3], seq_id=40)) == 0
    path = str(tmp_path / "cur.npz")
    state.state_save(a, path)
    with np.load(path) as d:
        data = dict(d)
    w = data["seq_bits"].astype(np.uint64)
    data["seq_bits"] = w[:, 0] | (w[:, 1] << np.uint64(32))  # the old 64-seq form
    legacy = str(tmp_path / "legacy.npz")
    np.savez_compressed(legacy, **data)
    b = _port(models, 64, "float32")
    state.state_load(b, legacy)
    used = np.flatnonzero(a.cells.used_mask())
    np.testing.assert_array_equal(b.cells.seq_bits[:len(used)], a.cells.seq_bits[used])
    assert b.cells.n_seq_cells(1) == 4 and b.cells.n_seq_cells(40) == 3


def test_state_load_errors(models, tmp_path):
    a = _port(models, 64, "q8_0")
    assert a.decode(Batch.text(PROMPT)) == 0
    full, seq = str(tmp_path / "full.npz"), str(tmp_path / "seq.npz")
    state.state_save(a, full)
    state.state_seq_save(a, 0, seq)
    b = _port(models, 64, "q8_0")
    with pytest.raises(ValueError, match="not a llm_tpu state"):
        state.state_load(b, seq)
    with pytest.raises(ValueError, match="per-seq"):
        state.state_seq_load(b, 0, full)
    one_layer = _model(64, n_layers=1)[1]
    c = Context(None, n_cells=32, dtype=torch.float32, device="cpu", params_cfg=one_layer)
    with pytest.raises(ValueError, match="layer count"):
        state.state_load(c, full)
    small = _port(models, 64, "q8_0", n_cells=8)
    with pytest.raises(ValueError, match="too small"):
        state.state_load(small, full)
    with pytest.raises(ValueError, match="no KV space"):
        state.state_seq_load(small, 0, seq)
    with np.load(full) as d:
        data = dict(d)
    data["swa_pos"] = data["pos"]
    data["swa_seq_bits"] = data["seq_bits"]
    ring = str(tmp_path / "ring.npz")
    np.savez_compressed(ring, **data)
    # a Context without a ring ignores swa_* keys, as llm_tpu's does: the
    # file loads into both, and the next step agrees (a ring Context's
    # files: test_torch_iswa.py)
    assert state.state_load(b, ring) == jax_state.state_load(ref := _jax(models, 64, "q8_0"),
                                                             ring)
    np.testing.assert_allclose(_continue(b, Batch), _continue(ref, JaxBatch), **TOL)
