"""S3's plain versions (llm_tpu_torch.ops.cuda_attn_probe.probe_plain) held
against llm_tpu's Pallas flash_decode in interpret mode on each variant's
equivalent input, at T=1 over a stack of NB=3 caches of S=256 cells, H=8,
Hkv=2, D=128 (seeded numpy inputs; the last quarter of the cells masked):

  v1       buffer lidx of a head-major stack  ->  flash_decode on that buffer
  v0       buffer lidx of a seq-major stack   ->  flash_decode on its transpose
  noscale  (int8, scale) pairs                ->  flash_decode on the int8 values as f32
  full     the same pairs                     ->  flash_decode on the f32 products q*s
  bf16     the same pairs                     ->  as test_torch_attn.py holds K3q:
           llm_tpu's _kernel_q8 on the pairs (whose bf16 rounding XLA folds
           away on the CPU) with the port's dequant set to that f32 product,
           and llm_tpu's dense kernel on bf16-rounded K/V against the port's
           own rounding

at test_pallas_attn.py's tolerances as shares of max|y|: 5e-3 for the
bf16 and dense caches, 2e-2 for the q8 cache. The TPU scripts
(scripts/kbench7.py, kbench9.py) are not imported: they set process-wide
JAX options at import, and their pallas_calls have no interpret mode.
Then plain versions that ignore the buffer index or the layout must fail
those bounds, "full" must differ from "bf16" by the rounding, and the
dispatcher takes the plain version for CPU tensors only. The kernels are
held against these plain versions in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.ops import pallas_attn as jax_attn
from llm_tpu.ops.rope import RopeParams as JaxRopeParams
from llm_tpu.ops.rope import rope_angles as jax_rope_angles

from llm_tpu_torch.ops import cuda_attn, cuda_attn_probe
from llm_tpu_torch.ops.cuda_attn_probe import probe, probe_cuda, probe_plain
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORM
from llm_tpu_torch.tools import kbench_attn

NB, S, H, HKV, D = 3, 256, 8, 2, 128
SCALE = D ** -0.5
DENSE_TOL = 5e-3  # test_pallas_attn.py:53, of max|y|
Q8_TOL = 2e-2  # test_pallas_attn.py:116, of max|y|


def _queries(mode, seed=0):
    """q, q_rot, rope tables of positions 0..S-1, a bias masking the last
    quarter of the cells: jax arrays and torch tensors of the same values."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, H, D)).astype(np.float32)
    cos_h, sin_h = jax_rope_angles(jnp.arange(S, dtype=jnp.int32),
                                   JaxRopeParams(n_dims=D, mode=mode, freq_base=500000.0))
    cos, sin = jax_attn.expand_tables(cos_h, sin_h, mode, D)
    bias = np.zeros((1, S), np.float32)
    bias[:, S - S // 4:] = -np.inf
    j = dict(q=jnp.asarray(q), q_rot=jax_attn.rope_companion(jnp.asarray(q), mode), cos=cos,
             sin=sin, bias=jnp.asarray(bias))
    return j, {n: torch.from_numpy(np.array(a)) for n, a in j.items()}


def _stacks(seed=1):
    """Head-major [NB, Hkv, S, D] K and V stacks (f32 numpy)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(NB, HKV, S, D)).astype(np.float32),
            rng.normal(size=(NB, HKV, S, D)).astype(np.float32))


def _seq_major(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def _lidx(i):
    return torch.tensor([i], dtype=torch.int32)


def _oracle(j, k, v):
    return np.asarray(jax_attn.flash_decode(**j, k=k, v=v, scale=SCALE, sblk=128,
                                            interpret=True))


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("lidx", [0, NB - 1])
@pytest.mark.parametrize("variant", ["v1", "v0"])
def test_stacked_plain_matches_pallas(variant, lidx, mode):
    """v1 / v0 on buffer lidx equal flash_decode on that head-major buffer."""
    j, t = _queries(mode)
    k, v = _stacks()
    want = _oracle(j, jnp.asarray(k[lidx]), jnp.asarray(v[lidx]))
    lay = (lambda x: x) if variant == "v1" else _seq_major
    got = probe_plain(variant, **t, k=torch.from_numpy(lay(k)), v=torch.from_numpy(lay(v)),
                      scale=SCALE, lidx=_lidx(lidx))
    assert _rel_err(got, want) <= DENSE_TOL


@pytest.mark.parametrize("fault", ["index", "layout"])
def test_stacked_oracle_catches_a_wrong_buffer_or_layout(fault):
    """A plain version that reads buffer 0 whatever the index, or a
    seq-major stack as if head-major, misses the oracle by far more than the
    tolerance: the comparisons above can see both faults."""
    j, t = _queries(ROPE_TYPE_NORM)
    k, v = _stacks()
    want = _oracle(j, jnp.asarray(k[NB - 1]), jnp.asarray(v[NB - 1]))
    if fault == "index":
        got = probe_plain("v1", **t, k=torch.from_numpy(k), v=torch.from_numpy(v),
                          scale=SCALE, lidx=_lidx(0))
    else:  # the seq-major bytes read head-major
        ks, vs = (torch.from_numpy(_seq_major(x)).reshape(NB, HKV, S, D) for x in (k, v))
        got = probe_plain("v1", **t, k=ks, v=vs, scale=SCALE, lidx=_lidx(NB - 1))
    assert _rel_err(got, want) > 20 * DENSE_TOL


def _q8_pairs(seed=2):
    """(int8 [Hkv, S, D], bf16 scales [Hkv, S, 1]) for K and V, one scale per
    head row (test_pallas_attn.py's q8 planes): numpy and torch."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("k", "v"):
        x = rng.normal(size=(HKV, S, D)).astype(np.float32)
        sc = np.abs(x).max(axis=-1, keepdims=True) / 127.0
        q8 = np.clip(np.round(x / sc), -127, 127).astype(np.int8)
        sc = np.asarray(jnp.asarray(sc, jnp.bfloat16))
        out[name] = ((q8, sc), (torch.from_numpy(q8),
                                torch.from_numpy(sc.astype(np.float32)).to(torch.bfloat16)))
    return out


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("variant", ["noscale", "full"])
def test_q8_dense_modes_match_pallas(variant, mode):
    """noscale = flash_decode on the int8 values as f32; full = flash_decode
    on the exact f32 products q * s."""
    j, t = _queries(mode)
    pairs = _q8_pairs()
    dense = {n: jnp.asarray(q8.astype(np.float32) if variant == "noscale"
                            else q8.astype(np.float32) * sc.astype(np.float32))
             for n, ((q8, sc), _) in pairs.items()}
    want = _oracle(j, dense["k"], dense["v"])
    got = probe_plain(variant, **t, k=pairs["k"][1], v=pairs["v"][1], scale=SCALE)
    assert _rel_err(got, want) <= DENSE_TOL


def _f32_product(kv):
    return kv[0].float() * kv[1].float() if isinstance(kv, tuple) else kv.float()


@pytest.mark.parametrize("oracle", ["kernel_q8", "bf16"])
@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
def test_q8_bf16_mode_matches_pallas(oracle, mode, monkeypatch):
    """bf16 (K3q's dequant) held two ways, as test_torch_attn.py holds K3q:
    "kernel_q8" runs llm_tpu's _kernel_q8 on the pairs, which computes the
    f32 product on the CPU, against the port with its dequant set to that
    product; "bf16" runs llm_tpu's dense kernel on the pairs dequantized and
    rounded to bf16 against the port's own rounding."""
    j, t = _queries(mode)
    pairs = _q8_pairs()
    if oracle == "kernel_q8":
        monkeypatch.setattr(cuda_attn, "dequant_bf16", _f32_product)
        kv = {n: tuple(jnp.asarray(a) for a in p[0]) for n, p in pairs.items()}
    else:
        kv = {n: jnp.asarray(np.asarray(jnp.asarray(p[0][0]).astype(jnp.bfloat16)
                                        * jnp.asarray(p[0][1])))
              for n, p in pairs.items()}
    want = _oracle(j, kv["k"], kv["v"])
    got = probe_plain("bf16", **t, k=pairs["k"][1], v=pairs["v"][1], scale=SCALE)
    assert _rel_err(got, want) <= Q8_TOL


def test_full_and_bf16_modes_differ_by_the_rounding():
    """The f32 product and its bf16 rounding are different K/V (a relative
    step of at most half a bf16 ulp, 2^-8, an element), and the outputs show
    it."""
    _, t = _queries(ROPE_TYPE_NORM)
    pairs = _q8_pairs()
    kv = dict(k=pairs["k"][1], v=pairs["v"][1])
    full, bf16 = (cuda_attn_probe.dense_kv(m, kv["k"]) for m in ("full", "bf16"))
    step = ((full - bf16).abs() / full.abs().clamp(min=1e-30)).max().item()
    assert 0 < step <= 2 ** -8
    y_full = probe_plain("full", **t, **kv, scale=SCALE)
    y_bf16 = probe_plain("bf16", **t, **kv, scale=SCALE)
    diff = (y_full - y_bf16).abs().max().item() / y_full.abs().max().item()
    assert 1e-6 < diff < 2 ** -7


@pytest.mark.parametrize("variant", cuda_attn_probe.VARIANTS)
def test_dispatcher_takes_the_plain_version_for_cpu_tensors(variant):
    _, t = _queries(ROPE_TYPE_NORM)
    if variant in cuda_attn_probe.STACKED:
        lay = (lambda x: x) if variant == "v1" else _seq_major
        k, v = (torch.from_numpy(lay(x)) for x in _stacks())
        kw = dict(k=k, v=v, lidx=_lidx(1))
    else:
        pairs = _q8_pairs()
        kw = dict(k=pairs["k"][1], v=pairs["v"][1])
    got = probe(variant, **t, **kw, scale=SCALE, split=64)
    assert torch.equal(got, probe_plain(variant, **t, **kw, scale=SCALE))


@pytest.mark.parametrize("variant", ["v1", "full"])
def test_cuda_probe_refuses_cpu_tensors(variant):
    """A probe asked of the kernel on tensors that are not on the card
    raises: there is no fallback to the plain version."""
    _, t = _queries(ROPE_TYPE_NORM)
    if variant == "v1":
        k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _stacks())
        kw = dict(k=k, v=v, lidx=_lidx(0))
    else:
        pairs = _q8_pairs()
        kw = dict(k=pairs["k"][1], v=pairs["v"][1])
    t = {n: (x if n == "bias" else x.to(torch.bfloat16)) for n, x in t.items()}
    with pytest.raises(ValueError):
        probe_cuda(variant, **t, **kw, scale=SCALE)


def test_unknown_variant_and_missing_index_raise():
    _, t = _queries(ROPE_TYPE_NORM)
    k, v = (torch.from_numpy(x) for x in _stacks())
    with pytest.raises(ValueError):
        probe("v2", **t, k=k, v=v, scale=SCALE, lidx=_lidx(0))
    with pytest.raises(ValueError):
        probe_plain("v1", **t, k=k, v=v, scale=SCALE)


def test_tolerance_is_relative_for_bf16_caches_and_k3q_for_q8():
    y = torch.tensor([0.5, -2.0])
    assert cuda_attn_probe.tolerance("v0", y) == pytest.approx(2e-3)
    assert cuda_attn_probe.tolerance("bf16", y) == pytest.approx(2e-3)
    assert cuda_attn_probe.tolerance("full", y / 4) == pytest.approx(1e-3)


def test_kbench_attn_needs_a_card():
    """The entry point exits nonzero without a CUDA device."""
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as e:
        kbench_attn.main([])
    assert e.value.code not in (0, None)


def test_kbench_attn_record_counts_bytes_and_bound():
    """The JSON record's byte counts and bound are computed from shapes
    alone: K+V of one buffer, the scales, cos/sin; the bound over those, q,
    q_rot, the bias and the f32 output at 3.35 TB/s."""
    T, Hq, Sq = kbench_attn.T, kbench_attn.H, kbench_attn.S_Q8
    inp = dict(q=torch.zeros((T, Hq, D), dtype=torch.bfloat16),
               q_rot=torch.zeros((T, Hq, D), dtype=torch.bfloat16),
               cos=torch.zeros((Sq, D), dtype=torch.bfloat16),
               sin=torch.zeros((Sq, D), dtype=torch.bfloat16), bias=torch.zeros((T, Sq)))
    kvb, scb = 2 * kbench_attn.HKV * Sq * D, 2 * kbench_attn.HKV * Sq * 2
    rec = kbench_attn._record("full", Sq, 0, 64, inp, kvb, scb, us=10.0, lib_us=5.0, err=0.0,
                              tol=1e-3, launches=3)
    read = kvb + scb + 2 * Sq * D * 2
    assert rec["bytes_read"] == read and rec["cells_per_split"] == 64
    moved = read + 2 * T * Hq * D * 2 + 4 * T * Sq + 4 * T * Hq * D
    assert rec["bound_us"] == pytest.approx(moved / 3.35e12 * 1e6)
    assert rec["bound_by"] == "bytes"
    assert rec["kv_gbps"] == pytest.approx(kvb / 1e4)
