"""llm_tpu_torch quantized planes held byte-equal to llm_tpu's: the same
GGUF tensor bytes give the same planes, scales and mins in both packages
(K-major matmul planes, the rows layout of embedding tables, and stacked
experts) for every type the port loads (Q8_0, Q4_0, Q4_1, Q5_0, Q5_1, Q2_K
and Q3_K nibble-packed at group size 16, Q4_K, Q5_K, Q6_K, IQ4_NL,
IQ4_XS; the IQ grid types as int8 planes at group size 32, 16 or 8, TQ1_0
and TQ2_0 nibble-packed at group size 256 with zero point 1), the dense weights of load_params(use_planes=False) equal to
llm_tpu's dequantize_tensor, the numpy packers agree, and a seed gives the
same synthetic planes."""

import numpy as np
import pytest

from llm_tpu.gguf.constants import GGMLType
from llm_tpu.models.synthetic import synthetic_qtensor as jax_synthetic_qtensor
from llm_tpu.ops.pallas_qmm import pack_p4 as jax_pack_p4
from llm_tpu.ops.pallas_qmm import pack_p4_kmajor as jax_pack_p4_kmajor
from llm_tpu.quant import codecs
from llm_tpu.quant.qtensor import expert_qtensor_from_gguf as jax_expert_qtensor_from_gguf
from llm_tpu.quant.qtensor import qtensor_from_gguf as jax_qtensor_from_gguf

from llm_tpu_torch.models.synthetic import synthetic_qtensor
from llm_tpu_torch.quant import qtensor
from llm_tpu_torch.quant.codecs import dequantize_dense
from llm_tpu_torch.quant.qtensor import (PLANE_TYPES, dequantize_qtensor,
                                         expert_qtensor_from_gguf, pack_p4, pack_p4_kmajor,
                                         qtensor_from_gguf)

K, N = 512, 96
# every type whose planes the port loads
TYPES = [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
         GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
         GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S,
         GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M, GGMLType.TQ1_0,
         GGMLType.TQ2_0]
# the group size (and layout, zero point) each IQ grid or ternary type's
# planes take
IQ_PLANES = {GGMLType.IQ2_XXS: ("i8", 32, 0), GGMLType.IQ2_XS: ("i8", 16, 0),
             GGMLType.IQ2_S: ("i8", 16, 0), GGMLType.IQ3_XXS: ("i8", 32, 0),
             GGMLType.IQ3_S: ("i8", 32, 0), GGMLType.IQ1_S: ("i8", 32, 0),
             GGMLType.IQ1_M: ("i8", 8, 0), GGMLType.TQ1_0: ("p4", 256, 1),
             GGMLType.TQ2_0: ("p4", 256, 1)}


def _raw(qtype, seed=0):
    w = np.random.default_rng(seed).normal(size=(N, K)).astype(np.float32)
    return codecs.quantize(w, qtype)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def _same_qtensor(got, ref):
    _same(got.qs.numpy(), ref.qs)
    _same(got.scales.numpy(), ref.scales)
    assert (got.mins is None) == (ref.mins is None)
    if ref.mins is not None:
        _same(got.mins.numpy(), ref.mins)
    for f in ("group_size", "layout", "zp", "pack_tk", "kmajor"):
        assert getattr(got, f) == getattr(ref, f), f


def test_plane_types_are_the_tested_ones():
    assert sorted(PLANE_TYPES) == sorted(TYPES)


@pytest.mark.parametrize("kmajor", [True, False], ids=["kmajor", "rows"])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_planes_byte_equal(qtype, kmajor):
    raw = _raw(qtype)
    ref = jax_qtensor_from_gguf(raw, qtype, (K, N), kmajor=kmajor)
    got = qtensor_from_gguf(raw, qtype, (K, N), kmajor=kmajor)
    _same_qtensor(got, ref)
    assert got.in_features == K and got.out_features == N
    if qtype in (GGMLType.Q2_K, GGMLType.Q3_K):  # nibble planes at group size 16
        assert (got.layout, got.group_size, got.zp) == ("p4", 16, 4 * (qtype == GGMLType.Q3_K))
    if qtype in IQ_PLANES:
        assert (got.layout, got.group_size, got.zp) == IQ_PLANES[qtype]


@pytest.mark.parametrize("kmajor", [True, False], ids=["kmajor", "rows"])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_threaded_planes_byte_equal(qtype, kmajor, monkeypatch):
    """The rows unpacked in 5 uneven chunks on threads (the loader's path
    for large matrices, forced here at any size) give llm_tpu's planes."""
    monkeypatch.setattr(qtensor, "THREADED_MIN_WEIGHTS", 1)
    monkeypatch.setattr(qtensor, "LOAD_THREADS", 5)
    raw = _raw(qtype, seed=3)
    ref = jax_qtensor_from_gguf(raw, qtype, (K, N), kmajor=kmajor)
    _same_qtensor(qtensor_from_gguf(raw, qtype, (K, N), kmajor=kmajor), ref)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_expert_stacks_byte_equal(qtype):
    """A 3-D expert stack ne = (K, N/4, 4): rows-layout planes [4, N/4, ...]."""
    raw = _raw(qtype, seed=2)
    ref = jax_expert_qtensor_from_gguf(raw, qtype, (K, N // 4, 4))
    got = expert_qtensor_from_gguf(raw, qtype, (K, N // 4, 4))
    _same_qtensor(got, ref)
    assert got.qs.shape[:2] == (4, N // 4)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_dense_dequantization_equals_reference(qtype):
    """What load_params(use_planes=False) keeps of a quantized matrix (its
    planes dequantized in f32) is llm_tpu's dequantize_tensor, value for
    value (llm_tpu gives Q3_K's in f64, every value an f32 one)."""
    raw = _raw(qtype, seed=3)
    want = codecs.dequantize_tensor(raw, qtype, (K, N))
    got = dequantize_qtensor(qtensor_from_gguf(raw, qtype, (K, N), kmajor=False)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("qtype", [GGMLType.F16, GGMLType.F32, GGMLType.BF16],
                         ids=lambda t: t.name)
def test_dense_types_equal(qtype):
    raw = _raw(qtype)
    want = codecs.dequantize_tensor(raw, qtype, (K, N))
    got = dequantize_dense(raw, qtype, (K, N))
    _same(got, want)


@pytest.mark.parametrize("zp,tile", [(0, 256), (8, 256), (8, 512)])
def test_packers_equal(zp, tile):
    q = np.random.default_rng(1).integers(-zp, 16 - zp, size=(1024, 64)).astype(np.int8)
    _same(pack_p4_kmajor(q, zp, tile), jax_pack_p4_kmajor(q, zp, tile))
    _same(pack_p4(q.T, zp, tile), jax_pack_p4(q.T, zp, tile))


@pytest.mark.parametrize("kmajor", [True, False], ids=["kmajor", "rows"])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q6_K],
                         ids=lambda t: t.name)
def test_synthetic_planes_identical(qtype, kmajor):
    ref = jax_synthetic_qtensor(np.random.default_rng(7), 64, 512, qtype, kmajor=kmajor)
    got = synthetic_qtensor(np.random.default_rng(7), 64, 512, qtype, kmajor=kmajor)
    _same(got.qs.numpy(), ref.qs)
    _same(got.scales.numpy(), ref.scales)
    if ref.mins is not None:
        _same(got.mins.numpy(), ref.mins)
    assert (got.layout, got.zp, got.group_size) == (ref.layout, ref.zp, ref.group_size)
