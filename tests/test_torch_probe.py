"""S1's plain versions (llm_tpu_torch.ops.cuda_probe.probe_plain) held
against numpy sums of llm_tpu's own planes of the same GGUF bytes, row by
row: row 0 the column sums of the packed bytes ("qs", "dma"), row 1 the
column sums of the scales and mins ("dma") or of llm_tpu's
dequantize_qtensor ("deq"), row 2 the sum of x ("dma", "deq"); each plane
term counted once per K1 launch (4 rows of x each). Then the bounds that
the CUDA probes are held to (cuda_probe.tolerance, test_torch_cuda.py and
tools/kbench.py) against probes that skip a load: each must fail them.

Tolerances: row 0 sums integers, exactly; rows 1 and 2 sum f32 values in
another order than numpy's f64 sums, held at 1e-6 of the row's largest sum
of magnitudes (probe_plain(magnitude=True); x's sum cancels)."""

import numpy as np
import pytest
import torch

from llm_tpu.gguf.constants import GGMLType
from llm_tpu.quant import codecs
from llm_tpu.quant.qtensor import dequantize_qtensor
from llm_tpu.quant.qtensor import qtensor_from_gguf as jax_qtensor_from_gguf

from llm_tpu_torch.models.synthetic import device_synthetic_qtensor
from llm_tpu_torch.ops import cuda_probe
from llm_tpu_torch.ops.cuda_probe import probe_plain, tolerance
from llm_tpu_torch.quant.qtensor import QTensor, qtensor_from_gguf


def _planes(qtype, K=512, N=200, seed=0):
    rng = np.random.default_rng(seed)
    raw = codecs.quantize(rng.normal(size=(N, K)).astype(np.float32), qtype)
    return jax_qtensor_from_gguf(raw, qtype, (K, N)), qtensor_from_gguf(raw, qtype, (K, N))


def _x(B, K=512):
    x = torch.from_numpy(np.random.default_rng(B).normal(size=(B, K)).astype(np.float32))
    return x, float(x.to(torch.bfloat16).double().sum())


@pytest.mark.parametrize("mode", ["qs", "dma", "deq"])
@pytest.mark.parametrize("B", [1, 4, 5, 8])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q4_0], ids=lambda t: t.name)
def test_probe_plain_matches_reference_planes(qtype, B, mode):
    jqt, qt = _planes(qtype)
    assert qt.layout == "p4" and (qt.mins is None) == (qtype == GGMLType.Q4_0)
    x, xsum = _x(B)
    C = -(-B // 4)
    want = np.zeros((3, qt.out_features))
    if mode in ("qs", "dma"):
        want[0] = C * np.asarray(jqt.qs).astype(np.int64).sum(0)
    if mode == "dma":
        want[1] = C * np.asarray(jqt.scales, np.float64).sum(0)
        if jqt.mins is not None:
            want[1] += C * np.asarray(jqt.mins, np.float64).sum(0)
    if mode == "deq":
        want[1] = C * dequantize_qtensor(jqt).astype(np.float64).sum(-1)
    if mode != "qs":
        want[2] = xsum
    got = probe_plain(mode, x, qt)
    assert got.shape == (3, qt.out_features) and got.dtype == torch.float32
    err = np.abs(got.double().numpy() - want).max(1)
    assert err[0] == 0
    mag = probe_plain(mode, x, qt, magnitude=True).double().numpy().max(1)
    assert (err[1:] <= 1e-6 * mag[1:]).all()


def _skip_group(qt, g, scales=True, mins=True):
    """qt as a probe that never loaded group row g's scales / mins sees it."""
    def drop(t):
        t = t.clone()
        t[g] = 0
        return t
    return QTensor(
        qt.qs, drop(qt.scales) if scales else qt.scales,
        drop(qt.mins) if mins else qt.mins, qt.group_size, qt.ggml_type, qt.layout, qt.zp,
        qt.pack_tk, qt.kmajor)


@pytest.mark.parametrize("B", [1, 8])
def test_probe_tolerance_catches_skipped_loads(B):
    """At the kbench gate+up depth (K = 4096) on kbench's synthetic planes,
    a probe that skips one group's scales and mins, or only the mins of one
    group, or one row of x, exceeds the bound of its row; the packed bytes
    must match exactly."""
    gen = torch.Generator().manual_seed(B)
    qt = device_synthetic_qtensor(gen, 256, 4096)
    x = torch.randn((B, 4096), generator=gen).to(torch.bfloat16)
    x_short = x.clone()
    x_short[-1] = 0
    for mode, skipped in (("dma", probe_plain("dma", x, _skip_group(qt, 77))),
                          ("dma", probe_plain("dma", x, _skip_group(qt, 5, scales=False))),
                          ("dma", probe_plain("dma", x_short, qt)),
                          ("deq", probe_plain("deq", x, _skip_group(qt, 77, scales=False))),
                          ("deq", probe_plain("deq", x_short, qt))):
        err = (skipped - probe_plain(mode, x, qt)).abs().amax(1, keepdim=True)
        assert (err > tolerance(mode, x, qt)).any(), mode
    tol = tolerance("qs", x, qt)
    assert tol[0] == 0 and tol.shape == (3, 1)


def test_probe_dispatch_and_modes():
    _, qt = _planes(GGMLType.Q4_K)
    x, _ = _x(3)
    assert torch.equal(cuda_probe.probe("deq", x, qt), probe_plain("deq", x, qt))
    with pytest.raises(ValueError):
        probe_plain("full", x, qt)
