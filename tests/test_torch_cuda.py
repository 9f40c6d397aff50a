"""The CUDA kernels (K1/K2 quantized matmul: the decode GEMV at B <= 16,
bit-identical from launch to launch and, as K7, bit-equal to K1/K2 on the
layer, writing bf16 or f32; K3/K4 flash attention (K3/K3q, the cluster
decode kernel, at the main path's T = 1 and 8 over 4096 cells and
bit-identical from launch to launch),
K3q/K4q on the int8 KV cache, the wide kernels and their capped
instantiations (gemma2's attention softcap, at cap 50 and 2), the narrow
kernels' ALiBi instantiations (K3_alibi, K3q_alibi, K4_alibi, K4q_alibi at
Baichuan-13B's heads, G = 4 and refact's G = 32, D = 64, 80 and 128), K5
group-factored matmul, K6 chained layer
tail (SwiGLU, and GeGLU: K6_gelu) and norm + matmul, K7 on stacked planes, the S1 probes, the S3
flash-decode layout and q8 probes) held against
their plain PyTorch versions on the card, at small and ragged shapes
beside those of chip_smoke.py (the prefill GEMM at B past one 128-row
tile and ragged: 129, 300; the wgmma flash prefill K4/K4q at G = 1 and 8,
S = 4001, T = 513 and the main path's T = 512, S = 4096). Every
test here is marked `cuda` and skips without a GPU. The file imports no
JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -o "markers=cuda: needs an NVIDIA GPU" \
        tests/test_torch_cuda.py -q

(with --noconftest the `cuda` marker that tests/conftest.py registers is
given on the command line instead).
"""

import numpy as np
import pytest
import torch

from llm_tpu_torch.gguf.constants import GGMLType
from llm_tpu_torch.models.transformer import alibi_slopes, quantize_rows
from llm_tpu_torch.ops import (cuda_attn, cuda_attn_probe, cuda_probe, cuda_qmm,
                               cuda_qmm_chain, qmatmul)
from llm_tpu_torch.ops.cuda_qmm import qmm_gdot_plain, qmm_plain, qmm_stacked_plain
from llm_tpu_torch.ops.rope import (ROPE_TYPE_NEOX, ROPE_TYPE_NONE, ROPE_TYPE_NORM, RopeParams,
                                    rope_angles)
from llm_tpu_torch.quant.qtensor import QTensor, StackedWeight, pack_p4_kmajor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _planes(layout, zp, gs, mins, N, K, B, scales_dtype, seed=0):
    rng = np.random.default_rng(seed)
    if layout == "p4":
        qs = pack_p4_kmajor(rng.integers(-zp, 16 - zp, size=(K, N)), zp)
    else:
        qs = rng.integers(-32, 32, size=(K, N)).astype(np.int8)
    scales = ((rng.random((K // gs, N)) + 0.5) * 0.01).astype(np.float32)
    m = (rng.random((K // gs, N)) * 0.05).astype(np.float32) if mins else None
    x = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(torch.bfloat16)
    to = (lambda a: torch.from_numpy(a).to(scales_dtype))
    qt = QTensor(torch.from_numpy(qs), to(scales), None if m is None else to(m), gs,
                 GGMLType.Q4_K, layout, zp)
    return x, qt


@pytest.mark.parametrize("scales_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 16, 17, 40, 129, 300])
@pytest.mark.parametrize("layout,zp,gs,mins,N,K", [
    ("p4", 0, 32, True, 256, 512),     # Q4_K
    ("p4", 8, 32, False, 264, 512),    # Q4_0, N not a multiple of 16
    ("p4", 0, 32, True, 1000, 1024),   # ragged N tile
    ("p4", 0, 16, True, 256, 512),     # Q2_K (gs 16, mins)
    ("p4", 4, 16, False, 264, 512),    # Q3_K (gs 16, zero point 4), N not a multiple of 16
    ("p4", 4, 16, False, 1000, 1024),  # Q3_K, ragged N tile
    ("i8", 0, 16, False, 256, 512),    # Q6_K
    ("i8", 0, 32, False, 200, 64),     # Q8_0, short K, ragged N
    ("i8", 0, 32, True, 128, 256),     # i8 with mins
    ("i8", 3, 32, False, 128, 256),    # i8 with a zero point
    ("p4", 1, 256, False, 256, 512),   # TQ2_0 (gs 256, zero point 1)
    ("p4", 1, 256, False, 264, 1024),  # TQ2_0, N not a multiple of 16
    ("i8", 0, 8, False, 256, 512),     # IQ1_M (gs 8)
    ("i8", 0, 8, False, 200, 320),     # IQ1_M, a half stage, ragged N
])
def test_qmm_kernel_matches_plain(cuda_device, layout, zp, gs, mins, N, K, B, scales_dtype):
    x, qt = _planes(layout, zp, gs, mins, N, K, B, scales_dtype)
    got = qmatmul.qmm(x.to(cuda_device), qt.to(cuda_device)).cpu()
    want = qmm_plain(x, qt, torch.bfloat16)
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


# the decode GEMV (K1/K2 at B <= 16, csrc/qmm_decode.cu) at the main path's
# decode shapes: p4 attn_k, p4 down, Q6_K (i8 gs 16) down and an i8 gs 32
# attn_k, the gs 16 nibble planes of Q3_K (attn_k) and Q2_K (down), at B on
# both sides of each 8-row block
DECODE_MAIN = [("Q4_K", 4096, 1024), ("Q4_K", 14336, 4096), ("Q6_K", 14336, 4096),
               ("Q8_0", 4096, 1024), ("Q3_K", 4096, 1024), ("Q2_K", 14336, 4096),
               ("TQ2_0", 2560, 3840), ("TQ2_0", 6912, 2560), ("IQ1_M", 4096, 4096),
               ("IQ1_M", 14336, 4096), ("IQ2_XXS", 4096, 4096)]


def _device_planes(dev, qtype, K, N, B, seed=0):
    from llm_tpu_torch.models.synthetic import device_synthetic_qtensor

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + K + N + B)
    qt = device_synthetic_qtensor(gen, N, K, GGMLType[qtype])
    return torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16), qt


@pytest.mark.parametrize("B", [1, 4, 8, 9, 16])
@pytest.mark.parametrize("qtype,K,N", DECODE_MAIN, ids=[f"{q}-{k}x{n}" for q, k, n in DECODE_MAIN])
def test_decode_main_shapes_match_plain(cuda_device, qtype, K, N, B):
    """One launch of the decode GEMV a call, in f32 or bf16 (counted, and
    seen by the profiler: no memset, no cast), within 1e-3 of max|y| of
    qmm_plain; the bf16 y is the f32 one rounded."""
    from torch.profiler import ProfilerActivity, profile

    x, qt = _device_planes(cuda_device, qtype, K, N, B)
    kern = cuda_qmm.kernel_name("K1", qt)
    launched = cuda_qmm.LAUNCHES[kern]
    y = cuda_qmm.qmm_cuda(x, qt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y16 = cuda_qmm.qmm_cuda(x, qt, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
    assert cuda_qmm.LAUNCHES[kern] == launched + 2
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in dev) == 1 and "qmm_decode" in dev[0].key, \
        [(e.key, e.count) for e in dev]
    want = qmm_plain(x, qt, torch.bfloat16)
    assert y.dtype == torch.float32 and y16.dtype == torch.bfloat16
    assert (y - want).abs().max() <= 1e-3 * want.abs().max()
    assert torch.equal(y16, y.to(torch.bfloat16))


@pytest.mark.parametrize("cluster", [1, 2, 5, 16])
@pytest.mark.parametrize("qtype,K,N,B", [("Q4_K", 4096, 1024, 1), ("Q6_K", 4096, 1024, 16),
                                         ("Q4_K", 4096, 1000, 9)])
def test_decode_is_bit_identical_from_launch_to_launch(cuda_device, qtype, K, N, B, cluster):
    """No atomics: two launches give the same bits at every cluster size,
    each within 1e-3 of max|y| of qmm_plain."""
    from llm_tpu_torch.quant.qtensor import QTensor

    x, qt = _device_planes(cuda_device, qtype, K, N if N % 16 == 0 else 1024, B)
    if N % 16:  # a ragged N: the producer gathers the planes
        qt = QTensor(qt.qs[:, :N].contiguous(), qt.scales[:, :N].contiguous(),
                     None if qt.mins is None else qt.mins[:, :N].contiguous(),
                     qt.group_size, qt.ggml_type, qt.layout, qt.zp, qt.pack_tk, qt.kmajor)
    y1 = cuda_qmm._qmm_launch(x, qt, False, cluster)
    y2 = cuda_qmm._qmm_launch(x, qt, False, cluster)
    want = qmm_plain(x, qt, torch.bfloat16)
    assert torch.equal(y1, y2)
    assert (y1 - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("qtype,K,N", [("Q4_K", 4096, 1024), ("Q6_K", 1024, 512),
                                       ("Q8_0", 14336, 256)])
def test_k7_decode_equals_unstacked_bit_for_bit(cuda_device, qtype, K, N, B):
    """K7 at B <= 16 is the decode GEMV on the layer the index names: the
    same bits as K1/K2 on that layer's own copy."""
    from llm_tpu_torch.models.synthetic import device_synthetic_qtensor

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(K + N + B)
    layers = [device_synthetic_qtensor(gen, N, K, GGMLType[qtype]) for _ in range(3)]
    one = layers[0]
    st = (lambda ts: torch.stack(ts))
    qt = QTensor(st([q.qs for q in layers]), st([q.scales for q in layers]),
                 None if one.mins is None else st([q.mins for q in layers]), one.group_size,
                 one.ggml_type, one.layout, one.zp, one.pack_tk, one.kmajor)
    x = torch.randn((B, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    lids = torch.arange(3, dtype=torch.int32, device=cuda_device)
    for il in range(3):
        got = cuda_qmm.qmm_stacked_cuda(x, StackedWeight(qt, lids[il:il + 1]))
        assert torch.equal(got, cuda_qmm.qmm_cuda(x, layers[il]))


# (type, K, N, gdot): the group-size-16 forms (Q3_K without mins, Q2_K
# with them; K5_gs16 with gdot), 32, 256 and 8
REPEAT_SHAPES = [("Q3_K", 4096, 28672, False), ("Q4_K", 4096, 28672, False),
                 ("TQ2_0", 2560, 13824, False), ("IQ1_M", 4096, 28672, False),
                 ("Q2_K", 4096, 28672, False), ("Q3_K", 4096, 28672, True),
                 ("Q2_K", 4096, 28672, True)]


@pytest.mark.parametrize("qtype,K,N,gdot", REPEAT_SHAPES,
                         ids=[f"{q}-{k}x{n}" + ("-K5" if g else "")
                              for q, k, n, g in REPEAT_SHAPES])
def test_decode_gives_the_same_bits_over_many_launches(cuda_device, qtype, K, N, gdot):
    """The decode GEMV sums in a fixed order and uses no atomics: K7 on each
    layer of a two-layer stack and K1/K2 on each layer's own planes (K7's
    K5 variant and K5 with gdot), launched back to back 1500 times each on
    one input at B = 1, give the first launch's bits every time. The
    consumers' proxy fence before they release a slot (qmm_decode.cuh
    dv_release) is what keeps the Q3_K case's last x fragments from the
    next round's TMA."""
    from llm_tpu_torch.models.synthetic import device_synthetic_qtensor

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    layers = [device_synthetic_qtensor(gen, N, K, GGMLType[qtype]) for _ in range(2)]
    one = layers[0]
    st = (lambda ts: torch.stack(ts))
    qt = QTensor(st([q.qs for q in layers]), st([q.scales for q in layers]),
                 None if one.mins is None else st([q.mins for q in layers]), one.group_size,
                 one.ggml_type, one.layout, one.zp, one.pack_tk, one.kmajor)
    views = [qt.map(lambda t, il=il: t[il]) for il in range(2)]
    lids = torch.arange(2, dtype=torch.int32, device=cuda_device)
    sws = [StackedWeight(qt, lids[il:il + 1]) for il in range(2)]
    x = torch.randn((1, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    want = [cuda_qmm.qmm_cuda(x, views[il], gdot) for il in range(2)]
    off = []
    for it in range(1500):
        for il in range(2):
            for kind, y in (("K7", cuda_qmm.qmm_stacked_cuda(x, sws[il], gdot)),
                            ("unstacked", cuda_qmm.qmm_cuda(x, views[il], gdot))):
                if not torch.equal(y, want[il]):
                    off.append((it, kind, il, (y - want[il]).abs().max().item()))
    assert not off, f"{len(off)} of 6000 launches differ from the first: {off[:8]}"


def test_prefill_gemm_gives_the_same_bits_over_many_launches(cuda_device):
    """The prefill GEMM's consumers release a ring slot after their
    ld.shared of the planes, behind a proxy fence before the producer's
    next TMA (qmm_gemm_body.cuh), as the decode GEMV's dv_release: at
    LLAMA3_8B's Q4_K gate+up, a 512-token step with its K unsplit (a split
    adds through atomics in a varying order), 1500 back-to-back launches on
    one input give the first launch's bits every time."""
    x, qt = _device_planes(cuda_device, "Q4_K", 4096, 28672, 512)
    want = cuda_qmm._qmm_launch(x, qt, False, 1)
    off = [it for it in range(1500)
           if not torch.equal(cuda_qmm._qmm_launch(x, qt, False, 1), want)]
    assert not off, f"{len(off)} of 1500 launches differ from the first: {off[:8]}"


# (T, H, Hkv, S): LLAMA3_8B's heads (G = 4) and GLM-4-9B's (G = 16: 16 and
# 128 query rows a KV head at T = 1 and 8) at decode (K3 / K3q) and at a
# 512-token prefill step (K4 / K4q) over 4096 cells
ATTN_REPEAT_SHAPES = [(1, 32, 8, 4096), (8, 32, 8, 4096), (512, 32, 8, 4096),
                      (1, 32, 2, 4096), (8, 32, 2, 4096), (512, 32, 2, 4096)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("T,H,Hkv,S", ATTN_REPEAT_SHAPES,
                         ids=[f"T{t}-H{h}-Hkv{g}" for t, h, g, _ in ATTN_REPEAT_SHAPES])
def test_flash_gives_the_same_bits_over_many_launches(cuda_device, q8, T, H, Hkv, S):
    """K3/K3q's consumers read their ring slots by ldmatrix and K4/K4q's
    producer reads its raw block by ld.shared before a TMA refills them
    (flash_attn.cu, flash_prefill.cuh), each behind a proxy fence, as the
    decode GEMV's dv_release: 1500 back-to-back launches on one input at
    the main path's heads give the first launch's bits every time."""
    t = _attn_inputs(T, H, Hkv, S, ROPE_TYPE_NORM)
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    launch = cuda_attn._decode_launch if T <= 8 else cuda_attn._prefill_launch
    run = (lambda: launch(q8, **dev, scale=128 ** -0.5))
    want = run()
    off = [it for it in range(1500) if not torch.equal(run(), want)]
    assert not off, f"{len(off)} of 1500 launches differ from the first: {off[:8]}"


# (T, H, Hkv, Dk, Dv, q8, softcap) over 4096 cells: K3w / K3qw at
# Gemma-7B's heads (16 over 16 of 256); the wide K4w / K4qw's ring at two
# chunks (Gemma-7B's heads, a split of 2; Gemma-2-2B's 8 over 4, a split of
# 4), at one (Dk 128 / Dv 64), capped (Gemma-2-9B's heads), on the int8
# cache at 256 and at rows of 8 mod 16 bytes (72: one chunk by cp.async;
# 136: two), and the narrow capped K4_cap / K4q_cap at Gemma-2-27B's heads
WIDE_REPEAT_CASES = [(1, 16, 16, 256, 256, False, 0.0), (1, 16, 16, 256, 256, True, 0.0),
                     (512, 16, 16, 256, 256, False, 0.0), (512, 16, 16, 256, 256, True, 0.0),
                     (512, 8, 4, 256, 256, False, 0.0), (512, 32, 8, 128, 64, False, 0.0),
                     (512, 16, 8, 256, 256, False, 50.0), (512, 16, 8, 256, 256, True, 50.0),
                     (512, 32, 8, 72, 72, True, 0.0), (512, 16, 8, 136, 136, True, 0.0),
                     (512, 32, 16, 128, 128, False, 50.0), (512, 32, 16, 128, 128, True, 50.0)]


@pytest.mark.parametrize("T,H,Hkv,Dk,Dv,q8,softcap", WIDE_REPEAT_CASES,
                         ids=[f"T{t}-H{h}-Hkv{hk}-Dk{dk}-Dv{dv}-{'q8' if q else 'bf16'}-cap{c:g}"
                              for t, h, hk, dk, dv, q, c in WIDE_REPEAT_CASES])
def test_wide_flash_gives_the_same_bits_over_many_launches(cuda_device, T, H, Hkv, Dk, Dv, q8,
                                                           softcap):
    """The wide kernels and the capped ones: K4w's producer reads each
    item's raw inputs through the generic proxy and writes the planes over
    them before a later TMA refills the slot, its consumers release a slot
    chunk by chunk and meet their split's ranks in rank order, and K3w's
    consumers read their slots likewise; 1500 back-to-back launches on one
    input give the first launch's bits every time."""
    t = _attn_inputs(T, H, Hkv, 4096, ROPE_TYPE_NORM, D=Dk, Dv=Dv)
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    launch = cuda_attn._decode_launch if T <= 8 else cuda_attn._prefill_launch
    run = (lambda: launch(q8, **dev, scale=Dk ** -0.5, softcap=softcap))
    want = run()
    off = [it for it in range(1500) if not torch.equal(run(), want)]
    assert not off, f"{len(off)} of 1500 launches differ from the first: {off[:8]}"


@pytest.mark.parametrize("B,gdot", [(1, False), (9, False), (17, False), (1, True), (9, True)])
def test_out_dtype_bf16_is_the_f32_result_rounded(cuda_device, B, gdot):
    """out_dtype=bf16 gives the f32 result rounded once to bf16: written by
    the decode GEMV (K1 and K5 at B <= 16), cast after the prefill GEMM (B =
    17, its K unsplit: a split adds through atomics in a varying order); the
    same for K7 at B <= 16."""
    x, qt = _planes("p4", 0, 32, True, 512, 1024, B, torch.bfloat16)
    xd, qd = x.to(cuda_device), qt.to(cuda_device)
    split = 1 if B > 16 else None
    f32 = cuda_qmm._qmm_launch(xd, qd, gdot, split)
    b16 = cuda_qmm._qmm_launch(xd, qd, gdot, split, torch.bfloat16)
    assert f32.dtype == torch.float32 and b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))
    if B <= 16:
        q3 = qd.map(lambda t: torch.stack([t, t]))
        sw = StackedWeight(q3, torch.ones(1, dtype=torch.int32, device=cuda_device))
        got = cuda_qmm.qmm_stacked_cuda(xd, sw, gdot, out_dtype=torch.bfloat16)
        assert torch.equal(got, b16)


def _attn_inputs(T, H, Hkv, S, mode, seed=0, D=128, Dv=None):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((T, H, D), generator=g).to(torch.bfloat16)
    k = torch.randn((Hkv, S, D), generator=g).to(torch.bfloat16)
    v = torch.randn((Hkv, S, Dv or D), generator=g).to(torch.bfloat16)
    pos = torch.randperm(S, generator=g)
    c, s = rope_angles(pos, RopeParams(n_dims=D, mode=mode))
    cos, sin = (t.to(torch.bfloat16).contiguous()
                for t in cuda_attn.expand_tables(c, s, mode, D))
    tok_pos = torch.sort(torch.randint(S // 4, S, (T,), generator=g)).values
    allowed = (pos[None, :] <= tok_pos[:, None]) & (torch.arange(S) < S - S // 4)[None]
    allowed[0] = False  # a padding row that sees nothing
    bias = torch.zeros((T, S)).masked_fill_(~allowed, float("-inf"))
    return dict(q=q, q_rot=cuda_attn.rope_companion(q, mode).contiguous(), k=k, v=v,
                cos=cos, sin=sin, bias=bias)


# flash prefill (T > 8) at G = 1 (H = Hkv), G = 8, a ragged S = 4001, T = 513
# (a CTA of 32 tokens past 16 full ones) and the main path's T=512 S=4096
PREFILL_CASES = [(40, 8, 8, 300), (24, 16, 2, 200), (100, 32, 8, 4001), (513, 32, 8, 1024),
                 (512, 32, 8, 4096)]


# flash decode (T <= 8) at the main path's shapes: T = 1 and 8 over a
# 4096-cell cache at LLAMA3_8B's heads
DECODE_MAIN_CASES = [(1, 32, 8, 4096), (8, 32, 8, 4096)]


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S", [(1, 32, 8, 1000), (3, 8, 8, 64), (8, 32, 8, 512),
                                       (8, 64, 8, 512), (9, 4, 1, 70), (40, 32, 8, 300),
                                       (512, 32, 8, 1024)] + PREFILL_CASES + DECODE_MAIN_CASES)
def test_flash_kernels_match_plain(cuda_device, T, H, Hkv, S, mode):
    t = _attn_inputs(T, H, Hkv, S, mode)
    fn = cuda_attn.flash_decode if T <= 8 else cuda_attn.flash_prefill
    got = fn(**{n: a.to(cuda_device) for n, a in t.items()}, scale=128 ** -0.5).cpu()
    want = cuda_attn.attn_plain(**t, scale=128 ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def _q8(x):
    """bf16 [Hkv, S, D] -> (int8, bf16 scales [Hkv, S, 1]) by the cache's quantizer."""
    return quantize_rows(x, 1)


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S", [(1, 32, 8, 1000), (2, 8, 8, 64), (3, 8, 1, 500),
                                       (5, 8, 2, 333), (8, 32, 8, 512), (8, 4, 4, 4001),
                                       (9, 4, 1, 70), (24, 16, 2, 200), (40, 32, 8, 300),
                                       (512, 32, 8, 1024)] + PREFILL_CASES[:1] + PREFILL_CASES[2:]
                         + DECODE_MAIN_CASES)
def test_flash_q8_kernels_match_plain(cuda_device, T, H, Hkv, S, mode):
    """K3q (T <= 8) and K4q against attn_plain on the same (int8, scales)
    pairs: ragged S, G in {1, 4, 8}, a padding row (row 0) that sees nothing."""
    t = _attn_inputs(T, H, Hkv, S, mode)
    t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    fn = cuda_attn.flash_decode if T <= 8 else cuda_attn.flash_prefill
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    launched = dict(cuda_attn.LAUNCHES)
    got = fn(**dev, scale=128 ** -0.5).cpu()
    want = cuda_attn.attn_plain(**t, scale=128 ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    kern = "K3q" if T <= 8 else "K4q"
    assert cuda_attn.LAUNCHES[kern] == launched[kern] + 1


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("T,S", [(2, 288), (3, 400), (4, 576)])
def test_flash_decode_rows_of_several_sequences_match_plain(cuda_device, T, S, q8):
    """K3/K3q at the server's batched steps (LLAMA3_8B heads, T = B rows):
    row t sees only its own sequence's cells (prompt runs of 128 cells,
    then runs of 8 dealt in turn), held against attn_plain; the launch is
    counted under its T."""
    t = _attn_inputs(T, 32, 8, S, ROPE_TYPE_NORM)
    c = torch.arange(S)
    owner = torch.where(c < T * 128, c // 128, ((c - T * 128).clamp(min=0) // 8) % T)
    rows = torch.arange(T)[:, None]
    seen = (owner[None, :] == rows) & (c[None, :] < S - rows)
    t["bias"] = torch.zeros((T, S)).masked_fill_(~seen, float("-inf"))
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    before = cuda_attn.DECODE_LAUNCHES_BY_T.get(T, 0)
    got = cuda_attn.flash_decode(**dev, scale=128 ** -0.5).cpu()
    want = cuda_attn.attn_plain(**t, scale=128 ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    assert cuda_attn.DECODE_LAUNCHES_BY_T[T] == before + 1


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("T,H,Hkv,S,cluster", [(1, 32, 8, 4096, None), (8, 32, 8, 4001, None),
                                               (3, 8, 2, 333, 1), (3, 8, 2, 333, 5),
                                               (1, 32, 8, 4096, 6), (8, 64, 8, 1000, 7)])
def test_flash_decode_is_bit_identical_from_launch_to_launch(cuda_device, q8, T, H, Hkv, S,
                                                             cluster):
    """K3 and K3q are one launch a call (no combine kernel, no scratch): the
    ranks of a cluster meet through distributed shared memory in rank order,
    so two launches give the same bits, at the plan's cluster size (None)
    and at others, ragged S and two row chunks among them; each within
    atol = rtol = 1e-3 of attn_plain."""
    t = _attn_inputs(T, H, Hkv, S, ROPE_TYPE_NORM)
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    kern = "K3q" if q8 else "K3"
    launched = cuda_attn.LAUNCHES[kern]
    run = (lambda: cuda_attn._decode_launch(q8, **dev, scale=128 ** -0.5, cluster=cluster))
    first, second = run(), run()
    torch.cuda.synchronize()
    assert cuda_attn.LAUNCHES[kern] == launched + 2
    assert torch.equal(first, second)
    torch.testing.assert_close(first.cpu(), cuda_attn.attn_plain(**t, scale=128 ** -0.5),
                               atol=1e-3, rtol=1e-3)


# the head dims and GQA groups past LLAMA3_8B's: D = 64 (Llama-3.2-1B), 80,
# 96 and a D the kernels take at run time (40); G = 3 (Llama-3.2-3B) at 128
# and 64. (T, H, Hkv, S, D); T <= 8 runs K3, T > 8 K4
DIM_CASES = [(1, 32, 8, 4096, 64), (8, 32, 8, 4096, 64), (512, 32, 8, 4096, 64),
             (1, 16, 8, 1000, 80), (40, 16, 8, 1000, 80), (3, 8, 2, 333, 96),
             (100, 8, 2, 4001, 96), (2, 8, 2, 200, 40), (24, 8, 2, 200, 40),
             (1, 24, 8, 4096, 128), (8, 24, 8, 4096, 128), (512, 24, 8, 4096, 128),
             (130, 6, 2, 1000, 64), (513, 24, 8, 1024, 128)]


@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S,D", DIM_CASES)
def test_flash_kernels_match_plain_at_any_head_dim_and_group(cuda_device, T, H, Hkv, S, D,
                                                             mode):
    """K3/K4 at head dims below 128 (the blocks' columns past D zero) and at
    G = 3 (a token's rows split over two CTAs of K4) against attn_plain."""
    t = _attn_inputs(T, H, Hkv, S, mode, D=D)
    fn = cuda_attn.flash_decode if T <= 8 else cuda_attn.flash_prefill
    kern = "K3" if T <= 8 else "K4"
    launched = cuda_attn.LAUNCHES[kern]
    got = fn(**{n: a.to(cuda_device) for n, a in t.items()}, scale=D ** -0.5).cpu()
    want = cuda_attn.attn_plain(**t, scale=D ** -0.5)
    assert cuda_attn.LAUNCHES[kern] == launched + 1
    assert got.shape == (T, H, D) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


# the int8 cache keeps one scale a row at D = 80 and 112 (kv_group) and at
# 128; G = 3 at 128
Q8_DIM_CASES = [(1, 16, 8, 4096, 80), (8, 16, 8, 4096, 80), (512, 16, 8, 4096, 80),
                (3, 8, 2, 333, 112), (40, 8, 2, 333, 112), (1, 24, 8, 4096, 128),
                (512, 24, 8, 4096, 128)]


@pytest.mark.parametrize("T,H,Hkv,S,D", Q8_DIM_CASES)
def test_flash_q8_kernels_match_plain_at_any_head_dim_and_group(cuda_device, T, H, Hkv, S, D):
    t = _attn_inputs(T, H, Hkv, S, ROPE_TYPE_NEOX, D=D)
    t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    fn = cuda_attn.flash_decode if T <= 8 else cuda_attn.flash_prefill
    kern = "K3q" if T <= 8 else "K4q"
    launched = cuda_attn.LAUNCHES[kern]
    got = fn(**dev, scale=D ** -0.5).cpu()
    assert cuda_attn.LAUNCHES[kern] == launched + 1
    torch.testing.assert_close(got, cuda_attn.attn_plain(**t, scale=D ** -0.5),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("D", [64, 80, 96])
def test_flash_decode_at_any_head_dim_is_bit_identical(cuda_device, D):
    t = _attn_inputs(3, 8, 2, 1000, ROPE_TYPE_NORM, D=D)
    dev = {n: a.to(cuda_device) for n, a in t.items()}
    first, second = (cuda_attn._decode_launch(False, **dev, scale=D ** -0.5, cluster=5)
                     for _ in range(2))
    assert torch.equal(first, second)


# the wide kernels: heads past 128 (gemma's 256; 136), Dk != Dv (MLA's
# 192 / 128; 128 / 64; 64 / 128) and, on the int8 cache, rows whose pitch is
# 8 mod 16 bytes (72, 136). (T, H, Hkv, S, Dk, Dv); T <= 8 runs K3w, T > 8
# K4w; T * G past 16 takes more row chunks of the wide K3 (64 rows: four)
WIDE_CASES = [(1, 8, 4, 4096, 256, 256), (8, 8, 4, 4096, 256, 256), (512, 8, 4, 4096, 256, 256),
              (3, 16, 2, 333, 256, 256), (100, 8, 4, 4001, 256, 256),
              (1, 16, 16, 4096, 192, 128), (8, 16, 16, 1000, 192, 128),
              (512, 16, 16, 4096, 192, 128), (1, 32, 8, 4096, 128, 64),
              (40, 32, 8, 1000, 128, 64), (4, 8, 2, 500, 64, 128), (24, 8, 2, 500, 64, 128),
              (2, 8, 2, 200, 136, 136), (70, 8, 2, 200, 136, 136), (8, 8, 1, 300, 256, 256),
              (512, 32, 8, 4096, 128, 64), (512, 16, 16, 4096, 256, 256), (9, 16, 8, 333, 256, 256)]
WIDE_Q8_CASES = [(1, 8, 4, 4096, 256, 256), (512, 8, 4, 4096, 256, 256),
                 (1, 8, 4, 4096, 72, 72), (8, 8, 2, 999, 72, 72), (512, 8, 4, 4096, 72, 72),
                 (1, 8, 4, 4096, 136, 136), (100, 8, 4, 1000, 136, 136),
                 (3, 16, 16, 700, 192, 128), (40, 16, 16, 700, 192, 128),
                 (512, 32, 8, 4096, 72, 72), (512, 16, 8, 4096, 136, 136),
                 (512, 16, 16, 4096, 192, 128)]


def _wide_ids(cases):
    return [f"T{t}-H{h}-Hkv{hk}-S{s}-Dk{dk}-Dv{dv}" for t, h, hk, s, dk, dv in cases]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
@pytest.mark.parametrize("T,H,Hkv,S,Dk,Dv", WIDE_CASES + WIDE_Q8_CASES,
                         ids=_wide_ids(WIDE_CASES + WIDE_Q8_CASES))
def test_flash_wide_kernels_match_plain(cuda_device, T, H, Hkv, S, Dk, Dv, mode, q8):
    """K3w/K4w (K3qw/K4qw on (int8, scales) pairs) against attn_plain at
    atol = rtol = 1e-3, each one launch; the cases the narrow kernels take
    (bf16 at 72, WIDE_Q8_CASES' rows on a dense cache) do not run here."""
    if cuda_attn.is_narrow(Dk, Dv, q8):
        pytest.skip("the narrow kernels take these heads")
    t = _attn_inputs(T, H, Hkv, S, mode, D=Dk, Dv=Dv)
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    fn = cuda_attn.flash_decode if T <= 8 else cuda_attn.flash_prefill
    kern = ("K3" if T <= 8 else "K4") + ("q" if q8 else "") + "w"
    launched = cuda_attn.LAUNCHES[kern]
    got = fn(**dev, scale=Dk ** -0.5).cpu()
    assert cuda_attn.LAUNCHES[kern] == launched + 1
    assert got.shape == (T, H, Dv) and torch.isfinite(got).all()
    torch.testing.assert_close(got, cuda_attn.attn_plain(**t, scale=Dk ** -0.5),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("Dk,Dv", [(256, 256), (192, 128), (136, 136)])
def test_flash_decode_wide_is_bit_identical(cuda_device, Dk, Dv, q8):
    """The wide K3/K3q meet their ranks in rank order too: two launches at
    a cluster of 5 give the same bits."""
    t = _attn_inputs(3, 8, 2, 1000, ROPE_TYPE_NORM, D=Dk, Dv=Dv)
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    first, second = (cuda_attn._decode_launch(q8, **dev, scale=Dk ** -0.5, cluster=5)
                     for _ in range(2))
    assert torch.equal(first, second)


@pytest.mark.parametrize("split", [1, 2, 3, 8])
@pytest.mark.parametrize("q8,Dk,Dv,softcap", [(False, 256, 256, 0.0), (True, 256, 256, 50.0),
                                             (False, 128, 64, 0.0), (True, 136, 136, 0.0)],
                         ids=["bf16-256", "q8-256-cap50", "bf16-128-64", "q8-136"])
def test_wide_prefill_at_any_split_matches_plain(cuda_device, q8, Dk, Dv, softcap, split):
    """The wide K4w / K4qw with a KV head's 32-cell blocks split over a
    cluster of 1, 2, 3 or 8 CTAs (the last rank's blocks fewer), their
    partials met in rank order, against attn_plain at atol = rtol = 1e-3;
    the same launch twice gives the same bits."""
    t = _attn_inputs(100, 8, 2, 1000, ROPE_TYPE_NEOX, D=Dk, Dv=Dv)
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    scale = 2.0 * Dk ** -0.5
    first, second = (cuda_attn._prefill_launch(q8, **dev, scale=scale, softcap=softcap,
                                               split=split) for _ in range(2))
    assert torch.equal(first, second)
    torch.testing.assert_close(first.cpu(), cuda_attn.attn_plain(**t, scale=scale,
                                                                 softcap=softcap),
                               atol=1e-3, rtol=1e-3)


# the capped kernels (gemma2's attention softcap): Gemma-2-9B's heads (16
# over 8 of 256) at decode, prefill, a ragged S and T * G past 16 (the
# wide K3w_cap / K4w_cap); Gemma-2-27B's (32 over 16 of 128: K3w_cap at
# decode, the narrow K4_cap at a prefill step); G = 4 at 128 and the
# run-time D kernel at 64. (T, H, Hkv, S, D)
CAP_CASES = [(1, 16, 8, 4096, 256), (8, 16, 8, 4096, 256), (512, 16, 8, 4096, 256),
             (3, 16, 8, 333, 256), (100, 16, 8, 1000, 256), (1, 32, 16, 4096, 128),
             (8, 32, 16, 1000, 128), (512, 32, 16, 4096, 128), (40, 8, 2, 300, 128),
             (100, 8, 2, 1000, 64)]


@pytest.mark.parametrize("cap", [50.0, 2.0], ids=["cap50", "cap2"])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("T,H,Hkv,S,D", CAP_CASES,
                         ids=[f"T{t}-H{h}-Hkv{hk}-S{s}-D{d}" for t, h, hk, s, d in CAP_CASES])
def test_flash_capped_kernels_match_plain(cuda_device, T, H, Hkv, S, D, q8, cap):
    """K3w_cap/K4w_cap and K4_cap (K3qw_cap/K4qw_cap and K4q_cap on (int8,
    scales) pairs) against attn_plain(softcap=cap) at the uncapped kernels'
    atol = rtol = 1e-3, each one launch of its capped kernel and none of
    another: capped decode always wide, capped prefill narrow where the
    uncapped one is; cap 2 bends most scores (|s| ~ 1 here), cap 50
    gemma2's own. Past T = 1, row 0 is a padding row."""
    t = _attn_inputs(T, H, Hkv, S, ROPE_TYPE_NEOX, D=D)
    if T == 1:  # a row that sees cells (_attn_inputs' row 0 sees none)
        t["bias"] = torch.zeros((1, S)).masked_fill_(
            torch.arange(S)[None] >= S - S // 4, float("-inf"))
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    fn = cuda_attn.flash_decode if T <= 8 else cuda_attn.flash_prefill
    kern = ("K3" + ("q" if q8 else "") + "w_cap" if T <= 8
            else "K4" + ("q" if q8 else "") + ("_cap" if D <= 128 else "w_cap"))
    launched = dict(cuda_attn.LAUNCHES)
    got = fn(**dev, scale=D ** -0.5, softcap=cap).cpu()
    assert {k: v - launched[k] for k, v in cuda_attn.LAUNCHES.items() if v != launched[k]} \
        == {kern: 1}
    assert got.shape == (T, H, D) and torch.isfinite(got).all()
    want = cuda_attn.attn_plain(**t, scale=D ** -0.5, softcap=cap)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    if cap == 2.0:  # the cap is live: the uncapped function is elsewhere
        assert (want - cuda_attn.attn_plain(**t, scale=D ** -0.5)).abs().max() > 1e-2


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
def test_flash_decode_capped_is_bit_identical(cuda_device, q8):
    """The capped K3w/K3qw meet their ranks in rank order: two launches at a
    cluster of 5 give the same bits."""
    t = _attn_inputs(3, 16, 8, 1000, ROPE_TYPE_NEOX, D=256)
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    first, second = (cuda_attn._decode_launch(q8, **dev, scale=256 ** -0.5, cluster=5,
                                              softcap=50.0) for _ in range(2))
    assert torch.equal(first, second)


def _alibi_inputs(T, H, Hkv, S, D, seed=0):
    """Inputs on rope NONE (q_rot, cos and sin None, as the ALiBi kernels
    take them), cells at a permutation of positions, the last quarter
    empty, T tokens at sorted positions (past T = 1 row 0 a padding row
    that sees nothing), and ALiBi's slopes of max_bias 8 with tok_pos and
    cell_pos in f32."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((T, H, D), generator=g).to(torch.bfloat16)
    k = torch.randn((Hkv, S, D), generator=g).to(torch.bfloat16)
    v = torch.randn((Hkv, S, D), generator=g).to(torch.bfloat16)
    pos = torch.randperm(S, generator=g)
    tok_pos = torch.sort(torch.randint(S // 4, S, (T,), generator=g)).values
    allowed = (pos[None, :] <= tok_pos[:, None]) & (torch.arange(S) < S - S // 4)[None]
    if T > 1:
        allowed[0] = False
    return dict(q=q, q_rot=None, k=k, v=v, cos=None, sin=None,
                bias=torch.zeros((T, S)).masked_fill_(~allowed, float("-inf")),
                alibi_slopes=torch.tensor(alibi_slopes(H, 8.0), dtype=torch.float32),
                tok_pos=tok_pos.float(), cell_pos=pos.float())


def _on(t: dict, device) -> dict:
    """t's tensors (and pairs' tensors) on device; None stays None."""
    return {n: (None if a is None else tuple(x.to(device) for x in a)
                if isinstance(a, tuple) else a.to(device)) for n, a in t.items()}


def _rope_none(t: dict) -> dict:
    """t without ALiBi, on rope NONE's tables (q_rot 0, cos 1, sin 0) that
    the kernels without ALiBi read."""
    S, D = t["bias"].shape[1], t["q"].shape[-1]
    cos, sin = (x.to(torch.bfloat16).contiguous() for x in cuda_attn.expand_tables(
        torch.zeros((S, 0)), torch.zeros((S, 0)), ROPE_TYPE_NONE, D))
    return {**{n: a for n, a in t.items() if n not in ("alibi_slopes", "tok_pos", "cell_pos")},
            "q_rot": torch.zeros_like(t["q"]), "cos": cos, "sin": sin}


# the ALiBi kernels (T, H, Hkv, S, D): Baichuan-13B's heads (40 over 40 of
# 128) at decode, prefill and a ragged S; G = 4 at 128 and 64; refact's
# G = 32 at 64 (the run-time D kernels); D = 80; a prefill past 512 rows
ALIBI_CASES = [(1, 40, 40, 4096, 128), (8, 40, 40, 4096, 128), (512, 40, 40, 4096, 128),
               (3, 40, 40, 333, 128), (1, 16, 4, 1000, 128), (8, 32, 8, 512, 128),
               (40, 8, 2, 300, 128), (8, 16, 4, 700, 64), (1, 32, 1, 1000, 64),
               (8, 32, 1, 700, 64), (100, 32, 1, 1000, 64), (4, 8, 2, 300, 80),
               (513, 8, 8, 1024, 128)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("T,H,Hkv,S,D", ALIBI_CASES,
                         ids=[f"T{t}-H{h}-Hkv{hk}-S{s}-D{d}" for t, h, hk, s, d in ALIBI_CASES])
def test_flash_alibi_kernels_match_plain(cuda_device, T, H, Hkv, S, D, q8):
    """K3_alibi/K4_alibi (K3q_alibi/K4q_alibi on (int8, scales) pairs)
    against attn_plain(alibi_slopes=, tok_pos=, cell_pos=) at atol = rtol
    = 1e-3, each one launch of its ALiBi kernel and none of another; ALiBi
    bites (without it attn_plain is elsewhere)."""
    t = _alibi_inputs(T, H, Hkv, S, D, seed=T + H + D)
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = _on(t, cuda_device)
    fn = cuda_attn.flash_decode if T <= 8 else cuda_attn.flash_prefill
    kern = ("K3" if T <= 8 else "K4") + ("q" if q8 else "") + "_alibi"
    launched = dict(cuda_attn.LAUNCHES)
    got = fn(**dev, scale=D ** -0.5).cpu()
    assert {k: v - launched[k] for k, v in cuda_attn.LAUNCHES.items() if v != launched[k]} \
        == {kern: 1}
    assert got.shape == (T, H, D) and torch.isfinite(got).all()
    want = cuda_attn.attn_plain(**t, scale=D ** -0.5)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    assert (want - cuda_attn.attn_plain(**_rope_none(t), scale=D ** -0.5)).abs().max() > 1e-2


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
def test_flash_decode_alibi_is_bit_identical(cuda_device, q8):
    """K3_alibi/K3q_alibi meet their ranks in rank order: two launches at a
    cluster of 5 give the same bits."""
    t = _alibi_inputs(3, 40, 40, 1000, 128)
    if q8:
        t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = _on(t, cuda_device)
    first, second = (cuda_attn._decode_launch(q8, **dev, scale=128 ** -0.5, cluster=5)
                     for _ in range(2))
    assert torch.equal(first, second)


def test_flash_alibi_refuses_what_no_kernel_takes(cuda_device):
    """ALiBi runs the narrow, uncapped kernels only (flash_route sends the
    rest to the unfused attention), with no rope: a head of 256, a
    softcap, slopes without the positions, positions of the wrong type or
    shape, and rope tables beside ALiBi raise, launching nothing."""
    launched = dict(cuda_attn.LAUNCHES)
    for T in (1, 16):
        fn = cuda_attn.flash_decode if T <= 8 else cuda_attn.flash_prefill
        wide = _on(_alibi_inputs(T, 4, 2, 64, 256), cuda_device)
        t = _on(_alibi_inputs(T, 4, 2, 64, 128), cuda_device)
        roped = {n: a for n, a in _on(_rope_none(_alibi_inputs(T, 4, 2, 64, 128)),
                                      cuda_device).items() if n in ("q_rot", "cos", "sin")}
        for bad in (dict(wide), dict(t, softcap=50.0), dict(t, cell_pos=None),
                    dict(t, tok_pos=t["tok_pos"].double()),
                    dict(t, cell_pos=t["cell_pos"][:32]),
                    dict(t, alibi_slopes=t["alibi_slopes"][:2]), dict(t, **roped),
                    dict(t, cos=roped["cos"])):
            with pytest.raises(ValueError):
                fn(**bad, scale=0.1)
    assert cuda_attn.LAUNCHES == launched


@pytest.mark.parametrize("H,Hkv,D,q_dtype", [(8, 2, 264, torch.bfloat16),   # past 256
                                              (8, 2, 100, torch.bfloat16),   # not a multiple of 8
                                              (8, 2, 128, torch.float32)])   # f32 queries
def test_flash_prefill_refuses_what_it_cannot_take(cuda_device, H, Hkv, D, q_dtype):
    """K4 and K4q raise on a CUDA input outside their admitted set; nothing
    falls back to attn_plain. (G = 3 and D = 64, and then D = 136, were
    refused here until the kernels took them: DIM_CASES and WIDE_CASES hold
    them now.)"""
    T, S = 16, 64
    g = torch.Generator().manual_seed(0)
    mk = (lambda *shape, dt=torch.bfloat16: torch.randn(shape, generator=g).to(dt).to(cuda_device))
    q = mk(T, H, D, dt=q_dtype)
    args = dict(q=q, q_rot=q.clone(), cos=mk(S, D), sin=mk(S, D),
                bias=torch.zeros((T, S), device=cuda_device))
    k, v = mk(Hkv, S, D), mk(Hkv, S, D)
    launched = dict(cuda_attn.LAUNCHES)
    for kk, vv in ((k, v), (_q8(k), _q8(v))):
        with pytest.raises(ValueError):
            cuda_attn.flash_prefill(**args, k=kk, v=vv, scale=0.1)
    assert cuda_attn.LAUNCHES == launched


def test_cuda_tensors_never_take_the_plain_path(cuda_device):
    """A CUDA tensor whose kernel cannot take it raises; nothing falls back."""
    x, qt = _planes("i8", 0, 32, False, 128, 64, 3, torch.float32)
    with pytest.raises(ValueError):
        qmatmul.qmm(x.to(cuda_device), qt.to(cuda_device), dtype=torch.float32)
    t = {n: a.to(cuda_device) for n, a in _attn_inputs(1, 4, 2, 64, ROPE_TYPE_NORM).items()}
    t["q"] = t["q"].float()
    with pytest.raises(ValueError):
        cuda_attn.flash_decode(**t, scale=0.1)
    # q8 pairs: int8 planes and [Hkv, S, 1] bf16 scales, nothing else
    t = {n: a.to(cuda_device) for n, a in _attn_inputs(1, 4, 2, 64, ROPE_TYPE_NORM).items()}
    kq, ks = _q8(t["k"])
    vq, vs = _q8(t["v"])
    for bad_k, bad_v in (((kq, ks.float()), (vq, vs)),                  # f32 scales
                         ((kq.float(), ks), (vq, vs)),                  # f32 "int8" plane
                         ((kq, ks.expand(2, 64, 2).contiguous()), (vq, vs)),  # group scales
                         ((kq, ks), vq)):                               # not a pair
        for fn in (cuda_attn.flash_decode, cuda_attn.flash_prefill):
            with pytest.raises(ValueError):
                fn(**{**t, "k": bad_k, "v": bad_v}, scale=0.1)


@pytest.mark.parametrize("scales_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("gs", [32, 16, 256])
@pytest.mark.parametrize("zp,mins,N,K", [(0, True, 256, 512), (8, False, 264, 512),
                                         (0, True, 1000, 1024), (0, False, 512, 256),
                                         (0, True, 1024, 4096), (4, False, 1024, 4096)])
def test_gdot_kernel_matches_plain(cuda_device, zp, mins, N, K, gs, B, scales_dtype):
    """K5 against qmm_gdot_plain (bf16): Q4_K with mins, Q4_0 with zero
    point 8 and N not a multiple of 16, a ragged N tile, no correction,
    and LLAMA3_8B's attn_k (4 N tiles, a K split no other case takes) with
    mins and with Q3_K's zero point 4; at group size 32, 16 (Q2_K,
    Q3_K: K5_gs16) and 256 (TQ1_0, TQ2_0: K5_gs256, whose CTAs take whole
    groups, so the cluster splits K in pairs of stages)."""
    x, qt = _planes("p4", zp, gs, mins, N, K, B, scales_dtype)
    kern = cuda_qmm.kernel_name("K5", qt)
    launched = cuda_qmm.LAUNCHES[kern]
    got = qmatmul.qmm(x.to(cuda_device), qt.to(cuda_device), gdot=True).cpu()
    want = qmm_gdot_plain(x, qt, torch.bfloat16)
    assert cuda_qmm.LAUNCHES[kern] == launched + 1
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


# K5 on the decode GEMV's CTA (csrc/qmm_decode.cuh, GDOT) at the main path's
# p4 decode shapes
K5_MAIN = [(4096, 6144), (4096, 4096), (4096, 1024), (4096, 28672), (14336, 4096)]


@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("K,N", K5_MAIN, ids=[f"{k}x{n}" for k, n in K5_MAIN])
def test_k5_main_shapes_match_plain(cuda_device, K, N, B):
    """One launch of K5's decode kernel a call, writing f32 or bf16 itself
    (chip_smoke.py's decode profiles show no memset and no cast), within
    1e-3 of max|y| of qmm_gdot_plain; the bf16 y is the f32 one rounded."""
    x, qt = _device_planes(cuda_device, "Q4_K", K, N, B)
    launched = cuda_qmm.LAUNCHES["K5"]
    y = cuda_qmm.qmm_cuda(x, qt, gdot=True)
    y16 = cuda_qmm.qmm_cuda(x, qt, gdot=True, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_qmm.LAUNCHES["K5"] == launched + 2
    want = qmm_gdot_plain(x, qt, torch.bfloat16)
    assert y.dtype == torch.float32 and y16.dtype == torch.bfloat16
    assert (y - want).abs().max() <= 1e-3 * want.abs().max()
    assert torch.equal(y16, y.to(torch.bfloat16))


@pytest.mark.parametrize("cluster", [1, 2, 5, 16])
@pytest.mark.parametrize("K,N,B,zp", [(4096, 1024, 1, 0), (4096, 512, 16, 8), (4096, 1000, 9, 0)])
def test_k5_is_bit_identical_from_launch_to_launch(cuda_device, K, N, B, zp, cluster):
    """No atomics: two launches of K5 give the same bits at every cluster
    size (a ragged N among them), each within 1e-3 of max|y| of
    qmm_gdot_plain."""
    x, qt = _planes("p4", zp, 32, zp == 0, N, K, B, torch.bfloat16)
    xd, qd = x.to(cuda_device), qt.to(cuda_device)
    y1 = cuda_qmm._qmm_launch(xd, qd, True, cluster)
    y2 = cuda_qmm._qmm_launch(xd, qd, True, cluster)
    want = qmm_gdot_plain(x, qt, torch.bfloat16)
    assert torch.equal(y1, y2)
    assert (y1.cpu() - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("K,N,zp", [(4096, 1024, 0), (1024, 512, 8), (14336, 256, 0)])
def test_k7_k5_variant_equals_k5_bit_for_bit(cuda_device, K, N, zp, B):
    """K7's K5 variant is K5's kernel on the layer the index names: the same
    bits as K5 on that layer's own copy."""
    layers = [_planes("p4", zp, 32, zp == 0, N, K, B, torch.bfloat16, seed=il)[1]
              for il in range(3)]
    st = (lambda ts: torch.stack(ts))
    one = layers[0]
    qt = QTensor(st([q.qs for q in layers]), st([q.scales for q in layers]),
                 None if one.mins is None else st([q.mins for q in layers]), 32, one.ggml_type,
                 "p4", zp).to(cuda_device)
    x = _planes("p4", zp, 32, zp == 0, N, K, B, torch.bfloat16, seed=7)[0].to(cuda_device)
    lids = torch.arange(3, dtype=torch.int32, device=cuda_device)
    for il in range(3):
        got = cuda_qmm.qmm_stacked_cuda(x, StackedWeight(qt, lids[il:il + 1]), gdot=True)
        assert torch.equal(got, cuda_qmm.qmm_cuda(x, layers[il].to(cuda_device), gdot=True))


def _chain_planes(rng, k, n, qtype, scales_dtype):
    """Chain phase planes: p4k (Q4_K), p4q2 (Q2_K: gs 16, codes 0..3,
    mins), p4q3 (Q3_K: gs 16, zero point 4, no mins), p4t (TQ2_0: gs 256,
    trits at zero point 1), i8g16 (Q6_K-like), i8g32, i8g8 (IQ1_M-like:
    gs 8, values -9..9)."""
    to = (lambda a: torch.from_numpy(a).to(scales_dtype))
    if qtype == "p4t":
        qs = pack_p4_kmajor(rng.integers(-1, 2, size=(k, n)), 1)
        scales = ((rng.random((k // 256, n)) + 0.5) * (4.0 / np.sqrt(k))).astype(np.float32)
        return QTensor(torch.from_numpy(qs), to(scales), None, 256, GGMLType.TQ2_0, "p4", 1)
    if qtype == "i8g8":
        qs = rng.integers(-9, 10, size=(k, n)).astype(np.int8)
        scales = ((rng.random((k // 8, n)) + 0.5) * (2.0 / np.sqrt(k) / 8)).astype(np.float32)
        return QTensor(torch.from_numpy(qs), to(scales), None, 8, GGMLType.IQ1_M, "i8", 0)
    if qtype == "p4k":
        qs = pack_p4_kmajor(rng.integers(0, 16, size=(k, n)), 0)
        gs, layout, zp = 32, "p4", 0
    elif qtype in ("p4q2", "p4q3"):
        zp = 4 if qtype == "p4q3" else 0
        qs = pack_p4_kmajor(rng.integers(-zp, (8 if zp else 4) - zp, size=(k, n)), zp)
        gs, layout = 16, "p4"
        scales = ((rng.random((k // gs, n)) + 0.5) * (2.0 / np.sqrt(k) / 8)).astype(np.float32)
        m = (scales * 1.5).astype(np.float32) if qtype == "p4q2" else None
        to = (lambda a: torch.from_numpy(a).to(scales_dtype))
        return QTensor(torch.from_numpy(qs), to(scales), None if m is None else to(m), gs,
                       GGMLType.Q2_K if zp == 0 else GGMLType.Q3_K, layout, zp)
    else:
        qs = rng.integers(-32, 32, size=(k, n)).astype(np.int8)
        gs, layout, zp = (16 if qtype == "i8g16" else 32), "i8", 0
    scales = ((rng.random((k // gs, n)) + 0.5) * (0.5 / np.sqrt(k) / 8)).astype(np.float32)
    m = (scales * 7.5).astype(np.float32) if layout == "p4" else None
    to = (lambda a: torch.from_numpy(a).to(scales_dtype))
    return QTensor(torch.from_numpy(qs), to(scales), None if m is None else to(m), gs,
                   GGMLType.Q4_K, layout, zp)


@pytest.mark.parametrize("scales_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 2, 5, 8])
@pytest.mark.parametrize("down", ["p4k", "i8g16"])
def test_chain_tail_kernel_matches_plain(cuda_device, down, B, scales_dtype):
    """K6's layer tail against qmm_chain_plain: Q4_K o_proj and gate+up,
    a Q4_K or Q6_K-like (int8, gs 16) down, random non-unit gamma. The
    output is bf16: a last-bit difference of an f32 sum can move a value
    across a bf16 rounding boundary of h, hn, cur or the output, one step
    of 2^-8 of it; held at 2e-2 of max|out|."""
    rng = np.random.default_rng(B)
    E, Fh = 512, 768
    wo, wgu, wd = (_chain_planes(rng, 512, E, "p4k", scales_dtype),
                   _chain_planes(rng, E, 2 * Fh, "p4k", scales_dtype),
                   _chain_planes(rng, Fh, E, down, scales_dtype))
    bf = torch.bfloat16
    att = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32)).to(bf)
    xres = torch.from_numpy(rng.normal(size=(B, E)).astype(np.float32)).to(bf)
    gamma = torch.from_numpy((rng.normal(size=E) * 0.2 + 1).astype(np.float32))
    want = cuda_qmm_chain.layer_tail(att, xres, gamma, wo, wgu, wd, eps=1e-5)
    launched = cuda_qmm_chain.LAUNCHES["K6"]
    got = cuda_qmm_chain.layer_tail(att.to(cuda_device), xres.to(cuda_device),
                                    gamma.to(cuda_device), wo.to(cuda_device),
                                    wgu.to(cuda_device), wd.to(cuda_device), eps=1e-5)
    assert cuda_qmm_chain.LAUNCHES["K6"] == launched + 1
    assert got.dtype == bf and got.shape == (B, E)
    got, want = got.cpu().float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.parametrize("B", [1, 2, 5, 8])
@pytest.mark.parametrize("down", ["p4k", "i8g16"])
def test_chain_gelu_tail_kernel_matches_plain(cuda_device, down, B):
    """K6_gelu (qmm_chain_tc_gelu: the GeGLU tail, gemma's) against
    qmm_chain_plain with the "geglu" boundary, as the SwiGLU tail is held,
    counted apart from K6; then the tail without its residual (final
    "cast": the FFN's output alone, which the activation moves by far more
    than the tolerance, where h would hide it), against the plain GeGLU
    and apart from the plain SwiGLU."""
    ws, att, xres, gamma = _tail_inputs(cuda_device, down, B, seed=B)
    cpu = [w.to("cpu") for w in ws]
    want = cuda_qmm_chain.layer_tail(att.cpu(), xres.cpu(), gamma.cpu(), *cpu, eps=1e-5,
                                     act="gelu").float()
    before = dict(cuda_qmm_chain.LAUNCHES)
    got = cuda_qmm_chain.layer_tail(att, xres, gamma, *ws, eps=1e-5, act="gelu")
    again = cuda_qmm_chain.layer_tail(att, xres, gamma, *ws, eps=1e-5, act="gelu")
    assert cuda_qmm_chain.LAUNCHES == {**before, "K6_gelu": before["K6_gelu"] + 2}
    assert torch.equal(got, again)
    got = got.cpu().float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    ffn = dict(eps=1e-5, final="cast")
    want = cuda_qmm_chain.qmm_chain_plain(att.cpu(), cpu, (gamma.cpu(),), xres.cpu(),
                                          pres=("cast", "res_norm", "geglu"), **ffn).float()
    silu = cuda_qmm_chain.qmm_chain_plain(att.cpu(), cpu, (gamma.cpu(),), xres.cpu(),
                                          pres=("cast", "res_norm", "swiglu"), **ffn).float()
    got = cuda_qmm_chain.qmm_chain_cuda(att, ws, (gamma,), xres,
                                        pres=("cast", "res_norm", "geglu"), **ffn).cpu().float()
    tol = 2e-2 * want.abs().max()
    assert (got - want).abs().max() <= tol
    assert (silu - want).abs().max() > 2 * tol  # 9-16% of max|want| on the CPU


@pytest.mark.parametrize("plan", [(4, (1, 1, 1)), (8, (4, 1, 2))], ids=["c4-unsplit", "c8"])
def test_chain_gelu_at_a_given_plan(cuda_device, plan):
    """K6_gelu at cluster sizes 4 and 8 with split phases."""
    ws, att, xres, gamma = _tail_inputs(cuda_device, "p4k", 8, seed=3)
    pres = dict(TAIL_PRES, pres=("cast", "res_norm", "geglu"))
    want = cuda_qmm_chain.qmm_chain_plain(att.cpu(), [w.to("cpu") for w in ws], (gamma.cpu(),),
                                          xres.cpu(), **pres).float()
    got = cuda_qmm_chain._chain_launch(att, ws, (gamma,), xres, plan=plan, **pres)
    assert (got.cpu().float() - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("wo,gu,down", [("p4q3", "p4q3", "p4q3"), ("p4q3", "p4q3", "p4k"),
                                        ("p4q2", "p4q2", "p4q3"), ("p4k", "p4q3", "i8g16")],
                         ids=["q3k", "q3k-q4k-down", "q2k", "q3k-gu-only"])
def test_chain_gs16_tail_matches_plain(cuda_device, wo, gu, down, B, act):
    """K6_gs16 (qmm_chain_tc_g16: phases on nibble planes at group size 16
    beside group size 32 and int8 ones, either act) against qmm_chain_plain,
    counted apart from K6 and K6_gelu, bit-identical from launch to launch."""
    rng = np.random.default_rng(B)
    E, Fh = 512, 768
    ws = [_chain_planes(rng, 512, E, wo, torch.bfloat16).to(cuda_device),
          _chain_planes(rng, E, 2 * Fh, gu, torch.bfloat16).to(cuda_device),
          _chain_planes(rng, Fh, E, down, torch.bfloat16).to(cuda_device)]
    bf = torch.bfloat16
    att = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32)).to(bf).to(cuda_device)
    xres = torch.from_numpy(rng.normal(size=(B, E)).astype(np.float32)).to(bf).to(cuda_device)
    gamma = torch.from_numpy((rng.normal(size=E) * 0.2 + 1).astype(np.float32)).to(cuda_device)
    pres = dict(TAIL_PRES, pres=("cast", "res_norm", act))
    want = cuda_qmm_chain.qmm_chain_plain(att.cpu(), [w.to("cpu") for w in ws], (gamma.cpu(),),
                                          xres.cpu(), **pres).float()
    before = dict(cuda_qmm_chain.LAUNCHES)
    got = cuda_qmm_chain.qmm_chain_cuda(att, ws, (gamma,), xres, **pres)
    again = cuda_qmm_chain.qmm_chain_cuda(att, ws, (gamma,), xres, **pres)
    assert cuda_qmm_chain.LAUNCHES == {**before, "K6_gs16": before["K6_gs16"] + 2}
    assert torch.equal(got, again)
    assert (got.cpu().float() - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("wo,gu,down,kern", [("i8g8", "i8g8", "i8g8", "K6_gs8"),
                                             ("i8g8", "i8g8", "i8g32", "K6_gs8"),
                                             ("p4t", "p4t", "p4t", "K6_gs256"),
                                             ("p4t", "p4k", "i8g16", "K6_gs256")],
                         ids=["iq1m", "iq1m-iq3-down", "tq2", "tq2-o-only"])
def test_chain_gx_tail_matches_plain(cuda_device, wo, gu, down, kern, B, act):
    """K6_gs8 (qmm_chain_tc_g8: phases on int8 planes at group size 8) and
    K6_gs256 (qmm_chain_tc_g256: nibble planes at group size 256) beside
    the other forms, either act, against qmm_chain_plain within one bf16
    step of max|out|, counted apart, bit-identical from launch to
    launch."""
    rng = np.random.default_rng(B)
    E, Fh = 512, 768
    ws = [_chain_planes(rng, 512, E, wo, torch.bfloat16).to(cuda_device),
          _chain_planes(rng, E, 2 * Fh, gu, torch.bfloat16).to(cuda_device),
          _chain_planes(rng, Fh, E, down, torch.bfloat16).to(cuda_device)]
    bf = torch.bfloat16
    att = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32)).to(bf).to(cuda_device)
    xres = torch.from_numpy(rng.normal(size=(B, E)).astype(np.float32)).to(bf).to(cuda_device)
    gamma = torch.from_numpy((rng.normal(size=E) * 0.2 + 1).astype(np.float32)).to(cuda_device)
    pres = dict(TAIL_PRES, pres=("cast", "res_norm", act))
    want = cuda_qmm_chain.qmm_chain_plain(att.cpu(), [w.to("cpu") for w in ws], (gamma.cpu(),),
                                          xres.cpu(), **pres).float()
    before = dict(cuda_qmm_chain.LAUNCHES)
    got = cuda_qmm_chain.qmm_chain_cuda(att, ws, (gamma,), xres, **pres)
    again = cuda_qmm_chain.qmm_chain_cuda(att, ws, (gamma,), xres, **pres)
    assert cuda_qmm_chain.LAUNCHES == {**before, kern: before[kern] + 2}
    assert torch.equal(got, again)
    assert (got.cpu().float() - want).abs().max() <= 2 ** -8 * want.abs().max()


def test_chain_refuses_mixed_group_size_forms():
    """No kernel takes gs-16 nibble phases beside gs-8 int8 ones: the gate
    says no on both devices, so the caller runs the unfused path."""
    rng = np.random.default_rng(0)
    ws = [_chain_planes(rng, 512, 512, "p4q3", torch.bfloat16),
          _chain_planes(rng, 512, 1536, "i8g8", torch.bfloat16),
          _chain_planes(rng, 768, 512, "i8g8", torch.bfloat16)]
    assert cuda_qmm_chain.chain_kernel(ws) is None and not cuda_qmm_chain.chain_fits(ws)
    assert cuda_qmm_chain.chain_kernel(ws[1:]) == "K6_gs8"


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("qtype,N", [("p4k", 768), ("p4q3", 768), ("p4q2", 640),
                                     ("i8g16", 1280), ("i8g32", 384), ("p4t", 3840),
                                     ("i8g8", 640)])
def test_chain_norm_mm_kernel_matches_plain(cuda_device, qtype, N, B, out_dtype):
    """K6's norm + matmul (a head, an lm_head) against the plain version."""
    rng = np.random.default_rng(N + B)
    K = 512
    w = _chain_planes(rng, K, N, qtype, torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(torch.bfloat16)
    gamma = torch.from_numpy((rng.normal(size=K) * 0.2 + 1).astype(np.float32))
    want = cuda_qmm_chain.norm_mm(x, gamma, w, eps=1e-5, out_dtype=out_dtype).float()
    got = cuda_qmm_chain.norm_mm(x.to(cuda_device), gamma.to(cuda_device), w.to(cuda_device),
                                 eps=1e-5, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    got = got.cpu().float()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


def _tail_inputs(dev, down, B, seed=0):
    rng = np.random.default_rng(seed)
    E, Fh = 512, 768
    ws = (_chain_planes(rng, 512, E, "p4k", torch.bfloat16),
          _chain_planes(rng, E, 2 * Fh, "p4k", torch.bfloat16),
          _chain_planes(rng, Fh, E, down, torch.bfloat16))
    bf = torch.bfloat16
    att = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32)).to(bf)
    xres = torch.from_numpy(rng.normal(size=(B, E)).astype(np.float32)).to(bf)
    gamma = torch.from_numpy((rng.normal(size=E) * 0.2 + 1).astype(np.float32))
    return [w.to(dev) for w in ws], att.to(dev), xres.to(dev), gamma.to(dev)


TAIL_PRES = dict(pres=("cast", "res_norm", "swiglu"), eps=1e-5, final="add_res")


@pytest.mark.parametrize("plan", [(4, (1, 1, 1)), (4, (4, 2, 2)), (6, (2, 2, 6)),
                                  (8, (4, 1, 2)), (8, (2, 4, 1))],
                         ids=["c4-unsplit", "c4", "c6", "c8", "c8-b"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("down", ["p4k", "i8g16"])
def test_chain_is_bit_identical_at_every_plan(cuda_device, down, B, plan):
    """K6 at cluster sizes 4, 6 and 8 and splits of one or several CTAs a
    tile: within 2e-2 of max|out| of qmm_chain_plain, and two launches give
    the same bits (no atomics, no memset), one launch a chain."""
    ws, att, xres, gamma = _tail_inputs(cuda_device, down, B)
    want = cuda_qmm_chain.qmm_chain_plain(att.cpu(), [w.to("cpu") for w in ws], (gamma.cpu(),),
                                          xres.cpu(), **TAIL_PRES).float()
    run = (lambda: cuda_qmm_chain._chain_launch(att, ws, (gamma,), xres, plan=plan,
                                                **TAIL_PRES))
    launched = cuda_qmm_chain.LAUNCHES["K6"]
    got, again = run(), run()
    assert cuda_qmm_chain.LAUNCHES["K6"] == launched + 2
    assert torch.equal(got, again)
    assert (got.cpu().float() - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.parametrize("plan", [(8, (8,)), (8, (1,)), (4, (4,)), (6, (2,))],
                         ids=["c8-split8", "c8-unsplit", "c4", "c6"])
@pytest.mark.parametrize("B", [1, 8])
def test_norm_mm_over_several_rounds(cuda_device, B, plan):
    """A head whose 33 column tiles outnumber the groups of one round at
    cluster size 8 and split 8 (a CTA takes a second item, its running
    stage count carries the ring's parities on): within 2e-2 of max|out|
    of qmm_chain_plain, bit-identical from launch to launch."""
    rng = np.random.default_rng(B)
    K, N = 1024, 33 * 128
    w = _chain_planes(rng, K, N, "p4k", torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(torch.bfloat16)
    gamma = torch.from_numpy((rng.normal(size=K) * 0.2 + 1).astype(np.float32))
    kw = dict(pres=("norm",), eps=1e-5, final="cast", out_dtype=torch.bfloat16)
    want = cuda_qmm_chain.qmm_chain_plain(x, [w], (gamma,), **kw).float()
    wd = w.to(cuda_device)
    run = (lambda: cuda_qmm_chain._chain_launch(x.to(cuda_device), [wd],
                                                (gamma.to(cuda_device),), plan=plan, **kw))
    got = run()
    assert torch.equal(got, run())
    assert (got.cpu().float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_k5_k6_raise_rather_than_fall_back(cuda_device):
    """K5 and K6 launch or raise: shapes outside their gates, non-bf16
    compute and too many rows never take a plain path on the card."""
    rng = np.random.default_rng(0)
    x, qt = _planes("p4", 0, 32, True, 256, 512, 17, torch.float32)
    with pytest.raises(ValueError):  # B > 16
        cuda_qmm.qmm_cuda(x.to(cuda_device), qt.to(cuda_device), gdot=True)
    x, qt = _planes("i8", 0, 32, False, 256, 512, 2, torch.float32)
    with pytest.raises(ValueError):  # int8 planes
        cuda_qmm.qmm_cuda(x.to(cuda_device), qt.to(cuda_device), gdot=True)
    w = _chain_planes(rng, 512, 384, "p4k", torch.bfloat16).to(cuda_device)
    g = torch.ones(512, device=cuda_device)
    xs = torch.ones((9, 512), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):  # B > 8
        cuda_qmm_chain.norm_mm(xs, g, w, eps=1e-5)
    with pytest.raises(ValueError):  # f32 compute
        cuda_qmm_chain.norm_mm(xs[:2], g, w, eps=1e-5, compute_dtype=torch.float32)
    w96 = _chain_planes(rng, 512, 96 * 4, "i8g32", torch.bfloat16).to(cuda_device)
    w96.qs, w96.scales = w96.qs[:, :96].contiguous(), w96.scales[:, :96].contiguous()
    assert cuda_qmm_chain.norm_mm(xs[:2], g, w96, eps=1e-5) is None  # the gate, both devices


def _stacked(layout, zp, gs, mins, N, K, B, scales_dtype, L=3):
    """L different layers of _planes, stacked into [L, ...] planes."""
    layers = [_planes(layout, zp, gs, mins, N, K, B, scales_dtype, seed=il)[1]
              for il in range(L)]
    st = (lambda ts: torch.stack(ts))
    qt = QTensor(st([q.qs for q in layers]), st([q.scales for q in layers]),
                 None if not mins else st([q.mins for q in layers]), gs, GGMLType.Q4_K,
                 layout, zp)
    return _planes(layout, zp, gs, mins, N, K, B, scales_dtype, seed=L)[0], qt


K7_PLANES = [  # layout, zp, gs, mins, N, K
    ("p4", 0, 32, True, 256, 512),     # Q4_K
    ("p4", 8, 32, False, 264, 512),    # Q4_0, N not a multiple of 16
    ("p4", 0, 32, True, 1000, 1024),   # ragged N tile
    ("p4", 0, 16, True, 256, 512),     # Q2_K
    ("p4", 4, 16, False, 264, 512),    # Q3_K, N not a multiple of 16
    ("i8", 0, 16, False, 256, 512),    # Q6_K
    ("i8", 0, 32, False, 200, 64),     # Q8_0, short K, ragged N
    ("p4", 1, 256, False, 256, 512),   # TQ2_0
    ("p4", 1, 256, False, 264, 1024),  # TQ2_0, N not a multiple of 16
    ("i8", 0, 8, False, 256, 512),     # IQ1_M
    ("i8", 0, 8, False, 200, 320),     # IQ1_M, ragged N
]
# stacked K1/K2 at decode and prefill rows; stacked K5 where its gate admits
K7_CASES = ([(*p, B, False) for p in K7_PLANES for B in (1, 3, 8, 17, 40, 129, 300)]
            + [(*p, B, True) for p in K7_PLANES if p[0] == "p4" for B in (1, 3, 8, 16)])


@pytest.mark.parametrize("layout,zp,gs,mins,N,K,B,gdot", K7_CASES)
def test_k7_matches_plain_and_unstacked(cuda_device, layout, zp, gs, mins, N, K, B, gdot):
    """K7 on every layer of a 3-layer stack whose layers differ: against
    its plain version, and against K1/K2/K5 launched on that layer's own
    copy (the same arithmetic; f32 atomics may add a split K in another
    order, a few ulps of max|y|)."""
    x, qt = _stacked(layout, zp, gs, mins, N, K, B, torch.bfloat16)
    xd, qd = x.to(cuda_device), qt.to(cuda_device)
    lids = torch.arange(3, dtype=torch.int32, device=cuda_device)
    kern = cuda_qmm.kernel_name("K7", qt.map(lambda t: t[0]))
    for il in range(3):
        sw = StackedWeight(qd, lids[il:il + 1])
        launched = cuda_qmm.LAUNCHES[kern]
        got = qmatmul.qmm(xd, sw, gdot=gdot)
        assert cuda_qmm.LAUNCHES[kern] == launched + 1
        want = qmm_stacked_plain(x, StackedWeight(qt, torch.tensor([il], dtype=torch.int32)),
                                 torch.bfloat16, gdot=gdot)
        assert (got.cpu() - want).abs().max() <= 1e-3 * want.abs().max()
        one = cuda_qmm.qmm_cuda(xd, qd.map(lambda t: t[il].contiguous()), gdot=gdot)
        assert (got - one).abs().max() <= 4e-6 * one.abs().max()


def test_k7_raises_on_misaligned_layers(cuda_device):
    """Layers whose planes would not start 16-byte aligned (bf16 scales of
    one group row at N = 132: 264 bytes a layer) are refused, not read."""
    x, qt = _stacked("i8", 0, 32, False, 132, 32, 1, torch.bfloat16)
    sw = StackedWeight(qt.to(cuda_device), torch.zeros(1, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        qmatmul.qmm(x.to(cuda_device), sw)
    x, qt = _stacked("p4", 0, 32, True, 256, 512, 1, torch.bfloat16)
    sw = StackedWeight(qt.to(cuda_device), torch.zeros(1, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):  # the index must be int32 on the card
        qmatmul.qmm(x.to(cuda_device), sw)


@pytest.mark.parametrize("mode", ["qs", "dma", "deq"])
@pytest.mark.parametrize("B", [1, 2, 4, 5, 8, 16])
@pytest.mark.parametrize("zp,mins,N,K", [(0, True, 256, 512), (8, False, 264, 512),
                                         (0, True, 1000, 1024), (0, True, 512, 4096)])
def test_probe_kernels_match_plain(cuda_device, zp, mins, N, K, B, mode):
    """S1 against probe_plain, row by row (cuda_probe.tolerance): the packed
    bytes' sums are integers below 2^24 (exact in f32 in any order); the
    scales and mins, the dequantized weights and x are f32 sums in another
    order, each held at 1e-5 of its own row's sum of magnitudes."""
    x, qt = _planes("p4", zp, 32, mins, N, K, B, torch.bfloat16)
    launched = cuda_probe.LAUNCHES["S1"]
    got = cuda_probe.probe(mode, x.to(cuda_device), qt.to(cuda_device)).cpu()
    assert cuda_probe.LAUNCHES["S1"] == launched + 1
    want = cuda_probe.probe_plain(mode, x, qt)
    assert got.shape == want.shape == (3, N)
    assert ((got - want).abs().amax(1, keepdim=True) <= cuda_probe.tolerance(mode, x, qt)).all()


def _s3_stack(variant, T, H, Hkv, S, mode, NB=3):
    """_attn_inputs with K/V stacks of NB different caches, in the variant's
    layout: [NB, Hkv, S, D] for v1, [NB, S, Hkv, D] for v0."""
    t = _attn_inputs(T, H, Hkv, S, mode)
    g = torch.Generator().manual_seed(S + NB)
    for n in ("k", "v"):
        st = torch.randn((NB, Hkv, S, 128), generator=g).to(torch.bfloat16)
        t[n] = st if variant == "v1" else st.transpose(1, 2).contiguous()
    return t


@pytest.mark.parametrize("split", [None, 64, 100, 1000])
@pytest.mark.parametrize("T,H,Hkv,S", [(1, 32, 8, 1000), (3, 8, 2, 333), (8, 32, 8, 512)])
@pytest.mark.parametrize("variant", ["v1", "v0"])
def test_s3_stacked_kernels_match_plain(cuda_device, variant, T, H, Hkv, S, split):
    """S3's v1 / v0 against probe_plain on the first and last buffer of a
    stack, at ragged S, G in {4}, a padding row (row 0), several split
    sizes; the two buffers' outputs differ (the device-side index is read)."""
    t = _s3_stack(variant, T, H, Hkv, S, ROPE_TYPE_NORM)
    dev = {n: a.to(cuda_device) for n, a in t.items()}
    outs = []
    for i in (0, 2):
        lidx = torch.tensor([i], dtype=torch.int32)
        launched = cuda_attn_probe.LAUNCHES["S3"]
        got = cuda_attn_probe.probe(variant, **dev, scale=128 ** -0.5,
                                    lidx=lidx.to(cuda_device), split=split).cpu()
        assert cuda_attn_probe.LAUNCHES["S3"] == launched + 1
        want = cuda_attn_probe.probe_plain(variant, **t, scale=128 ** -0.5, lidx=lidx)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= cuda_attn_probe.tolerance(variant, want)
        outs.append(got)
    assert (outs[0] - outs[1]).abs().max() > 1e-2


@pytest.mark.parametrize("variant", ["noscale", "full", "bf16"])
@pytest.mark.parametrize("T,H,Hkv,S", [(1, 32, 8, 1000), (2, 8, 8, 64), (5, 8, 2, 333),
                                       (8, 4, 4, 4001)])
def test_s3_q8_kernels_match_plain(cuda_device, variant, T, H, Hkv, S):
    """S3's q8 modes against probe_plain on the same (int8, scales) pairs;
    bf16 is K3q's dequant, and its output (the split-S body of
    flash_decode.cuh) is within
    K3q's atol = rtol = 1e-3 of K3q's."""
    t = _attn_inputs(T, H, Hkv, S, ROPE_TYPE_NEOX)
    t["k"], t["v"] = _q8(t["k"]), _q8(t["v"])
    dev = {n: (tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
               else a.to(cuda_device)) for n, a in t.items()}
    launched = cuda_attn_probe.LAUNCHES["S3"]
    got = cuda_attn_probe.probe(variant, **dev, scale=128 ** -0.5)
    assert cuda_attn_probe.LAUNCHES["S3"] == launched + 1
    want = cuda_attn_probe.probe_plain(variant, **t, scale=128 ** -0.5)
    assert torch.isfinite(got).all()
    assert (got.cpu() - want).abs().max() <= cuda_attn_probe.tolerance(variant, want)
    if variant == "bf16":
        torch.testing.assert_close(got, cuda_attn.flash_decode(**dev, scale=128 ** -0.5),
                                   atol=1e-3, rtol=1e-3)


def test_s3_raises_rather_than_fall_back(cuda_device):
    """An index that is not an int32 on the card, a stack of the wrong rank
    or a split of 0 cells is refused."""
    t = {n: a.to(cuda_device) for n, a in _s3_stack("v1", 1, 8, 2, 64, ROPE_TYPE_NORM).items()}
    good = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for lidx in (good.long(), good.cpu(), None, torch.zeros(2, dtype=torch.int32,
                                                            device=cuda_device)):
        with pytest.raises(ValueError):
            cuda_attn_probe.probe_cuda("v1", **t, scale=0.1, lidx=lidx)
    with pytest.raises(ValueError):
        cuda_attn_probe.probe_cuda("v1", **{**t, "k": t["k"][0], "v": t["v"][0]}, scale=0.1,
                                   lidx=good)
    with pytest.raises(ValueError):
        cuda_attn_probe.probe_cuda("v1", **t, scale=0.1, lidx=good, split=0)
