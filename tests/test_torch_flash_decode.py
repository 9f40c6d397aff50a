"""K3/K3q's arithmetic (csrc/flash_attn.cu, the Hopper flash decode),
written out in plain torch in the order the kernel uses, and the grid
ops/cuda_attn.py::decode_attn_plan picks for it.

The kernel forms k*cos and k*sin (exact products of bf16 values), splits
each into bf16 hi = bf16(k*c) and lo = k*c - hi (exact), and sums the
scores [kc_hi | ks_hi] . [q | q_rot] + [kc_lo | ks_lo] . [q | q_rot] in
f32. A KV head's cells are split over the CTAs of a cluster (blocks of 64
cells, `per` blocks a rank) and each block over 4 warps of 16 cells. Each
warp keeps its own online softmax in log2 units (m from -1e30 log2 e, l
from 0, cells past S left out), rounds p to P_hi = bf16(p) and P_lo =
bf16(p - P_hi), adds V.P_hi + V.P_lo to its f32 accumulator; l sums the
f32 p. The CTA combines its warps in warp order, then the cluster its ranks
in rank order. Held here, on seeded numpy inputs with T in {1, 3, 8}, G in
{1, 2, 4, 8}, ragged S (64, 200, 333, 4001), a padding row that sees no
cell, NORM and NEOX rope, the bf16 cache and q8_0 pairs:
  * against cuda_attn.attn_plain, the function the card's checks hold the
    kernel to (atol = rtol = 1e-3 there), at 1e-5 of max|y|;
  * against llm_tpu's flash_decode in interpret mode at test_pallas_attn's
    5e-3 on the bf16 cache, and at 2e-2 on the q8_0 pairs against both of
    its oracles (test_torch_attn.py's: the TPU's q8 kernel with the f32
    product q*s, and its dense kernel on the values rounded to bf16);
  * one bf16 rounding of k*cos and k*sin and of p misses the card's
    atol = rtol = 1e-3 at T=1 S=64 H=32 Hkv=8 (chip_smoke.py's inputs at
    that shape), where the split stays far inside it: the reason for the
    split.
The plan: every cell of every KV head is read by exactly one CTA, the
cluster is at most 8, no CTA is left without a block, and the row chunks
cover every row, at every shape here and at LLAMA3_8B on 132 SMs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.ops import pallas_attn as jax_attn

from llm_tpu_torch.device import full_f32
from llm_tpu_torch.models.transformer import quantize_rows
from llm_tpu_torch.ops import cuda_attn
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORM, RopeParams, rope_angles
from llm_tpu_torch.tools import attn_splits
from llm_tpu_torch.tools.kbench_attn import attn_inputs

NEG = -1e30
LOG2E = 1.4426950408889634
BLOCK = cuda_attn.DECODE_BLOCK  # cells a stage
WARPS, WARP_CELLS = 4, 16  # csrc/flash_attn.cu's DA_WARPS, DA_CELLS
D = 128
PLAIN_REL_TOL = 1e-5
PALLAS_TOL = dict(atol=5e-3, rtol=5e-3)
PALLAS_Q8_TOL = dict(atol=2e-2, rtol=2e-2)
CARD_TOL = dict(atol=1e-3, rtol=1e-3)  # chip_smoke.py::check_attn, test_torch_cuda.py
N_SM = 132  # H100 SXM


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's many small torch ops: beside
    the suite's other workers, more threads spend their time waiting on
    each other (a case that takes 0.2 s alone took 30-70 s so). The
    worker's setting comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, as the kernel's bf16x2 products and
    cvt.rn round), as f32."""
    return x.to(torch.bfloat16).float()


def kernel_order(q, q_rot, k, v, cos, sin, bias, scale, cluster=None, split_k=True,
                 split_p=True):
    """K3/K3q's arithmetic with `cluster` CTAs a KV head (None: the plan's
    on N_SM SMs). split_k=False rounds k*cos and k*sin to bf16 once;
    split_p=False rounds p to bf16 once. Returns [T, H, D] f32."""
    T, H, _ = q.shape
    kf = cuda_attn.dequant_bf16(k)
    vf = cuda_attn.dequant_bf16(v)
    Hkv, S, Dv = vf.shape
    G = H // Hkv
    kc = kf * cos.float()[None]  # exact: 8 x 8 significant bits
    ks = kf * sin.float()[None]
    if split_k:
        planes = (_bf(kc), _bf(ks), kc - _bf(kc), ks - _bf(ks))
        if torch.equal(_bf(kf), kf):  # bf16 k (not the f32 oracle's q*s): lo is exact
            assert all(torch.equal(_bf(p), p) for p in planes)
    else:
        planes = (_bf(kc), _bf(ks))
    rows = (lambda x: x.float().reshape(T, Hkv, G, -1).permute(1, 0, 2, 3)
            .reshape(Hkv, T * G, -1))
    qh, qrh = rows(q), rows(q_rot)
    lhs = (qh, qrh, qh, qrh)
    brow = torch.clamp(bias.float(), min=NEG).repeat_interleave(G, dim=0) * LOG2E  # t*G + g
    scale2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    nblk = -(-S // BLOCK)
    if cluster is None:
        cluster = cuda_attn.decode_attn_plan(T, H, Hkv, S, N_SM)[0]
    per = -(-nblk // cluster)
    R = T * G

    def combine(ms, ls, os_):
        """States in order -> one: max, then the sums scaled by 2^(m - M)."""
        M = ms[0]
        for m in ms[1:]:
            M = torch.maximum(M, m)
        L, O = torch.zeros_like(ls[0]), torch.zeros_like(os_[0])
        for m, l, o in zip(ms, ls, os_):
            e = torch.exp2(m - M)
            L = L + l * e
            O = O + o * e
        return M, L, O

    ranks = []
    with full_f32():
        for rank in range(cluster):
            b0 = min(nblk, rank * per)
            b1 = min(nblk, b0 + per)
            warps = []
            for w in range(WARPS):
                m = torch.full((Hkv, R, 1), NEG) * LOG2E
                l = torch.zeros((Hkv, R, 1))
                o = torch.zeros((Hkv, R, Dv))
                for blk in range(b0, b1):
                    c0 = blk * BLOCK + w * WARP_CELLS
                    c1 = min(S, c0 + WARP_CELLS)  # cells past S: left out
                    if c0 >= c1:
                        continue
                    sc = sum(torch.einsum("hrd,hsd->hrs", a, p[:, c0:c1])
                             for a, p in zip(lhs, planes))
                    s = sc * scale2 + brow[None, :, c0:c1]
                    mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                    alpha = torch.exp2(m - mn)
                    p = torch.exp2(s - mn)
                    l = l * alpha + p.sum(dim=-1, keepdim=True)
                    ph = _bf(p)
                    vb = vf[:, c0:c1]
                    pv = ph @ vb
                    if split_p:
                        pv = pv + _bf(p - ph) @ vb
                    o = o * alpha + pv
                    m = mn
                warps.append((m, l, o))
            ranks.append(combine(*zip(*warps)))
        _, L, O = combine(*zip(*ranks))
    out = O / torch.clamp(L, min=1e-30)
    return out.reshape(Hkv, T, G, Dv).permute(1, 0, 2, 3).reshape(T, H, Dv)


def _inputs(T, H, Hkv, S, mode, seed=0, q8=False):
    """Seeded numpy inputs rounded to bf16 (the kernel's input types); row 0
    is a padding row that sees no cell, the last quarter of the cells is
    empty."""
    rng = np.random.default_rng(seed)
    bf = (lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16))
    q = bf(rng.normal(size=(T, H, D)))
    k = bf(rng.normal(size=(Hkv, S, D)))
    v = bf(rng.normal(size=(Hkv, S, D)))
    pos = rng.permutation(S).astype(np.int32)
    c, s = rope_angles(torch.from_numpy(pos), RopeParams(n_dims=D, mode=mode,
                                                         freq_base=10000.0))
    cos, sin = (x.to(torch.bfloat16).contiguous()
                for x in cuda_attn.expand_tables(c, s, mode, D))
    tok_pos = np.sort(rng.integers(S // 4, S, size=T))
    allowed = (pos[None, :] <= tok_pos[:, None]) & (np.arange(S) < S - S // 4)[None]
    allowed[0] = False
    bias = torch.from_numpy(np.where(allowed, 0.0, -np.inf).astype(np.float32))
    t = dict(q=q, q_rot=cuda_attn.rope_companion(q, mode).contiguous(), k=k, v=v, cos=cos,
             sin=sin, bias=bias)
    if q8:
        t["k"], t["v"] = quantize_rows(k, 1), quantize_rows(v, 1)
    return t


def _jax_args(t, oracle="kernel_q8"):
    """The same inputs for llm_tpu's flash_decode: f32 arrays; q8_0 pairs as
    (int8, f32 scales) for its q8 kernel, or (oracle "bf16") dequantized and
    rounded to bf16 as the TPU kernel's values, for its dense kernel."""
    f32 = (lambda x: jnp.asarray(x.float().numpy()))

    def cv(x):
        if not isinstance(x, tuple):
            return f32(x)
        if oracle == "bf16":
            return f32(cuda_attn.dequant_bf16(x))
        return jnp.asarray(x[0].numpy()), f32(x[1])

    return {n: cv(x) for n, x in t.items()}


def _f32_product(kv):
    return kv[0].float() * kv[1].float() if isinstance(kv, tuple) else kv.float()


# name, T, H, Hkv, S: T*G of 1..64 rows (64: two row chunks), S ragged
CASES = [
    ("t1-g1-s64", 1, 4, 4, 64),
    ("t3-g2-s200", 3, 8, 4, 200),
    ("t8-g4-s333", 8, 8, 2, 333),
    ("t8-g8-s200", 8, 16, 2, 200),
    ("t1-g4-s4001", 1, 8, 2, 4001),
]
MODES = pytest.mark.parametrize("mode", [ROPE_TYPE_NORM, ROPE_TYPE_NEOX], ids=["norm", "neox"])
KV = pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@KV
@MODES
@pytest.mark.parametrize("name,T,H,Hkv,S", CASES, ids=[c[0] for c in CASES])
def test_kernel_order_matches_plain(name, T, H, Hkv, S, mode, q8):
    t = _inputs(T, H, Hkv, S, mode, q8=q8)
    scale = D ** -0.5
    got = kernel_order(**t, scale=scale)
    want = cuda_attn.attn_plain(**t, scale=scale)
    assert got.shape == want.shape == (T, H, D)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= PLAIN_REL_TOL
    # the padding row (token 0) averages V over exactly S cells, as attn_plain
    assert torch.allclose(got[0], want[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("cluster", [1, 2, 3, 5])
def test_kernel_order_is_the_same_function_at_any_cluster(cluster):
    """The ranks' split changes only the order of the sums: every cluster
    size stays within 1e-5 of max|y| of attn_plain (the kernel takes any
    size up to 16 and at most a block a rank)."""
    t = _inputs(3, 8, 2, 333, ROPE_TYPE_NORM, seed=2)
    got = kernel_order(**t, scale=D ** -0.5, cluster=cluster)
    assert _rel(got, cuda_attn.attn_plain(**t, scale=D ** -0.5)) <= PLAIN_REL_TOL


@MODES
@pytest.mark.parametrize("name,T,H,Hkv,S", CASES, ids=[c[0] for c in CASES])
def test_kernel_order_matches_pallas(name, T, H, Hkv, S, mode):
    """Against the TPU kernel (_kernel) in interpret mode at
    test_pallas_attn.py's 5e-3. The reference takes S in one block: over a
    padded last block its padding row would also count the pad (ROADMAP,
    deliberate differences)."""
    t = _inputs(T, H, Hkv, S, mode, seed=1)
    scale = D ** -0.5
    want = np.asarray(jax_attn.flash_decode(**_jax_args(t), scale=scale, sblk=S,
                                            interpret=True))
    got = kernel_order(**t, scale=scale).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **PALLAS_TOL)


@pytest.mark.parametrize("oracle", ["kernel_q8", "bf16"])
@MODES
@pytest.mark.parametrize("name,T,H,Hkv,S", CASES, ids=[c[0] for c in CASES])
def test_kernel_order_q8_matches_pallas(name, T, H, Hkv, S, mode, oracle, monkeypatch):
    """K3q's order against the TPU's q8 decode in interpret mode, two ways
    (test_torch_attn.py's oracles): "kernel_q8" runs _kernel_q8 on the pairs,
    whose bf16 rounding of q*s XLA folds away on the CPU, against this order
    with its dequant set to that f32 product; "bf16" runs the dense _kernel
    on the pairs dequantized and rounded to bf16 (the TPU kernel's values)
    against this order as the card runs it."""
    t = _inputs(T, H, Hkv, S, mode, seed=1, q8=True)
    scale = D ** -0.5
    want = np.asarray(jax_attn.flash_decode(**_jax_args(t, oracle), scale=scale, sblk=S,
                                            interpret=True))
    if oracle == "kernel_q8":
        monkeypatch.setattr(cuda_attn, "dequant_bf16", _f32_product)
    got = kernel_order(**t, scale=scale).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **PALLAS_Q8_TOL)


@pytest.fixture(scope="module")
def card_shape():
    # chip_smoke.py's attention inputs at this shape (seed S + T), on the CPU
    t, _ = attn_inputs(1, 32, 8, 64, D, seed=64 + 1, device="cpu")
    return t, cuda_attn.attn_plain(**t, scale=D ** -0.5)


def _close_ratio(got, want) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 fails assert_close."""
    return float(((got - want).abs() / (CARD_TOL["atol"] + CARD_TOL["rtol"] * want.abs())).max())


@pytest.mark.parametrize("split,passes", [(False, False), (True, True)],
                         ids=["bf16-once", "hi-lo"])
def test_single_rounding_misses_the_card_tolerance(card_shape, split, passes):
    """At T=1 S=64 H=32 Hkv=8: one bf16 rounding of k*cos, k*sin and p misses
    the card's atol = rtol = 1e-3 against attn_plain; hi + lo on both stays
    under a hundredth of it."""
    t, want = card_shape
    ratio = _close_ratio(kernel_order(**t, scale=D ** -0.5, split_k=split, split_p=split),
                         want)
    if passes:
        assert ratio < 0.01
    else:
        assert ratio > 1.0


def _covers(T, H, Hkv, S, n_sm):
    """decode_attn_plan's grid, checked: the ranks' block ranges (as the
    kernel computes them) read every cell once, each CTA has a block, and
    the row chunks of 32 cover the T*G rows."""
    cluster, per, chunks = cuda_attn.decode_attn_plan(T, H, Hkv, S, n_sm)
    nblk = -(-S // BLOCK)
    assert 1 <= cluster <= cuda_attn.DECODE_MAX_CLUSTER
    assert per == -(-nblk // cluster)
    cells = []
    for rank in range(cluster):
        b0, b1 = min(nblk, rank * per), min(nblk, rank * per + per)
        assert b1 > b0, f"rank {rank} of {cluster} has no block"
        cells += range(b0 * BLOCK, min(S, b1 * BLOCK))
    assert cells == list(range(S))
    R = T * (H // Hkv)
    assert (chunks - 1) * cuda_attn.DECODE_ROWS < R <= chunks * cuda_attn.DECODE_ROWS
    return cluster


@pytest.mark.parametrize("name,T,H,Hkv,S", CASES + [("card", 8, 32, 8, 512), ("one", 2, 4, 4, 1),
                                                    ("g8-t8", 8, 64, 8, 4001)],
                         ids=[c[0] for c in CASES] + ["card", "one-cell", "g8-t8"])
@pytest.mark.parametrize("n_sm", [8, 132])
def test_plan_covers_every_cell_once(name, T, H, Hkv, S, n_sm):
    _covers(T, H, Hkv, S, n_sm)


@pytest.mark.parametrize("T", range(1, 9))
@pytest.mark.parametrize("S", [4096, 4001, 512 + 128, 64])
def test_plan_at_llama3_8b(T, S):
    """LLAMA3_8B (H=32, Hkv=8) on 132 SMs: one chunk of rows, and the
    cluster the sweep found fastest at every swept shape (8; PERF.md), or
    the fewest CTAs that read as many blocks each as 8 would."""
    cluster = _covers(T, 32, 8, S, N_SM)
    assert cuda_attn.decode_attn_plan(T, 32, 8, S, N_SM)[2] == 1
    nblk = -(-S // BLOCK)
    assert cluster == -(-nblk // -(-nblk // min(8, nblk)))
    if S >= 4001:
        assert cluster == 8


def test_decode_checks_refuse_what_the_kernel_cannot_take():
    """T past 8 and a tensor that does not start 16-byte aligned are
    refused before any launch."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    cuda_attn._check_decode(8, x)
    with pytest.raises(ValueError):
        cuda_attn._check_decode(9, x)
    with pytest.raises(ValueError):
        cuda_attn._check_decode(1, x[1:])


@pytest.mark.parametrize("argv,want", [
    ([], dict(T=[1, 8], S=[4096, 4001], kv=["bf16", "q8_0"], clusters=[1, 2, 4, 8])),
    (["--T", "1", "--S", "64", "--kv", "q8_0", "--clusters", "1,8"],
     dict(T=[1], S=[64], kv=["q8_0"], clusters=[1, 8])),
    (["--host", "--T", "1"], dict(T=[1], host=True)),
    ([], dict(host=False)),
])
def test_attn_splits_arguments(argv, want):
    args = attn_splits.parse(argv)
    assert {k: getattr(args, k) for k in want} == want


@pytest.mark.parametrize("argv", [["--T", "9"], ["--T", "0"], ["--clusters", "9"],
                                  ["--kv", "f32"], ["--S", "0"]])
def test_attn_splits_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit):
        attn_splits.parse(argv)


def test_attn_splits_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        attn_splits.main([])
