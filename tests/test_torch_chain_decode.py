"""K6 on the decode GEMV's CTA body (csrc/qmm_chain.cu), its arithmetic
written out in plain torch in the order the kernel runs it, and its plan.

Each phase is the decode GEMV's sum (exact integer products q - zp with
the bf16 x on the tensor cores, f32 over 16 k, one f32 accumulator a quant
group, then acc = s * P + acc and acc = -m * xsum + acc): a column tile's K
is split over `split` CTAs of a thread block cluster, within a CTA the
stages alternate between two consumer pairs by the CTA's running stage
count, and the partial tiles meet in rank order (v += pair 0's, v += pair
1's, CTA after CTA). Between phases the x of the next one is materialised
in bf16: h = bf16(x_res + bf16(y1)) by phase 0's epilogue, hn =
bf16(h * rsqrt(mean(h^2) + eps) * gamma), cur = bf16(silu(g) * u); the
last phase writes bf16(h + bf16(y3)), or its f32 y cast. Held here, on the
same GGUF bytes in both packages (Q4_K phases with a Q4_K or Q6_K down,
Q8_0 phases; B in {1, 5, 8}; splits from chain_plan at the H100's cluster
counts and forced ones):
  * against qmm_chain_plain within one bf16 step (2^-8) of max|out|: the
    outputs are bf16, and a last-bit difference of an f32 sum can cross a
    rounding boundary of h, hn, cur or the output (measured <= 3.3e-3);
  * against llm_tpu's layer_tail / norm_mm in interpret mode at
    tests/test_torch_chain.py's TOL_BF16 / TOL_NORM_BF16 (the TPU kernel
    rounds (q - zp) * s to bf16, the port keeps it in f32).
The plan (chain_plan, chain_items): every (tile, stage) of every phase is
covered once, by groups whose split divides the cluster size, at every
LLAMA3_8B chain and the test shapes, and its pick is within 5% of the
fastest cluster size and splits timed on the card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from llm_tpu.gguf.constants import GGMLType
from llm_tpu.ops import pallas_qmm_chain as jax_chain
from llm_tpu.quant import codecs
from llm_tpu.quant.qtensor import qtensor_from_gguf as jax_qtensor_from_gguf

from llm_tpu_torch.device import full_f32
from llm_tpu_torch.ops import cuda_qmm_chain
from llm_tpu_torch.ops.cuda_qmm import DECODE_TILE_N, DECODE_UNIT_K, unpack_planes
from llm_tpu_torch.ops.cuda_qmm_chain import chain_items, chain_plan, qmm_chain_plain
from llm_tpu_torch.quant.qtensor import qtensor_from_gguf

E, FF = 512, 1024
EPS = 1e-5
# the clusters an H100 SXM holds at once for each of K6's cluster sizes
# (qmm_chain_clusters, two CTAs an SM)
H100_CLUSTERS = {4: 62, 6: 39, 8: 30}
BF16_STEP = 2.0 ** -8
TOL_BF16 = 3e-2       # tests/test_torch_chain.py
TOL_NORM_BF16 = 2e-2


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _stage_groups(qt, u: int):
    """The quant groups of stage u (128 k) in the order the consumers fold
    them, each with its 16-k steps: p4 -> the low nibbles' first group, the
    high nibbles' first, then the second of each; i8 -> in k order."""
    if qt.layout == "p4":
        kx0 = 256 * (u >> 1) + 64 * (u & 1)
        order = [kx0, kx0 + 128, kx0 + 32, kx0 + 160]
        return [(k0 // 32, [k0, k0 + 16]) for k0 in order]
    gs = qt.group_size
    return [(k0 // gs, list(range(k0, k0 + gs, 16)))
            for k0 in range(DECODE_UNIT_K * u, DECODE_UNIT_K * (u + 1), gs)]


def phase_decode_order(x: torch.Tensor, qt, plan_phase, n_clusters: int,
                       cluster: int) -> torch.Tensor:
    """One phase, x bf16 [B, K] -> y f32 [B, N], in the kernel's order:
    plan_phase = (split, last split); the items as chain_items deals them,
    each CTA's running stage count from item to item."""
    split, last = plan_phase
    xr = _bf16(x)
    q = unpack_planes(qt).float()
    assert torch.equal(_bf16(q), q)
    K, N = q.shape
    B = xr.shape[0]
    s = qt.scales.float()
    m = None if qt.mins is None else qt.mins.float()
    with full_f32():
        dot16 = {k0: xr[:, k0:k0 + 16] @ q[k0:k0 + 16] for k0 in range(0, K, 16)}
        xs16 = {k0: xr[:, k0:k0 + 16].sum(-1, keepdim=True) for k0 in range(0, K, 16)}
        count, tiles = {}, {}
        for cq, rank, k, tile, u0, u1 in sorted(
                chain_items(K, N, split, n_clusters, cluster, last), key=lambda it: it[2]):
            c0 = count.get((cq, rank), 0)
            count[(cq, rank)] = c0 + u1 - u0
            tiles.setdefault(tile, []).append((rank, u0, u1, c0))
        y = torch.zeros((B, N))
        for tile, ctas in tiles.items():
            cols = slice(tile * DECODE_TILE_N, (tile + 1) * DECODE_TILE_N)
            v = torch.zeros((B, DECODE_TILE_N))
            for rank, u0, u1, c0 in sorted(ctas):  # the group's CTAs in rank order
                acc = [torch.zeros((B, DECODE_TILE_N)), torch.zeros((B, DECODE_TILE_N))]
                for j, u in enumerate(range(u0, u1)):
                    w = (c0 + j) % 2  # the consumer pair that takes the stage
                    for g, steps in _stage_groups(qt, u):
                        p = dot16[steps[0]][:, cols]
                        xs = xs16[steps[0]]
                        for k0 in steps[1:]:
                            p = p + dot16[k0][:, cols]
                            xs = xs + xs16[k0]
                        acc[w] = s[g, cols] * p + acc[w]
                        if m is not None:
                            acc[w] = -m[g, cols] * xs + acc[w]
                v = v + acc[0]
                v = v + acc[1]
            y[:, cols] = v
    return y


def chain_decode_order(x, qts, gammas, x_res, *, pres, final, out_dtype, plan,
                       n_clusters=H100_CLUSTERS):
    """The chain as the kernel runs it: x [B, K0] -> [B, N_last]; plan =
    (cluster size, splits[, last splits])."""
    cluster, splits, *lasts = plan
    lasts = lasts[0] if lasts else splits
    gam = iter(gammas)
    h = prev = None
    for p, (qt, pre) in enumerate(zip(qts, pres)):
        if pre == "cast":
            xin = _bf16(x)
        elif pre in ("norm", "res_norm"):
            src = _bf16(x) if pre == "norm" else h
            with full_f32():
                r = torch.rsqrt((src * src).sum(-1, keepdim=True) / src.shape[-1] + EPS)
            xin = _bf16(src * r * next(gam).float())
        else:
            g, u = prev.chunk(2, dim=-1)
            xin = _bf16(g / (1 + torch.exp(-g)) * u)
        y = phase_decode_order(xin, qt, (splits[p], lasts[p]), n_clusters[cluster], cluster)
        nxt = pres[p + 1] if p + 1 < len(qts) else None
        if nxt == "res_norm":
            h = prev = _bf16(_bf16(x_res) + _bf16(y))
        else:
            prev = y
    if final == "add_res":
        return _bf16(h + _bf16(prev))
    return prev.to(out_dtype)


def _mk(rng, n, k, qtype):
    """The same GGUF bytes as both packages' planes."""
    w = (rng.normal(size=(n, k)) * 0.05).astype(np.float32)
    raw = codecs.quantize(w, qtype)
    return jax_qtensor_from_gguf(raw, qtype, (k, n)), qtensor_from_gguf(raw, qtype, (k, n))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


TAIL_TYPES = [(GGMLType.Q4_K, GGMLType.Q4_K, GGMLType.Q4_K),
              (GGMLType.Q4_K, GGMLType.Q4_K, GGMLType.Q6_K),
              (GGMLType.Q8_0, GGMLType.Q8_0, GGMLType.Q8_0)]


def _tail_case(types, seed, B):
    rng = np.random.default_rng(seed)
    pairs = [_mk(rng, E, E, types[0]), _mk(rng, 2 * FF, E, types[1]), _mk(rng, E, FF, types[2])]
    bf = torch.bfloat16
    att = torch.from_numpy((rng.normal(size=(B, E)) * 0.1).astype(np.float32)).to(bf)
    xres = torch.from_numpy((rng.normal(size=(B, E)) * 0.1).astype(np.float32)).to(bf)
    gamma = torch.from_numpy((rng.normal(size=(E,)) * 0.1 + 1.0).astype(np.float32))
    return pairs, att, xres, gamma


TAIL = dict(pres=("cast", "res_norm", "swiglu"), final="add_res", out_dtype=torch.bfloat16)


@pytest.mark.parametrize("B", [1, 5, 8])
@pytest.mark.parametrize("types", TAIL_TYPES, ids=lambda t: "-".join(x.name for x in t))
def test_tail_order_matches_plain_and_reference(types, B):
    pairs, att, xres, gamma = _tail_case(types, 11 + B, B)
    qts = [p[1] for p in pairs]
    plan = chain_plan([(q.in_features, q.out_features) for q in qts], H100_CLUSTERS)
    got = chain_decode_order(att, qts, (gamma,), xres, plan=plan, **TAIL)
    want = qmm_chain_plain(att, qts, (gamma,), xres, eps=EPS, pres=TAIL["pres"],
                           final="add_res")
    assert got.shape == (B, E)
    assert _rel(got, want.float()) <= BF16_STEP
    tb = (lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16))
    ref = jax_chain.layer_tail(tb(att), tb(xres), jnp.asarray(gamma.numpy()),
                               *(p[0] for p in pairs), eps=EPS, compute_dtype=jnp.bfloat16,
                               interpret=True)
    assert _rel(got, np.asarray(ref, np.float32)) < TOL_BF16


FEW_CLUSTERS = {4: 3, 6: 1, 8: 1}


@pytest.mark.parametrize("plan,counts", [
    ((4, (4, 1, 1)), H100_CLUSTERS), ((8, (1, 2, 8)), H100_CLUSTERS),
    ((6, (2, 1, 2)), H100_CLUSTERS),
    ((4, (1, 1, 1), (1, 2, 1)), FEW_CLUSTERS),   # several rounds, a last one at its own split
    ((6, (2, 1, 2), (2, 1, 3)), FEW_CLUSTERS)],
    ids=["c4", "c8", "c6", "c4-rounds", "c6-rounds"])
def test_tail_order_at_forced_splits(plan, counts):
    """Other cluster sizes and splits the sweep times, and grids of a few
    clusters, where a CTA takes several items and the running stage count
    moves the consumer pairs: the same sum in another order, within one
    bf16 step of the plain chain."""
    pairs, att, xres, gamma = _tail_case(TAIL_TYPES[1], 3, 5)
    qts = [p[1] for p in pairs]
    for (K, N), split, last in zip([(q.in_features, q.out_features) for q in qts], plan[1],
                                   plan[-1]):
        _check_cover(K, N, split, counts[plan[0]], plan[0], last)
    got = chain_decode_order(att, qts, (gamma,), xres, plan=plan, n_clusters=counts, **TAIL)
    want = qmm_chain_plain(att, qts, (gamma,), xres, eps=EPS, pres=TAIL["pres"],
                           final="add_res")
    assert _rel(got, want.float()) <= BF16_STEP


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B", [1, 5, 8])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_norm_mm_order_matches_plain_and_reference(qtype, B, out_dtype):
    rng = np.random.default_rng(B)
    jw, tw = _mk(rng, 3 * E, E, qtype)
    x = torch.from_numpy((rng.normal(size=(B, E)) * 0.3).astype(np.float32)).to(torch.bfloat16)
    gamma = torch.from_numpy((rng.normal(size=(E,)) * 0.1 + 1.0).astype(np.float32))
    plan = chain_plan([(E, 3 * E)], H100_CLUSTERS)
    kw = dict(pres=("norm",), final="cast", out_dtype=out_dtype)
    got = chain_decode_order(x, [tw], (gamma,), None, plan=plan, **kw)
    want = qmm_chain_plain(x, [tw], (gamma,), None, eps=EPS, **kw)
    assert got.dtype == out_dtype and got.shape == (B, 3 * E)
    assert _rel(got.float(), want.float()) <= BF16_STEP
    ref = jax_chain.norm_mm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                            jnp.asarray(gamma.numpy()), jw, eps=EPS,
                            compute_dtype=jnp.bfloat16, out_dtype=jnp.float32, interpret=True)
    assert _rel(got.float(), np.asarray(ref, np.float32)) < TOL_NORM_BF16


# LLAMA3_8B's chains (phases (K, N)) and the test shapes
LLAMA3_8B_CHAINS = {
    "tail": ((4096, 4096), (4096, 28672), (14336, 4096)),
    "head qkv": ((4096, 6144),),
    "lm_head": ((4096, 128256),),
}
TEST_CHAINS = {"tail": ((E, E), (E, 2 * FF), (FF, E)), "head": ((E, 3 * E),),
               "narrow": ((256, 384), (384, 256))}
ALL_CHAINS = {**LLAMA3_8B_CHAINS, **{f"test {k}": v for k, v in TEST_CHAINS.items()}}


def _check_cover(K, N, split, n_clusters, cluster, last=None):
    tiles, units = -(-N // DECODE_TILE_N), -(-K // DECODE_UNIT_K)
    last = last or split
    for sp in (split, last):  # the launch's rules (csrc/qmm_chain.cu)
        assert cluster % sp == 0 and (sp - 1) * -(-units // sp) < units
    full, rest = divmod(tiles, n_clusters * (cluster // split))
    assert last == split or (full and rest and rest <= n_clusters * (cluster // last))
    seen = np.zeros((tiles, units), np.int32)
    for q, rank, k, tile, u0, u1 in chain_items(K, N, split, n_clusters, cluster, last):
        assert 0 <= q < n_clusters and 0 <= rank < cluster and u1 > u0
        seen[tile, u0:u1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("counts", [H100_CLUSTERS, {4: 1, 6: 1, 8: 1}, {4: 7, 6: 5, 8: 3}],
                         ids=["h100", "one", "few"])
@pytest.mark.parametrize("name", list(ALL_CHAINS))
def test_plan_covers_every_stage_once(name, counts):
    dims = ALL_CHAINS[name]
    cluster, splits, lasts = chain_plan(dims, counts)
    assert cluster in counts and len(splits) == len(lasts) == len(dims)
    for (K, N), split, last in zip(dims, splits, lasts):
        _check_cover(K, N, split, counts[cluster], cluster, last)


@pytest.mark.parametrize("cluster", sorted(H100_CLUSTERS))
@pytest.mark.parametrize("name", list(ALL_CHAINS))
def test_every_split_the_kernel_takes_covers_every_stage_once(name, cluster):
    for K, N in ALL_CHAINS[name]:
        units = -(-K // DECODE_UNIT_K)
        for split in cuda_qmm_chain._splits(units, cluster):
            _check_cover(K, N, split, H100_CLUSTERS[cluster], cluster)


# tools/gemm_splits.py --chain --B 1,8 on an NVIDIA H100 80GB HBM3 (700.00
# W): µs of each chain at each cluster size with the plan's splits for it,
# with one phase's split moved, and without a last round's own split
# (PERF.md §6, PR 10), those within 8% of the fastest; (chain, B) ->
# {(cluster, splits, last splits): µs}
SWEEP_US = {
    ('tail Q4_K down', 1): {
        (6, (2, 1, 6), (2, 1, 6)): 73.5, (6, (3, 1, 6), (3, 1, 6)): 71.6,
        (6, (6, 1, 3), (6, 1, 3)): 73.6, (6, (6, 1, 6), (6, 1, 6)): 71.9,
    },
    ('tail Q6_K down', 1): {
        (4, (4, 1, 4), (4, 1, 4)): 94.7, (6, (2, 1, 6), (2, 1, 6)): 91.5,
        (6, (3, 1, 6), (3, 1, 6)): 89.8, (6, (6, 1, 3), (6, 1, 3)): 88.7,
        (6, (6, 1, 6), (6, 1, 6)): 89.4, (8, (4, 1, 4), (4, 1, 4)): 94.2,
    },
    ('head qkv', 1): {
        (4, (4,), (4,)): 14.1, (6, (2,), (2,)): 15.2, (8, (4,), (4,)): 14.2,
    },
    ('lm_head Q6_K', 1): {
        (4, (1,), (1,)): 221.1, (4, (1,), (4,)): 210.0, (4, (2,), (2,)): 224.2,
        (6, (1,), (1,)): 216.0, (6, (1,), (3,)): 215.6, (8, (1,), (1,)): 218.6,
        (8, (1,), (4,)): 214.4, (8, (2,), (2,)): 224.0,
    },
    ('tail Q4_K down', 8): {
        (4, (4, 1, 4), (4, 1, 4)): 81.5, (6, (2, 1, 6), (2, 1, 6)): 79.2,
        (6, (3, 1, 6), (3, 1, 6)): 76.6, (6, (6, 1, 3), (6, 1, 3)): 77.0,
        (6, (6, 1, 6), (6, 1, 6)): 76.2, (8, (4, 1, 4), (4, 1, 4)): 81.6,
        (8, (4, 1, 8), (4, 1, 8)): 80.6,
    },
    ('tail Q6_K down', 8): {
        (4, (2, 1, 4), (2, 1, 4)): 100.4, (4, (4, 1, 4), (4, 1, 4)): 98.0,
        (6, (2, 1, 6), (2, 1, 6)): 97.8, (6, (3, 1, 6), (3, 1, 6)): 95.0,
        (6, (6, 1, 3), (6, 1, 3)): 93.6, (6, (6, 1, 6), (6, 1, 6)): 93.3,
        (8, (2, 1, 4), (2, 1, 4)): 100.4, (8, (4, 1, 4), (4, 1, 4)): 97.8,
    },
    ('head qkv', 8): {
        (4, (4,), (4,)): 14.8, (8, (4,), (4,)): 14.8,
    },
    ('lm_head Q6_K', 8): {
        (4, (1,), (1,)): 228.3, (4, (1,), (4,)): 216.7, (6, (1,), (1,)): 223.0,
        (6, (1,), (3,)): 223.6, (8, (1,), (1,)): 225.8, (8, (1,), (4,)): 221.2,
    },
}
CHAIN_DIMS = {"tail Q4_K down": LLAMA3_8B_CHAINS["tail"], "tail Q6_K down":
              LLAMA3_8B_CHAINS["tail"], "head qkv": LLAMA3_8B_CHAINS["head qkv"],
              "lm_head Q6_K": LLAMA3_8B_CHAINS["lm_head"]}
PICK_SLACK = 1.05


@pytest.mark.parametrize("case", list(SWEEP_US), ids=[f"{c}-B{b}" for c, b in SWEEP_US])
def test_plan_picks_a_fastest_measured_chain(case):
    """At each LLAMA3_8B chain, B = 1 and 8, chain_plan's pick on the
    H100's cluster counts was timed, within 5% of the fastest timed."""
    us = SWEEP_US[case]
    pick = chain_plan(CHAIN_DIMS[case[0]], H100_CLUSTERS)
    assert pick in us
    assert us[pick] <= PICK_SLACK * min(us.values())


def test_swiglu_boundary_is_silu_times_u():
    """The kernel's cur = bf16(g / (1 + exp(-g)) * u) is torch's silu(g) * u
    rounded to bf16, to the last bit or one bf16 step."""
    g = torch.linspace(-12, 12, 4097)
    u = torch.linspace(3, -3, 4097)
    got = _bf16(g / (1 + torch.exp(-g)) * u)
    want = _bf16(F.silu(g) * u)
    assert ((got - want).abs() <= BF16_STEP * want.abs().clamp(min=2.0 ** -126)).all()
