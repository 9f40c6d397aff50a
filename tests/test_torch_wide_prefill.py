"""The flash prefill's route, the wide K4/K4q's plan and arithmetic, and
the capped narrow step, on the CPU.

- The route: every (T, Dk, Dv, q8, softcap) that chip_smoke.py's phase 2
  and its model phases give K3/K4 goes to exactly one entry point of the
  kernel libraries and one LAUNCHES key, the wrapper's own calls recorded
  with the libraries replaced: capped prefill at Dk = Dv <= 128 on the
  narrow kernels' capped instantiations (K4_cap, K4q_cap), capped decode
  on K3w_cap / K3qw_cap, 256 dims and Dk != Dv on the wide ones; the wide
  launch takes wide_prefill_plan's split.
- wide_prefill_plan against the budgets of the wide CTA
  (csrc/flash_prefill_wide.cuh): 128 rows a CTA, one chunk where Dk and Dv
  are at most 128, q in shared memory at two chunks, the whole within the
  227 KB a block can have, the S split's partials within the ring, no
  scratch in global memory, every rank of a split with a block, one wave
  of CTAs at the main path's T = 512, a split no larger than lets every
  cluster run at once (on the card, the clusters the occupancy query
  says it holds); and the constants the kernel itself
  declares (rows, cells, slots, the largest cluster, the setmaxnreg
  balance) against the Python plan's.
- The wide CTA's arithmetic in its order (32-cell blocks, the exact hi +
  lo planes and P, each rank of an S split on its own blocks, then the
  ranks' (m, l, O) combined in rank order; the softcap's tanh in the scale
  step) against attn_plain, capped and uncapped, at one and two chunks.
- attn_plain(softcap=50) at 128 dims (Gemma-2-27B's heads, the capped
  narrow kernels' function) against llm_tpu's flash_prefill(softcap=50) in
  interpret mode, at test_pallas_attn.py's tolerances (5e-3 dense, 2e-2
  q8_0).
- Gemma-2-27B's config cut to a few layers keeps its 46-layer scale,
  query_pre_attn_scalar 144.
About 10 s on one worker."""

import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_tpu.ops import pallas_attn as jax_attn

from llm_tpu_torch.device import full_f32
from llm_tpu_torch.models.synthetic import GEMMA2_27B, gemma2_27b_config, gemma2_config
from llm_tpu_torch.models.transformer import quantize_rows
from llm_tpu_torch.ops import cuda_attn
from llm_tpu_torch.ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORM

from test_torch_attn_dims import _inputs, _jax, _q8, _torch
from test_torch_flash_decode import one_torch_thread  # noqa: F401 (autouse)

PALLAS_TOL = dict(atol=5e-3, rtol=5e-3)     # test_pallas_attn.py:53
PALLAS_Q8_TOL = dict(atol=2e-2, rtol=2e-2)  # test_pallas_attn.py:116
NEG, LOG2E = -1e30, 1.4426950408889634
N_SM = 132  # the H100's SMs
WIDE_HEADER = Path(cuda_attn.__file__).resolve().parents[1] / "csrc" / "flash_prefill_wide.cuh"

# (T, Dk, Dv, q8, softcap, LAUNCHES key, entry point): phase 2's rows (T = 1,
# 8 and 512 over 4096 cells) and the model phases' steps (T = 9 and 70 are
# prefill steps of a few tokens)
ROUTES = [
    (512, 128, 128, False, 0.0, "K4", "flash_prefill_launch"),
    (512, 128, 128, True, 0.0, "K4q", "flash_prefill_q8_launch"),
    (512, 64, 64, False, 0.0, "K4", "flash_prefill_launch"),
    (512, 80, 80, True, 0.0, "K4q", "flash_prefill_q8_launch"),
    (512, 96, 96, False, 0.0, "K4", "flash_prefill_launch"),
    (512, 72, 72, False, 0.0, "K4", "flash_prefill_launch"),
    (512, 72, 72, True, 0.0, "K4qw", "flash_prefill_wide_q8_launch"),
    (512, 136, 136, True, 0.0, "K4qw", "flash_prefill_wide_q8_launch"),
    (70, 136, 136, False, 0.0, "K4w", "flash_prefill_wide_launch"),
    (512, 256, 256, False, 0.0, "K4w", "flash_prefill_wide_launch"),
    (512, 256, 256, True, 0.0, "K4qw", "flash_prefill_wide_q8_launch"),
    (512, 192, 128, False, 0.0, "K4w", "flash_prefill_wide_launch"),
    (40, 192, 128, True, 0.0, "K4qw", "flash_prefill_wide_q8_launch"),
    (512, 128, 64, False, 0.0, "K4w", "flash_prefill_wide_launch"),
    (512, 256, 256, False, 50.0, "K4w_cap", "flash_prefill_wide_launch"),
    (512, 256, 256, True, 50.0, "K4qw_cap", "flash_prefill_wide_q8_launch"),
    (512, 128, 128, False, 50.0, "K4_cap", "flash_prefill_cap_launch"),
    (512, 128, 128, True, 50.0, "K4q_cap", "flash_prefill_q8_cap_launch"),
    (9, 128, 128, False, 50.0, "K4_cap", "flash_prefill_cap_launch"),
    (1, 128, 128, False, 50.0, "K3w_cap", "flash_decode_wide_launch"),
    (8, 128, 128, True, 50.0, "K3qw_cap", "flash_decode_wide_q8_launch"),
    (1, 256, 256, False, 50.0, "K3w_cap", "flash_decode_wide_launch"),
    (1, 128, 128, False, 0.0, "K3", "flash_decode_launch"),
    (8, 128, 128, True, 0.0, "K3q", "flash_decode_q8_launch"),
    (8, 256, 256, True, 0.0, "K3qw", "flash_decode_wide_q8_launch"),
    (1, 192, 128, False, 0.0, "K3w", "flash_decode_wide_launch"),
]


class _Recorder:
    """A kernel library whose every entry point records its call and
    returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _dims(q, k, v):
    T, H, Dk = q.shape
    Hkv, S, Dv = (v[0] if isinstance(v, tuple) else v).shape
    return T, H, Hkv, S, Dk, Dv


@pytest.mark.parametrize("T,Dk,Dv,q8,softcap,key,entry", ROUTES,
                         ids=[f"T{r[0]}-Dk{r[1]}-Dv{r[2]}-{'q8' if r[3] else 'bf16'}-cap{r[4]:g}"
                              for r in ROUTES])
def test_each_step_takes_exactly_one_kernel(T, Dk, Dv, q8, softcap, key, entry, monkeypatch):
    """The dispatcher's launch for a step of these heads calls one entry
    point and counts one LAUNCHES key (the device checks stubbed: the
    tensors lie on the CPU); the wide prefill passes the plan's split."""
    H, Hkv, S = 4, 2, 64
    lib = _Recorder()
    monkeypatch.setattr(cuda_attn, "_lib", lambda: lib)
    monkeypatch.setattr(cuda_attn, "_prefill_lib", lambda: lib)
    monkeypatch.setattr(cuda_attn, "_check_inputs",
                        lambda q, q_rot, k, v, cos, sin, bias, kv_dtype=None: _dims(q, k, v))
    monkeypatch.setattr(cuda_attn, "_check_q8",
                        lambda q, q_rot, k, v, cos, sin, bias: _dims(q, k, v))
    monkeypatch.setattr(cuda_attn, "sm_count", lambda device: N_SM)
    monkeypatch.setattr(cuda_attn, "_wide_clusters", lambda q8, chunks, split: N_SM // split)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    q = torch.zeros((T, H, Dk), dtype=torch.bfloat16)
    k, v = (torch.zeros((Hkv, S, d), dtype=torch.bfloat16) for d in (Dk, Dv))
    if q8:
        k, v = quantize_rows(k, 1), quantize_rows(v, 1)
    tables = torch.zeros((S, Dk), dtype=torch.bfloat16)
    args = dict(q=q, q_rot=q, k=k, v=v, cos=tables, sin=tables,
                bias=torch.zeros((T, S)), scale=Dk ** -0.5, softcap=softcap)
    before = dict(cuda_attn.LAUNCHES)
    launch = cuda_attn._decode_launch if T <= cuda_attn.DECODE_MAX_T else cuda_attn._prefill_launch
    out = launch(q8, **args)
    assert out.shape == (T, H, Dv)
    assert [name for name, _ in lib.calls] == [entry]
    assert {n: c - before[n] for n, c in cuda_attn.LAUNCHES.items() if c != before[n]} == {key: 1}
    want_key = (cuda_attn.decode_kernel if T <= cuda_attn.DECODE_MAX_T
                else cuda_attn.prefill_kernel)(Dk, Dv, q8, softcap)
    assert want_key == key
    if entry.startswith("flash_prefill_wide"):
        split = lib.calls[0][1][-2]
        assert split == cuda_attn.wide_prefill_plan(T, H, Hkv, S, Dk, Dv, N_SM)["split"]


# (T, H, Hkv, S, Dk, Dv): phase 2's wide and capped rows (Gemma-2-2B's 8 over
# 4 of 256, MLA's 16 of 192 / 128, Dk 128 / Dv 64 at 32 over 8, int8 at 72
# and 136, Gemma-2-9B's 16 over 8 of 256), Gemma-7B's 16 over 16 of 256,
# phase 11's steps over its 8192 cells, and a few tokens over a few cells
PLAN_SHAPES = [(512, 8, 4, 4096, 256, 256), (512, 16, 16, 4096, 192, 128),
               (512, 32, 8, 4096, 128, 64), (512, 32, 8, 4096, 72, 72),
               (512, 16, 8, 4096, 136, 136), (512, 16, 8, 4096, 256, 256),
               (512, 16, 16, 4096, 256, 256), (512, 16, 8, 8192, 256, 256),
               (9, 16, 8, 333, 256, 256), (40, 8, 2, 64, 128, 64), (24, 8, 2, 32, 64, 128),
               (100, 8, 4, 1000, 136, 136)]


@pytest.mark.parametrize("T,H,Hkv,S,Dk,Dv", PLAN_SHAPES,
                         ids=[f"T{t}-H{h}-Hkv{hk}-S{s}-Dk{dk}-Dv{dv}"
                              for t, h, hk, s, dk, dv in PLAN_SHAPES])
def test_wide_plan_within_budgets(T, H, Hkv, S, Dk, Dv):
    """The plan's CTA: 128 rows, one chunk where Dk and Dv fit 128 (no
    dead chunk), else two with q in shared memory (O at Dv = 256 takes 128
    registers a thread); within 227 KB with the S split's partials inside
    the ring and no scratch; a split of 1 to 8 CTAs in which every rank has
    blocks; at the main path's T = 512 one wave of at least 64 CTAs on 132
    SMs."""
    plan = cuda_attn.wide_prefill_plan(T, H, Hkv, S, Dk, Dv, N_SM)
    assert plan == cuda_attn.wide_prefill_plan(T, H, Hkv, S, Dk, Dv, N_SM)  # a pure function
    chunks = 1 if max(Dk, Dv) <= 128 else 2
    assert (plan["rows"], plan["cells"], plan["chunks"]) == (128, 32, chunks)
    smem = cuda_attn.wide_prefill_smem(chunks)
    assert plan["smem_bytes"] == smem["total"] <= cuda_attn.SMEM_PER_CTA
    assert smem["partials"] <= smem["total"] - 1024
    assert smem["q"] == (0 if chunks == 1 else 128 * 2 * chunks * 128 * 2)
    assert plan["scratch_bytes"] == 0
    nblk = math.ceil(S / 32)
    split, per = plan["split"], plan["blocks_per_cta"]
    assert 1 <= split <= min(8, nblk) and split * per >= nblk and (split - 1) * per < nblk
    tiles = math.ceil(T * (H // Hkv) / 128)
    assert plan["ctas"] == tiles * Hkv * split
    if T == 512:
        assert 64 <= plan["ctas"] <= N_SM


@pytest.mark.parametrize("capacity4,want", [(None, 4), (32, 4), (31, 3), (0, 3)],
                         ids=["one-cta-an-sm", "32-fit", "31-fit", "none-fit"])
def test_wide_plan_keeps_every_cluster_resident(capacity4, want):
    """Gemma-2-2B's 32 tiles of 128 rows over its 4 KV heads take a split of
    4 where the card holds 32 clusters of 4 CTAs at once, else 3 (a
    second wave cost more than the smaller split on an H100); each split's
    clusters then all fit."""
    def clusters(s):
        return N_SM // s if capacity4 is None or s != 4 else capacity4
    plan = cuda_attn.wide_prefill_plan(512, 8, 4, 4096, 256, 256, N_SM,
                                       None if capacity4 is None else clusters)
    assert plan["split"] == want and clusters(plan["split"]) >= 32


def _constexpr(text: str, name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return m.group(1).split("//")[0].strip()


def test_wide_plan_matches_the_kernel_constants():
    """The Python plan and csrc/flash_prefill_wide.cuh agree on the CTA's
    rows, cells a block, the largest split and the slots at one and two
    chunks; the registers the consumers raise to come from the producer
    (setmaxnreg can hand over no more), and cover the two-chunk consumer's
    O (128), scores, bias and P fragments (16 each)."""
    text = WIDE_HEADER.read_text()
    assert int(_constexpr(text, "FW_ROWS")) == cuda_attn.WIDE_PREFILL_ROWS
    assert int(_constexpr(text, "FW_SB")) == cuda_attn.WIDE_PREFILL_BLOCK
    assert int(_constexpr(text, "FW_MAX_SPLIT")) == cuda_attn.WIDE_PREFILL_MAX_SPLIT
    assert _constexpr(text, "NR") == "NC == 1 ? 4 : 2" == _constexpr(text, "NV")
    assert [cuda_attn.wide_prefill_smem(c)["planes_slots"] for c in (1, 2)] == [4, 2]
    producer = int(_constexpr(text, "FW_PRODUCER_REGS"))
    consumer = int(_constexpr(text, "FW_CONSUMER_REGS"))
    launch = 65536 // 384 // 8 * 8  # a thread's registers at launch, 384 threads a CTA
    assert 128 * (launch - producer) >= 256 * (consumer - launch)
    assert consumer >= 128 + 3 * 16


def wide_order(q, q_rot, k, v, cos, sin, bias, scale, softcap=0.0, split=1):
    """The wide CTA's arithmetic in its order: blocks of 32 cells, the exact
    hi + lo planes of k cos and k sin against [q | q_rot | q | q_rot], the
    score in log2 units (capped: cap log2e tanh(s scale / cap)), P as bf16
    hi + lo against V; rank r of a split of `split` runs blocks [r per,
    (r + 1) per) from m = -1e30 log2e, l = 0, and the ranks' (m, l, O)
    meet in rank order. Returns [T, H, Dv] f32."""
    T, H, _ = q.shape
    kf, vf = cuda_attn.dequant_bf16(k), cuda_attn.dequant_bf16(v)
    Hkv, S, Dv = vf.shape
    G = H // Hkv
    hi = (lambda x: (x.view(torch.int32) & -65536).view(torch.float32))
    kc, ks = kf * cos.float()[None], kf * sin.float()[None]
    planes = (hi(kc), hi(ks), kc - hi(kc), ks - hi(ks))
    rows = (lambda x: x.float().reshape(T, Hkv, G, -1).permute(1, 0, 2, 3)
            .reshape(Hkv, T * G, -1))
    lhs = (rows(q), rows(q_rot)) * 2
    brow = torch.clamp(bias.float(), min=NEG).repeat_interleave(G, dim=0) * LOG2E
    nblk = -(-S // 32)
    per = -(-nblk // split)
    parts = []
    with full_f32():
        for r in range(split):
            m = torch.full((Hkv, T * G, 1), NEG * LOG2E)
            l = torch.zeros((Hkv, T * G, 1))
            o = torch.zeros((Hkv, T * G, Dv))
            for b in range(r * per, min(nblk, (r + 1) * per)):
                sb, se = 32 * b, min(S, 32 * b + 32)
                s = sum(torch.einsum("hrd,hsd->hrs", a, p[:, sb:se])
                        for a, p in zip(lhs, planes))
                if softcap > 0:
                    s = softcap * LOG2E * torch.tanh(s * (scale / softcap))
                else:
                    s = s * (scale * LOG2E)
                s = s + brow[None, :, sb:se]
                mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp2(s - mn)
                alpha = torch.exp2(m - mn)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                ph = p.to(torch.bfloat16).float()
                pv = ph @ vf[:, sb:se] + (p - ph).to(torch.bfloat16).float() @ vf[:, sb:se]
                o = o * alpha + pv
                m = mn
            parts.append((m, l, o))
        M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        L = sum(l * torch.exp2(m - M) for m, l, _ in parts)
        O = sum(o * torch.exp2(m - M) for m, _, o in parts)
    out = O / torch.clamp(L, min=1e-30)
    return out.reshape(Hkv, T, G, Dv).permute(1, 0, 2, 3).reshape(T, H, Dv)


# (T, H, Hkv, S, Dk, Dv, q8, softcap, split): one chunk (Dk 128 / Dv 64,
# int8 at 72) and two (256, 192 / 128, 136), capped and not, unsplit and
# split over 2, 3 and 8 ranks (S = 200: 7 blocks, the last ragged)
WIDE_ORDER_CASES = [(20, 8, 2, 200, 128, 64, False, 0.0, 1),
                    (20, 8, 2, 200, 72, 72, True, 0.0, 3),
                    (20, 4, 2, 200, 256, 256, False, 0.0, 2),
                    (20, 4, 2, 200, 256, 256, True, 50.0, 3),
                    (20, 4, 4, 200, 192, 128, False, 0.0, 7),
                    (20, 4, 2, 200, 136, 136, True, 2.0, 1),
                    (20, 4, 2, 200, 128, 128, False, 50.0, 1)]


@pytest.mark.parametrize("T,H,Hkv,S,Dk,Dv,q8,softcap,split", WIDE_ORDER_CASES,
                         ids=[f"Dk{c[4]}-Dv{c[5]}-{'q8' if c[6] else 'bf16'}-cap{c[7]:g}-split{c[8]}"
                              for c in WIDE_ORDER_CASES])
def test_wide_order_is_the_function(T, H, Hkv, S, Dk, Dv, q8, softcap, split):
    """The wide CTA's order of operations gives attn_plain within 1e-5 (the
    bf16 P_lo's 2^-17 of each weight and the f32 sums' order), on rows that
    see cells and on the padding row that sees none; capped at 50 and at 2
    (which bends most scores), and the same order unsplit where the cap is
    off."""
    a = _inputs(T, H, Hkv, S, Dk, ROPE_TYPE_NEOX, seed=5, Dv=Dv)
    t = _torch(a)
    t["bias"][0] = float("-inf")  # a padding row
    if q8:
        t["k"], t["v"] = quantize_rows(t["k"], 1), quantize_rows(t["v"], 1)
    scale = 2.0 * Dk ** -0.5
    got = wide_order(**t, scale=scale, softcap=softcap, split=split)
    want = cuda_attn.attn_plain(**t, scale=scale, softcap=softcap)
    assert got.shape == (T, H, Dv)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if split > 1:
        torch.testing.assert_close(got, wide_order(**t, scale=scale, softcap=softcap),
                                   atol=1e-5, rtol=1e-5)


# (T, H, Hkv, S): Gemma-2-27B's G = 2 at 128 dims (T % llm_tpu's tblk 16 == 0)
CAP128 = [(32, 8, 4, 192), (48, 4, 2, 130)]


@pytest.mark.parametrize("mode", [ROPE_TYPE_NEOX, ROPE_TYPE_NORM], ids=["neox", "norm"])
@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("T,H,Hkv,S", CAP128, ids=[f"T{t}-H{h}-Hkv{hk}-S{s}"
                                                  for t, h, hk, s in CAP128])
def test_capped_plain_at_128_matches_pallas(T, H, Hkv, S, kv, mode, monkeypatch):
    """attn_plain(softcap=50), the function of K4_cap / K4q_cap, against
    llm_tpu's flash_prefill(softcap=50) in interpret mode at 128 dims; the
    scores scaled so that the cap bends them. On the q8_0 cache the port's
    dequant is set to the f32 product llm_tpu's interpreted kernel computes
    (test_torch_attn.py)."""
    cap, scale = 50.0, 2.0
    a = _inputs(T, H, Hkv, S, 128, mode, seed=17)
    t, j = _torch(a), _jax(a)
    if kv == "q8_0":
        for name in ("k", "v"):
            t[name], (q, s) = _q8(a[name])
            j[name] = (jnp.asarray(q), jnp.asarray(s, jnp.bfloat16))
        monkeypatch.setattr(cuda_attn, "dequant_bf16",
                            lambda x: x[0].float() * x[1].float() if isinstance(x, tuple)
                            else x.float())
    want = jax_attn.flash_prefill(**j, scale=scale, softcap=cap, tblk=16, sblk=64,
                                  interpret=True)
    got = cuda_attn.flash_prefill(**t, scale=scale, softcap=cap)
    assert got.shape == (T, H, 128) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(PALLAS_Q8_TOL if kv == "q8_0" else PALLAS_TOL))
    assert (cuda_attn.attn_plain(**t, scale=scale) - got).abs().max() > 0.1  # the cap bends


@pytest.mark.parametrize("n_layers", [1, 4, 12])
def test_gemma2_27b_config_keeps_its_scale_at_cut_depth(n_layers):
    """Gemma-2-27B cut to a few layers scales its scores by (4608 / 32)^-0.5
    = 144^-0.5 (query_pre_attn_scalar), as at its 46 layers; gemma2_config
    built at the cut depth would take head_dim^-0.5 = 128^-0.5."""
    cfg = gemma2_27b_config(n_layers)
    assert cfg.n_layers == n_layers
    assert cfg.attn_scale == 144 ** -0.5 == gemma2_config(**GEMMA2_27B).attn_scale
    assert (cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ff, cfg.vocab_size) \
        == (4608, 32, 16, 128, 36864, 256000)
    assert (cfg.attn_softcap, cfg.final_softcap, cfg.swa_window, cfg.swa_pattern) \
        == (50.0, 30.0, 4096, 2)
    assert gemma2_config(**dict(GEMMA2_27B, n_layers=n_layers)).attn_scale == 128 ** -0.5
