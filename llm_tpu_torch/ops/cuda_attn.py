"""K3/K4 (and K3q/K4q on the int8 cache): flash attention over the
head-major, unroped KV cache. Counterpart of llm_tpu/ops/pallas_attn.py
(flash_decode, flash_prefill, rope_companion, expand_tables).

Rope folds into the scores: (R(p_s) k_s).q = (k_s*cos_s).q + (k_s*sin_s).q_rot,
with q_rot the rope companion of q and cos/sin full-width per-cell tables.
The additive bias [T, S] carries the seq/causal mask; -inf is clamped to
-1e30 so fully masked padding rows stay finite, and the softmax denominator
is max(l, 1e-30). Query head h reads KV head h // G (h = h_kv*G + g).

K and V are bf16 [Hkv, S, D] tensors, or q8_0 (int8 [Hkv, S, D], bf16
scales [Hkv, S, 1]) pairs: one scale per head row. A pair is dequantized as
the TPU kernel does it, bf16(q) * bf16(s) rounded to bf16, then widened to
f32 (that product is exact in f32 before the rounding, so the kernels'
__float2bfloat16_rn((float)q * s) gives the same bits).

`attn_plain` is the kernels' function in plain PyTorch (f32). For CUDA
tensors flash_decode (T <= 8) launches csrc/flash_attn.cu (K3 on a bf16
cache, K3q on a pair): one launch a call, the cells of a KV head split over
a thread block cluster whose size `decode_attn_plan` chooses, the scores
and P.V on the tensor cores with exact bf16 hi + lo operands, the ranks'
states combined through distributed shared memory (no scratch, output
bit-identical from launch to launch). flash_prefill (T > 8) launches
csrc/flash_prefill.cu (K4, K4q), a library of its own: the wgmma kernel
whose operands are the same exact splits of k*cos, k*sin and p, at any G.
Both take the plain version for CPU tensors.

The kernels take head dims Dk (of q, K, cos and sin) and Dv (of V and the
output) that are multiples of 8 up to 256, as the reference's flash gate
does (any multiple of 8). Dk = Dv <= 128 (on the int8 cache a multiple of
16, its rows' TMA pitch) runs the narrow kernels, which hold a block as 128
dims, the columns past D arriving from TMA as zeros. Everything else, Dk !=
Dv (MLA's 192/128), heads past 128 (gemma's 256) and int8 rows whose pitch
is no multiple of 16 bytes (D = 72, 136: 8 mod 16), runs the wide kernels
(LAUNCHES "K3w", "K3qw", "K4w", "K4qw"): the same arithmetic over
128-dim chunks, int8 rows of such a pitch brought by 8-byte cp.async. The
wide K4/K4q's CTA owns 128 query rows over ceil(max(Dk, Dv) / 128) chunks
and splits a KV head's cells over a thread block cluster where the row
tiles leave SMs idle (`wide_prefill_plan`, which a CPU test holds against
the kernel's budgets). Heads past 256 are refused here;
models/transformer.py's flash_route sends them to the unfused attention on
either device.

softcap > 0 (gemma2's attention logit cap, pallas_attn.py's `softcap`):
each score becomes cap * tanh(score * scale / cap) before the bias is added.
A capped prefill step whose heads the narrow kernels take (Gemma-2-27B's
128) runs their capped instantiations (LAUNCHES "K4_cap", "K4q_cap"),
kernels of their own, so that the uncapped narrow kernels keep their
machine code; any other capped prefill step runs the wide ones' ("K4w_cap",
"K4qw_cap"), and every capped decode step the wide decode kernels'
("K3w_cap", "K3qw_cap"), whatever its head dims. The kernels take tanhf,
not tanh.approx.f32, whose ~2^-11 relative error would reach ~2% of a
weight at cap 50.

ALiBi (alibi_slopes f32 [H] with the positions tok_pos [T] and cell_pos
[S]; pallas_attn.py's `alibi_slopes` / `dist`, dist = tok_pos - cell_pos,
Baichuan-13B's and refact's): each score becomes s * scale - slope_h *
(tok_pos[t] - cell_pos[s]) before the bias is added. The difference is
taken in f32 from f32 positions, exact for integer positions below 2^24.
Every ALiBi model runs rope NONE, and the ALiBi kernels fold no rope: an
ALiBi call passes q_rot, cos and sin as None, and a call with rope tables
takes no ALiBi. The narrow kernels' ALiBi instantiations take it (LAUNCHES
"K3_alibi", "K3q_alibi", "K4_alibi", "K4q_alibi"): flash_decode_tc_alibi
and flash_prefill_wgmma_alibi at D = 128 and at any other narrow D at run
time, so that every existing kernel keeps its machine code. The wide and
capped kernels take no ALiBi (no ALiBi model of the reference has a head
past 128 or a softcap): models/transformer.py's flash_route sends such a
step to the unfused attention on either device, and the launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..device import full_f32
from . import cuda_build
from .cuda_qmm import sm_count
from .rope import ROPE_TYPE_NEOX, ROPE_TYPE_NONE, ROPE_TYPE_NORM

NEG = -1e30
T_CHUNK = 64  # query rows per step of attn_plain, to bound its score tensor
LAUNCHES = {"K3": 0, "K4": 0, "K3q": 0, "K4q": 0, "K3w": 0, "K4w": 0, "K3qw": 0, "K4qw": 0,
            "K3w_cap": 0, "K4w_cap": 0, "K3qw_cap": 0, "K4qw_cap": 0, "K4_cap": 0, "K4q_cap": 0,
            "K3_alibi": 0, "K4_alibi": 0, "K3q_alibi": 0, "K4q_alibi": 0}
# the K3/K3q launches (narrow, wide, capped and ALiBi) by T, the query rows of the call
DECODE_LAUNCHES_BY_T: dict[int, int] = {}
# K3/K3q (csrc/flash_attn.cu): a CTA walks blocks of 64 cells and holds up
# to 32 query rows of one KV head (past 32, more row chunks, each reading K
# and V again); T <= 8 (the bias rows of a stage); the CTAs of a thread
# block cluster (at most the portable 8) split a head's blocks.
# decode_attn_plan's rule, fitted to a sweep of the cluster size at the
# LLAMA3_8B decode shapes on an H100 (tools/attn_splits.py, PERF.md): one CTA
# an SM (a CTA holds ~200 KB of shared memory), up to 8 a cluster. Clusters
# of 12 and 16 lost to 8 at every swept shape: a cluster of 16 such CTAs
# needs 16 free SMs of one GPC, which not every GPC of the card has.
DECODE_BLOCK, DECODE_ROWS, DECODE_MAX_T, DECODE_MAX_CLUSTER = 64, 32, 8, 8
WIDE_ROWS = 16  # the wide K3/K3q: query rows a CTA
NARROW_HEAD_DIM = 128  # the head dims a narrow kernel's block holds
MAX_HEAD_DIM = 256  # the wide kernels: two 128-dim chunks
# the wide K4/K4q (csrc/flash_prefill.cu): query rows a CTA (64 a consumer
# warpgroup), cells a block, the largest cluster that splits a head's cells
WIDE_PREFILL_ROWS, WIDE_PREFILL_BLOCK, WIDE_PREFILL_MAX_SPLIT = 128, 32, 8
SMEM_PER_CTA = 232448  # the H100's 227 KB of shared memory a block


def head_dim_ok(d: int) -> bool:
    """Whether the flash kernels take head dim d (Dk or Dv): a multiple of
    8 up to MAX_HEAD_DIM."""
    return 0 < d <= MAX_HEAD_DIM and d % 8 == 0


def is_narrow(dk: int, dv: int, q8: bool) -> bool:
    """Whether (Dk, Dv) runs the narrow kernels: Dk = Dv <= 128, on the
    int8 cache a multiple of 16 (the rows' TMA pitch). Else the wide ones."""
    return dk == dv and dk <= NARROW_HEAD_DIM and dk % (16 if q8 else 8) == 0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    DECODE_LAUNCHES_BY_T.clear()


def dequant_bf16(kv) -> torch.Tensor:
    """A cache plane as f32: a q8_0 pair as bf16(q) * bf16(s), rounded to
    bf16 (the TPU kernel's dequant), a tensor as it is."""
    if isinstance(kv, tuple):
        q8, sc = kv
        return (q8.to(torch.bfloat16) * sc.to(torch.bfloat16)).float()
    return kv.float()


def attn_plain(q, q_rot, k, v, cos, sin, bias, scale: float,
               softcap: float = 0.0, alibi_slopes=None, tok_pos=None,
               cell_pos=None) -> torch.Tensor:
    """q, q_rot [T, H, Dk]; k [Hkv, S, Dk], v [Hkv, S, Dv], or (int8,
    scales [Hkv, S, 1]) pairs; cos, sin [S, Dk], or q_rot, cos and sin all
    None (no rope); bias [T, S]; alibi_slopes [H] with tok_pos [T] and
    cell_pos [S], or None. Returns [T, H, Dv] f32. Chunked over T to bound
    the score tensor. The score is (q.kc + q_rot.ks) * scale (no rope:
    q.k * scale), then cap * tanh(s / cap) where softcap > 0, then -
    slope_h * (tok_pos[t] - cell_pos[s]) (ALiBi), then + max(bias, -1e30):
    the reference kernel's order."""
    T, H, D = q.shape
    kf = dequant_bf16(k)
    vf = dequant_bf16(v)
    Hkv, S, Dv = vf.shape
    G = H // Hkv
    roped = cos is not None
    kc = kf * cos.float()[None] if roped else kf  # [Hkv, S, D]
    ks = kf * sin.float()[None] if roped else None
    dist = (tok_pos.float()[:, None] - cell_pos.float()[None, :]
            if alibi_slopes is not None else None)
    outs = []
    with full_f32():
        for t0 in range(0, T, T_CHUNK):
            t1 = min(T, t0 + T_CHUNK)
            qh = q[t0:t1].float().reshape(t1 - t0, Hkv, G, D).permute(1, 0, 2, 3)
            sc = torch.einsum("htgd,hsd->htgs", qh, kc)
            if roped:
                qrh = q_rot[t0:t1].float().reshape(t1 - t0, Hkv, G, D).permute(1, 0, 2, 3)
                sc = sc + torch.einsum("htgd,hsd->htgs", qrh, ks)
            sc = sc * scale
            if softcap > 0.0:
                sc = torch.tanh(sc / softcap) * softcap
            if dist is not None:
                sl = alibi_slopes.float().reshape(Hkv, 1, G, 1)
                sc = sc - sl * dist[t0:t1][None, :, None, :]
            sc = sc + torch.clamp(bias[t0:t1].float(), min=NEG)[None, :, None, :]
            m = torch.clamp(sc.amax(dim=-1, keepdim=True), min=NEG)
            p = torch.exp(sc - m)
            l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
            o = torch.einsum("htgs,hsd->htgd", p, vf) / l  # [Hkv, t, G, Dv]
            outs.append(o.permute(1, 0, 2, 3).reshape(t1 - t0, H, Dv))
    return torch.cat(outs, dim=0)


def _lib():
    lib = cuda_build.load("flash_attn")
    if lib.flash_decode_launch.argtypes is None:
        lib.flash_decode_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_decode_launch.restype = ctypes.c_int
        lib.flash_decode_q8_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_decode_q8_launch.restype = ctypes.c_int
        lib.flash_decode_wide_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_decode_wide_launch.restype = ctypes.c_int
        lib.flash_decode_wide_q8_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_decode_wide_q8_launch.restype = ctypes.c_int
        lib.flash_decode_alibi_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_decode_alibi_launch.restype = ctypes.c_int
        lib.flash_decode_q8_alibi_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_decode_q8_alibi_launch.restype = ctypes.c_int
    return lib


def _prefill_lib():
    lib = cuda_build.load("flash_prefill")
    if lib.flash_prefill_launch.argtypes is None:
        lib.flash_prefill_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_prefill_launch.restype = ctypes.c_int
        lib.flash_prefill_q8_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_prefill_q8_launch.restype = ctypes.c_int
        lib.flash_prefill_wide_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_prefill_wide_launch.restype = ctypes.c_int
        lib.flash_prefill_wide_q8_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_prefill_wide_q8_launch.restype = ctypes.c_int
        lib.flash_prefill_cap_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.flash_prefill_cap_launch.restype = ctypes.c_int
        lib.flash_prefill_q8_cap_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.flash_prefill_q8_cap_launch.restype = ctypes.c_int
        lib.flash_prefill_alibi_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_prefill_alibi_launch.restype = ctypes.c_int
        lib.flash_prefill_q8_alibi_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_prefill_q8_alibi_launch.restype = ctypes.c_int
        lib.flash_prefill_wide_clusters.argtypes = [ctypes.c_int] * 3
        lib.flash_prefill_wide_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _wide_clusters(q8: bool, chunks: int, split: int) -> int:
    """The clusters of `split` wide K4/K4q CTAs the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    n = _prefill_lib().flash_prefill_wide_clusters(int(q8), chunks, split)
    if n < 0:
        cuda_build.check(-n, "flash_prefill_wide_clusters")
    return n


def _check_inputs(q, q_rot, k, v, cos, sin, bias, kv_dtype=torch.bfloat16):
    """Checks every input of a flash kernel; k, v are tensors of kv_dtype;
    q_rot, cos and sin all tensors, or all None (no rope). Returns (T, H,
    Hkv, S, Dk, Dv)."""
    T, H, D = q.shape
    Hkv, S, Dv = v.shape
    if not head_dim_ok(D) or not head_dim_ok(Dv) or H % Hkv:
        raise ValueError(f"flash kernels take Dk and Dv that are multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, and H % Hkv == 0 "
                         f"(got Dk={D}, Dv={Dv}, H={H}, Hkv={Hkv})")
    rope = (("q_rot", q_rot, (T, H, D)), ("cos", cos, (S, D)), ("sin", sin, (S, D)))
    if any(t is None for _, t, _ in rope) and any(t is not None for _, t, _ in rope):
        raise ValueError("flash kernel: q_rot, cos and sin are all given or all None")
    for name, t, dt in (("q", q, torch.bfloat16), ("k", k, kv_dtype), ("v", v, kv_dtype),
                        ("bias", bias, torch.float32),
                        *((n, t, torch.bfloat16) for n, t, _ in rope if t is not None)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"flash kernel: {name} must be a contiguous CUDA {dt}")
    if tuple(k.shape) != (Hkv, S, D) or tuple(bias.shape) != (T, S) \
            or any(t is not None and tuple(t.shape) != shape for _, t, shape in rope):
        raise ValueError("flash kernel: inconsistent shapes")
    return T, H, Hkv, S, D, Dv


def _check_q8(q, q_rot, k, v, cos, sin, bias):
    """As _check_inputs for (int8, bf16 scales [Hkv, S, 1]) pairs."""
    if not (isinstance(k, tuple) and isinstance(v, tuple) and len(k) == len(v) == 2):
        raise ValueError("q8 flash kernel: k and v must be (int8, scales) pairs")
    (kq, ks), (vq, vs) = k, v
    dims = _check_inputs(q, q_rot, kq, vq, cos, sin, bias, torch.int8)
    Hkv, S = dims[2], dims[3]
    for name, t in (("k scales", ks), ("v scales", vs)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or tuple(t.shape) != (Hkv, S, 1):
            raise ValueError(f"q8 flash kernel: {name} must be a contiguous CUDA "
                             f"bf16 [{Hkv}, {S}, 1] tensor (one scale per head row), "
                             f"got {t.dtype} {tuple(t.shape)}")
    return dims


def _check_alibi(alibi_slopes, tok_pos, cell_pos, roped: bool, T: int, H: int, S: int,
                 narrow: bool, softcap: float) -> bool:
    """Whether a launch runs ALiBi: alibi_slopes, tok_pos and cell_pos all
    given (f32 [H], [T] and [S], contiguous and 16-byte aligned on the
    card) or none. The ALiBi kernels fold no rope (roped: q_rot, cos and
    sin were given), the others need the tables; only the narrow, uncapped
    kernels take ALiBi."""
    named = (("alibi_slopes", alibi_slopes, (H,)), ("tok_pos", tok_pos, (T,)),
             ("cell_pos", cell_pos, (S,)))
    given = [t is not None for _, t, _ in named]
    if any(given) and not all(given):
        raise ValueError("flash kernel: ALiBi takes alibi_slopes, tok_pos and cell_pos")
    if roped == any(given):
        raise ValueError("flash kernel: an ALiBi call passes q_rot, cos and sin as None (its "
                         "kernels fold no rope: every ALiBi model runs rope NONE), any other "
                         "call passes them")
    if not any(given):
        return False
    for name, t, shape in named:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != shape or t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} must be a contiguous, 16-byte aligned "
                             f"CUDA f32 {list(shape)} tensor, got {t.dtype} {tuple(t.shape)}")
    if not narrow or softcap > 0.0:
        raise ValueError("flash kernel: ALiBi runs the narrow, uncapped kernels only "
                         "(models/transformer.py's flash_route sends other shapes to the "
                         "unfused attention)")
    return True


def decode_attn_plan(T: int, H: int, Hkv: int, S: int, n_sm: int,
                     rows: int = DECODE_ROWS) -> tuple[int, int, int]:
    """K3/K3q's grid for T query tokens of H heads over Hkv KV heads and S
    cells on n_sm SMs: (cluster size, blocks of 64 cells a CTA, row chunks).
    A KV head's T*G rows are one chunk up to `rows` (32 for the narrow
    kernel, in one, two or four n8 tiles; WIDE_ROWS for the wide one), else
    chunks of `rows`. The cluster is as many CTAs as put one on every SM,
    at most DECODE_MAX_CLUSTER and one a block; then the fewest that
    give each CTA the same number of blocks, so none is left without one.
    CTA `rank` takes blocks [rank * per, (rank + 1) * per), per =
    ceil(blocks / cluster) as the kernel computes it."""
    R = T * (H // Hkv)
    chunks = -(-R // rows)
    nblk = -(-S // DECODE_BLOCK)
    target = max(1, min(DECODE_MAX_CLUSTER, nblk, n_sm // (Hkv * chunks)))
    cluster = -(-nblk // -(-nblk // target))
    return cluster, -(-nblk // cluster), chunks


def wide_prefill_chunks(dk: int, dv: int) -> int:
    """The 128-dim chunks of the wide K4/K4q at (Dk, Dv): one where both
    are at most 128 (no dead chunk), else two."""
    return 1 if max(dk, dv) <= NARROW_HEAD_DIM else 2


def wide_prefill_smem(chunks: int) -> dict:
    """The wide K4/K4q CTA's dynamic shared memory at `chunks` chunks, in
    bytes, as csrc/flash_prefill.cu's WideSmem lays it out: q and q_rot of
    the 128 rows (two chunks only: one chunk holds them in registers), the
    ring of planes slots (one (block, chunk) item's four K-side planes,
    [32 cells][128 dims] bf16 each, its raw inputs landing in it) and of V
    slots (a block's V, [chunks][32 cells][128 dims] bf16), and 1024 to
    align. The S split's partials (O f32 [128][chunks * 128], m and l, and
    every rank's m and l) reuse the ring."""
    q = 0 if chunks == 1 else 2 * 2 * chunks * 2 * 64 * 128
    slots = 4 if chunks == 1 else 2
    plane_slot = 4 * WIDE_PREFILL_BLOCK * 128 * 2
    v_slot = chunks * WIDE_PREFILL_BLOCK * 128 * 2
    partials = (WIDE_PREFILL_ROWS * chunks * 128 * 4 + 2 * WIDE_PREFILL_ROWS * 4
                + 2 * WIDE_PREFILL_MAX_SPLIT * WIDE_PREFILL_ROWS * 4)
    ring = q + slots * plane_slot + slots * v_slot
    return dict(q=q, planes_slots=slots, v_slots=slots, plane_slot=plane_slot, v_slot=v_slot,
                partials=partials, total=ring + 1024)


def wide_prefill_plan(T: int, H: int, Hkv: int, S: int, dk: int, dv: int,
                      n_sm: int, clusters=None) -> dict:
    """The wide K4/K4q's launch for T query tokens of H heads over Hkv KV
    heads and S cells on n_sm SMs: a CTA owns WIDE_PREFILL_ROWS rows r = t*G
    + g of one KV head (grid ceil(T*G/128) tiles x Hkv) over `chunks`
    128-dim chunks, and a thread block cluster of `split` CTAs splits the
    head's 32-cell blocks where the tiles leave SMs idle: as many as put one
    CTA on every SM, at most WIDE_PREFILL_MAX_SPLIT and one a block, and no
    more than let every cluster run at once (clusters(split): the clusters
    of that size the card holds, cudaOccupancyMaxActiveClusters on the
    card; None: n_sm // split, one CTA an SM), then the fewest that give
    each CTA the same number of blocks (each then takes `blocks_per_cta`,
    the last at least one). No scratch in global memory: the ranks meet in
    distributed shared memory."""
    tiles = -(-T * (H // Hkv) // WIDE_PREFILL_ROWS)
    nblk = -(-S // WIDE_PREFILL_BLOCK)
    clusters = clusters or (lambda s: n_sm // s)
    target = max(1, min(WIDE_PREFILL_MAX_SPLIT, nblk, n_sm // (tiles * Hkv)))
    while target > 1 and clusters(target) < tiles * Hkv:
        target -= 1
    split = -(-nblk // -(-nblk // target))
    chunks = wide_prefill_chunks(dk, dv)
    return dict(rows=WIDE_PREFILL_ROWS, cells=WIDE_PREFILL_BLOCK, chunks=chunks, split=split,
                blocks_per_cta=-(-nblk // split), ctas=tiles * Hkv * split,
                smem_bytes=wide_prefill_smem(chunks)["total"], scratch_bytes=0)


def _check_decode(T, *tensors):
    """What K3/K3q take beyond _check_inputs: T <= 8 and 16-byte aligned
    tensors (TMA and 16-byte loads)."""
    if not 1 <= T <= DECODE_MAX_T:
        raise ValueError(f"flash_decode kernel takes 1 <= T <= {DECODE_MAX_T}, got {T}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("flash_decode kernel: every tensor must start 16-byte aligned")


def _launch_ptrs(q, q_rot, planes, cos, sin, bias, alibi_slopes, tok_pos, cell_pos,
                 out) -> list[int]:
    """The launcher's pointers in its order: q, q_rot, the planes, cos,
    sin, bias, out; an ALiBi launcher's q, the planes, bias, the slopes,
    tok_pos, cell_pos, out (no rope)."""
    if alibi_slopes is None:
        ts = (q, q_rot, *planes, cos, sin, bias, out)
    else:
        ts = (q, *planes, bias, alibi_slopes, tok_pos, cell_pos, out)
    return [t.data_ptr() for t in ts]


def _decode_launch(q8: bool, q, q_rot, k, v, cos, sin, bias, scale: float,
                   cluster=None, softcap: float = 0.0, alibi_slopes=None,
                   tok_pos=None, cell_pos=None) -> torch.Tensor:
    """Launch K3 (bf16 k, v) or K3q (q8: (int8, scales) pairs), narrow or
    wide by is_narrow (wide and capped where softcap > 0; the narrow ALiBi
    instantiation with alibi_slopes, tok_pos and cell_pos, q_rot, cos and
    sin None), with `cluster` CTAs a KV head (None: decode_attn_plan's).
    Returns [T, H, Dv] f32."""
    T, H, Hkv, S, Dk, Dv = (_check_q8 if q8 else _check_inputs)(q, q_rot, k, v, cos, sin, bias)
    planes = (*k, *v) if q8 else (k, v)
    _check_decode(T, *(t for t in (q, q_rot, *planes, cos, sin, bias) if t is not None))
    narrow = is_narrow(Dk, Dv, q8) and softcap <= 0.0  # every capped step runs wide
    alibi = _check_alibi(alibi_slopes, tok_pos, cell_pos, cos is not None, T, H, S, narrow,
                         softcap)
    if cluster is None:
        cluster = decode_attn_plan(T, H, Hkv, S, sm_count(q.device),
                                   DECODE_ROWS if narrow else WIDE_ROWS)[0]
    out = torch.empty((T, H, Dv), dtype=torch.float32, device=q.device)
    ptrs = _launch_ptrs(q, q_rot, planes, cos, sin, bias, alibi_slopes, tok_pos, cell_pos, out)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if narrow:
        name = ("flash_decode_q8" if q8 else "flash_decode") + ("_alibi" if alibi else "") \
            + "_launch"
        rc = getattr(lib, name)(*ptrs, T, H, Hkv, S, Dk, float(scale), int(cluster), stream)
    else:
        name = "flash_decode_wide_q8_launch" if q8 else "flash_decode_wide_launch"
        rc = getattr(lib, name)(*ptrs, T, H, Hkv, S, Dk, Dv, float(scale),
                                max(float(softcap), 0.0), int(cluster), stream)
    cuda_build.check(rc, name)
    LAUNCHES[decode_kernel(Dk, Dv, q8, softcap, alibi)] += 1
    DECODE_LAUNCHES_BY_T[T] = DECODE_LAUNCHES_BY_T.get(T, 0) + 1
    return out


def _kernel_name(base: str, q8: bool, narrow: bool, softcap: float,
                 alibi: bool = False) -> str:
    """The LAUNCHES key of a launch: K3/K4, q on the int8 cache, w on the
    wide kernels, _cap on the capped instantiations, _alibi on the narrow
    kernels' ALiBi ones."""
    return (base + ("q" if q8 else "") + ("" if narrow else "w")
            + ("_cap" if softcap > 0.0 else "") + ("_alibi" if alibi else ""))


def flash_decode_cuda(q, q_rot, k, v, cos, sin, bias, scale: float, softcap: float = 0.0,
                      alibi_slopes=None, tok_pos=None, cell_pos=None) -> torch.Tensor:
    """K3 on a bf16 cache."""
    return _decode_launch(False, q, q_rot, k, v, cos, sin, bias, scale, softcap=softcap,
                          alibi_slopes=alibi_slopes, tok_pos=tok_pos, cell_pos=cell_pos)


def flash_decode_q8_cuda(q, q_rot, k, v, cos, sin, bias, scale: float, softcap: float = 0.0,
                         alibi_slopes=None, tok_pos=None, cell_pos=None) -> torch.Tensor:
    """K3q: K3 on (int8, scales [Hkv, S, 1]) pairs."""
    return _decode_launch(True, q, q_rot, k, v, cos, sin, bias, scale, softcap=softcap,
                          alibi_slopes=alibi_slopes, tok_pos=tok_pos, cell_pos=cell_pos)


def prefill_kernel(dk: int, dv: int, q8: bool, softcap: float, alibi: bool = False) -> str:
    """The LAUNCHES key of a K4/K4q step: the narrow kernels where
    is_narrow (their capped instantiations K4_cap / K4q_cap where softcap >
    0, their ALiBi ones with alibi), else the wide ones (K4w, K4qw, capped
    K4w_cap, K4qw_cap). Every shape goes to exactly one kernel."""
    return _kernel_name("K4", q8, is_narrow(dk, dv, q8), softcap, alibi)


def decode_kernel(dk: int, dv: int, q8: bool, softcap: float, alibi: bool = False) -> str:
    """The LAUNCHES key of a K3/K3q step: the narrow kernels where
    is_narrow and uncapped (their ALiBi ones with alibi), else the wide
    ones; every capped step the wide ones' capped instantiations."""
    return _kernel_name("K3", q8, is_narrow(dk, dv, q8) and softcap <= 0.0, softcap, alibi)


def _prefill_launch(q8: bool, q, q_rot, k, v, cos, sin, bias, scale: float,
                    softcap: float = 0.0, alibi_slopes=None, tok_pos=None,
                    cell_pos=None, split=None) -> torch.Tensor:
    """Launch K4 (bf16 k, v) or K4q (q8: (int8, scales) pairs), narrow or
    wide by is_narrow (the narrow capped instantiation where softcap > 0 and
    the heads are narrow; the narrow ALiBi instantiation with alibi_slopes,
    tok_pos and cell_pos, q_rot, cos and sin None), any G = H / Hkv. The
    wide kernel's cluster is `split` CTAs a row tile (None:
    wide_prefill_plan's). Returns [T, H, Dv] f32."""
    T, H, Hkv, S, Dk, Dv = (_check_q8 if q8 else _check_inputs)(q, q_rot, k, v, cos, sin, bias)
    planes = (*k, *v) if q8 else (k, v)
    narrow = is_narrow(Dk, Dv, q8)
    alibi = _check_alibi(alibi_slopes, tok_pos, cell_pos, cos is not None, T, H, S, narrow,
                         softcap)
    out = torch.empty((T, H, Dv), dtype=torch.float32, device=q.device)
    ptrs = _launch_ptrs(q, q_rot, planes, cos, sin, bias, alibi_slopes, tok_pos, cell_pos, out)
    lib = _prefill_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cap = max(float(softcap), 0.0)
    if narrow and cap > 0.0:
        name = "flash_prefill_q8_cap_launch" if q8 else "flash_prefill_cap_launch"
        rc = getattr(lib, name)(*ptrs, T, H, Hkv, S, Dk, float(scale), cap, stream)
    elif narrow:
        name = ("flash_prefill_q8" if q8 else "flash_prefill") + ("_alibi" if alibi else "") \
            + "_launch"
        rc = getattr(lib, name)(*ptrs, T, H, Hkv, S, Dk, float(scale), stream)
    else:
        if split is None:
            chunks = wide_prefill_chunks(Dk, Dv)
            split = wide_prefill_plan(T, H, Hkv, S, Dk, Dv, sm_count(q.device),
                                      lambda s: _wide_clusters(q8, chunks, s))["split"]
        name = "flash_prefill_wide_q8_launch" if q8 else "flash_prefill_wide_launch"
        rc = getattr(lib, name)(*ptrs, T, H, Hkv, S, Dk, Dv, float(scale), cap, int(split),
                                stream)
    cuda_build.check(rc, name)
    LAUNCHES[prefill_kernel(Dk, Dv, q8, softcap, alibi)] += 1
    return out


def flash_prefill_cuda(q, q_rot, k, v, cos, sin, bias, scale: float, softcap: float = 0.0,
                       alibi_slopes=None, tok_pos=None, cell_pos=None) -> torch.Tensor:
    """K4 on a bf16 cache."""
    return _prefill_launch(False, q, q_rot, k, v, cos, sin, bias, scale, softcap,
                           alibi_slopes, tok_pos, cell_pos)


def flash_prefill_q8_cuda(q, q_rot, k, v, cos, sin, bias, scale: float, softcap: float = 0.0,
                          alibi_slopes=None, tok_pos=None, cell_pos=None) -> torch.Tensor:
    """K4q: K4 on (int8, scales [Hkv, S, 1]) pairs."""
    return _prefill_launch(True, q, q_rot, k, v, cos, sin, bias, scale, softcap,
                           alibi_slopes, tok_pos, cell_pos)


def flash_decode(q, q_rot, k, v, cos, sin, bias, scale: float, softcap: float = 0.0,
                 alibi_slopes=None, tok_pos=None, cell_pos=None) -> torch.Tensor:
    """K3, or K3q when k, v are (int8, scales) pairs (T <= 8); capped where
    softcap > 0; ALiBi with alibi_slopes [H], tok_pos [T] and cell_pos [S]
    (q_rot, cos and sin None). Returns [T, H, Dv] f32."""
    if q.is_cuda:
        fn = flash_decode_q8_cuda if isinstance(k, tuple) else flash_decode_cuda
        return fn(q, q_rot, k, v, cos, sin, bias, scale, softcap, alibi_slopes, tok_pos,
                  cell_pos)
    return attn_plain(q, q_rot, k, v, cos, sin, bias, scale, softcap, alibi_slopes, tok_pos,
                      cell_pos)


def flash_prefill(q, q_rot, k, v, cos, sin, bias, scale: float, softcap: float = 0.0,
                  alibi_slopes=None, tok_pos=None, cell_pos=None) -> torch.Tensor:
    """K4, or K4q on (int8, scales) pairs (T > 8), any T; capped where
    softcap > 0; ALiBi with alibi_slopes [H], tok_pos [T] and cell_pos [S]
    (q_rot, cos and sin None). Returns [T, H, Dv] f32."""
    if q.is_cuda:
        fn = flash_prefill_q8_cuda if isinstance(k, tuple) else flash_prefill_cuda
        return fn(q, q_rot, k, v, cos, sin, bias, scale, softcap, alibi_slopes, tok_pos,
                  cell_pos)
    return attn_plain(q, q_rot, k, v, cos, sin, bias, scale, softcap, alibi_slopes, tok_pos,
                      cell_pos)


def rope_companion(q: torch.Tensor, mode: int, n_dims: int | None = None) -> torch.Tensor:
    """q_rot such that R(p)k . q == (k*cos_p).q + (k*sin_p).q_rot.
    NEOX halves: [q_hi, -q_lo]; NORM pairs: [q1, -q0] interleaved. Dims
    past n_dims (partial rotary) get 0; mode NONE is all zeros."""
    if mode == ROPE_TYPE_NONE:
        return torch.zeros_like(q)
    d = q.shape[-1]
    nd = d if n_dims is None else n_dims
    if mode == ROPE_TYPE_NEOX:
        half = nd // 2
        rot = torch.cat([q[..., half:nd], -q[..., :half]], dim=-1)
    elif mode == ROPE_TYPE_NORM:
        rot = torch.stack([q[..., 1:nd:2], -q[..., 0:nd:2]], dim=-1).reshape(
            *q.shape[:-1], nd)
    else:
        raise ValueError(f"unsupported rope mode {mode}")
    if nd == d:
        return rot
    return torch.cat([rot, torch.zeros_like(q[..., nd:])], dim=-1)


def expand_tables(cos_h: torch.Tensor, sin_h: torch.Tensor, mode: int, d: int,
                  n_dims: int | None = None):
    """Half-width [S, n_dims/2] rope tables -> full-width [S, D] per layout;
    unrotated trailing dims get cos=1, sin=0; mode NONE gives all-ones cos
    and all-zeros sin."""
    if mode == ROPE_TYPE_NONE:
        shape = (*cos_h.shape[:-1], d)
        return (torch.ones(shape, dtype=cos_h.dtype, device=cos_h.device),
                torch.zeros(shape, dtype=sin_h.dtype, device=sin_h.device))
    nd = d if n_dims is None else n_dims
    ch, sh = cos_h[..., : nd // 2], sin_h[..., : nd // 2]
    if mode == ROPE_TYPE_NEOX:
        c, s = torch.cat([ch, ch], -1), torch.cat([sh, sh], -1)
    elif mode == ROPE_TYPE_NORM:
        c = torch.stack([ch, ch], -1).reshape(*ch.shape[:-1], nd)
        s = torch.stack([sh, sh], -1).reshape(*sh.shape[:-1], nd)
    else:
        raise ValueError(f"unsupported rope mode {mode}")
    if nd == d:
        return c, s
    return (torch.nn.functional.pad(c, (0, d - nd), value=1.0),
            torch.nn.functional.pad(s, (0, d - nd), value=0.0))
