"""S3: the flash-decode layout and q8 dequant probes. Counterpart of the TPU
package's timing probes scripts/kbench7.py (v1_stacked, v0_stacked: the
decode kernel over a head-major or a seq-major cache, the buffer of a stack
picked by an index on the device) and scripts/kbench9.py (_mk_kernel: the
q8 cache's dequant without the scale, in f32, or in bf16 as K3q does).

Each variant computes the decode function of K3 (cuda_attn.attn_plain) on
its own form of the cache:

    v1       k, v bf16 [NB, Hkv, S, D]; buffer lidx (int32 [1]) of the stack
    v0       k, v bf16 [NB, S, Hkv, D] (seq-major); buffer lidx, read as
             its transpose [Hkv, S, D]
    noscale  k, v (int8 [Hkv, S, D], bf16 scales [Hkv, S, 1]) pairs; K/V are
             the int8 values (the kernel loads the scales, applies none)
    full     the same pairs; K/V = q * s in f32
    bf16     the same pairs; K/V = bf16(q * s), K3q's dequant

`probe_plain` builds that K/V from its inputs alone (the buffer picked with
index_select, so the index never leaves the device) and calls attn_plain.
`probe_cuda` launches csrc/flash_probe.cu, the split-S decode body of
csrc/flash_decode.cuh (one CTA per S split, then a combine kernel; K3 and
K3q run csrc/flash_attn.cu's cluster kernel) on each variant's loader,
with the split size (cells per CTA) as a parameter and the body's own
choice as the default; it counts its launches in LAUNCHES["S3"].
`probe` takes the kernel for CUDA tensors and the plain version for CPU
tensors; on a CUDA tensor the kernel runs or raises.

The TPU script kbench7.py's v0 no longer runs (its shim hands the
head-major body a seq-major block on a 1-D grid); the port's v0 computes
what that script's docstring says, the production decode over a seq-major
cache, and is held against flash_decode on the transposed buffer.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_attn, cuda_build
from .cuda_qmm import sm_count

STACKED = ("v1", "v0")
Q8_MODES = {"noscale": 0, "full": 1, "bf16": 2}
VARIANTS = STACKED + tuple(Q8_MODES)
LAUNCHES = {"S3": 0}


def reset_launches() -> None:
    LAUNCHES["S3"] = 0


def _variant(variant: str) -> str:
    if variant not in VARIANTS:
        raise ValueError(f"S3 probe variant {variant!r} not in {VARIANTS}")
    return variant


def stack_buffer(variant: str, kv: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """Buffer lidx of a v1 or v0 stack as a head-major [Hkv, S, D] view."""
    buf = kv.index_select(0, lidx.reshape(1))[0]
    return buf if variant == "v1" else buf.transpose(0, 1)


def dense_kv(mode: str, kv) -> torch.Tensor:
    """A q8 mode's K or V as f32 [Hkv, S, D] from an (int8, scales) pair."""
    q8, sc = kv
    if mode == "noscale":
        return q8.float()
    if mode == "full":
        return q8.float() * sc.float()
    return cuda_attn.dequant_bf16(kv)


def probe_plain(variant, q, q_rot, k, v, cos, sin, bias, scale: float,
                lidx=None) -> torch.Tensor:
    """The variant's function in plain PyTorch: [T, H, D] f32."""
    if _variant(variant) in STACKED:
        if lidx is None:
            raise ValueError(f"S3 {variant}: a stacked cache needs its buffer index lidx")
        k, v = stack_buffer(variant, k, lidx), stack_buffer(variant, v, lidx)
    else:
        k, v = dense_kv(variant, k), dense_kv(variant, v)
    return cuda_attn.attn_plain(q, q_rot, k, v, cos, sin, bias, scale)


def tolerance(variant: str, want: torch.Tensor) -> float:
    """The bound on max|probe_cuda - probe_plain| on the card: 1e-3 of
    max|y| for the bf16 caches; K3q's 1e-3 for the q8 modes, relative where
    |y| exceeds 1 (noscale's outputs are the int8 values' scale)."""
    top = want.abs().max().item()
    return 1e-3 * (top if _variant(variant) in STACKED else max(1.0, top))


def _lib():
    lib = cuda_build.load("flash_probe")
    if lib.flash_probe_splits.argtypes is None:
        lib.flash_probe_splits.argtypes = [ctypes.c_int] * 6
        lib.flash_probe_splits.restype = ctypes.c_int
        tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.flash_probe_stacked_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + tail
        lib.flash_probe_stacked_launch.restype = ctypes.c_int
        lib.flash_probe_q8_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 13 + tail
        lib.flash_probe_q8_launch.restype = ctypes.c_int
    return lib


def _check_stacked(variant, q, q_rot, k, v, cos, sin, bias, lidx):
    """As cuda_attn._check_inputs, for bf16 stacks ([NB, Hkv, S, D] for v1,
    [NB, S, Hkv, D] for v0) and their buffer index, an int32 [1] on the card.
    Returns (T, H, Hkv, S)."""
    for name, t, dt in (("q", q, torch.bfloat16), ("q_rot", q_rot, torch.bfloat16),
                        ("k", k, torch.bfloat16), ("v", v, torch.bfloat16),
                        ("cos", cos, torch.bfloat16), ("sin", sin, torch.bfloat16),
                        ("bias", bias, torch.float32), ("lidx", lidx, torch.int32)):
        if not torch.is_tensor(t) or not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"S3 {variant}: {name} must be a contiguous CUDA {dt}")
    if k.dim() != 4 or k.shape != v.shape or lidx.numel() != 1:
        raise ValueError(f"S3 {variant}: k, v must be stacks of one shape and lidx one index "
                         f"(got {tuple(k.shape)}, {tuple(v.shape)}, {lidx.numel()})")
    T, H, D = q.shape
    _, a, b, Dk = k.shape
    Hkv, S = (a, b) if variant == "v1" else (b, a)
    if D != 128 or Dk != 128 or H % Hkv:
        raise ValueError(f"S3 {variant}: head_dim 128 and H % Hkv == 0 "
                         f"(got D={D}, Dk={Dk}, H={H}, Hkv={Hkv})")
    if tuple(q_rot.shape) != (T, H, D) or tuple(cos.shape) != (S, D) \
            or tuple(sin.shape) != (S, D) or tuple(bias.shape) != (T, S):
        raise ValueError(f"S3 {variant}: inconsistent shapes")
    return T, H, Hkv, S


def split_count(device, T: int, H: int, Hkv: int, S: int, split: int | None) -> int:
    """S splits of a probe launch: of `split` cells each, or the body's own
    choice (flash_decode.cuh's decode_splits) for None."""
    if split is not None and split < 1:
        raise ValueError(f"S3: split must be a positive number of cells, got {split}")
    return _lib().flash_probe_splits(S, Hkv, T, H, sm_count(device), split or 0)


def _scratch(q, T: int, H: int, Hkv: int, n_splits: int):
    """The split kernel's partials pm, pl [Hkv * T*G * n_splits] f32 and
    pacc [.., D] f32, and the output [T, H, D] f32."""
    rows = Hkv * T * (H // Hkv) * n_splits
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty(rows, **f32), torch.empty(rows, **f32), torch.empty((rows, 128), **f32),
            torch.empty((T, H, 128), **f32))


def probe_cuda(variant, q, q_rot, k, v, cos, sin, bias, scale: float, lidx=None,
               split: int | None = None) -> torch.Tensor:
    """Launch the variant's kernel: [T, H, D] f32. split: cells per CTA
    (None: the body's own choice)."""
    if _variant(variant) in STACKED:
        T, H, Hkv, S = _check_stacked(variant, q, q_rot, k, v, cos, sin, bias, lidx)
    else:
        T, H, Hkv, S, D, Dv = cuda_attn._check_q8(q, q_rot, k, v, cos, sin, bias)
        if D != 128 or Dv != 128:  # the split-S body holds 128 dims, as the TPU probes do
            raise ValueError(f"S3 {variant}: head_dim 128 (got Dk={D}, Dv={Dv})")
    lib = _lib()
    n_splits = split_count(q.device, T, H, Hkv, S, split)
    pm, pl, pacc, out = _scratch(q, T, H, Hkv, n_splits)
    tail = (out.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), T, H, Hkv, S,
            float(scale), n_splits, torch.cuda.current_stream(q.device).cuda_stream)
    if variant in STACKED:
        rc = lib.flash_probe_stacked_launch(
            int(variant == "v0"), q.data_ptr(), q_rot.data_ptr(), k.data_ptr(), v.data_ptr(),
            lidx.data_ptr(), cos.data_ptr(), sin.data_ptr(), bias.data_ptr(), *tail)
    else:
        (kq, ks), (vq, vs) = k, v
        rc = lib.flash_probe_q8_launch(
            Q8_MODES[variant], q.data_ptr(), q_rot.data_ptr(), kq.data_ptr(), ks.data_ptr(),
            vq.data_ptr(), vs.data_ptr(), cos.data_ptr(), sin.data_ptr(), bias.data_ptr(),
            *tail)
    cuda_build.check(rc, f"flash_probe ({variant})")
    LAUNCHES["S3"] += 1
    return out


def probe(variant, q, q_rot, k, v, cos, sin, bias, scale: float, lidx=None,
          split: int | None = None) -> torch.Tensor:
    """The probe by device: the kernel for CUDA tensors, the plain version
    (which has no split) for CPU tensors."""
    if q.is_cuda:
        return probe_cuda(variant, q, q_rot, k, v, cos, sin, bias, scale, lidx, split)
    return probe_plain(variant, q, q_rot, k, v, cos, sin, bias, scale, lidx)
