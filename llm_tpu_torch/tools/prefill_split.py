"""Where K4/K4q's time goes on the card: the wgmma flash prefill
(csrc/flash_prefill.cuh) timed whole and with one side of its ring alone,
at T=512 S=4096 H=32 Hkv=8 D=128 (a 512-token LLAMA3_8B prefill into a
cache of 4096 cells, half of it visible; chip_smoke.py's inputs):

  full       the library's kernel (cuda_attn.flash_prefill);
  producer   its producer warpgroup alone: TMA of the raw blocks and of V,
             the hi/lo planes built, every stage released unread;
  consumers  its two consumer warpgroups alone: the score and P.V chains and
             the softmax on whatever the stages hold, the producer only
             releasing stages.

--wide times the wide K4w / K4qw (csrc/flash_prefill_wide.cuh) the same
way at WIDE_SHAPES, phase 2's wide and capped rows of chip_smoke.py (the
same inputs, at the scale chip_smoke.py's check_attn gives them), each at
the split wide_prefill_plan picks, and the narrow capped K4_cap / K4q_cap
at Gemma-2-27B's heads.

The two parts are csrc/flash_prefill_probe.cu's kernels, built from the
checkout at first use. Each is timed with CUDA events over a CUDA graph of
--iters launches; the full kernel is first held against attn_plain
(max|err| <= 1e-3). Prints one JSON line with the card's name and power
limit. Exits nonzero without a card.

    python3 -m llm_tpu_torch.tools.prefill_split [--iters 50] [--wide]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys

import torch

from ..models.transformer import quantize_rows
from ..ops import cuda_attn, cuda_build
from .kbench import card, time_ms
from .kbench_attn import attn_inputs

PARTS = {"producer": 1, "consumers": 2}
SHAPE = dict(T=512, H=32, Hkv=8, S=4096, D=128)
SCALE = 128 ** -0.5
# (name, T, H, Hkv, S, Dk, Dv, q8, softcap): the wide rows of chip_smoke.py's
# phase 2 (Gemma-2-2B's 8 over 4 of 256, MLA's 192 / 128, Dk 128 / Dv 64,
# int8 at 72 and 136), the capped ones at Gemma-2-9B's heads, and the narrow
# capped ones at Gemma-2-27B's (32 over 16 of 128)
WIDE_SHAPES = (("K4w", 512, 8, 4, 4096, 256, 256, False, 0.0),
               ("K4w", 512, 16, 16, 4096, 192, 128, False, 0.0),
               ("K4w", 512, 32, 8, 4096, 128, 64, False, 0.0),
               ("K4qw", 512, 8, 4, 4096, 256, 256, True, 0.0),
               ("K4qw", 512, 32, 8, 4096, 72, 72, True, 0.0),
               ("K4qw", 512, 16, 8, 4096, 136, 136, True, 0.0),
               ("K4w_cap", 512, 16, 8, 4096, 256, 256, False, 50.0),
               ("K4qw_cap", 512, 16, 8, 4096, 256, 256, True, 50.0),
               ("K4_cap", 512, 32, 16, 4096, 128, 128, False, 50.0),
               ("K4q_cap", 512, 32, 16, 4096, 128, 128, True, 50.0))
CAP_SCORE_SCALE = 16.0  # chip_smoke.py's: the capped rows' scores, in units of Dk^-0.5


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_prefill_probe")
    if lib.flash_prefill_part_launch.argtypes is None:
        lib.flash_prefill_part_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.flash_prefill_part_launch.restype = ctypes.c_int
        lib.flash_prefill_wide_part_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_prefill_wide_part_launch.restype = ctypes.c_int
    return lib


def part_launcher(part: int, inp: dict, scale: float = SCALE, softcap: float = 0.0):
    """A closure that launches part `part` of K4 (K4q on q8_0 pairs; K4_cap,
    K4q_cap where softcap > 0) at D = 128 on inp, which the caller keeps,
    into an output of its own."""
    lib = _lib()
    q8 = isinstance(inp["k"], tuple)
    (kq, ks), (vq, vs) = (inp["k"], inp["v"]) if q8 else ((inp["k"], None), (inp["v"], None))
    T, H, D = inp["q"].shape
    Hkv, S, _ = vq.shape
    out = torch.empty((T, H, D), dtype=torch.float32, device="cuda")
    ptrs = [None if t is None else t.data_ptr() for t in (
        inp["q"], inp["q_rot"], kq, ks, vq, vs, inp["cos"], inp["sin"], inp["bias"], out)]

    def run(_i, _out=out):  # holds the output while launches may write it
        cuda_build.check(lib.flash_prefill_part_launch(
            part, int(q8), *ptrs, T, H, Hkv, S, scale, softcap,
            torch.cuda.current_stream().cuda_stream), "flash_prefill_part_launch")
    return run


def wide_part_launcher(part: int, inp: dict, scale: float, softcap: float):
    """As part_launcher for the wide kernel, at wide_prefill_plan's split."""
    lib = _lib()
    q8 = isinstance(inp["k"], tuple)
    (kq, ks), (vq, vs) = (inp["k"], inp["v"]) if q8 else ((inp["k"], None), (inp["v"], None))
    T, H, Dk = inp["q"].shape
    Hkv, S, Dv = vq.shape
    chunks = cuda_attn.wide_prefill_chunks(Dk, Dv)
    split = cuda_attn.wide_prefill_plan(
        T, H, Hkv, S, Dk, Dv, torch.cuda.get_device_properties(0).multi_processor_count,
        lambda s: cuda_attn._wide_clusters(q8, chunks, s))
    out = torch.empty((T, H, Dv), dtype=torch.float32, device="cuda")
    ptrs = [None if t is None else t.data_ptr() for t in (
        inp["q"], inp["q_rot"], kq, ks, vq, vs, inp["cos"], inp["sin"], inp["bias"], out)]

    def run(_i, _out=out):
        cuda_build.check(lib.flash_prefill_wide_part_launch(
            part, int(q8), *ptrs, T, H, Hkv, S, Dk, Dv, scale, softcap, split["split"],
            torch.cuda.current_stream().cuda_stream), "flash_prefill_wide_part_launch")
    return run


def wide_rows(iters: int) -> list[dict]:
    """Each WIDE_SHAPES row whole (held against attn_plain at 1e-3) and
    each side alone, in µs."""
    rows = []
    for name, T, H, Hkv, S, Dk, Dv, q8, cap in WIDE_SHAPES:
        inp, _ = attn_inputs(T, H, Hkv, S, Dk, seed=S + T, Dv=Dv)
        if q8:
            inp = {**inp, "k": quantize_rows(inp["k"], 1), "v": quantize_rows(inp["v"], 1)}
        scale = Dk ** -0.5 * (CAP_SCORE_SCALE if cap > 0 else 1.0)
        err = (cuda_attn.flash_prefill(**inp, scale=scale, softcap=cap)
               - cuda_attn.attn_plain(**inp, scale=scale, softcap=cap)).abs().max().item()
        if not (err <= 1e-3 and math.isfinite(err)):
            raise AssertionError(f"{name} T={T} H={H} Hkv={Hkv} Dk={Dk} Dv={Dv}: "
                                 f"max|err| {err} > 1e-3")
        rec = dict(kernel=name, shape=f"T={T} S={S} H={H} Hkv={Hkv} Dk={Dk} Dv={Dv} cap={cap:g}",
                   max_abs_err=err, full_us=time_ms(
                       lambda i: cuda_attn.flash_prefill(**inp, scale=scale, softcap=cap),
                       iters=iters) * 1e3)
        launcher = part_launcher if cuda_attn.is_narrow(Dk, Dv, q8) else wide_part_launcher
        for part_name, part in PARTS.items():
            rec[f"{part_name}_us"] = time_ms(launcher(part, inp, scale, cap), iters=iters) * 1e3
        rows.append(rec)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--wide", action="store_true", help="the wide kernel's rows")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prefill_split: no CUDA device", file=sys.stderr)
        return 2
    if args.wide:
        print(json.dumps(dict(card=card(), wide=wide_rows(args.iters))))
        return 0
    inp, _ = attn_inputs(**SHAPE, seed=0)
    rec = dict(card=card(), shape=SHAPE)
    for q8 in (False, True):
        x = {**inp, "k": quantize_rows(inp["k"], 1), "v": quantize_rows(inp["v"], 1)} \
            if q8 else inp
        kern = "K4q" if q8 else "K4"
        err = (cuda_attn.flash_prefill(**x, scale=SCALE)
               - cuda_attn.attn_plain(**x, scale=SCALE)).abs().max().item()
        if not (err <= 1e-3 and math.isfinite(err)):
            raise AssertionError(f"{kern}: max|err| {err} > 1e-3")
        us = {"full_us": time_ms(lambda i: cuda_attn.flash_prefill(**x, scale=SCALE),
                                 iters=args.iters) * 1e3}
        for name, part in PARTS.items():
            us[f"{name}_us"] = time_ms(part_launcher(part, x), iters=args.iters) * 1e3
        rec[kern] = dict(max_abs_err=err, **us)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
