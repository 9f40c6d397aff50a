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

The two parts are csrc/flash_prefill_probe.cu's kernels, built from the
checkout at first use. Each is timed with CUDA events over a CUDA graph of
--iters launches; the full kernel is first held against attn_plain
(max|err| <= 1e-3). Prints one JSON line with the card's name and power
limit. Exits nonzero without a card.

    python3 -m llm_tpu_torch.tools.prefill_split [--iters 50]
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


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_prefill_probe")
    if lib.flash_prefill_part_launch.argtypes is None:
        lib.flash_prefill_part_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_prefill_part_launch.restype = ctypes.c_int
    return lib


def part_launcher(part: int, inp: dict):
    """A closure that launches part `part` of K4 (K4q on q8_0 pairs) on inp,
    which the caller keeps, into an output of its own."""
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
            part, int(q8), *ptrs, T, H, Hkv, S, SCALE,
            torch.cuda.current_stream().cuda_stream), "flash_prefill_part_launch")
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prefill_split: no CUDA device", file=sys.stderr)
        return 2
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
