"""The prefill GEMM (K1/K2 at B > 16, csrc/qmm_gemm.cuh) at each K split,
at the LLAMA3_8B Q4_K_M prefill shapes: what the cost constants of
ops/cuda_qmm.py::gemm_split are fitted to, and whether its pick is the
fastest. At B <= 16 the same for the decode GEMV (csrc/qmm_decode.cu),
whose K split is the size of the thread block cluster that shares a column
tile, and whose pick is ops/cuda_qmm.py::decode_plan's.

    python3 -m llm_tpu_torch.tools.gemm_splits [--B 512,128] [--splits 1,2,4,8,16]
    python3 -m llm_tpu_torch.tools.gemm_splits --B 1,8 --splits 1,2,4,8,12,16

For each shape and row count: planes with bf16 scales made on the card
(enough copies to exceed the 50 MB L2, cycled, so that every launch reads
them from device memory), each split launched once and held against
qmm_plain at 1e-3 of max|y|, then timed with CUDA events around a CUDA
graph of launches. The split gemm_split (decode_plan) picks is always among
those timed; splits past K's 128-deep stages (decode: past 16, or leaving a
CTA without a stage) are skipped. Prints the card's name and
power limit, then one JSON line per shape and row count: µs per split, and
the split gemm_split picks.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ..gguf.constants import GGMLType
from ..models.synthetic import device_synthetic_qtensor
from ..ops import cuda_qmm
from .kbench import L2_BYTES, card, nbytes, time_ms

# the LLAMA3_8B Q4_K_M prefill matmuls (name: K, N, type)
SHAPES = {"qkv": (4096, 6144, "Q4_K"), "attn_q/o_proj": (4096, 4096, "Q4_K"),
          "attn_k": (4096, 1024, "Q4_K"), "attn_v": (4096, 1024, "Q6_K"),
          "gate_up": (4096, 28672, "Q4_K"), "down": (14336, 4096, "Q4_K"),
          "down Q6_K": (14336, 4096, "Q6_K"), "lm_head Q6_K": (4096, 128256, "Q6_K")}
# the prefill shapes, swept unless --shapes names others
PREFILL_SHAPES = tuple(k for k in SHAPES if k != "lm_head Q6_K")
REL_TOL = 1e-3  # chip_smoke.py::check_qmm's


def sweep_shape(name: str, B: int, splits, seed: int = 0) -> dict:
    K, N, qtype = SHAPES[name]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + K + N + B)
    first = device_synthetic_qtensor(gen, N, K, GGMLType[qtype])
    ncp = max(1, min(16, math.ceil(2 * L2_BYTES / nbytes(first.qs, first.scales, first.mins))))
    qts = [first] + [device_synthetic_qtensor(gen, N, K, GGMLType[qtype])
                     for _ in range(ncp - 1)]
    x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
    want = cuda_qmm.qmm_plain(x, qts[0], torch.bfloat16)
    tol = REL_TOL * want.abs().max().item()
    n_sm = cuda_qmm.sm_count(x.device)
    if B > cuda_qmm.GDOT_MAX_B:
        units = -(-K // cuda_qmm.GEMM_UNIT_K)
        pick = cuda_qmm.gemm_split(B, N, K, n_sm)
        ok = (lambda sp: sp <= units)
    else:
        units = -(-K // cuda_qmm.DECODE_UNIT_K)
        pick = cuda_qmm.decode_plan(K, N, B, n_sm, first.layout)[1]
        ok = (lambda sp: sp <= cuda_qmm.DECODE_MAX_CLUSTER
              and (sp - 1) * -(-units // sp) < units)
    rec = dict(shape=f"{name} {qtype} K={K} N={N} B={B}", pick=pick, us={})
    for sp in sorted({s for s in splits if ok(s)} | {pick}):
        err = (cuda_qmm._qmm_launch(x, qts[0], False, sp) - want).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{rec['shape']} split {sp}: max|err| {err} > {tol}")
        rec["us"][sp] = 1e3 * time_ms(lambda i: cuda_qmm._qmm_launch(x, qts[i], False, sp),
                                      ncp)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", default="512,128", help="rows of x, comma-separated")
    ap.add_argument("--splits", default="1,2,4,8,16")
    ap.add_argument("--shapes", default=",".join(PREFILL_SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_splits needs a CUDA device")
    print(f"card: {card()}", flush=True)
    splits = [int(v) for v in args.splits.split(",")]
    for b in (int(v) for v in args.B.split(",")):
        for name in args.shapes.split(","):
            print(json.dumps(sweep_shape(name, b, splits)), flush=True)


if __name__ == "__main__":
    main()
