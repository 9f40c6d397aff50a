"""The prefill GEMM (K1/K2 at B > 16, csrc/qmm_gemm.cuh) at each K split,
at the LLAMA3_8B Q4_K_M prefill shapes: what the cost constants of
ops/cuda_qmm.py::gemm_split are fitted to, and whether its pick is the
fastest. At B <= 16 the same for the decode GEMV (csrc/qmm_decode.cu),
whose K split is the size of the thread block cluster that shares a column
tile, and whose pick is ops/cuda_qmm.py::decode_plan's; with --gdot for K5,
the decode GEMV's group-factored kernel, on the p4 shapes. With --chain,
K6 (csrc/qmm_chain.cu) on the LLAMA3_8B chains: at each cluster size the
chain with ops/cuda_qmm_chain.py::chain_plan's splits for it and with each
phase's split moved to every other one the plan weighs, and each phase
alone (a one-phase chain that reads x as it is) at each cluster size and
split, beside the decode GEMV's launch on the same planes.

    python3 -m llm_tpu_torch.tools.gemm_splits [--B 512,128] [--splits 1,2,4,8,16]
    python3 -m llm_tpu_torch.tools.gemm_splits --B 1,8 --splits 1,2,4,8,12,16
    python3 -m llm_tpu_torch.tools.gemm_splits --gdot --B 1,8 --splits 1,2,3,4,6,8
    python3 -m llm_tpu_torch.tools.gemm_splits --chain --B 1,8

For each shape and row count: planes with bf16 scales made on the card
(enough copies to exceed the 50 MB L2, cycled, so that every launch reads
them from device memory; a chain's own planes, as chip_smoke.py times it),
each split launched once and held against its plain version (qmm_plain,
qmm_gdot_plain: 1e-3 of max|y|; qmm_chain_plain: 1e-2 of max|out|), then
timed with CUDA events around a CUDA graph of launches. The split the plan
picks is always among those timed; splits past K's 128-deep stages
(decode: past 16, or leaving a CTA without a stage) are skipped. Prints
the card's name and power limit, then one JSON line per shape (chain) and
row count: µs per split, and the plan's pick.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ..gguf.constants import GGMLType
from ..models.synthetic import device_synthetic_qtensor
from ..ops import cuda_qmm, cuda_qmm_chain
from .kbench import L2_BYTES, card, nbytes, time_ms

# the LLAMA3_8B Q4_K_M matmuls (name: K, N, type)
SHAPES = {"qkv": (4096, 6144, "Q4_K"), "attn_q/o_proj": (4096, 4096, "Q4_K"),
          "attn_k": (4096, 1024, "Q4_K"), "attn_v": (4096, 1024, "Q6_K"),
          "gate_up": (4096, 28672, "Q4_K"), "down": (14336, 4096, "Q4_K"),
          "down Q6_K": (14336, 4096, "Q6_K"), "lm_head Q6_K": (4096, 128256, "Q6_K"),
          "lm_head Q4_K": (4096, 128256, "Q4_K")}
# the prefill shapes, swept unless --shapes names others
PREFILL_SHAPES = tuple(k for k in SHAPES if not k.startswith("lm_head"))
# K5's shapes: every p4 matmul of the decode path and the gdot probes' head
GDOT_SHAPES = ("qkv", "attn_q/o_proj", "attn_k", "gate_up", "down", "lm_head Q4_K")
# the LLAMA3_8B chains K6 runs (name: phases (K, N, type), boundaries)
CHAINS = {
    "tail Q4_K down": (((4096, 4096, "Q4_K"), (4096, 28672, "Q4_K"), (14336, 4096, "Q4_K")),
                       ("cast", "res_norm", "swiglu")),
    "tail Q6_K down": (((4096, 4096, "Q4_K"), (4096, 28672, "Q4_K"), (14336, 4096, "Q6_K")),
                       ("cast", "res_norm", "swiglu")),
    "head qkv": (((4096, 6144, "Q4_K"),), ("norm",)),
    "lm_head Q6_K": (((4096, 128256, "Q6_K"),), ("norm",)),
}
REL_TOL = 1e-3  # chip_smoke.py::check_qmm's
CHAIN_REL_TOL = 1e-2  # chip_smoke.py::K6_REL_TOL


def sweep_shape(name: str, B: int, splits, seed: int = 0, gdot: bool = False) -> dict:
    K, N, qtype = SHAPES[name]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + K + N + B)
    first = device_synthetic_qtensor(gen, N, K, GGMLType[qtype])
    ncp = max(1, min(16, math.ceil(2 * L2_BYTES / nbytes(first.qs, first.scales, first.mins))))
    qts = [first] + [device_synthetic_qtensor(gen, N, K, GGMLType[qtype])
                     for _ in range(ncp - 1)]
    x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
    plain = cuda_qmm.qmm_gdot_plain if gdot else cuda_qmm.qmm_plain
    want = plain(x, qts[0], torch.bfloat16)
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
    rec = dict(shape=f"{name} {qtype} K={K} N={N} B={B}", kernel="K5" if gdot else None,
               pick=pick, us={})
    for sp in sorted({s for s in splits if ok(s)} | {pick}):
        err = (cuda_qmm._qmm_launch(x, qts[0], gdot, sp) - want).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{rec['shape']} split {sp}: max|err| {err} > {tol}")
        rec["us"][sp] = 1e3 * time_ms(lambda i: cuda_qmm._qmm_launch(x, qts[i], gdot, sp),
                                      ncp)
    if gdot:  # K1's decode GEMV at its own pick on the same planes
        rec["k1_us"] = 1e3 * time_ms(lambda i: cuda_qmm.qmm_cuda(x, qts[i]), ncp)
    return rec


def _chain_case(name: str, B: int, seed: int):
    """A chain's planes and inputs, made on the card as chip_smoke.py's
    check_chain makes them."""
    dims, pres = CHAINS[name]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + sum(n for _, n, _ in dims) + B)
    qts = [device_synthetic_qtensor(gen, n, k, GGMLType[t]) for k, n, t in dims]
    K0, N0 = dims[0][0], dims[0][1]
    bf = torch.bfloat16
    x = torch.randn((B, K0), generator=gen, device="cuda").to(bf)
    tail = pres[0] == "cast"
    x_res = torch.randn((B, N0), generator=gen, device="cuda").to(bf) if tail else None
    gamma = 1 + 0.2 * torch.randn(dims[1][0] if tail else K0, generator=gen, device="cuda")
    kw = dict(pres=pres, eps=1e-5, final="add_res" if tail else "cast",
              out_dtype=torch.float32 if N0 == 128256 else bf)
    return qts, x, x_res, gamma, kw


def sweep_chain(name: str, B: int, seed: int = 0) -> dict:
    """K6 on one chain, at each cluster size with chain_plan's splits for it
    and with each phase's split moved, each against qmm_chain_plain; each
    phase alone at each cluster size and split, beside the decode GEMV on
    its planes. "plan" is the launch's own pick."""
    qts, x, x_res, gamma, kw = _chain_case(name, B, seed)
    clusters = cuda_qmm_chain.chain_clusters()
    plan = cuda_qmm_chain.launch_plan(qts)
    want = cuda_qmm_chain.qmm_chain_plain(x, qts, (gamma,), x_res, **kw).float()
    tol = CHAIN_REL_TOL * want.abs().max().item()

    def chain_us(plan):
        run = (lambda i: cuda_qmm_chain._chain_launch(x, qts, (gamma,), x_res, plan=plan, **kw))
        err = (run(0).float() - want).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} B={B} plan {plan}: max|err| {err} > {tol}")
        return 1e3 * time_ms(run)

    key = (lambda c, sp, la: f"C={c} {list(sp)}" + (f" last {list(la)}" if la != sp else ""))
    rec = dict(chain=f"{name} B={B}", plan=[plan[0], list(plan[1]), list(plan[2])],
               clusters={str(c): q for c, q in clusters.items()}, us={}, phase_alone=[])
    units = [-(-qt.in_features // cuda_qmm.DECODE_UNIT_K) for qt in qts]
    for c, q in clusters.items():
        base = [cuda_qmm_chain._phase_plan(qt.in_features, qt.out_features, q, c)[1:]
                for qt in qts]
        splits, lasts = tuple(b[0] for b in base), tuple(b[1] for b in base)
        rec["us"][key(c, splits, lasts)] = chain_us((c, splits, lasts))
        if lasts != splits:
            rec["us"][key(c, splits, splits)] = chain_us((c, splits, splits))
        for p in range(len(qts)):
            for sp in cuda_qmm_chain._splits(units[p], c):
                if sp != splits[p]:
                    moved = splits[:p] + (sp,) + splits[p + 1:]
                    rec["us"][key(c, moved, moved)] = chain_us((c, moved, moved))
    rec["us"]["plan"] = rec["us"][key(*plan)]
    one = dict(pres=("cast",), eps=1e-5, final="cast", out_dtype=torch.bfloat16)
    for p, qt in enumerate(qts):
        # the phase alone: x as it is, bf16 out
        xp = torch.randn((B, qt.in_features), device="cuda").to(torch.bfloat16)
        ref = cuda_qmm.qmm_plain(xp, qt, torch.bfloat16)
        alone = {"decode_gemv": 1e3 * time_ms(
            lambda i: cuda_qmm.qmm_cuda(xp, qt, out_dtype=torch.bfloat16))}
        for c in clusters:
            for sp in cuda_qmm_chain._splits(units[p], c):
                run = (lambda i, c=c, sp=sp: cuda_qmm_chain._chain_launch(
                    xp, [qt], plan=(c, (sp,), (sp,)), **one))
                err = (run(0).float() - ref).abs().max().item()
                if not err <= CHAIN_REL_TOL * ref.abs().max().item():
                    raise AssertionError(f"{name} phase {p} alone C={c} split {sp}: "
                                         f"max|err| {err}")
                alone[f"C={c} split {sp}"] = 1e3 * time_ms(run)
        rec["phase_alone"].append(dict(K=qt.in_features, N=qt.out_features,
                                       type=qt.ggml_type.name, us=alone))
    return rec


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", default=None,
                    help="rows of x, comma-separated (default 512,128; --gdot, --chain: 1,8)")
    ap.add_argument("--splits", default="1,2,4,8,16")
    ap.add_argument("--shapes", default=None, help="shapes (chains with --chain), comma-separated")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--gdot", action="store_true", help="K5's cluster size at B <= 16")
    mode.add_argument("--chain", action="store_true", help="K6's splits on the LLAMA3_8B chains")
    args = ap.parse_args(argv)
    args.B = [int(v) for v in (args.B or ("1,8" if args.gdot or args.chain else "512,128"))
              .split(",")]
    args.splits = [int(v) for v in args.splits.split(",")]
    known = CHAINS if args.chain else SHAPES
    default = CHAINS if args.chain else (GDOT_SHAPES if args.gdot else PREFILL_SHAPES)
    args.shapes = args.shapes.split(",") if args.shapes else list(default)
    bad = [s for s in args.shapes if s not in known]
    if bad:
        ap.error(f"unknown shapes {bad}")
    if args.gdot and any(SHAPES[s][2] != "Q4_K" or b > cuda_qmm.GDOT_MAX_B
                         for s in args.shapes for b in args.B):
        ap.error(f"--gdot takes p4 shapes and B <= {cuda_qmm.GDOT_MAX_B}")
    if args.chain and any(b > cuda_qmm_chain.CHAIN_MAX_B for b in args.B):
        ap.error(f"--chain takes B <= {cuda_qmm_chain.CHAIN_MAX_B}")
    return args


def main(argv=None) -> None:
    args = parse(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_splits needs a CUDA device")
    print(f"card: {card()}", flush=True)
    for b in args.B:
        for name in args.shapes:
            rec = sweep_chain(name, b) if args.chain else \
                sweep_shape(name, b, args.splits, gdot=args.gdot)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
