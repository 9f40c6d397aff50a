"""Where decode time goes on the card: LLAMA3_8B with Q4_K_M-style random
planes, a 512-token prefill, then `--tokens` greedy tokens of
Context.generate_loop under torch.profiler, with a bf16 or a q8_0 KV cache,
on each of --paths: "unfused", "gdot" (the group-factored matmul K5),
"chain" (the chained kernel K6, with gdot) and "scan" (the scan decoder,
Context(scan_layers=True), K7 on stacked planes, on uniform planes: Q4_K
in every matmul and the lm_head, since a Q4_K_M mix does not stack).

    python3 -m llm_tpu_torch.tools.profile_decode [--tokens 16] [--kv-dtype q8_0]
        [--paths unfused,gdot,chain,scan]
    python3 llm_tpu_torch/tools/profile_decode.py --root <checkout> --paths unfused,scan

The paths run one after the other in one process. --root runs another checkout's
llm_tpu_torch (an older commit unpacked with git archive), so that two
versions can be profiled in turns, one process each, on one card: parent,
change, change, parent; the process first builds the kernels that decode
runs, in parallel.

Prints one JSON line a path: wall ms per token (host clock around
synchronized work), the device's busy and idle shares over that window
(kernel time summed from the profiler's CUDA events; one stream, so
kernels do not overlap), device launches per token (the profiler's
records; CUPTI can drop one now and then, so exact counts come from the
wrappers' own launch counters, also in the line), the decode GEMV's
(K1/K2/K7: every kernel named qmm_decode or qmm_gemv) ms and launches per
token, K5's alone (qmm_decode_gdot, or the older loop's qmm_gemv) and K6's
(qmm_chain), flash decode's (K3/K3q: every kernel named flash_decode, a
split-S kernel's combine among them) ms and launches per token and its
combine kernels per token, the memsets and the copy kernels (dtype casts among
them) per token, and device time per kernel name, largest first. Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PATHS = {"unfused": {}, "gdot": dict(gdot=True), "chain": dict(chain=True, gdot=True),
         "scan": dict(scan_layers=True)}
# kernel names of the decode GEMV of K1/K2/K7 (and, with gdot, K5's), and
# of flash decode (K3/K3q)
GEMV_NAMES = ("qmm_decode", "qmm_gemv")
# K5's kernels (an older checkout's: the qmm_gemv loop) and K6's
K5_NAMES, K6_NAME = ("qmm_decode_gdot", "qmm_gemv"), "qmm_chain"
ATTN_NAME = "flash_decode"
# the libraries decode runs (--root builds them in parallel first; the chain
# path also qmm_chain)
DECODE_LIBS = ("qmm", "qmm_stacked", "qmm_decode", "flash_attn", "flash_prefill")


def _span(e, skip) -> tuple[float, int]:
    """(device us, launches) of the kernels under a profiler event and its
    CPU children, the ranges named in skip aside (the profiler lists a
    range's own span on the card among its kernels)."""
    us = sum(k.duration for k in e.kernels if k.name not in skip)
    n = sum(k.name not in skip for k in e.kernels)
    for c in e.cpu_children:
        cu, cn = _span(c, skip)
        us, n = us + cu, n + cn
    return us, n


def _launch_counts() -> dict:
    """The kernel wrappers' launch counts (each wrapper adds one where it
    launches its kernel)."""
    from llm_tpu_torch.ops import cuda_attn, cuda_qmm, cuda_qmm_chain

    return {**cuda_qmm.LAUNCHES, **cuda_attn.LAUNCHES, **cuda_qmm_chain.LAUNCHES}


def profile_tokens(ctx, tok: int, n_tokens: int, ranges=()) -> dict:
    """Profile n_tokens greedy tokens of ctx.generate_loop from tok (the
    cache already holds the prompt). The numbers of the JSON line; and for
    each name in ranges (a torch.profiler.record_function range the caller
    wraps around some functions), the device ms and kernel launches per
    token of the work launched inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = _launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        toks = ctx.generate_loop(tok, n_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = {k: v - before.get(k, 0) for k, v in _launch_counts().items()}
    kernels, counts = {}, {}
    for e in prof.key_averages():
        if e.key in ranges:  # a range's span on the card, not a kernel
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA or (
                e.self_device_time_total > 0 and e.cpu_time_total == 0):
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
            counts[e.key] = counts.get(e.key, 0) + e.count
    busy_ms = sum(kernels.values())
    n = len(toks)
    gemv = [k for k in kernels if any(s in k for s in GEMV_NAMES)]
    k5 = [k for k in kernels if any(s in k for s in K5_NAMES)]
    k6 = [k for k in kernels if K6_NAME in k]
    attn = [k for k in kernels if ATTN_NAME in k]
    spans = {}
    for name in ranges:
        us, launched = 0.0, 0
        for e in prof.events():
            if e.name == name and e.device_type == torch.autograd.DeviceType.CPU:
                eu, en = _span(e, ranges)
                us, launched = us + eu, launched + en
        spans[f"{name}_ms_per_token"] = us / 1e3 / n
        spans[f"{name}_launches_per_token"] = launched / n
    return {**spans,
        "device": torch.cuda.get_device_name(0), "kv_dtype": str(ctx.kv_dtype),
        "chain": ctx.chain, "gdot": ctx.gdot, "scan": ctx.scan, "layers": ctx.cfg.n_layers,
        "tokens": n,
        "wall_ms_per_token": wall_ms / n, "device_busy_ms_per_token": busy_ms / n,
        "busy_share": busy_ms / wall_ms, "idle_share": 1 - busy_ms / wall_ms,
        "device_launches_per_token": sum(counts.values()) / n,
        "gemv_ms_per_token": sum(kernels[k] for k in gemv) / n,
        "gemv_launches_per_token": sum(counts[k] for k in gemv) / n,
        "k5_ms_per_token": sum(kernels[k] for k in k5) / n,
        "k5_launches_per_token": sum(counts[k] for k in k5) / n,
        "k6_ms_per_token": sum(kernels[k] for k in k6) / n,
        "k6_launches_per_token": sum(counts[k] for k in k6) / n,
        "attn_ms_per_token": sum(kernels[k] for k in attn) / n,
        "attn_launches_per_token": sum(counts[k] for k in attn) / n,
        "attn_combines_per_token": sum(counts[k] for k in attn if "combine" in k) / n,
        "counted_attn_launches_per_token": sum(v for k, v in counted.items()
                                               if k.startswith("K3")) / n,
        "counted_launches_per_token": {k: v / n for k, v in counted.items() if v},
        "memsets_per_token": sum(c for k, c in counts.items() if "memset" in k.lower()) / n,
        "qmm_gemv_launches_per_token": sum(c for k, c in counts.items() if "qmm_gemv" in k) / n,
        "copies_per_token": sum(c for k, c in counts.items() if "copy_kernel" in k) / n,
        "kernel_ms_per_token": {k: v / n for k, v in
                                sorted(kernels.items(), key=lambda kv: -kv[1])[:20]},
    }


def run_path(path: str, kv_dtype: str, tokens: int) -> dict:
    """One path's profile: planes made on the card (seed 2), the prompt,
    8 warm-up tokens, then `tokens` profiled ones."""
    import torch

    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import LLAMA3_8B, make_synthetic_model
    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context

    opts = PATHS[path]
    scan = opts.get("scan_layers", False)
    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=2, recipe=None if scan else "Q4_K_M", **LLAMA3_8B)
    ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg),
                  kv_dtype="q8_0" if kv_dtype == "q8_0" else None, **opts)
    del params
    if scan and not ctx.scan:
        raise SystemExit("the planes did not stack")
    prompt = [(i * 104729) % cfg.vocab_size for i in range(512)]
    assert ctx.decode(Batch.text(prompt)) == 0
    tok = ctx.generate_loop(int(ctx.get_logits().argmax()), 8)[-1]  # warm-up
    rec = dict(path=path, **profile_tokens(ctx, tok, tokens))
    del ctx
    torch.cuda.empty_cache()
    return rec


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="checkout whose llm_tpu_torch to run")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--kv-dtype", choices=("bf16", "q8_0"), default="bf16")
    ap.add_argument("--paths", default="unfused",
                    help=f"comma-separated paths of {sorted(PATHS)}")
    args = ap.parse_args(argv)
    args.paths = args.paths.split(",")
    for p in args.paths:
        if p not in PATHS:
            ap.error(f"unknown path {p!r}: choose from {sorted(PATHS)}")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    if args.root is not None:
        from llm_tpu_torch.ops import cuda_build

        libs = DECODE_LIBS + (("qmm_chain",) if "chain" in args.paths else ())
        cuda_build.build_all(tuple(n for n in cuda_build.SOURCES if n in libs))
    import llm_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[:1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(llm_tpu_torch.__file__)))
    for path in args.paths:
        rec = run_path(path, args.kv_dtype, args.tokens)
        print(json.dumps(dict(card=card[0] if card else None, root=root, **rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
