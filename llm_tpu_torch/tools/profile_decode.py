"""Where decode time goes on the card: LLAMA3_8B with Q4_K_M-style random
planes, a 512-token prefill, then `--tokens` greedy tokens of
Context.generate_loop under torch.profiler, with a bf16 or a q8_0 KV cache,
and optionally the chained kernel (--chain, K6) and the group-factored
matmul (--gdot, K5). --scan runs the scan decoder (Context(scan_layers=
True), K7 on stacked planes) on uniform planes, Q4_K in every matmul and
the lm_head (a Q4_K_M mix does not stack).

    python3 -m llm_tpu_torch.tools.profile_decode [--tokens 16] [--kv-dtype q8_0]
        [--chain] [--gdot] [--scan]

Prints one JSON line: wall ms per token (host clock around synchronized
work), the device's busy and idle shares over that window (kernel time
summed from the profiler's CUDA events; one stream, so kernels do not
overlap), device launches per token, and device time per kernel name,
largest first.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..gguf.constants import GGMLType
from ..models.synthetic import LLAMA3_8B, make_synthetic_model
from ..runtime.batch import Batch
from ..runtime.engine import Context


def profile_tokens(ctx: Context, tok: int, n_tokens: int) -> dict:
    """Profile n_tokens greedy tokens of ctx.generate_loop from tok (the
    cache already holds the prompt). The numbers of the JSON line."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        toks = ctx.generate_loop(tok, n_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA or (
                e.self_device_time_total > 0 and e.cpu_time_total == 0):
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
            launches += e.count
    busy_ms = sum(kernels.values())
    n = len(toks)
    return {
        "device": torch.cuda.get_device_name(0), "kv_dtype": str(ctx.kv_dtype),
        "chain": ctx.chain, "gdot": ctx.gdot, "scan": ctx.scan, "layers": ctx.cfg.n_layers,
        "tokens": n,
        "wall_ms_per_token": wall_ms / n, "device_busy_ms_per_token": busy_ms / n,
        "busy_share": busy_ms / wall_ms, "idle_share": 1 - busy_ms / wall_ms,
        "device_launches_per_token": launches / n,
        "kernel_ms_per_token": {k: v / n for k, v in
                                sorted(kernels.items(), key=lambda kv: -kv[1])[:20]},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--kv-dtype", choices=("bf16", "q8_0"), default="bf16")
    ap.add_argument("--chain", action="store_true", help="chained kernel K6 on decode steps")
    ap.add_argument("--gdot", action="store_true", help="group-factored K5 for unfused p4")
    ap.add_argument("--scan", action="store_true",
                    help="scan decoder (K7) on uniform Q4_K planes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")

    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=2, recipe=None if args.scan else "Q4_K_M",
                                       **LLAMA3_8B)
    ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg),
                  kv_dtype="q8_0" if args.kv_dtype == "q8_0" else None,
                  chain=args.chain, gdot=args.gdot, scan_layers=args.scan)
    del params
    if args.scan and not ctx.scan:
        raise SystemExit("the planes did not stack")
    prompt = [(i * 104729) % cfg.vocab_size for i in range(512)]
    assert ctx.decode(Batch.text(prompt)) == 0
    tok = ctx.generate_loop(int(ctx.get_logits().argmax()), 8)[-1]  # warm-up
    print(json.dumps(profile_tokens(ctx, tok, args.tokens)))


if __name__ == "__main__":
    main()
