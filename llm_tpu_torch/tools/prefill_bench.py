"""Where a 512-token prefill's time goes on the card: LLAMA3_8B with the
Q4_K_M-style random planes of chip_smoke.py's phase 4 (seed 2), the same
prompt, a KV cache of 4096 cells, bf16 or (--kv-dtype q8_0) int8 with a
bf16 scale a row. Times --reps prefills on the host clock (each after
clearing the sequence, every one synchronized), then profiles one more
under torch.profiler: the device time of the prefill GEMM (K1/K2 at B =
512, kernels named qmm_wgmma, or qmm_gemm before the wgmma GEMM), of flash
prefill (K4, or K4q on the q8_0 cache: flash_prefill_wgmma, or
flash_prefill_kernel before the wgmma kernel) and of every kernel.

    python3 -m llm_tpu_torch.tools.prefill_bench [--reps 5] [--kv-dtype q8_0]
    python3 llm_tpu_torch/tools/prefill_bench.py --root <checkout> [--reps 5] [--kv-dtype q8_0]

--root runs another checkout's llm_tpu_torch (an older commit unpacked
with git archive), so that two versions can be timed in turns, one process
each, on one card: parent, change, change, parent. Prints one JSON line.
Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PROMPT = 512
GEMM_NAMES = ("qmm_wgmma", "qmm_gemm<")
K4_NAMES = ("flash_prefill_wgmma", "flash_prefill_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="checkout whose llm_tpu_torch to run")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kv-dtype", choices=("bf16", "q8_0"), default="bf16",
                    help="the KV cache's type: bf16 runs K4, q8_0 K4q")
    args = ap.parse_args(argv)
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("prefill_bench: no CUDA device", file=sys.stderr)
        return 2
    import llm_tpu_torch
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import LLAMA3_8B, make_synthetic_model
    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context

    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=2, recipe="Q4_K_M", **LLAMA3_8B)
    ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg),
                  kv_dtype="q8_0" if args.kv_dtype == "q8_0" else None)
    prompt = [(i * 104729) % cfg.vocab_size for i in range(PROMPT)]

    def prefill():
        ctx.seq_rm(0, 0, -1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assert ctx.decode(Batch.text(prompt)) == 0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prefill()  # builds the kernels, warms the caches
    wall = [prefill() for _ in range(args.reps)]
    ctx.seq_rm(0, 0, -1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert ctx.decode(Batch.text(prompt)) == 0
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA or (
                e.self_device_time_total > 0 and e.cpu_time_total == 0):
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)

    def total(names):
        hit = [(ms, n) for k, (ms, n) in kernels.items() if any(s in k for s in names)]
        return sum(ms for ms, _ in hit), sum(n for _, n in hit)

    gemm_ms, gemm_n = total(GEMM_NAMES)
    k4_ms, k4_n = total(K4_NAMES)
    med = statistics.median(wall)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[:1]
    print(json.dumps(dict(card=card[0] if card else None,
        root=os.path.dirname(os.path.dirname(os.path.abspath(llm_tpu_torch.__file__))),
        device=torch.cuda.get_device_name(0), kv_dtype=args.kv_dtype, prompt=PROMPT,
        prefill_ms=wall,
        prefill_ms_median=med, prefill_tok_s=PROMPT / med * 1e3,
        gemm_ms=gemm_ms, gemm_launches=gemm_n, k4_ms=k4_ms, k4_launches=k4_n,
        device_ms=sum(ms for ms, _ in kernels.values()),
        top_kernels={k[:90]: v for k, v in sorted(kernels.items(),
                                                   key=lambda kv: -kv[1][0])[:8]})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
