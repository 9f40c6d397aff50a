"""The decode GEMV's probes (S1) beside K1, at the LLAMA3_8B decode shapes.
Counterpart of the TPU package's scripts/kbench.py and scripts/kbench3.py.
The probes run the GEMV loop of csrc/qmm_gemv.cuh, which no production
kernel runs any more (K1's until K1 got the decode GEMV of
csrc/qmm_decode.cu, then K5's and K6's until they moved onto that GEMV's
CTA), so their times split that loop's time, and K1's "full" time beside
them is the other kernel's.

    python3 -m llm_tpu_torch.tools.kbench [--shapes qkv,out,gu,down,head] [--B 1,8]

For each shape and row count: Q4_K planes with bf16 scales made on the
card (enough copies to exceed the 50 MB L2, cycled, so that every launch
streams from device memory), then the probes "qs" (stream the packed
nibbles), "dma" (stream every plane and stage x) and "deq" (also unpack and
dequantize every weight) and K1 ("full") each timed with CUDA events around
a CUDA graph of launches, each probe first held against its plain version
row by row (ops/cuda_probe.py: the packed bytes' sums exactly, the scales
and mins, the dequantized weights and x each at a bound of its own size).
Prints the card's name and power limit, then one JSON line per shape and
row count: µs and GB/s per mode (the bytes the mode must read, over its
time), K1's bytes bound, and per mode each output row's max|err| beside its
bound.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from ..gguf.constants import GGMLType
from ..models.synthetic import device_synthetic_qtensor
from ..ops import cuda_probe, cuda_qmm

# scripts/kbench.py SHAPES: LLAMA3_8B decode matmuls (name: K, N)
SHAPES = {"qkv": (4096, 6144), "out": (4096, 4096), "gu": (4096, 28672),
          "down": (14336, 4096), "head": (4096, 128256)}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
L2_BYTES = 50 << 20


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def time_ms(fn, n_variants: int = 1, iters: int = 50) -> float:
    """Mean device time of fn(i), i cycling over n_variants, over iters
    launches captured in a CUDA graph (no host time between launches)."""
    for i in range(2):
        fn(i % n_variants)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(i % n_variants)
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bench_shape(name: str, K: int, N: int, B: int, seed: int = 0,
                plain: bool = False) -> dict:
    """One shape at B rows: each probe against its plain version, then the
    probes and K1 timed. plain: also time the plain versions (3 launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed * 1000003 + K * 7 + N + B)
    qt0 = device_synthetic_qtensor(gen, N, K, GGMLType.Q4_K, torch.bfloat16)
    planes = nbytes(qt0.qs, qt0.scales, qt0.mins)
    ncp = max(1, min(16, math.ceil(2 * L2_BYTES / planes)))
    qts = [qt0] + [device_synthetic_qtensor(gen, N, K, GGMLType.Q4_K, torch.bfloat16)
                   for _ in range(ncp - 1)]
    x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
    rec = dict(shape=f"{name} Q4_K K={K} N={N} B={B}", B=B, K=K, N=N, us={}, gbps={},
               max_abs_err={}, tol={}, plain_us={})
    out = 4 * cuda_probe.OUT_ROWS * N
    moved = {"qs": nbytes(qt0.qs) + out,
             "dma": planes + nbytes(x) + out,
             "deq": planes + nbytes(x) + out,
             "full": planes + nbytes(x) + 4 * B * N}
    for mode in cuda_probe.MODES:
        got = cuda_probe.probe_cuda(mode, x, qt0)
        want = cuda_probe.probe_plain(mode, x, qt0)
        err = (got - want).abs().amax(1, keepdim=True)
        tol = cuda_probe.tolerance(mode, x, qt0)
        rec["max_abs_err"][mode], rec["tol"][mode] = err.flatten().tolist(), tol.flatten().tolist()
        if not (bool((err <= tol).all()) and bool(err.isfinite().all())):
            raise AssertionError(f"S1 {mode} {rec['shape']}: max|err| per row "
                                 f"{rec['max_abs_err'][mode]} > {rec['tol'][mode]}")
        rec["us"][mode] = 1e3 * time_ms(lambda i, m=mode: cuda_probe.probe_cuda(m, x, qts[i]),
                                        ncp)
        if plain:
            rec["plain_us"][mode] = 1e3 * time_ms(
                lambda i, m=mode: cuda_probe.probe_plain(m, x, qts[i]), ncp, iters=3)
    rec["us"]["full"] = 1e3 * time_ms(lambda i: cuda_qmm.qmm_cuda(x, qts[i]), ncp)
    rec["gbps"] = {m: moved[m] / (us * 1e3) for m, us in rec["us"].items()}
    rec["bytes"] = moved
    rec["bound_us"] = {m: b / PEAK_BYTES_PER_S * 1e6 for m, b in moved.items()}
    return rec


def run(shapes, rows, plain: bool = False, log=print) -> list[dict]:
    """bench_shape for every row count and shape, each record logged as a
    JSON line as it comes."""
    recs = []
    for b in rows:
        for name in shapes:
            recs.append(bench_shape(name, *SHAPES[name], b, plain=plain))
            log(json.dumps(recs[-1]))
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--B", default="1,8", help="rows of x, comma-separated (1..16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kbench needs a CUDA device")
    print(f"card: {card()}", flush=True)
    run(args.shapes.split(","), [int(v) for v in args.B.split(",")],
        log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
