"""K3/K3q (csrc/flash_attn.cu) at each thread block cluster size, at the
LLAMA3_8B decode shapes: what ops/cuda_attn.py::decode_attn_plan is fitted
to, and whether its pick is the fastest.

    python3 -m llm_tpu_torch.tools.attn_splits [--T 1,8] [--S 4096,4001]
        [--kv bf16,q8_0] [--clusters 1,2,4,8] [--host]

For each cache type, T and S, at H=32, Hkv=8, D=128: chip_smoke.py's
attention inputs (half of the cache masked; the q8_0 pairs made by the
port's quantizer), enough copies to pass the 50 MB L2, cycled. Each cluster
size (the CTAs that split one KV head's cells, 1..8, at most one a block
of 64 cells) is launched twice, the two outputs held bit-equal and against
attn_plain at atol = rtol = 1e-3, then timed with CUDA events around a CUDA
graph of launches. decode_attn_plan's pick is always among those timed.
Prints the card's name and power limit, then one JSON line per
configuration: µs per cluster size and the plan's pick.

--host times the host side of one call instead (host_us), at the plan's
cluster size.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time

import torch

from ..models.transformer import quantize_rows
from ..ops import cuda_attn
from ..ops.cuda_qmm import sm_count
from .kbench import card, nbytes, time_ms
from .kbench_attn import attn_inputs, copies_for

H, HKV, D = 32, 8, 128
KV_TYPES = ("bf16", "q8_0")
TOL = dict(atol=1e-3, rtol=1e-3)  # chip_smoke.py::check_attn's


def inputs(kv: str, T: int, S: int, seed: int) -> dict:
    inp, _ = attn_inputs(T, H, HKV, S, D, seed=seed)
    if kv == "q8_0":
        inp = {**inp, "k": quantize_rows(inp["k"], 1), "v": quantize_rows(inp["v"], 1)}
    return inp


def sweep(kv: str, T: int, S: int, clusters) -> dict:
    q8 = kv == "q8_0"
    first = inputs(kv, T, S, S + T)
    size = sum(nbytes(*(x if isinstance(x, tuple) else (x,))) for x in first.values())
    inps = [first] + [inputs(kv, T, S, S + T + i) for i in range(1, copies_for(size))]
    scale = D ** -0.5
    want = cuda_attn.attn_plain(**first, scale=scale)
    nblk = -(-S // cuda_attn.DECODE_BLOCK)
    pick = cuda_attn.decode_attn_plan(T, H, HKV, S, sm_count(first["q"].device))[0]
    rec = dict(kernel="K3q" if q8 else "K3", shape=f"T={T} S={S} H={H} Hkv={HKV} D={D}",
               pick=pick, us={}, max_abs_err={})
    for c in sorted({c for c in clusters if c <= min(nblk, cuda_attn.DECODE_MAX_CLUSTER)}
                    | {pick}):
        run = (lambda i, c=c: cuda_attn._decode_launch(q8, **inps[i], scale=scale, cluster=c))
        got, again = run(0), run(0)
        if not torch.equal(got, again):
            raise AssertionError(f"{rec['kernel']} {rec['shape']} cluster {c}: "
                                 "two launches differ")
        torch.testing.assert_close(got, want, **TOL)
        rec["max_abs_err"][c] = (got - want).abs().max().item()
        rec["us"][c] = 1e3 * time_ms(run, len(inps))
    return rec


# cuTensorMapEncodeTiled's enums (cuda.h)
TMAP_UINT8, TMAP_BF16, TMAP_SWIZZLE_128B, TMAP_L2_128B = 0, 9, 3, 2


def _encode_maps(kv: str, inp: dict, S: int):
    """A function that encodes K3/K3q's four tensor maps of inp as
    csrc/flash_attn.cu's launch does, by cuTensorMapEncodeTiled through
    ctypes (each call also pays ctypes' own cost)."""
    q8 = kv == "q8_0"
    cu = ctypes.CDLL("libcuda.so.1")
    fn = cu.cuTensorMapEncodeTiled
    fn.restype = ctypes.c_int
    buf = ctypes.create_string_buffer(128 + 64)
    tmap = ctypes.c_void_p((ctypes.addressof(buf) + 63) & ~63)
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    es = 1 if q8 else 2
    k = inp["k"][0] if q8 else inp["k"]
    v = inp["v"][0] if q8 else inp["v"]
    kv_map = ((u64 * 3)(D, S, HKV), (u64 * 2)(D * es, S * D * es),
              (u32 * 3)(128 if q8 else 64, cuda_attn.DECODE_BLOCK, 1))
    tab_map = ((u64 * 2)(D, S), (u64 * 1)(D * 2), (u32 * 2)(64, cuda_attn.DECODE_BLOCK))
    ones = (u32 * 3)(1, 1, 1)
    maps = [(TMAP_UINT8 if q8 else TMAP_BF16, 3, t.data_ptr(), kv_map) for t in (k, v)] + \
           [(TMAP_BF16, 2, inp[n].data_ptr(), tab_map) for n in ("cos", "sin")]

    def encode():
        for dt, rank, ptr, (dims, strides, box) in maps:
            rc = fn(tmap, dt, u32(rank), ctypes.c_void_p(ptr), dims, strides, box, ones,
                    0, TMAP_SWIZZLE_128B, TMAP_L2_128B, 0)
            if rc:
                raise RuntimeError(f"cuTensorMapEncodeTiled: CUresult {rc}")
    return encode


def host_us(kv: str, T: int, S: int, n: int = 2000) -> dict:
    """Host µs of one K3/K3q call at the plan's cluster size, the median of
    n calls, each on an idle stream: the whole wrapper
    (cuda_attn._decode_launch: checks, plan, torch.empty, the library
    call), the library call alone (four tensor maps encoded, one launch),
    the library call refused before it encodes anything (cluster 0: ctypes'
    own cost), and the four encodes alone."""
    q8 = kv == "q8_0"
    inp = inputs(kv, T, S, S + T)
    scale = D ** -0.5
    planes = (*inp["k"], *inp["v"]) if q8 else (inp["k"], inp["v"])
    out = torch.empty((T, H, D), dtype=torch.float32, device=inp["q"].device)
    ptrs = [t.data_ptr() for t in (inp["q"], inp["q_rot"], *planes, inp["cos"], inp["sin"],
                                   inp["bias"], out)]
    lib = cuda_attn._lib()
    fn = lib.flash_decode_q8_launch if q8 else lib.flash_decode_launch
    stream = torch.cuda.current_stream().cuda_stream
    cluster = cuda_attn.decode_attn_plan(T, H, HKV, S, sm_count(inp["q"].device))[0]
    encode = _encode_maps(kv, inp, S)
    calls = {
        "wrapper": lambda: cuda_attn._decode_launch(q8, **inp, scale=scale),
        "library": lambda: fn(*ptrs, T, H, HKV, S, D, scale, cluster, stream),
        "library_refused": lambda: fn(*ptrs, T, H, HKV, S, D, scale, 0, stream),
        "encode_4_maps": encode,
    }
    rec = dict(kernel="K3q" if q8 else "K3", shape=f"T={T} S={S} H={H} Hkv={HKV} D={D}",
               cluster=cluster, n=n, host_us={})
    for name, call in calls.items():
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            call()
            ts.append(time.perf_counter_ns() - t0)
        rec["host_us"][name] = statistics.median(ts) / 1e3
    torch.cuda.synchronize()
    return rec


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", default="1,8", help="query tokens, comma-separated (1..8)")
    ap.add_argument("--S", default="4096,4001", help="cache cells, comma-separated")
    ap.add_argument("--kv", default=",".join(KV_TYPES), help="cache types: bf16, q8_0")
    ap.add_argument("--clusters", default="1,2,4,8",
                    help=f"cluster sizes, comma-separated (1..{cuda_attn.DECODE_MAX_CLUSTER})")
    ap.add_argument("--host", action="store_true",
                    help="time the host side of one call (host_us), not the cluster sizes")
    args = ap.parse_args(argv)
    ints = (lambda v: [int(x) for x in v.split(",")])
    args.T, args.S, args.clusters, args.kv = (ints(args.T), ints(args.S), ints(args.clusters),
                                              args.kv.split(","))
    if any(not 1 <= t <= cuda_attn.DECODE_MAX_T for t in args.T):
        ap.error(f"--T takes 1..{cuda_attn.DECODE_MAX_T}")
    if any(s < 1 for s in args.S):
        ap.error("--S takes positive cell counts")
    if any(not 1 <= c <= cuda_attn.DECODE_MAX_CLUSTER for c in args.clusters):
        ap.error(f"--clusters takes 1..{cuda_attn.DECODE_MAX_CLUSTER}")
    if any(k not in KV_TYPES for k in args.kv):
        ap.error(f"--kv takes {', '.join(KV_TYPES)}")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_splits needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card()}", flush=True)
    for kv in args.kv:
        for T in args.T:
            for S in args.S:
                rec = host_us(kv, T, S) if args.host else sweep(kv, T, S, args.clusters)
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
