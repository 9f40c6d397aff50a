"""S3: the flash-decode layout and q8 dequant probes (ops/cuda_attn_probe.py)
beside their bytes bound and the library call. Counterpart of the TPU
package's scripts/kbench7.py (layout) and scripts/kbench9.py (q8 dequant).

    python3 -m llm_tpu_torch.tools.kbench_attn [--variants v1,v0,noscale,full,bf16]
        [--splits 0,256,512,1024] [--plain]

At T=1, H=32, Hkv=8, D=128, with real NORM rope tables and a zero bias:
  v1, v0   S=1024 over a stack of NB=20 caches (80 MiB of K+V, past the
           50 MB L2), head-major [NB, Hkv, S, D] and seq-major [NB, S, Hkv,
           D] copies of the same values; each launch reads the buffer that
           an int32 index on the card names, and the timed graph cycles the
           index through the NB buffers (kbench7's rem(it, NB)); swept over
           the split sizes (cells per CTA; 0 is the split body's own choice);
  noscale, full, bf16   S=4096 on int8 K/V with bf16 scales (kbench9's
           data: uniform int8 in [-127, 127], scales 0.02 + 0.01 N(0, 1)),
           enough copies to pass the L2, cycled; at the split body's own split.
Each configuration is first held against its plain version (for v1/v0 on
buffers 0 and NB-1 at every split, whose outputs must also differ: the
index is honoured). Then CUDA events around a CUDA graph of launches give
its µs. Prints the card's name and power limit, then one JSON line per
variant and split: µs; GB/s over the K+V bytes (kbench7's measure) and over
every byte read (K/V, scales, cos/sin: kbench9's); the bytes bound at 3.35
TB/s over every byte the function must move; the library call's µs
(scaled_dot_product_attention over pre-roped, GQA-expanded bf16 K/V of as
many buffers as pass the L2, the q8 modes' K/V dequantized by the mode);
max|err| beside its tolerance; the plain version's µs (--plain, timed once
a variant: it has no split); and the S3 launches the configuration made.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ..ops import cuda_attn, cuda_attn_probe
from ..ops.rope import ROPE_TYPE_NORM, RopeParams, apply_rope, rope_angles
from .kbench import L2_BYTES, PEAK_BYTES_PER_S, card, nbytes, time_ms

T, H, HKV, D = 1, 32, 8, 128
S_STACKED, NB = 1024, 20  # scripts/kbench7.py
S_Q8 = 4096  # scripts/kbench9.py
SPLITS = (0, 256, 512, 1024)  # kbench7's sblks; 0 = the split body's choice
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense


def copies_for(n: int) -> int:
    """Copies of n bytes that pass twice the L2 (at most 16)."""
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(n, 1))))


def attn_inputs(T, H, Hkv, S, D, seed, masked_frac=0.5, device="cuda", Dv=None, n_rot=None):
    """Attention inputs made from seed: a causal run of T tokens whose last
    sees the first (1 - masked_frac) * S cells of a cache of S (NORM rope at
    freq_base 5e5 on the first n_rot dims, None: all D; bf16 q/K/V from
    N(0, 1); V at Dv, None: D); and the half-width rope angles."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn((T, H, D), generator=gen, device=device).to(bf)
    k = torch.randn((Hkv, S, D), generator=gen, device=device).to(bf)
    v = torch.randn((Hkv, S, Dv or D), generator=gen, device=device).to(bf)
    pos = torch.arange(S, device=device)
    n_rot = n_rot or D
    c, s = rope_angles(pos, RopeParams(n_dims=n_rot, mode=ROPE_TYPE_NORM, freq_base=500000.0))
    cos, sin = (t.to(bf).contiguous()
                for t in cuda_attn.expand_tables(c, s, ROPE_TYPE_NORM, D, n_dims=n_rot))
    tok_pos = torch.arange(T, device=device) + int(S * (1 - masked_frac)) - T
    bias = torch.where(pos[None, :] <= tok_pos[:, None], 0.0, float("-inf")).float()
    qr = cuda_attn.rope_companion(q, ROPE_TYPE_NORM, n_rot).contiguous()
    return dict(q=q, q_rot=qr, k=k, v=v, cos=cos, sin=sin, bias=bias.contiguous()), (c, s)


def queries(gen, S: int) -> dict:
    """q, q_rot, the rope tables of positions 0..S-1 (kbench7's freq_base)
    and a zero bias, on the card; plus the half-width angles for SDPA."""
    bf = torch.bfloat16
    q = torch.randn((T, H, D), generator=gen, device="cuda").to(bf)
    c, s = rope_angles(torch.arange(S, device="cuda"),
                       RopeParams(n_dims=D, mode=ROPE_TYPE_NORM, freq_base=500000.0))
    cos, sin = (t.to(bf).contiguous() for t in cuda_attn.expand_tables(c, s, ROPE_TYPE_NORM, D))
    return dict(q=q, q_rot=cuda_attn.rope_companion(q, ROPE_TYPE_NORM).contiguous(), cos=cos,
                sin=sin, bias=torch.zeros((T, S), device="cuda")), (c, s)


def sdpa_ms(inp: dict, angles, kvs) -> float:
    """scaled_dot_product_attention over pre-roped, GQA-expanded bf16 K/V,
    cycling over the [Hkv, S, D] (k, v) pairs kvs, as many as pass the L2."""
    c, s = angles
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = inp["q"].transpose(0, 1)[None]
    mask = inp["bias"].to(torch.bfloat16)[None, None]
    G = H // HKV
    S = kvs[0][0].shape[1]
    ready = []
    for k, v in kvs[:copies_for(2 * H * S * D * 2)]:
        kr = apply_rope(k.to(torch.bfloat16).transpose(0, 1), c, s, ROPE_TYPE_NORM,
                        D).transpose(0, 1)
        ready.append((kr.repeat_interleave(G, dim=0)[None].contiguous(),
                      v.to(torch.bfloat16).repeat_interleave(G, dim=0)[None].contiguous()))
    ms = time_ms(lambda i: sdpa(qs, *ready[i], attn_mask=mask, scale=D ** -0.5), len(ready))
    del ready
    return ms


def _record(variant, S, split, n_splits, inp, kv_bytes, extra_bytes, us, lib_us, err, tol,
            launches, plain_us=None) -> dict:
    """One JSON line: the bytes each measure counts, and the bound."""
    read = kv_bytes + extra_bytes + nbytes(inp["cos"], inp["sin"])
    moved = read + nbytes(inp["q"], inp["q_rot"], inp["bias"]) + 4 * T * H * D
    t_bytes = moved / PEAK_BYTES_PER_S * 1e6
    t_ops = 6.0 * T * H * S * D / PEAK_BF16_FLOPS * 1e6
    rec = dict(variant=variant, shape=f"{variant} T={T} S={S} H={H} Hkv={HKV} D={D}",
               split=split, cells_per_split=-(-S // n_splits), n_splits=n_splits,
               ctas=n_splits * HKV, us=us,
               kv_gbps=kv_bytes / (us * 1e3), read_gbps=read / (us * 1e3),
               bound_us=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else
               "operations", bytes_kv=kv_bytes, bytes_read=read, library_us=lib_us,
               max_abs_err=err, tol=tol, launches=launches)
    if plain_us is not None:
        rec["plain_us"] = plain_us
    return rec


def _check(variant, inp, kv, lidx, split, scale):
    """Kernel against plain version on one input: (max|err|, tol, output)."""
    got = cuda_attn_probe.probe_cuda(variant, **inp, **kv, scale=scale, lidx=lidx, split=split)
    want = cuda_attn_probe.probe_plain(variant, **inp, **kv, scale=scale, lidx=lidx)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = cuda_attn_probe.tolerance(variant, want)
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"S3 {variant} split={split} lidx={lidx}: max|err| {err} > {tol}")
    return err, tol, got


def bench_stacked(variants, splits, plain=False, seed=0, log=print) -> list[dict]:
    """v1 and v0 over the same NB buffers, every split (module docstring)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    inp, angles = queries(gen, S_STACKED)
    seq = [torch.randn((NB, S_STACKED, HKV, D), generator=gen, device="cuda").to(torch.bfloat16)
           for _ in range(2)]
    stacks = {"v0": dict(k=seq[0], v=seq[1]),
              "v1": dict(k=seq[0].transpose(1, 2).contiguous(),
                         v=seq[1].transpose(1, 2).contiguous())}
    lids = torch.arange(NB, dtype=torch.int32, device="cuda")
    lid = [lids[i:i + 1] for i in range(NB)]
    scale = D ** -0.5
    buf_bytes = 2 * HKV * S_STACKED * D * 2
    heads = [(stacks["v1"]["k"][i], stacks["v1"]["v"][i]) for i in range(NB)]
    lib_us = 1e3 * sdpa_ms(inp, angles, heads)
    recs = []
    for variant in (v for v in ("v1", "v0") if v in variants):
        kv = stacks[variant]
        plain_us = None
        if plain:
            plain_us = 1e3 * time_ms(lambda i: cuda_attn_probe.probe_plain(
                variant, **inp, **kv, scale=scale, lidx=lid[i]), NB, iters=3)
        for split in splits:
            before = cuda_attn_probe.LAUNCHES["S3"]
            err0, tol0, y0 = _check(variant, inp, kv, lid[0], split or None, scale)
            err1, tol1, y1 = _check(variant, inp, kv, lid[NB - 1], split or None, scale)
            if not (y0 - y1).abs().max().item() > max(tol0, tol1):
                raise AssertionError(f"S3 {variant}: buffers 0 and {NB - 1} gave one output")
            us = 1e3 * time_ms(lambda i: cuda_attn_probe.probe_cuda(
                variant, **inp, **kv, scale=scale, lidx=lid[i], split=split or None), NB)
            n = cuda_attn_probe.split_count("cuda", T, H, HKV, S_STACKED, split or None)
            rec = _record(variant, S_STACKED, split, n, inp, buf_bytes, 4, us, lib_us,
                          max(err0, err1), min(tol0, tol1),
                          cuda_attn_probe.LAUNCHES["S3"] - before, plain_us)
            rec["shape"] += f" NB={NB}"
            recs.append(rec)
            log(json.dumps(rec))
    return recs


def q8_inputs(gen, S: int) -> dict:
    """kbench9's cache: int8 K/V uniform in [-127, 127], bf16 scales
    0.02 + 0.01 N(0, 1) per head row."""
    def pair():
        q8 = torch.randint(-127, 128, (HKV, S, D), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        sc = (0.02 + 0.01 * torch.randn((HKV, S, 1), generator=gen, device="cuda"))
        return q8, sc.to(torch.bfloat16)
    return dict(k=pair(), v=pair())


def bench_q8(modes, plain=False, seed=1, log=print) -> list[dict]:
    """The q8 modes on the same int8 caches at the split body's own split (module docstring)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    inp, angles = queries(gen, S_Q8)
    kv_bytes = 2 * HKV * S_Q8 * D
    scale_bytes = 2 * HKV * S_Q8 * 2
    kvs = [q8_inputs(gen, S_Q8) for _ in range(copies_for(kv_bytes + scale_bytes))]
    scale = D ** -0.5
    recs = []
    for mode in (m for m in cuda_attn_probe.Q8_MODES if m in modes):
        before = cuda_attn_probe.LAUNCHES["S3"]
        err, tol, _ = _check(mode, inp, kvs[0], None, None, scale)
        us = 1e3 * time_ms(lambda i: cuda_attn_probe.probe_cuda(mode, **inp, **kvs[i],
                                                                scale=scale), len(kvs))
        plain_us = None
        if plain:
            plain_us = 1e3 * time_ms(lambda i: cuda_attn_probe.probe_plain(
                mode, **inp, **kvs[i], scale=scale), len(kvs), iters=3)
        dense = [tuple(cuda_attn_probe.dense_kv(mode, c[n]) for n in ("k", "v")) for c in kvs]
        lib_us = 1e3 * sdpa_ms(inp, angles, dense)
        del dense
        n = cuda_attn_probe.split_count("cuda", T, H, HKV, S_Q8, None)
        recs.append(_record(mode, S_Q8, 0, n, inp, kv_bytes, scale_bytes, us,
                            lib_us, err, tol, cuda_attn_probe.LAUNCHES["S3"] - before, plain_us))
        log(json.dumps(recs[-1]))
    return recs


def run(variants=cuda_attn_probe.VARIANTS, splits=SPLITS, plain=False, log=print) -> list[dict]:
    """Every variant asked for, each record logged as a JSON line as it comes."""
    return (bench_stacked(variants, splits, plain, log=log)
            + bench_q8(variants, plain, log=log))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(cuda_attn_probe.VARIANTS))
    ap.add_argument("--splits", default=",".join(map(str, SPLITS)),
                    help="cells per CTA for v1/v0, comma-separated; 0 is the split body's choice")
    ap.add_argument("--plain", action="store_true", help="also time the plain versions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kbench_attn needs a CUDA device")
    variants = args.variants.split(",")
    for v in variants:
        cuda_attn_probe._variant(v)
    print(f"card: {card()}", flush=True)
    run(variants, tuple(int(s) for s in args.splits.split(",")), args.plain,
        log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
