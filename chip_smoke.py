"""Smoke run of the PyTorch/CUDA port (llm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sweep-seeds [q8_0|chain|gguf]  # phase 3's twins' errors
    python3 chip_smoke.py --screen-seeds   # the q8_0 twin's top-2 gaps on the card, seeds 1-64
    python3 chip_smoke.py --decode-rows    # phase 2's decode GEMV / K6 rows alone
    python3 chip_smoke.py --attn-gemm-rows [--root DIR]  # phase 2's K3/K4 and B = 512 GEMM rows
                                           # alone (--root: another checkout's kernels)
    python3 chip_smoke.py --command-r      # phase 2's Command-R rows, its twin and phase 18

Phases, each of which raises on failure (the script then exits nonzero and
prints no result line):
  1. the card's name and power limit; build every kernel from
     llm_tpu_torch/csrc in parallel (nvcc, sm_90a); the decode GEMV's
     machine code read back (cuobjdump: every qmm_decode kernel, K1/K2/K7's
     and K5's qmm_decode_gdot, issues HMMA and TMA loads; no qmm_gemv kernel
     is left in libqmm.so, libqmm_stacked.so or libqmm_chain.so, and
     libqmm_probe.so keeps S1's probes of that loop), K6's (its
     qmm_chain_tc kernel and the GeGLU one, qmm_chain_tc_gelu, issue HMMA
     and TMA loads, the old qmm_chain_kernel is gone), the prefill GEMM's (every qmm_wgmma kernel
     issues HGMMA and TMA loads, no mma.sync GEMM is left), flash
     prefill's (every one of the K4_KERNELS flash_prefill kernels of
     libflash_prefill.so, two at head dim 128, eight _dim ones at 64, 80,
     96 and any other D, and the wide, capped and ALiBi ones, issues
     HGMMA, no f32-FMA prefill kernel is left in it or in
     libflash_attn.so), and
     flash decode's (the 46 flash_decode_tc kernels of libflash_attn.so,
     six at head dim 128, 24 _dim ones, 8 wide and 8 capped wide ones,
     issue HMMA and TMA loads, no split-S kernel or combine kernel is left
     there; libflash_probe.so keeps the split-S body and its combine for
     S3), and the capped kernels (gemma2's softcap) counted apart: 8
     flash_decode_tc_wide_cap (HMMA, TMA), 4 flash_prefill_wgmma_wide_cap
     and 4 narrow flash_prefill_wgmma_cap (HGMMA, TMA); likewise the narrow
     kernels' ALiBi instantiations: 12 flash_decode_tc_alibi (HMMA, TMA)
     and 4 flash_prefill_wgmma_alibi (HGMMA, TMA); and the forms on nibble
     planes at group size 16, counted apart: 16 qmm_decode_g16 /
     qmm_decode_gdot_g16 (HMMA, TMA), qmm_chain_tc_g16 (HMMA, TMA) and 4
     qmm_wgmma_g16 in each GEMM library (HGMMA, TMA); the forms at group
     size 256 (nibble planes) and 8 (int8 planes), likewise: 16
     qmm_decode_g256 / qmm_decode_gdot_g256, 8 qmm_decode_g8,
     qmm_chain_tc_g256 and qmm_chain_tc_g8, and 4 qmm_wgmma_g256 and 4
     qmm_wgmma_g8 in each GEMM library;
  2. each kernel (K1/K2 quantized matmul: at B <= 16 the decode GEMV, at
     B = 1 and 8, at B > 16 the wgmma prefill GEMM, also at a ragged B =
     300; K3/K4 flash attention (K4, the
     wgmma flash prefill, also beside its doubled floor), K3q/K4q
     flash attention on the int8 KV cache, whose inputs the port's own
     quantizer makes on the card, K5 group-factored matmul (the decode
     GEMV's CTA with the group-factored sum) beside K1 at the same shapes,
     K6 chained layer tail / norm + matmul (the decode GEMV's CTA on a
     cooperative grid of clusters) beside the unfused launches it replaces,
     K7 = K1/K2/K5 on a layer of stacked planes beside the unstacked kernel
     on the same layer, bit-equal to it at decode) at
     the main path's shapes, held
     against its plain PyTorch version on the card, and timed beside its
     bound, the plain version and one PyTorch library call that computes
     the same function (K3/K3q's times also beside the split-S kernel's
     that they replace); then
     the decode GEMV's probes (S1, tools/kbench.py) at the kbench shapes,
     each against its plain version and timed beside K1; then the
     flash-decode probes (S3, tools/kbench_attn.py, each within
     S3_MAX_RATIO of its kernel table's time): the split-S decode body over
     a stack of 20 head-major (v1) and seq-major (v0) caches at S=1024, the
     buffer named by an index on the card (buffers 0 and 19 checked, and
     different), at splits of 256, 512 and 1024 cells and its own, and on
     the int8 cache at S=4096 without the scale multiply, with it in f32,
     and in bf16 (K3q's dequant), each against its plain version and timed
     beside its bound and SDPA; K3/K4 at head dims 64, 80 and 96 (the
     columns of a 128-dim block past D zero) and K3q/K4q at 80 (a row keeps
     one scale there), each at the decode and prefill shapes of the D = 128
     rows, and K3/K4/K4q at G = 3 (24 query heads over 8 KV heads); the
     wide kernels (K3w/K4w, K3qw/K4qw) at gemma's D = 256 (G = 2), MLA's
     Dk 192 / Dv 128 (G = 1), Dk 128 / Dv 64, and the int8 cache at
     D = 256 and at D = 72 and 136 (rows of 8 mod 16 bytes), each beside
     SDPA (the backend it took logged); K3 at the server's batched steps
     (T = 2 and 4, each row masked to its own sequence's cells;
     per_sequence_bias), K3q at T = 4; K1/K2 at every Gemma-2-9B matmul
     shape (K or N = 3584, its 256000-row tied Q6_K lm_head) at B = 1, 8
     and 512; the capped kernels at cap 50: the wide ones (K3w_cap,
     K3qw_cap, K4w_cap, K4qw_cap) at Gemma-2-9B's heads (16 over 8 of 256)
     and at Gemma-2-27B's (32 over 16 of 128) K3w_cap at decode and the
     narrow ones' capped instantiations K4_cap / K4q_cap at a 512-token
     prefill, each timed beside the uncapped kernel at the same shape and
     SDPA's uncapped time (no one SDPA call computes capped attention:
     library None; `--attn-gemm-rows` times flex_attention with a tanh
     score_mod there); the
     ALiBi kernels (K3_alibi, K3q_alibi, K4_alibi, K4q_alibi) on rope
     NONE (no rope tables) at Baichuan-13B's heads (40 over 40 of 128, both
     caches) and refact's (32 over 1 of 64, the run-time D kernels), each
     timed beside the kernel without ALiBi at the same shape and SDPA with
     the ALiBi term in its float mask (the library column); K1/K2 at every
     Baichuan-13B matmul shape (Q8_0 down at K = 13696) at B = 1, 8 and
     512; K6_gelu (the GeGLU tail, qmm_chain_tc_gelu) at Gemma-7B's
     widths with a Q4_K and a Q6_K down and K6 at its fused head, B = 1
     and 8, beside the unfused launches, the tail also without its
     residual (the FFN's output alone, where the plain SwiGLU must lie
     apart from the plain GeGLU); K1/K2 at Qwen3-30B-A3B's and Gemma-7B's
     attention, FFN and lm_head shapes at B = 1, 8 (and 512 but the
     lm_heads); at LLAMA3_8B's gate+up, attn_q, attn_k and down on Q3_K
     (zero point 4) and Q2_K (mins) nibble planes at group size 16:
     K1_gs16 and K7_gs16 at B = 1, 8 and 512, K5_gs16 at B = 1 and 8,
     K6_gs16 on a Q3_K tail at B = 1 and 8; K2 at 4096x4096 on Q5_0,
     Q5_1, Q5_K, IQ4_NL and IQ4_XS planes;
  3. two layers at LLAMA3_8B width: Context.decode of a 64-token prompt and
     2 greedy generate_loop steps on the card (kernels; TWO_LAYER_DECODE,
     cut from 8 for time), the card's stream
     decoded step by step on the card and on the CPU (plain versions), from
     the same random weights; every step's logits compared, and the greedy
     tokens (the CPU's: each step's argmax after the card's prefix); then the same with a q8_0 KV
     cache, whose card logits are also held against the bf16 cache's; then
     with chain=True, gdot=True (K5 on the unfused QKV of layer 0, K6 on
     layer 1's head, both tails and the lm_head); then the same card-vs-CPU
     check at Llama-3.2-1B's widths (2048 hidden, 32 / 8 heads of 64 dims,
     ff 8192) with a bf16 cache (K3/K4 at D = 64) and a q8_0 cache (32-dim
     group scales: the unfused attention, by shape, as the reference) and
     at Llama-3.2-3B's (3072 hidden, 24 / 8 heads of 128, ff 8192; K4 at
     G = 3); then llama configs at Gemma-2-2B's attention widths (2304
     hidden, 8 / 4 heads of 256, ff 9216) with a bf16 and a q8_0 cache
     (K3w/K4w, K3qw/K4qw), at DeepSeek-V2-Lite's (2048 hidden, 16 heads,
     Dk 192, Dv 128; K3w/K4w), at head_dim 100 (no multiple of 8: the
     unfused attention, counted, no flash launch) and 264 (past 256: the
     same); then two layers of the real Gemma-2-9B config (gemma2: a
     sliding and a global layer, softcaps, post-norms, gelu, the tied Q6_K
     lm_head) with the window cut to 32, so that the mask bites inside the
     64-token prompt, and a bf16 cache (K3w_cap/K4w_cap), and at its own
     window with a q8_0 cache (K3qw_cap/K4qw_cap); then two layers of
     Baichuan-13B (its 13B profile: rope NONE, ALiBi) with a bf16 and a
     q8_0 cache (K3_alibi/K4_alibi, K3q_alibi/K4q_alibi) and of
     Refact-1.6B (ALiBi at G = 32, D = 64) with a bf16 cache; then two
     layers of Qwen3-30B-A3B (qk-norm, 128 experts of 768, 8 a token: the
     prompt on the grouped dispatch, the decode steps on the gather; K3/K4
     at G = 8), of Qwen2.5-7B (QKV biases, G = 7) and of Gemma-7B with
     chain=True (a GeGLU tail on K6_gelu in each layer of each decode
     step, K3w/K4w at D = 256); then two layers at LLAMA3_8B width from a
     2-layer tools/synth_gguf.py file typed as Q3_K_M (Q3_K, Q5_K, Q4_K,
     Q6_K) and one typed as Q2_K (Q2_K, Q3_K, Q4_K, Q6_K), loaded through
     models/loader.py so that the unpackers run on real block bytes
     (K1_gs16 launched on the card);
  4. LLAMA3_8B, 32 layers, Q4_K_M-style random planes made on the card
     (first, K5 against its plain version at every p4 shape of these planes
     that phase 2 left out, attn_k among them): prefill 512 tokens, then 128
     greedy tokens, with every kernel's launch count read over that run; its
     profile of 8 more tokens shows no memset, and one flash decode launch
     a layer (no combine kernel);
  5. the same planes with a q8_0 KV cache (K3q/K4q in place of K3/K4):
     prefill 512, 128 greedy tokens, launch counts, the cache's bytes and
     peak memory against phase 4's, a profile of 8 more tokens (one K3q
     launch a layer, no combine kernel); then the prompt's cells saved with
     state_seq_save, loaded into a fresh q8_0 Context (planes bit-equal)
     and one decode step there against the uninterrupted Context;
  6. phase 4's planes with gdot=True: K5 in place of every decode K1;
  7. phase 4's planes with chain=True, gdot=True: K6 for every tail, fused
     head and the lm_head, K5 for the unfused QKV; each of phases 4, 6 and
     7 also profiled over 8 decode tokens (launches per token, idle share;
     no memset and no qmm_gemv kernel in any of them); then the three
     paths' decode timed in turns (A B C C B A A B C);
  8. the scan decoder at LLAMA3_8B (phases 4-7's planes freed first):
     uniform Q4_K planes made on the card, Context(scan_layers=True), whose
     every layer matmul runs K7 (4 a layer a token) and the lm_head K1;
     the same planes through the per-layer Context, whose greedy tokens
     must be the scan's; the scan with gdot (K7's K5 variant, lm_head on
     K5) and with chain and gdot (layers on K7, lm_head on K6), 16 tokens
     each, enough for their launches per token; uniform Q8_0 planes (K7 on
     int8 planes, lm_head on K2); the Q4_K and Q8_0 scans profiled (no
     memset, no qmm_gemv kernel);
  9. the text entry point on a GGUF: a file at LLAMA3_8B's widths and 4
     of its 32 layers (GGUF_LAYERS, cut for time) typed as Q4_K_M
     (Q6_K lm_head, attn_v and ffn_down of the use_more_bits layers) with
     random blocks and a 128256-token byte-level BPE vocab
     (tools/synth_gguf.py), written with the port's writer into a
     temporary directory; `python -m llm_tpu_torch.tools.cli -m <file> -p
     <~512-token prompt> -n 128 --temp 0 -c 4096` run as a user runs it
     (its stdout, "model loaded in" line and PerfCounters line logged),
     while this process loads the same file (both loads build the planes
     on the host); once the CLI has exited, cli.generate's greedy tokens
     held equal to Context.decode of the prompt followed by generate_loop,
     and its text to what the CLI printed; the write and load times and
     the peak host and device memory logged;
 10. the server on phase 9's Context and tokenizer: the port's ServerApp
     (http.server) on 127.0.0.1 at a free port with 4 slots, driven with
     urllib: /health, /props, /v1/models, /tokenize, /detokenize; four
     concurrent greedy streamed /completions of ~128-token prompts (n_predict
     64) through the batched fast path (fast_chunks_total > 0, K3 launched
     at T >= 2, its launches logged by T),
     each equal to its prompt's decode + generate_loop or parted only at a
     near tie; eight concurrent seeded sampled ones (temp 0.8, top_k 40); a
     streamed chat completion equal to the unstreamed one; a response_format
     enum schema whose answer parses to "yes" or "no"; a --lookup-ngram
     server's greedy text against the plain one; a slot save / restore; two
     embeddings. TTFT, total time and aggregate decode tok/s logged, and the
     wall time of one batched step's token choice at B = 4 (sample_rows,
     greedy and sampled, and the argmax); the directory deleted;
 11. Gemma-2-9B at 12 of its 42 layers (Q4_K_M-style random planes made
     on the card, tied Q6_K lm_head): the ISWA ring Context (8192 cells, a
     4608-cell ring) prefills 4608 tokens in 512-token steps and decodes
     128 greedy tokens, each on a reused ring cell (K3w_cap/K4w_cap, no
     uncapped flash launch; profiled over 8 more tokens; the cache beside
     swa_full's); swa_full on the same planes: the same greedy stream or
     one parted at a near tie, prompt logits within the two-layer
     tolerance; swa_window = 0: the prompt's last logits (position 4607)
     apart by more than it; a q8_0 ring (prefill 512, 32 tokens:
     K3qw_cap/K4qw_cap) whose first 128 prompt cells, in both of its
     tables, go through a state file into a fresh q8_0 ring Context, one
     decode step against the uninterrupted one;
 12. Baichuan-13B at full width and 20 of its 40 layers (Q4_K_M-style random planes made
     on the card, Q8_0 ffn_down at K = 13696), rope NONE and ALiBi: 4096
     cells, prefill 512 and 128 greedy tokens with the bf16 cache
     (K3_alibi/K4_alibi, no other flash launch; profiled over 8 more
     tokens; the cache's 3,355,443,200 bytes), the prompt's logits with
     alibi_max_bias = 0 apart by more than the two-layer tolerance, and
     the q8_0 cache (prefill 512, 32 tokens: K3q_alibi/K4q_alibi);
 13. Qwen3-30B-A3B at 12 of its 48 layers (QWEN3_LAYERS, cut for time;
     Q4_K_M-style random planes
     made on the card: 128 experts a layer as rows-layout stacks, Q6_K
     ffn_down_exps and attn_v in the use_more_bits layers, a bf16 router,
     an untied Q6_K lm_head), 4096 cells: prefill 512 (the grouped
     dispatch) and 128 greedy tokens (the gather) with the bf16 cache (K3/K4
     a layer a step at G = 8; profiled over 8 more tokens with the MoE
     FFN's and its gather-dequant's device ms and launches a token; the
     cache's bytes, the planes' and the peak memory), chain=True for 16
     tokens (K6 heads, unchained MoE tails; the stream equal to the
     unchained one or parted only at a near tie), and the q8_0 cache for
     32 tokens (K3q/K4q);
 14. Gemma-7B with chain=True at full width and 14 of its 28 layers (Q4_K_M-
     style random planes, a tied Q6_K table of 256000 rows), 4096 cells:
     prefill 512 and 128 greedy tokens, a GeGLU tail on K6_gelu in every
     layer of every token, K3w/K4w (profiled over 8 more tokens); the
     unchained Context's 128 tokens on the same planes, the streams equal
     or parted only at a near tie, and 4 decode steps of distinct tokens
     on both, every step's logits within the chained twin's tolerance
     (as for phase 13's chain=True run);
 15. (run after phase 8 has freed its planes) LLAMA3_8B at 32 layers on
     Q3_K_M-style planes made on the card (Q3_K nibble planes at group
     size 16, Q5_K / Q4_K attn_v, Q4_K down in layers 0-1, Q6_K lm_head):
     prefill 512 and 128 greedy tokens with every kernel's launches
     (K1_gs16), profiled over 8 more tokens; gdot=True (K5_gs16) and
     chain=True, gdot=True (K6_gs16), 16 tokens each, each stream equal
     to the unfused one or parted only at a near tie; Q2_K-recipe planes,
     prefill 512 and 32 tokens; uniform Q2_K planes through
     Context(scan_layers=True) (K7_gs16, 16 tokens) against the
     per-layer Context's greedy tokens;
 16. (after phase 15) the IQ and ternary types (phase_iq): LLAMA3_8B at 32
     layers on IQ2_XXS-recipe and IQ1_M-recipe planes made on the card
     (f32 scales; IQ1_M's int8 planes at group size 8 on K2_gs8), and
     BitNet b1.58 2B4T at 30 layers on TQ2_0 planes (nibbles at group size
     256, zero point 1, on K1_gs256): prefill 512 and 128 greedy tokens
     each, profiled over 8 more; IQ1_M and BitNet with chain=True,
     gdot=True (K6_gs8 tails on IQ1_M; K5_gs256 on BitNet), 16 tokens,
     each stream equal to the unfused one or parted only at a near tie,
     and 4 decode steps' logits within full_depth_tol of the unfused
     ones (BitNet's squared relu keeps it unchained, as the reference's
     gate does; K6_gs256 runs on LLAMA3_8B's TQ2_0-recipe planes at
     IQ_TQ2_LLAMA_LAYERS layers with chain=True, gdot=True); uniform TQ2_0
     and IQ1_M planes through
     Context(scan_layers=True) (K7_gs256, K7_gs8) against the per-layer
     Context (prefill logits within full_depth_tol). Phase 2 holds those
     kernels against their plain versions at BitNet's and LLAMA3_8B's
     shapes (at decode within 1.5e-5 of max|y|, the K6 forms within one
     bf16 step) and K2 on every other IQ type; phase 3 runs IQ1_M and
     bitnet TQ2_0 GGUF twins.
 17. (after phase 14) GLM-4-9B-0414 at full width and 20 of its 40 layers (GLM4_LAYERS,
     phase_glm4_9b): Q4_K_M-style random planes made on the card (a Q8_0
     down at K = 13696, gate+up packed in one matrix, QKV biases,
     post-norms), 4096 cells: prefill 512 and 128 greedy tokens with the
     bf16 cache (K1/K2, K3/K4 at G = 16 with rope on 64 of 128 dims;
     profiled over 8 more tokens), the same with gdot (K5; the stream equal
     or parted only at a near tie) and 512 + 32 with the q8_0 cache
     (K3q/K4q); prefill tok/s, ms a token, launches a token, idle share,
     the planes' bytes and the bytes bound, peak memory, each beside the
     card's name and power limit. Phase 2 holds K1/K2 at its matmuls and
     K3/K4 at its heads; phase 3 runs a two-layer GLM-4-9B GGUF twin.
 18. (after phase 17) Command-R v01 at full width (8192, 64 heads over 64
     KV heads of 128, ff 22528, a tied 256000-row Q6_K table;
     COMMAND_R_LAYERS of its 40 layers; phase_command_r_35b): Q4_K_M-style
     random planes made on the card with LayerNorm weights and the
     parallel block, 4096 cells: prefill 512 and 128 greedy tokens with the
     bf16 cache (K1/K2, K3/K4 at G = 1; profiled over 8 more tokens), with
     gdot (K5) for COMMAND_R_GDOT_DECODE tokens (the stream equal or parted
     only at a near tie), with chain=True for CHAIN_STEPS decode steps
     whose logits equal the unchained ones bit for bit (the chain gate
     refuses LayerNorm; no K6 launch), and 512 + COMMAND_R_Q8_DECODE with
     the q8_0 cache (K3q/K4q); prefill tok/s, ms a token, launches a
     token, idle share, the planes' and cache's bytes, the bytes bound and
     peak memory, each beside the card's name and power limit. Phase 2
     holds K1/K2 at its matmuls (the lm_head at B = 1 and 512) and
     K3/K3q/K4/K4q at its heads; phase 3 runs a two-layer Command-R GGUF
     twin (vocab cut to COMMAND_R_TWIN_VOCAB).
 19. (after phase 18) Gemma-2-27B at full width (4608, 32 query heads over
     16 KV heads of 128, ff 36864, a tied 256000-row Q6_K table;
     GEMMA2_27B_LAYERS of its 46 layers, the 46-layer config's scale
     144^-0.5 kept; phase_gemma2_27b): Q4_K_M-style random planes made on
     the card, 1024 cells: prefill 512 and GEMMA2_27B_DECODE greedy tokens
     with the bf16 cache (K4_cap a layer at the prefill step, the narrow
     CTA's capped instantiation, and no K4w_cap; K3w_cap a layer a token)
     and with the q8_0 cache (K4q_cap; K3qw_cap); each against a second
     Context fed the same prompt 8 tokens a step (K3w_cap / K3qw_cap): the
     prompt's last logits within the two-layer tolerance of max|logit|.
The last lines are a JSON "kernels" line, the card line, and
{"ok": true, "device": {...}}. It imports nothing of JAX or llm_tpu.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM data sheet: HBM3 3.35 TB/s, dense bf16 989 TFLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
L2_BYTES = 50 << 20


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(fn, n_variants: int = 1, iters: int = 50) -> float:
    """Mean device time of fn(i) over iters launches, measured with CUDA
    events around a CUDA graph of the launches (so host overhead between
    launches is not counted). fn(i) cycles over n_variants input copies so
    that, where the inputs exceed L2, each launch finds them cold."""
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


def copies_for(nbytes: int) -> int:
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def qt_bytes(qt) -> int:
    return sum(t.numel() * t.element_size() for t in (qt.qs, qt.scales, qt.mins)
               if t is not None)


def dequant_bf16(qt):
    """[K, N] bf16 weight for the library yardstick (torch.matmul)."""
    from llm_tpu_torch.ops.cuda_qmm import unpack_planes

    q = unpack_planes(qt).float()
    K, N = q.shape
    gs = qt.group_size
    w = q.reshape(K // gs, gs, N) * qt.scales.float()[:, None, :]
    if qt.mins is not None:
        w = w - qt.mins.float()[:, None, :]
    return w.reshape(K, N).to(torch.bfloat16)


def sass_functions(lib: str) -> dict:
    """{mangled kernel name: its SASS} of lib<lib>.so, by the toolkit's
    cuobjdump."""
    import re
    from pathlib import Path

    from llm_tpu_torch.ops import cuda_build

    tool = str(Path(cuda_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cuda_build.BUILD_DIR / f"lib{lib}.so")],
                          capture_output=True, text=True, check=True).stdout
    return {f.split("\n", 1)[0].strip(): f for f in re.split(r"\n\s*Function : ", sass)[1:]}


def check_sass(tag: str, libs: dict, name: str, need: tuple, gone) -> dict:
    """Machine code of built libraries: lib<lib>.so holds libs[lib] kernels
    whose name contains `name`, each of which issues every instruction in
    `need`, and no kernel whose name contains `gone` (the kernel they
    replaced; a tuple: any of them)."""
    gone = (gone,) if isinstance(gone, str) else gone
    out = {}
    for lib, n in libs.items():
        funcs = sass_functions(lib)
        mine = [v for k, v in funcs.items() if name in k]
        rec = out[lib] = dict(kernels=len(mine),
                              old_kernels=sum(any(x in k for x in gone) for k in funcs), **{
            f"{ins.lower()}_min": min((v.count(ins) for v in mine), default=0) for ins in need})
        if len(mine) != n or rec["old_kernels"] or \
                any(rec[f"{ins.lower()}_min"] == 0 for ins in need if n):
            raise AssertionError(f"lib{lib}.so: {tag} machine code {rec}")
    log(json.dumps({tag: out}))
    return out


# the decode GEMV's kernels in libqmm_decode.so: p4/i8 x f32/bf16 scales x
# mins x 8/16 rows (K1/K2/K7), K5's on p4 planes (qmm_decode_gdot), and
# both on nibble planes at group size 16 (qmm_decode_g16,
# qmm_decode_gdot_g16: f32/bf16 scales x mins x 8/16 rows each)
DECODE_G16_KERNELS = 8 + 8
# and on nibble planes at group size 256 (qmm_decode_g256,
# qmm_decode_gdot_g256) and on int8 planes at group size 8 (qmm_decode_g8)
DECODE_G256_KERNELS = 8 + 8
DECODE_G8_KERNELS = 8
DECODE_KERNELS = 16 + 8 + DECODE_G16_KERNELS + DECODE_G256_KERNELS + DECODE_G8_KERNELS
# the prefill GEMM's in libqmm.so and libqmm_stacked.so: p4/i8 x f32/bf16
# scales x mins (qmm_wgmma), p4 at group size 16 (qmm_wgmma_g16) and 256
# (qmm_wgmma_g256), i8 at group size 8 (qmm_wgmma_g8)
GEMM_G16_KERNELS = 4
GEMM_G256_KERNELS = 4
GEMM_G8_KERNELS = 4
GEMM_KERNELS = 8 + GEMM_G16_KERNELS + GEMM_G256_KERNELS + GEMM_G8_KERNELS
# K6's kernels in libqmm_chain.so: SwiGLU, GeGLU, and the forms with
# phases at group size 16, 256 and 8
CHAIN_KERNELS = 5
# the rows of phase 2 on the forms this card's kernels added for the IQ and
# ternary types (K1/K5/K7 at group size 256, K2/K7 at 8): at decode (B <=
# 16) within NEW_FORM_REL_TOL of max|y| of the plain version; the prefill
# GEMM, whose bf16 hi + lo weights round differently from the plain f32
# product (up to 1.9e-5 of max|y| at K = 14336 on the main path's planes),
# at the 1e-3 of the other rows
NEW_FORM_REL_TOL = 1.5e-5
# S1's kernels in libqmm_probe.so: 1, 2 or 4 rows of x x mins x three modes
S1_KERNELS = 18
# K3/K3q's kernels: bf16 / q8_0 cache x one, two or four n8 tiles of rows,
# at head dim 128 (flash_decode_tc) and at 64, 80, 96 and any other D
# (flash_decode_tc_dim); the wide ones (flash_decode_tc_wide): bf16 / q8_0
# x one or two n8 tiles x one or two 128-dim chunks; and as many capped
# (gemma2's softcap: flash_decode_tc_wide_cap); and the narrow ones' ALiBi
# instantiations at 128 and at any other D (flash_decode_tc_alibi)
K3_CAP_KERNELS = 8
K3_ALIBI_KERNELS = 6 * 2
K3_KERNELS = 6 * 5 + 8 + K3_CAP_KERNELS + K3_ALIBI_KERNELS
# K4/K4q's: bf16 / q8_0 cache, at 128 and at 64, 80, 96 and any other D,
# the wide ones (flash_prefill_wgmma_wide, one or two 128-dim chunks), the
# capped wide ones, the narrow ones' capped instantiations at 128 and at
# any other D (flash_prefill_wgmma_cap), and the ALiBi ones at 128 and at
# any other D (flash_prefill_wgmma_alibi)
K4_WIDE_KERNELS = 2 * 2
K4_CAP_KERNELS = 2 * 2
K4_NARROW_CAP_KERNELS = 2 * 2
K4_ALIBI_KERNELS = 2 * 2
K4_KERNELS = 2 * 5 + K4_WIDE_KERNELS + K4_CAP_KERNELS + K4_NARROW_CAP_KERNELS + K4_ALIBI_KERNELS

# S3's split-S kernels in libflash_probe.so: stacked v1 / v0 and the three
# q8 modes
S3_SPLIT_KERNELS = 5


def check_qmm(results, name, qtype, K, N, B, scales_dtype=torch.bfloat16, rel_tol=1e-3):
    from llm_tpu_torch.models.synthetic import device_synthetic_qtensor
    from llm_tpu_torch.ops import cuda_qmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(K * 7 + N + B)
    nb = qt_bytes(device_synthetic_qtensor(gen, N, K, qtype, scales_dtype))
    ncp = copies_for(nb)
    qts = [device_synthetic_qtensor(gen, N, K, qtype, scales_dtype) for _ in range(ncp)]
    x = (torch.randn((B, K), generator=gen, device="cuda")).to(torch.bfloat16)
    y = cuda_qmm.qmm_cuda(x, qts[0])
    want = cuda_qmm.qmm_plain(x, qts[0], torch.bfloat16)
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    tol = rel_tol * want.abs().max().item()
    ms = time_ms(lambda i: cuda_qmm.qmm_cuda(x, qts[i]), ncp)
    plain_ms = time_ms(lambda i: cuda_qmm.qmm_plain(x, qts[i], torch.bfloat16), ncp, iters=5)
    ws = [dequant_bf16(q) for q in qts[:copies_for(K * N * 2)]]
    lib_ms = time_ms(lambda i: torch.matmul(x, ws[i]), len(ws))
    del ws
    bmin, by = bound_ms(nb + B * K * 2 + B * N * 4, 2.0 * B * K * N)
    kern = cuda_qmm.kernel_name("K1", qts[0])
    rec = dict(kernel=kern, shape=f"{name} {qtype.name} K={K} N={N} B={B}",
               max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bmin,
               bound_by=by, library_ms=lib_ms)
    log(json.dumps(rec))
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{kern} {rec['shape']}: max|err| {err} > {tol}")
    results.append(rec)


def check_gdot(results, name, K, N, B, qtype="Q4_K", rel_tol=1e-3,
               scales_dtype=torch.bfloat16):
    """K5 at a p4 shape, beside K1 on the same inputs (probe S2 of the TPU
    package, scripts/kbench6.py); its bound and library call are K1's."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import device_synthetic_qtensor
    from llm_tpu_torch.ops import cuda_qmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(K * 5 + N + B)
    nb = qt_bytes(device_synthetic_qtensor(gen, N, K, GGMLType[qtype], scales_dtype))
    ncp = copies_for(nb)
    qts = [device_synthetic_qtensor(gen, N, K, GGMLType[qtype], scales_dtype)
           for _ in range(ncp)]
    x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
    y = cuda_qmm.qmm_cuda(x, qts[0], gdot=True)
    want = cuda_qmm.qmm_gdot_plain(x, qts[0], torch.bfloat16)
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    tol = rel_tol * want.abs().max().item()
    ms = time_ms(lambda i: cuda_qmm.qmm_cuda(x, qts[i], gdot=True), ncp)
    k1_ms = time_ms(lambda i: cuda_qmm.qmm_cuda(x, qts[i]), ncp)
    plain_ms = time_ms(lambda i: cuda_qmm.qmm_gdot_plain(x, qts[i], torch.bfloat16), ncp,
                       iters=5)
    ws = [dequant_bf16(q) for q in qts[:copies_for(K * N * 2)]]
    lib_ms = time_ms(lambda i: torch.matmul(x, ws[i]), len(ws))
    del ws
    bmin, by = bound_ms(nb + B * K * 2 + B * N * 4, 2.0 * B * K * N)
    rec = dict(kernel=cuda_qmm.kernel_name("K5", qts[0]),
               shape=f"{name} {qtype} K={K} N={N} B={B}", max_abs_err=err, tol=tol,
               ms=ms, k1_ms=k1_ms, plain_ms=plain_ms, bound_ms=bmin, bound_by=by,
               library_ms=lib_ms)
    log(json.dumps(rec))
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{rec['kernel']} {rec['shape']}: max|err| {err} > {tol}")
    results.append(rec)


# K7 against the unstacked kernel on the same layer: the same arithmetic on
# the same bytes. The decode GEMV (B <= 16 without gdot) sums in a fixed
# order: bit-equal. Elsewhere, where K is split over CTAs, f32 atomics add
# the partial sums in an order that varies from launch to launch, a few
# ulps of max|y|
K7_VS_UNSTACKED_REL_TOL = 1e-5


def check_stacked(results, name, qtype, K, N, B, gdot=False, rel_tol=1e-3,
                  scales_dtype=torch.bfloat16):
    """K7 on a stack of planes whose layers differ (enough layers to exceed
    L2, so that a launch cycling over the layers finds them cold): layers 0
    and 1 against its plain version and against K1/K2/K5 launched on the
    layer's own planes (a view of the stack); timed beside that kernel, the
    plain version and torch.matmul on the layer's pre-dequantized bf16
    weight."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import device_synthetic_qtensor
    from llm_tpu_torch.ops import cuda_qmm
    from llm_tpu_torch.quant.qtensor import QTensor, StackedWeight

    bit_equal = not gdot and B <= cuda_qmm.GDOT_MAX_B
    gen = torch.Generator(device="cuda")
    gen.manual_seed(K * 3 + N + B + gdot)
    layers = [device_synthetic_qtensor(gen, N, K, GGMLType[qtype], scales_dtype)]
    nb = qt_bytes(layers[0])
    layers += [device_synthetic_qtensor(gen, N, K, GGMLType[qtype], scales_dtype)
               for _ in range(max(2, copies_for(nb)) - 1)]
    L = len(layers)
    one = layers[0]
    stack = (lambda ts: torch.stack(ts))
    qt = QTensor(stack([q.qs for q in layers]), stack([q.scales for q in layers]),
                 None if one.mins is None else stack([q.mins for q in layers]),
                 one.group_size, one.ggml_type, one.layout, one.zp, one.pack_tk, one.kmajor)
    del layers
    views = [qt.map(lambda t, il=il: t[il]) for il in range(L)]
    lids = torch.arange(L, dtype=torch.int32, device="cuda")
    sws = [StackedWeight(qt, lids[il:il + 1]) for il in range(L)]
    x = torch.randn((B, K), generator=gen, device="cuda").to(torch.bfloat16)
    err = diff = tol = dtol = 0.0
    for il in (0, 1):
        y = cuda_qmm.qmm_stacked_cuda(x, sws[il], gdot)
        want = cuda_qmm.qmm_stacked_plain(x, sws[il], torch.bfloat16, gdot)
        unst = cuda_qmm.qmm_cuda(x, views[il], gdot)
        torch.cuda.synchronize()
        err = max(err, (y - want).abs().max().item())
        diff = max(diff, (y - unst).abs().max().item())
        tol = max(tol, rel_tol * want.abs().max().item())
        if not bit_equal:
            dtol = max(dtol, K7_VS_UNSTACKED_REL_TOL * unst.abs().max().item())
    ms = time_ms(lambda i: cuda_qmm.qmm_stacked_cuda(x, sws[i], gdot), L)
    unst_ms = time_ms(lambda i: cuda_qmm.qmm_cuda(x, views[i], gdot), L)
    plain_ms = time_ms(lambda i: cuda_qmm.qmm_stacked_plain(x, sws[i], torch.bfloat16, gdot),
                       L, iters=5)
    ws = [dequant_bf16(views[i]) for i in range(min(L, copies_for(K * N * 2)))]
    lib_ms = time_ms(lambda i: torch.matmul(x, ws[i]), len(ws))
    del ws
    bmin, by = bound_ms(nb + B * K * 2 + B * N * 4, 2.0 * B * K * N)
    variant = "K5" if gdot else ("K1" if one.layout == "p4" else "K2")
    rec = dict(kernel=cuda_qmm.kernel_name("K7", one), variant=variant,
               shape=f"{name} {qtype} K={K} N={N} B={B}",
               layers=L, max_abs_err=err, tol=tol, unstacked_max_abs_diff=diff,
               unstacked_tol=dtol, ms=ms, unstacked_ms=unst_ms, plain_ms=plain_ms,
               bound_ms=bmin, bound_by=by, library_ms=lib_ms)
    log(json.dumps(rec))
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{rec['kernel']} {rec['shape']}: max|err| {err} > {tol}")
    if not diff <= dtol:  # 0 where bit_equal
        raise AssertionError(f"{rec['kernel']} {rec['shape']}: {diff} from {variant} on the "
                             "same layer")
    results.append(rec)


# K6 against its plain version on the card: a tail or head's output is
# bf16, so a last-bit difference of an f32 sum can move a value across a
# bf16 rounding boundary (of h, hn, cur or the output): one step is 2^-8
# of the value, 3.9e-3 of max|out| at most. Held at 1e-2 of max|out|.
K6_REL_TOL = 1e-2
# LLAMA3_8B chains at their main-path types: (name, [(K, N, type)], pres)
CHAINS = (
    ("tail Q4_K down", ((4096, 4096, "Q4_K"), (4096, 28672, "Q4_K"), (14336, 4096, "Q4_K")),
     ("cast", "res_norm", "swiglu")),
    ("tail Q6_K down", ((4096, 4096, "Q4_K"), (4096, 28672, "Q4_K"), (14336, 4096, "Q6_K")),
     ("cast", "res_norm", "swiglu")),
    ("head qkv", ((4096, 6144, "Q4_K"),), ("norm",)),
    ("lm_head Q6_K", ((4096, 128256, "Q6_K"),), ("norm",)),
)


# LLAMA3_8B's Q3_K_M tail (phase 15's planes): o_proj, gate+up and down on
# nibble planes at group size 16 (the use_more_bits layers' Q4_K down runs
# the same kernel beside them: K6_gs16)
LOWBIT_CHAINS = (
    ("tail Q3_K", ((4096, 4096, "Q3_K"), (4096, 28672, "Q3_K"), (14336, 4096, "Q3_K")),
     ("cast", "res_norm", "swiglu")),
)


# Gemma-7B's chains (phase 14's planes): the GeGLU tail with a Q4_K and a
# Q6_K down (o_proj 4096 -> 3072, gate+up 3072 -> 49152, down 24576 ->
# 3072: K6_gelu), and the fused head (3072 -> 12288: K6)
GEMMA7B_CHAINS = (
    ("gemma-7b tail Q4_K down", ((4096, 3072, "Q4_K"), (3072, 49152, "Q4_K"),
                                 (24576, 3072, "Q4_K")), ("cast", "res_norm", "geglu")),
    ("gemma-7b tail Q6_K down", ((4096, 3072, "Q4_K"), (3072, 49152, "Q4_K"),
                                 (24576, 3072, "Q6_K")), ("cast", "res_norm", "geglu")),
    ("gemma-7b head qkv", ((3072, 12288, "Q4_K"),), ("norm",)),
)


def unfused_chain(x, qts, gamma, x_res, pres, mm):
    """The chain as forward runs it unfused, with mm(x, i) for the i-th
    matmul (f32 out): K1/K2 launches, or torch.matmul on bf16 weights."""
    from llm_tpu_torch.ops.cuda_qmm_chain import GLU
    from llm_tpu_torch.ops.norms import rms_norm

    bf = torch.bfloat16
    if pres[0] == "norm":
        y = mm(rms_norm(x, gamma, 1e-5), 0)
        return y if qts[0].out_features == 128256 else y.to(bf)
    h = x_res + mm(x, 0).to(bf)
    g, u = mm(rms_norm(h, gamma, 1e-5), 1).chunk(2, dim=-1)
    return h + mm((GLU[pres[2]](g) * u).to(bf), 2).to(bf)


def check_chain(results, name, dims, pres, B, rel_tol=K6_REL_TOL, scales_dtype=torch.bfloat16,
                one_step=False):
    """K6 on one chain at B rows: against qmm_chain_plain, and timed beside
    the unfused path it replaces (K1/K2 launches, memsets and torch glue),
    the plain version, and the library yardstick: the same chain of
    torch.matmul over pre-dequantized bf16 weights with the same glue."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import device_synthetic_qtensor
    from llm_tpu_torch.ops import cuda_qmm, cuda_qmm_chain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(sum(n for _, n, _ in dims) + B)
    qts = [device_synthetic_qtensor(gen, n, k, GGMLType[t], scales_dtype) for k, n, t in dims]
    K0, N0 = dims[0][0], dims[0][1]
    bf = torch.bfloat16
    x = torch.randn((B, K0), generator=gen, device="cuda").to(bf)
    x_res = torch.randn((B, N0), generator=gen, device="cuda").to(bf) \
        if pres[0] == "cast" else None
    gamma = 1 + 0.2 * torch.randn(dims[1][0] if pres[0] == "cast" else K0, generator=gen,
                                  device="cuda")
    out_dtype = torch.float32 if N0 == 128256 else bf
    final = "add_res" if pres[0] == "cast" else "cast"
    kw = dict(pres=pres, eps=1e-5, final=final, out_dtype=out_dtype)
    run = (lambda: cuda_qmm_chain.qmm_chain_cuda(x, qts, (gamma,), x_res, **kw))
    got = run()
    want = cuda_qmm_chain.qmm_chain_plain(x, qts, (gamma,), x_res, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    # one_step: one bf16 step (the spacing of bf16 values at max|out|)
    tol = 2.0 ** (math.floor(math.log2(top)) - 7) if one_step else rel_tol * top
    ms = time_ms(lambda i: run())
    unfused_ms = time_ms(lambda i: unfused_chain(
        x, qts, gamma, x_res, pres, lambda a, j: cuda_qmm.qmm_cuda(a.contiguous(), qts[j])))
    plain_ms = time_ms(lambda i: cuda_qmm_chain.qmm_chain_plain(x, qts, (gamma,), x_res, **kw),
                       iters=3)
    ws = [dequant_bf16(q) for q in qts]
    lib_ms = time_ms(lambda i: unfused_chain(x, qts, gamma, x_res, pres,
                                             lambda a, j: torch.matmul(a, ws[j]).float()))
    del ws
    nbytes = sum(qt_bytes(q) for q in qts) + x.numel() * 2 + got.numel() * got.element_size()
    nbytes += x_res.numel() * 2 if x_res is not None else 0
    bmin, by = bound_ms(nbytes, sum(2.0 * B * k * n for k, n, _ in dims))
    gelu = "geglu" in pres
    kern = cuda_qmm_chain.chain_kernel(qts, gelu)
    rec = dict(kernel=kern, shape=f"{name} B={B}", max_abs_err=err, tol=tol, ms=ms,
               unfused_ms=unfused_ms, plain_ms=plain_ms, bound_ms=bmin, bound_by=by,
               library_ms=lib_ms, plan=cuda_qmm_chain.launch_plan(qts, gelu),
               clusters=cuda_qmm_chain.chain_clusters(kern))
    if gelu:
        # the tail without its residual (final "cast": the FFN's output,
        # which h would hide): the kernel against the plain GeGLU, and the
        # plain SwiGLU apart from it by more than twice the tolerance, so
        # that the activation is live
        ffn = dict(kw, final="cast")
        got_f = cuda_qmm_chain.qmm_chain_cuda(x, qts, (gamma,), x_res, **ffn).float()
        want_f = cuda_qmm_chain.qmm_chain_plain(x, qts, (gamma,), x_res, **ffn).float()
        silu_f = cuda_qmm_chain.qmm_chain_plain(
            x, qts, (gamma,), x_res, **dict(ffn, pres=(*pres[:2], "swiglu"))).float()
        rec.update(ffn_max_abs_err=(got_f - want_f).abs().max().item(),
                   ffn_tol=K6_REL_TOL * want_f.abs().max().item(),
                   silu_vs_gelu_ffn_max_abs_diff=(silu_f - want_f).abs().max().item())
        rec["max_abs_err"] = max(err, rec["ffn_max_abs_err"])
    log(json.dumps(rec))
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{kern} {rec['shape']}: max|err| {err} > {tol}")
    if gelu and not (rec["ffn_max_abs_err"] <= rec["ffn_tol"]
                     and rec["silu_vs_gelu_ffn_max_abs_diff"] > 2 * rec["ffn_tol"]):
        raise AssertionError(f"{kern} {rec['shape']}: the GeGLU FFN's output: {rec}")
    results.append(rec)


def tensor_bytes(x) -> int:
    """Bytes of a tensor, or of every tensor in a tuple (a q8_0 pair)."""
    parts = x if isinstance(x, tuple) else (x,)
    return sum(t.numel() * t.element_size() for t in parts)


def quantized(inp):
    """kbench_attn.attn_inputs with K and V made q8_0 pairs by the port's
    quantizer."""
    from llm_tpu_torch.models.transformer import quantize_rows

    return {**inp, "k": quantize_rows(inp["k"], 1), "v": quantize_rows(inp["v"], 1)}


def sdpa_backend(*args, **kw) -> str:
    """The SDPA backend that PyTorch's dispatcher takes for these inputs:
    the first, in its priority order, that accepts them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    order = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
    prio = getattr(torch._C, "_get_sdp_priority_order", None)
    if prio is not None:
        by_value = {int(b): b for b in order}
        order = [by_value[int(v)] for v in prio() if int(v) in by_value] or order
    for b in order:
        try:
            with sdpa_kernel([b]):
                torch.nn.functional.scaled_dot_product_attention(*args, **kw)
            return b.name
        except RuntimeError:
            continue
    return "none"


def per_sequence_bias(T: int, S: int, prompt: int, chunk: int = 8) -> torch.Tensor:
    """The bias of one step of Context.generate_loop_batch over T sequences:
    cells [0, T * prompt) hold the T prompts one run each, the rest come in
    runs of `chunk` cells dealt to the sequences in turn (a call's cells);
    row t sees only its own sequence's cells, the last run up to its row."""
    c = torch.arange(S, device="cuda")
    tail = (c - T * prompt).clamp(min=0)
    owner = torch.where(c < T * prompt, c // prompt, (tail // chunk) % T)
    rows = torch.arange(T, device="cuda")[:, None]
    seen = (owner[None, :] == rows) & (c[None, :] < S - rows)
    return torch.where(seen, 0.0, float("-inf")).float().contiguous()


ALIBI_KEYS = ("alibi_slopes", "tok_pos", "cell_pos")
ROPE_KEYS = ("q_rot", "cos", "sin")


def alibi_inputs(inp, T: int, S: int, H: int) -> dict:
    """attn_inputs (a causal run of T tokens ending at position
    S - S/2 - 1 over cells at positions 0..S-1) on rope NONE (no q_rot,
    cos or sin), with ALiBi's slopes of max_bias 8 for H heads and the
    tokens' and cells' positions in f32: Baichuan-13B's and refact's
    attention."""
    from llm_tpu_torch.models.transformer import alibi_slopes

    slopes = torch.tensor(alibi_slopes(H, ALIBI_MAX_BIAS), dtype=torch.float32, device="cuda")
    return {**{n: x for n, x in inp.items() if n not in ROPE_KEYS},
            "q_rot": None, "cos": None, "sin": None, "alibi_slopes": slopes,
            "tok_pos": (torch.arange(T, device="cuda") + S // 2 - T).float(),
            "cell_pos": torch.arange(S, device="cuda").float()}


def without_alibi(inp) -> dict:
    """inp of alibi_inputs without the ALiBi term, on the identity rope
    tables (q_rot 0, cos 1, sin 0) that the kernels without ALiBi read."""
    q = inp["q"]
    S, D = inp["bias"].shape[1], q.shape[-1]
    return {**{n: x for n, x in inp.items() if n not in ALIBI_KEYS},
            "q_rot": torch.zeros_like(q),
            "cos": torch.ones((S, D), dtype=torch.bfloat16, device=q.device),
            "sin": torch.zeros((S, D), dtype=torch.bfloat16, device=q.device)}


def attn_kernel(T: int, D: int, Dv: int, q8: bool, softcap: float, alibi: bool) -> str:
    """The LAUNCHES key the dispatcher counts for a step of these heads
    (cuda_attn.decode_kernel / prefill_kernel; a checkout run by --root
    that predates them took every capped step wide)."""
    from llm_tpu_torch.ops import cuda_attn

    fn = getattr(cuda_attn, "decode_kernel" if T <= 8 else "prefill_kernel", None)
    if fn is not None:
        return fn(D, Dv, q8, softcap, alibi)
    narrow = cuda_attn.is_narrow(D, Dv, q8) and softcap <= 0.0
    return (("K3" if T <= 8 else "K4") + ("q" if q8 else "") + ("" if narrow else "w")
            + ("_cap" if softcap > 0 else "") + ("_alibi" if alibi else ""))


def flex_capped_ms(qs, ks, vs, bias, scale: float, softcap: float):
    """(ms, None) of one torch.nn.attention.flex_attention call, compiled,
    with a score_mod of softcap * tanh(s / softcap) + bias[t, s] on the
    same pre-roped, GQA-expanded bf16 q, K, V as SDPA's (the capped rows'
    library yardstick: the port never calls it), or (None, the reason)
    where it does not compile or run."""
    try:
        from torch.nn.attention.flex_attention import flex_attention

        flex = torch.compile(flex_attention)
        bias = bias.float().contiguous()

        def capped(score, b, h, q_idx, kv_idx):
            return softcap * torch.tanh(score / softcap) + bias[q_idx, kv_idx]

        def run(_i):
            return flex(qs, ks, vs, score_mod=capped, scale=scale)

        run(0)
        torch.cuda.synchronize()
        return time_ms(run), None
    except Exception as e:  # noqa: BLE001 (any failure of the yardstick is recorded)
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200] if str(e) else ''}"


def check_attn(results, name, T, S, H=32, Hkv=8, D=128, q8=False, Dv=None, prompt=None,
               softcap=0.0, alibi=False, n_rot=None, flex=False):
    """K3/K4 (K3q/K4q on q8_0 pairs; the wide kernels where Dk != Dv, past
    128 or at int8 rows of 8 mod 16 bytes) against attn_plain, timed beside
    their bound and SDPA. D is Dk; Dv None: D. prompt: each of the T rows is
    its own sequence's, prompts of that many cells (per_sequence_bias);
    None: one causal sequence. softcap > 0: the capped kernels (K3w_cap,
    K3qw_cap at decode; K4_cap, K4q_cap at a prefill step the narrow kernels
    take, else K4w_cap, K4qw_cap) against attn_plain(softcap=), at scores
    scaled by CAP_SCORE_SCALE, where attn_plain without the cap must differ
    from attn_plain with it by more than the tolerance; no one SDPA call
    computes capped attention, so the library column is None (flex: the
    time of flex_attention with the cap as a score_mod, flex_capped_ms),
    with SDPA's uncapped time and the uncapped kernel's at the same shape
    logged beside it. alibi: the narrow kernels' ALiBi instantiations
    (K3_alibi, K3q_alibi, K4_alibi, K4q_alibi) on alibi_inputs against
    attn_plain(alibi_slopes=, tok_pos=, cell_pos=), where attn_plain
    without the term must differ by more than the tolerance; timed beside
    the kernel without ALiBi at the same shape (on the identity rope
    tables) and SDPA with the ALiBi term and the bias in its float mask
    [1, H, T, S] (which computes the same function: the library column).
    The bound counts what the function needs: the bytes of the tensors
    given (an ALiBi call has no q_rot, cos or sin) and, under ALiBi, one
    score dot of Dk, not the two of a rope fold. n_rot: rope on the first
    n_rot dims only (GLM-4's 64 of 128), the tables 1 / 0 past them."""
    from llm_tpu_torch.ops import cuda_attn
    from llm_tpu_torch.ops.rope import ROPE_TYPE_NORM, apply_rope
    from llm_tpu_torch.tools.kbench_attn import attn_inputs

    Dv = Dv or D
    quant = quantized if q8 else (lambda x: x)
    seq_bias = None if prompt is None else per_sequence_bias(T, S, prompt)

    def prep(x):
        x = alibi_inputs(x, T, S, H) if alibi else x
        return quant(x if seq_bias is None else {**x, "bias": seq_bias})

    inp, (c, s) = attn_inputs(T, H, Hkv, S, D, seed=S + T, Dv=Dv, n_rot=n_rot)
    inp = prep(inp)
    scale = D ** -0.5 * (CAP_SCORE_SCALE if softcap > 0 else 1.0)
    # the dispatchers launch K3/K4, or K3q/K4q on q8_0 pairs, for CUDA tensors
    fn = cuda_attn.flash_decode if T <= 8 else cuda_attn.flash_prefill
    out = fn(**inp, scale=scale, softcap=softcap)
    want = cuda_attn.attn_plain(**inp, scale=scale, softcap=softcap)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    tol = 1e-3
    nbytes = sum(tensor_bytes(t) for t in inp.values() if t is not None) + T * H * Dv * 4
    ncp = copies_for(nbytes)
    inps = [inp] + [prep(attn_inputs(T, H, Hkv, S, D, seed=S + T + i, Dv=Dv, n_rot=n_rot)[0])
                    for i in range(1, ncp)]
    ms = time_ms(lambda i: fn(**inps[i], scale=scale, softcap=softcap), ncp)
    plain_ms = time_ms(lambda i: cuda_attn.attn_plain(**inps[i], scale=scale, softcap=softcap),
                       ncp, iters=5)
    # library yardstick: SDPA over pre-roped (and, for q8, pre-dequantized)
    # bf16 keys and values with the same additive mask
    kb, vb = (cuda_attn.dequant_bf16(inp[n]).to(torch.bfloat16) for n in ("k", "v"))
    k_roped = kb if alibi else \
        apply_rope(kb.transpose(0, 1), c, s, ROPE_TYPE_NORM, n_rot or D).transpose(0, 1)
    G = H // Hkv
    qs = inp["q"].transpose(0, 1)[None]
    ks = k_roped.repeat_interleave(G, dim=0)[None].contiguous()
    vs = vb.repeat_interleave(G, dim=0)[None].contiguous()
    mask = inp["bias"].clamp(min=-1e30)[None, None]
    if alibi:  # the ALiBi term of each head in the float mask [1, H, T, S]
        dist = inp["tok_pos"][:, None] - inp["cell_pos"][None, :]
        mask = mask - inp["alibi_slopes"][None, :, None, None] * dist[None, None]
    mask = mask.to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda i: sdpa(qs, ks, vs, attn_mask=mask, scale=scale))
    # two score dots of Dk (the rope fold; under ALiBi, rope NONE, one) and
    # one P.V of Dv a query row and cell, and ALiBi's multiply-add
    flops = 2.0 * T * H * S * ((D + Dv + 1) if alibi else (2 * D + Dv))
    bmin, by = bound_ms(nbytes, flops)
    narrow = cuda_attn.is_narrow(D, Dv, q8)
    kern = attn_kernel(T, D, Dv, q8, 0.0, False)
    dims = f"D={D}" if Dv == D else f"Dk={D} Dv={Dv}"
    if prompt is not None:
        dims += f" {T} sequences"
    if n_rot is not None:
        dims += f" rope {n_rot}/{D}"
    extra = {}
    if alibi:
        # the term is live: a kernel without it fails
        moves = (cuda_attn.attn_plain(**without_alibi(inp), scale=scale) - want).abs().max().item()
        plain_inps = [without_alibi(x) for x in inps]
        extra = dict(unalibi_kernel=kern, unalibi_ms=time_ms(
            lambda i: fn(**plain_inps[i], scale=scale), ncp), alibi_moves_plain_by=moves)
        kern = attn_kernel(T, D, Dv, q8, 0.0, True)
        dims += " alibi"
    if softcap > 0:
        # the cap is live at these scores: a kernel without it fails
        cap_moves = (cuda_attn.attn_plain(**inp, scale=scale) - want).abs().max().item()
        extra = dict(uncapped_kernel=kern, uncapped_ms=time_ms(
            lambda i: fn(**inps[i], scale=scale), ncp), sdpa_uncapped_ms=lib_ms,
            score_scale=scale, cap_moves_plain_by=cap_moves)
        kern = attn_kernel(T, D, Dv, q8, softcap, False)
        dims += f" cap={softcap:g}"
        lib_ms = None
        if flex:
            lib_ms, why = flex_capped_ms(qs, ks, vs, inp["bias"].clamp(min=-1e30), scale,
                                         softcap)
            extra.update(library="flex_attention", library_failed=why)
    rec = dict(kernel=kern, shape=f"{name} T={T} S={S} H={H} Hkv={Hkv} {dims}",
               max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bmin,
               bound_by=by, library_ms=lib_ms,
               sdpa_backend=sdpa_backend(qs, ks, vs, attn_mask=mask, scale=scale), **extra)
    if T > 8 and not narrow and hasattr(cuda_attn, "wide_prefill_plan"):
        chunks = cuda_attn.wide_prefill_chunks(D, Dv)
        rec["wide_plan"] = cuda_attn.wide_prefill_plan(
            T, H, Hkv, S, D, Dv, torch.cuda.get_device_properties(0).multi_processor_count,
            lambda sp: cuda_attn._wide_clusters(q8, chunks, sp))
    if T > 8:
        # K4/K4q run every score and P.V product twice (bf16 hi + lo of
        # k*cos, k*sin and p): their floor is twice the operations bound,
        # and a head dim below 128 is computed as 128 (its zero columns);
        # the ALiBi ones run the score dot once (k is exact in bf16) and
        # P.V twice
        work = 2.0 * T * H * S * (D + 2 * Dv) if alibi else 2 * flops
        rec["floor_ms"] = work / PEAK_BF16_FLOPS * 1e3
        if narrow and not softcap and D < 128:
            rec["padded_floor_ms"] = rec["floor_ms"] * 128 / D
    log(json.dumps(rec))
    if not (err <= tol and math.isfinite(err)):
        raise AssertionError(f"{kern} {rec['shape']}: max|err| {err} > {tol}")
    if softcap > 0 and not extra["cap_moves_plain_by"] > tol:
        raise AssertionError(f"{kern} {rec['shape']}: the cap moves attn_plain by only "
                             f"{extra['cap_moves_plain_by']} <= {tol}")
    if alibi and not extra["alibi_moves_plain_by"] > tol:
        raise AssertionError(f"{kern} {rec['shape']}: ALiBi moves attn_plain by only "
                             f"{extra['alibi_moves_plain_by']} <= {tol}")
    results.append(rec)


def phase_kernels():
    from llm_tpu_torch.gguf.constants import GGMLType

    Q4K, Q6K, Q80 = GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0
    results = []
    # every matmul shape of the Q4_K_M main path, at decode (B=1, and B=8,
    # the decode GEMV's 8-row block full), at a 512-token prefill step, and
    # at B=128 between them; the use_more_bits layers run attn_q, attn_k and
    # attn_v unfused (attn_v and ffn_down in Q6_K). The main path's lm_head
    # sees only the output rows (B=1; B=8 beside it).
    for B in (1, 8, 128, 512):
        for name, K, N in (("qkv", 4096, 6144), ("attn_q/o_proj", 4096, 4096),
                           ("attn_k", 4096, 1024), ("gate_up", 4096, 28672),
                           ("down", 14336, 4096)):
            check_qmm(results, name, Q4K, K, N, B)
        for name, K, N in (("attn_v", 4096, 1024), ("4096x4096", 4096, 4096),
                           ("down", 14336, 4096)):
            check_qmm(results, name, Q6K, K, N, B)
        for name, K, N in (("4096x4096", 4096, 4096), ("down", 14336, 4096)):
            check_qmm(results, name, Q80, K, N, B)
    # the prefill GEMM past its 128-row tiles at a ragged B (two full tiles
    # and a 44-row one)
    check_qmm(results, "gate_up", Q4K, 4096, 28672, 300)
    check_qmm(results, "qkv f32-scales", Q4K, 4096, 6144, 1, torch.float32)
    for B in (1, 128):
        check_qmm(results, "lm_head", Q4K, 4096, 128256, B)
    for B in (1, 8):
        check_qmm(results, "lm_head", Q6K, 4096, 128256, B)
    check_attn(results, "decode half-masked", 1, 4096)
    check_attn(results, "decode ragged-S", 1, 4001)
    check_attn(results, "decode T=8", 8, 4096)
    check_attn(results, "prefill", 512, 4096)
    check_attn(results, "decode half-masked", 1, 4096, q8=True)
    check_attn(results, "decode ragged-S", 1, 4001, q8=True)
    check_attn(results, "decode T=8", 8, 4096, q8=True)
    check_attn(results, "prefill", 512, 4096, q8=True)
    # the server's batched steps (phase 10): T = B_pad = 2 or 4 rows, each
    # its own sequence's, over prompts of SERVER_PROMPT_TOKENS cells and
    # runs of 8 decode cells (T = 4, G = 4: 16 rows, the NR = 2 kernel)
    for T, S in ((2, 288), (4, 576)):
        check_attn(results, "server step", T, S, prompt=SERVER_PROMPT_TOKENS)
    check_attn(results, "server step", 4, 576, q8=True, prompt=SERVER_PROMPT_TOKENS)
    # head dims below 128 (Llama-3.2-1B's 64; 80; 96) and G = 3
    # (Llama-3.2-3B's 24 query heads over 8) at the same T and S
    for D in (64, 80, 96):
        check_attn(results, "decode half-masked", 1, 4096, D=D)
        check_attn(results, "decode T=8", 8, 4096, D=D)
        check_attn(results, "prefill", 512, 4096, D=D)
    check_attn(results, "decode half-masked", 1, 4096, D=80, q8=True)
    check_attn(results, "decode T=8", 8, 4096, D=80, q8=True)
    check_attn(results, "prefill", 512, 4096, D=80, q8=True)
    check_attn(results, "decode T=8 G=3", 8, 4096, H=24)
    check_attn(results, "prefill G=3", 512, 4096, H=24)
    # the wide kernels: gemma's 256 (Gemma-2-2B's 8 heads over 4), MLA's
    # Dk 192 / Dv 128 (DeepSeek-V2-Lite's 16 heads, G = 1), Dk 128 / Dv 64,
    # and the int8 cache at 256 and at 72, 136 (rows of 8 mod 16 bytes)
    for T, name in ((1, "decode half-masked"), (8, "decode T=8"), (512, "prefill")):
        check_attn(results, name, T, 4096, H=8, Hkv=4, D=256)
        check_attn(results, name, T, 4096, H=16, Hkv=16, D=192, Dv=128)
        check_attn(results, name, T, 4096, H=8, Hkv=4, D=256, q8=True)
        if T != 8:
            check_attn(results, name, T, 4096, D=128, Dv=64)
            check_attn(results, name, T, 4096, D=72, q8=True)
            check_attn(results, name, T, 4096, H=16, Hkv=8, D=136, q8=True)
    check_attn(results, "prefill G=3", 512, 4096, H=24, q8=True)
    # Gemma-2-9B's matmuls (phase 11's Q4_K_M-style planes) at decode (B = 1,
    # 8) and a 512-token prefill step: K = 3584 and N = 3584 are new to
    # decode_plan and gemm_split; the use_more_bits layers run attn_q,
    # attn_k and attn_v unfused (attn_v and ffn_down in Q6_K); the tied
    # Q6_K lm_head (256000 rows) sees the output rows only
    for B in (1, 8, 512):
        for name, K, N in GEMMA2_MATMULS_Q4K:
            check_qmm(results, name, Q4K, K, N, B)
        for name, K, N in GEMMA2_MATMULS_Q6K:
            check_qmm(results, name, Q6K, K, N, B)
    for B in (1, 8):
        check_qmm(results, "gemma2 lm_head", Q6K, 3584, 256000, B)
    # the capped kernels at cap 50: Gemma-2-9B's heads (16 over 8 of 256)
    # at decode (T = 1, 8; K3qw_cap at T = 1) and at a 512-token prefill
    # step over 4096 cells (the wide K4w_cap, K4qw_cap), and Gemma-2-27B's
    # (32 over 16 of 128; K3w_cap at decode, the narrow K4_cap and K4q_cap
    # at the prefill step, phase 19's)
    for T, name in ((1, "decode half-masked"), (8, "decode T=8"), (512, "prefill")):
        check_attn(results, name, T, 4096, H=16, Hkv=8, D=256, softcap=GEMMA2_CAP)
        check_attn(results, name, T, 4096, H=32, Hkv=16, D=128, softcap=GEMMA2_CAP)
        if T != 8:
            check_attn(results, name, T, 4096, H=16, Hkv=8, D=256, q8=True,
                       softcap=GEMMA2_CAP)
    check_attn(results, "prefill", 512, 4096, H=32, Hkv=16, D=128, q8=True, softcap=GEMMA2_CAP)
    # the ALiBi kernels: Baichuan-13B's heads (40 over 40 of 128) and
    # refact's (32 over 1 of 64: the run-time D kernels), at decode (T = 1,
    # 8) and a 512-token prefill step over 4096 cells, both caches (refact's
    # q8_0 cache keeps group scales at 64: the unfused attention)
    for T, name in ((1, "decode half-masked"), (8, "decode T=8"), (512, "prefill")):
        for q8 in (False, True):
            check_attn(results, name, T, 4096, H=40, Hkv=40, D=128, q8=q8, alibi=True)
        check_attn(results, name, T, 4096, H=32, Hkv=1, D=64, alibi=True)
    # Baichuan-13B's matmuls (phase 12's Q4_K_M-style planes) at decode (B =
    # 1, 8) and a 512-token prefill step: K = 5120 and N = 15360, 27392 and
    # 5120 are new to decode_plan and gemm_split, and ffn_down is Q8_0 at K
    # = 13696 (no multiple of 256: 107 stages of 128 k) in every layer; the
    # use_more_bits layers run attn_q and attn_k unfused (the o_proj shape)
    # and attn_v in Q6_K; the Q6_K lm_head (64000 rows) sees the output rows
    for B in (1, 8, 512):
        for name, K, N in BAICHUAN_MATMULS_Q4K:
            check_qmm(results, name, Q4K, K, N, B)
        check_qmm(results, "baichuan attn_v", Q6K, 5120, 5120, B)
        check_qmm(results, "baichuan down", Q80, 13696, 5120, B)
    for B in (1, 8):
        check_qmm(results, "baichuan lm_head", Q6K, 5120, 64000, B)
    # K5 at the TPU package's gdot probe shapes (scripts/kbench6.py SHAPES;
    # "head" is a probe shape only: the main path's lm_head is Q6_K); every
    # shape the main path gives K5 is checked once its planes exist
    # (check_gdot_path)
    for B in (1, 8):
        for name, K, N in (("qkv", 4096, 6144), ("out", 4096, 4096), ("gu", 4096, 28672),
                           ("down", 14336, 4096), ("head", 4096, 128256)):
            check_gdot(results, name, K, N, B)
    for B in (1, 8):
        for name, dims, pres in CHAINS + GEMMA7B_CHAINS:
            check_chain(results, name, dims, pres, B)
    # Qwen3-30B-A3B's and Gemma-7B's attention matmuls and lm_heads (phases
    # 13 and 14): N = 5120, 512 (attn_k / attn_v of the use_more_bits
    # layers), 2048 (o_proj) and 151936 (lm_head) are new to decode_plan
    # and gemm_split, and so are Gemma-7B's K = 3072 and 24576 and N =
    # 12288, 49152 and 256000; the experts run plain PyTorch
    for B in (1, 8, 512):
        for name, K, N in QWEN3_MATMULS_Q4K + GEMMA7B_MATMULS_Q4K:
            check_qmm(results, name, Q4K, K, N, B)
        for name, K, N in QWEN3_MATMULS_Q6K + GEMMA7B_MATMULS_Q6K:
            check_qmm(results, name, Q6K, K, N, B)
    for B in (1, 8):
        check_qmm(results, "qwen3 lm_head", Q6K, 2048, 151936, B)
        check_qmm(results, "gemma-7b lm_head", Q6K, 3072, 256000, B)
    # K7 at every layer matmul of phase 8's uniform planes: K1 (Q4_K) and K2
    # (Q8_0) at decode and at a 512-token prefill step, K5 at decode and at
    # the gdot probes' B = 8
    for B in (1, 512):
        for qtype in ("Q4_K", "Q8_0"):
            for name, K, N in STACKED_SHAPES:
                check_stacked(results, name, qtype, K, N, B)
    for B in (1, 8):
        for name, K, N in STACKED_SHAPES:
            check_stacked(results, name, "Q4_K", K, N, B, gdot=True)
    # LLAMA3_8B at Q3_K_M and Q2_K (phase 15's planes): K1 and K7 on nibble
    # planes at group size 16 (Q3_K with zero point 4, Q2_K with mins) at
    # decode and a 512-token prefill step, K5 at decode, K6 on the Q3_K
    # tail; then K2 on the int8 planes of the other types the port loads
    for qtype in ("Q3_K", "Q2_K"):
        for B in (1, 8, 512):
            for name, K, N in LOWBIT_SHAPES:
                check_qmm(results, name, GGMLType[qtype], K, N, B)
                check_stacked(results, name, qtype, K, N, B)
        for B in (1, 8):
            for name, K, N in LOWBIT_SHAPES:
                check_gdot(results, name, K, N, B, qtype)
    for B in (1, 8):
        for name, dims, pres in LOWBIT_CHAINS:
            check_chain(results, name, dims, pres, B)
    for qtype in ("Q5_0", "Q5_1", "Q5_K", "IQ4_NL", "IQ4_XS"):
        check_qmm(results, "4096x4096", GGMLType[qtype], 4096, 4096, 1)
    # the IQ and ternary types (phase 16's planes): K1 and K5 on TQ2_0's
    # nibble planes at group size 256 at BitNet b1.58 2B4T's matmuls, K2 on
    # IQ1_M's int8 planes at group size 8 at LLAMA3_8B's, at decode (B = 1
    # and 8) and at a 512-token prefill step (the GEMM); K7 on both, K6 on
    # LLAMA3_8B's TQ2_0 head and tail and IQ1_M's tail; then K2 on the int8
    # planes of the other IQ types
    f32 = torch.float32  # the scales as loading a GGUF makes them, and as phase 16 runs
    for B in (1, 8, 512):
        tol = NEW_FORM_REL_TOL if B <= 16 else 1e-3
        for name, K, N in BITNET_SHAPES:
            check_qmm(results, name, GGMLType.TQ2_0, K, N, B, f32, rel_tol=tol)
        for name, K, N in IQ1M_SHAPES:
            check_qmm(results, name, GGMLType.IQ1_M, K, N, B, f32, rel_tol=tol)
    for B in (1, 8):
        for name, K, N in BITNET_SHAPES:
            check_gdot(results, name, K, N, B, "TQ2_0", NEW_FORM_REL_TOL, f32)
    for B in (1, 512):
        tol = NEW_FORM_REL_TOL if B <= 16 else 1e-3
        check_stacked(results, "gate_up", "TQ2_0", 2560, 13824, B, rel_tol=tol, scales_dtype=f32)
        check_stacked(results, "gate_up", "IQ1_M", 4096, 28672, B, rel_tol=tol, scales_dtype=f32)
    check_stacked(results, "gate_up", "TQ2_0", 2560, 13824, 1, gdot=True,
                  rel_tol=NEW_FORM_REL_TOL, scales_dtype=f32)
    for B in (1, 8):
        for name, dims, pres in IQ_CHAINS:
            check_chain(results, name, dims, pres, B, scales_dtype=f32, one_step=True)
    for qtype in ("IQ1_S", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S"):
        check_qmm(results, "4096x4096", GGMLType[qtype], 4096, 4096, 1, f32)
    # GLM-4-9B (phase 17's planes) at decode (B = 1) and a 512-token prefill
    # step: N = 4608, 256 (two column tiles) and 27392 and K = 13696 (Q8_0
    # down) on the decode GEMV and the GEMM, the Q6_K lm_head (151552
    # rows); K3 / K3q at T = 1 and 8 and K4 / K4q at T = 512 over 4096
    # cells at its heads (32 over 2 of 128, G = 16: 16 and 128 query rows
    # a KV head) with rope on the first 64 of the 128 dims
    for B in (1, 512):
        for name, K, N in GLM4_MATMULS_Q4K:
            check_qmm(results, name, Q4K, K, N, B)
        for name, K, N in GLM4_MATMULS_Q6K:
            check_qmm(results, name, Q6K, K, N, B)
        check_qmm(results, "glm4 down", Q80, 13696, 4096, B)
    for T, name in ((1, "decode half-masked"), (8, "decode T=8"), (512, "prefill")):
        for q8 in (False, True):
            check_attn(results, name, T, 4096, H=32, Hkv=2, D=128, q8=q8, n_rot=64)
    t0 = time.perf_counter()
    command_r_rows(results)
    log(f"Command-R rows passed in {time.perf_counter() - t0:.1f} s")
    return results


# GLM-4-9B's matmuls (name, K, N; phase 17's Q4_K_M-style planes): the
# fused QKV (N = 4608), attn_q and o_proj (4096), attn_k (N = 256; the
# use_more_bits layers run q, k and v unfused, attn_v in Q6_K), gate+up
# packed in ffn_up (N = 27392); attn_v and the lm_head (151552 rows) Q6_K
GLM4_MATMULS_Q4K = (("glm4 qkv", 4096, 4608), ("glm4 attn_q/o_proj", 4096, 4096),
                    ("glm4 attn_k", 4096, 256), ("glm4 gate_up", 4096, 27392))
GLM4_MATMULS_Q6K = (("glm4 attn_v", 4096, 256), ("glm4 lm_head", 4096, 151552))
# Command-R v01's matmuls (name, K, N; phase 18's Q4_K_M-style planes):
# the fused QKV (N = 24576), o_proj and the unfused attn_q / attn_k of the
# use_more_bits layers (8192), gate+up (45056) and down (K = 22528); attn_v
# and down of those layers and the tied lm_head (256000 rows) Q6_K
COMMAND_R_MATMULS_Q4K = (("command-r qkv", 8192, 24576), ("command-r o_proj", 8192, 8192),
                         ("command-r gate_up", 8192, 45056), ("command-r down", 22528, 8192))
COMMAND_R_MATMULS_Q6K = (("command-r attn_v", 8192, 8192), ("command-r down", 22528, 8192),
                         ("command-r lm_head", 8192, 256000))


def command_r_rows(results) -> None:
    """Phase 2's Command-R rows: K1/K2 at its matmuls at decode (B = 1) and
    a 512-token prefill step (K = 8192 and 22528, N = 24576, 45056 and the
    tied table's 256000 rows are new to decode_plan and gemm_split), and
    K3/K3q at T = 1 and 8 and K4/K4q at T = 512 over 4096 cells at its
    heads (64 over 64 of 128, G = 1: 64 CTAs a wave of K4, one KV head
    each)."""
    from llm_tpu_torch.gguf.constants import GGMLType

    for B in (1, 512):
        for name, K, N in COMMAND_R_MATMULS_Q4K:
            check_qmm(results, name, GGMLType.Q4_K, K, N, B)
        for name, K, N in COMMAND_R_MATMULS_Q6K:
            check_qmm(results, name, GGMLType.Q6_K, K, N, B)
    for T, name in ((1, "decode half-masked"), (8, "decode T=8"), (512, "prefill")):
        for q8 in (False, True):
            check_attn(results, name, T, 4096, H=64, Hkv=64, D=128, q8=q8)


# BitNet b1.58 2B4T's matmuls (name, K, N) on TQ2_0: fused QKV, o_proj,
# gate+up, down
BITNET_SHAPES = (("qkv", 2560, 3840), ("o_proj", 2560, 2560), ("gate_up", 2560, 13824),
                 ("down", 6912, 2560))
# LLAMA3_8B's IQ1_M matmuls: gate+up, attn_q (and o_proj), down (QKV stays
# unfused: attn_v is Q4_K)
IQ1M_SHAPES = (("gate_up", 4096, 28672), ("attn_q", 4096, 4096), ("down", 14336, 4096))
# the chains phase 16 runs on K6_gs256, LLAMA3_8B's on TQ2_0-recipe planes
# (the norm -> QKV head and the layer tail; BitNet's squared relu keeps it
# unchained), and on K6_gs8, LLAMA3_8B's IQ1_M tail
IQ_CHAINS = (
    ("llama head qkv TQ2_0", ((4096, 6144, "TQ2_0"),), ("norm",)),
    ("llama tail TQ2_0", ((4096, 4096, "TQ2_0"), (4096, 28672, "TQ2_0"),
                          (14336, 4096, "TQ2_0")), ("cast", "res_norm", "swiglu")),
    ("tail IQ1_M", ((4096, 4096, "IQ1_M"), (4096, 28672, "IQ1_M"), (14336, 4096, "IQ1_M")),
     ("cast", "res_norm", "swiglu")),
)


# LLAMA3_8B's matmuls (name, K, N) at Q3_K_M and Q2_K: gate+up, attn_q (and
# o_proj), attn_k (QKV stays unfused: attn_v's type differs), down
LOWBIT_SHAPES = (("gate_up", 4096, 28672), ("attn_q", 4096, 4096), ("attn_k", 4096, 1024),
                 ("down", 14336, 4096))


# Qwen3-30B-A3B's attention matmuls (name, K, N): Q4_K fused QKV, attn_q
# and attn_k (unfused in the use_more_bits layers), o_proj; Q6_K attn_v of
# the use_more_bits layers
QWEN3_MATMULS_Q4K = (("qwen3 qkv", 2048, 5120), ("qwen3 attn_q", 2048, 4096),
                     ("qwen3 attn_k", 2048, 512), ("qwen3 o_proj", 4096, 2048))
QWEN3_MATMULS_Q6K = (("qwen3 attn_v", 2048, 512),)
# Gemma-7B's matmuls (name, K, N): Q4_K fused QKV, attn_q/k/v (unfused in the
# use_more_bits layers), o_proj, fused gate+up and down; Q6_K attn_v and
# down of the use_more_bits layers
GEMMA7B_MATMULS_Q4K = (("gemma-7b qkv", 3072, 12288), ("gemma-7b attn_q", 3072, 4096),
                       ("gemma-7b o_proj", 4096, 3072), ("gemma-7b gate_up", 3072, 49152),
                       ("gemma-7b down", 24576, 3072))
GEMMA7B_MATMULS_Q6K = (("gemma-7b attn_v", 3072, 4096), ("gemma-7b down", 24576, 3072))
# Gemma-2-9B's matmuls (name, K, N): Q4_K fused QKV, attn_q and attn_k
# (unfused in the use_more_bits layers), o_proj, fused gate+up and down;
# Q6_K attn_v and down of the use_more_bits layers; its attention softcap
GEMMA2_MATMULS_Q4K = (("gemma2 qkv", 3584, 8192), ("gemma2 attn_q", 3584, 4096),
                      ("gemma2 attn_k", 3584, 2048), ("gemma2 o_proj", 4096, 3584),
                      ("gemma2 gate_up", 3584, 28672), ("gemma2 down", 14336, 3584))
GEMMA2_MATMULS_Q6K = (("gemma2 attn_v", 3584, 2048), ("gemma2 down", 14336, 3584))
GEMMA2_CAP = 50.0
# Baichuan-13B's Q4_K matmuls (name, K, N): fused QKV, o_proj (and the
# unfused attn_q / attn_k of the use_more_bits layers), fused gate+up; its
# Q6_K attn_v and Q8_0 down are checked beside them; ALiBi's max_bias
BAICHUAN_MATMULS_Q4K = (("baichuan qkv", 5120, 15360), ("baichuan o_proj", 5120, 5120),
                        ("baichuan gate_up", 5120, 27392))
ALIBI_MAX_BIAS = 8.0
# the capped rows' score scale, in units of D^-0.5: attn_inputs' N(0, 1) q
# and k give scores of about this standard deviation, whose largest
# (~3.5 of it over 4096 cells) cap 50 moves by tens. At D^-0.5 alone the
# cap would move them by ~1e-3 and a kernel without it would pass
CAP_SCORE_SCALE = 16.0

# the layer matmuls of a uniform LLAMA3_8B (name, K, N)
STACKED_SHAPES = (("qkv", 4096, 6144), ("o_proj", 4096, 4096), ("gate_up", 4096, 28672),
                  ("down", 14336, 4096))


def decode_rows() -> list:
    """Phase 2's rows of the decode GEMV and K6 at LLAMA3_8B's shapes, B = 1:
    K1 and K2 (Q4_K, Q6_K and the Q6_K lm_head), K5, K7 and K6 (the Q4_K_M
    tails), the group-size-16 forms on Q3_K (K1_gs16, K7_gs16, K5_gs16,
    K6_gs16) and K6_gs256 / K6_gs8 (IQ_CHAINS), each checked and
    graph-timed as phase 2 does. `chip_smoke.py --decode-rows` runs only
    these: run it from two trees in turns in one call to time a change of
    those kernels' code against its parent's on one card."""
    from llm_tpu_torch.gguf.constants import GGMLType

    Q4K, Q6K, Q3K = GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q3_K
    results = []
    for name, K, N in (("qkv", 4096, 6144), ("attn_q/o_proj", 4096, 4096),
                       ("attn_k", 4096, 1024), ("gate_up", 4096, 28672), ("down", 14336, 4096)):
        check_qmm(results, name, Q4K, K, N, 1)
    for name, K, N in (("attn_v", 4096, 1024), ("down", 14336, 4096), ("lm_head", 4096, 128256)):
        check_qmm(results, name, Q6K, K, N, 1)
    for name, K, N in (("qkv", 4096, 6144), ("out", 4096, 4096), ("gu", 4096, 28672),
                       ("down", 14336, 4096)):
        check_gdot(results, name, K, N, 1)
    for name, K, N in STACKED_SHAPES:
        check_stacked(results, name, "Q4_K", K, N, 1)
    for name, K, N in LOWBIT_SHAPES:
        check_qmm(results, name, Q3K, K, N, 1)
        check_stacked(results, name, "Q3_K", K, N, 1)
        check_gdot(results, name, K, N, 1, "Q3_K")
    for name, dims, pres in CHAINS + LOWBIT_CHAINS:
        check_chain(results, name, dims, pres, 1)
    for name, dims, pres in IQ_CHAINS:
        check_chain(results, name, dims, pres, 1, scales_dtype=torch.float32, one_step=True)
    return results


def attn_gemm_rows(flex: bool = True) -> list:
    """Phase 2's rows of K3/K3q, K4/K4q and the prefill GEMM: K3/K3q and
    K4/K4q at LLAMA3_8B's heads (T = 1 over 4096 and 4001 cells, T = 8,
    T = 512), the ALiBi K4 / K4q at 40 over 40 of 128, every wide and
    capped prefill row of phase 2 (K4w / K4qw at 8 over 4 heads of 256,
    MLA's 192 / 128, Dk 128 / Dv 64, int8 at 72 and 136; K4w_cap /
    K4qw_cap at Gemma-2-9B's heads, K4_cap / K4q_cap at Gemma-2-27B's, and
    K4 / K4q uncapped at Gemma-2-27B's heads, the capped 128-dim rows'
    yardstick), and the GEMM at B = 512 at LLAMA3_8B's Q4_K and Q6_K
    shapes and on the group-size-16, 256 and 8 forms, each checked and
    graph-timed as phase 2 does; flex: the capped rows' library column
    (flex_attention, compiled: not in phase 2, whose time it would grow).
    `chip_smoke.py --attn-gemm-rows [--root DIR]` runs only these (--root:
    DIR's llm_tpu_torch, an older checkout, which takes no flex column):
    run it on two trees in turns in one call to time a change of those
    kernels against its parent on one card."""
    from llm_tpu_torch.gguf.constants import GGMLType

    results = []
    for q8 in (False, True):
        check_attn(results, "decode half-masked", 1, 4096, q8=q8)
        check_attn(results, "decode ragged-S", 1, 4001, q8=q8)
        check_attn(results, "decode T=8", 8, 4096, q8=q8)
        check_attn(results, "prefill", 512, 4096, q8=q8)
        check_attn(results, "prefill", 512, 4096, H=8, Hkv=4, D=256, q8=q8)
        check_attn(results, "prefill", 512, 4096, H=40, Hkv=40, D=128, q8=q8, alibi=True)
        check_attn(results, "prefill", 512, 4096, H=32, Hkv=16, D=128, q8=q8)
        check_attn(results, "prefill", 512, 4096, H=32, Hkv=16, D=128, q8=q8,
                   softcap=GEMMA2_CAP, flex=flex)
        check_attn(results, "prefill", 512, 4096, H=16, Hkv=8, D=256, q8=q8,
                   softcap=GEMMA2_CAP, flex=flex)
    check_attn(results, "prefill", 512, 4096, H=16, Hkv=16, D=192, Dv=128)
    check_attn(results, "prefill", 512, 4096, D=128, Dv=64)
    check_attn(results, "prefill", 512, 4096, D=72, q8=True)
    check_attn(results, "prefill", 512, 4096, H=16, Hkv=8, D=136, q8=True)
    for name, K, N in (("qkv", 4096, 6144), ("attn_q/o_proj", 4096, 4096),
                       ("attn_k", 4096, 1024), ("gate_up", 4096, 28672), ("down", 14336, 4096)):
        check_qmm(results, name, GGMLType.Q4_K, K, N, 512)
    for name, K, N in (("attn_v", 4096, 1024), ("down", 14336, 4096)):
        check_qmm(results, name, GGMLType.Q6_K, K, N, 512)
    f32 = torch.float32
    check_qmm(results, "gate_up", GGMLType.Q3_K, 4096, 28672, 512)
    check_qmm(results, "gate_up", GGMLType.TQ2_0, 2560, 13824, 512, f32)
    check_qmm(results, "gate_up", GGMLType.IQ1_M, 4096, 28672, 512, f32)
    return results


def phase_probes():
    """S1 through its entry point's loop (tools/kbench.py): the probes at
    the kbench shapes at B = 8 (the TPU probes' rows) and 1, each against
    its plain version, timed beside K1. Returns the records and the S1
    launches of that run (the checks and the captured launches; graph
    replays are not counted)."""
    from llm_tpu_torch.ops import cuda_probe
    from llm_tpu_torch.tools import kbench

    cuda_probe.reset_launches()
    recs = kbench.run(list(kbench.SHAPES), (8, 1), plain=True, log=log)
    return recs, cuda_probe.LAUNCHES["S1"]


def phase_attn_probes():
    """S3 through its entry point's loop (tools/kbench_attn.py): every
    variant at its TPU probe's shape, v1 and v0 at every split, each against
    its plain version (timed once a variant), beside its bound and SDPA.
    Returns the records and the S3 launches of that run (the checks and the
    captured launches; graph replays are not counted)."""
    from llm_tpu_torch.ops import cuda_attn_probe
    from llm_tpu_torch.tools import kbench_attn

    cuda_attn_probe.reset_launches()
    recs = kbench_attn.run(plain=True, log=log)
    return recs, cuda_attn_probe.LAUNCHES["S3"]


# The split-S decode kernel's times that K3/K3q's rows of PERF.md's kernel
# table had before the cluster kernel replaced it (µs; chip run 7, PR 1 and
# chip run 1, PR 2, read within 2.8% by every later PR until then): phase 2
# logs the new times beside these.
K3_WAS_US = {("K3", "decode half-masked"): 47.9, ("K3", "decode ragged-S"): 47.2,
             ("K3", "decode T=8"): 215.5, ("K3q", "decode half-masked"): 63.4,
             ("K3q", "decode ragged-S"): 61.3, ("K3q", "decode T=8"): 265.2}
# S3's rows of the kernel table (µs, at the split body's own split; chip run
# 2, PR 5): the probes run that body still, alone, so they keep these times.
# A run reads them within 2% on a card at 700 W; past S3_MAX_RATIO of them
# the body (flash_decode.cuh, no longer K3's) lost its time.
S3_TABLE_US = {"v1": 25.4, "v0": 25.9, "noscale": 61.5, "full": 61.9, "bf16": 63.1}
S3_MAX_RATIO = 1.25


def log_k3_against_was(results) -> None:
    ratios = {}
    for r in results:
        for (kern, name), was in K3_WAS_US.items():
            if r["kernel"] == kern and r["shape"].startswith(name + " "):
                ratios[f"{kern} {r['shape']}"] = {"us": 1e3 * r["ms"], "was_us": was,
                                                  "ratio": 1e3 * r["ms"] / was}
    log(json.dumps(dict(k3_against_was=ratios)))


def check_s3_against_table(attn_probes) -> None:
    ratios = {}
    for r in attn_probes:
        if r["split"] == 0:
            us = S3_TABLE_US[r["variant"]]
            ratios[r["variant"]] = {"us": r["us"], "table_us": us, "ratio": r["us"] / us}
    log(json.dumps(dict(s3_against_table=ratios)))
    slow = {v: x["ratio"] for v, x in ratios.items() if x["ratio"] > S3_MAX_RATIO}
    if slow or set(ratios) != set(S3_TABLE_US):
        raise AssertionError(f"S3 against its table times: {ratios} (slower than "
                             f"{S3_MAX_RATIO}x: {slow})")


def gdot_path_shapes(params) -> dict:
    """{(type, K, N): names} of every matmul of the params that qmm's gdot
    gate sends to K5 at one row: what the decode steps of phases 6 and 7
    give K5 (phase 7 runs a subset, the unfused QKV)."""
    from llm_tpu_torch.ops.cuda_qmm import gdot_eligible
    from llm_tpu_torch.quant.qtensor import QTensor

    shapes = {}
    named = [kw for layer in params["layers"] for kw in layer.items()]
    for name, w in named + [("output", params["output"])]:
        if isinstance(w, QTensor) and gdot_eligible(w, 1):
            names = shapes.setdefault((w.ggml_type.name, w.in_features, w.out_features), [])
            if name not in names:
                names.append(name)
    return shapes


def check_gdot_path(results, params):
    """K5 against its plain version at every shape the main path gives it
    (gdot_path_shapes) that phase 2's probe shapes did not check."""
    done = {r["shape"].split(" ", 1)[1] for r in results if r["kernel"] == "K5"}
    shapes = gdot_path_shapes(params)
    log(json.dumps(dict(k5_path_shapes={f"{t} K={k} N={n}": v
                                        for (t, k, n), v in shapes.items()})))
    for (qtype, K, N), names in shapes.items():
        if f"{qtype} K={K} N={N} B=1" not in done:
            check_gdot(results, "/".join(names), K, N, 1, qtype)


# card-vs-CPU logits tolerance, relative to max|logit|: about 3x the largest
# error measured over seeds 1-6 (4.5e-3, PERF.md). Both sides round the
# activations to bf16, so a last-bit difference of an f32 sum can move a
# value by one bf16 step (2^-8), and such steps carry through the layers.
TWO_LAYER_REL_TOL = 1.5e-2
# the same with a q8_0 KV cache: a last-bit difference in K or V can also
# move a value across a rounding boundary of the quantizer, one int8 step
# (1/127 of the row's amax). About 3x the largest error measured over
# seeds 1-6 (5.6e-3, PERF.md).
TWO_LAYER_Q8_REL_TOL = 1.7e-2
# the weights' seed: greedy equality holds across devices only where no
# step's top two logits lie within the error. At seed 5 the smallest top-2
# gap of the 9 steps is 0.163, over 4x the error (seed 6 parts at step 0
# on a gap of 0.018; PERF.md)
TWO_LAYER_SEED = 5
# the greedy tokens the two-layer checks generate on the card (every one
# replayed on the CPU, whose plain versions dequantize each step's
# weights, the lm_head's among them: most of phase 3's time); cut from 8
# to 4, then to 2 beside the IQ1_M and TQ2_0 GGUF twins, for
# chip_smoke.py's time limit: the script took 1029 s with 4 and 908 s
# with 2, and cutting the depth of the other phases saves ~25 s (PERF.md).
# The seeds above were chosen on the 9 steps of 8 tokens, whose first 3
# these are
TWO_LAYER_DECODE = 2


# a router near tie, in router probabilities: where a follower's experts
# (RouteTwin) differ from the recorded run's, each expert swapped in lies
# within ROUTE_GAP_TOL of each expert swapped out on the follower's own
# probabilities; and on every token the two runs' probabilities differ by
# at most ROUTE_DIFF_TOL (the same inputs). About 3x the largest readings
# at Qwen3-30B-A3B's widths over 48 layers (a swap's gap 7.3e-4, a swapped
# token's difference 3.3e-3, PERF.md), where the largest probability of a
# token is 0.026 or more (a softmax over 128 router logits of std 0.9)
ROUTE_GAP_TOL = 2.5e-3
ROUTE_DIFF_TOL = 1e-2


def route_swaps(sel, idx, rsel, ridx) -> tuple[float, list[float]]:
    """A follower's router probabilities sel [T, E] and experts idx [T, k]
    against a recorded run's (rsel, ridx): (the largest difference of the
    probabilities, the gap of each token whose experts differ). Raises
    unless the shapes match, every difference is within ROUTE_DIFF_TOL and
    every gap within ROUTE_GAP_TOL (a near tie)."""
    if sel.shape != rsel.shape or idx.shape != ridx.shape:
        raise AssertionError(f"router calls of shapes {tuple(sel.shape)} and "
                             f"{tuple(rsel.shape)}: not the recorded step")
    diff = float((sel - rsel).abs().max())
    if not diff <= ROUTE_DIFF_TOL:
        raise AssertionError(f"the router probabilities differ by {diff} > {ROUTE_DIFF_TOL}"
                             f" from the recorded run's: not its inputs")
    gaps = []
    for t in range(idx.shape[0]):
        mine, ref = set(idx[t].tolist()), set(ridx[t].tolist())
        if mine == ref:
            continue
        gap = max(abs(float(sel[t, a] - sel[t, b])) for a in mine - ref for b in ref - mine)
        if not gap <= ROUTE_GAP_TOL:
            raise AssertionError(f"token {t}: the routers part on experts "
                                 f"{sorted(mine ^ ref)} {gap} apart > {ROUTE_GAP_TOL}")
        gaps.append(gap)
    return diff, gaps


class RouteTwin:
    """The experts a mixture-of-experts run picks (models/transformer.py's
    top_k), recorded on a reference run and followed on a second run over
    the same inputs. The router is discontinuous: where two experts'
    probabilities nearly tie, the last-bit differences between two devices
    (or the chained and the unchained path) pick either, and the layer's
    output moves by a whole expert. So the second run takes the reference's
    experts after route_swaps has held each of its calls to the recorded
    one: the same probabilities within ROUTE_DIFF_TOL, and experts that
    differ only at a near tie (ROUTE_GAP_TOL). Then the runs' logits are
    compared as any twins'. mode: "record", "follow" or None (neither:
    steps of the reference that the second run does not repeat, and timed
    windows, which take no host sync of it)."""

    def __init__(self):
        self.mode, self.calls, self.seen, self.i = None, [], [], 0
        self.flips, self.worst_gap, self.worst_diff = 0, 0.0, 0.0

    def follow(self):
        self.mode, self.i = "follow", 0

    def __enter__(self):
        from llm_tpu_torch.models import transformer

        self._real = real = transformer.top_k

        def top_k(sel, k):
            idx = real(sel, k)
            if self.mode == "record":
                self.calls.append((sel.float().cpu(), idx.cpu()))
            elif self.mode == "follow":
                if self.i >= len(self.calls):
                    raise AssertionError(f"router call {self.i} past the "
                                         f"{len(self.calls)} recorded")
                rsel, ridx = self.calls[self.i]
                self.i += 1
                mine = (sel.float().cpu(), idx.cpu())
                self.seen.append(mine)
                diff, gaps = route_swaps(*mine, rsel, ridx)
                self.flips += len(gaps)
                self.worst_gap = max([self.worst_gap] + gaps)
                self.worst_diff = max(self.worst_diff, diff)
                idx = ridx.to(sel.device)
            return idx

        transformer.top_k = top_k
        return self

    def __exit__(self, *exc):
        from llm_tpu_torch.models import transformer

        transformer.top_k = self._real

    def followed_all(self, name: str) -> None:
        """Raise unless the follower repeated every recorded call."""
        if self.i != len(self.calls):
            raise AssertionError(f"{name}: the follower made {self.i} of the "
                                 f"{len(self.calls)} recorded router calls")

    def planted_fault(self) -> None:
        """route_swaps must refuse two faults planted in the first followed
        call's recorded token 0: a router row whose weights moved (the
        follower's least likely expert raised 0.05 past the row's largest
        probability, so that the recorded run picks it), and a pick that is
        no near tie (the recorded last expert swapped for the follower's
        least likely, the probabilities kept)."""
        if not self.seen:
            raise AssertionError("no router call was followed")
        sel, idx = self.seen[0]
        rsel, ridx = self.calls[0]
        low = int(sel[0].argmin())
        moved = rsel.clone()
        moved[0, low] = float(rsel[0].max()) + 0.05
        far = ridx.clone()
        far[0, -1] = low
        for name, fault in (("a moved router row", (moved, self._real(moved, idx.shape[1]))),
                            ("a pick far from a tie", (rsel, far))):
            try:
                route_swaps(sel, idx, *fault)
            except AssertionError:
                continue
            raise AssertionError(f"route_swaps accepted {name}")

    def record(self) -> dict:
        return dict(router_calls=len(self.calls), router_flips=self.flips,
                    flip_max_gap=self.worst_gap, router_max_prob_diff=self.worst_diff)


def two_layer_steps(seed: int, kv_dtype=None, devices=("cuda", "cpu"), chain=False,
                    gdot=False, geo=None, after_card=None, route=None):
    """Full width, 2 layers, one set of weights on each device. Each device
    prefills a 64-token prompt (Context.decode). The card generates 8
    greedy tokens (generate_loop), then its token stream is fed back one
    decode step at a time on every device, so that every device's logits of
    every step come from the same inputs. A device's greedy tokens are
    those of generate_loop on the card and, on the CPU, the argmax of each
    step's logits: the CPU's own greedy stream equals the card's exactly
    when each card token is the CPU's argmax after the same prefix, so the
    CPU runs no generate_loop of its own (8 forward passes of plain
    dequantizing matmuls saved a row). chain/gdot are Context's options; geo the widths
    (LLAMA3_8B's by default); after_card, if given, is called right after
    the card's run (to read counters before the CPU's run); geo's
    alibi_profile, if true, gives the model cfg's ALiBi profile (rope NONE,
    ALiBi of max_bias 8: Baichuan-13B's, whose depth 40 selects it), and
    geo's chain, if given, is the chain option; geo's ftype, if given,
    takes the weights from a 2-layer tools/synth_gguf.py file of that
    type mix, through models/loader.py (gguf_two_layers). route: a RouteTwin (in
    force) that records the card's experts over the steps the CPU repeats
    (the prompt and the replayed steps) and that the CPU follows.
    Returns (cfg, {device: logits [TWO_LAYER_DECODE + 1, vocab]}, {device:
    greedy tokens})."""
    import numpy as np

    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.config import alibi_profile
    from llm_tpu_torch.models.synthetic import LLAMA3_8B, make_synthetic_model
    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context, params_to

    geo = dict(geo or LLAMA3_8B, n_layers=2)  # may carry arch, swa_window and experts
    profile = geo.pop("alibi_profile", False)
    chain = geo.pop("chain", chain)
    ftype = geo.pop("ftype", None)
    if ftype is not None:
        params, cfg = gguf_two_layers(ftype, seed, geo)
    else:
        params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                           seed=seed, recipe="Q4_K_M", **geo)
    if profile:
        cfg = alibi_profile(cfg)
    prompt = [(i * 7919) % cfg.vocab_size for i in range(64)]
    toks, steps = {}, {}
    for dev in devices:
        t0 = time.perf_counter()
        p = params if dev == "cuda" else params_to(params, "cpu")
        ctx = Context(None, n_cells=256, device=dev, params_cfg=(p, cfg), kv_dtype=kv_dtype,
                      chain=chain, gdot=gdot)
        if route is not None:
            if dev == "cuda":
                route.mode = "record"
            else:
                route.follow()
        assert ctx.decode(Batch.text(prompt)) == 0
        lg = [ctx.get_logits().copy()]
        if dev == "cuda":
            first = int(lg[0].argmax())
            if route is not None:  # steps the CPU does not repeat
                route.mode = None
            toks[dev] = [first] + ctx.generate_loop(first, TWO_LAYER_DECODE)
            if route is not None:
                route.mode = "record"
            ctx.seq_rm(0, len(prompt), -1)
        for t in toks["cuda"][:-1]:
            assert ctx.decode(Batch.text([t])) == 0
            lg.append(ctx.get_logits().copy())
        steps[dev] = np.stack(lg)
        if dev != "cuda":
            toks[dev] = [int(x.argmax()) for x in steps[dev]]
        log(f"two-layer {dev} kv {kv_dtype} chain {chain} gdot {gdot}: "
            f"{time.perf_counter() - t0:.1f} s, tokens {toks[dev]}")
        if dev == "cuda" and after_card is not None:
            after_card()
        del ctx, p
    return cfg, steps, toks


# the BPE vocabs of phase 3's GGUF rows, made once a size
_GGUF_VOCAB: dict = {}


def gguf_two_layers(ftype: str, seed: int, geo: dict):
    """Phase 3's GGUF rows: a tools/synth_gguf.py file of geo's widths, 2
    layers and the ftype's type mix (random blocks from seed, a BPE vocab
    of geo's size) and geo's arch written into a temporary directory and loaded
    on the card by models/loader.py, so that the unpackers run on real
    block bytes. Returns (params, cfg)."""
    from llm_tpu_torch.gguf.reader import GGUFReader
    from llm_tpu_torch.models.loader import load_params
    from llm_tpu_torch.tools import synth_gguf

    t0 = time.perf_counter()
    if geo["vocab"] not in _GGUF_VOCAB:
        _GGUF_VOCAB[geo["vocab"]] = synth_gguf.bpe_vocab(geo["vocab"], 0)
    with tempfile.TemporaryDirectory() as d:
        info = synth_gguf.write_llama(
            f"{d}/two_{ftype}.gguf", n_layers=geo["n_layers"], n_embd=geo["n_embd"],
            n_heads=geo["n_heads"], n_kv_heads=geo["n_kv_heads"], n_ff=geo["n_ff"],
            vocab=_GGUF_VOCAB[geo["vocab"]], seed=seed, ftype=ftype,
            arch=geo.get("arch", "llama"))
        t1 = time.perf_counter()
        params, cfg = load_params(GGUFReader(info["path"]), device="cuda")
        torch.cuda.synchronize()
    log(json.dumps(dict(two_layer_gguf=ftype, file_bytes=info["file_bytes"],
                        tensors=info["tensors"], write_s=t1 - t0,
                        load_s=time.perf_counter() - t1)))
    planes_summary(params, cfg, f"two_layer_{ftype}")
    return params, cfg


def phase_two_layers(seed: int = TWO_LAYER_SEED, kv_dtype=None, rel_tol=TWO_LAYER_REL_TOL,
                     chain=False, gdot=False):
    """two_layer_steps on the card and the CPU: every step's logits within
    rel_tol of max|logit|, and the greedy tokens equal. Returns the card's
    logits [TWO_LAYER_DECODE + 1, vocab]."""
    import numpy as np

    cfg, steps, toks = two_layer_steps(seed, kv_dtype, chain=chain, gdot=gdot)
    lg, lc = steps["cuda"], steps["cpu"]
    tg, tc = toks["cuda"], toks["cpu"]
    assert np.isfinite(lg).all() and lg.shape == (TWO_LAYER_DECODE + 1, cfg.vocab_size)
    err = float(np.abs(lg - lc).max())
    tol = rel_tol * float(np.abs(lc).max())
    log(json.dumps(dict(seed=seed, kv_dtype=str(kv_dtype), chain=chain, gdot=gdot,
                        two_layer_logits_max_abs_err=err,
                        tol=tol, rel_err=err / float(np.abs(lc).max()),
                        step_max_abs_err=np.abs(lg - lc).max(axis=1).tolist(),
                        min_top2_gap=min_top2_gap(lc),
                        distinct_tokens=len(set(tg)), tokens_equal=tg == tc)))
    if not err <= tol:
        raise AssertionError(f"two-layer logits over {len(lg)} steps: max|err| {err} > {tol}")
    for i, t in enumerate(tg):  # generate_loop's greedy pick is decode's argmax
        if lg[i, t] < lg[i].max() - tol:
            raise AssertionError(f"step {i}: generate_loop took {t}, decode's argmax is "
                                 f"{int(lg[i].argmax())}")
    if len(set(tg)) < 2:
        raise AssertionError(f"the greedy stream {tg} is one token: the check is empty")
    if tg != tc:
        raise AssertionError(f"two-layer greedy tokens differ: {tg} vs {tc}")
    return lg


# q8_0 cache against the bf16 cache on the card, prefill logits (as
# llm_tpu's test_engine.py::test_quantized_kv_cache_close_to_bf16 holds
# them): top-1 equal, max|diff| within this share of max|logit|, about 3x
# the largest difference measured over seeds 1-6 (1.5e-2, PERF.md)
Q8_VS_BF16_REL_TOL = 4.5e-2
# the q8_0 twin's seed, the one of seeds 1-64 (--screen-seeds) whose card
# logits' smallest top-2 gap over the 9 steps exceeds TWO_LAYER_Q8_REL_TOL
# of max|logit| (1.81e-2) with more than one distinct greedy token; its
# bf16 prefill's top-2 gap (5.2e-2) exceeds Q8_VS_BF16_REL_TOL (PERF.md)
TWO_LAYER_Q8_SEED = 40


def min_top2_gap(logits) -> float:
    """Smallest gap between the top two logits of any row, [steps, vocab]."""
    import numpy as np

    top2 = np.sort(logits, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def phase_two_layers_q8(seed: int = TWO_LAYER_Q8_SEED):
    """Phase 3's q8_0 twin, then the card's q8_0 prefill logits against the
    bf16 cache's on the same weights."""
    import numpy as np

    lq = phase_two_layers(seed, kv_dtype="q8_0", rel_tol=TWO_LAYER_Q8_REL_TOL)
    lb = two_layer_steps(seed, devices=("cuda",))[1]["cuda"][0]
    diff = float(np.abs(lq[0] - lb).max())
    tol = Q8_VS_BF16_REL_TOL * float(np.abs(lb).max())
    log(json.dumps(dict(q8_vs_bf16_prefill_max_abs_diff=diff, tol=tol,
                        top1_equal=int(lq[0].argmax()) == int(lb.argmax()))))
    if int(lq[0].argmax()) != int(lb.argmax()):
        raise AssertionError("q8_0 and bf16 caches pick different top-1 tokens")
    if not diff <= tol:
        raise AssertionError(f"q8_0 vs bf16 prefill logits: max|diff| {diff} > {tol}")


# the chained twin (chain=True, gdot=True): layer 0 is a use_more_bits
# layer, so its QKV stays unfused (K5 on attn_q/attn_k, K2 on attn_v) and
# its tail mixes Q4_K with a Q6_K down; layer 1 runs the fused head and an
# all-Q4_K tail, and the lm_head is a K6 norm_mm. Card vs CPU, relative to
# max|logit|: about 3x the largest error over seeds 1-6 (5.2e-3,
# `--sweep-seeds chain`, PERF.md), for the same reason as the bf16 twin's.
TWO_LAYER_CHAIN_REL_TOL = 1.5e-2
# of seeds 1-6, seed 5 has the widest smallest top-2 gap of the CPU's 9
# steps (0.115, 2.8x its error of 0.041); seed 6 parts on a 0.008 gap
TWO_LAYER_CHAIN_SEED = 5


def phase_two_layers_chain():
    """Phase 3's chained twin; K5 and K6 must both launch on the card."""
    from llm_tpu_torch.ops import cuda_qmm, cuda_qmm_chain

    cuda_qmm.reset_launches()
    cuda_qmm_chain.reset_launches()
    phase_two_layers(TWO_LAYER_CHAIN_SEED, rel_tol=TWO_LAYER_CHAIN_REL_TOL, chain=True,
                     gdot=True)
    launched = {**cuda_qmm.LAUNCHES, **cuda_qmm_chain.LAUNCHES}
    log(json.dumps(dict(two_layer_chain_launches=launched)))
    for k in ("K5", "K6"):
        if launched[k] <= 0:
            raise AssertionError(f"the chained twin launched no {k}")


# two layers at the widths of the llama configs past LLAMA3_8B's head dim
# and group: Llama-3.2-1B (hidden 2048, 32 heads over 8 of 64 dims) and
# Llama-3.2-3B (hidden 3072, 24 heads over 8 of 128: G = 3), ff 8192 and
# the Llama 3 vocab (their published config.json widths; 2 of 16 and 28
# layers)
LLAMA32_1B = dict(n_embd=2048, n_heads=32, n_kv_heads=8, n_ff=8192, vocab=128256, head_dim=64)
LLAMA32_3B = dict(n_embd=3072, n_heads=24, n_kv_heads=8, n_ff=8192, vocab=128256, head_dim=128)
# llama configs at the attention widths of the heads the wide kernels
# take: Gemma-2-2B (hidden 2304, 8 heads over 4 of 256, ff 9216) and
# DeepSeek-V2-Lite's MLA heads as plain ones (hidden 2048, 16 heads of Dk
# 192 = 128 + 64 rope dims and Dv 128, no GQA; ff 8192 in place of its
# 10944, which Q4_K's 256-wide groups do not divide), both with the Llama 3
# vocab; and a head dim that is no multiple of 8 (100: 64 heads over 8, so
# that attn_output's 6400 columns are Q4_K groups)
GEMMA2_2B_ATTN = dict(n_embd=2304, n_heads=8, n_kv_heads=4, n_ff=9216, vocab=128256,
                      head_dim=256)
DSV2_LITE_ATTN = dict(n_embd=2048, n_heads=16, n_kv_heads=16, n_ff=8192, vocab=128256,
                      head_dim=192, head_dim_v=128)
HEAD_DIM_100 = dict(n_embd=2048, n_heads=64, n_kv_heads=8, n_ff=8192, vocab=128256,
                    head_dim=100)
# a head past 256 (264, a multiple of 8 that no kernel of the port holds:
# the unfused attention on either device; 32 heads over 8, so that
# attn_output's 8448 columns are Q4_K groups)
HEAD_DIM_264 = dict(n_embd=2048, n_heads=32, n_kv_heads=8, n_ff=8192, vocab=128256,
                    head_dim=264)
# Gemma-2-9B's geometry (models/synthetic.py GEMMA2_9B; google/gemma-2-9b
# config.json); gemma2_config adds its window, softcaps and scales
GEMMA2_9B = dict(n_embd=3584, n_layers=42, n_heads=16, n_kv_heads=8, n_ff=14336,
                 vocab=256000, head_dim=256)
# two layers of the real Gemma-2-9B config (layer 0 slides, layer 1 is
# global; tied Q6_K lm_head of 256000 rows): with the window cut to 32 so
# that the mask bites inside the 64-token prompt and a bf16 cache (a row at
# its own window of 4096 would check nothing more: the 64 cells lie inside
# it), and with the q8_0 cache at its own window (the mask is the bias,
# whatever the cache). Each row costs ~1 min, most of it the CPU
# dequantizing the lm_head in f32 at every step
GEMMA2_9B_TWO = dict(arch="gemma2")
GEMMA2_9B_W32 = dict(arch="gemma2", swa_window=32)
# phase 11's depth: 12 of Gemma-2-9B's 42 layers (the sliding and global
# layers alternate either way), cut for chip_smoke.py's time limit (to 21,
# then to 12)
GEMMA2_PHASE11_LAYERS = 12
# two layers of Baichuan-13B (models/synthetic.py BAICHUAN_13B) with its
# 13B profile (rope NONE, ALiBi of max_bias 8, which its 40 layers select:
# two_layer_steps applies alibi_profile to the cut model's config), and of
# Refact-1.6B (REFACT_1_6B: ALiBi at G = 32, D = 64, the run-time D
# kernels; its q8_0 cache keeps group scales at 64, so only the bf16 one)
BAICHUAN_13B = dict(n_embd=5120, n_layers=40, n_heads=40, n_kv_heads=40, n_ff=13696,
                    vocab=64000, head_dim=128)
BAICHUAN_13B_TWO = dict(BAICHUAN_13B, arch="baichuan", alibi_profile=True)
# two layers of Qwen3-30B-A3B (models/synthetic.py QWEN3_30B_A3B: qk-norm,
# 128 experts of 768, 8 a token; the 64-token prompt runs the grouped
# dispatch, the 8 decode steps the per-(token, k) gather; K3/K4 at G = 8),
# of Qwen2.5-7B (QWEN2_5_7B: QKV biases, G = 7) and of Gemma-7B with
# chain=True (GEMMA_7B: both layers are use_more_bits ones, so their QKV
# stays unfused and each tail is a GeGLU chain with a Q6_K down, K6_gelu;
# the tied lm_head a K6 norm_mm; D = 256: K3w/K4w)
REFACT_1_6B_TWO = dict(n_embd=2048, n_heads=32, n_kv_heads=1, n_ff=5632, vocab=49216,
                       head_dim=64, arch="refact")
WIDTHS_SEED = 5


# the kernel each GGUF row's base type runs on the card
GGUF_ROW_KERNEL = {"Q3_K_M": "K1_gs16", "Q2_K": "K1_gs16", "IQ1_M": "K2_gs8",
                   "TQ2_0": "K1_gs256", "Q4_K_M": "K1"}


# the vocab of phase 3's Command-R twin: the CPU replays dequantize the
# tied table in f32 every step, and Gemma-2-9B's 256000 x 3584 took ~1 min
# a row so (PERF.md); Command-R's 256000 x 8192 would take more than
# twice that. Phase 2 holds the full lm_head, phase 18 runs it
COMMAND_R_TWIN_VOCAB = 32768


def phase_two_layers_widths(only=None):
    """two_layer_steps at Llama-3.2-1B's widths with a bf16 cache (K3/K4 at
    D = 64) and a q8_0 cache (its 64-dim rows keep 32-dim group scales: the
    unfused attention on both devices, by shape, no K3q/K4q launch), and at
    Llama-3.2-3B's (G = 3; the 64-token prompt is a K4 prefill); then at
    Gemma-2-2B's attention widths with a bf16 and a q8_0 cache (the wide
    K3w/K4w, K3qw/K4qw), DeepSeek-V2-Lite's (K3w/K4w at Dk 192, Dv 128) and
    head_dim 100 (the unfused attention, counted); then the GGUF rows
    (synth_gguf files of two layers loaded by models/loader.py), GLM-4-9B's
    among them (G = 16, rope on 64 of 128 dims, QKV biases, post-norms,
    gate+up packed in ffn_up, a Q8_0 down) and Command-R's (8192 wide, 64
    heads over 64, LayerNorm weights, the parallel block, a tied table of
    COMMAND_R_TWIN_VOCAB rows, the logit scale; only: the rows of these
    names alone, else every row). Every
    step's logits within the two-layer tolerance of max|logit|. At every
    step the card's greedy token is one whose CPU logit lies within that
    tolerance of the CPU's top logit on the same inputs (both devices are
    fed the card's tokens); where the CPU's top two are further apart, that
    is the CPU's own argmax, so the two greedy streams must be equal before
    the first step whose top two CPU logits lie within the tolerance. At
    that near tie either device may take either token and the streams may
    part. Returns each run's record."""
    import numpy as np

    from llm_tpu_torch.models.synthetic import (BITNET_B158_2B, COMMAND_R_35B, GEMMA_7B,
                                                GLM4_9B, LLAMA3_8B, QWEN2_5_7B, QWEN3_30B_A3B)
    from llm_tpu_torch.ops import attention, cuda_attn, cuda_qmm, cuda_qmm_chain

    recs = []
    for name, geo, kv_dtype, rel_tol, want in (
            ("Llama-3.2-1B", LLAMA32_1B, None, TWO_LAYER_REL_TOL, ("K3", "K4")),
            ("Llama-3.2-1B", LLAMA32_1B, "q8_0", TWO_LAYER_Q8_REL_TOL, ()),
            ("Llama-3.2-3B", LLAMA32_3B, None, TWO_LAYER_REL_TOL, ("K3", "K4")),
            ("Gemma-2-2B attention", GEMMA2_2B_ATTN, None, TWO_LAYER_REL_TOL, ("K3w", "K4w")),
            ("Gemma-2-2B attention", GEMMA2_2B_ATTN, "q8_0", TWO_LAYER_Q8_REL_TOL,
             ("K3qw", "K4qw")),
            ("DeepSeek-V2-Lite attention", DSV2_LITE_ATTN, None, TWO_LAYER_REL_TOL,
             ("K3w", "K4w")),
            ("head_dim 100", HEAD_DIM_100, None, TWO_LAYER_REL_TOL, ()),
            ("head_dim 264", HEAD_DIM_264, None, TWO_LAYER_REL_TOL, ()),
            ("Gemma-2-9B window cut to 32", dict(GEMMA2_9B, **GEMMA2_9B_W32), None,
             TWO_LAYER_REL_TOL, ("K3w_cap", "K4w_cap")),
            ("Gemma-2-9B", dict(GEMMA2_9B, **GEMMA2_9B_TWO), "q8_0", TWO_LAYER_Q8_REL_TOL,
             ("K3qw_cap", "K4qw_cap")),
            ("Baichuan-13B", BAICHUAN_13B_TWO, None, TWO_LAYER_REL_TOL,
             ("K3_alibi", "K4_alibi")),
            ("Baichuan-13B", BAICHUAN_13B_TWO, "q8_0", TWO_LAYER_Q8_REL_TOL,
             ("K3q_alibi", "K4q_alibi")),
            ("Refact-1.6B", REFACT_1_6B_TWO, None, TWO_LAYER_REL_TOL,
             ("K3_alibi", "K4_alibi")),
            ("Qwen3-30B-A3B", dict(QWEN3_30B_A3B, arch="qwen3moe"), None, TWO_LAYER_REL_TOL,
             ("K3", "K4")),
            ("Qwen2.5-7B", dict(QWEN2_5_7B, arch="qwen2"), None, TWO_LAYER_REL_TOL,
             ("K3", "K4")),
            ("Gemma-7B chain", dict(GEMMA_7B, arch="gemma", chain=True), None,
             TWO_LAYER_CHAIN_REL_TOL, ("K3w", "K4w")),
            ("Q3_K_M GGUF", dict(LLAMA3_8B, ftype="Q3_K_M"), None, TWO_LAYER_REL_TOL,
             ("K3", "K4")),
            ("Q2_K GGUF", dict(LLAMA3_8B, ftype="Q2_K"), None, TWO_LAYER_REL_TOL,
             ("K3", "K4")),
            ("IQ1_M GGUF", dict(LLAMA3_8B, ftype="IQ1_M"), None, TWO_LAYER_REL_TOL,
             ("K3", "K4")),
            ("TQ2_0 GGUF", dict(BITNET_B158_2B, ftype="TQ2_0", arch="bitnet"), None,
             TWO_LAYER_REL_TOL, ("K3", "K4")),
            ("GLM-4-9B GGUF", dict(GLM4_9B, ftype="Q4_K_M", arch="glm4"), None,
             TWO_LAYER_REL_TOL, ("K3", "K4")),
            ("Command-R GGUF", dict(COMMAND_R_35B, ftype="Q4_K_M", arch="command-r",
                                    vocab=COMMAND_R_TWIN_VOCAB), None, TWO_LAYER_REL_TOL,
             ("K3", "K4"))):
        if only is not None and name not in only:
            continue
        t0 = time.perf_counter()
        cuda_attn.reset_launches()
        cuda_qmm_chain.reset_launches()
        cuda_qmm.reset_launches()
        attention.LAUNCHES["unfused"] = 0
        card = {}
        with RouteTwin() as route:
            cfg, steps, toks = two_layer_steps(
                WIDTHS_SEED, kv_dtype, geo=geo,
                after_card=lambda: card.update(attention.LAUNCHES, **cuda_qmm_chain.LAUNCHES,
                                               qmm=dict(cuda_qmm.LAUNCHES)),
                route=route if geo.get("n_expert") else None)
        route.followed_all(name)
        if geo.get("n_expert"):
            route.planted_fault()
        launched = dict(cuda_attn.LAUNCHES)  # the card's run; the CPU's launches nothing
        unfused = card["unfused"]
        lg, lc = steps["cuda"], steps["cpu"]
        tg, tc = toks["cuda"], toks["cpu"]
        err = float(np.abs(lg - lc).max())
        tol = rel_tol * float(np.abs(lc).max())
        top2 = np.sort(lc, axis=-1)[:, -2:]
        gaps = (top2[:, 1] - top2[:, 0]).tolist()
        tie = next((i for i, g in enumerate(gaps) if g <= tol), len(gaps))
        # how far below the CPU's top logit the card's pick lies, per step
        below = [float(lc[i].max() - lc[i, t]) for i, t in enumerate(tg)]
        chained = {k: card[k] for k in cuda_qmm_chain.LAUNCHES}
        rec = dict(two_layer_widths=name, arch=cfg.arch, swa_window=cfg.swa_window,
                   alibi_max_bias=cfg.alibi_max_bias, rope_mode=cfg.rope.mode,
                   head_dim=cfg.head_dim, head_dim_v=cfg.head_dim_v,
                   G=cfg.n_heads // cfg.n_kv_heads, unfused_attention_calls=unfused,
                   kv_dtype=str(kv_dtype), logits_max_abs_err=err, tol=tol,
                   rel_err=err / float(np.abs(lc).max()), top2_gaps=gaps,
                   first_near_tie=tie, card_pick_below_cpu_top=below,
                   tokens_card=tg, tokens_cpu=tc,
                   attn_launches=launched, chain_launches=chained, qmm_launches=card["qmm"],
                   n_expert=cfg.n_expert, attn_bias=cfg.attn_bias, qk_norm=cfg.qk_norm,
                   **route.record(), seconds=time.perf_counter() - t0)
        log(json.dumps(rec))
        if not (np.isfinite(lg).all() and lg.shape == (TWO_LAYER_DECODE + 1, cfg.vocab_size)):
            raise AssertionError(f"{name}: card logits not finite or of the wrong shape")
        if not err <= tol:
            raise AssertionError(f"{name} kv {kv_dtype}: max|err| {err} > {tol}")
        if not max(below) <= tol:
            raise AssertionError(f"{name} kv {kv_dtype}: the card's greedy tokens {tg} lie "
                                 f"{below} below the CPU's top logits, tolerance {tol}")
        if tg[:tie] != tc[:tie]:
            raise AssertionError(f"{name} kv {kv_dtype}: greedy tokens {tg} vs {tc} part "
                                 f"before the first near tie at step {tie}")
        for k in cuda_attn.LAUNCHES:
            if (launched[k] > 0) != (k in want):
                raise AssertionError(f"{name} kv {kv_dtype}: attention launches {launched}, "
                                     f"want {want} and no other")
        if (unfused > 0) != (not want):
            raise AssertionError(f"{name} kv {kv_dtype}: {unfused} unfused attention calls "
                                 f"beside flash launches {launched}")
        # the chained row: a GeGLU tail on each layer of each of the card's
        # 2 * TWO_LAYER_DECODE decode steps (generate_loop's, then those replayed), the
        # lm_head (and layer 1's fused head) on K6; the others chain nothing
        steps = 2 * TWO_LAYER_DECODE
        if geo.get("chain"):
            ok = chained["K6_gelu"] == steps * cfg.n_layers and chained["K6"] >= steps
        else:
            ok = not any(chained.values())
        if not ok:
            raise AssertionError(f"{name}: chained launches {chained}")
        # the GGUF rows' base types run their group-size forms: Q2_K / Q3_K
        # the group-size-16 kernels, IQ1_M the group-size-8 ones, TQ2_0 the
        # group-size-256 ones
        if geo.get("ftype") and not card["qmm"][GGUF_ROW_KERNEL[geo["ftype"]]] > 0:
            raise AssertionError(f"{name}: matmul launches {card['qmm']}")
        recs.append(rec)
    return recs


def sweep_chain_seeds(seeds) -> None:
    """What the chained twin's tolerance and seed come from: per seed, the
    card-vs-CPU error over the steps relative to max|logit|, the CPU's
    smallest top-2 gap, and whether the greedy tokens agree. Logs only."""
    import numpy as np

    for seed in seeds:
        _, steps, toks = two_layer_steps(seed, chain=True, gdot=True)
        lg, lc = steps["cuda"], steps["cpu"]
        log(json.dumps(dict(seed=seed, chain=True, gdot=True,
                            card_vs_cpu_rel_err=float(np.abs(lg - lc).max() / np.abs(lc).max()),
                            min_top2_gap=min_top2_gap(lc),
                            min_top2_gap_rel=min_top2_gap(lc) / float(np.abs(lc).max()),
                            distinct_tokens=len(set(toks["cuda"])),
                            tokens_equal=toks["cuda"] == toks["cpu"])))


def sweep_gguf_seeds(seeds, ftypes=("Q3_K_M", "Q2_K", "Q4_K_M")) -> None:
    """Phase 3's GGUF twins over seeds: per ftype (Q4_K_M, whose planes
    the kernels took before the group-size-16 forms, as the control) and
    seed, the card-vs-CPU error of every step relative to max|logit|, the
    CPU's smallest top-2 gap and whether the greedy tokens agree. Logs
    only."""
    import numpy as np

    from llm_tpu_torch.models.synthetic import LLAMA3_8B

    for ftype in ftypes:
        for seed in seeds:
            _, steps, toks = two_layer_steps(seed, geo=dict(LLAMA3_8B, ftype=ftype))
            lg, lc = steps["cuda"], steps["cpu"]
            top = float(np.abs(lc).max())
            log(json.dumps(dict(
                sweep="gguf", ftype=ftype, seed=seed,
                card_vs_cpu_rel_err=float(np.abs(lg - lc).max()) / top,
                step_rel_err=(np.abs(lg - lc).max(axis=1) / top).tolist(),
                max_abs_logit=top, min_top2_gap_rel=min_top2_gap(lc) / top,
                distinct_tokens=len(set(toks["cuda"])),
                tokens_equal=toks["cuda"] == toks["cpu"])))


def sweep_seeds(seeds, devices=("cuda", "cpu")) -> None:
    """What the q8_0 tolerances and seed above come from. For each seed:
    the card's q8_0 prefill logits against its bf16 cache's, and the
    smallest top-2 gaps (relative to max|logit|) of the card's q8_0 steps
    and its bf16 prefill; with the CPU also the q8_0 cache's card-vs-CPU
    error over the steps. Logs; checks nothing."""
    import numpy as np

    for seed in seeds:
        lb = two_layer_steps(seed, devices=("cuda",))[1]["cuda"][0]
        _, steps, toks = two_layer_steps(seed, "q8_0", devices)
        lg = steps["cuda"]
        rec = dict(seed=seed, distinct_tokens=len(set(toks["cuda"])),
                   q8_vs_bf16_prefill_rel_diff=float(np.abs(lg[0] - lb).max()
                                                     / np.abs(lb).max()),
                   top1_equal=int(lg[0].argmax()) == int(lb.argmax()),
                   q8_card_min_top2_gap_rel=min_top2_gap(lg) / float(np.abs(lg).max()),
                   bf16_prefill_top2_gap_rel=min_top2_gap(lb) / float(np.abs(lb).max()))
        if "cpu" in steps:
            lc = steps["cpu"]
            rec.update(q8_card_vs_cpu_rel_err=float(np.abs(lg - lc).max() / np.abs(lc).max()),
                       min_top2_gap=min_top2_gap(lc), tokens_equal=toks["cuda"] == toks["cpu"])
        log(json.dumps(rec))


def kv_bytes(ctx) -> int:
    """Bytes the Context's KV cache holds (int8 planes and scales for q8_0)."""
    return sum(tensor_bytes(c) for c in ctx.kv.k + ctx.kv.v)


def decode_bytes_per_token(ctx):
    """Bytes one decoded token must read at least: every matmul weight
    plane once, plus every layer's whole cache as it is stored (bf16, or
    int8 with its scales) and the bf16 cos/sin tables of every cell (decode
    reads all cells)."""
    from llm_tpu_torch.quant.qtensor import QTensor

    params, cfg = ctx.params, ctx.cfg
    ws = [v for layer in params["layers"] for v in layer.values()] + [params["output"]]
    ws += list(params.get("layers_stacked", {}).values())  # every layer's planes
    w = sum(qt_bytes(v) for v in ws if isinstance(v, QTensor) and v.kmajor)
    # each layer's cells (the ISWA ring's for its sliding-window layers)
    cells = [(k[0] if isinstance(k, tuple) else k).shape[1] for k in ctx.kv.k]
    tables = sum(cells) * 2 * cfg.head_dim * 2
    return w + kv_bytes(ctx) + tables


def decode_counts(params, cfg, chain=False, gdot=False):
    """Launches of K1/K2/K5/K6/K7 (and their forms) per decoded token (one
    row), from the params' keys and plane types: with chain, where the
    model-wide chain_gate admits cfg (no residual scale, no squared relu:
    granite, minicpm, arcee and bitnet chain nothing), one K6 for each
    layer's tail that tail_eligible admits (o_proj, fused gate+up, down;
    K6_gelu where cfg.act is gelu; not one with sub-norms or post-norms),
    each fused QKV head without biases and the lm_head, where chain_fits
    admits them; every other K-major
    matmul on K5 (p4, with gdot) or K1 (p4) or K2 (int8). A mixture-of-
    experts layer's tail is unchained: its o_proj and shared expert on
    K1/K2, its router (dense) and experts (rows-layout planes) plain
    PyTorch. A stacked model runs every layer matmul on K7, chain or not
    (K6's gates refuse stacked planes)."""
    from llm_tpu_torch.models.transformer import chain_gate, n_stacked
    from llm_tpu_torch.ops.cuda_qmm_chain import head_eligible
    from llm_tpu_torch.quant.qtensor import QTensor

    from llm_tpu_torch.ops.cuda_qmm import kernel_name
    from llm_tpu_torch.ops.cuda_qmm_chain import chain_kernel

    from llm_tpu_torch.ops.cuda_qmm import LAUNCHES as QMM_LAUNCHES
    from llm_tpu_torch.ops.cuda_qmm_chain import LAUNCHES as CHAIN_LAUNCHES
    from llm_tpu_torch.ops.cuda_qmm_chain import chain_fits, tail_eligible

    n = {k: 0 for k in (*QMM_LAUNCHES, *CHAIN_LAUNCHES)}
    chain = chain_gate(cfg, chain, 1)
    act = cfg.act

    def one(w):
        n[kernel_name("K5" if gdot and w.layout == "p4" else "K1", w)] += 1

    kmajor = (lambda w: isinstance(w, QTensor) and w.kmajor)
    stacked = params.get("layers_stacked")
    if stacked is not None:
        for w in stacked.values():
            if kmajor(w):
                n[kernel_name("K7", w.map(lambda t: t[0]))] += n_stacked(stacked)
    for layer in params["layers"]:
        moe = "ffn_gate_inp" in layer
        tail = [layer[k] for k in ("attn_output", "ffn_gateup_fused", "ffn_down",
                                   "ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp",
                                   "ffn_gate_inp_shexp") if k in layer]
        head = [layer[k] for k in ("attn_qkv_fused", "attn_q", "attn_k", "attn_v")
                if k in layer]
        if chain and head_eligible(layer) and chain_fits(head):
            n[chain_kernel(head)] += 1
        else:
            for w in head:
                one(w)
        if chain and not moe and tail_eligible(layer) and chain_fits(tail):
            n[chain_kernel(tail, act == "gelu")] += 1
        else:
            for w in tail:  # every quantized matmul (a dense router is plain)
                if isinstance(w, QTensor):
                    one(w)
    if chain and kmajor(params["output"]) and chain_fits([params["output"]]):
        n[chain_kernel([params["output"]])] += 1
    else:
        one(params["output"])
    return n


LLAMA3_8B_PROMPT = 512
LLAMA3_8B_DECODE = 128


def llama3_8b_planes():
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import LLAMA3_8B, make_synthetic_model

    t0 = time.perf_counter()
    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=2, recipe="Q4_K_M", **LLAMA3_8B)
    torch.cuda.synchronize()
    log(f"LLAMA3_8B planes made on the card in {time.perf_counter() - t0:.1f} s")
    return params, cfg


def launch_counts() -> dict:
    from llm_tpu_torch.ops import cuda_attn, cuda_qmm, cuda_qmm_chain

    return {**cuda_qmm.LAUNCHES, **cuda_attn.LAUNCHES, **cuda_qmm_chain.LAUNCHES}


def main_prompt(vocab_size: int, n: int) -> list[int]:
    """The main paths' n-token prompt."""
    return [(i * 104729) % vocab_size for i in range(n)]


def run_llama3_8b(ctx, attn_kernels, keep=None, n_decode=LLAMA3_8B_DECODE,
                  n_prompt=LLAMA3_8B_PROMPT):
    """The main path on ctx: prefill n_prompt (512) tokens, in steps of
    ctx.n_ubatch, then n_decode (128) greedy tokens, with every launch count
    set to 0 just before and read just after. attn_kernels: (decode kernel,
    prefill kernel) the cache type runs; every other attention kernel must
    stay at 0. The matmul kernels per token are decode_counts' for the
    Context's options. keep: a dict that receives the prefill logits, the
    first token and the greedy tokens."""
    import numpy as np

    from llm_tpu_torch.ops import cuda_attn, cuda_qmm, cuda_qmm_chain
    from llm_tpu_torch.runtime.batch import Batch

    cfg = ctx.cfg
    torch.cuda.reset_peak_memory_stats()
    prompt = main_prompt(cfg.vocab_size, n_prompt)
    cuda_qmm.reset_launches()
    cuda_attn.reset_launches()
    cuda_qmm_chain.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert ctx.decode(Batch.text(prompt)) == 0
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    logits = ctx.get_logits()
    after_prefill = launch_counts()
    first = int(np.argmax(logits))
    t0 = time.perf_counter()
    toks = ctx.generate_loop(first, n_decode)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    counts = launch_counts()

    assert np.isfinite(logits).all(), "non-finite prefill logits"
    assert len(toks) == n_decode and all(0 <= t < cfg.vocab_size for t in toks)
    n = len(toks)
    dec, pre = attn_kernels
    per_token = {k: (counts[k] - after_prefill[k]) / n for k in counts}
    want = {k: 0.0 for k in cuda_attn.LAUNCHES}
    want.update({k: float(v) for k, v in decode_counts(ctx.params, ctx.cfg, ctx.chain,
                                                        ctx.gdot).items()})
    want[dec] = float(cfg.n_layers)
    prefill_counts = {k: after_prefill[k] for k in cuda_attn.LAUNCHES}
    want_prefill = {k: 0 for k in cuda_attn.LAUNCHES}
    want_prefill[pre] = cfg.n_layers * -(-n_prompt // ctx.n_ubatch)
    if keep is not None:
        keep.update(logits=logits, first=first, tokens=toks)
    rec = dict(kv_dtype=str(ctx.kv_dtype), chain=ctx.chain, gdot=ctx.gdot, scan=ctx.scan,
               prefill_tokens=n_prompt,
               prefill_s=t_prefill, prefill_tok_s=n_prompt / t_prefill,
               decode_tokens=n, decode_s=t_decode, decode_tok_s=n / t_decode,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               kv_bytes=kv_bytes(ctx),
               decode_bound_tok_s=PEAK_BYTES_PER_S / decode_bytes_per_token(ctx),
               launches=counts, launches_per_token=per_token, expected_per_token=want,
               attn_launches_in_prefill=prefill_counts)
    rec["last_token"] = toks[-1]
    log(json.dumps(rec))
    for k in [k for k, v in want.items() if v > 0] + [pre]:
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    if per_token != want:
        raise AssertionError(f"launches per token {per_token} != {want}")
    if prefill_counts != want_prefill:
        raise AssertionError(f"attention launches in prefill {prefill_counts} != {want_prefill}")
    return counts, rec


def phase_llama3_8b(params, cfg, chain=False, gdot=False, base=None):
    """Phase 4 (no options), 6 (gdot) or 7 (chain and gdot): the main path
    with the bf16 cache, then 8 more decode tokens under torch.profiler
    (tools/profile_decode.py). base: phase 4's record, printed beside."""
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg), chain=chain,
                  gdot=gdot)
    counts, rec = run_llama3_8b(ctx, ("K3", "K4"))
    prof = profile_tokens(ctx, rec["last_token"], 8)
    log("profile_decode " + json.dumps(prof))
    # the profiler's device launches per token (every kernel, memsets and
    # torch ops included), beside rec's per-kernel launches_per_token
    rec.update(device_launches_per_token=prof["device_launches_per_token"],
               idle_share=prof["idle_share"])
    check_gemv_profile(prof)
    check_attn_profile(prof, cfg.n_layers)
    keys = ("decode_tok_s", "prefill_tok_s", "peak_mem_gib", "device_launches_per_token",
            "idle_share")
    side = dict(chain=chain, gdot=gdot, **{k: rec[k] for k in keys})
    if base is not None:
        side.update({f"phase4_{k}": base[k] for k in keys})
    log(json.dumps(side))
    del ctx
    torch.cuda.empty_cache()
    return counts, rec


def check_gemv_profile(prof, memsets: int = 0) -> None:
    """The decode matmuls in a decode profile: no memset (the decode GEMV,
    K5 and K6 split K over clusters and sum in rank order) and no kernel of
    the old GEMV loop. memsets: those a token that come from elsewhere
    (torch.argmax over Gemma-2's 256000 logits, or GLM-4's 151552, zeroes
    its multi-block reduction's semaphores with one memset; over 128256 it
    runs in one pass). A dropped profiler record (check_attn_profile) can only lower
    the count, so the memsets may fall short of that, never exceed it."""
    if prof["memsets_per_token"] > memsets or prof["qmm_gemv_launches_per_token"] != 0:
        raise AssertionError(f"decode runs {prof['memsets_per_token']} memsets and "
                             f"{prof['qmm_gemv_launches_per_token']} qmm_gemv kernels a token")


def check_attn_profile(prof, n_layers: int) -> None:
    """Flash decode in a decode profile: one launch a layer a token (K3 or
    K3q, the cluster kernel) by the wrappers' counters over the profiled
    tokens, and in the profiler's records no combine kernel and no other
    kernel named flash_decode. The profiler's count may fall short of the
    launches (CUPTI drops a record now and then: 255 of 256 flash-decode
    kernels seen once, on an H100), never exceed them."""
    counted, seen = prof["counted_attn_launches_per_token"], prof["attn_launches_per_token"]
    if counted != n_layers or seen > counted or prof["attn_combines_per_token"] != 0:
        raise AssertionError(f"flash decode: {counted} launches counted, {seen} kernels and "
                             f"{prof['attn_combines_per_token']} combines seen a token "
                             f"(want {n_layers}, at most {n_layers}, and 0)")
    if seen != counted:
        log(f"profiler: {seen} flash-decode kernels a token of {counted} launched "
            "(records dropped)")


def phase_decode_turns(params, cfg, n_tokens=32):
    """Decode ms per token of the unfused path (A), the chained one (B,
    chain=True, gdot=True) and gdot alone (C) in turns, A B C C B A A B C,
    each after the same 512-token prompt: host-clock rates vary between
    runs of one path, so this is how the paths are compared within one
    call. Logs only."""
    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context

    prompt = main_prompt(cfg.vocab_size, LLAMA3_8B_PROMPT)
    paths = {"A_unfused": {}, "B_chain_gdot": dict(chain=True, gdot=True),
             "C_gdot": dict(gdot=True)}
    ctxs = {}
    for name, kw in paths.items():
        ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg), **kw)
        assert ctx.decode(Batch.text(prompt)) == 0
        ctx.generate_loop(7, 4)  # warm-up
        ctxs[name] = ctx
    order = list(paths) + list(paths)[::-1] + list(paths)
    runs = {name: [] for name in paths}
    for name in order:
        ctx = ctxs[name]
        ctx.seq_rm(0, LLAMA3_8B_PROMPT, -1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.generate_loop(7, n_tokens)
        torch.cuda.synchronize()
        runs[name].append((time.perf_counter() - t0) / n_tokens * 1e3)
    log(json.dumps(dict(decode_turns_order=order, decode_turns_ms_per_token=runs)))
    del ctxs
    torch.cuda.empty_cache()


# the q8_0 cache of LLAMA3_8B at 4096 cells: per layer, K and V each hold
# 8 x 4096 x 128 int8 (4 MiB) and 8 x 4096 bf16 scales (64 KiB)
Q8_KV_BYTES = 32 * 2 * (8 * 4096 * 128 + 8 * 4096 * 2)  # 272,629,760


def phase_llama3_8b_q8(params, cfg, bf16_rec):
    """Phase 5: phase 4's planes with a q8_0 cache; then the prompt's cells
    through state_seq_save / state_seq_load into a fresh Context."""
    import numpy as np

    from llm_tpu_torch.ops import cuda_build
    from llm_tpu_torch.runtime import state
    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg),
                  kv_dtype="q8_0")
    counts, rec = run_llama3_8b(ctx, ("K3q", "K4q"))
    if rec["kv_bytes"] != Q8_KV_BYTES:
        raise AssertionError(f"q8_0 cache holds {rec['kv_bytes']} B, not {Q8_KV_BYTES}")
    saved = bf16_rec["peak_mem_gib"] - rec["peak_mem_gib"]
    if not saved >= 0.2:
        raise AssertionError(f"q8_0 peak memory is only {saved:.3f} GiB below bf16's")
    prof = profile_tokens(ctx, rec["last_token"], 8)
    log("profile_decode " + json.dumps(prof))
    check_attn_profile(prof, cfg.n_layers)

    # the prompt's cells: drop the generated tokens (a metadata edit), save
    # sequence 0, load it into a fresh Context
    P = LLAMA3_8B_PROMPT
    ctx.seq_rm(0, P, -1)
    BUILD = cuda_build.BUILD_DIR
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = f"{tmp}/seq0.npz"
        t0 = time.perf_counter()
        state.state_seq_save(ctx, 0, path)
        t_save = time.perf_counter() - t0
        fresh = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg),
                        kv_dtype="q8_0")
        t0 = time.perf_counter()
        state.state_seq_load(fresh, 0, path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    cells = np.flatnonzero(ctx.cells.seq_mask(0))
    slots = np.flatnonzero(fresh.cells.seq_mask(0))
    if len(cells) != P or not np.array_equal(fresh.cells.pos[slots], ctx.cells.pos[cells]):
        raise AssertionError("the loaded sequence's cells differ from the saved ones")
    ci = torch.as_tensor(cells, device="cuda")
    si = torch.as_tensor(slots, device="cuda")
    for a, b in zip(ctx.kv.k + ctx.kv.v, fresh.kv.k + fresh.kv.v):
        for x, y in zip(a, b):
            if not torch.equal(x[:, ci], y[:, si]):
                raise AssertionError("loaded q8_0 planes are not bit-equal to the saved ones")
    tok = 7
    assert ctx.decode(Batch.one(tok, pos=P)) == 0
    want = ctx.get_logits().copy()
    assert fresh.decode(Batch.one(tok, pos=P)) == 0
    got = fresh.get_logits()
    err = float(np.abs(got - want).max())
    tol = TWO_LAYER_Q8_REL_TOL * float(np.abs(want).max())
    log(json.dumps(dict(state_seq_cells=P, state_save_s=t_save, state_load_s=t_load,
                        planes_bit_equal=True, step_logits_max_abs_err=err, tol=tol)))
    if not (np.isfinite(got).all() and err <= tol):
        raise AssertionError(f"decode after state load: max|err| {err} > {tol}")
    del ctx, fresh
    torch.cuda.empty_cache()
    return counts


# the server phase's near tie: where the server's text parts from the
# reference's tokens, the reference's top two logits at that step within
# this share of max|logit| (a flag in its record)
SCAN_TIE_REL = 1e-3
# phase 8's scan against the per-layer Context on the same planes (and
# phases 15 and 16's uniform scans, phase 11's ISWA ring against
# swa_full, phase 16's chained runs against the unfused one): both
# Contexts' logits, at the prefill (or steps_against's decode steps)
# and at a replayed step where their greedy streams part, within this
# share of max|logit|, and a part only where the top two lie within it.
# Decode's K1 and K7 are bit-equal; the prefill GEMM's split-K atomics may
# add in another order from launch to launch, and a last-bit difference
# can cross a bf16 rounding of an activation and carry through the layers
# (and the cache). About 3x the largest reading (LLAMA3_8B Q4_K 9.6e-3,
# IQ1_M 9.6e-3 and chained 9.1e-3, Q2_K 7.5e-3; Gemma-2-9B's ring 3.6e-3;
# PERF.md)
SCAN_REL_TOL = 3e-2
# the same on the random 30-layer BitNet b1.58 2B4T (relu2 and two
# sub-norms a layer), which carries a last-bit difference furthest: its
# uniform TQ2_0 scan's prefill read 1.66e-2 and 4.80e-2 in two runs, its
# chained steps 2.75e-2 and 2.67e-2 (K5's correction operands also rounded
# to bf16, as the reference's gdot kernel rounds them). About 3x the
# largest (PERF.md)
BITNET_REL_TOL = 1.5e-1


def top2_gap(logits) -> float:
    import numpy as np

    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def compare_streams(scan_ctx, scan_keep, layer_ctx, layer_keep,
                    n_prompt=LLAMA3_8B_PROMPT, rel_tol=SCAN_REL_TOL) -> dict:
    """Phase 8: the scan's prefill logits and greedy stream against the
    per-layer Context's on the same planes (phase 11: the ISWA ring's
    against swa_full's, after an n_prompt-token prompt). The prefill logits
    within rel_tol of max|logit|; the streams equal, or parted only at a
    step whose logits (replayed on both Contexts, from an empty sequence,
    over the prompt and the common stream: a ring cannot rewind past cells
    it pruned) lie within rel_tol of max|logit| of each other, and whose
    top two per-layer logits lie within it too."""
    import numpy as np

    from llm_tpu_torch.runtime.batch import Batch

    ls, lp = scan_keep["logits"], layer_keep["logits"]
    ss = [scan_keep["first"]] + scan_keep["tokens"]
    sp = [layer_keep["first"]] + layer_keep["tokens"]
    diff, top = float(np.abs(ls - lp).max()), float(np.abs(lp).max())
    rec = dict(scan_vs_per_layer_prefill_max_abs_diff=diff, prefill_max_abs_logit=top,
               prefill_rel_diff=diff / top, prefill_logits_bit_equal=bool(np.array_equal(ls, lp)),
               greedy_tokens_equal=ss == sp, prefill_top2_gap=top2_gap(lp))
    if not diff <= rel_tol * top:
        log(json.dumps(rec))
        raise AssertionError(f"scan and per-layer prefill logits: max|diff| {diff} > "
                             f"{rel_tol} of {top}")
    if ss != sp:
        i = next(j for j, (a, b) in enumerate(zip(ss, sp)) if a != b)
        if i > 0:
            for c in (scan_ctx, layer_ctx):
                c.seq_rm(0)
                assert c.decode(Batch.text(main_prompt(c.cfg.vocab_size, n_prompt)
                                           + sp[:i])) == 0
            ls, lp = scan_ctx.get_logits(), layer_ctx.get_logits()
        diff, gap, top = float(np.abs(ls - lp).max()), top2_gap(lp), float(np.abs(lp).max())
        rec.update(parted_at_step=i, step_max_abs_diff=diff, step_top2_gap=gap,
                   step_max_abs_logit=top, tol=rel_tol * top)
        if not (diff <= rec["tol"] and gap <= rec["tol"]):
            log(json.dumps(rec))
            raise AssertionError(f"scan and per-layer greedy streams part at step {i}: "
                                 f"max|diff| {diff}, top-2 gap {gap}, tolerance {rec['tol']}")
    log(json.dumps(rec))
    return rec


# phase 8's decode tokens for the scan's gdot and chain options: their
# launches per token are fixed from the first token on
SCAN_OPTION_DECODE = 16


def phase_scan():
    """Phase 8: the scan decoder at LLAMA3_8B on uniform planes made on the
    card (Q4_K everywhere, then Q8_0 everywhere: a Q4_K_M mix does not
    stack). Every layer matmul must run K7 (4 a layer a token: fused QKV,
    o_proj, fused gate+up, down) and the lm_head K1 / K5 (gdot) / K6
    (chain) / K2 (Q8_0); attention K3 32 a token. The plain Q4_K and the
    Q8_0 scans run 128 tokens and are profiled; the per-layer run 128
    tokens for the comparison of streams; gdot and chain SCAN_OPTION_DECODE.
    Returns each kernel's launches from the path that runs it: K7 from the
    plain scan run."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import LLAMA3_8B, make_synthetic_model
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    def planes(qtype):
        t0 = time.perf_counter()
        params, cfg = make_synthetic_model(qtype=GGMLType[qtype], device="cuda", on_device=True,
                                           seed=3, recipe=None, **LLAMA3_8B)
        torch.cuda.synchronize()
        log(f"uniform {qtype} LLAMA3_8B planes made on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        return params, cfg

    keys = ("decode_tok_s", "prefill_tok_s", "peak_mem_gib", "device_launches_per_token",
            "idle_share", "launches_per_token")

    def run(qtype, params, cfg, keep=None, profile=False, n_decode=LLAMA3_8B_DECODE, **kw):
        ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg), **kw)
        if kw.get("scan_layers") and not ctx.scan:
            raise AssertionError(f"the uniform {qtype} planes did not stack")
        counts, rec = run_llama3_8b(ctx, ("K3", "K4"), keep, n_decode)
        if profile:
            prof = profile_tokens(ctx, rec["last_token"], 8)
            log("profile_decode " + json.dumps(prof))
            check_gemv_profile(prof)
            check_attn_profile(prof, cfg.n_layers)
            rec.update(device_launches_per_token=prof["device_launches_per_token"],
                       idle_share=prof["idle_share"])
        log(json.dumps(dict(phase=8, qtype=qtype, scan=ctx.scan, chain=ctx.chain,
                            gdot=ctx.gdot, **{k: rec[k] for k in keys if k in rec})))
        return ctx, counts

    params, cfg = planes("Q4_K")
    scan_keep, layer_keep = {}, {}
    scan_ctx, counts = run("Q4_K", params, cfg, scan_keep, profile=True, scan_layers=True)
    layer_ctx, _ = run("Q4_K", params, cfg, layer_keep)
    compare_streams(scan_ctx, scan_keep, layer_ctx, layer_keep)
    stacked = scan_ctx.params  # the scan options below reuse its stacked planes
    del layer_ctx, scan_ctx, params
    torch.cuda.empty_cache()
    run("Q4_K", stacked, cfg, n_decode=SCAN_OPTION_DECODE, gdot=True)
    run("Q4_K", stacked, cfg, n_decode=SCAN_OPTION_DECODE, chain=True, gdot=True)
    del stacked
    torch.cuda.empty_cache()
    params, cfg = planes("Q8_0")
    ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg), scan_layers=True)
    del params  # the per-layer planes: the Context keeps the stacked ones
    torch.cuda.empty_cache()
    run("Q8_0", ctx.params, cfg, profile=True, scan_layers=True)
    del ctx
    torch.cuda.empty_cache()
    return counts


# phase 15's runs: the Q3_K_M planes' options (gdot, chain) and the uniform
# Q2_K scan take this many tokens (their launches per token are fixed from
# the first token on), the Q2_K recipe's run LOWBIT_Q2K_DECODE
LOWBIT_OPTION_DECODE = 16
LOWBIT_Q2K_DECODE = 32


def lowbit_planes(recipe: str | None, qtype: str, seed: int):
    """LLAMA3_8B's planes made on the card: a recipe's type mix (Q3_K_M or
    Q2_K: models/synthetic.py's tensor_type_for), or qtype everywhere
    (recipe None). Returns (params, cfg, planes_summary's record)."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import LLAMA3_8B, make_synthetic_model

    t0 = time.perf_counter()
    params, cfg = make_synthetic_model(qtype=GGMLType[qtype], device="cuda", on_device=True,
                                       seed=seed, recipe=recipe, **LLAMA3_8B)
    torch.cuda.synchronize()
    log(json.dumps(dict(phase=15, recipe=recipe, qtype=qtype,
                        planes_s=time.perf_counter() - t0)))
    return params, cfg, planes_summary(params, cfg, f"llama3_8b_{recipe or qtype}")


def phase_llama3_8b_lowbit() -> dict:
    """Phase 15: LLAMA3_8B at 32 layers on Q3_K_M-style planes made on the
    card from seed 17 (Q3_K nibble planes at group size 16 with zero point
    4 everywhere; attn_v Q5_K in layers 0-1, else Q4_K, so QKV stays
    unfused; ffn_down Q4_K in layers 0-1; a Q6_K lm_head; a Q3_K
    embedding table): prefill 512 and 128 greedy tokens with every
    kernel's launches (K1_gs16 for every Q3_K matmul), profiled over 8
    more tokens (device ms, idle share, no memset); decode_bound_tok_s
    from these planes' bytes; then gdot=True (K5_gs16) and chain=True,
    gdot=True (K6_gs16 for every tail, K5_gs16 for the unfused QKV) for
    LOWBIT_OPTION_DECODE tokens each, each stream equal to the unfused one
    or parted only at a near tie. Then Q2_K-recipe planes (seed 18: Q2_K
    with mins, attn_v Q4_K, ffn_down Q3_K in the use_more_bits layers):
    prefill 512, LOWBIT_Q2K_DECODE tokens. Then uniform Q2_K planes (seed
    19, every matrix and the lm_head) through Context(scan_layers=True),
    every layer matmul on K7_gs16 (4 a layer a token) and the lm_head on
    K1_gs16, against the per-layer Context on the same planes
    (compare_streams), LOWBIT_OPTION_DECODE tokens each. Returns the
    group-size-16 kernels' launches from the runs that drive them and the
    records."""
    from llm_tpu_torch.models.synthetic import use_more_bits
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    out = {}
    params, cfg, planes = lowbit_planes("Q3_K_M", "Q3_K", 17)
    l0, l5 = params["layers"][0], params["layers"][5]
    types = {k: (l5[k].ggml_type.name, l5[k].layout, l5[k].group_size, l5[k].zp)
             for k in ("attn_q", "attn_v", "attn_output", "ffn_gateup_fused", "ffn_down")}
    if types != {"attn_q": ("Q3_K", "p4", 16, 4), "attn_v": ("Q4_K", "p4", 32, 0),
                 "attn_output": ("Q3_K", "p4", 16, 4),
                 "ffn_gateup_fused": ("Q3_K", "p4", 16, 4),
                 "ffn_down": ("Q3_K", "p4", 16, 4)} \
            or l0["attn_v"].ggml_type.name != "Q5_K" or l0["ffn_down"].ggml_type.name != "Q4_K":
        raise AssertionError(f"not the Q3_K_M recipe's planes: layer 5 {types}")
    ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg))
    keep = {}
    counts, rec = run_llama3_8b(ctx, ("K3", "K4"), keep)
    prof = profile_tokens(ctx, rec["last_token"], 8)
    log("profile_decode " + json.dumps(prof))
    check_gemv_profile(prof)
    check_attn_profile(prof, cfg.n_layers)
    out["Q3_K_M"] = dict(
        phase=15, path="LLAMA3_8B Q3_K_M", decode_tok_s=rec["decode_tok_s"],
        prefill_tok_s=rec["prefill_tok_s"], decode_bound_tok_s=rec["decode_bound_tok_s"],
        planes_bytes=planes["llama3_8b_Q3_K_M_planes_bytes"], peak_mem_gib=rec["peak_mem_gib"],
        device_busy_ms_per_token=prof["device_busy_ms_per_token"],
        idle_share=prof["idle_share"], gemv_ms_per_token=prof.get("gemv_ms_per_token"),
        device_launches_per_token=prof["device_launches_per_token"],
        launches_per_token={k: v for k, v in rec["launches_per_token"].items() if v})
    log(json.dumps(out["Q3_K_M"]))
    for name, kw in (("gdot", dict(gdot=True)), ("chain", dict(chain=True, gdot=True))):
        other = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg), **kw)
        keep_o = {}
        counts_o, rec_o = run_llama3_8b(other, ("K3", "K4"), keep_o, LOWBIT_OPTION_DECODE)
        out[name] = dict(phase=15, path=f"LLAMA3_8B Q3_K_M {name}",
                         decode_tok_s=rec_o["decode_tok_s"],
                         launches_per_token={k: v for k, v in
                                             rec_o["launches_per_token"].items() if v},
                         **parted_at_near_tie(ctx, keep, keep_o, LLAMA3_8B_PROMPT,
                                              TWO_LAYER_CHAIN_REL_TOL))
        log(json.dumps(out[name]))
        # K5_gs16's launches from the gdot run, K6_gs16's from the chained one
        key = "K5_gs16" if name == "gdot" else "K6_gs16"
        counts[key] = counts_o[key]
        del other
    del ctx, params
    torch.cuda.empty_cache()

    params, cfg, _ = lowbit_planes("Q2_K", "Q2_K", 18)
    downs = [layer["ffn_down"].ggml_type.name for layer in params["layers"]]
    if downs != ["Q3_K" if use_more_bits(il, cfg.n_layers) else "Q2_K"
                 for il in range(cfg.n_layers)] \
            or params["layers"][1]["attn_v"].ggml_type.name != "Q4_K" \
            or params["layers"][1]["ffn_gateup_fused"].mins is None:
        raise AssertionError(f"not the Q2_K recipe's planes: ffn_down {downs}")
    ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg))
    _, rec = run_llama3_8b(ctx, ("K3", "K4"), None, LOWBIT_Q2K_DECODE)
    out["Q2_K"] = dict(phase=15, path="LLAMA3_8B Q2_K", decode_tok_s=rec["decode_tok_s"],
                       prefill_tok_s=rec["prefill_tok_s"],
                       decode_bound_tok_s=rec["decode_bound_tok_s"],
                       peak_mem_gib=rec["peak_mem_gib"],
                       launches_per_token={k: v for k, v in rec["launches_per_token"].items()
                                           if v})
    log(json.dumps(out["Q2_K"]))
    del ctx, params
    torch.cuda.empty_cache()

    params, cfg, _ = lowbit_planes(None, "Q2_K", 19)
    scan_keep, layer_keep = {}, {}
    scan_ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg),
                       scan_layers=True)
    if not scan_ctx.scan:
        raise AssertionError("the uniform Q2_K planes did not stack")
    counts_s, rec_s = run_llama3_8b(scan_ctx, ("K3", "K4"), scan_keep, LOWBIT_OPTION_DECODE)
    layer_ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg))
    run_llama3_8b(layer_ctx, ("K3", "K4"), layer_keep, LOWBIT_OPTION_DECODE)
    out["scan"] = dict(phase=15, path="LLAMA3_8B uniform Q2_K scan",
                       decode_tok_s=rec_s["decode_tok_s"],
                       launches_per_token={k: v for k, v in
                                           rec_s["launches_per_token"].items() if v},
                       **compare_streams(scan_ctx, scan_keep, layer_ctx, layer_keep))
    log(json.dumps(out["scan"]))
    counts["K7_gs16"] = counts_s["K7_gs16"]
    del scan_ctx, layer_ctx, params
    torch.cuda.empty_cache()
    out["counts"] = counts
    return out


# phase 16's decode tokens for the chained and scan runs beside each full run
IQ_OPTION_DECODE = 16
# the group-size-256 and -8 kernels of the IQ and ternary types, counted
# apart, which phase 16 drives (and phase 2 holds against their plain
# versions)
IQ_KERNELS = ("K1_gs256", "K5_gs256", "K6_gs256", "K7_gs256", "K2_gs8", "K6_gs8", "K7_gs8")
# phase 16's LLAMA3_8B on TQ2_0-recipe planes, cut to this many of its 32
# layers: its chained run drives K6_gs256 (BitNet's squared relu keeps the
# whole model unchained, as the reference's gate does)
IQ_TQ2_LLAMA_LAYERS = 8


def iq_planes(recipe: str | None, qtype: str, seed: int, arch: str = "llama",
              layers: int | None = None):
    """Phase 16's planes made on the card: LLAMA3_8B (arch llama) or BitNet
    b1.58 2B4T (arch bitnet) at full depth (or `layers`), a recipe's type mix
    (models/synthetic.py's tensor_type_for) or qtype everywhere (recipe
    None), f32 scales as a loaded GGUF has them. Returns (params, cfg,
    planes_summary's record)."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import BITNET_B158_2B, LLAMA3_8B, make_synthetic_model

    geo = dict(BITNET_B158_2B if arch == "bitnet" else LLAMA3_8B)
    if layers is not None:
        geo["n_layers"] = layers
    t0 = time.perf_counter()
    params, cfg = make_synthetic_model(qtype=GGMLType[qtype], device="cuda", on_device=True,
                                       seed=seed, recipe=recipe, arch=arch,
                                       scales_dtype=torch.float32, **geo)
    torch.cuda.synchronize()
    log(json.dumps(dict(phase=16, arch=arch, recipe=recipe, qtype=qtype,
                        planes_s=time.perf_counter() - t0)))
    return params, cfg, planes_summary(params, cfg, f"{arch}_{recipe or qtype}")


def full_depth_tol(cfg) -> float:
    """Phase 16's tolerance of one full-depth Context against another on
    the same planes, relative to max|logit|: BITNET_REL_TOL on bitnet,
    else SCAN_REL_TOL."""
    return BITNET_REL_TOL if cfg.arch == "bitnet" else SCAN_REL_TOL


def iq_full_run(tag: str, params, cfg, planes_bytes: int, options: dict
                ) -> tuple[dict, dict]:
    """One phase 16 model: prefill 512 and 128 greedy tokens with every
    kernel's launches, profiled over 8 more tokens (device ms, idle share,
    no memset); decode_bound_tok_s from these planes' bytes; then each of
    `options` (name: Context keywords) for IQ_OPTION_DECODE tokens, each
    stream equal to the unfused one or parted only where the unfused
    logits' top two lie within full_depth_tol of max|logit|, and each
    Context's logits held to the unfused one's at that tolerance over
    steps_against's decode steps. Returns ({run: launch counts},
    {run: record})."""
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg))
    keep = {}
    counts, rec = run_llama3_8b(ctx, ("K3", "K4"), keep)
    prof = profile_tokens(ctx, rec["last_token"], 8)
    log("profile_decode " + json.dumps(prof))
    check_gemv_profile(prof)
    check_attn_profile(prof, cfg.n_layers)
    out = {tag: dict(
        phase=16, path=tag, decode_tok_s=rec["decode_tok_s"], prefill_tok_s=rec["prefill_tok_s"],
        decode_bound_tok_s=rec["decode_bound_tok_s"],
        planes_bytes=planes_bytes,
        peak_mem_gib=rec["peak_mem_gib"],
        device_busy_ms_per_token=prof["device_busy_ms_per_token"],
        idle_share=prof["idle_share"], gemv_ms_per_token=prof.get("gemv_ms_per_token"),
        device_launches_per_token=prof["device_launches_per_token"],
        launches_per_token={k: v for k, v in rec["launches_per_token"].items() if v})}
    log(json.dumps(out[tag]))
    runs = {tag: counts}
    for name, kw in options.items():
        other = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg), **kw)
        keep_o = {}
        runs[name], rec_o = run_llama3_8b(other, ("K3", "K4"), keep_o, IQ_OPTION_DECODE)
        path = f"{tag} {name}"
        out[path] = dict(phase=16, path=path, decode_tok_s=rec_o["decode_tok_s"],
                         launches_per_token={k: v for k, v in
                                             rec_o["launches_per_token"].items() if v},
                         **parted_at_near_tie(ctx, keep, keep_o, LLAMA3_8B_PROMPT,
                                              full_depth_tol(cfg)),
                         steps=steps_against(other, ctx, LLAMA3_8B_PROMPT, full_depth_tol(cfg)))
        log(json.dumps(out[path]))
        del other
    return runs, out


def iq_scan_run(tag: str, params, cfg) -> tuple[dict, dict]:
    """Uniform planes through Context(scan_layers=True), every layer matmul
    on K7, against the per-layer Context on the same planes
    (compare_streams), IQ_OPTION_DECODE tokens each."""
    from llm_tpu_torch.runtime.engine import Context

    scan_keep, layer_keep = {}, {}
    scan_ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg),
                       scan_layers=True)
    if not scan_ctx.scan:
        raise AssertionError(f"{tag}: the uniform planes did not stack")
    counts, rec = run_llama3_8b(scan_ctx, ("K3", "K4"), scan_keep, IQ_OPTION_DECODE)
    layer_ctx = Context(None, n_cells=4096, device="cuda", params_cfg=(params, cfg))
    run_llama3_8b(layer_ctx, ("K3", "K4"), layer_keep, IQ_OPTION_DECODE)
    out = dict(phase=16, path=f"{tag} scan", decode_tok_s=rec["decode_tok_s"],
               launches_per_token={k: v for k, v in rec["launches_per_token"].items() if v},
               **compare_streams(scan_ctx, scan_keep, layer_ctx, layer_keep,
                                 rel_tol=full_depth_tol(cfg)))
    log(json.dumps(out))
    return counts, out


def phase_iq() -> dict:
    """Phase 16: the IQ and ternary plane types at full depth, planes made
    on the card from fixed seeds with f32 scales.
      * LLAMA3_8B (32 layers) on IQ2_XXS-recipe planes (seed 21: IQ2_XXS
        int8 planes at group size 32, attn_v Q4_K, so QKV stays unfused,
        ffn_down IQ3_XXS in layers 0-1, a Q5_K lm_head, a Q2_K table);
      * LLAMA3_8B on IQ1_M-recipe planes (seed 22: IQ1_M int8 planes at
        group size 8 on K2_gs8, the same mix), and with chain=True,
        gdot=True (K6_gs8 for every tail, the IQ3_XXS downs beside it);
      * BitNet b1.58 2B4T (30 layers) on TQ2_0 planes (seed 23: nibble
        planes at group size 256, zero point 1, on K1_gs256; a Q6_K
        lm_head), and with chain=True, gdot=True (its squared relu keeps
        every step unchained, as the reference's gate does: no K6 launch,
        K5_gs256 for every TQ2_0 matmul);
      * LLAMA3_8B at IQ_TQ2_LLAMA_LAYERS layers on TQ2_0-recipe planes
        (seed 26), and with chain=True, gdot=True (K6_gs256 for every
        norm -> QKV head and tail, K6 for the Q6_K lm_head);
    each as iq_full_run; then uniform TQ2_0 (BitNet, seed 24) and uniform
    IQ1_M (LLAMA3_8B, seed 25) planes through the scan decoder (K7_gs256,
    K7_gs8) against the per-layer Context (iq_scan_run). Returns the
    kernels' launches from the runs that drive them, and the records."""
    out, counts = {}, {}
    params, cfg, planes = iq_planes("IQ2_XXS", "IQ2_XXS", 21)
    l1, l2 = params["layers"][1], params["layers"][2]
    types = {k: (l2[k].ggml_type.name, l2[k].layout, l2[k].group_size)
             for k in ("attn_q", "attn_v", "attn_output", "ffn_gateup_fused", "ffn_down")}
    if types != {"attn_q": ("IQ2_XXS", "i8", 32), "attn_v": ("Q4_K", "p4", 32),
                 "attn_output": ("IQ2_XXS", "i8", 32),
                 "ffn_gateup_fused": ("IQ2_XXS", "i8", 32),
                 "ffn_down": ("IQ2_XXS", "i8", 32)} \
            or l1["ffn_down"].ggml_type.name != "IQ3_XXS" \
            or params["output"].ggml_type.name != "Q5_K" \
            or params["tok_embd"].ggml_type.name != "Q2_K":
        raise AssertionError(f"not the IQ2_XXS recipe's planes: layer 2 {types}")
    _, rec = iq_full_run("LLAMA3_8B IQ2_XXS", params, cfg,
                         planes["llama_IQ2_XXS_planes_bytes"], {})
    out.update(rec)
    del params
    torch.cuda.empty_cache()

    params, cfg, planes = iq_planes("IQ1_M", "IQ1_M", 22)
    qt = params["layers"][2]["ffn_gateup_fused"]
    if (qt.ggml_type.name, qt.layout, qt.group_size) != ("IQ1_M", "i8", 8) \
            or params["layers"][0]["ffn_down"].ggml_type.name != "IQ3_XXS":
        raise AssertionError("not the IQ1_M recipe's planes")
    runs, rec = iq_full_run("LLAMA3_8B IQ1_M", params, cfg, planes["llama_IQ1_M_planes_bytes"],
                            {"chain": dict(chain=True, gdot=True)})
    out.update(rec)
    counts["K2_gs8"] = runs["LLAMA3_8B IQ1_M"]["K2_gs8"]
    counts["K6_gs8"] = runs["chain"]["K6_gs8"]
    del params
    torch.cuda.empty_cache()

    params, cfg, planes = iq_planes("TQ2_0", "TQ2_0", 23, arch="bitnet")
    qt = params["layers"][3]["attn_qkv_fused"]
    if (cfg.arch, cfg.act, qt.ggml_type.name, qt.layout, qt.group_size, qt.zp) != \
            ("bitnet", "relu2", "TQ2_0", "p4", 256, 1) \
            or "ffn_sub_norm" not in params["layers"][3] \
            or params["output"].ggml_type.name != "Q6_K":
        raise AssertionError("not BitNet's TQ2_0 planes")
    runs, rec = iq_full_run("BitNet-b1.58-2B TQ2_0", params, cfg,
                            planes["bitnet_TQ2_0_planes_bytes"],
                            {"chain": dict(chain=True, gdot=True)})
    out.update(rec)
    counts["K1_gs256"] = runs["BitNet-b1.58-2B TQ2_0"]["K1_gs256"]
    counts["K5_gs256"] = runs["chain"]["K5_gs256"]
    if any(runs["chain"][k] for k in ("K6", "K6_gelu", "K6_gs16", "K6_gs256", "K6_gs8")):
        raise AssertionError(f"BitNet under chain=True launched K6: {runs['chain']}")
    del params
    torch.cuda.empty_cache()

    params, cfg, planes = iq_planes("TQ2_0", "TQ2_0", 26, layers=IQ_TQ2_LLAMA_LAYERS)
    runs, rec = iq_full_run(f"LLAMA3_8B TQ2_0 {IQ_TQ2_LLAMA_LAYERS} layers", params, cfg,
                            planes["llama_TQ2_0_planes_bytes"],
                            {"chain": dict(chain=True, gdot=True)})
    out.update(rec)
    counts["K6_gs256"] = runs["chain"]["K6_gs256"]
    del params
    torch.cuda.empty_cache()

    for tag, arch, qtype, seed, kern in (("BitNet-b1.58-2B uniform TQ2_0", "bitnet", "TQ2_0",
                                          24, "K7_gs256"),
                                         ("LLAMA3_8B uniform IQ1_M", "llama", "IQ1_M", 25,
                                          "K7_gs8")):
        params, cfg, _ = iq_planes(None, qtype, seed, arch=arch)
        runs_s, out[f"{tag} scan"] = iq_scan_run(tag, params, cfg)
        counts[kern] = runs_s[kern]
        del params
        torch.cuda.empty_cache()
    out["counts"] = counts
    return out


# the CLI phase: a prompt of about this many tokens, then -n 128 at temp 0,
# on a file of LLAMA3_8B's widths and GGUF_LAYERS of its 32 layers (cut
# from 32 to 8, then to 4 and to 2, to keep the script near its time:
# the host builds the planes of the file twice, in the CLI's process and
# in this one, ~3 s a layer)
GGUF_PROMPT_TOKENS = 512
GGUF_DECODE = 128
GGUF_LAYERS = 2
_WORDS = ("the of and to in is was that for on with as by at from his her they which "
          "this have had were are but not be one all their there when an who will more "
          "time about would up out so what some into than could them other only then "
          "water people year world house number point river small city music light "
          "mountain story garden morning language question history family paper").split()


def gguf_prompt(tok, n_tokens: int = GGUF_PROMPT_TOKENS) -> str:
    """English-like text from a fixed seed, sentences added until it
    tokenizes to at least n_tokens."""
    import numpy as np

    rng = np.random.default_rng(11)
    text = ""
    while len(tok.encode(text, add_special=True, parse_special=True)) < n_tokens:
        words = [str(w) for w in rng.choice(_WORDS, 12)]
        text += " ".join(words).capitalize() + ". "
    return text



# phase 10: the server on phase 9's 8B Context: 4 slots, prompts of about
# SERVER_PROMPT_TOKENS tokens, SERVER_DECODE tokens a request
SERVER_SLOTS, SERVER_PROMPT_TOKENS, SERVER_DECODE = 4, 128, 64


def http(port: int, method: str, path: str, body=None, stream: bool = False) -> dict:
    """One request to the port's server with urllib: its status, JSON body
    (or, streamed, the SSE events' payloads), the seconds to the first
    event (TTFT) and in all. Raises on a status other than 200."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=None if body is None else json.dumps(body).encode())
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{method} {path}: status {r.status}")
        if not stream:
            raw = r.read()
            ctype = r.headers["Content-Type"]
            out = json.loads(raw) if ctype.startswith("application/json") else raw.decode()
            return dict(body=out, total_s=time.perf_counter() - t0)
        events, ttft, done = [], None, False
        for line in r:
            line = line.decode().rstrip("\n")
            if not line:
                continue
            if not line.startswith("data: "):
                raise AssertionError(f"{path}: not an SSE line: {line!r}")
            if line == "data: [DONE]":
                done = True
                break
            if ttft is None:
                ttft = time.perf_counter() - t0
            events.append(json.loads(line[len("data: "):]))
        if not done:
            raise AssertionError(f"{path}: the stream ended without [DONE]")
        return dict(events=events, ttft_s=ttft, total_s=time.perf_counter() - t0)


def concurrently(fns) -> list:
    """Run the calls on threads at once; their results in order. A failed
    call fails the phase."""
    import threading

    out, errs = [None] * len(fns), []

    def run(i, f):
        try:
            out[i] = f()
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)

    ths = [threading.Thread(target=run, args=(i, f)) for i, f in enumerate(fns)]
    t0 = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    if errs:
        raise errs[0]
    return out, time.perf_counter() - t0


def server_prompts(tok, n: int) -> list[str]:
    """n distinct prompts of about SERVER_PROMPT_TOKENS tokens."""
    import numpy as np

    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        text = ""
        while len(tok.encode(text, add_special=True, parse_special=True)) < SERVER_PROMPT_TOKENS:
            text += " ".join(str(w) for w in rng.choice(_WORDS, 12)).capitalize() + ". "
        out.append(text)
    return out


def greedy_reference(ctx, tok, prompt: str, n: int, eogs, seq_id: int = SERVER_SLOTS + 1):
    """A prompt's own Context.decode + generate_loop on a spare sequence:
    (tokens, their pieces); the sequence is emptied after."""
    import numpy as np

    from llm_tpu_torch.runtime.batch import Batch

    ptoks = tok.encode(prompt, add_special=True, parse_special=True)
    ctx.seq_rm(seq_id)
    assert ctx.decode(Batch.text(ptoks, seq_id=seq_id)) == 0
    first = int(np.argmax(ctx.get_logits()))
    toks = [first] + ctx.generate_loop(first, n - 1, seq_id=seq_id, eog_ids=eogs)
    ctx.seq_rm(seq_id)
    if toks and toks[-1] in eogs:
        toks = toks[:-1]  # the server stops before an EOG token
    return ptoks, toks


def parted_at_a_tie(ctx, tok, ptoks, want, got_text, seq_id: int = SERVER_SLOTS + 1) -> dict:
    """Where the server's text and the reference's tokens part: the step
    whose pieces stop matching, and that step's top-2 gap of the
    reference's logits (replayed from the common prefix) against
    SCAN_TIE_REL of max|logit|."""
    import numpy as np

    from llm_tpu_torch.runtime.batch import Batch

    text, i = "", 0
    while i < len(want) and got_text.startswith(text + tok.piece(want[i])):
        text += tok.piece(want[i])
        i += 1
    ctx.seq_rm(seq_id)
    assert ctx.decode(Batch.text(ptoks + want[:i], seq_id=seq_id)) == 0
    lg = ctx.get_logits()
    ctx.seq_rm(seq_id)
    gap = top2_gap(lg)
    return dict(parted_at_step=i, top2_gap=gap, max_abs_logit=float(np.abs(lg).max()),
                near_tie=bool(gap <= SCAN_TIE_REL * float(np.abs(lg).max())))


def sampler_step_ms(B: int, V: int, iters: int = 50) -> dict:
    """Wall ms a call of one batched step's token choice over [B, V] f32
    logits, synced after each call as generate_loop_batch syncs a step:
    sample_rows with every row greedy (what an all-greedy step ran before it
    took the argmax alone), sample_rows at temp 0.8 / top_k 40, and the
    full-row argmax."""
    from llm_tpu_torch.samplers.device import row_generators, sample_rows

    lg = torch.randn((B, V), device="cuda")
    gens = row_generators(range(B), "cuda")

    def params(temp, top_k):
        return (torch.full((B,), temp, device="cuda"), torch.full((B,), top_k, device="cuda"),
                torch.ones(B, device="cuda"), torch.zeros(B, device="cuda"))

    greedy, sampled = params(0.0, 0), params(0.8, 40)
    fns = dict(sample_rows_greedy=lambda: sample_rows(lg, *greedy, gens),
               sample_rows_sampled=lambda: sample_rows(lg, *sampled, gens),
               argmax=lambda: torch.argmax(lg, dim=-1))
    out = {}
    for name, fn in fns.items():
        for _ in range(3):
            int(fn()[0])
        t0 = time.perf_counter()
        for _ in range(iters):
            int(fn()[0])
        out[name] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def phase_server(ctx, tok, tmp: str) -> dict:
    """Phase 10: the port's ServerApp on 127.0.0.1 at a free port over
    phase 9's Context and tokenizer, SERVER_SLOTS slots, driven with
    urllib (module docstring). Fails on any failed request or check."""
    import os

    import numpy as np

    from llm_tpu_torch.ops import cuda_attn, cuda_qmm
    from llm_tpu_torch.server.app import ServerApp
    from llm_tpu_torch.server.core import InferenceServer

    eogs = tuple(i for i in (tok.vocab.eos_id, tok.vocab.eot_id) if i is not None and i >= 0)
    prompts = server_prompts(tok, 8)
    rec = {}

    def serve(**kw):
        ctx.clear()
        eng = InferenceServer(ctx, tok, n_slots=SERVER_SLOTS, n_batch=256, **kw)
        eng.start()
        server, _ = ServerApp(eng, model_name="llama3-8b-q4_k_m").serve_in_thread("127.0.0.1", 0)
        return eng, server

    def stop(eng, server):
        server.shutdown()
        server.server_close()
        eng.stop()

    eng, server = serve()
    port = server.server_address[1]
    try:
        for path in ("/health", "/props", "/v1/models"):
            rec[path] = http(port, "GET", path)["body"]
        if rec["/health"] != {"status": "ok"} or rec["/props"]["n_slots"] != SERVER_SLOTS:
            raise AssertionError(f"/health or /props: {rec['/health']} {rec['/props']}")
        toks = http(port, "POST", "/tokenize", {"content": prompts[0]})["body"]["tokens"]
        text = http(port, "POST", "/detokenize", {"tokens": toks})["body"]["content"]
        if toks != tok.encode(prompts[0], add_special=False, parse_special=True) \
                or text != tok.decode(toks):
            raise AssertionError("/tokenize or /detokenize differ from the tokenizer")

        # 2. four concurrent greedy streams through the batched fast path
        cuda_attn.reset_launches()
        cuda_qmm.reset_launches()
        ctx.batch_loop_shapes.clear()
        body = dict(n_predict=SERVER_DECODE, temperature=0, stream=True)
        greedy, wall = concurrently([
            (lambda p=p: http(port, "POST", "/completion", {**body, "prompt": p}, stream=True))
            for p in prompts[:4]])
        launches = dict(cuda_attn.LAUNCHES)
        by_t = dict(sorted(cuda_attn.DECODE_LAUNCHES_BY_T.items()))
        metrics = http(port, "GET", "/metrics")["body"]
        fast = int(next(ln.split()[1] for ln in metrics.splitlines()
                        if ln.startswith("llm_tpu_fast_chunks_total ")))
        n_tok = [len(r["events"]) - 1 for r in greedy]
        rec["greedy4"] = dict(
            ttft_s=[r["ttft_s"] for r in greedy], total_s=[r["total_s"] for r in greedy],
            tokens=n_tok, wall_s=wall, decode_tok_s=sum(n_tok) / wall,
            fast_chunks_total=fast, attn_launches=launches, k3_launches_by_t=by_t,
            batch_loop_shapes=sorted(ctx.batch_loop_shapes))
        log(json.dumps(dict(server_greedy4=rec["greedy4"])))
        # batch_loop_shapes holds the loops whose steps ran; K3 must have
        # run at T >= 2, rows of several sequences in one launch
        if fast <= 0 or not any(b >= 2 for b, _ in ctx.batch_loop_shapes) \
                or sum(c for t, c in by_t.items() if t >= 2) <= 0:
            raise AssertionError(f"the batched fast path did not run: fast_chunks_total {fast}, "
                                 f"shapes {ctx.batch_loop_shapes}, K3 by T {by_t}")
        with eng.ctx_lock:
            parts = []
            for p, r in zip(prompts[:4], greedy):
                got = "".join(e["choices"][0]["text"] for e in r["events"])
                ptoks, want = greedy_reference(ctx, tok, p, SERVER_DECODE, eogs)
                if got == "".join(tok.piece(t) for t in want):
                    parts.append(None)
                    continue
                part = parted_at_a_tie(ctx, tok, ptoks, want, got)
                parts.append(part)
                if not part["near_tie"]:
                    raise AssertionError(f"a greedy stream parts from its own decode + "
                                         f"generate_loop off a near tie: {part}")
        rec["greedy4"]["parted"] = parts
        log(json.dumps(dict(server_greedy4_vs_generate_loop=parts)))

        # 3. eight concurrent seeded sampled requests over 4 slots
        body = dict(n_predict=SERVER_DECODE, temperature=0.8, top_k=40, stream=True)
        sampled, wall = concurrently([
            (lambda i=i, p=p: http(port, "POST", "/completion",
                                   {**body, "prompt": p, "seed": 1000 + i}, stream=True))
            for i, p in enumerate(prompts)])
        n_tok = [len(r["events"]) - 1 for r in sampled]
        ends = [r["events"][-1]["choices"][0]["finish_reason"] for r in sampled]
        rec["sampled8"] = dict(ttft_s=[r["ttft_s"] for r in sampled],
                               total_s=[r["total_s"] for r in sampled], tokens=n_tok,
                               finish=ends, wall_s=wall, decode_tok_s=sum(n_tok) / wall)
        log(json.dumps(dict(server_sampled8=rec["sampled8"])))
        for n, e in zip(n_tok, ends):
            if not (e == "length" and n == SERVER_DECODE or e == "stop" and n <= SERVER_DECODE):
                raise AssertionError(f"a sampled request ended {e} after {n} tokens")

        # 4. a streamed chat completion against the unstreamed one at temp 0
        chat = dict(messages=[{"role": "user", "content": prompts[1][:200]}], max_tokens=32,
                    temperature=0)
        streamed = http(port, "POST", "/v1/chat/completions", {**chat, "stream": True},
                        stream=True)
        plain = http(port, "POST", "/v1/chat/completions", chat)["body"]
        joined = "".join(e["choices"][0]["delta"].get("content", "")
                         for e in streamed["events"])
        rec["chat"] = dict(ttft_s=streamed["ttft_s"], total_s=streamed["total_s"],
                           equal=joined == plain["choices"][0]["message"]["content"])
        if not rec["chat"]["equal"]:
            raise AssertionError("the streamed chat deltas differ from the unstreamed answer")

        # 5. a JSON schema the grammar forces whatever the weights are
        t0 = time.perf_counter()
        yn = http(port, "POST", "/v1/chat/completions", dict(
            messages=[{"role": "user", "content": "yes or no?"}], max_tokens=12,
            temperature=0, response_format={"type": "json_schema", "json_schema": {
                "schema": {"type": "string", "enum": ["yes", "no"]}}}))["body"]
        content = yn["choices"][0]["message"]["content"]
        rec["schema"] = dict(content=content, s=time.perf_counter() - t0)
        if json.loads(content) not in ("yes", "no"):
            raise AssertionError(f"the enum schema's answer {content!r}")

        # 7. a slot's cells saved and restored
        fn = os.path.join(tmp, "slot0.npz")
        saved = http(port, "POST", "/slots/0?action=save", {"filename": fn})["body"]
        restored = http(port, "POST", "/slots/0?action=restore", {"filename": fn})["body"]
        rec["slots"] = dict(saved=saved["n_tokens"], restored=restored["n_tokens"])
        if not saved["n_tokens"] == restored["n_tokens"] > 0:
            raise AssertionError(f"slot save / restore: {saved} {restored}")

        # 8. two embeddings
        emb = http(port, "POST", "/embeddings", {"input": prompts[2:4]})["body"]["data"]
        vecs = np.asarray([e["embedding"] for e in emb])
        rec["embeddings"] = dict(shape=list(vecs.shape), finite=bool(np.isfinite(vecs).all()))
        if vecs.shape != (2, ctx.cfg.n_embd) or not rec["embeddings"]["finite"]:
            raise AssertionError(f"embeddings {rec['embeddings']}")
        plain_text = http(port, "POST", "/completion", dict(
            prompt=prompts[5], n_predict=SERVER_DECODE, temperature=0))["body"]["content"]
    finally:
        stop(eng, server)

    # 6. a --lookup-ngram server's greedy text against the plain one
    eng, server = serve(lookup_ngram=True)
    try:
        r = http(server.server_address[1], "POST", "/completion", dict(
            prompt=prompts[5], n_predict=SERVER_DECODE, temperature=0))
        rec["ngram"] = dict(equal=r["body"]["content"] == plain_text, total_s=r["total_s"],
                            proposed=eng.metrics["draft_proposed_total"],
                            accepted=eng.metrics["draft_accepted_total"])
        if not rec["ngram"]["equal"]:
            with eng.ctx_lock:
                ptoks, want = greedy_reference(ctx, tok, prompts[5], SERVER_DECODE, eogs)
                part = parted_at_a_tie(ctx, tok, ptoks, want, r["body"]["content"])
            rec["ngram"]["parted"] = part
            if not part["near_tie"]:
                raise AssertionError(f"the lookup-ngram greedy text parts off a near tie: {part}")
        log(json.dumps(dict(server_ngram=rec["ngram"])))
    finally:
        stop(eng, server)
    ctx.clear()
    rec["sampler_step_ms"] = sampler_step_ms(SERVER_SLOTS, ctx.cfg.vocab_size)
    log(json.dumps(dict(server={k: v for k, v in rec.items() if k in (
        "chat", "schema", "slots", "embeddings", "ngram", "sampler_step_ms")})))
    return rec


def phase_gguf_cli() -> dict:
    """Phase 9: the text entry point on a GGUF typed as Q4_K_M, at
    LLAMA3_8B's widths and GGUF_LAYERS of its layers."""
    import os
    import resource
    import shutil
    from pathlib import Path

    import numpy as np

    from llm_tpu_torch.gguf.reader import GGUFReader
    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.samplers import SamplingParams
    from llm_tpu_torch.tokenizers import tokenizer_from_gguf
    from llm_tpu_torch.tools import cli, synth_gguf

    tmp = tempfile.mkdtemp(prefix="llama3_8b_gguf_")
    rec = {}
    try:
        path = os.path.join(tmp, "llama3_8b_q4_k_m.gguf")
        free = shutil.disk_usage(tmp).free
        t0 = time.perf_counter()
        info = synth_gguf.write_llama(path, n_layers=GGUF_LAYERS, seed=0)
        rec.update(gguf=info, write_s=time.perf_counter() - t0, disk_free_gib=free / 2**30)
        log(json.dumps(dict(gguf_written=rec)))
        t0 = time.perf_counter()
        reader = GGUFReader(path)
        tok = tokenizer_from_gguf(reader)
        prompt = gguf_prompt(tok)
        ptoks = tok.encode(prompt, add_special=True, parse_special=True)
        rec.update(tokenizer_s=time.perf_counter() - t0, prompt_tokens=len(ptoks))

        # the CLI as a user runs it, in a process of its own, started now so
        # that its load (the planes built in numpy on the host, minutes at
        # 8B) runs beside this process's own load below; this process uses
        # the card only once the CLI has exited
        cmd = [sys.executable, "-m", "llm_tpu_torch.tools.cli", "-m", path, "-p", prompt,
               "-n", str(GGUF_DECODE), "--temp", "0", "-c", "4096"]
        t_cli = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                cwd=str(Path(__file__).resolve().parent))
        try:
            # the CLI's glue in this process: cli.generate on the loaded
            # file against Context.decode of the prompt and generate_loop
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ctx = Context(reader, n_cells=4096)
            torch.cuda.synchronize()
            rec.update(load_s=time.perf_counter() - t0,
                       load_peak_device_gib=torch.cuda.max_memory_allocated() / 2**30)
            log(json.dumps(dict(gguf_loaded=dict(load_s=rec["load_s"],
                                                 peak_device_gib=rec["load_peak_device_gib"]))))
            out, err_text = proc.communicate(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        rec.update(cli_s=time.perf_counter() - t_cli, cli_rc=proc.returncode,
                   cli_peak_host_gib=resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
                   / 2**20)
        r = subprocess.CompletedProcess(cmd, proc.returncode, out, err_text)
        err = [line for line in r.stderr.splitlines() if line.strip()]
        rec.update(cli_stderr=err[-6:], cli_generated=r.stdout[len(prompt):])
        log(json.dumps(dict(gguf_cli=rec)))
        if r.returncode != 0:
            raise AssertionError(f"the CLI exited {r.returncode}: {r.stderr[-2000:]}")
        import re

        perf = re.fullmatch(r"load \d+ ms \| prefill (\d+) tok @ [\d.]+ t/s \| "
                            r"decode (\d+) tok @ [\d.]+ t/s", err[-1] if err else "")
        if not any(e.startswith("model loaded in ") for e in err) or perf is None:
            raise AssertionError(f"the CLI's stderr lacks its load or perf line: {err}")
        # the prompt is prefilled (and its last token decoded alone where the
        # generation ended on the scalar loop), then every generated token
        if not (r.stdout.startswith(prompt) and int(perf.group(1)) >= len(ptoks) - 1
                and int(perf.group(2)) > 0):
            raise AssertionError("the CLI printed no prompt, or prefilled or decoded nothing")

        from llm_tpu_torch.ops import cuda_attn, cuda_qmm

        cuda_qmm.reset_launches()
        cuda_attn.reset_launches()
        t0 = time.perf_counter()
        got, text = cli.generate(ctx, tok, ptoks, GGUF_DECODE, SamplingParams(temp=0.0))
        torch.cuda.synchronize()
        rec.update(generate_s=time.perf_counter() - t0, generate_launches=launch_counts(),
                   perf=ctx.perf.summary())
        ctx.clear()
        assert ctx.decode(Batch.text(ptoks)) == 0
        logits = ctx.get_logits()
        first = int(np.argmax(logits))
        eogs = tuple(i for i in (tok.vocab.eos_id, tok.vocab.eot_id) if i is not None and i >= 0)
        want = [first] + ctx.generate_loop(first, GGUF_DECODE - 1, eog_ids=eogs)
        rec.update(tokens_equal=got == want[:len(got)], n_generated=len(got),
                   text_equal_cli=r.stdout == prompt + text + "\n",
                   peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
                   peak_host_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
                   prefill_logits_finite=bool(np.isfinite(logits).all()))
        log(json.dumps(dict(gguf_generate={k: v for k, v in rec.items()
                                           if k not in ("cli_generated", "gguf")})))
        if not rec["prefill_logits_finite"]:
            raise AssertionError("non-finite logits from the 8B GGUF")
        # generate stops before an EOG token, which generate_loop returns
        full = len(got) == GGUF_DECODE or (len(want) > len(got) and want[len(got)] in eogs)
        if not (rec["tokens_equal"] and full):
            raise AssertionError(f"cli.generate {got} != decode + generate_loop {want}")
        if not rec["text_equal_cli"]:
            raise AssertionError("cli.generate's text is not what the CLI printed")
        for k in ("K1", "K2", "K3", "K4"):
            if rec["generate_launches"][k] <= 0:
                raise AssertionError(f"cli.generate launched no {k}")
        t0 = time.perf_counter()
        rec["server"] = phase_server(ctx, tok, tmp)
        log(f"phase 10 (the server on the 8B GGUF) passed in {time.perf_counter() - t0:.1f} s")
        del ctx
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


# phase 11: Gemma-2-9B at full depth. The ring holds 1 * (4096 + 512) =
# 4608 cells beside 8192 full ones; a prompt of exactly that many tokens
# fills it, so every decode step reuses a cell that slid out of the window
GEMMA2_CELLS = 8192
GEMMA2_PROMPT = 4608
GEMMA2_DECODE = 128
GEMMA2_Q8_PROMPT, GEMMA2_Q8_DECODE = 512, 32
# the state round trip saves the q8_0 ring Context's first prompt cells
# (its other cells removed, a metadata edit), held in both of its tables.
# Not the bf16 run's: after its 128 tokens the ring has pruned every cell
# at or before position 640, which no later token of the sequence can see
# (a pruned cell cannot be rewound, as in llama.cpp's ISWA cache), and its
# whole 4608-cell sequence would make a ~3 GB compressed file
GEMMA2_STATE_CELLS = 128
# (b)'s replay past the prompt on the ring and on swa_full: one step of
# this many tokens of the ring's stream, then single decode steps
GEMMA2_REPLAY_STEP, GEMMA2_REPLAY_DECODE = 64, 4


def gemma2_9b_planes():
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import make_synthetic_model

    t0 = time.perf_counter()
    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=11, recipe="Q4_K_M", arch="gemma2",
                                       **dict(GEMMA2_9B, n_layers=GEMMA2_PHASE11_LAYERS))
    torch.cuda.synchronize()
    from llm_tpu_torch.quant.qtensor import QTensor

    leaves = [v for layer in params["layers"] for v in layer.values()]
    leaves += [params["tok_embd"], params["output"]]
    nbytes = sum(qt_bytes(v) for v in leaves if isinstance(v, QTensor))
    log(json.dumps(dict(gemma2_9b_planes_s=time.perf_counter() - t0, planes_bytes=nbytes,
                        planes_gib=nbytes / 2**30)))
    return params, cfg


def state_round_trip(ctx, n_cells: int, tol_rel: float) -> dict:
    """The first n_cells cells of sequence 0 (its later cells removed from
    both tables) through state_seq_save / state_seq_load into a fresh
    Context of ctx's kind; one decode step on each, logits within tol_rel
    of max|logit|; the loaded cells' planes bit-equal to the saved ones."""
    import numpy as np

    from llm_tpu_torch.ops import cuda_build
    from llm_tpu_torch.runtime import state
    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context

    ctx.seq_rm(0, n_cells, -1)
    ring_cells = None if ctx.cells_swa is None else ctx.cells_swa.n_seq_cells(0)
    if ring_cells == 0:
        raise AssertionError("the ring holds none of the cells to save")
    BUILD = cuda_build.BUILD_DIR
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = f"{tmp}/seq0.npz"
        t0 = time.perf_counter()
        state.state_seq_save(ctx, 0, path)
        t_save = time.perf_counter() - t0
        fresh = Context(None, n_cells=ctx.n_cells, device="cuda",
                        params_cfg=(ctx.params, ctx.cfg), kv_dtype=ctx.kv_dtype,
                        swa_full=ctx.cells_swa is None)
        t0 = time.perf_counter()
        state.state_seq_load(fresh, 0, path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    for a_tab, b_tab, ks, kf in ((ctx.cells, fresh.cells, False, None),
                                 (ctx.cells_swa, fresh.cells_swa, True, None)):
        if a_tab is None:
            continue
        cells = np.flatnonzero(a_tab.seq_mask(0))
        cells = cells[np.argsort(a_tab.pos[cells], kind="stable")]
        slots = np.flatnonzero(b_tab.seq_mask(0))
        slots = slots[np.argsort(b_tab.pos[slots], kind="stable")]
        if not np.array_equal(b_tab.pos[slots], a_tab.pos[cells]):
            raise AssertionError("the loaded sequence's cells differ from the saved ones")
        ci = torch.as_tensor(cells, device="cuda")
        si = torch.as_tensor(slots, device="cuda")
        for il in range(ctx.cfg.n_layers):
            if (ctx.cells_swa is not None and ctx.cfg.layer_is_swa(il)) != ks:
                continue
            for a, b in ((ctx.kv.k[il], fresh.kv.k[il]), (ctx.kv.v[il], fresh.kv.v[il])):
                for x, y in zip(a if isinstance(a, tuple) else (a,),
                                b if isinstance(b, tuple) else (b,)):
                    if not torch.equal(x[:, ci], y[:, si]):
                        raise AssertionError("loaded planes are not bit-equal to the saved")
    tok = 7
    assert ctx.decode(Batch.one(tok, pos=n_cells)) == 0
    want = ctx.get_logits().copy()
    assert fresh.decode(Batch.one(tok, pos=n_cells)) == 0
    got = fresh.get_logits()
    err = float(np.abs(got - want).max())
    tol = tol_rel * float(np.abs(want).max())
    rec = dict(state_seq_cells=n_cells, state_ring_cells=ring_cells, state_save_s=t_save,
               state_load_s=t_load, planes_bit_equal=True, step_logits_max_abs_err=err,
               tol=tol)
    log(json.dumps(rec))
    if not (np.isfinite(got).all() and err <= tol):
        raise AssertionError(f"decode after state load: max|err| {err} > {tol}")
    del fresh
    return rec


def replay_past_prompt(ring, full, stream) -> dict:
    """Phase 11(b) past the prompt: the ring and swa_full Contexts empty
    their sequence (a ring cannot rewind past cells it pruned), then take
    the same tokens: the prompt and the first GEMMA2_REPLAY_STEP tokens of
    stream in n_ubatch steps (K4w_cap; the last step wraps the full ring),
    then GEMMA2_REPLAY_DECODE single decode steps (K3w_cap), each written
    to a ring cell that an earlier position held. Each step's logits agree
    within TWO_LAYER_REL_TOL of swa_full's max|logit|."""
    import numpy as np

    from llm_tpu_torch.runtime.batch import Batch

    for c in (ring, full):
        c.seq_rm(0)
    n = GEMMA2_REPLAY_STEP
    prompt = main_prompt(ring.cfg.vocab_size, GEMMA2_PROMPT)
    steps = [prompt + stream[:n]] + [[t] for t in stream[n:n + GEMMA2_REPLAY_DECODE]]
    diffs, tols = [], []
    for step in steps:
        for c in (ring, full):
            assert c.decode(Batch.text(step)) == 0
        lf = full.get_logits()
        diffs.append(float(np.abs(ring.get_logits() - lf).max()))
        tols.append(TWO_LAYER_REL_TOL * float(np.abs(lf).max()))
    last = GEMMA2_PROMPT + n + GEMMA2_REPLAY_DECODE - 1
    rec = dict(phase=11, replay_positions=[GEMMA2_PROMPT, last],
               replay_step_tokens=[len(t) for t in steps], ring_used=ring.cells_swa.n_used,
               ring_vs_swa_full_replay_max_abs_diff=diffs, tol=tols)
    log(json.dumps(rec))
    for i, (d, t) in enumerate(zip(diffs, tols)):
        if not d <= t:
            raise AssertionError(f"ring vs swa_full past the prompt, step {i}: "
                                 f"max|diff| {d} > {t}")
    return rec


def phase_gemma2_9b() -> dict:
    """Phase 11: Gemma-2-9B at full width and GEMMA2_PHASE11_LAYERS (12) of its
    42 layers (Q4_K_M-style random planes made on the card from seed 11,
    tied Q6_K lm_head).
    (a) the ISWA ring Context (8192 cells, ring 4608): prefill 4608 tokens
        in 512-token steps, then 128 greedy tokens, every decode step on a
        reused ring cell; launches by kernel (capped K3w_cap / K4w_cap a
        layer a step, no uncapped flash launch); profiled over 8 more
        tokens; the cache's bytes beside swa_full's;
    (b) swa_full on the same planes and prompt: the greedy streams equal or
        parted only at a near tie (compare_streams), the prompt's last
        logits within TWO_LAYER_REL_TOL of max|logit|; then both drop
        their cells past the prompt and take the same tokens of the ring's
        stream (replay_past_prompt), every step's logits within that
        tolerance, so the ring's reused cells are held whether or not the
        streams part;
    (c) the same planes with swa_window = 0: the prompt's last logits
        (position 4607, past the window) apart from (b)'s by more than that
        tolerance: the window is live at full width;
    (d) a q8_0 ring Context: prefill 512, 32 greedy tokens (K3qw_cap,
        K4qw_cap); then its first GEMMA2_STATE_CELLS prompt cells, in both
        tables, through a state file into a fresh q8_0 ring Context, one
        decode step against the uninterrupted one.
    Returns the capped kernels' launches of (a) and (d)."""
    import dataclasses

    import numpy as np

    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    params, cfg = gemma2_9b_planes()
    out = {}
    ring = Context(None, n_cells=GEMMA2_CELLS, device="cuda", params_cfg=(params, cfg))
    if ring.cells_swa is None or ring.cells_swa.n_cells != GEMMA2_PROMPT:
        raise AssertionError(f"the ring holds {ring.cells_swa and ring.cells_swa.n_cells} cells")
    ring_keep = {}
    counts, rec = run_llama3_8b(ring, ("K3w_cap", "K4w_cap"), ring_keep, GEMMA2_DECODE,
                                GEMMA2_PROMPT)
    out.update(K3w_cap=counts["K3w_cap"], K4w_cap=counts["K4w_cap"])
    prof = profile_tokens(ring, rec["last_token"], 8)
    log("profile_decode " + json.dumps(prof))
    check_gemv_profile(prof, memsets=1)  # the greedy argmax's over 256000 logits
    check_attn_profile(prof, cfg.n_layers)
    full = Context(None, n_cells=GEMMA2_CELLS, device="cuda", params_cfg=(params, cfg),
                   swa_full=True)
    full_bytes = kv_bytes(full)
    log(json.dumps(dict(phase=11, path="ISWA ring", ring_cells=ring.cells_swa.n_cells,
                        ring_used_after=ring.cells_swa.n_used, kv_bytes=rec["kv_bytes"],
                        swa_full_kv_bytes=full_bytes,
                        kv_saved_gib=(full_bytes - rec["kv_bytes"]) / 2**30,
                        ms_per_token=1e3 / rec["decode_tok_s"],
                        prefill_tok_s=rec["prefill_tok_s"], peak_mem_gib=rec["peak_mem_gib"],
                        device_busy_ms_per_token=prof["device_busy_ms_per_token"],
                        idle_share=prof["idle_share"],
                        device_launches_per_token=prof["device_launches_per_token"],
                        decode_bound_tok_s=rec["decode_bound_tok_s"])))
    if not full_bytes > rec["kv_bytes"]:
        raise AssertionError("the ring saves no cache bytes")

    # (b) swa_full: the same stream, or parted at a near tie
    full_keep = {}
    _, full_rec = run_llama3_8b(full, ("K3w_cap", "K4w_cap"), full_keep, GEMMA2_DECODE,
                                GEMMA2_PROMPT)
    lr, lf = ring_keep["logits"], full_keep["logits"]
    err = float(np.abs(lr - lf).max())
    tol = TWO_LAYER_REL_TOL * float(np.abs(lf).max())
    streams = compare_streams(ring, ring_keep, full, full_keep, GEMMA2_PROMPT)
    log(json.dumps(dict(phase=11, ring_vs_swa_full_prefill_max_abs_diff=err, tol=tol,
                        swa_full_ms_per_token=1e3 / full_rec["decode_tok_s"], **streams)))
    if not err <= tol:
        raise AssertionError(f"ring vs swa_full prompt logits: max|diff| {err} > {tol}")
    replay_past_prompt(ring, full, [ring_keep["first"]] + ring_keep["tokens"])
    del full
    torch.cuda.empty_cache()

    # (c) no window: position 4607 then sees cells the window hides
    flat = Context(None, n_cells=GEMMA2_CELLS, device="cuda",
                   params_cfg=(params, dataclasses.replace(cfg, swa_window=0)))
    prompt = main_prompt(cfg.vocab_size, GEMMA2_PROMPT)
    assert flat.decode(Batch.text(prompt)) == 0
    diff = float(np.abs(flat.get_logits() - lf).max())
    log(json.dumps(dict(phase=11, no_window_vs_window_prompt_max_abs_diff=diff, tol=tol,
                        position=GEMMA2_PROMPT - 1)))
    if not diff > tol:
        raise AssertionError(f"swa_window=0 moves the logits past the window by only {diff}")
    del flat
    torch.cuda.empty_cache()

    del ring
    torch.cuda.empty_cache()

    # (d) the q8_0 ring: K3qw_cap / K4qw_cap
    q8 = Context(None, n_cells=GEMMA2_CELLS, device="cuda", params_cfg=(params, cfg),
                 kv_dtype="q8_0")
    counts_q8, rec_q8 = run_llama3_8b(q8, ("K3qw_cap", "K4qw_cap"), None, GEMMA2_Q8_DECODE,
                                      GEMMA2_Q8_PROMPT)
    out.update(K3qw_cap=counts_q8["K3qw_cap"], K4qw_cap=counts_q8["K4qw_cap"])
    log(json.dumps(dict(phase=11, path="ISWA ring q8_0", kv_bytes=rec_q8["kv_bytes"],
                        ms_per_token=1e3 / rec_q8["decode_tok_s"],
                        peak_mem_gib=rec_q8["peak_mem_gib"])))
    # its first prompt cells through a state file into a fresh q8_0 ring
    out["state"] = state_round_trip(q8, GEMMA2_STATE_CELLS, TWO_LAYER_Q8_REL_TOL)
    del q8, params
    torch.cuda.empty_cache()
    return out


# phase 12: Baichuan-13B at full width and BAICHUAN_PHASE12_LAYERS of its
# 40 layers (cut to 20 to pay for phase 17 within the time limit; the 13B
# profile, keyed on 40 layers, is given to the cut config) on 4096 cells:
# a 512-token prefill and 128 greedy tokens with the bf16 cache, 512 + 32
# with the q8_0 one
BAICHUAN_PHASE12_LAYERS = 20
BAICHUAN_CELLS = 4096
BAICHUAN_PROMPT, BAICHUAN_DECODE = 512, 128
BAICHUAN_Q8_PROMPT, BAICHUAN_Q8_DECODE = 512, 32


def baichuan_13b_planes():
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.config import alibi_profile
    from llm_tpu_torch.models.synthetic import make_synthetic_model
    from llm_tpu_torch.quant.qtensor import QTensor

    t0 = time.perf_counter()
    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=13, recipe="Q4_K_M", arch="baichuan",
                                       **dict(BAICHUAN_13B, n_layers=BAICHUAN_PHASE12_LAYERS))
    cfg = alibi_profile(cfg)  # the 13B profile at cut depth
    torch.cuda.synchronize()
    leaves = [v for layer in params["layers"] for v in layer.values()]
    leaves += [params["tok_embd"], params["output"]]
    types = {}
    for v in leaves:
        if isinstance(v, QTensor):
            types[v.ggml_type.name] = types.get(v.ggml_type.name, 0) + 1
    nbytes = sum(qt_bytes(v) for v in leaves if isinstance(v, QTensor))
    log(json.dumps(dict(baichuan_13b_planes_s=time.perf_counter() - t0, planes_bytes=nbytes,
                        planes_gib=nbytes / 2**30, plane_types=types)))
    downs = [layer["ffn_down"].ggml_type.name for layer in params["layers"]]
    if downs != ["Q8_0"] * cfg.n_layers:
        raise AssertionError(f"ffn_down at K = 13696 must fall back to Q8_0: {downs}")
    return params, cfg


def phase_baichuan_13b() -> dict:
    """Phase 12: Baichuan-13B at full width and BAICHUAN_PHASE12_LAYERS of
    its 40 layers (Q4_K_M-
    style random planes made on the card from seed 13: Q8_0 ffn_down at K =
    13696, Q6_K attn_v in the use_more_bits layers and the lm_head), its 13B
    profile: rope NONE and ALiBi of max_bias 8.
    (a) the bf16 cache (4096 cells): prefill 512 tokens, then 128 greedy
        tokens; launches by kernel (K3_alibi / K4_alibi a layer a step, no
        other flash launch); profiled over 8 more tokens; the cache's
        bytes (2 x layers x 40 heads x 4096 cells x 128 x 2 B);
    (b) the same planes with alibi_max_bias = 0: the prompt's last logits
        apart from (a)'s by more than the two-layer tolerance (ALiBi is
        live at full depth);
    (c) the q8_0 cache: prefill 512, 32 greedy tokens (K3q_alibi,
        K4q_alibi).
    Returns the ALiBi kernels' launches of (a) and (c)."""
    import dataclasses

    import numpy as np

    from llm_tpu_torch.ops.rope import ROPE_TYPE_NONE
    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    params, cfg = baichuan_13b_planes()
    if not (cfg.alibi_max_bias == ALIBI_MAX_BIAS and cfg.rope.mode == ROPE_TYPE_NONE):
        raise AssertionError(f"not the 13B profile: {cfg}")
    out = {}
    ctx = Context(None, n_cells=BAICHUAN_CELLS, device="cuda", params_cfg=(params, cfg))
    keep = {}
    counts, rec = run_llama3_8b(ctx, ("K3_alibi", "K4_alibi"), keep, BAICHUAN_DECODE,
                                BAICHUAN_PROMPT)
    out.update(K3_alibi=counts["K3_alibi"], K4_alibi=counts["K4_alibi"])
    prof = profile_tokens(ctx, rec["last_token"], 8)
    log("profile_decode " + json.dumps(prof))
    check_gemv_profile(prof)
    check_attn_profile(prof, cfg.n_layers)
    want_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * BAICHUAN_CELLS * cfg.head_dim * 2
    log(json.dumps(dict(phase=12, path="Baichuan-13B bf16 cache", kv_bytes=rec["kv_bytes"],
                        ms_per_token=1e3 / rec["decode_tok_s"],
                        prefill_tok_s=rec["prefill_tok_s"], peak_mem_gib=rec["peak_mem_gib"],
                        device_busy_ms_per_token=prof["device_busy_ms_per_token"],
                        idle_share=prof["idle_share"],
                        device_launches_per_token=prof["device_launches_per_token"],
                        decode_bound_tok_s=rec["decode_bound_tok_s"],
                        distinct_tokens=len(set(keep["tokens"])))))
    if rec["kv_bytes"] != want_bytes:
        raise AssertionError(f"the cache holds {rec['kv_bytes']} bytes, not {want_bytes}")
    del ctx
    torch.cuda.empty_cache()

    # (b) ALiBi off: the same planes without the term
    flat = Context(None, n_cells=BAICHUAN_CELLS, device="cuda",
                   params_cfg=(params, dataclasses.replace(cfg, alibi_max_bias=0.0)))
    assert flat.decode(Batch.text(main_prompt(cfg.vocab_size, BAICHUAN_PROMPT))) == 0
    lf = keep["logits"]
    diff = float(np.abs(flat.get_logits() - lf).max())
    tol = TWO_LAYER_REL_TOL * float(np.abs(lf).max())
    log(json.dumps(dict(phase=12, no_alibi_vs_alibi_prompt_max_abs_diff=diff, tol=tol)))
    if not diff > tol:
        raise AssertionError(f"alibi_max_bias=0 moves the prompt's logits by only {diff}")
    del flat
    torch.cuda.empty_cache()

    # (c) the q8_0 cache: K3q_alibi / K4q_alibi
    q8 = Context(None, n_cells=BAICHUAN_CELLS, device="cuda", params_cfg=(params, cfg),
                 kv_dtype="q8_0")
    counts_q8, rec_q8 = run_llama3_8b(q8, ("K3q_alibi", "K4q_alibi"), None, BAICHUAN_Q8_DECODE,
                                      BAICHUAN_Q8_PROMPT)
    out.update(K3q_alibi=counts_q8["K3q_alibi"], K4q_alibi=counts_q8["K4q_alibi"])
    log(json.dumps(dict(phase=12, path="Baichuan-13B q8_0 cache", kv_bytes=rec_q8["kv_bytes"],
                        ms_per_token=1e3 / rec_q8["decode_tok_s"],
                        prefill_tok_s=rec_q8["prefill_tok_s"],
                        peak_mem_gib=rec_q8["peak_mem_gib"])))
    del q8, params
    torch.cuda.empty_cache()
    return out


# phase 13: Qwen3-30B-A3B at full width and 12 of its 48 layers (cut to
# 24, then to 12, for chip_smoke.py's time limit) on 4096
# cells: a 512-token prefill and 128 greedy tokens with the bf16 cache (8
# more profiled), 16 with chain=True, 32 with the q8_0 cache
QWEN3_LAYERS = 12
QWEN3_CELLS = 4096
QWEN3_PROMPT, QWEN3_DECODE = 512, 128
QWEN3_CHAIN_DECODE, QWEN3_Q8_DECODE = 16, 32
# the profiler ranges phase 13 wraps around the MoE FFN and, inside it, the
# experts' gather and dequantization
MOE_RANGES = ("moe_ffn", "gather_experts")


def planes_summary(params, cfg, tag: str) -> dict:
    """The plane types, the bytes of the K-major planes, of the expert
    stacks and of the dense routers, logged."""
    from llm_tpu_torch.quant.qtensor import QTensor

    leaves = [(k, v) for layer in params["layers"] for k, v in layer.items()]
    leaves += [("tok_embd", params["tok_embd"]), ("output", params["output"])]
    types, nbytes, expert_bytes, dense_bytes = {}, 0, 0, 0
    for k, v in leaves:
        if isinstance(v, QTensor):
            types[v.ggml_type.name] = types.get(v.ggml_type.name, 0) + 1
            nbytes += qt_bytes(v)
            expert_bytes += qt_bytes(v) if k.endswith("_exps") else 0
        elif v.dim() >= 2:
            dense_bytes += v.numel() * v.element_size()
    rec = {f"{tag}_planes_bytes": nbytes, "planes_gib": nbytes / 2**30,
           "expert_planes_bytes": expert_bytes, "dense_bytes": dense_bytes,
           "plane_types": types, "n_layers": cfg.n_layers}
    log(json.dumps(rec))
    return rec


def qwen3_30b_a3b_planes():
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import QWEN3_30B_A3B, make_synthetic_model, use_more_bits

    t0 = time.perf_counter()
    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=15, recipe="Q4_K_M", arch="qwen3moe",
                                       **dict(QWEN3_30B_A3B, n_layers=QWEN3_LAYERS))
    torch.cuda.synchronize()
    log(json.dumps(dict(qwen3_30b_a3b_planes_s=time.perf_counter() - t0)))
    planes_summary(params, cfg, "qwen3_30b_a3b")
    downs = [layer["ffn_down_exps"].ggml_type.name for layer in params["layers"]]
    want = ["Q6_K" if use_more_bits(il, cfg.n_layers) else "Q4_K"
            for il in range(cfg.n_layers)]
    if downs != want or params["layers"][0]["ffn_up_exps"].qs.shape[0] != cfg.n_expert:
        raise AssertionError(f"Qwen3-30B-A3B's expert stacks: downs {downs}")
    return params, cfg


def traced(module, names):
    """Wrap module's functions `names` in torch.profiler ranges of their
    names (profile_tokens' ranges); returns a function that unwraps them."""
    real = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def run(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return run

    for n, fn in real.items():
        setattr(module, n, wrap(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in real.items()]


def parted_at_near_tie(ctx, keep, other, n_prompt: int, rel_tol: float) -> dict:
    """ctx's greedy stream (keep: its first token and tokens) against another
    run's on the same planes (other: the same keys, at most as many tokens):
    equal, or parted at a step whose top two logits on ctx, replayed over
    the prompt and the common stream, lie within rel_tol of max|logit|."""
    import numpy as np

    from llm_tpu_torch.runtime.batch import Batch

    a = [keep["first"]] + keep["tokens"]
    b = [other["first"]] + other["tokens"]
    a = a[:len(b)]
    rec = dict(streams_equal=a == b, compared_tokens=len(b))
    if a != b:
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx.seq_rm(0)
        assert ctx.decode(Batch.text(main_prompt(ctx.cfg.vocab_size, n_prompt) + a[:i])) == 0
        lg = ctx.get_logits()
        gap, top = top2_gap(lg), float(np.abs(lg).max())
        rec.update(parted_at_step=i, step_top2_gap=gap, step_max_abs_logit=top,
                   tol=rel_tol * top)
        if not gap <= rel_tol * top:
            log(json.dumps(rec))
            raise AssertionError(f"the greedy streams part at step {i} on a top-2 gap of {gap}")
    log(json.dumps(rec))
    return rec


# the decode steps on which steps_against holds one Context's logits
# against another's on the same planes (distinct tokens, where the greedy
# streams of random planes may repeat one token)
CHAIN_STEPS = 4


def steps_against(other, ctx, n_prompt: int, rel_tol: float = TWO_LAYER_CHAIN_REL_TOL
                  ) -> dict:
    """Both Contexts (other: chained or gdot; ctx: unfused) emptied, the
    n_prompt-token prompt prefilled again on each, then CHAIN_STEPS
    single-token decode steps of distinct tokens on each. A MoE's other
    Context follows ctx's experts over the prompt and the steps, the same
    inputs on both (RouteTwin; its gate also refuses planted faults).
    Every step's logits within rel_tol of max|logit| (by default
    TWO_LAYER_CHAIN_REL_TOL, the chained twin's tolerance: K6 and K1/K2
    round their bf16 boundaries apart as the card and the CPU do)."""
    import numpy as np

    from llm_tpu_torch.runtime.batch import Batch

    prompt = main_prompt(ctx.cfg.vocab_size, n_prompt)
    toks = [(i * 7919 + 13) % ctx.cfg.vocab_size for i in range(1, CHAIN_STEPS + 1)]
    lg = {}
    with RouteTwin() as route:
        for name, c in (("ctx", ctx), ("other", other)):
            if name == "ctx":
                route.mode = "record"
            else:
                route.follow()
            c.seq_rm(0)
            assert c.decode(Batch.text(prompt)) == 0
            steps = []
            for t in toks:
                assert c.decode(Batch.text([t])) == 0
                steps.append(c.get_logits().copy())
            lg[name] = np.stack(steps)
        route.mode = None
    route.followed_all("the other Context's steps")
    if ctx.cfg.n_expert:
        route.planted_fault()
    err = float(np.abs(lg["other"] - lg["ctx"]).max())
    top = float(np.abs(lg["ctx"]).max())
    rec = dict(steps_max_abs_err=err, tol=rel_tol * top, rel_err=err / top,
               top1_equal=[int(a.argmax()) == int(b.argmax())
                           for a, b in zip(lg["other"], lg["ctx"])], **route.record())
    log(json.dumps(rec))
    if not (np.isfinite(lg["other"]).all() and err <= rel_tol * top):
        raise AssertionError(f"decode steps against the unfused Context: max|err| {err} > "
                             f"{rel_tol * top}")
    return rec


def phase_qwen3_30b_a3b() -> dict:
    """Phase 13: Qwen3-30B-A3B at full width and QWEN3_LAYERS (12) of its 48
    layers (Q4_K_M-style random planes made on the card from seed 15: rows-layout expert
    stacks, Q6_K ffn_down_exps and attn_v in the use_more_bits layers, a
    bf16 router, an untied Q6_K lm_head; qk-norm; 128 experts, 8 a token).
    (a) the bf16 cache (4096 cells): prefill 512 tokens (the grouped
        dispatch), then 128 greedy tokens (the gather); launches by kernel
        (K3 / K4 a layer a step at G = 8, the experts none); profiled over 8
        more tokens, with the MoE FFN's and its gather-dequant's device ms
        and launches a token (MOE_RANGES); the cache's bytes (2 x 24 layers
        x 4 heads x 4096 cells x 128 x 2 B) and the peak memory;
    (b) chain=True on the same planes, 16 tokens: K6 for each fused head
        (qk-norm after it) and the lm_head, every MoE tail unchained; the
        stream equal to (a)'s or parted only at a near tie; then
        steps_against (a)'s Context, which holds the chained logits
        to the unchained ones on the same experts (RouteTwin, outside the
        timed windows, which run no hook);
    (c) the q8_0 cache: prefill 512, 32 greedy tokens (K3q, K4q).
    Returns the records."""
    from llm_tpu_torch.models import transformer
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    params, cfg = qwen3_30b_a3b_planes()
    if not (cfg.qk_norm and cfg.n_expert == 128 and cfg.n_expert_used == 8
            and cfg.n_heads // cfg.n_kv_heads == 8):
        raise AssertionError(f"not Qwen3-30B-A3B's profile: {cfg}")
    out = {}
    ctx = Context(None, n_cells=QWEN3_CELLS, device="cuda", params_cfg=(params, cfg))
    keep = {}
    counts, rec = run_llama3_8b(ctx, ("K3", "K4"), keep, QWEN3_DECODE, QWEN3_PROMPT)
    untrace = traced(transformer, MOE_RANGES)
    try:
        prof = profile_tokens(ctx, rec["last_token"], 8, ranges=MOE_RANGES)
    finally:
        untrace()
    log("profile_decode " + json.dumps(prof))
    check_attn_profile(prof, cfg.n_layers)
    if prof["qmm_gemv_launches_per_token"] != 0:
        raise AssertionError("a qmm_gemv kernel ran in decode")
    busy = prof["device_busy_ms_per_token"]
    want_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * QWEN3_CELLS * cfg.head_dim * 2
    out["a"] = dict(phase=13, path="Qwen3-30B-A3B bf16 cache", kv_bytes=rec["kv_bytes"],
                    ms_per_token=1e3 / rec["decode_tok_s"],
                    prefill_tok_s=rec["prefill_tok_s"], peak_mem_gib=rec["peak_mem_gib"],
                    device_busy_ms_per_token=busy, idle_share=prof["idle_share"],
                    device_launches_per_token=prof["device_launches_per_token"],
                    moe_ffn_share_of_device=prof["moe_ffn_ms_per_token"] / busy,
                    gather_dequant_share_of_device=prof["gather_experts_ms_per_token"] / busy,
                    moe_ffn_launches_per_token=prof["moe_ffn_launches_per_token"],
                    gather_dequant_launches_per_token=prof["gather_experts_launches_per_token"],
                    K3_per_token=rec["launches_per_token"]["K3"],
                    K4_in_prefill=counts["K4"], decode_bound_tok_s=rec["decode_bound_tok_s"],
                    distinct_tokens=len(set(keep["tokens"])))
    log(json.dumps(out["a"]))
    if rec["kv_bytes"] != want_bytes:
        raise AssertionError(f"the cache holds {rec['kv_bytes']} bytes, not {want_bytes}")
    if not (0 < prof["gather_experts_ms_per_token"] <= prof["moe_ffn_ms_per_token"] < busy):
        raise AssertionError(f"the MoE ranges' device time does not nest: {prof}")

    # (b) chain=True: K6 heads, unchained MoE tails, the same stream
    chained = Context(None, n_cells=QWEN3_CELLS, device="cuda", params_cfg=(params, cfg),
                      chain=True)
    keep_c = {}
    counts_c, rec_c = run_llama3_8b(chained, ("K3", "K4"), keep_c, QWEN3_CHAIN_DECODE,
                                    QWEN3_PROMPT)
    out["b"] = dict(phase=13, path="Qwen3-30B-A3B chain", K6_per_token=rec_c[
        "launches_per_token"]["K6"], ms_per_token=1e3 / rec_c["decode_tok_s"],
        **parted_at_near_tie(ctx, keep, keep_c, QWEN3_PROMPT, TWO_LAYER_CHAIN_REL_TOL),
        steps=steps_against(chained, ctx, QWEN3_PROMPT))
    del chained
    torch.cuda.empty_cache()
    log(json.dumps(out["b"]))
    if not counts_c["K6"] > 0 or counts_c["K6_gelu"]:
        raise AssertionError(f"the chained run's K6 launches: {counts_c}")
    del ctx
    torch.cuda.empty_cache()

    # (c) the q8_0 cache: K3q / K4q
    q8 = Context(None, n_cells=QWEN3_CELLS, device="cuda", params_cfg=(params, cfg),
                 kv_dtype="q8_0")
    counts_q8, rec_q8 = run_llama3_8b(q8, ("K3q", "K4q"), None, QWEN3_Q8_DECODE, QWEN3_PROMPT)
    out["c"] = dict(phase=13, path="Qwen3-30B-A3B q8_0 cache", kv_bytes=rec_q8["kv_bytes"],
                    ms_per_token=1e3 / rec_q8["decode_tok_s"],
                    prefill_tok_s=rec_q8["prefill_tok_s"], peak_mem_gib=rec_q8["peak_mem_gib"])
    log(json.dumps(out["c"]))
    del q8, params
    torch.cuda.empty_cache()
    return out


# phase 14: Gemma-7B at full width with chain=True (GEMMA7B_LAYERS of its
# 28 layers; cut to 14 to pay for phase 17 within the time limit) on 4096
# cells: a 512-token prefill and 128 greedy tokens, against the unchained
# Context on the same planes
GEMMA7B_LAYERS = 14
GEMMA7B_CELLS = 4096
GEMMA7B_PROMPT, GEMMA7B_DECODE = 512, 128


def phase_gemma_7b() -> dict:
    """Phase 14: Gemma-7B (gemma v1: gelu, the embedding scaled by
    sqrt(3072), 16 heads of 256, a tied Q6_K table of 256000 rows) at full
    width, Q4_K_M-style random planes made on the card from seed 16, with
    chain=True: prefill 512, 128 greedy tokens; a GeGLU tail (K6_gelu) on
    every layer a token, K6 on each fused head and the lm_head, K3w/K4w for
    attention; profiled over 8 more tokens; then the unchained Context's
    128 tokens on the same planes, the streams equal or parted only at a
    near tie (random planes with a tied, scaled table repeat one token),
    and steps_against it on distinct tokens. Returns K6_gelu's
    launches and the records."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import GEMMA_7B, make_synthetic_model
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    t0 = time.perf_counter()
    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=16, recipe="Q4_K_M", arch="gemma",
                                       **dict(GEMMA_7B, n_layers=GEMMA7B_LAYERS))
    torch.cuda.synchronize()
    log(json.dumps(dict(gemma_7b_planes_s=time.perf_counter() - t0)))
    planes_summary(params, cfg, "gemma_7b")
    if not (cfg.arch == "gemma" and cfg.act == "gelu" and cfg.head_dim == 256):
        raise AssertionError(f"not Gemma-7B's profile: {cfg}")
    out = {}
    chained = Context(None, n_cells=GEMMA7B_CELLS, device="cuda", params_cfg=(params, cfg),
                      chain=True)
    keep_c = {}
    counts_c, rec_c = run_llama3_8b(chained, ("K3w", "K4w"), keep_c, GEMMA7B_DECODE,
                                    GEMMA7B_PROMPT)
    prof = profile_tokens(chained, rec_c["last_token"], 8)
    log("profile_decode " + json.dumps(prof))
    check_gemv_profile(prof, memsets=1)  # the greedy argmax's over 256000 logits
    check_attn_profile(prof, cfg.n_layers)
    if rec_c["launches_per_token"]["K6_gelu"] != cfg.n_layers:
        raise AssertionError(f"K6_gelu a token: {rec_c['launches_per_token']}")
    ctx = Context(None, n_cells=GEMMA7B_CELLS, device="cuda", params_cfg=(params, cfg))
    keep = {}
    _, rec = run_llama3_8b(ctx, ("K3w", "K4w"), keep, GEMMA7B_DECODE, GEMMA7B_PROMPT)
    out["chain"] = dict(phase=14, path="Gemma-7B chain", ms_per_token=1e3 / rec_c[
        "decode_tok_s"], unchained_ms_per_token=1e3 / rec["decode_tok_s"],
        prefill_tok_s=rec_c["prefill_tok_s"], peak_mem_gib=rec_c["peak_mem_gib"],
        device_busy_ms_per_token=prof["device_busy_ms_per_token"],
        idle_share=prof["idle_share"], k6_ms_per_token=prof["k6_ms_per_token"],
        device_launches_per_token=prof["device_launches_per_token"],
        K6_gelu_per_token=rec_c["launches_per_token"]["K6_gelu"],
        K6_per_token=rec_c["launches_per_token"]["K6"],
        distinct_tokens=len(set(keep_c["tokens"])),
        **parted_at_near_tie(ctx, keep, keep_c, GEMMA7B_PROMPT, TWO_LAYER_CHAIN_REL_TOL),
        steps=steps_against(chained, ctx, GEMMA7B_PROMPT))
    log(json.dumps(out["chain"]))
    del chained, ctx, params
    torch.cuda.empty_cache()
    out["K6_gelu"] = counts_c["K6_gelu"]
    return out


# phase 17: GLM-4-9B-0414 at full width and GLM4_LAYERS of its 40 layers
# (cut to 20 to pay for phase 18 within the time limit) on 4096 cells: a
# 512-token prefill and 128 greedy tokens with the bf16 cache, unfused and
# with gdot, then 512 + 32 with the q8_0 cache
GLM4_LAYERS = 20
GLM4_CELLS = 4096
GLM4_PROMPT, GLM4_DECODE = 512, 128
GLM4_Q8_DECODE = 32


def glm4_9b_planes():
    """GLM-4-9B's Q4_K_M-style random planes made on the card from seed 17
    at GLM4_LAYERS layers:
    Q4_K everywhere but a Q6_K attn_v (the use_more_bits layers, whose QKV
    then stays unfused) and lm_head, ffn_down Q8_0 (K = 13696, no multiple
    of 256), gate+up packed in one [27392, 4096] matrix, f32 QKV biases and
    post-norms. Returns (params, cfg, planes_summary's record)."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import GLM4_9B, make_synthetic_model, use_more_bits
    from llm_tpu_torch.ops.rope import ROPE_TYPE_NORM

    t0 = time.perf_counter()
    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=17, recipe="Q4_K_M", arch="glm4",
                                       **dict(GLM4_9B, n_layers=GLM4_LAYERS))
    torch.cuda.synchronize()
    log(json.dumps(dict(glm4_9b_planes_s=time.perf_counter() - t0)))
    planes = planes_summary(params, cfg, "glm4_9b")
    if (cfg.arch, cfg.rope.mode, cfg.rope.n_dims, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) \
            != ("glm4", ROPE_TYPE_NORM, 64, 128, 16):
        raise AssertionError(f"not GLM-4-9B's profile: {cfg}")
    for il, layer in enumerate(params["layers"]):
        more = use_more_bits(il, cfg.n_layers)
        if layer["ffn_down"].ggml_type != GGMLType.Q8_0 \
                or layer["ffn_gateup_fused"].out_features != 2 * cfg.n_ff \
                or ("attn_qkv_fused" in layer) == more \
                or (more and layer["attn_v"].ggml_type != GGMLType.Q6_K) \
                or not {"attn_q_b", "attn_k_b", "attn_v_b", "attn_post_norm",
                        "ffn_post_norm"} <= set(layer):
            raise AssertionError(f"layer {il} is not the Q4_K_M recipe's GLM-4 layer")
    return params, cfg, planes


def run_full_model_phase(phase: int, model: str, params, cfg, planes_bytes: int, card: str,
                         cells: int, prompt: int, decode: int, gdot_decode: int,
                         q8_decode: int, chain: bool = False) -> dict:
    """One dense model's planes at full width through the main path:
    (a) the bf16 cache (`cells` cells): prefill `prompt` tokens, then
        `decode` greedy tokens, launches by kernel (K1 and K2 on every
        matmul, K3 / K4 a layer a step), profiled over 8 more tokens;
    (b) gdot (K5 on every p4 matmul at decode) for `gdot_decode` tokens,
        the stream equal to (a)'s or parted only at a near tie, and
        steps_against (a)'s Context on distinct tokens within SCAN_REL_TOL
        (random planes with a tied table repeat one greedy token, which a
        fault that leaves that token on top would not move);
    (c) with `chain`: chain=True, whose gate refuses LayerNorm and the
        parallel block, so CHAIN_STEPS decode steps give the unchained
        logits bit for bit and launch no K6;
    (d) the q8_0 cache: prefill `prompt`, `q8_decode` greedy tokens (K3q,
        K4q).
    Each record is logged beside the card's name and power limit. Returns
    the records, and each run's launches under "counts"."""
    from llm_tpu_torch.ops import cuda_qmm_chain
    from llm_tpu_torch.runtime.engine import Context
    from llm_tpu_torch.tools.profile_decode import profile_tokens

    out = {}
    ctx = Context(None, n_cells=cells, device="cuda", params_cfg=(params, cfg))
    keep = {}
    counts, rec = run_llama3_8b(ctx, ("K3", "K4"), keep, decode, prompt)
    prof = profile_tokens(ctx, rec["last_token"], 8)
    log("profile_decode " + json.dumps(prof))
    check_gemv_profile(prof, memsets=1)  # the greedy argmax's over the vocabulary
    check_attn_profile(prof, cfg.n_layers)
    out["bf16"] = dict(
        phase=phase, path=f"{model} bf16 cache", n_layers=cfg.n_layers,
        ms_per_token=1e3 / rec["decode_tok_s"], decode_tok_s=rec["decode_tok_s"],
        prefill_tok_s=rec["prefill_tok_s"], prefill_ms_per_token=1e3 / rec["prefill_tok_s"],
        decode_bound_tok_s=rec["decode_bound_tok_s"],
        decode_bytes_per_token=decode_bytes_per_token(ctx),
        planes_bytes=planes_bytes, kv_bytes=rec["kv_bytes"], peak_mem_gib=rec["peak_mem_gib"],
        device_busy_ms_per_token=prof["device_busy_ms_per_token"],
        idle_share=prof["idle_share"], gemv_ms_per_token=prof.get("gemv_ms_per_token"),
        device_launches_per_token=prof["device_launches_per_token"],
        launches_per_token={k: v for k, v in rec["launches_per_token"].items() if v},
        distinct_tokens=len(set(keep["tokens"])), card=card)
    log(json.dumps(out["bf16"]))

    gdot = Context(None, n_cells=cells, device="cuda", params_cfg=(params, cfg), gdot=True)
    keep_g = {}
    counts_g, rec_g = run_llama3_8b(gdot, ("K3", "K4"), keep_g, gdot_decode, prompt)
    out["gdot"] = dict(phase=phase, path=f"{model} gdot", ms_per_token=1e3 / rec_g[
        "decode_tok_s"], prefill_tok_s=rec_g["prefill_tok_s"],
        launches_per_token={k: v for k, v in rec_g["launches_per_token"].items() if v},
        **parted_at_near_tie(ctx, keep, keep_g, prompt, SCAN_REL_TOL),
        steps=steps_against(gdot, ctx, prompt, SCAN_REL_TOL), card=card)
    log(json.dumps(out["gdot"]))
    del gdot
    torch.cuda.empty_cache()

    if chain:
        chained = Context(None, n_cells=cells, device="cuda", params_cfg=(params, cfg),
                          chain=True)
        cuda_qmm_chain.reset_launches()
        steps = steps_against(chained, ctx, prompt, rel_tol=0.0)
        k6 = dict(cuda_qmm_chain.LAUNCHES)
        out["chain"] = dict(phase=phase, path=f"{model} chain=True", k6_launches=k6,
                            bit_equal=steps["steps_max_abs_err"] == 0.0, card=card)
        log(json.dumps(out["chain"]))
        if any(k6.values()) or not out["chain"]["bit_equal"]:
            raise AssertionError(f"{model} under chain=True: K6 launches {k6}, steps {steps}")
        del chained
    del ctx
    torch.cuda.empty_cache()

    q8 = Context(None, n_cells=cells, device="cuda", params_cfg=(params, cfg), kv_dtype="q8_0")
    counts_q8, rec_q8 = run_llama3_8b(q8, ("K3q", "K4q"), None, q8_decode, prompt)
    out["q8_0"] = dict(phase=phase, path=f"{model} q8_0 cache", kv_bytes=rec_q8["kv_bytes"],
                       ms_per_token=1e3 / rec_q8["decode_tok_s"],
                       prefill_tok_s=rec_q8["prefill_tok_s"],
                       decode_bound_tok_s=rec_q8["decode_bound_tok_s"],
                       peak_mem_gib=rec_q8["peak_mem_gib"], card=card)
    log(json.dumps(out["q8_0"]))
    del q8
    torch.cuda.empty_cache()
    out["counts"] = {"bf16": counts, "gdot": counts_g, "q8_0": counts_q8}
    return out


def phase_glm4_9b(card: str) -> dict:
    """Phase 17: GLM-4-9B-0414 (32 heads over 2 of 128, G = 16, rope NORM on
    64 of the 128 dims, QKV biases, post-norms, gate+up packed in ffn_up, a
    Q8_0 down at K = 13696, a Q6_K lm_head of 151552 rows) at full width
    and GLM4_LAYERS layers on glm4_9b_planes, through run_full_model_phase
    (bf16, gdot and the q8_0 cache). Returns the records."""
    params, cfg, planes = glm4_9b_planes()
    out = run_full_model_phase(17, "GLM-4-9B", params, cfg, planes["glm4_9b_planes_bytes"], card,
                               GLM4_CELLS, GLM4_PROMPT, GLM4_DECODE, GLM4_DECODE, GLM4_Q8_DECODE)
    del params
    torch.cuda.empty_cache()
    return out


# phase 18: Command-R v01 at full width and COMMAND_R_LAYERS of its 40
# layers (cut to 20: at 40 the whole script took 1040 s on an H100 host;
# then to 12 to pay for phase 19 within the time limit) on 4096
# cells: a 512-token prefill and 128 greedy tokens with the bf16 cache,
# unfused, then gdot, chain and the q8_0 cache on fewer tokens
COMMAND_R_LAYERS = 12
COMMAND_R_CELLS = 4096
COMMAND_R_PROMPT, COMMAND_R_DECODE = 512, 128
COMMAND_R_GDOT_DECODE = 32
COMMAND_R_Q8_DECODE = 32


def command_r_planes():
    """Command-R v01's Q4_K_M-style random planes made on the card from
    seed 19 at COMMAND_R_LAYERS layers: Q4_K everywhere but a Q6_K attn_v
    and ffn_down in the use_more_bits layers (whose q, k and v then stay
    unfused) and the tied Q6_K table (256000 rows; the lm_head its K-major
    copy), an attn_norm (LayerNorm weights, no bias) and no ffn_norm a
    layer. Returns (params, cfg, planes_summary's record)."""
    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import COMMAND_R_35B, make_synthetic_model, use_more_bits
    from llm_tpu_torch.ops.rope import ROPE_TYPE_NORM

    t0 = time.perf_counter()
    params, cfg = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                       seed=19, recipe="Q4_K_M", arch="command-r",
                                       **dict(COMMAND_R_35B, n_layers=COMMAND_R_LAYERS))
    torch.cuda.synchronize()
    log(json.dumps(dict(command_r_planes_s=time.perf_counter() - t0)))
    planes = planes_summary(params, cfg, "command_r")
    widths = ("n_embd", "n_heads", "n_kv_heads", "n_ff", "head_dim")
    if (cfg.arch, cfg.norm_kind, cfg.parallel_residual, cfg.logit_scale, cfg.rope.mode,
            cfg.vocab_size) != ("command-r", "ln", True, 0.0625, ROPE_TYPE_NORM,
                                COMMAND_R_35B["vocab"]) \
            or any(getattr(cfg, k) != COMMAND_R_35B[k] for k in widths):
        raise AssertionError(f"not Command-R's profile: {cfg}")
    if not (params["tok_embd"].ggml_type == params["output"].ggml_type == GGMLType.Q6_K
            and params["output"].out_features == cfg.vocab_size):
        raise AssertionError("not the tied Q6_K table")
    for il, layer in enumerate(params["layers"]):
        more = use_more_bits(il, cfg.n_layers)
        down = GGMLType.Q6_K if more else GGMLType.Q4_K
        if layer["ffn_down"].ggml_type != down or ("attn_qkv_fused" in layer) == more \
                or "ffn_norm" in layer or layer["attn_norm"].shape != (cfg.n_embd,) \
                or layer["ffn_gateup_fused"].out_features != 2 * cfg.n_ff:
            raise AssertionError(f"layer {il} is not the Q4_K_M recipe's Command-R layer")
    return params, cfg, planes


def phase_command_r_35b(card: str) -> dict:
    """Phase 18: Command-R v01 (8192 wide, 64 heads over 64 of 128, G = 1,
    ff 22528, LayerNorm, the parallel block on one shared norm, logits
    times 0.0625, a tied 256000-row Q6_K table) at full width and
    COMMAND_R_LAYERS layers on command_r_planes, through
    run_full_model_phase (bf16, gdot on COMMAND_R_GDOT_DECODE tokens,
    chain=True bit-equal with no K6, the q8_0 cache). Returns the records."""
    params, cfg, planes = command_r_planes()
    out = run_full_model_phase(18, "Command-R", params, cfg, planes["command_r_planes_bytes"],
                               card, COMMAND_R_CELLS, COMMAND_R_PROMPT, COMMAND_R_DECODE,
                               COMMAND_R_GDOT_DECODE, COMMAND_R_Q8_DECODE, chain=True)
    del params
    torch.cuda.empty_cache()
    return out


# phase 19: Gemma-2-27B (google/gemma-2-27b config.json; models/synthetic.py
# GEMMA2_27B) at full width and GEMMA2_27B_LAYERS of its 46 layers, cut after
# the 46-layer config chose its scale (gemma2_27b_config), on 1024 cells (no
# ring: its window is 4096): a 512-token prefill (one step) and
# GEMMA2_27B_DECODE greedy tokens with each cache type, and a twin Context
# fed the same prompt GEMMA2_27B_STEP tokens a step
GEMMA2_27B_LAYERS = 4
GEMMA2_27B_CELLS = 1024
GEMMA2_27B_PROMPT, GEMMA2_27B_DECODE, GEMMA2_27B_STEP = 512, 8, 8


def phase_gemma2_27b(card: str) -> dict:
    """Phase 19: Gemma-2-27B's capped 128-dim prefill on the narrow CTA.
    Q4_K_M-style random planes made on the card from seed 19 (a tied Q6_K
    table), gemma2_27b_config(GEMMA2_27B_LAYERS), whose scale must be
    (4608 / 32)^-0.5. For the bf16 cache (K4_cap at the prefill, K3w_cap
    at decode) and the q8_0 one (K4q_cap, K3qw_cap): prefill 512 and
    GEMMA2_27B_DECODE greedy tokens with every launch counted
    (run_llama3_8b: the capped narrow kernel a layer at the one prefill
    step and no other flash prefill, K4w_cap among them); then a second
    Context on the same planes fed the prompt GEMMA2_27B_STEP tokens a step,
    which runs K3w_cap (K3qw_cap) alone, an independent kernel: the prompt's
    last logits within TWO_LAYER_REL_TOL of max|logit| (on q8_0 caches
    TWO_LAYER_Q8_REL_TOL: a last-bit difference can also move a cached
    value across an int8 step). Returns the launches and the records."""
    import numpy as np

    from llm_tpu_torch.gguf.constants import GGMLType
    from llm_tpu_torch.models.synthetic import (GEMMA2_27B, gemma2_27b_config,
                                                make_synthetic_model)
    from llm_tpu_torch.ops import cuda_attn
    from llm_tpu_torch.quant.qtensor import QTensor
    from llm_tpu_torch.runtime.batch import Batch
    from llm_tpu_torch.runtime.engine import Context

    t0 = time.perf_counter()
    params, _ = make_synthetic_model(qtype=GGMLType.Q4_K, device="cuda", on_device=True,
                                     seed=19, recipe="Q4_K_M", arch="gemma2",
                                     **dict(GEMMA2_27B, n_layers=GEMMA2_27B_LAYERS))
    cfg = gemma2_27b_config(GEMMA2_27B_LAYERS)
    if cfg.attn_scale != (4608 / 32) ** -0.5 or cfg.n_layers != GEMMA2_27B_LAYERS:
        raise AssertionError(f"Gemma-2-27B at cut depth: scale {cfg.attn_scale}")
    torch.cuda.synchronize()
    leaves = [v for layer in params["layers"] for v in layer.values()]
    leaves += [params["tok_embd"], params["output"]]
    nbytes = sum(qt_bytes(v) for v in leaves if isinstance(v, QTensor))
    log(json.dumps(dict(phase=19, gemma2_27b_planes_s=time.perf_counter() - t0,
                        planes_bytes=nbytes, attn_scale=cfg.attn_scale, card=card)))
    prompt = main_prompt(cfg.vocab_size, GEMMA2_27B_PROMPT)
    out = {}
    for kv, (dec, pre), rel in ((None, ("K3w_cap", "K4_cap"), TWO_LAYER_REL_TOL),
                                ("q8_0", ("K3qw_cap", "K4q_cap"), TWO_LAYER_Q8_REL_TOL)):
        kw = {"kv_dtype": kv} if kv else {}
        ctx = Context(None, n_cells=GEMMA2_27B_CELLS, device="cuda", params_cfg=(params, cfg),
                      **kw)
        keep = {}
        counts, rec = run_llama3_8b(ctx, (dec, pre), keep, GEMMA2_27B_DECODE,
                                    GEMMA2_27B_PROMPT)
        del ctx
        twin = Context(None, n_cells=GEMMA2_27B_CELLS, device="cuda", params_cfg=(params, cfg),
                       **kw)
        cuda_attn.reset_launches()
        for i in range(0, len(prompt), GEMMA2_27B_STEP):
            assert twin.decode(Batch.text(prompt[i:i + GEMMA2_27B_STEP])) == 0
        torch.cuda.synchronize()
        twin_counts = {k: v for k, v in cuda_attn.LAUNCHES.items() if v}
        want_twin = {dec: cfg.n_layers * -(-len(prompt) // GEMMA2_27B_STEP)}
        lt = twin.get_logits()
        err = float(np.abs(keep["logits"] - lt).max())
        tol = rel * float(np.abs(lt).max())
        log(json.dumps(dict(phase=19, kv_dtype=kv or "bf16", prefill_kernel=pre,
                            prefill_launches=counts[pre], twin_launches=twin_counts,
                            prefill_vs_steps_of_8_max_abs_diff=err, tol=tol,
                            prefill_tok_s=rec["prefill_tok_s"],
                            ms_per_token=1e3 / rec["decode_tok_s"], card=card)))
        del twin
        torch.cuda.empty_cache()
        if twin_counts != want_twin:
            raise AssertionError(f"the twin's flash launches {twin_counts} != {want_twin}")
        if not (err <= tol and math.isfinite(err)):
            raise AssertionError(f"Gemma-2-27B {kv or 'bf16'}: the prefill's last logits vs "
                                 f"steps of {GEMMA2_27B_STEP}: max|diff| {err} > {tol}")
        out.update({pre: counts[pre], dec: counts[dec], f"{kv or 'bf16'}_rec": rec})
    del params
    torch.cuda.empty_cache()
    return out


REPLACES = {
    "K1": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:159"),
    "K2": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:149"),
    "K3": ("llm_tpu_torch/csrc/flash_attn.cu", "llm_tpu/ops/pallas_attn.py:123"),
    "K4": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:328"),
    "K3q": ("llm_tpu_torch/csrc/flash_attn.cu", "llm_tpu/ops/pallas_attn.py:135"),
    "K4q": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:341"),
    "K3w": ("llm_tpu_torch/csrc/flash_attn.cu", "llm_tpu/ops/pallas_attn.py:123"),
    "K4w": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:328"),
    "K3qw": ("llm_tpu_torch/csrc/flash_attn.cu", "llm_tpu/ops/pallas_attn.py:135"),
    "K4qw": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:341"),
    # the softcap term of the TPU kernels' bodies (_decode_body :81-82,
    # _prefill_body :292-293), reached through _kernel / _kernel_q8 and
    # _prefill_kernel / _prefill_kernel_q8
    "K3w_cap": ("llm_tpu_torch/csrc/flash_attn.cu", "llm_tpu/ops/pallas_attn.py:123"),
    "K4w_cap": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:328"),
    "K3qw_cap": ("llm_tpu_torch/csrc/flash_attn.cu", "llm_tpu/ops/pallas_attn.py:135"),
    "K4qw_cap": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:341"),
    "K4_cap": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:328"),
    "K4q_cap": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:341"),
    # the ALiBi term of the TPU kernels' bodies (_decode_body :83-96,
    # _prefill_body :294-302), reached through the same entries
    "K3_alibi": ("llm_tpu_torch/csrc/flash_attn.cu", "llm_tpu/ops/pallas_attn.py:123"),
    "K4_alibi": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:328"),
    "K3q_alibi": ("llm_tpu_torch/csrc/flash_attn.cu", "llm_tpu/ops/pallas_attn.py:135"),
    "K4q_alibi": ("llm_tpu_torch/csrc/flash_prefill.cu", "llm_tpu/ops/pallas_attn.py:341"),
    "K5": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:195"),
    "K6": ("llm_tpu_torch/csrc/qmm_chain.cu", "llm_tpu/ops/pallas_qmm_chain.py:107"),
    # the gelu term of _chain_kernel's "geglu" boundary (:164-167, _act_f32
    # :101-104)
    "K6_gelu": ("llm_tpu_torch/csrc/qmm_chain.cu", "llm_tpu/ops/pallas_qmm_chain.py:107"),
    "K7": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:481"),
    # the same TPU kernels on nibble planes at group size 16 (Q2_K, Q3_K:
    # _p4_m's and _gdot_kernel's groups, _chain_kernel's phases, :189-204)
    "K1_gs16": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:159"),
    "K5_gs16": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:195"),
    "K6_gs16": ("llm_tpu_torch/csrc/qmm_chain.cu", "llm_tpu/ops/pallas_qmm_chain.py:107"),
    "K7_gs16": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:481"),
    # and at group size 256 (TQ1_0, TQ2_0) and, on int8 planes, 8 (IQ1_M:
    # _i8_m's groups, :154)
    "K1_gs256": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:159"),
    "K5_gs256": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:195"),
    "K6_gs256": ("llm_tpu_torch/csrc/qmm_chain.cu", "llm_tpu/ops/pallas_qmm_chain.py:107"),
    "K7_gs256": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:481"),
    "K2_gs8": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:149"),
    "K6_gs8": ("llm_tpu_torch/csrc/qmm_chain.cu", "llm_tpu/ops/pallas_qmm_chain.py:107"),
    "K7_gs8": ("llm_tpu_torch/csrc/qmm_decode.cu", "llm_tpu/ops/pallas_qmm.py:481"),
    "S1": ("llm_tpu_torch/csrc/qmm_probe.cu", "scripts/kbench.py:56"),
    "S3 v1": ("llm_tpu_torch/csrc/flash_probe.cu", "scripts/kbench7.py:102"),
    "S3 v0": ("llm_tpu_torch/csrc/flash_probe.cu", "scripts/kbench7.py:47"),
    "S3 noscale": ("llm_tpu_torch/csrc/flash_probe.cu", "scripts/kbench9.py:35"),
    "S3 full": ("llm_tpu_torch/csrc/flash_probe.cu", "scripts/kbench9.py:35"),
    "S3 bf16": ("llm_tpu_torch/csrc/flash_probe.cu", "scripts/kbench9.py:35"),
}
# the line's timing for each kernel comes from its main-path decode (or
# prefill) shape; max_abs_err is the largest over every shape checked
HEADLINE = {"K1": "gate_up Q4_K K=4096 N=28672 B=1",
            "K2": "down Q6_K K=14336 N=4096 B=1",
            "K3": "decode half-masked T=1 S=4096 H=32 Hkv=8 D=128",
            "K4": "prefill T=512 S=4096 H=32 Hkv=8 D=128",
            "K3q": "decode half-masked T=1 S=4096 H=32 Hkv=8 D=128",
            "K4q": "prefill T=512 S=4096 H=32 Hkv=8 D=128",
            # the wide kernels at gemma's head dim (phase 3's Gemma-2-2B twins)
            "K3w": "decode half-masked T=1 S=4096 H=8 Hkv=4 D=256",
            "K4w": "prefill T=512 S=4096 H=8 Hkv=4 D=256",
            "K3qw": "decode half-masked T=1 S=4096 H=8 Hkv=4 D=256",
            "K4qw": "prefill T=512 S=4096 H=8 Hkv=4 D=256",
            # the capped wide kernels at Gemma-2-9B's heads (phase 11)
            "K3w_cap": "decode half-masked T=1 S=4096 H=16 Hkv=8 D=256 cap=50",
            "K4w_cap": "prefill T=512 S=4096 H=16 Hkv=8 D=256 cap=50",
            "K3qw_cap": "decode half-masked T=1 S=4096 H=16 Hkv=8 D=256 cap=50",
            "K4qw_cap": "prefill T=512 S=4096 H=16 Hkv=8 D=256 cap=50",
            # the narrow capped kernels at Gemma-2-27B's heads (phase 19)
            "K4_cap": "prefill T=512 S=4096 H=32 Hkv=16 D=128 cap=50",
            "K4q_cap": "prefill T=512 S=4096 H=32 Hkv=16 D=128 cap=50",
            # the ALiBi kernels at Baichuan-13B's heads (phase 12)
            "K3_alibi": "decode half-masked T=1 S=4096 H=40 Hkv=40 D=128 alibi",
            "K4_alibi": "prefill T=512 S=4096 H=40 Hkv=40 D=128 alibi",
            "K3q_alibi": "decode half-masked T=1 S=4096 H=40 Hkv=40 D=128 alibi",
            "K4q_alibi": "prefill T=512 S=4096 H=40 Hkv=40 D=128 alibi",
            "K5": "gu Q4_K K=4096 N=28672 B=1",
            "K6": "tail Q6_K down B=1",
            # the GeGLU tail at Gemma-7B's widths (phase 14)
            "K6_gelu": "gemma-7b tail Q4_K down B=1",
            "K7": "gate_up Q4_K K=4096 N=28672 B=1",
            # the group-size-16 forms at phase 15's Q3_K gate+up and tail
            "K1_gs16": "gate_up Q3_K K=4096 N=28672 B=1",
            "K5_gs16": "gate_up Q3_K K=4096 N=28672 B=1",
            "K6_gs16": "tail Q3_K B=1",
            "K7_gs16": "gate_up Q3_K K=4096 N=28672 B=1",
            # the group-size-256 forms at BitNet's TQ2_0 gate+up and
            # LLAMA3_8B's TQ2_0 tail, the group-size-8 ones at LLAMA3_8B's
            # IQ1_M gate+up and tail
            "K1_gs256": "gate_up TQ2_0 K=2560 N=13824 B=1",
            "K5_gs256": "gate_up TQ2_0 K=2560 N=13824 B=1",
            "K6_gs256": "llama tail TQ2_0 B=1",
            "K7_gs256": "gate_up TQ2_0 K=2560 N=13824 B=1",
            "K2_gs8": "gate_up IQ1_M K=4096 N=28672 B=1",
            "K6_gs8": "tail IQ1_M B=1",
            "K7_gs8": "gate_up IQ1_M K=4096 N=28672 B=1",
            # S1's line reads its "dma" probe (every plane streamed, x staged)
            "S1": "gu Q4_K K=4096 N=28672 B=8"}
# K1/K2/K7's entries (their source the decode GEMV's) also carry their
# prefill GEMM's time (B = 512) at the largest matmul of a prefill of their
# planes, with the GEMM's source
PREFILL_SOURCE = {"K1": "llm_tpu_torch/csrc/qmm.cu", "K2": "llm_tpu_torch/csrc/qmm.cu",
                  "K7": "llm_tpu_torch/csrc/qmm_stacked.cu",
                  "K1_gs16": "llm_tpu_torch/csrc/qmm.cu",
                  "K7_gs16": "llm_tpu_torch/csrc/qmm_stacked.cu",
                  "K1_gs256": "llm_tpu_torch/csrc/qmm.cu",
                  "K7_gs256": "llm_tpu_torch/csrc/qmm_stacked.cu",
                  "K2_gs8": "llm_tpu_torch/csrc/qmm.cu",
                  "K7_gs8": "llm_tpu_torch/csrc/qmm_stacked.cu"}
PREFILL_HEADLINE = {"K1": "gate_up Q4_K K=4096 N=28672 B=512",
                    "K2": "down Q6_K K=14336 N=4096 B=512",
                    "K7": "gate_up Q4_K K=4096 N=28672 B=512",
                    "K1_gs16": "gate_up Q3_K K=4096 N=28672 B=512",
                    "K7_gs16": "gate_up Q3_K K=4096 N=28672 B=512",
                    "K1_gs256": "gate_up TQ2_0 K=2560 N=13824 B=512",
                    "K7_gs256": "gate_up TQ2_0 K=2560 N=13824 B=512",
                    "K2_gs8": "gate_up IQ1_M K=4096 N=28672 B=512",
                    "K7_gs8": "gate_up IQ1_M K=4096 N=28672 B=512"}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    attn_gemm = sys.argv[1:2] == ["--attn-gemm-rows"]
    root = None
    if attn_gemm and sys.argv[2:3] == ["--root"] and len(sys.argv) == 4:
        root = os.path.abspath(sys.argv[3])  # that checkout's llm_tpu_torch, built there
        sys.path.insert(0, root)
    elif attn_gemm and len(sys.argv) != 2:
        print("usage: chip_smoke.py --attn-gemm-rows [--root DIR]", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from llm_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    report = cuda_build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        log(f"--- nvcc {name} ({r['seconds']:.1f} s)")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line or "C75" in line:
                log("   ", line.strip())
    if attn_gemm:
        log(f"attention and GEMM rows of {os.path.dirname(cuda_build.CSRC.parent)}")
        attn_gemm_rows(flex=root is None)
        log("attention and GEMM rows passed")
        return 0
    # the decode GEMV: K1/K2/K7's 16 qmm_decode kernels and K5's 8
    # (qmm_decode_gdot) issue mma.sync and TMA tile loads; the old GEMV loop
    # (qmm_gemv) is in no library but S1's, whose probes keep it; K6's
    # qmm_chain_tc, the decode GEMV's CTA on a cooperative grid, issues
    # mma.sync and TMA tile loads, and the old qmm_chain_kernel is gone
    check_sass("decode_sass", {"qmm_decode": DECODE_KERNELS}, "qmm_decode",
               ("HMMA", "UTMALDG"), "qmm_gemv")
    check_sass("gemv_left", {"qmm": 0, "qmm_stacked": 0, "qmm_chain": 0}, "qmm_gemv", (),
               "qmm_gemv")
    check_sass("probe_sass", {"qmm_probe": S1_KERNELS}, "qmm_probe", (), ())
    check_sass("chain_sass", {"qmm_chain": CHAIN_KERNELS}, "qmm_chain_tc", ("HMMA", "UTMALDG"),
               ("qmm_chain_kernel", "qmm_decode"))
    # the forms on nibble planes at group size 16 (Q2_K, Q3_K), counted
    # apart: K1/K7/K5's decode kernels and K6's issue mma.sync and TMA
    # loads, K1/K7's prefill GEMM wgmma and TMA loads
    check_sass("g16_decode_sass", {"qmm_decode": DECODE_G16_KERNELS}, "_g16",
               ("HMMA", "UTMALDG"), ())
    check_sass("g16_chain_sass", {"qmm_chain": 1}, "qmm_chain_tc_g16", ("HMMA", "UTMALDG"), ())
    check_sass("g16_gemm_sass", {"qmm": GEMM_G16_KERNELS, "qmm_stacked": GEMM_G16_KERNELS},
               "qmm_wgmma_g16", ("HGMMA", "UTMALDG"), ())
    # the forms at group size 256 (TQ1_0, TQ2_0) and, on int8 planes, 8
    # (IQ1_M), likewise
    check_sass("g256_decode_sass", {"qmm_decode": DECODE_G256_KERNELS}, "_g256",
               ("HMMA", "UTMALDG"), ())
    check_sass("g8_decode_sass", {"qmm_decode": DECODE_G8_KERNELS}, "qmm_decode_g8",
               ("HMMA", "UTMALDG"), ())
    for form in ("g256", "g8"):
        check_sass(f"{form}_chain_sass", {"qmm_chain": 1}, f"qmm_chain_tc_{form}",
                   ("HMMA", "UTMALDG"), ())
    for form, n in (("g256", GEMM_G256_KERNELS), ("g8", GEMM_G8_KERNELS)):
        check_sass(f"{form}_gemm_sass", {"qmm": n, "qmm_stacked": n}, f"qmm_wgmma_{form}",
                   ("HGMMA", "UTMALDG"), ())
    # the prefill GEMM: the eight qmm_wgmma kernels of each library issue
    # wgmma and TMA tile loads, and the mma.sync qmm_gemm is gone; flash
    # prefill: K4 and K4q issue wgmma, libflash_attn.so holds only the
    # decode kernels, and the f32-FMA flash_prefill_kernel is gone
    check_sass("gemm_sass", {"qmm": GEMM_KERNELS, "qmm_stacked": GEMM_KERNELS}, "qmm_wgmma",
               ("HGMMA", "UTMALDG"), "qmm_gemm")
    check_sass("prefill_sass", {"flash_prefill": K4_KERNELS, "flash_attn": 0}, "flash_prefill",
               ("HGMMA",), "flash_prefill_kernel")
    # flash decode: K3/K3q's cluster kernels issue mma.sync and TMA tile
    # loads, and no split-S kernel or combine kernel is left in their
    # library; S3's library keeps that body
    check_sass("decode_attn_sass", {"flash_attn": K3_KERNELS}, "flash_decode_tc",
               ("HMMA", "UTMALDG"), ("flash_decode_split", "flash_decode_combine"))
    # the capped instantiations (gemma2's attention softcap), counted apart:
    # K3w_cap/K3qw_cap issue mma.sync and TMA loads, K4w_cap/K4qw_cap and
    # the narrow K4_cap/K4q_cap wgmma and TMA loads
    check_sass("capped_decode_sass", {"flash_attn": K3_CAP_KERNELS}, "flash_decode_tc_wide_cap",
               ("HMMA", "UTMALDG"), ())
    check_sass("capped_prefill_sass", {"flash_prefill": K4_CAP_KERNELS},
               "flash_prefill_wgmma_wide_cap", ("HGMMA", "UTMALDG"), ())
    check_sass("narrow_capped_prefill_sass", {"flash_prefill": K4_NARROW_CAP_KERNELS},
               "flash_prefill_wgmma_cap", ("HGMMA", "UTMALDG"), ())
    # the ALiBi instantiations of the narrow kernels (Baichuan-13B, refact),
    # counted apart: K3_alibi/K3q_alibi issue mma.sync and TMA loads,
    # K4_alibi/K4q_alibi wgmma and TMA loads
    check_sass("alibi_decode_sass", {"flash_attn": K3_ALIBI_KERNELS}, "flash_decode_tc_alibi",
               ("HMMA", "UTMALDG"), ())
    check_sass("alibi_prefill_sass", {"flash_prefill": K4_ALIBI_KERNELS},
               "flash_prefill_wgmma_alibi", ("HGMMA", "UTMALDG"), ())
    # S3's library keeps the split-S body that K3/K3q no longer run, and its
    # combine kernel
    check_sass("probe_split_sass", {"flash_probe": S3_SPLIT_KERNELS}, "flash_probe_split", (), ())
    check_sass("probe_combine_sass", {"flash_probe": 1}, "flash_decode_combine", (), ())
    if sys.argv[1:2] == ["--sweep-seeds"]:
        kinds = sys.argv[2:] or ["q8_0", "chain", "gguf"]
        if "q8_0" in kinds:
            sweep_seeds(range(1, 7))
        if "chain" in kinds:
            sweep_chain_seeds(range(1, 7))
        if "gguf" in kinds:
            sweep_gguf_seeds(range(1, 5))
        return 0
    if sys.argv[1:] == ["--decode-rows"]:
        decode_rows()
        log("decode rows passed")
        return 0
    if sys.argv[1:] == ["--command-r"]:
        command_r_rows([])
        phase_two_layers_widths(only=("Command-R GGUF",))
        t0 = time.perf_counter()
        phase_command_r_35b(card)
        log(f"Command-R at {COMMAND_R_LAYERS} layers passed in {time.perf_counter() - t0:.1f} s")
        return 0
    if sys.argv[1:] == ["--screen-seeds"]:
        sweep_seeds(range(1, 65), devices=("cuda",))
        return 0

    t0 = time.perf_counter()
    results = phase_kernels()
    log(f"kernel checks passed in {time.perf_counter() - t0:.1f} s")
    log_k3_against_was(results)
    t0 = time.perf_counter()
    probes, s1_launches = phase_probes()
    log(f"decode GEMV probes passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    attn_probes, s3_launches = phase_attn_probes()
    log(f"flash-decode probes passed in {time.perf_counter() - t0:.1f} s")
    check_s3_against_table(attn_probes)
    t0 = time.perf_counter()
    phase_two_layers()
    log(f"two-layer card-vs-CPU check passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_two_layers_q8()
    log(f"two-layer q8_0 card-vs-CPU check passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_two_layers_chain()
    log(f"two-layer chained card-vs-CPU check passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    widths = phase_two_layers_widths()
    log(f"two-layer Llama-3.2-1B/3B card-vs-CPU checks passed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params, cfg = llama3_8b_planes()
    check_gdot_path(results, params)
    counts, rec = phase_llama3_8b(params, cfg)
    log(f"LLAMA3_8B main path passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_q8 = phase_llama3_8b_q8(params, cfg, rec)
    log(f"LLAMA3_8B q8_0 cache path passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_gdot, _ = phase_llama3_8b(params, cfg, gdot=True, base=rec)
    log(f"LLAMA3_8B gdot path passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_chain, _ = phase_llama3_8b(params, cfg, chain=True, gdot=True, base=rec)
    log(f"LLAMA3_8B chained path passed in {time.perf_counter() - t0:.1f} s")
    phase_decode_turns(params, cfg)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts_scan = phase_scan()
    log(f"LLAMA3_8B scan decoder passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lowbit = phase_llama3_8b_lowbit()
    log(f"LLAMA3_8B at Q3_K_M and Q2_K passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    iq = phase_iq()
    log(f"the IQ and ternary types (LLAMA3_8B IQ2_XXS, IQ1_M; BitNet TQ2_0) passed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_gguf_cli()
    log(f"LLAMA3_8B GGUF through the CLI passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_gemma2 = phase_gemma2_9b()
    log(f"Gemma-2-9B at {GEMMA2_PHASE11_LAYERS} layers passed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_baichuan = phase_baichuan_13b()
    log(f"Baichuan-13B at {BAICHUAN_PHASE12_LAYERS} layers passed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_qwen3_30b_a3b()
    log(f"Qwen3-30B-A3B at {QWEN3_LAYERS} layers passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gemma7b = phase_gemma_7b()
    log(f"Gemma-7B with chain at {GEMMA7B_LAYERS} layers passed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    glm4 = phase_glm4_9b(card)
    log(f"GLM-4-9B at {GLM4_LAYERS} layers passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_command_r_35b(card)
    log(f"Command-R at {COMMAND_R_LAYERS} layers passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gemma27 = phase_gemma2_27b(card)
    log(f"Gemma-2-27B at {GEMMA2_27B_LAYERS} layers passed in {time.perf_counter() - t0:.1f} s")
    # each kernel's launches from the path that runs it: K1-K4 from phase 4,
    # K3q/K4q from phase 5, K5 from phase 6, K6 from phase 7, K7 from phase
    # 8, the wide K3w/K4w/K3qw/K4qw from phase 3's Gemma-2-2B and
    # DeepSeek-V2-Lite twins (their card runs), the capped ones from phase
    # 11 (K3w_cap/K4w_cap its ring run, K3qw_cap/K4qw_cap its q8_0 one), the
    # narrow capped K4_cap/K4q_cap from phase 19, the ALiBi ones from phase 12 (its bf16 and q8_0 runs), K6_gelu from phase
    # 14's chained run, S1 from the kbench run, S3 from the kbench_attn run
    counts = {**counts, "K3q": counts_q8["K3q"], "K4q": counts_q8["K4q"],
              "K5": counts_gdot["K5"], "K6": counts_chain["K6"], "K7": counts_scan["K7"],
              **{k: sum(r["attn_launches"][k] for r in widths)
                 for k in ("K3w", "K4w", "K3qw", "K4qw")},
              **{k: counts_gemma2[k] for k in ("K3w_cap", "K4w_cap", "K3qw_cap", "K4qw_cap")},
              **{k: gemma27[k] for k in ("K4_cap", "K4q_cap")},
              **counts_baichuan, "K6_gelu": gemma7b["K6_gelu"],
              **{k: lowbit["counts"][k] for k in ("K1_gs16", "K5_gs16", "K6_gs16", "K7_gs16")},
              **{k: iq["counts"][k] for k in IQ_KERNELS}}

    kernels = []
    for k in ("K1", "K2", "K3", "K4", "K3q", "K4q", "K3w", "K4w", "K3qw", "K4qw", "K3w_cap",
              "K4w_cap", "K3qw_cap", "K4qw_cap", "K4_cap", "K4q_cap", "K3_alibi", "K4_alibi",
              "K3q_alibi",
              "K4q_alibi", "K5", "K6", "K6_gelu", "K7", "K1_gs16", "K5_gs16", "K6_gs16",
              "K7_gs16") + IQ_KERNELS:
        mine = [r for r in results if r["kernel"] == k]
        head = next(r for r in mine if r["shape"] == HEADLINE[k])
        src, rep = REPLACES[k]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=rep, launches=counts[k],
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=head["shape"], passed=True,
            **{f: head[f] for f in ("k1_ms", "unfused_ms", "unstacked_ms", "uncapped_kernel",
                                    "uncapped_ms", "sdpa_uncapped_ms", "unalibi_kernel",
                                    "unalibi_ms", "sdpa_backend") if f in head}))
        if k in PREFILL_HEADLINE:
            pre = next(r for r in mine if r["shape"] == PREFILL_HEADLINE[k])
            kernels[-1]["prefill"] = {"source": PREFILL_SOURCE[k], **{f: pre[f] for f in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    head = next(r for r in probes if r["shape"] == HEADLINE["S1"])
    src, rep = REPLACES["S1"]
    kernels.append(dict(
        name="S1", route="cuda", source=src, replaces=rep, launches=s1_launches,
        max_abs_err=max(e for r in probes for row in r["max_abs_err"].values() for e in row),
        ms=head["us"]["dma"] / 1e3, plain_ms=head["plain_us"]["dma"] / 1e3,
        bound_ms=head["bound_us"]["dma"] / 1e3, bound_by="bytes", library_ms=None,
        shape=head["shape"] + " dma", passed=True, k1_ms=head["us"]["full"] / 1e3,
        qs_ms=head["us"]["qs"] / 1e3, deq_ms=head["us"]["deq"] / 1e3))
    # S3, one entry a variant: its time at the split body's own split (the q8 modes run
    # at no other); launches are the variant's in the kbench_attn run
    for variant in ("v1", "v0", "noscale", "full", "bf16"):
        mine = [r for r in attn_probes if r["variant"] == variant]
        head = next(r for r in mine if r["split"] == 0)
        src, rep = REPLACES[f"S3 {variant}"]
        kernels.append(dict(
            name=f"S3 {variant}", route="cuda", source=src, replaces=rep,
            launches=sum(r["launches"] for r in mine),
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=head["us"] / 1e3,
            plain_ms=head["plain_us"] / 1e3, bound_ms=head["bound_us"] / 1e3,
            bound_by=head["bound_by"], library_ms=head["library_us"] / 1e3,
            shape=head["shape"], passed=True, n_splits=head["n_splits"],
            sweep_ms={r["cells_per_split"]: r["us"] / 1e3 for r in mine}))
    if sum(k["launches"] for k in kernels if k["name"].startswith("S3")) != s3_launches:
        raise AssertionError(f"S3: the variants' launches do not add up to {s3_launches}")
    log(f"chip_smoke.py: every phase passed, {time.perf_counter() - t_start:.1f} s in main()")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
