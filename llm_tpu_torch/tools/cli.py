"""llm-tpu-cli on the port: one-shot and interactive generation.

The port's own copy of llm_tpu/tools/cli.py (llama-cli's parity target:
tools/main/main.cpp: prompt eval, sampling loop, context shifting that
keeps n_keep and discards half (main.cpp:357-400), antiprompts, perf
report). `generate` is the reference's: the same fast path (greedy with
no-op modifiers runs Context.generate_loop in chunks of 8/16/32), the same
scalar loop through the host sampler chain, and the same output text.

    python -m llm_tpu_torch.tools.cli -m model.gguf -p "..." -n 128 --temp 0

Runs on the card (--device cuda, the default; without a card it exits
nonzero) unless --device cpu is given. --profile DIR writes a
torch.profiler trace there. --grammar, --grammar-file and --json-schema
constrain the generated text through the port's grammar/ (GBNF, "%regex",
JSON schema). --no-planes dequantizes the weights to dense at load;
--ep-capacity-factor F caps a mixture-of-experts model's expert buckets
(Context's ep_cf). Options whose modules the port has not ported exit with
an error that names their ROADMAP item: --lora and --control-vector, the
mesh options and T5 models.
"""

from __future__ import annotations

import os
import sys
import time

from ..gguf.reader import GGUFReader
from ..runtime.batch import Batch
from ..runtime.engine import Context
from ..samplers import SamplingParams, build_chain
from ..tokenizers import tokenizer_from_gguf

# option -> (the value that means "not used", what it needs)
_NOT_PORTED = {
    "lora": ([], "LoRA adapters are not ported yet (ROADMAP Queue 1 item 9.1)"),
    "control_vector": ([], "control vectors are not ported yet (ROADMAP Queue 1 item 9.1)"),
    "control_vector_layer_range": (None, "control vectors are not ported yet "
                                         "(ROADMAP Queue 1 item 9.1)"),
    "tensor_parallel": (1, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "seq_parallel": (1, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "dist_coordinator": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "dist_num_processes": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "dist_process_id": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "platform": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
    "n_virtual_devices": (None, "meshes are not ported yet (ROADMAP Queue 1 item 10)"),
}


def generate(
    ctx: Context,
    tok,
    prompt_tokens: list[int],
    n_predict: int,
    sampling: SamplingParams,
    seq_id: int = 0,
    n_keep: int = 0,
    antiprompts: tuple[str, ...] = (),
    stream=None,
    prompt_prefix: int = 0,
    pos_start: int = 0,
):
    """Prompt eval + generation loop with context shifting. Returns
    (tokens, text). prompt_prefix: tokens already in cache (session reuse);
    pos_start: cache position offset (interactive follow-up turns)."""
    chain = build_chain(sampling, ctx.cfg.vocab_size)
    n_ctx = ctx.n_cells

    todo = prompt_tokens[prompt_prefix:]
    rc = ctx.decode(Batch.text(todo, seq_id=seq_id,
                               pos_start=pos_start + prompt_prefix))
    if rc != 0:
        raise RuntimeError(f"prompt decode failed: rc={rc}")
    for t in prompt_tokens:
        chain.accept(t)
    if sampling.grammar:
        # constrain GENERATED text only: wrap after the prompt is accepted
        from ..grammar import constrained_chain

        chain = constrained_chain(chain, tok, grammar=sampling.grammar)

    out_tokens: list[int] = []
    text_parts: list[str] = []
    n_past = pos_start + len(prompt_tokens)

    # fast path: greedy + default (no-op) modifiers, no antiprompts, and
    # enough cache that no context shift can trigger -> generate ON DEVICE
    # in chunks (Context.generate_loop), avoiding the per-token host round
    # trip of the scalar loop below
    simple_greedy = (
        sampling.temp <= 0 and sampling.mirostat == 0
        and not sampling.grammar and not sampling.logit_bias
        and sampling.penalty_repeat == 1.0 and sampling.penalty_freq == 0.0
        and sampling.penalty_present == 0.0 and sampling.dry_multiplier == 0.0
        and sampling.xtc_probability == 0.0
    )
    n_scalar = n_predict  # scalar-loop budget (reduced by the fast path)
    if (simple_greedy and not antiprompts
            and (ctx.rslots is not None
                 or n_past + n_predict + 2 <= n_ctx)):
        eogs = tuple(i for i in (tok.vocab.eos_id, tok.vocab.eot_id)
                     if i is not None and i >= 0)

        def _emit(t):
            out_tokens.append(t)
            piece = tok.piece(t)
            text_parts.append(piece)
            if stream:
                stream(piece)
            chain.accept(t)

        tid = chain.sample(ctx.get_logits())
        chain.accept(tid)
        stopped = tok.vocab.is_eog(tid)
        tail_undecoded = False  # out_tokens[-1] not yet in cache/state
        if not stopped:
            out_tokens.append(tid)
            piece = tok.piece(tid)
            text_parts.append(piece)
            if stream:
                stream(piece)
            tail_undecoded = True
        # chunks never exceed the remaining budget (chunk <= remaining), so
        # the device loop cannot overshoot — required for recurrent models,
        # whose state cannot rewind
        while not stopped and len(out_tokens) < n_predict:
            rem = n_predict - len(out_tokens)
            k = max((b for b in (8, 16, 32) if b <= rem), default=0)
            if k == 0:
                break  # scalar tail below finishes the last few tokens
            nxt = ctx.generate_loop(out_tokens[-1], k, seq_id=seq_id,
                                    eog_ids=eogs)
            if not nxt:
                stopped = True
                break
            if tok.vocab.is_eog(nxt[-1]) or nxt[-1] in eogs:
                # the loop decoded everything up to (not incl.) the EOG
                stopped = True
                nxt = nxt[:-1]
                tail_undecoded = False
            else:
                tail_undecoded = True  # final sampled token undecoded
            for t in nxt:
                _emit(t)
        n_past = pos_start + len(prompt_tokens) + len(out_tokens)
        # the scalar loop decodes every emitted token — mirror that so (a)
        # the scalar tail below has logits to continue from and (b) cache/
        # state matches for follow-up turns
        if out_tokens and tail_undecoded:
            rc = ctx.decode(Batch.one(out_tokens[-1], pos=n_past - 1,
                                      seq_id=seq_id))
            if rc != 0:
                raise RuntimeError(f"decode failed: rc={rc}")
        if stopped or len(out_tokens) >= n_predict:
            return out_tokens, "".join(text_parts)
        n_scalar = n_predict - len(out_tokens)

    for _ in range(n_scalar):
        logits = ctx.get_logits()
        tid = chain.sample(logits)
        chain.accept(tid)
        if tok.vocab.is_eog(tid):
            break
        out_tokens.append(tid)
        piece = tok.piece(tid)
        text_parts.append(piece)
        if stream:
            stream(piece)

        # context shift: keep n_keep, drop half of the rest (main.cpp:372-400)
        if ctx.cells.n_seq_cells(seq_id) + 1 > n_ctx - 1:
            n_left = n_past - n_keep
            n_discard = n_left // 2
            ctx.seq_rm(seq_id, n_keep, n_keep + n_discard)
            ctx.seq_add(seq_id, n_keep + n_discard, n_past, -n_discard)
            n_past -= n_discard

        rc = ctx.decode(Batch.one(tid, pos=n_past, seq_id=seq_id))
        if rc != 0:
            raise RuntimeError(f"decode failed: rc={rc}")
        n_past += 1

        if antiprompts:
            tail = "".join(text_parts)[-64:]
            if any(a in tail for a in antiprompts):
                break
    return out_tokens, "".join(text_parts)


def _parser():
    import argparse

    from .args import add_override_kv, env_default as ed, required_unless_env

    ap = argparse.ArgumentParser(description="llm-tpu text generation (PyTorch port)")
    ap.add_argument("-m", "--model", default=ed("model", None),
                    required=required_unless_env("model"))
    ap.add_argument("-p", "--prompt", default=ed("prompt", ""))
    ap.add_argument("-f", "--file", default=None, help="prompt from file")
    ap.add_argument("-n", "--n-predict", type=int, default=ed("n-predict", 128))
    ap.add_argument("-c", "--ctx-size", type=int, default=ed("ctx-size", 4096))
    ap.add_argument("--n-keep", type=int, default=0)
    ap.add_argument("--temp", type=float, default=ed("temp", 0.8))
    ap.add_argument("--top-k", type=int, default=ed("top-k", 40))
    ap.add_argument("--top-p", type=float, default=ed("top-p", 0.95))
    ap.add_argument("--min-p", type=float, default=0.05)
    ap.add_argument("--grammar", default=ed("grammar", ""),
                    help="GBNF grammar text, or '%%regex <pattern>'")
    ap.add_argument("--grammar-file", default=None,
                    help="read --grammar from a file (.gbnf)")
    ap.add_argument("--json-schema", default=None,
                    help="constrain output to a JSON schema (string or @file)")
    ap.add_argument("--repeat-penalty", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=-1)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--no-planes", action="store_true",
                    help="dequantize the weights to dense at load (no quantized kernels)")
    ap.add_argument("-r", "--reverse-prompt", action="append", default=[])
    ap.add_argument("--prompt-cache", default=None,
                    help="session file: restore matching prompt prefix, save on exit")
    ap.add_argument("--verbose-prompt", action="store_true")
    ap.add_argument("--lora", action="append", default=[], help="(not ported yet)")
    ap.add_argument("--control-vector", action="append", default=[],
                    help="(not ported yet)")
    ap.add_argument("--control-vector-layer-range", nargs=2, type=int,
                    default=None, metavar=("START", "END"), help="(not ported yet)")
    ap.add_argument("-i", "--interactive", action="store_true",
                    help="interactive mode: read follow-up input after each turn")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to DIR")
    add_override_kv(ap)
    # the reference's mesh flags (tools/mesh_args.py) and MoE capacity factor
    ap.add_argument("-tp", "--tensor-parallel", type=int, default=1, help="(not ported yet)")
    ap.add_argument("-sp", "--seq-parallel", type=int, default=1, help="(not ported yet)")
    ap.add_argument("--dist-coordinator", default=None, help="(not ported yet)")
    ap.add_argument("--dist-num-processes", type=int, default=None, help="(not ported yet)")
    ap.add_argument("--dist-process-id", type=int, default=None, help="(not ported yet)")
    ap.add_argument("--platform", default=None, help="(not ported yet)")
    ap.add_argument("--n-virtual-devices", type=int, default=None, help="(not ported yet)")
    ap.add_argument("--ep-capacity-factor", type=float,
                    default=ed("ep-capacity-factor", 0.0), metavar="F",
                    help="MoE expert capacity factor (0 = exact, no drops). "
                         "Env: LLM_TPU_ARG_EP_CAPACITY_FACTOR")
    ap.add_argument("--device", default=ed("device", "cuda"),
                    help="torch device: cuda (default; the card) or cpu. "
                         "Env: LLM_TPU_ARG_DEVICE")
    return ap


def main(argv=None):
    import torch

    from .args import apply_kv_overrides

    ap = _parser()
    args = ap.parse_args(argv)
    for name, (unused, why) in _NOT_PORTED.items():
        if getattr(args, name) != unused:
            ap.error(f"--{name.replace('_', '-')}: {why}")
    from ..device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(2, f"{ap.prog}: error: {e}\n")
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        prof = profile(activities=acts)
        prof.start()

    t0 = time.perf_counter()
    reader = GGUFReader(args.model)
    apply_kv_overrides(reader, args.override_kv)
    tok = tokenizer_from_gguf(reader)
    if reader.architecture in ("t5", "t5encoder"):
        ap.error("T5 models are not ported yet (ROADMAP Queue 1 item 9.4)")

    ctx = Context(
        reader,
        n_cells=args.ctx_size,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
        device=device,
        ep_cf=args.ep_capacity_factor,
        use_planes=not args.no_planes,
    )
    ctx.perf.t_load_ms = (time.perf_counter() - t0) * 1e3
    print(f"model loaded in {time.perf_counter()-t0:.1f}s "
          f"({ctx.cfg.arch}, {ctx.cfg.n_layers} layers, vocab {ctx.cfg.vocab_size})",
          file=sys.stderr)

    prompt = args.prompt
    if args.file:
        prompt = open(args.file, encoding="utf-8").read()
    ptoks = tok.encode(prompt, add_special=True, parse_special=True)
    if args.verbose_prompt:
        for t in ptoks:
            print(f"{t:8d} -> {tok.piece(t, special=True)!r}", file=sys.stderr)

    # session / prompt cache (llama-cli --prompt-cache, main.cpp:357). The
    # state file is an .npz, which numpy names path + ".npz" when the path
    # lacks the suffix: look for that name too (llm_tpu's CLI does not, so
    # its cache is never reused under such a path; ROADMAP, "Faults in the
    # reference")
    session_prefix = 0
    if args.prompt_cache:
        from ..runtime.state import state_load
        saved = next((p for p in (args.prompt_cache, args.prompt_cache + ".npz")
                      if os.path.exists(p)), None)
        if saved is not None:
            try:
                cached = state_load(ctx, saved)
                n = 0
                for a, b in zip(cached, ptoks):
                    if a != b:
                        break
                    n += 1
                n = min(n, len(ptoks) - 1)
                ctx.seq_rm(0, n, -1)
                session_prefix = n
                print(f"prompt cache: reusing {n} tokens", file=sys.stderr)
            except Exception as e:
                print(f"prompt cache load failed: {e}", file=sys.stderr)
                ctx.clear()

    grammar = args.grammar or ""
    if args.grammar_file:
        grammar = open(args.grammar_file).read()
    if args.json_schema and not grammar:
        import json as _json

        from ..grammar.json_schema import json_schema_to_gbnf

        js = args.json_schema
        if js.startswith("@"):
            js = open(js[1:]).read()
        grammar = json_schema_to_gbnf(_json.loads(js))
    sampling = SamplingParams(
        temp=args.temp, top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        penalty_repeat=args.repeat_penalty,
        seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
        grammar=grammar,
    )

    sys.stdout.write(prompt)
    sys.stdout.flush()
    out_toks, _text = generate(
        ctx, tok, ptoks, args.n_predict, sampling,
        n_keep=args.n_keep, antiprompts=tuple(args.reverse_prompt),
        stream=lambda s: (sys.stdout.write(s), sys.stdout.flush()),
        prompt_prefix=session_prefix,
    )
    print()

    # interactive mode (llama-cli -i, main.cpp interactive loop): alternate
    # user input / generation on the same sequence, continuing the cache
    n_past = len(ptoks) + len(out_toks)
    while args.interactive:
        try:
            line = input("\n> ")
        except EOFError:
            break
        if not line.strip():
            continue
        if line.strip() in ("/exit", "/quit"):
            break
        turn = tok.encode(line + "\n", add_special=False, parse_special=True)
        more, _ = generate(
            ctx, tok, turn, args.n_predict, sampling,
            n_keep=args.n_keep, antiprompts=tuple(args.reverse_prompt),
            stream=lambda s: (sys.stdout.write(s), sys.stdout.flush()),
            prompt_prefix=0, pos_start=n_past,
        )
        n_past += len(turn) + len(more)
        print()
    print(ctx.perf.summary(), file=sys.stderr)
    if args.prompt_cache:
        from ..runtime.state import state_save
        state_save(ctx, args.prompt_cache, tokens=ptoks + out_toks)
        print(f"prompt cache saved to {args.prompt_cache}", file=sys.stderr)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"profiler trace written to {args.profile}", file=sys.stderr)


if __name__ == "__main__":
    main()
