"""The port's text entry point (llm_tpu_torch/tools/cli.py, tokenize_cli.py)
against llm_tpu's on the same tiny GGUFs, on the CPU: the same text on
stdout and the same stderr lines (the "model loaded in" line and
PerfCounters.summary(), up to their times), at temp 0 on the fast path
(greedy chunks through generate_loop) and on the scalar loop (a repeat
penalty, an antiprompt, a context shift). Both run in f32 so that their
greedy picks cannot part on a bf16 rounding.

Files: tests/test_tools.py's SPM vocab on a tiny HF llama converted by
llm_tpu's convert_hf_llama, and a tiny Q4_K_M-typed llama with a
byte-level BPE vocab ("llama-bpe") from the port's tools/synth_gguf.py.
Also: the perf counters counted as the reference counts them, the
prompt cache, --profile, --grammar / --grammar-file / --json-schema (the
reference's text at temp 0), --no-planes and --ep-capacity-factor (the
reference's text), the options the port has not ported (an error that
names the ROADMAP item), and --device cuda without a card."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.runtime.batch import Batch as JaxBatch
from llm_tpu.runtime.engine import Context as JaxContext
from llm_tpu.runtime.engine import PerfCounters as JaxPerfCounters
from llm_tpu.tools import cli as jax_cli
from llm_tpu.tools import tokenize_cli as jax_tokenize_cli

import torch

from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.runtime.batch import Batch
from llm_tpu_torch.runtime.engine import Context, PerfCounters
from llm_tpu_torch.tools import cli, synth_gguf, tokenize_cli

sys.path.insert(0, str(Path(__file__).parent))

_TIMES = re.compile(r"\d+(\.\d+)?(?= ?(s|ms|t/s)\b)")


@pytest.fixture(scope="module")
def spm_gguf(tmp_path_factory):
    pytest.importorskip("transformers")
    from test_model_vs_hf import _tiny_hf_llama
    from test_tools import _test_vocab

    from llm_tpu.convert.hf_llama import convert_hf_llama

    path = str(tmp_path_factory.mktemp("cli") / "tiny_spm.gguf")
    convert_hf_llama(_tiny_hf_llama(hidden=64, layers=2, vocab=97), path,
                     vocab=_test_vocab(97))
    return path


@pytest.fixture(scope="module")
def bpe_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "tiny_bpe_q4km.gguf")
    synth_gguf.write_llama(path, n_layers=2, n_embd=256, n_heads=4, n_kv_heads=1,
                                n_ff=512, n_vocab=1024, seed=3)
    return path


def _run(main, argv, capsys):
    main(argv)
    out, err = capsys.readouterr()
    return out, [line for line in err.splitlines() if line.strip()]


def _untimed(lines):
    return [_TIMES.sub("#", line) for line in lines]


CASES = {
    "fast": ["-p", "the quick brown", "-n", "21", "--temp", "0"],
    "penalty": ["-p", "Hello, World", "-n", "12", "--temp", "0", "--repeat-penalty", "1.3"],
    "antiprompt": ["-p", "the quick brown", "-n", "24", "--temp", "0", "-r", "o"],
    "shift": ["-p", "the quick brown fox", "-n", "20", "--temp", "0", "-c", "24",
              "--n-keep", "4"],
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("model", ["spm", "bpe"])
def test_cli_prints_the_reference_text(model, case, spm_gguf, bpe_gguf, capsys):
    path = spm_gguf if model == "spm" else bpe_gguf
    argv = ["-m", path, "--f32", "-c", "64", *CASES[case]]
    want, werr = _run(jax_cli.main, argv + ["--device", "cpu"], capsys)
    got, gerr = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert got == want
    assert len(got) > len(CASES[case][1])  # the prompt and some generated text
    assert _untimed(gerr) == _untimed(werr)
    assert gerr[0].startswith("model loaded in ")
    assert re.fullmatch(r"load \d+ ms \| prefill \d+ tok @ [\d.]+ t/s \| "
                        r"decode \d+ tok @ [\d.]+ t/s", gerr[-1])


GRAMMAR_CASES = {
    "gbnf": ["--grammar", 'root ::= ("the" | "a") " " [a-z]+ "."'],
    "regex": ["--grammar", "%regex [0-9]{2,4}-(yes|no)"],
    "file": ["--grammar-file", "{tmp}/g.gbnf"],
    "schema": ["--json-schema", '{"type": "object", "properties": {"n": {"type": "integer"}}, '
               '"required": ["n"]}'],
    "enum": ["--json-schema", '{"type": "string", "enum": ["yes", "no"]}'],
}


@pytest.mark.parametrize("case", sorted(GRAMMAR_CASES))
def test_cli_grammar_prints_the_reference_text(case, spm_gguf, tmp_path, capsys):
    """Under a grammar (GBNF, %regex, a grammar file) or a JSON schema the
    port prints llm_tpu's text at temp 0: the grammar constrains the
    generated text through the same resample rule on both sides."""
    (tmp_path / "g.gbnf").write_text('root ::= [a-c]+ " " [x-z]+')
    extra = [a.replace("{tmp}", str(tmp_path)) for a in GRAMMAR_CASES[case]]
    argv = ["-m", spm_gguf, "--f32", "-c", "64", "-p", "Answer:", "-n", "10", "--temp", "0",
            "--device", "cpu", *extra]
    want, werr = _run(jax_cli.main, argv, capsys)
    got, gerr = _run(cli.main, argv, capsys)
    assert got == want and len(got) > len("Answer:")
    assert _untimed(gerr) == _untimed(werr)


@pytest.mark.parametrize("vals", [(0.0, 0.0, 0.0, 0, 0), (1234.5, 56.7, 890.1, 17, 21),
                                  (12.0, 3.0, 0.0, 5, 0)])
def test_perf_summary_text_is_the_reference(vals):
    keys = ("t_load_ms", "t_prefill_ms", "t_decode_ms", "n_prefill", "n_decode")
    assert PerfCounters(**dict(zip(keys, vals))).summary() == \
        JaxPerfCounters(**dict(zip(keys, vals))).summary()


def test_perf_counts_as_the_reference(spm_gguf):
    """A prefill counts its tokens as prefill; a one-token decode and every
    token of generate_loop count as decode; the times are positive."""
    ref = JaxContext(JaxGGUFReader(spm_gguf), n_cells=64, dtype=jnp.float32)
    ctx = Context(GGUFReader(spm_gguf), n_cells=64, dtype=torch.float32, device="cpu")
    assert ctx.rslots is None and ctx.perf.t_load_ms > 0
    for c, B in ((ref, JaxBatch), (ctx, Batch)):
        assert c.decode(B.text([1, 5, 9, 13, 20])) == 0
        assert c.decode(B.one(7, pos=5)) == 0
        c.generate_loop(8, 6)
    for k in ("n_prefill", "n_decode"):
        assert getattr(ctx.perf, k) == getattr(ref.perf, k)
    assert (ctx.perf.n_prefill, ctx.perf.n_decode) == (5, 7)
    assert ctx.perf.t_prefill_ms > 0 and ctx.perf.t_decode_ms > 0


def test_generate_matches_decode_and_generate_loop(bpe_gguf):
    """cli.generate's greedy fast path gives the tokens of Context.decode of
    the prompt followed by generate_loop, called directly (chip_smoke.py
    holds the same on the 8B file)."""
    from llm_tpu_torch.samplers import SamplingParams
    from llm_tpu_torch.tokenizers import tokenizer_from_gguf

    reader = GGUFReader(bpe_gguf)
    tok = tokenizer_from_gguf(reader)
    ctx = Context(reader, n_cells=128, dtype=torch.float32, device="cpu")
    prompt = tok.encode("the quick brown fox jumps over the lazy dog", add_special=True,
                        parse_special=True)
    got, text = cli.generate(ctx, tok, prompt, 40, SamplingParams(temp=0.0))
    ctx.clear()
    assert ctx.decode(Batch.text(prompt)) == 0
    first = int(np.argmax(ctx.get_logits()))
    eogs = (tok.vocab.eos_id, tok.vocab.eot_id)
    want = [first] + ctx.generate_loop(first, 39, eog_ids=eogs)
    assert got == want[:len(got)] and len(got) == 40
    assert text == "".join(tok.piece(t) for t in got)


@pytest.mark.parametrize("name", ["prompt.state", "prompt.npz"])
def test_prompt_cache_round_trip(bpe_gguf, tmp_path, capsys, name):
    """The second run reuses the saved prompt and prints the same text. numpy
    saves "prompt.state" as "prompt.state.npz": the port looks for that name
    too, where llm_tpu's CLI never finds its cache (ROADMAP, "Faults in the
    reference")."""
    cache = str(tmp_path / name)
    argv = ["-m", bpe_gguf, "--f32", "-p", "the quick brown", "-n", "8", "--temp", "0",
            "-c", "64", "--device", "cpu", "--prompt-cache", cache]
    first, err1 = _run(cli.main, argv, capsys)
    assert err1[-1] == f"prompt cache saved to {cache}"
    second, err2 = _run(cli.main, argv, capsys)
    assert second == first
    reused = [int(m.group(1)) for e in err2
              for m in [re.fullmatch(r"prompt cache: reusing (\d+) tokens", e)] if m]
    assert reused and reused[0] > 0  # all of the prompt but its last token


def test_profile_writes_a_trace(spm_gguf, tmp_path, capsys):
    out = tmp_path / "prof"
    _, err = _run(cli.main, ["-m", spm_gguf, "-p", "ab", "-n", "2", "--temp", "0",
                             "--device", "cpu", "--profile", str(out)], capsys)
    assert (out / "trace.json").stat().st_size > 0
    assert err[-1] == f"profiler trace written to {out}"


@pytest.mark.parametrize("extra,item", [
    (["--control-vector-layer-range", "0", "1"], "Queue 1 item 9.1"),
    (["-sp", "2"], "Queue 1 item 10"), (["--platform", "cpu"], "Queue 1 item 10"),
    (["--lora", "a.gguf"], "Queue 1 item 9.1"),
    (["--control-vector", "c.gguf"], "Queue 1 item 9.1"), (["-tp", "2"], "Queue 1 item 10")])
def test_unported_options_exit_naming_the_roadmap(spm_gguf, extra, item, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["-m", spm_gguf, "--device", "cpu", *extra])
    assert e.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


def moe_gguf_with_vocab(path: str) -> str:
    """A tiny qwen3moe (test_torch_moe.py's hf_moe geometry: 4 experts of
    48, 2 a token) with tests/test_tools.py's SPM vocab, converted by
    llm_tpu's convert_hf_llama."""
    transformers = pytest.importorskip("transformers")
    from test_tools import _test_vocab

    from llm_tpu.convert.hf_llama import convert_hf_llama

    cfg = transformers.Qwen3MoeConfig(
        vocab_size=97, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0, tie_word_embeddings=False, moe_intermediate_size=48, head_dim=16,
        num_experts=4, num_experts_per_tok=2, norm_topk_prob=True, decoder_sparse_step=1)
    torch.manual_seed(0)
    convert_hf_llama(transformers.Qwen3MoeForCausalLM(cfg).eval(), path, arch="qwen3moe",
                     vocab=_test_vocab(97))
    return path


@pytest.mark.parametrize("extra", [["--no-planes"], ["--ep-capacity-factor", "0.5"]],
                         ids=["no-planes", "ep-capacity-factor"])
def test_load_options_print_the_reference_text(extra, bpe_gguf, tmp_path, monkeypatch,
                                               capsys):
    """--no-planes (every quantized matrix dequantized to dense at load) on
    the Q4_K_M file, and --ep-capacity-factor 0.5 on a tiny qwen3moe whose
    30-token prompt is one step of more than 8 tokens, so that the cap of
    8 tokens an expert drops assignments: the port prints llm_tpu's text
    and stderr. (llm_tpu's CLI hands the factor on through LLM_TPU_EP_CF,
    restored after the test.)"""
    monkeypatch.setenv("LLM_TPU_EP_CF", "0")
    path = bpe_gguf if extra[0] == "--no-planes" else \
        moe_gguf_with_vocab(str(tmp_path / "moe.gguf"))
    argv = ["-m", path, "--f32", "-c", "64", "-p", "the quick brown fox jumps over a lazy",
            "-n", "12", "--temp", "0", "--device", "cpu", *extra]
    want, werr = _run(jax_cli.main, argv, capsys)
    got, gerr = _run(cli.main, argv, capsys)
    assert got == want and len(got) > len("the quick brown fox jumps over a lazy")
    assert _untimed(gerr) == _untimed(werr)


def test_default_device_needs_a_card(spm_gguf, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(SystemExit) as e:
        cli.main(["-m", spm_gguf, "-p", "ab", "-n", "2"])
    assert e.value.code != 0
    assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [[], ["--ids"], ["--no-bos"], ["--no-parse-special"]])
@pytest.mark.parametrize("model", ["spm", "bpe"])
def test_tokenize_cli_prints_the_reference_text(model, extra, spm_gguf, bpe_gguf, capsys):
    path = spm_gguf if model == "spm" else bpe_gguf
    argv = ["-m", path, "-p", "Hello, World! <|eot_id|> it's 42", *extra]
    want = _run(jax_tokenize_cli.main, argv, capsys)
    got = _run(tokenize_cli.main, argv, capsys)
    assert got == want
