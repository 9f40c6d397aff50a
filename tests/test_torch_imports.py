"""llm_tpu_torch and chip_smoke.py import neither jax nor llm_tpu, nor the
`regex`, `aiohttp` or `jinja2` packages (the card's machine has none: the
BPE pre-tokenizer and the grammar sampler run on the standard `re`, the
server on http.server, chat templates without Jinja). Checked
in a subprocess, because this test process already holds jax (conftest).
Every port module is imported, and so is every module that chip_smoke.py
imports inside its phases. Importing builds no kernel: that happens at
first launch, on the card."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import ast, importlib, pkgutil, sys
import llm_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(llm_tpu_torch.__path__, "llm_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"llm_tpu_torch.ops.cuda_qmm_chain", "llm_tpu_torch.tools.kbench",
        "llm_tpu_torch.ops.cuda_attn_probe", "llm_tpu_torch.tools.kbench_attn",
        "llm_tpu_torch.samplers.device", "llm_tpu_torch.runtime.speculative",
        "llm_tpu_torch.grammar.gbnf", "llm_tpu_torch.grammar.regex",
        "llm_tpu_torch.grammar.json_schema", "llm_tpu_torch.grammar.sampler",
        "llm_tpu_torch.server.core", "llm_tpu_torch.server.app", "llm_tpu_torch.server.chat",
        "llm_tpu_torch.server.toolcall", "llm_tpu_torch.server.webui",
        "llm_tpu_torch.parallel", "llm_tpu_torch.parallel.moe"} <= set(mods), mods
import chip_smoke
lazy = set()
for n in ast.walk(ast.parse(open(chip_smoke.__file__).read())):
    if isinstance(n, ast.ImportFrom) and (n.module or "").startswith("llm_tpu_torch"):
        lazy.add(n.module)
        lazy.update(f"{n.module}.{a.name}" for a in n.names if f"{n.module}.{a.name}" in mods)
assert {"llm_tpu_torch.ops.cuda_qmm_chain", "llm_tpu_torch.tools.profile_decode",
        "llm_tpu_torch.tools.kbench", "llm_tpu_torch.ops.cuda_attn_probe",
        "llm_tpu_torch.tools.kbench_attn"} <= lazy
for m in lazy:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules if m in ("jax", "llm_tpu", "regex", "aiohttp", "jinja2")
             or m.startswith(("jax.", "llm_tpu.", "aiohttp.", "jinja2.")))
assert not bad, bad
from llm_tpu_torch.ops import cuda_build
assert not cuda_build._libs, "a kernel library was loaded at import time"
print(len(mods))
"""


def test_port_imports_no_jax_or_llm_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 50  # every module was imported


def test_default_device_refuses_silent_cpu_fallback():
    import pytest
    import torch

    from llm_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits nonzero and prints no result line without a GPU."""
    import torch

    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_NO_REGEX = r"""
import sys
sys.modules["regex"] = None  # any `import regex` raises
from llm_tpu_torch.tokenizers import tokenizer_from_vocab
from llm_tpu_torch.tokenizers.bpe import PRE_PATTERNS, BpeTokenizer
from llm_tpu_torch.tokenizers.vocab import Vocab
from llm_tpu_torch.tools import cli, synth_gguf, tokenize_cli
from llm_tpu_torch.gguf.constants import Keys
kv = synth_gguf.bpe_vocab(1024, seed=1)
K = Keys.Tokenizer
for pre in sorted(PRE_PATTERNS):
    v = Vocab(model="gpt2", pre=pre, tokens=kv[K.LIST], scores=None, types=kv[K.TOKEN_TYPE],
              merges=kv[K.MERGES], bos_id=kv[K.BOS_ID], eos_id=kv[K.EOS_ID], add_bos=True)
    tok = tokenizer_from_vocab(v)
    assert isinstance(tok, BpeTokenizer)
    ids = tok.encode("Hello, World! It's 42 \u00e9t\u00e9 \u65e5\u672c 123456")
    assert tok.decode(ids, special=False).startswith("Hello, World!"), pre
print(len(PRE_PATTERNS))
"""


def test_tokenizers_need_no_regex_package():
    """With `regex` made unimportable, the port's tokenizers, CLI and GGUF
    tools import, and a byte-level BPE tokenizer round-trips text under
    every pre-tokenizer."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _NO_REGEX], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 40


_NO_SERVER_DEPS = r"""
import sys
for m in ("regex", "aiohttp", "jinja2"):
    sys.modules[m] = None  # any import of them raises
import numpy as np
from llm_tpu_torch.grammar import constrained_chain
from llm_tpu_torch.grammar.json_schema import json_schema_to_gbnf
from llm_tpu_torch.samplers import Chain
from llm_tpu_torch.samplers.chain import Greedy
from llm_tpu_torch.server import app, chat, core, toolcall
from llm_tpu_torch.server.app import _grammar_from_request


class V:
    def is_eog(self, t):
        return t == 0


class T:
    vocab = V()

    def piece(self, t, special=False):
        return ["", "yes", "no", "x"][t]


c = constrained_chain(Chain([Greedy()]), T(), grammar=_grammar_from_request(
    {"response_format": {"type": "json_schema", "json_schema": {"schema": {
        "type": "string", "enum": ["yes", "no"]}}}}))
assert c.gs.grammar is not None
c = constrained_chain(Chain([Greedy()]), T(), grammar="%regex yes|no")
assert c.sample(np.array([0.0, 1.0, 2.0, 9.0], np.float32)) == 2
assert chat.apply_template("{% for m in messages %}{% endfor %}", [
    {"role": "user", "content": "hi"}]) == "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n"
print("ok")
"""


def test_server_and_grammar_need_no_aiohttp_regex_or_jinja2():
    """With regex, aiohttp and jinja2 made unimportable, the server, the
    grammar (a response_format schema, a %regex constraint on the
    standard re) and the chat templates import and run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _NO_SERVER_DEPS], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"
