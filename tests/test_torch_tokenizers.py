"""The port's tokenizers (llm_tpu_torch/tokenizers) against llm_tpu's on the
same vocabularies: token ids, pieces and detokenized text exactly equal.

Vocabularies made in the test: tests/test_tools.py::_test_vocab (SPM) in a
GGUF written by llm_tpu's convert_hf_llama; byte-level BPE vocabularies
(the port's tools/synth_gguf.py::bpe_vocab) under several pre-tokenizers;
a WPM (bert) vocab; the UGM and RWKV cases of tests/test_tokenizers.py.
The pre-tokenizer: for every PRE_PATTERNS key, the port's patterns
compiled by the standard `re` (uclass.translate) split a fixed
multilingual text exactly as llm_tpu's compiled by `regex`. `\\s` is held on
U+001C..U+001F, where str.isspace() and Unicode's White_Space part.

Code points assigned after Unicode 15.0 (Python 3.12's unicodedata) are in
no \\p{..} class of the port, where the installed `regex` may know them:
test_later_unicode_is_counted states how many there are (ROADMAP,
"Deliberate differences"). The text here holds none of them."""

import re
import sys
import unicodedata

import numpy as np
import pytest
import regex

from llm_tpu.gguf.constants import Keys as JaxKeys
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.gguf.writer import GGUFWriter as JaxGGUFWriter
from llm_tpu.tokenizers import tokenizer_from_gguf as jax_tokenizer_from_gguf
from llm_tpu.tokenizers import tokenizer_from_vocab as jax_tokenizer_from_vocab
from llm_tpu.tokenizers.bpe import PRE_PATTERNS as JAX_PRE_PATTERNS
from llm_tpu.tokenizers.rwkv import unescape_rwkv_token as jax_unescape_rwkv_token
from llm_tpu.tokenizers.vocab import Vocab as JaxVocab

from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.tokenizers import tokenizer_from_gguf, tokenizer_from_vocab
from llm_tpu_torch.tokenizers.bpe import PRE_PATTERNS
from llm_tpu_torch.tokenizers.rwkv import unescape_rwkv_token
from llm_tpu_torch.tokenizers.uclass import WHITE_SPACE, class_ranges, translate
from llm_tpu_torch.tokenizers.vocab import Vocab
from llm_tpu_torch.tools.synth_gguf import bpe_vocab

TEXT = ("Hello, World! It's 2024-06-01; don't WORRY'LL ca'nt 12345678 ½ ³ ٣٤ ‱\n\n"
        "  Grüße aus Köln — ça va? Ĳssel ǅemal ſtraße İstanbul ΣΊΣΥΦΟΣ σοφός\r\n"
        "Привет, мир! 日本語のテキスト、漢字と仮名。中文：你好，世界。한국어 텍스트\t\t"
        "हिन्दी भाषा ، العربية: مرحبا بالعالم ۔ עברית 😀👍🏽 emoji‍ é a⃝ "
        "x\u001cy\u001f z\u0085w v u　 <sentinel:12> IMGIMGABZ    code()  {x}  "
        "def f(x):\n    return x**2  # comment\n$100 + <=> ^~| `tick` ...!!! ??")

TEXTS = ["", " ", "Hello world", "  leading and trailing  ", "the quick brown fox.\n\nNew line",
         "I'm 42 years old, it's 3.14159!", "tab\there and  double  spaces", TEXT,
         "<|begin_of_text|>special <|eot_id|> tokens<s></s>"]


@pytest.mark.parametrize("key", sorted(JAX_PRE_PATTERNS))
def test_pre_tokenizer_splits_equal_regex(key):
    """Every pattern of the pre-tokenizer `key`, as the port compiles it
    with `re`, matches the same spans of TEXT as llm_tpu's compiled by
    `regex`, and the patterns are llm_tpu's."""
    assert PRE_PATTERNS[key] == JAX_PRE_PATTERNS[key]
    for p in PRE_PATTERNS[key]:
        want = [m.span() for m in regex.finditer(p, TEXT)]
        got = [m.span() for m in re.finditer(translate(p), TEXT)]
        assert got == want, p


def test_whitespace_class_is_unicode_white_space():
    """`re`'s \\s follows str.isspace(), which takes U+001C..U+001F;
    Unicode's White_Space (regex's \\s) does not. The port's \\s is built
    from White_Space and agrees with regex at every code point."""
    ws = set(c for a, b in WHITE_SPACE for c in range(a, b + 1))
    for c in range(0x1C, 0x20):
        assert chr(c).isspace() and re.match(r"\s", chr(c))
        assert not regex.match(r"\s", chr(c)) and c not in ws
    rs, ps = regex.compile(r"\s"), re.compile(translate(r"\s"))
    for c in list(range(0x3100)) + [0xFEFF, 0x205F, 0x3000, 0x10000]:
        assert bool(rs.match(chr(c))) == bool(ps.match(chr(c))), hex(c)


def test_later_unicode_is_counted():
    """The code points where the port's \\p{L}, \\p{N}, \\p{P}, \\p{S} or
    \\p{M} (Unicode 15.0, unicodedata) and the installed regex's disagree are
    all unassigned in Unicode 15.0: code points that later versions
    assigned. Their count is what ROADMAP's "Deliberate differences" states
    for this regex and Python."""
    assert unicodedata.unidata_version == "15.0.0"
    cls = {k: (regex.compile(r"\p{%s}" % k), re.compile(f"[{class_ranges(k)}]"))
           for k in ("L", "N", "P", "S", "M")}
    differ = set()
    for c in range(sys.maxunicode + 1):
        ch = chr(c)
        for r, p in cls.values():
            if bool(r.match(ch)) != bool(p.match(ch)):
                differ.add(c)
                break
    assert all(unicodedata.category(chr(c)) == "Cn" for c in differ)
    assert len(differ) < 12000, len(differ)
    print(f"code points split differently from regex: {len(differ)}")


def test_translate_keeps_what_it_does_not_know():
    assert translate(r"\p{L}+") == f"[{class_ranges('L')}]+"
    assert translate(r"[^\s\p{N}]") == f"[^{class_ranges('s')}{class_ranges('N')}]"
    assert translate(r"\s+(?!\S)") == f"[{class_ranges('s')}]+(?![^{class_ranges('s')}])"
    assert translate(r"\d{3}\\p\[x\]") == r"\d{3}\\p\[x\]"
    with pytest.raises(ValueError):
        translate(r"\p{Xx}")


def _write(path, kv, writer=JaxGGUFWriter):
    w = writer(path, arch="llama")
    for k, v in kv.items():
        w.add_kv(k, v)
    w.add_tensor("dummy", np.zeros(4, np.float32))
    w.write()


def _both(path):
    return (jax_tokenizer_from_gguf(JaxGGUFReader(path)),
            tokenizer_from_gguf(GGUFReader(path)))


def _special_kwargs(tok):
    """decode/piece's `special` settings, where the tokenizer takes one."""
    import inspect

    if "special" in inspect.signature(tok.decode).parameters:
        return [dict(special=False), dict(special=True)]
    return [{}]


def _assert_same(ref, tok, texts=TEXTS):
    for text in texts:
        for add_special in (True, False):
            for parse_special in (True, False):
                want = ref.encode(text, add_special=add_special, parse_special=parse_special)
                got = tok.encode(text, add_special=add_special, parse_special=parse_special)
                assert got == want, (text, add_special, parse_special)
        ids = ref.encode(text, add_special=True, parse_special=True)
        for kw in _special_kwargs(ref):
            assert tok.decode(ids, **kw) == ref.decode(ids, **kw)
            assert [tok.piece(t, **kw) for t in ids] == [ref.piece(t, **kw) for t in ids]
    n = len(ref.vocab.tokens)
    sample = list(range(min(n, 300))) + list(range(max(0, n - 300), n))
    assert tok.decode(sample) == ref.decode(sample)


def test_spm_vocab_from_the_converter_matches(tmp_path):
    """tests/test_tools.py's SPM vocab in a GGUF written by llm_tpu's HF
    converter: the same ids, pieces and text."""
    import sys as _sys
    _sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    transformers = pytest.importorskip("transformers")
    from test_model_vs_hf import _tiny_hf_llama
    from test_tools import _test_vocab

    from llm_tpu.convert.hf_llama import convert_hf_llama

    del transformers
    path = str(tmp_path / "spm.gguf")
    convert_hf_llama(_tiny_hf_llama(hidden=64, layers=1, vocab=97), path,
                     vocab=_test_vocab(97))
    ref, tok = _both(path)
    assert type(tok).__name__ == "SpmTokenizer"
    _assert_same(ref, tok, TEXTS[:7] + ["the quick brown", "Hello, World! 123 ?!"])


@pytest.mark.parametrize("pre", ["llama-bpe", "gpt2", "qwen2", "gpt-4o", "deepseek-v3",
                                 "falcon", "chameleon", "bailingmoe", "superbpe"])
def test_bpe_vocab_matches(tmp_path, pre):
    """A byte-level BPE vocab of 4096 tokens (256 bytes, merges, Llama 3's
    256 specials) under pre-tokenizer `pre`, in a GGUF each package reads
    with its own reader."""
    path = str(tmp_path / "bpe.gguf")
    _write(path, bpe_vocab(4096, seed=7, pre=pre))
    ref, tok = _both(path)
    assert type(tok).__name__ == "BpeTokenizer"
    _assert_same(ref, tok)


def test_llama3_width_bpe_vocab_matches(tmp_path):
    """The chip check's vocab: 128256 tokens, the specials at 128000.. ."""
    kv = bpe_vocab(128256, seed=0)
    assert kv[JaxKeys.Tokenizer.LIST][128000] == "<|begin_of_text|>"
    assert kv[JaxKeys.Tokenizer.LIST][128009] == "<|eot_id|>"
    path = str(tmp_path / "bpe128k.gguf")
    _write(path, kv)
    ref, tok = _both(path)
    _assert_same(ref, tok, TEXTS[2:])


def _wpm_kv():
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world", "▁hello",
            "▁world", "##s", "▁the", "▁quick", "qu", "##ick", "▁brown", ".", "▁.", "▁,", ","]
    toks += [f"▁{c}" for c in "abcdefghijklmnopqrstuvwxyz"] + list("abcdefghijklmnopqrstuvwxyz")
    K = JaxKeys.Tokenizer
    types = np.ones(len(toks), np.int32)
    types[:5] = 3
    return {K.MODEL: "bert", K.LIST: toks, K.TOKEN_TYPE: types, K.BOS_ID: 2, K.EOS_ID: 3,
            K.UNK_ID: 1, K.SEP_ID: 3, K.PAD_ID: 0, K.ADD_BOS: True, K.ADD_EOS: True}


def test_wpm_vocab_matches(tmp_path):
    path = str(tmp_path / "wpm.gguf")
    _write(path, _wpm_kv())
    ref, tok = _both(path)
    assert type(tok).__name__ == "WpmTokenizer"
    _assert_same(ref, tok, ["hello world", "Hello Worlds.", "the quick brown, fox",
                            "Ünïcödé hello", "xyz qu"])


def _ugm_pair(tokens_scores, charsmap=b"", **kw):
    toks = ["<unk>"] + [t for t, _ in tokens_scores]
    scores = np.asarray([0.0] + [s for _, s in tokens_scores], np.float32)
    types = np.asarray([2] + [1] * len(tokens_scores), np.int32)
    args = dict(model="t5", pre="default", tokens=toks, scores=scores, types=types,
                unk_id=0, add_space_prefix=kw.get("add_space_prefix", True),
                remove_extra_whitespaces=kw.get("remove_extra_whitespaces", True),
                precompiled_charsmap=charsmap)
    return (jax_tokenizer_from_vocab(JaxVocab(**args)),
            tokenizer_from_vocab(Vocab(**args)))


def _tiny_xcda(prefix: bytes, replacement: bytes) -> bytes:
    """tests/test_tokenizers.py's 1-rule XCDA charsmap: prefix -> replacement."""
    import struct

    c = prefix[0]
    nodes = [0] * 128
    root_base = 8
    nodes[0] = root_base << 10
    child = root_base ^ c
    value_node = 100
    nodes[child] = ((child ^ value_node) << 10) | (1 << 8) | c
    nodes[value_node] = 1 << 31
    blob = struct.pack("<I", len(nodes) * 4) + struct.pack(f"<{len(nodes)}I", *nodes)
    return blob + replacement + b"\0"


@pytest.mark.parametrize("case", ["viterbi", "penalized", "unknowns", "spaces", "charsmap"])
def test_ugm_cases_match(case):
    """tests/test_tokenizers.py:117-193's UGM cases, through both packages."""
    vocab, text = {
        "viterbi": ([("▁ab", -1.0), ("▁a", -2.0), ("b", -2.0), ("▁", -3.0)], "ab"),
        "penalized": ([("▁ab", -10.0), ("▁a", -2.0), ("b", -2.0)], "ab"),
        "unknowns": ([("▁a", -1.0)], "a xyz"),
        "spaces": ([("▁a", -1.0), ("▁b", -1.0), ("▁", -1.0)], "a  b"),
        "charsmap": ([("▁b", -1.0)], "A"),
    }[case]
    ref, tok = _ugm_pair(vocab, _tiny_xcda(b"A", b"b") if case == "charsmap" else b"")
    for t in (text, text + " " + text, "  " + text):
        assert tok.encode(t, add_special=False) == ref.encode(t, add_special=False)
    ids = ref.encode(text, add_special=False)
    assert tok.decode(ids) == ref.decode(ids)


def test_rwkv_cases_match():
    """tests/test_tokenizers.py's RWKV cases: the escapes and the greedy
    longest match over a byte trie."""
    for s in ("ab", "\\n\\t\\r\\\\", "\\xc3\\xa9"):
        assert unescape_rwkv_token(s) == jax_unescape_rwkv_token(s)
    toks = ["<unk>", "a", "ab", "abc", "b", "c", " ", "\\n"]
    args = dict(model="rwkv", pre="default", tokens=toks,
                scores=np.zeros(len(toks), np.float32),
                types=np.asarray([2] + [1] * (len(toks) - 1), np.int32), unk_id=0)
    ref = jax_tokenizer_from_vocab(JaxVocab(**args))
    tok = tokenizer_from_vocab(Vocab(**args))
    for text in ("abcab", "ab c\na", "abcabcx", "cba  a", ""):
        ids = ref.encode(text, add_special=False)
        assert tok.encode(text, add_special=False) == ids
        assert tok.decode(ids) == ref.decode(ids)
