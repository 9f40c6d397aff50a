"""The port's grammar/ (its own copy: GBNF engine, JSON-schema and regex
converters, the grammar sampler on the standard `re`) against llm_tpu's on
tests/test_grammar.py's cases: equal accept and reject, equal GBNF text
from json_schema_to_gbnf and regex_to_gbnf, equal masks and resampled
tokens, and lazy trigger patterns with \\p{..} classes (which the port's
`re` takes through tokenizers/uclass.py)."""

import numpy as np
import pytest

from llm_tpu.grammar import constrained_chain as jax_constrained_chain
from llm_tpu.grammar.gbnf import Grammar as JaxGrammar
from llm_tpu.grammar.json_schema import json_schema_to_gbnf as jax_schema
from llm_tpu.grammar.regex import RegexError as JaxRegexError
from llm_tpu.grammar.regex import regex_to_gbnf as jax_regex
from llm_tpu.grammar.sampler import GrammarSampler as JaxGrammarSampler
from llm_tpu.samplers import Chain as JaxChain
from llm_tpu.samplers.chain import Greedy as JaxGreedy

from llm_tpu_torch.grammar import constrained_chain
from llm_tpu_torch.grammar.gbnf import Grammar, parse_gbnf
from llm_tpu_torch.grammar.json_schema import json_schema_to_gbnf
from llm_tpu_torch.grammar.regex import RegexError, regex_to_gbnf
from llm_tpu_torch.grammar.sampler import GrammarSampler
from llm_tpu_torch.samplers import Chain
from llm_tpu_torch.samplers.chain import Candidates, Greedy

JSON_GBNF = """
root ::= value
value ::= object | array | string | number | boolean | null
object ::= "{" ws ( string ":" ws value ("," ws string ":" ws value)* )? "}" ws
array ::= "[" ws ( value ("," ws value)* )? "]" ws
string ::= "\\"" ([^"\\\\] | "\\\\" .)* "\\"" ws
number ::= "-"? [0-9]+ ("." [0-9]+)? ws
boolean ::= ("true" | "false") ws
null ::= "null" ws
ws ::= [ \\t\\n]*
"""

# (grammar, text): test_grammar.py's accept / reject cases
ACCEPT_CASES = [
    ('root ::= "yes" | "no"', s) for s in ("yes", "no", "maybe", "ye")
] + [
    ("root ::= [a-z0-9]+", "abc123"), ("root ::= [a-z0-9]+", "ABC"),
    ('root ::= [^"]* "\\""', 'hello"'),
    ('root ::= "a"? "b"', "b"), ('root ::= "a"? "b"', "ab"), ('root ::= "a"* "b"', "aaab"),
    ('root ::= "a"+ "b"', "ab"), ('root ::= "a"+ "b"', "b"),
    ('root ::= "a"{2,3}', "a"), ('root ::= "a"{2,3}', "aa"), ('root ::= "a"{2,3}', "aaa"),
    ('root ::= "a"{2,3}', "aaaa"),
    ('root ::= item ("," item)*\nitem ::= [a-z]+', "a,bc,def"),
    ('root ::= item ("," item)*\nitem ::= [a-z]+', "a,,b"),
    ('root ::= "hello world"', "hello"), ('root ::= "hello world"', "help"),
] + [(JSON_GBNF, d) for d in ('{"a": 1, "b": [true, null]}', '[1, 2, {"x": "y"}]',
                              '{"a": }', "{", '"unclosed')]


def _accepts(G, g_text, s):
    g = G.from_string(g_text)
    return (g.accept_string(s), g.can_end, G.from_string(g_text).can_accept(s))


@pytest.mark.parametrize("g_text,s", ACCEPT_CASES)
def test_accept_and_reject_as_the_reference(g_text, s):
    assert _accepts(Grammar, g_text, s) == _accepts(JaxGrammar, g_text, s)


def _parses(parse, text):
    try:
        parse(text)
        return "ok"
    except Exception as e:  # noqa: BLE001 - the refusal's kind is compared
        return type(e).__name__


@pytest.mark.parametrize("text", ["root ::= foo", 'notroot ::= "x"', 'root ::= "a" |',
                                  "root ::= [a-", 'root ::= "a" ("b"', "root ::= x\nx ::= [0-9]"])
def test_bad_grammars_rejected_as_the_reference(text):
    """Each text parses on both sides or is refused on both with the same
    kind of error (GrammarError; an IndexError at "[a-" on both)."""
    got, want = _parses(parse_gbnf, text), _parses(JaxGrammar.from_string, text)
    assert got == want


SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                                      "tags": {"type": "array", "items": {"type": "string"}}},
     "required": ["name", "age"]},
    {"enum": ["red", "green", 3]},
    {"anyOf": [{"type": "integer"}, {"type": "boolean"}]},
    {"type": "array", "items": {"type": "integer"}, "minItems": 2, "maxItems": 3},
    {"type": "string", "enum": ["yes", "no"]},
    {"type": "number"}, {}, {"const": {"a": [1, None]}},
    {"type": "object", "properties": {"v": {"type": "string", "minLength": 2, "maxLength": 4}},
     "additionalProperties": False},
]
DOCS = ['{"name": "bob", "age": 42, "tags": ["x", "y"]}', '{"age": 42}', '"red"', "3",
        '"blue"', "42", "true", "[1, 2]", "[1, 2, 3, 4]", '"yes"', '"no"', "-1.5e3",
        '{"a": [1, null]}', '{"v": "abc"}', '{"v": "a"}']


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_json_schema_gbnf_is_the_reference(i):
    """The same GBNF text, and the same verdict on every document."""
    text = json_schema_to_gbnf(SCHEMAS[i])
    assert text == jax_schema(SCHEMAS[i])
    for doc in DOCS:
        assert _accepts(Grammar, text, doc) == _accepts(JaxGrammar, text, doc), doc


REGEXES = {
    r"[a-z]+@[a-z]+\.(com|org)": ["ab@cd.com", "ab@cd.net", "a@b.org"],
    r"\d{3}-\d{4}": ["555-1234", "55-1234", "555-12345"],
    r"yes|no|maybe": ["yes", "maybe", "nope", "no"],
    r"(?:ab)+c?": ["ababc", "abab", "aab"],
    r"[^0-9]{2,}": ["xy", "x1", "xyz"],
    r"-?\d+(\.\d+)?": ["-3.14", "42", "4."],
    r".*": ["anything at all", ""],
    r"a\x41+": ["aAA", "a"],
    r"^start$": ["start", "startx"],
    r"\w+\s\w+": ["two words", "oneword"],
}


@pytest.mark.parametrize("pat", sorted(REGEXES))
def test_regex_gbnf_is_the_reference(pat):
    text = regex_to_gbnf(pat)
    assert text == jax_regex(pat)
    for s in REGEXES[pat]:
        assert _accepts(Grammar, text, s) == _accepts(JaxGrammar, text, s), s


@pytest.mark.parametrize("pat", [r"(?=look)", r"a^b", r"*oops", r"a{", r"(unclosed",
                                 r"[unclosed", r"a\q"])
def test_regex_refusals_are_the_reference(pat):
    with pytest.raises(JaxRegexError):
        jax_regex(pat)
    with pytest.raises(RegexError):
        regex_to_gbnf(pat)


class _Vocab:
    def __init__(self, eog):
        self.eog = eog

    def is_eog(self, tid):
        return tid == self.eog


class _Tok:
    """A toy tokenizer whose pieces cover the grammars below."""

    PIECES = ["", "yes", "no", "zz", "{", "}", '"', "a", "b", "1", "2", ":", " ", ",", "ye", "s",
              "n", "o", "[", "]", "true", "nul", "l", "é", "x"]

    def __init__(self):
        self.vocab = _Vocab(0)

    def piece(self, tid, special=False):
        return self.PIECES[tid]


GRAMMARS = ['root ::= "yes" | "no"', JSON_GBNF, "%regex [ab]+[12]?",
            json_schema_to_gbnf({"type": "array", "items": {"type": "integer"}})]


@pytest.mark.parametrize("gi", range(len(GRAMMARS)))
def test_masks_and_resampled_tokens_are_the_reference(gi):
    """Over 12 steps of seeded logits: the grammar sampler's mask of every
    candidate, and the greedy chain's pick under it (free sample, then the
    constrained resample), equal llm_tpu's; each step accepts the pick."""
    rng = np.random.default_rng(gi)
    V = len(_Tok.PIECES)
    ours = constrained_chain(Chain([Greedy()]), _Tok(), grammar=GRAMMARS[gi])
    ref = jax_constrained_chain(JaxChain([JaxGreedy()]), _Tok(), grammar=GRAMMARS[gi])
    for _ in range(12):
        logits = rng.normal(size=V).astype(np.float32) * 3
        assert [ours.gs.valid(t) for t in range(V)] == [ref.gs.valid(t) for t in range(V)]
        cur = Candidates.from_logits(logits)
        ours.gs.apply(cur)
        t = ours.sample(logits)
        assert t == ref.sample(logits)
        assert np.isfinite(cur.logits[t]) or not ours.gs.active
        ours.accept(t)
        ref.accept(t)
        if t == 0:
            break


@pytest.mark.parametrize("patterns,text,active", [
    ((r"\p{L}+:",), ["x", "é", ":"], True), ((r"\p{N}{2}",), ["1", "a", "2"], False),
    ((r"\p{N}{2}",), ["1", "2"], True), ((r"yes",), ["ye", "s"], True)])
def test_lazy_trigger_patterns_with_classes(patterns, text, active):
    """A lazy grammar turns on where a trigger pattern (\\p{..} classes
    included) matches the generated text, as llm_tpu's on `regex`."""
    tok = _Tok()
    ids = [tok.PIECES.index(p) for p in text]
    ours = GrammarSampler(Grammar.from_string('root ::= [a-z]*'), tok, lazy=True,
                          trigger_patterns=patterns)
    ref = JaxGrammarSampler(JaxGrammar.from_string('root ::= [a-z]*'), tok, lazy=True,
                            trigger_patterns=patterns)
    for t in ids:
        ours.accept(t)
        ref.accept(t)
    assert ours.active == ref.active == active
