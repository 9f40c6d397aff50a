"""Unicode property classes for the standard `re` module.

The pre-tokenizer patterns of bpe.py are the models' published ones,
written for engines that know `\\p{..}` (llama.cpp's own, the `regex`
package that llm_tpu uses). Python's `re` does not, and the port carries no
`regex`: `translate` rewrites a pattern for `re`, each `\\p{X}` becoming the
code point ranges of general category X, built once from `unicodedata`
(Unicode 15.0 in Python 3.12). Code points assigned in later Unicode
versions belong to no class here (ROADMAP, "Deliberate differences").

`\\s` and `\\S` are built explicitly too: `re`'s `\\s` follows
`str.isspace()`, which takes U+001C..U+001F (the information separators),
where Unicode's White_Space property, and so `regex`'s `\\s`, does not.
Python 3.12's `re` has the rest of what the patterns use: possessive
quantifiers, atomic groups and scoped `(?i:...)`. `\\d` is left to `re`
(decimal digits, category Nd, of the same Unicode version).
"""

from __future__ import annotations

import sys
import unicodedata
from functools import lru_cache

# Unicode's White_Space property (PropList.txt)
WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
               (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
               (0x3000, 0x3000))


def _esc(c: int) -> str:
    return f"\\u{c:04x}" if c <= 0xFFFF else f"\\U{c:08x}"


def _ranges_str(ranges) -> str:
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in ranges)


@lru_cache(maxsize=1)
def _categories() -> dict[str, list[tuple[int, int]]]:
    """{two-letter general category: [(first, last) code point ranges]}"""
    out: dict[str, list[tuple[int, int]]] = {}
    cat = unicodedata.category
    prev, start = None, 0
    for c in range(sys.maxunicode + 2):
        k = cat(chr(c)) if c <= sys.maxunicode else None
        if k != prev:
            if prev is not None:
                out.setdefault(prev, []).append((start, c - 1))
            prev, start = k, c
    return out


@lru_cache(maxsize=None)
def class_ranges(name: str) -> str:
    """The inside of a character class for `\\p{name}`: a general category
    (Lu, Nd, ...) or a major class (L, N, P, S, M, Z, C), or "s" for
    White_Space."""
    if name == "s":
        return _ranges_str(WHITE_SPACE)
    cats = _categories()
    keys = [k for k in cats if (k == name if len(name) == 2 else k[0] == name)]
    if not keys:
        raise ValueError(f"unknown Unicode class \\p{{{name}}}")
    ranges = sorted(r for k in keys for r in cats[k])
    merged: list[tuple[int, int]] = []
    for a, b in ranges:
        if merged and a == merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return _ranges_str(merged)


def translate(pattern: str) -> str:
    """`pattern` with every `\\p{X}`, `\\s` and `\\S` spelled out for `re`:
    inside a character class as the class's ranges, outside as a class of
    its own. Other escapes are kept as they are."""
    out = []
    i, depth, n = 0, False, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e == "p" and pattern.startswith("{", i + 2):
                j = pattern.index("}", i + 3)
                body = class_ranges(pattern[i + 3:j])
                out.append(body if depth else f"[{body}]")
                i = j + 1
                continue
            if e in "sS":
                if depth:
                    if e == "S":
                        raise ValueError("\\S inside a character class is not translated")
                    out.append(class_ranges("s"))
                else:
                    out.append(f"[{'^' if e == 'S' else ''}{class_ranges('s')}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not depth:
            depth = True
            out.append(c)
            i += 1
            # a leading ^ and a leading ] are part of the class's opening
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "]" and depth:
            depth = False
        out.append(c)
        i += 1
    return "".join(out)
