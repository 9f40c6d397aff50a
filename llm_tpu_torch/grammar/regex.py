"""Regex-constrained decoding: translate a practical regex subset to GBNF
and ride the existing pushdown grammar engine.

The reference gates this capability behind the optional llguidance library
(common/llguidance.cpp, grammar strings starting with "%llguidance";
docs/llguidance.md): lark grammars + regexes + JSON schemas compiled to
token masks. Our GBNF engine already covers grammars and JSON schemas, so
the missing piece is regex: `%regex <pattern>` grammar strings (full-match
semantics, like llguidance's regex mode).

Supported: literals, escapes (\\d \\w \\s \\D \\W \\S \\n \\t \\r \\xhh and
escaped metachars), ".", character classes (incl. negation, ranges, class
escapes), groups (incl. non-capturing), alternation, ?/*/+/{m}/{m,}/{m,n}
quantifiers, and ^/$ anchors at the pattern edges (implied; mid-pattern
anchors, backrefs and lookaround are rejected).
"""

from __future__ import annotations

CLASS_ESCAPES = {
    "d": "0-9",
    "w": "0-9A-Za-z_",
    "s": " \\t\\n\\r",
}
NEG_CLASS = {"D": "d", "W": "w", "S": "s"}
SIMPLE = {"n": "\\n", "t": "\\t", "r": "\\r"}
META = set(r".^$*+?{}[]()|\/")


class RegexError(ValueError):
    pass


class _Rx:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str):
        raise RegexError(f"{msg} at pos {self.i} in {self.p!r}")

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    # -- literals --------------------------------------------------------

    @staticmethod
    def _lit(ch: str) -> str:
        """A single literal char as a GBNF quoted string."""
        if ch == '"':
            return '"\\""'
        if ch == "\\":
            return '"\\\\"'
        if ch == "\n":
            return '"\\n"'
        if ch == "\t":
            return '"\\t"'
        if ch == "\r":
            return '"\\r"'
        return f'"{ch}"'

    def _escape_atom(self) -> str:
        """After a backslash: return the GBNF atom for the escape."""
        c = self.peek()
        if not c:
            self.error("dangling backslash")
        self.i += 1
        if c in CLASS_ESCAPES:
            return f"[{CLASS_ESCAPES[c]}]"
        if c in NEG_CLASS:
            return f"[^{CLASS_ESCAPES[NEG_CLASS[c]]}]"
        if c in SIMPLE:
            return f'"{SIMPLE[c]}"'
        if c == "x":
            h = self.p[self.i:self.i + 2]
            if len(h) != 2:
                self.error("bad \\x escape")
            self.i += 2
            return self._lit(chr(int(h, 16)))
        if c in META or not c.isalnum():
            return self._lit(c)
        self.error(f"unsupported escape \\{c}")

    def _class_atom(self) -> str:
        """A [...] class, translated to a GBNF class."""
        out = ["["]
        if self.peek() == "^":
            out.append("^")
            self.i += 1
        if self.peek() == "]":  # leading ] is literal in regex
            out.append("\\]")
            self.i += 1
        while True:
            c = self.peek()
            if not c:
                self.error("unterminated class")
            if c == "]":
                self.i += 1
                break
            self.i += 1
            if c == "\\":
                e = self.peek()
                self.i += 1
                if e in CLASS_ESCAPES:
                    out.append(CLASS_ESCAPES[e])
                    continue
                if e in NEG_CLASS:
                    self.error(f"\\{e} inside a class is unsupported")
                if e in SIMPLE:
                    out.append(SIMPLE[e])
                    continue
                if e == "x":
                    h = self.p[self.i:self.i + 2]
                    if len(h) != 2:
                        self.error("bad \\x escape")
                    self.i += 2
                    ch = chr(int(h, 16))
                    out.append("\\" + ch if ch in "]\\^-" else ch)
                    continue
                out.append("\\" + e if e in "]\\^-" else e)
                continue
            if c in "]\\":
                out.append("\\" + c)
            else:
                out.append(c)
        out.append("]")
        return "".join(out)

    # -- grammar ---------------------------------------------------------

    def _atom(self) -> str | None:
        c = self.peek()
        if not c or c in "|)":
            return None
        if c in "*+?{":
            self.error(f"quantifier {c!r} with nothing to repeat")
        self.i += 1
        if c == ".":
            return "[^\\n]"  # regex . excludes newline
        if c == "\\":
            return self._escape_atom()
        if c == "[":
            return self._class_atom()
        if c == "(":
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2
            elif self.peek() == "?":
                self.error("lookaround/named groups unsupported")
            inner = self._alternates()
            if self.peek() != ")":
                self.error("unterminated group")
            self.i += 1
            return f"({inner})"
        if c in "^$":
            self.error("mid-pattern anchors unsupported")
        return self._lit(c)

    def _quantifier(self) -> str:
        c = self.peek()
        if c and c in "*+?":
            self.i += 1
            return c
        if c == "{":
            j = self.p.find("}", self.i)
            if j < 0:
                self.error("unterminated {m,n}")
            body = self.p[self.i + 1:j]
            parts = body.split(",")
            ok = all(p.strip().isdigit() or p.strip() == "" for p in parts)
            if not ok or len(parts) > 2 or not parts[0].strip():
                self.error(f"bad quantifier {{{body}}}")
            self.i = j + 1
            return "{" + body + "}"
        return ""

    def _sequence(self) -> str:
        atoms = []
        while True:
            a = self._atom()
            if a is None:
                break
            q = self._quantifier()
            if q and self.peek() and self.peek() in "*+?":
                self.error("double quantifier (possessive/lazy unsupported)")
            atoms.append(a + q)
        return " ".join(atoms) if atoms else '""'

    def _alternates(self) -> str:
        alts = [self._sequence()]
        while self.peek() == "|":
            self.i += 1
            alts.append(self._sequence())
        return " | ".join(alts)


def regex_to_gbnf(pattern: str) -> str:
    """Full-match GBNF grammar for `pattern` (root rule)."""
    if pattern.startswith("^"):
        pattern = pattern[1:]
    if pattern.endswith("$") and not pattern.endswith("\\$"):
        pattern = pattern[:-1]
    rx = _Rx(pattern)
    body = rx._alternates()
    if rx.i != len(rx.p):
        rx.error("unbalanced ')'")
    return f"root ::= {body}\n"
