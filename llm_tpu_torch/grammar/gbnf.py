"""GBNF grammar engine: parser + pushdown-automaton matcher.

Parity target: the reference's grammar engine
(llama.cpp's src/llama-grammar.cpp/h): the GBNF dialect (rules,
alternates, groups, ?/*/+/{m,n} repetition, char classes, literals),
codepoint-level matching over a set of pushdown stacks
(llama_grammar_accept, llama-grammar.h:72), candidate-token filtering, and
lazy grammars with trigger tokens/patterns (llama-grammar.h:124-132).

Independent implementation: rules are kept structured (alternates of atoms)
rather than the reference's flattened element arrays; a matcher state is a
frozenset of stacks, each stack a tuple of (rule, alt, idx) positions.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Char:
    """Character-class atom: tuple of (lo, hi) codepoint ranges."""

    ranges: tuple[tuple[int, int], ...]
    negated: bool = False

    def matches(self, cp: int) -> bool:
        hit = any(lo <= cp <= hi for lo, hi in self.ranges)
        return (not hit) if self.negated else hit


@dataclass(frozen=True)
class Ref:
    name: str


Atom = Char | Ref


class GrammarError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: dict[str, list[list[Atom]]] = {}
        self._gensym = 0

    # -- lexing helpers -------------------------------------------------------

    def _ws(self, newlines: bool = True):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t\r" or (newlines and c == "\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        start = self.pos
        while self._peek() and (self._peek().isalnum() or self._peek() in "-_"):
            self.pos += 1
        if start == self.pos:
            raise GrammarError(f"expected rule name at {self.pos}")
        return self.text[start : self.pos]

    def _expect(self, s: str):
        if not self.text.startswith(s, self.pos):
            raise GrammarError(f"expected {s!r} at pos {self.pos}")
        self.pos += len(s)

    def _escape(self) -> int:
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self.text[self.pos]
        self.pos += 1
        simple = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91, "]": 93, "/": 47}
        if e in simple:
            return simple[e]
        if e == "x":
            v = int(self.text[self.pos : self.pos + 2], 16)
            self.pos += 2
            return v
        if e == "u":
            v = int(self.text[self.pos : self.pos + 4], 16)
            self.pos += 4
            return v
        if e == "U":
            v = int(self.text[self.pos : self.pos + 8], 16)
            self.pos += 8
            return v
        raise GrammarError(f"bad escape \\{e}")

    # -- grammar productions ----------------------------------------------------

    def _new_rule(self, base: str, alts: list[list[Atom]]) -> str:
        self._gensym += 1
        name = f"{base}_{self._gensym}"
        self.rules[name] = alts
        return name

    def _atom(self, rule_name: str) -> list[Atom] | None:
        c = self._peek()
        if c == '"':
            self.pos += 1
            seq: list[Atom] = []
            while self._peek() != '"':
                if not self._peek():
                    raise GrammarError("unterminated string literal")
                cp = self._escape()
                seq.append(Char(((cp, cp),)))
            self.pos += 1
            return seq
        if c == "[":
            self.pos += 1
            negated = False
            if self._peek() == "^":
                negated = True
                self.pos += 1
            ranges = []
            while self._peek() != "]":
                if not self._peek():
                    raise GrammarError("unterminated char class")
                lo = self._escape()
                hi = lo
                if self._peek() == "-" and self.text[self.pos + 1] != "]":
                    self.pos += 1
                    hi = self._escape()
                ranges.append((lo, hi))
            self.pos += 1
            return [Char(tuple(ranges), negated)]
        if c == "(":
            self.pos += 1
            alts = self._alternates(rule_name)
            self._expect(")")
            return [Ref(self._new_rule(rule_name, alts))]
        if c and (c.isalnum() or c in "-_"):
            return [Ref(self._name())]
        if c == ".":
            self.pos += 1
            return [Char(((0, 0x10FFFF),))]
        return None

    def _repeat(self, rule_name: str, seq: list[Atom]) -> list[Atom]:
        """Apply a trailing ?/*/+/{m,n} operator to the last atom."""
        c = self._peek()
        if not c or c not in "?*+{":
            return seq
        target = [seq[-1]]
        rest = seq[:-1]
        if c == "?":
            self.pos += 1
            name = self._new_rule(rule_name, [target, []])
            return rest + [Ref(name)]
        if c == "*":
            self.pos += 1
            name = f"{rule_name}_star_{self._gensym + 1}"
            self._gensym += 1
            self.rules[name] = [target + [Ref(name)], []]
            return rest + [Ref(name)]
        if c == "+":
            self.pos += 1
            name = f"{rule_name}_plus_{self._gensym + 1}"
            self._gensym += 1
            self.rules[name] = [target + [Ref(name)], target]
            return rest + [Ref(name)]
        # {m}, {m,}, {m,n}
        self.pos += 1
        start = self.pos
        while self._peek() and self._peek() not in "},":
            self.pos += 1
        m = int(self.text[start : self.pos] or "0")
        n = None
        if self._peek() == ",":
            self.pos += 1
            start = self.pos
            while self._peek() != "}":
                self.pos += 1
            tail = self.text[start : self.pos].strip()
            n = int(tail) if tail else None
        else:
            n = m
        self._expect("}")
        out = rest + target * m
        if n is None:
            name = f"{rule_name}_star_{self._gensym + 1}"
            self._gensym += 1
            self.rules[name] = [target + [Ref(name)], []]
            out.append(Ref(name))
        else:
            for _ in range(n - m):
                name = self._new_rule(rule_name, [target, []])
                out.append(Ref(name))
        return out

    def _at_rule_end(self) -> bool:
        """A newline ends the rule only if what follows is a new rule
        definition or EOF (GBNF allows multi-line rule bodies)."""
        save = self.pos
        self._ws(newlines=True)
        end = not self._peek() or self._lookahead_rule_def()
        self.pos = save
        return end

    def _sequence(self, rule_name: str) -> list[Atom]:
        seq: list[Atom] = []
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c in ")|" or not c:
                break
            if c == "\n":
                if self._at_rule_end():
                    break
                self._ws(newlines=True)
                if self._peek() in ")|":
                    break
                continue
            if self._lookahead_rule_def():
                break
            atoms = self._atom(rule_name)
            if atoms is None:
                break
            seq.extend(atoms)
            self._ws(newlines=False)
            while self._peek() and self._peek() in "?*+{":
                seq = self._repeat(rule_name, seq)
        return seq

    def _lookahead_rule_def(self) -> bool:
        """Check if a new 'name ::=' starts here (rule boundary)."""
        save = self.pos
        try:
            if not (self._peek().isalnum() or self._peek() in "-_"):
                return False
            self._name()
            self._ws(newlines=False)
            return self.text.startswith("::=", self.pos)
        except GrammarError:
            return False
        finally:
            self.pos = save

    def _alternates(self, rule_name: str) -> list[list[Atom]]:
        alts = [self._sequence(rule_name)]
        while True:
            save = self.pos
            self._ws(newlines=True)
            if self._peek() == "|":
                self._expect("|")
                alts.append(self._sequence(rule_name))
            else:
                self.pos = save
                break
        return alts

    def parse(self) -> dict[str, list[list[Atom]]]:
        self._ws()
        while self.pos < len(self.text):
            name = self._name()
            self._ws(newlines=False)
            self._expect("::=")
            self._ws(newlines=False)
            alts = self._alternates(name)
            if name in self.rules:
                raise GrammarError(f"duplicate rule {name!r}")
            self.rules[name] = alts
            self._ws()
        # validate refs
        for rname, alts in self.rules.items():
            for alt in alts:
                for a in alt:
                    if isinstance(a, Ref) and a.name not in self.rules:
                        raise GrammarError(f"undefined rule {a.name!r} in {rname}")
        if "root" not in self.rules:
            raise GrammarError("grammar has no 'root' rule")
        return self.rules


def parse_gbnf(text: str) -> dict[str, list[list[Atom]]]:
    return _Parser(text).parse()


# ---------------------------------------------------------------------------
# Matcher (pushdown over stacks)
# ---------------------------------------------------------------------------

# a stack is a tuple of (rule_name, alt_idx, atom_idx) positions; the TOP of
# the stack is the last element


class Grammar:
    def __init__(self, rules: dict[str, list[list[Atom]]], root: str = "root"):
        self.rules = rules
        self.root = root
        self.stacks: frozenset = self._init_stacks()

    @classmethod
    def from_string(cls, text: str) -> "Grammar":
        return cls(parse_gbnf(text))

    def _init_stacks(self) -> frozenset:
        out = set()
        for ai in range(len(self.rules[self.root])):
            out |= self._close(((self.root, ai, 0),))
        return frozenset(out)

    def _close(self, stack: tuple) -> set:
        """Expand until the top atom is a Char (or the stack empties)."""
        while True:
            if not stack:
                return {stack}
            rule, ai, idx = stack[-1]
            alt = self.rules[rule][ai]
            if idx >= len(alt):
                stack = stack[:-1]
                # advancing the parent happens when we pushed; parents were
                # stored pre-advanced, so just continue closing
                continue
            atom = alt[idx]
            if isinstance(atom, Char):
                return {stack}
            # Ref: replace top with advanced position + push child alts
            base = stack[:-1] + ((rule, ai, idx + 1),)
            out = set()
            for cai in range(len(self.rules[atom.name])):
                out |= self._close(base + ((atom.name, cai, 0),))
            return out

    def _advance(self, stacks, cp: int) -> frozenset:
        out = set()
        for stack in stacks:
            if not stack:
                continue
            rule, ai, idx = stack[-1]
            atom = self.rules[rule][ai][idx]
            if atom.matches(cp):
                nxt = stack[:-1] + ((rule, ai, idx + 1),)
                out |= self._close(nxt)
        return frozenset(out)

    # -- public API ---------------------------------------------------------------

    def accept(self, cp: int) -> bool:
        nxt = self._advance(self.stacks, cp)
        if not nxt:
            return False
        self.stacks = nxt
        return True

    def accept_string(self, s: str) -> bool:
        for ch in s:
            if not self.accept(ord(ch)):
                return False
        return True

    def can_accept(self, s: str) -> bool:
        """Would this string keep the grammar alive (without mutating)?"""
        stacks = self.stacks
        for ch in s:
            stacks = self._advance(stacks, ord(ch))
            if not stacks:
                return False
        return True

    @property
    def can_end(self) -> bool:
        return any(len(s) == 0 for s in self.stacks)

    def copy(self) -> "Grammar":
        g = Grammar.__new__(Grammar)
        g.rules = self.rules
        g.root = self.root
        g.stacks = self.stacks
        return g

    def reset(self):
        self.stacks = self._init_stacks()
