"""JSON schema -> GBNF grammar converter.

Parity target: llama.cpp's common/json-schema-to-grammar.cpp — the
feature subset that matters in practice: types (object/array/string/
number/integer/boolean/null), enum/const, properties + required +
additionalProperties, items/prefixItems, min/maxItems, anyOf/oneOf/allOf,
$ref into $defs/definitions, string min/maxLength and a few formats.
"""

from __future__ import annotations

import json

# shared primitive rules (mirror the converter's SPACE_RULE + PRIMITIVE_RULES)
PRIMITIVES = {
    "space": '" "?',
    "boolean": '("true" | "false") space',
    "null": '"null" space',
    "number": '("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": '("-"? ([0-9] | [1-9] [0-9]*)) space',
    "string": '"\\"" char* "\\"" space',
    "char": '[^"\\\\\\x7F\\x00-\\x1F] | [\\\\] (["\\\\bfnrt] | "u" [0-9a-fA-F]{4})',
    "value": "object | array | string | number | boolean | null",
    "object": '"{" space ( string ":" space value ("," space string ":" space value)* )? "}" space',
    "array": '"[" space ( value ("," space value)* )? "]" space',
}


class _Converter:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {"space": PRIMITIVES["space"]}
        self.refs = schema.get("$defs", schema.get("definitions", {}))
        self._n = 0

    def _prim(self, name: str) -> str:
        if name not in self.rules:
            self.rules[name] = PRIMITIVES[name]
            # pull in dependencies
            if name == "string":
                self._prim("char")
            if name in ("value", "object", "array"):
                for dep in ("object", "array", "string", "number", "boolean",
                            "null", "value"):
                    if dep not in self.rules:
                        self.rules[dep] = PRIMITIVES[dep]
                self._prim("char")
        return name

    def _add(self, hint: str, body: str) -> str:
        self._n += 1
        name = f"{hint}{self._n}"
        self.rules[name] = body
        return name

    @staticmethod
    def _lit(value) -> str:
        """A JSON literal as a quoted GBNF string."""
        s = json.dumps(value)
        out = s.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{out}"'

    def convert(self, schema, hint: str = "root") -> str:
        """Returns a GBNF expression (not a rule name) for this schema node."""
        if schema is True or schema == {}:
            return self._prim("value")
        if "$ref" in schema:
            ref = schema["$ref"]
            key = ref.split("/")[-1]
            rule_name = f"def-{key}"
            if rule_name not in self.rules:
                self.rules[rule_name] = "placeholder"
                self.rules[rule_name] = self.convert(self.refs[key], rule_name)
            return rule_name

        if "const" in schema:
            return f"{self._lit(schema['const'])} space"
        if "enum" in schema:
            alts = " | ".join(self._lit(v) for v in schema["enum"])
            return self._add(f"{hint}-enum", f"({alts}) space")

        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                alts = " | ".join(
                    self.convert(s, f"{hint}-alt") for s in schema[comb]
                )
                return self._add(f"{hint}-any", alts)
        if "allOf" in schema:
            merged: dict = {}
            for s in schema["allOf"]:
                if "$ref" in s:
                    s = self.refs[s["$ref"].split("/")[-1]]
                merged.update(s)
            return self.convert(merged, hint)

        t = schema.get("type")
        if isinstance(t, list):
            alts = " | ".join(self.convert({**schema, "type": x}, hint) for x in t)
            return self._add(f"{hint}-types", alts)

        if t == "object" or ("properties" in schema and t is None):
            return self._object(schema, hint)
        if t == "array":
            return self._array(schema, hint)
        if t == "string":
            return self._string(schema, hint)
        if t == "integer":
            return self._prim("integer")
        if t == "number":
            return self._prim("number")
        if t == "boolean":
            return self._prim("boolean")
        if t == "null":
            return self._prim("null")
        return self._prim("value")

    def _object(self, schema, hint: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        addl = schema.get("additionalProperties", not props)

        parts = []
        if props:
            items = []
            for key, sub in props.items():
                expr = self.convert(sub, f"{hint}-{key}")
                kv = f'{self._lit(key)} space ":" space {expr}'
                items.append((key, kv, key in required))
            # required keys in order; optional keys each wrapped
            seq = []
            first = True
            opt_started = False
            for key, kv, req in items:
                comma = '' if first else '"," space '
                if req:
                    seq.append(f"{comma}{kv}")
                    first = False
                else:
                    rn = self._add(f"{hint}-opt", f"{comma}{kv}")
                    seq.append(f"{rn}?")
                    opt_started = True
            body = " ".join(seq)
            if opt_started and all(not r for _, _, r in items):
                # all-optional objects: allow fully empty body
                parts.append(f'"{{" space ({body})? "}}" space')
            else:
                parts.append(f'"{{" space {body} "}}" space')
        elif addl:
            self._prim("value")
            self._prim("string")
            parts.append(
                '"{" space ( string ":" space value ("," space string ":" space value)* )? "}" space'
            )
        else:
            parts.append('"{" space "}" space')
        return self._add(f"{hint}-obj", " | ".join(parts))

    def _array(self, schema, hint: str) -> str:
        items = schema.get("items", True)
        min_items = int(schema.get("minItems", 0))
        max_items = schema.get("maxItems")
        expr = self.convert(items if items is not True else {}, f"{hint}-item")
        if min_items == 0 and max_items is None:
            body = f'"[" space ( {expr} ("," space {expr})* )? "]" space'
        else:
            reps = []
            for _ in range(max(min_items, 1) - 1):
                reps.append(f'"," space {expr}')
            head = expr if min_items > 0 else f"({expr})?"
            mid = " ".join(reps)
            if max_items is None:
                tail = f'("," space {expr})*'
            else:
                opt = max_items - max(min_items, 1)
                tail = " ".join([f'("," space {expr})?'] * max(0, opt))
            inner = " ".join(x for x in (head, mid, tail) if x)
            if min_items == 0:
                body = f'"[" space ( {inner} )? "]" space'
            else:
                body = f'"[" space {inner} "]" space'
        return self._add(f"{hint}-arr", body)

    def _string(self, schema, hint: str) -> str:
        fmt = schema.get("format")
        if fmt == "date":
            return self._add(
                f"{hint}-date",
                '"\\"" [0-9]{4} "-" [0-9]{2} "-" [0-9]{2} "\\"" space',
            )
        if fmt == "uuid":
            return self._add(
                f"{hint}-uuid",
                '"\\"" [0-9a-fA-F]{8} "-" [0-9a-fA-F]{4} "-" [0-9a-fA-F]{4} "-" '
                '[0-9a-fA-F]{4} "-" [0-9a-fA-F]{12} "\\"" space',
            )
        min_len = schema.get("minLength")
        max_len = schema.get("maxLength")
        if min_len is not None or max_len is not None:
            self._prim("char")
            lo = int(min_len or 0)
            rep = f"{{{lo},{max_len}}}" if max_len is not None else f"{{{lo},}}"
            return self._add(f"{hint}-str", f'"\\"" char{rep} "\\"" space')
        return self._prim("string")


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    conv = _Converter(schema)
    root_expr = conv.convert(schema, "root")
    lines = [f"root ::= {root_expr}"]
    for name, body in conv.rules.items():
        lines.append(f"{name} ::= {body}")
    return "\n".join(lines) + "\n"
