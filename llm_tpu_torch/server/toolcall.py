"""(The port's own copy of llm_tpu/server/toolcall.py.) Tool-call protocol: prompt rendering + (streaming) output parsing.

Parity target: the reference's chat/tool-call layer
(llama.cpp's common/chat.cpp — per-model tool-call formats — and
common/json-partial.cpp — incremental JSON parsing for streaming).

Rendering: tools are passed to the Jinja chat template when it understands
them; otherwise a generic system-prompt injection instructs the model to
answer with <tool_call>{...}</tool_call> (Hermes format — the reference's
generic fallback).

Parsing: recognizes Hermes <tool_call> blocks, mistral-style
[TOOL_CALLS][...] and bare {"name": ..., "arguments": {...}} objects.
parse_partial_json() heals truncated JSON (close open strings/containers)
so a streaming client can detect an in-flight tool call before it is
complete.
"""

from __future__ import annotations

import json
import re
import uuid


def parse_partial_json(text: str):
    """Parse possibly-truncated JSON (common/json-partial.cpp analogue).

    Returns (value, is_complete). Truncated input is healed by closing any
    open string/array/object; returns (None, False) if nothing parseable."""
    text = text.strip()
    if not text:
        return None, False
    try:
        return json.loads(text), True
    except json.JSONDecodeError:
        pass
    # heal: track the container stack and string state
    stack = []
    in_str = False
    esc = False
    for ch in text:
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch in "{[":
            stack.append("}" if ch == "{" else "]")
        elif ch in "}]" and stack:
            stack.pop()
    healed = text
    if esc:
        healed = healed[:-1]
    if in_str:
        healed += '"'
    # drop dangling keys / separators so the close brackets parse
    prev = None
    while prev != healed:
        prev = healed
        healed = re.sub(r'"(?:[^"\\]|\\.)*"\s*:\s*$', "", healed)
        healed = re.sub(r'[,:]\s*$', "", healed)
    healed += "".join(reversed(stack))
    try:
        return json.loads(healed), False
    except json.JSONDecodeError:
        return None, False


_HERMES_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.S)
_MISTRAL_RE = re.compile(r"\[TOOL_CALLS\]\s*(\[.*\])", re.S)


def render_tools_prompt(tools: list[dict]) -> str:
    """Generic system-prompt injection (the reference's generic handler)."""
    sigs = json.dumps([t.get("function", t) for t in tools], indent=2)
    return (
        "You have access to the following functions. To call a function, "
        "respond ONLY with a <tool_call> block containing a JSON object "
        'with "name" and "arguments":\n'
        "<tool_call>{\"name\": \"fn\", \"arguments\": {...}}</tool_call>\n\n"
        f"Available functions:\n{sigs}"
    )


def _mk_call(obj: dict) -> dict | None:
    name = obj.get("name")
    if not name:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if isinstance(args, str):
        try:
            args = json.loads(args)
        except json.JSONDecodeError:
            pass
    return {
        "id": f"call_{uuid.uuid4().hex[:12]}",
        "type": "function",
        "function": {"name": str(name), "arguments": json.dumps(args)},
    }


def extract_tool_calls(text: str):
    """-> (tool_calls, remaining_content). Empty list when none found."""
    calls: list[dict] = []
    content = text

    m = _MISTRAL_RE.search(text)
    if m:
        val, _ = parse_partial_json(m.group(1))
        if isinstance(val, list):
            for obj in val:
                c = _mk_call(obj) if isinstance(obj, dict) else None
                if c:
                    calls.append(c)
            content = (text[: m.start()] + text[m.end():]).strip()
            return calls, content

    blocks = _HERMES_RE.findall(text)
    if blocks:
        for b in blocks:
            val, _ = parse_partial_json(b)
            c = _mk_call(val) if isinstance(val, dict) else None
            if c:
                calls.append(c)
        content = _HERMES_RE.sub("", text).strip()
        return calls, content

    # bare JSON object with name+arguments (some templates emit it raw)
    stripped = text.strip()
    if stripped.startswith("{"):
        val, _ = parse_partial_json(stripped)
        if isinstance(val, dict) and "name" in val and (
            "arguments" in val or "parameters" in val
        ):
            c = _mk_call(val)
            if c:
                return [c], ""
    return calls, content


def tool_call_in_progress(text: str) -> bool:
    """True when the tail of `text` looks like an unfinished tool call —
    a streaming client should buffer instead of emitting deltas."""
    if "<tool_call>" in text and "</tool_call>" not in text.rsplit("<tool_call>", 1)[1]:
        return True
    if "[TOOL_CALLS]" in text:
        done = extract_tool_calls(text)[0]
        return not done
    tail = text.strip()
    if tail.startswith("{") and not tail.endswith("}"):
        val, complete = parse_partial_json(tail)
        return isinstance(val, dict) and "name" in val and not complete
    return False
