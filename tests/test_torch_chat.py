"""The port's server/chat.py and server/toolcall.py (its own copies)
against llm_tpu's on tests/test_chat.py's and test_server.py's cases:
equal template strings and equal tool-call parses. A Jinja source renders
as chatml in the port, which carries no Jinja engine, as llm_tpu renders it
where jinja2 is missing (the card's machine)."""

import sys

import pytest

from llm_tpu.server import chat as jax_chat
from llm_tpu.server import toolcall as jax_toolcall

from llm_tpu_torch.server import chat, toolcall

MSGS = [
    {"role": "system", "content": "be good"},
    {"role": "user", "content": "hi"},
    {"role": "assistant", "content": "hello"},
    {"role": "user", "content": "bye?"},
]


@pytest.mark.parametrize("add_assistant", [True, False])
@pytest.mark.parametrize("name", sorted(jax_chat.TEMPLATES))
def test_named_templates_are_the_reference(name, add_assistant):
    assert chat.apply_template(name, MSGS, add_assistant) == \
        jax_chat.apply_template(name, MSGS, add_assistant)
    assert chat.TEMPLATES[name](MSGS[1:2]) == jax_chat.TEMPLATES[name](MSGS[1:2])


@pytest.mark.parametrize("src", ["{{ '<|im_start|>' }}", "<|start_header_id|>...",
                                 "<start_of_turn>", "[INST] something", "",
                                 "[SYSTEM_PROMPT]", "<|assistant|>"])
def test_detect_is_the_reference(src):
    assert chat.detect_template(src) == jax_chat.detect_template(src)


def test_jinja_source_renders_as_llm_tpu_without_jinja2(monkeypatch):
    src = "{% for m in messages %}{{ m.role }}:{{ m.content }};{% endfor %}"
    monkeypatch.setitem(sys.modules, "jinja2", None)  # llm_tpu as on the card's machine
    want = jax_chat.apply_template(src, MSGS)
    assert chat.apply_template(src, MSGS) == want == chat.TEMPLATES["chatml"](MSGS)


@pytest.mark.parametrize("text", [
    '{"a": 1, "b": [2, 3]}', '{"name": "get_weather", "arguments": {"city": "Par',
    '{"name": "f", "arguments":', '[1, 2', '"abc', '{"x": tr'])
def test_partial_json_is_the_reference(text):
    assert toolcall.parse_partial_json(text) == jax_toolcall.parse_partial_json(text)


@pytest.mark.parametrize("text", [
    'thinking...<tool_call>{"name": "add", "arguments": {"a": 1}}</tool_call>',
    '[TOOL_CALLS][{"name": "mul", "arguments": {"x": 2}}]',
    '{"name": "solo", "arguments": {}}', "plain text answer",
    '<tool_call>{"name": "a"', '<function=f>{"q": 1}</function>'])
def test_tool_call_parses_are_the_reference(text):
    """extract_tool_calls (the call ids aside: fresh uuids on both sides)
    and tool_call_in_progress."""
    def strip(calls):
        return [{k: v for k, v in c.items() if k != "id"} for c in calls]

    calls, content = toolcall.extract_tool_calls(text)
    jcalls, jcontent = jax_toolcall.extract_tool_calls(text)
    assert strip(calls) == strip(jcalls) and content == jcontent
    assert toolcall.tool_call_in_progress(text) == jax_toolcall.tool_call_in_progress(text)


def test_tools_prompt_is_the_reference():
    tools = [{"type": "function", "function": {"name": "add", "description": "sum",
                                               "parameters": {"type": "object"}}}]
    assert toolcall.render_tools_prompt(tools) == jax_toolcall.render_tools_prompt(tools)
