"""Built-in chat templates + detection.

Parity target: src/llama-chat.cpp — a registry of hand-rolled templates per
model family, selected by probing the GGUF-embedded Jinja template string
(llm_chat_detect_template semantics). The port's own copy of
llm_tpu/server/chat.py without its Jinja engine: a GGUF's embedded template
renders as chatml, as llm_tpu renders it where jinja2 is missing; these
formatters are the `--chat-template NAME` set.
"""

from __future__ import annotations


def _chatml(messages, add_assistant=True):
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    if add_assistant:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _llama2(messages, add_assistant=True):
    out = []
    system = ""
    for m in messages:
        if m["role"] == "system":
            system = m["content"]
        elif m["role"] == "user":
            content = m["content"]
            if system:
                content = f"<<SYS>>\n{system}\n<</SYS>>\n\n{content}"
                system = ""
            out.append(f"[INST] {content} [/INST]")
        else:
            out.append(f" {m['content']} ")
    return "".join(out)


def _llama3(messages, add_assistant=True):
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(
            f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
            f"{m['content']}<|eot_id|>"
        )
    if add_assistant:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _gemma(messages, add_assistant=True):
    out = []
    for m in messages:
        role = "model" if m["role"] == "assistant" else "user"
        # gemma folds system into the first user turn
        out.append(f"<start_of_turn>{role}\n{m['content']}<end_of_turn>\n")
    if add_assistant:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _mistral_v7(messages, add_assistant=True):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"[SYSTEM_PROMPT] {m['content']}[/SYSTEM_PROMPT]")
        elif m["role"] == "user":
            out.append(f"[INST] {m['content']}[/INST]")
        else:
            out.append(f" {m['content']}</s>")
    return "".join(out)


def _phi3(messages, add_assistant=True):
    out = [f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in messages]
    if add_assistant:
        out.append("<|assistant|>\n")
    return "".join(out)


def _zephyr(messages, add_assistant=True):
    out = [f"<|{m['role']}|>\n{m['content']}<|endoftext|>\n" for m in messages]
    if add_assistant:
        out.append("<|assistant|>\n")
    return "".join(out)


TEMPLATES = {
    "chatml": _chatml,
    "llama2": _llama2,
    "llama3": _llama3,
    "gemma": _gemma,
    "mistral-v7": _mistral_v7,
    "phi3": _phi3,
    "zephyr": _zephyr,
}

# (needle in the jinja source) -> template name, probed in order
_DETECT = [
    ("<|im_start|>", "chatml"),
    ("<|start_header_id|>", "llama3"),
    ("<start_of_turn>", "gemma"),
    ("[SYSTEM_PROMPT]", "mistral-v7"),
    ("<|assistant|>", "phi3"),
    ("[INST]", "llama2"),
]


def detect_template(jinja_source: str) -> str:
    for needle, name in _DETECT:
        if needle in (jinja_source or ""):
            return name
    return "chatml"


def apply_template(name_or_jinja: str, messages, add_assistant=True) -> str:
    """Render with a named builtin. Any other argument is a Jinja source,
    which the port renders as chatml: it carries no Jinja engine, and
    llm_tpu renders such a source as chatml where jinja2 is missing (the
    card's machine has none)."""
    fn = TEMPLATES.get(name_or_jinja)
    if fn is not None:
        return fn(messages, add_assistant)
    return _chatml(messages, add_assistant)
