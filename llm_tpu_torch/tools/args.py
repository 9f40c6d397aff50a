"""Environment-variable fallbacks and shared flags for the port's CLI
tools: the port's own copy of the parts of llm_tpu/tools/args.py that import
no jax (env_default, required_unless_env, --override-kv).

As in llama.cpp's arg system (common/arg.cpp, the LLAMA_ARG_* .set_env
entries), every tool passes its argparse defaults through env_default(),
so e.g.

    LLM_TPU_ARG_MODEL=weights.gguf LLM_TPU_ARG_CTX_SIZE=8192 python -m ...

supplies -m / -c without flags. Explicit flags always win over env vars.
"""

from __future__ import annotations

import os

PREFIX = "LLM_TPU_ARG_"


def env_default(name: str, default, cast=None):
    """Default for argparse: LLM_TPU_ARG_<NAME> when set, else `default`.

    name: the long flag name ("ctx-size" -> LLM_TPU_ARG_CTX_SIZE)."""
    key = PREFIX + name.replace("-", "_").upper()
    raw = os.environ.get(key)
    if raw is None:
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if cast is not None:
        return cast(raw)
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def required_unless_env(name: str):
    """For required args: not required when the env var supplies a value."""
    return env_default(name, None) is None


def add_override_kv(ap) -> None:
    """--override-kv KEY=TYPE:VALUE (repeatable) — the analogue of the
    reference's llama_model_kv_override (llama.h:280-291, common arg
    --override-kv): patch GGUF metadata at load, e.g.
    `--override-kv qwen2.rope.freq_base=float:1000000`."""
    ap.add_argument("--override-kv", action="append", default=[],
                    metavar="KEY=TYPE:VALUE",
                    help="override a GGUF metadata value (TYPE: "
                         "int|float|bool|str); repeatable")


def apply_kv_overrides(reader, specs) -> None:
    """Patch reader.metadata in place from KEY=TYPE:VALUE specs."""
    casts = {"int": int, "float": float, "str": str,
             "bool": lambda v: v.strip().lower() in ("1", "true", "yes", "on")}
    for spec in specs or ():
        key, _, tv = spec.partition("=")
        typ, _, val = tv.partition(":")
        if not key or typ not in casts or not _:
            raise SystemExit(
                f"bad --override-kv {spec!r} (want KEY=TYPE:VALUE, "
                f"TYPE in {sorted(casts)})")
        reader.metadata[key] = casts[typ](val)
