"""llm-tpu-tokenize on the port (parity: tools/llama-tokenize): the port's
own copy of llm_tpu/tools/tokenize_cli.py, on the port's tokenizers.

    python -m llm_tpu_torch.tools.tokenize_cli -m model.gguf -p "text" [--ids]
"""

from __future__ import annotations

import sys


def main(argv=None):
    import argparse

    from ..gguf.reader import GGUFReader
    from ..tokenizers import tokenizer_from_gguf

    ap = argparse.ArgumentParser(description="tokenize text with a GGUF vocab")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("-f", "--file", default=None)
    ap.add_argument("--ids", action="store_true", help="print bare ids")
    ap.add_argument("--no-bos", action="store_true")
    ap.add_argument("--no-parse-special", action="store_true")
    args = ap.parse_args(argv)

    tok = tokenizer_from_gguf(GGUFReader(args.model))
    text = args.prompt if args.prompt is not None else open(args.file).read()
    ids = tok.encode(text, add_special=not args.no_bos,
                     parse_special=not args.no_parse_special)
    if args.ids:
        print(ids)
        return
    for t in ids:
        print(f"{t:8d} -> {tok.piece(t, special=True)!r}")
    print(f"total: {len(ids)} tokens", file=sys.stderr)


if __name__ == "__main__":
    main()
