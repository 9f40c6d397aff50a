"""Compare the machine code of the kernels that two cubins share.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -cubin \\
        -o old.cubin <parent checkout>/llm_tpu_torch/csrc/flash_attn.cu
    nvcc ... -o new.cubin llm_tpu_torch/csrc/flash_attn.cu
    python3 -m llm_tpu_torch.tools.cubin_cmp old.cubin new.cubin \\
        [--alias flash_probe_split=flash_decode_split]

A kernel's code is its ELF section `.text.<mangled name>`. A kernel in an
anonymous namespace carries a hash of its source file in its name; the
hash is dropped, so the same kernel built from two files (or, with
--alias, under two names) is compared by the rest of its name. Prints SAME,
DIFF or ONLY for each kernel and exits 1 if a kernel that both hold
differs. It reads the ELF headers itself and needs no CUDA toolkit.
"""

from __future__ import annotations

import argparse
import re
import struct
import sys

_ANON = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def text_sections(data: bytes) -> dict[str, bytes]:
    """{section name: bytes} of every .text.* section of a 64-bit
    little-endian ELF image."""
    if data[:4] != b"\x7fELF" or data[4] != 2 or data[5] != 1:
        raise ValueError("not a 64-bit little-endian ELF file")
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum, shstrndx = struct.unpack_from("<HHH", data, 0x3A)
    heads = [struct.unpack_from("<IIQQQQIIQQ", data, shoff + i * shentsize)
             for i in range(shnum)]
    names = heads[shstrndx][4]

    def name(off: int) -> str:
        return data[names + off:data.index(b"\0", names + off)].decode()

    return {name(h[0]): data[h[4]:h[4] + h[5]] for h in heads
            if name(h[0]).startswith(".text.")}


def kernel_key(section: str, aliases: dict[str, str]) -> str:
    """The section's kernel name without its file hash, aliases applied
    (to the mangled identifier, length prefix included)."""
    key = _ANON.sub("(anon)", section[len(".text."):])
    for a, b in aliases.items():
        key = key.replace(f"{len(a)}{a}", f"{len(b)}{b}")
    return key


def compare(old: bytes, new: bytes, aliases=None) -> list[tuple[str, str]]:
    """[(verdict, kernel)] over the kernels of both images, sorted by name:
    SAME or DIFF where both hold the kernel, else ONLY old / ONLY new."""
    aliases = aliases or {}
    a = {kernel_key(k, aliases): v for k, v in text_sections(old).items()}
    b = {kernel_key(k, aliases): v for k, v in text_sections(new).items()}
    out = []
    for k in sorted(set(a) | set(b)):
        if k in a and k in b:
            out.append(("SAME" if a[k] == b[k] else "DIFF", k))
        else:
            out.append(("ONLY old" if k in a else "ONLY new", k))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--alias", action="append", default=[],
                    help="NAME=OTHER: compare kernel NAME of either file as OTHER")
    args = ap.parse_args(argv)
    aliases = dict(a.split("=", 1) for a in args.alias)
    with open(args.old, "rb") as f, open(args.new, "rb") as g:
        rows = compare(f.read(), g.read(), aliases)
    for verdict, k in rows:
        print(verdict, k)
    return 1 if any(v == "DIFF" for v, _ in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
