"""llm_tpu_torch.tools.cubin_cmp, which shows on the card that a kernel
built from moved or shared sources keeps its machine code, held here on
small ELF images made in the test: kernels in anonymous namespaces of two
files match by name, --alias maps one kernel's name to another's, a
changed byte is a DIFF and makes main exit 1."""

import struct

import pytest

from llm_tpu_torch.tools import cubin_cmp


def _elf(sections: dict) -> bytes:
    """A 64-bit little-endian ELF image holding the given sections."""
    names = b"\0.shstrtab\0" + b"".join(n.encode() + b"\0" for n in sections)
    body = names + b"".join(sections.values())
    shoff = 64 + len(body)
    heads = [bytes(64), struct.pack("<IIQQQQIIQQ", 1, 3, 0, 0, 64, len(names), 0, 0, 1, 0)]
    name_off, data_off = len(b"\0.shstrtab\0"), 64 + len(names)
    for n, data in sections.items():
        heads.append(struct.pack("<IIQQQQIIQQ", name_off, 1, 6, 0, data_off, len(data),
                                 0, 0, 128, 0))
        name_off += len(n) + 1
        data_off += len(data)
    ident = b"\x7fELF" + bytes([2, 1, 1]) + bytes(9)
    head = ident + struct.pack("<HHIQQQIHHHHHH", 1, 190, 1, 0, 0, shoff, 0, 64, 0, 0, 64,
                               len(heads), 1)
    return head + body + b"".join(heads)


def _kernel(file_hash: str, name: str) -> str:
    return f".text._ZN46_GLOBAL__N__{file_hash}_13_flash_attn_cu_321adc4e{len(name)}{name}Ev"


OLD = {_kernel("f4d83255", "flash_decode_split"): b"\x01\x02" * 64,
       _kernel("f4d83255", "flash_decode_combine"): b"\x03" * 32,
       ".text.shared_kernel": b"\x05" * 16}


def test_same_code_under_another_file_hash_is_same():
    new = {k.replace("f4d83255", "36593ce4"): v for k, v in OLD.items()}
    rows = cubin_cmp.compare(_elf(OLD), _elf(new))
    assert [v for v, _ in rows] == ["SAME"] * 3
    assert all("(anon)" in k for _, k in rows if "flash" in k)


def test_a_changed_byte_is_a_diff_and_an_extra_kernel_is_only_new(tmp_path):
    new = dict(OLD)
    new[_kernel("f4d83255", "flash_decode_split")] = b"\x01\x02" * 63 + b"\x01\x03"
    new[".text.extra"] = b"\x00" * 8
    rows = dict((k, v) for v, k in cubin_cmp.compare(_elf(OLD), _elf(new)))
    assert rows["extra"] == "ONLY new" and rows["shared_kernel"] == "SAME"
    assert rows["(anon)18flash_decode_splitEv"] == "DIFF"
    (tmp_path / "old.cubin").write_bytes(_elf(OLD))
    (tmp_path / "new.cubin").write_bytes(_elf(new))
    assert cubin_cmp.main([str(tmp_path / "old.cubin"), str(tmp_path / "new.cubin")]) == 1


def test_alias_compares_a_kernel_under_another_name(tmp_path):
    new = {_kernel("24014b07", "flash_probe_split"): OLD[_kernel("f4d83255",
                                                                 "flash_decode_split")]}
    rows = cubin_cmp.compare(_elf(OLD), _elf(new), {"flash_probe_split": "flash_decode_split"})
    assert ("SAME", "(anon)18flash_decode_splitEv") in rows
    (tmp_path / "a").write_bytes(_elf(OLD))
    (tmp_path / "b").write_bytes(_elf(new))
    assert cubin_cmp.main([str(tmp_path / "a"), str(tmp_path / "b"),
                           "--alias", "flash_probe_split=flash_decode_split"]) == 0


def test_refuses_what_is_not_an_elf_image():
    with pytest.raises(ValueError):
        cubin_cmp.text_sections(b"not an elf file at all" + bytes(64))
