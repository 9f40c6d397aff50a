"""The port's GGUF writer (llm_tpu_torch/gguf/writer.py) against llm_tpu's:
the same calls write byte-equal files, which both packages' readers read
back alike. Cases: every metadata value type (numpy scalars, Python
scalars, strings, lists, numpy arrays, bools), F32/F16/BF16/I32 tensors,
pre-quantized Q4_K and Q6_K blocks, a non-default alignment, and the
synthetic Q4_K_M llama file of tools/synth_gguf.py written through each
writer."""

import numpy as np
import pytest

from llm_tpu.gguf.constants import GGMLType as JaxGGMLType
from llm_tpu.gguf.reader import GGUFReader as JaxGGUFReader
from llm_tpu.gguf.writer import GGUFWriter as JaxGGUFWriter

from llm_tpu_torch.gguf import constants
from llm_tpu_torch.gguf.constants import GGMLType, GGUFValueType, Keys
from llm_tpu_torch.gguf.reader import GGUFReader
from llm_tpu_torch.gguf.writer import GGUFWriter
from llm_tpu_torch.tools import synth_gguf


def _fill(w, ggml, rng):
    w.add_kv("general.name", "writer test ✓")
    w.add_kv("test.u8", np.uint8(200))
    w.add_kv("test.i8", np.int8(-5))
    w.add_kv("test.u16", np.uint16(60000))
    w.add_kv("test.i16", np.int16(-30000))
    w.add_kv("test.u32", 7)
    w.add_kv("test.i32", -7)
    w.add_kv("test.u64", 2 ** 40)
    w.add_kv("test.i64", -(2 ** 40))
    w.add_kv("test.f32", 0.1)
    w.add_kv("test.f64", np.float64(1e-300))
    w.add_kv("test.bool", True)
    w.add_kv("test.strs", ["a", "bé", "", "<|eot_id|>"])
    w.add_kv("test.ints", [1, 2, 3])
    w.add_kv("test.floats", [0.5, -1.25])
    w.add_kv("test.arr_f32", rng.normal(size=5).astype(np.float32))
    w.add_kv("test.arr_i32", np.arange(6, dtype=np.int32))
    w.add_kv("test.arr_bool", np.asarray([True, False, True]))
    w.add_kv("test.empty", [])
    w.add_kv("test.forced", 3, vtype=GGUFValueType.INT16)  # an IntEnum: either package's
    x = rng.normal(size=(3, 64)).astype(np.float32)
    w.add_tensor("f32", x)
    w.add_tensor("f16", x, ggml_type=ggml.F16)
    w.add_tensor("bf16", x, ggml_type=ggml.BF16)
    w.add_tensor("i32", np.arange(10, dtype=np.int32))
    w.add_tensor("scalar", np.float32(2.5))
    for t, name in ((ggml.Q4_K, "q4k"), (ggml.Q6_K, "q6k")):
        raw = synth_gguf.random_blocks(np.random.default_rng(int(t)), GGMLType(int(t)), 4, 512)
        w.add_tensor(name, None, ggml_type=t, raw=raw, shape=(512, 4))


@pytest.mark.parametrize("alignment", [32, 64])
def test_files_are_byte_equal(tmp_path, alignment):
    a, b = str(tmp_path / "ref.gguf"), str(tmp_path / "port.gguf")
    ref = JaxGGUFWriter(a, arch="llama", alignment=alignment)
    port = GGUFWriter(b, arch="llama", alignment=alignment)
    _fill(ref, JaxGGMLType, np.random.default_rng(0))
    _fill(port, GGMLType, np.random.default_rng(0))
    ref.write()
    port.write()
    assert open(a, "rb").read() == open(b, "rb").read()
    r, p = JaxGGUFReader(b), GGUFReader(b)
    assert p.get("general.name") == r.get("general.name") == "writer test ✓"
    assert list(p.tensors) == list(r.tensors)
    for name in p.tensors:
        np.testing.assert_array_equal(p.data(name), r.data(name))


def test_duplicates_and_bad_raw_sizes_raise(tmp_path):
    w = GGUFWriter(str(tmp_path / "x.gguf"))
    w.add_kv("k", 1)
    with pytest.raises(ValueError):
        w.add_kv("k", 2)
    w.add_tensor("t", np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        w.add_tensor("t", np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        w.add_tensor("q", None, ggml_type=GGMLType.Q4_K, raw=np.zeros(10, np.uint8),
                     shape=(256, 1))
    with pytest.raises(ValueError):
        w.add_tensor("q8", np.zeros((2, 32), np.float32), ggml_type=GGMLType.Q8_0)


def test_constants_hold_the_reference_keys():
    """The tokenizer keys and value types the tokenizers and the writer read
    are the reference's; the file types are its, and llama.cpp's ids of
    the four whose files tools/synth_gguf.py writes and the reference's
    enum lacks (IQ2_XXS, IQ1_M, TQ1_0, TQ2_0)."""
    from llm_tpu.gguf import constants as jc

    def flat(k):
        return {f"{c}.{n}": getattr(getattr(k, c), n) for c in vars(k) if not c.startswith("_")
                for n in vars(getattr(k, c)) if not n.startswith("_")}

    assert flat(Keys) == flat(jc.Keys)
    assert {e.name: e.value for e in GGUFValueType} == {e.name: e.value for e in jc.GGUFValueType}
    assert {e.name: e.value for e in constants.FileType} == {
        **{e.name: e.value for e in jc.FileType}, "MOSTLY_IQ2_XXS": 19, "MOSTLY_IQ1_M": 31,
        "MOSTLY_TQ1_0": 36, "MOSTLY_TQ2_0": 37}


def test_synthetic_llama_file_is_the_same_through_either_writer(tmp_path, monkeypatch):
    """tools/synth_gguf.py's Q4_K_M llama with its BPE vocab, written by the
    port's writer and, with the same calls, by llm_tpu's: byte-equal, and
    llm_tpu's reader finds the recipe's types and the vocab in it."""
    geo = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=1, n_ff=512, n_vocab=1024)
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "ref.gguf")
    info = synth_gguf.write_llama(a, **geo)
    monkeypatch.setattr(synth_gguf, "GGUFWriter", JaxGGUFWriter)
    synth_gguf.write_llama(b, **geo)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert info["tensors"] == {"Q4_K": 13, "Q6_K": 3, "F32": 5}
    r = JaxGGUFReader(a)
    assert r.tensors["output.weight"].ggml_type == JaxGGMLType.Q6_K
    assert r.tensors["blk.0.ffn_down.weight"].ggml_type == JaxGGMLType.Q6_K  # use_more_bits
    assert r.get("tokenizer.ggml.pre") == "llama-bpe"
