"""tools/gemm_splits.py's argument handling on the CPU: the prefill sweep by
default, the decode GEMV's K5 sweep with --gdot (p4 shapes, B <= 16) and
K6's chains with --chain (B <= 8), unknown shapes refused, and no CUDA
device -> an exit with no result line."""

import pytest

from llm_tpu_torch.tools import gemm_splits


@pytest.mark.parametrize("argv,B,shapes", [
    ([], [512, 128], list(gemm_splits.PREFILL_SHAPES)),
    (["--B", "1,8"], [1, 8], list(gemm_splits.PREFILL_SHAPES)),
    (["--gdot"], [1, 8], list(gemm_splits.GDOT_SHAPES)),
    (["--gdot", "--B", "16", "--shapes", "attn_k"], [16], ["attn_k"]),
    (["--chain"], [1, 8], list(gemm_splits.CHAINS)),
    (["--chain", "--shapes", "head qkv,lm_head Q6_K"], [1, 8], ["head qkv", "lm_head Q6_K"]),
])
def test_modes(argv, B, shapes):
    args = gemm_splits.parse(argv)
    assert args.B == B and args.shapes == shapes


@pytest.mark.parametrize("argv", [
    ["--shapes", "qkv,fast"],                     # unknown shape
    ["--gdot", "--shapes", "down Q6_K"],          # K5 takes p4 planes
    ["--gdot", "--B", "17"],                      # K5 is the decode kernel
    ["--chain", "--B", "16"],                     # K6 takes B <= 8
    ["--chain", "--shapes", "gate_up"],           # a matmul is no chain
    ["--gdot", "--chain"],                        # one mode at a time
])
def test_refused(argv):
    with pytest.raises(SystemExit):
        gemm_splits.parse(argv)


def test_k5_shapes_are_p4():
    assert all(gemm_splits.SHAPES[s][2] == "Q4_K" for s in gemm_splits.GDOT_SHAPES)


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        gemm_splits.main(["--chain"])
    assert capsys.readouterr().out == ""
