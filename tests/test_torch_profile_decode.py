"""tools/profile_decode.py's argument handling on the CPU: --paths, --root
put on the import path before anything of the package is imported, and no
CUDA device -> exit code 2 with no result line; and chip_smoke.py's check of
flash decode in a profile."""

import sys

import pytest

from llm_tpu_torch.tools import profile_decode


@pytest.mark.parametrize("argv,paths", [
    ([], ["unfused"]), (["--paths", "gdot"], ["gdot"]), (["--paths", "chain"], ["chain"]),
    (["--paths", "scan"], ["scan"]), (["--paths", "unfused,scan"], ["unfused", "scan"]),
    (["--paths", "unfused,gdot,chain,scan"], ["unfused", "gdot", "chain", "scan"]),
])
def test_paths(argv, paths):
    assert profile_decode.parse(argv).paths == paths


def test_unknown_path_is_refused():
    with pytest.raises(SystemExit):
        profile_decode.parse(["--paths", "unfused,fast"])


def test_root_goes_first_on_the_import_path_and_no_card_exits_2(tmp_path, capsys,
                                                                monkeypatch):
    import torch

    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_decode.main(["--root", str(tmp_path), "--paths", "unfused,scan"]) == 2
    assert sys.path[0] == str(tmp_path)
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@pytest.mark.parametrize("counted,seen,combines,ok", [
    (32.0, 32.0, 0.0, True),
    (32.0, 31.875, 0.0, True),   # the profiler dropped one record of 256
    (31.875, 31.875, 0.0, False),  # a launch missing by the wrappers' counters
    (32.0, 32.125, 0.0, False),  # a kernel named flash_decode beyond the launches
    (32.0, 32.0, 1.0, False),    # a combine kernel
    (64.0, 64.0, 0.0, False),    # two launches a layer
])
def test_attn_profile_check(counted, seen, combines, ok):
    """chip_smoke.py's check of flash decode in a decode profile: one launch
    a layer a token by the wrappers' counters, and in the profiler's records
    no combine kernel and no more flash-decode kernels than were launched
    (a dropped record is not a fault of the program)."""
    from chip_smoke import check_attn_profile

    prof = dict(counted_attn_launches_per_token=counted, attn_launches_per_token=seen,
                attn_combines_per_token=combines)
    if ok:
        check_attn_profile(prof, 32)
    else:
        with pytest.raises(AssertionError, match="flash decode"):
            check_attn_profile(prof, 32)


@pytest.mark.parametrize("memsets,allowed,ok", [
    (0.0, 0, True), (0.125, 0, False), (1.0, 1, True), (0.875, 1, True), (1.125, 1, False),
])
def test_gemv_profile_check(memsets, allowed, ok):
    """chip_smoke.py's check of the decode matmuls in a profile: no memset
    beyond those that come from elsewhere (fewer where the profiler dropped
    a record) and no kernel of the old GEMV loop."""
    from chip_smoke import check_gemv_profile

    prof = dict(memsets_per_token=memsets, qmm_gemv_launches_per_token=0.0)
    if ok:
        check_gemv_profile(prof, allowed)
    else:
        with pytest.raises(AssertionError, match="memsets"):
            check_gemv_profile(prof, allowed)
    with pytest.raises(AssertionError, match="qmm_gemv"):
        check_gemv_profile(dict(prof, qmm_gemv_launches_per_token=1.0), allowed)
