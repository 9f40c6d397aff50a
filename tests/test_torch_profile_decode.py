"""tools/profile_decode.py's argument handling on the CPU: --paths, --root
put on the import path before anything of the package is imported, and no
CUDA device -> exit code 2 with no result line."""

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
