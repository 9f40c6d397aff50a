"""Build and load the port's CUDA kernels.

Each source in llm_tpu_torch/csrc is compiled by nvcc for sm_90a into a
shared library with a plain C interface, loaded with ctypes. The build
happens at first use, from the sources in the checkout only, into
llm_tpu_torch/_build (listed in .gitignore); a library is rebuilt when its
source, or any shared header (csrc/*.cuh), is newer. `build_all` starts
one nvcc per source at once.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("qmm", "qmm_stacked", "qmm_decode", "flash_attn", "flash_prefill", "qmm_chain", "qmm_probe",
           "flash_probe")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _paths(name: str) -> tuple[Path, Path]:
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared header
    (every source may include every header)."""
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def _command(name: str, out: Path) -> list[str]:
    src, _ = _paths(name)
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(src)]


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every stale source in parallel. Returns per source the
    seconds it took and the compiler's resource report (registers, spills,
    shared memory per kernel). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        procs[name] = (subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    report = {}
    failed = []
    for name, (p, tmp) in procs.items():
        log, _ = p.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if p.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, _paths(name)[1])
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all((name,))
            lib = ctypes.CDLL(str(_paths(name)[1]))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """The C entry points return cudaGetLastError(); nonzero means the
    launch was refused or an earlier fault surfaced."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
