"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C entry points. It is compiled with
``nvcc`` into ``build/kiri_tpu_torch/lib<name>_<hash>.so`` at the root of the
checkout the first time it is needed (the hash covers the source, every
header under ``csrc/`` and the flags, so an edited source or header builds
anew) and loaded with ``ctypes``. Every C entry takes device pointers and
the CUDA stream as ``void*`` and returns ``cudaGetLastError()`` after its
launches; ``check`` raises when that is not 0. Nothing here runs on import:
the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kiri_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("preprocess_lines", "q8_gemm", "q8_stem", "stem_f32x3", "stem_mma")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: ptxas report (registers, shared memory, spills) of each build in this
#: process, by source name.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _headers() -> List[Path]:
    """Every header under ``csrc/`` (``*.h``, ``*.cuh``): any source may
    include any of them."""
    return sorted(p for ext in ("h", "cuh") for p in CSRC.rglob(f"*.{ext}"))


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in _headers():
        src += str(header.relative_to(CSRC)).encode() + header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every named source that is not built yet, one nvcc process
    each, all started together. Returns the names that were compiled."""
    jobs = {n: _start_build(n) for n in names}
    jobs = {n: j for n, j in jobs.items() if j is not None}
    for n, j in jobs.items():
        _finish_build(n, j)
    return list(jobs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
        return _loaded[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
