"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``build/repro_torch/`` at the root of the checkout.
The file name carries a hash of the source, of the ``csrc/*.cuh`` headers
it includes and of the flags, so an edited source or header rebuilds and
an unchanged one is loaded as it is.

Nothing here runs at import time: the CPU tests import every module, and
nothing looks for ``nvcc`` until a kernel is first launched on a CUDA
tensor (or ``build_all`` is called).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/src/repro_torch/kernels/build.py -> <checkout>/build/repro_torch
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc/*.cuh`` headers it includes
    (``#include "x.cuh"``, followed through the headers), in order."""
    seen = [CSRC / f"{name}.cu"]
    for path in seen:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+\.cuh)"',
                              path.read_text(), flags=re.M):
            header = CSRC / inc
            if header not in seen:
                seen.append(header)
    return seen


def _target(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is built already.
    Returns (target, process or None, temporary output path)."""
    so = _target(name)
    if so.exists():
        return so, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so, proc, tmp


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source at once (one nvcc each, all started
    together). Returns ``{name: nvcc output}`` — the ``-Xptxas -v``
    register/spill summary, or "cached" for a library already built."""
    started = {n: _start(n) for n in names}
    logs = {}
    for name, (so, proc, tmp) in started.items():
        if proc is None:
            log_path = so.with_suffix(".log")
            logs[name] = log_path.read_text() if log_path.exists() else "cached"
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)   # atomic: a reader never sees a partial .so
        logs[name] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
