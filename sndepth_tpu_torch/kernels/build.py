"""Build the CUDA kernels of ``kernels/csrc`` with ``nvcc`` and load them.

Each source compiles on first use into a shared library with a plain C
interface under ``build/`` at the repository root, named by a hash of the
source, so a changed source rebuilds and an unchanged one is reused. The
library is loaded with ``ctypes``; nothing here includes PyTorch's headers,
which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # No fused multiply-add: the kernels then round every step as
              # the plain PyTorch versions do, so exact DSSIM ties (equal
              # windows) stay exact ties on the card.
              "-fmad=false", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str) -> str:
    """Where the library of ``source`` (a file name in ``csrc/``) goes."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:12]}.so")


def compile_source(source: str) -> tuple[str, str]:
    """Compile ``csrc/<source>`` unless its library exists; returns the
    library path and the compiler's report (registers, shared memory)."""
    out = library_path(source)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(compile_source(source)[0])
        return _libs[source]
