"""Build the CUDA kernels of ``kernels/csrc`` with ``nvcc`` and load them.

Each source compiles on first use into a shared library with a plain C
interface under ``build/`` at the repository root, named by a hash of the
source, of the ``csrc/`` headers it includes (directly or through another
header) and of its compiler flags (:func:`nvcc_flags`), so a change to any
of them rebuilds and an unchanged source is reused. The library is loaded with ``ctypes``;
nothing here includes PyTorch's headers, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
# Sources built with fused multiply-adds: the Gauss-Newton build and its
# backward have no exact tie to keep; the photo kernel keeps its DSSIM tie by
# arithmetic the compiler does not contract (csrc/ssim.cuh).
FMAD_SOURCES = ("gn_build.cu", "gn_build_bwd.cu", "photo_pair.cu")


def nvcc_flags(source: str) -> list[str]:
    """The compiler flags of ``csrc/<source>``."""
    if source in FMAD_SOURCES:
        return [f for f in NVCC_FLAGS if f != "-fmad=false"]
    return list(NVCC_FLAGS)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_closure(source: str) -> list[str]:
    """``source`` (a file name in ``csrc/``) followed by every ``csrc/``
    file it includes with ``#include "..."``, transitively, each once, in
    the order found."""
    order, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in order:
            continue
        order.append(name)
        with open(os.path.join(CSRC, name), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return order


def library_path(source: str) -> str:
    """Where the library of ``source`` (a file name in ``csrc/``) goes."""
    digest = hashlib.sha256(" ".join(nvcc_flags(source)).encode())
    for name in source_closure(source):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
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
        [nvcc_path(), *nvcc_flags(source), "-o", tmp,
         os.path.join(CSRC, source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def compile_sources(sources: list[str]) -> dict[str, tuple[str, str]]:
    """Compile several sources at once, one ``nvcc`` process each, all
    started together; returns ``{source: (library path, report)}``."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        return dict(zip(sources, pool.map(compile_source, sources)))


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(compile_source(source)[0])
        return _libs[source]
