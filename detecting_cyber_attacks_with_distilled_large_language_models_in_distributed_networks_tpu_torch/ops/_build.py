"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``build/torch_kernels/`` at the repository root, named by
a hash of the source, of every ``csrc/`` header it includes (directly or
through another header) and of the flags, so an edited source or shared
header rebuilds every library that uses it and an unchanged one is reused. Nothing is built at import: the first call that
needs a kernel builds it, together with the libraries of its group
(:data:`BUILD_GROUPS`), all started at once. A failed build raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

#: Library name -> source file under csrc/.
SOURCES = {
    "flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu", "fold": "fold.cu", "adam": "adam.cu",
    "residual_ln": "residual_ln.cu",
}

#: Libraries that one forward of the model needs together: the first load
#: of any of them builds the whole group in one :func:`build` call, so on
#: a cold start their ``nvcc`` runs side by side instead of one after the
#: other. Every other library builds alone.
BUILD_GROUPS = (("flash_fwd", "residual_ln"),)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, else ``/usr/local/cuda``, else PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built here"
        )
    return found


def source_files(name: str) -> list[str]:
    """The source of library ``name`` and every ``csrc/`` file it
    includes with ``#include "..."``, transitively, source first."""
    order, todo = [], [SOURCES[name]]
    while todo:
        rel = todo.pop()
        if rel in order:
            continue
        order.append(rel)
        with open(os.path.join(CSRC_DIR, rel)) as f:
            todo += [inc for inc in _INCLUDE.findall(f.read())
                     if os.path.isfile(os.path.join(CSRC_DIR, inc))]
    return order


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for rel in source_files(name):
        h.update(rel.encode() + b"\0")
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, float]:
    """Compile every named library that is not built yet, one ``nvcc``
    per source, all started together. Returns seconds per library built
    (empty when all were cached). Raises ``RuntimeError`` with the
    compiler's output on any failure."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        ), tmp, out)
    took: dict[str, float] = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees old or new
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def build_group(name: str) -> list[str]:
    """The libraries built with ``name``: its group, or itself alone."""
    for group in BUILD_GROUPS:
        if name in group:
            return list(group)
    return [name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it and its group first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(build_group(name))
            lib = _libs[name] = ctypes.CDLL(library_path(name))
        return lib
