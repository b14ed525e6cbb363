"""The port's loader for the repository's native C++ sources (``native/``).

The port's own copy of the JAX package's ``utils/native.py``, without its
build script: each source compiles with ``g++ -O3 -shared -fPIC
-std=c++17 -fno-exceptions`` into ``build/torch_native/`` at the
repository root, named by a hash of the source and the flags (as
``ops/_build.py`` names the CUDA libraries), so an edited source rebuilds
and an unchanged one is reused. Nothing is written into ``native/``, and
nothing is built at import: the first call that needs a library builds
it. A failed build is logged with the compiler's output and remembered
(:func:`build_error`); the caller keeps its pure-Python twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Callable

log = logging.getLogger(__name__)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fno-exceptions")

_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL | None] = {}
_errors: dict[str, str] = {}


class NativeBuildError(RuntimeError):
    """A native source that did not compile (the compiler's output inside)."""


def library_path(src: str) -> str:
    """Where ``native/<src>`` builds to: a hash of its bytes and the flags."""
    h = hashlib.sha256()
    with open(os.path.join(NATIVE_DIR, src), "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_native(src: str) -> str:
    """Compile ``native/<src>`` unless its library is built; returns the
    library's path. Raises :class:`NativeBuildError` on any failure."""
    out = library_path(src)
    if os.path.isfile(out):
        return out
    gxx = shutil.which("g++") or shutil.which("clang++")
    if gxx is None:
        raise NativeBuildError(f"no C++ compiler (g++ or clang++) on PATH to build {src}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [gxx, *GXX_FLAGS, os.path.join(NATIVE_DIR, src), "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise NativeBuildError(f"{' '.join(cmd)} failed (exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees old or new
    return out


def load_native(src: str, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL | None:
    """Build (if needed), load and configure ``native/<src>``; the first
    outcome is cached. None when the build or the load failed: the error
    is logged with the compiler's output and kept for :func:`build_error`."""
    with _lock:
        if src in _cache:
            return _cache[src]
        lib = None
        try:
            lib = ctypes.CDLL(build_native(src))
            configure(lib)
        except (NativeBuildError, OSError, AttributeError) as e:
            lib = None
            _errors[src] = f"{type(e).__name__}: {e}"
            log.error(f"[NATIVE] {src} unavailable, the Python path serves instead: {_errors[src]}")
        _cache[src] = lib
        return lib


def build_error(src: str) -> str | None:
    """Why ``native/<src>`` did not load (None: it loaded, or was never tried)."""
    return _errors.get(src)
