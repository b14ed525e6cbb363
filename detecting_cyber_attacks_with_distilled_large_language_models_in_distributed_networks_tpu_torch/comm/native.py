"""The wire's native byte path: ctypes bindings of the repository's
``native/fedwire.cpp`` with numpy twins (the port of the JAX package's
``comm/native.py``).

:func:`lib` builds the source on first use (``utils/native.py``, into
``build/torch_native/``) and loads it; :func:`have_native` says whether
it did. Without a C++ compiler every entry point runs its numpy twin,
which gives the same bytes: the CRC is zlib's (the same IEEE polynomial),
and the bf16 pack is the C++ rounding written in uint32 arithmetic.
"""

from __future__ import annotations

import ctypes
import zlib

import numpy as np

from ..utils.native import load_native


def _configure(cdll: ctypes.CDLL) -> None:
    cdll.fedwire_crc32.restype = ctypes.c_uint32
    cdll.fedwire_crc32.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
    for name in ("fedwire_pack_bf16", "fedwire_unpack_bf16", "fedwire_xor"):
        fn = getattr(cdll, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        fn.restype = None


def lib() -> ctypes.CDLL | None:
    return load_native("fedwire.cpp", _configure)


def have_native() -> bool:
    return lib() is not None


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


# ------------------------------------------------------------------- crc32
def crc32(data: bytes | bytearray | memoryview | np.ndarray, seed: int = 0) -> int:
    """zlib's CRC-32 of ``data``'s bytes, continuing from ``seed``; a
    contiguous buffer is read in place (uploads are ~250 MB)."""
    cdll = lib()
    if cdll is None:
        return zlib.crc32(data, seed)
    buf = np.ascontiguousarray(data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8))
    return int(cdll.fedwire_crc32(ctypes.c_char_p(buf.ctypes.data), buf.nbytes, seed))


# --------------------------------------------------------------- bf16 pack
def pack_bf16_numpy(x: np.ndarray) -> np.ndarray:
    """``fedwire_pack_bf16`` in numpy uint32 arithmetic: round to nearest
    even by ``(x + 0x7FFF + lsb) >> 16``, and a NaN keeps its sign and top
    payload bits with the quiet bit forced (``(x >> 16) | 0x40``), so
    rounding never carries a NaN into inf."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) >> np.uint32(16)
    quiet = (u >> np.uint32(16)) | np.uint32(0x40)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def pack_bf16(x: np.ndarray) -> np.ndarray:
    """fp32 array -> uint16 bf16 bits (round to nearest even)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    cdll = lib()
    if cdll is None or not x.size:
        return pack_bf16_numpy(x)
    out = np.empty(x.shape, np.uint16)
    cdll.fedwire_pack_bf16(_ptr(x), _ptr(out), x.size)
    return out


def unpack_bf16(x: np.ndarray, shape=None) -> np.ndarray:
    """uint16 bf16 bits -> fp32 (exact: the low 16 bits are zero)."""
    x = np.ascontiguousarray(x, dtype=np.uint16)
    cdll = lib()
    if cdll is None or not x.size:
        out = x.astype(np.uint32) << np.uint32(16)
    else:
        out = np.empty(x.shape, np.uint32)
        cdll.fedwire_unpack_bf16(_ptr(x), _ptr(out), x.size)
    f = out.view(np.float32)
    return f.reshape(shape) if shape is not None else f


# --------------------------------------------------------------- xor delta
def xor_bytes(src: np.ndarray, dst: np.ndarray) -> None:
    """``dst ^= src`` in place (uint8 arrays of equal size); self-inverse."""
    if src.dtype != np.uint8 or dst.dtype != np.uint8 or src.size != dst.size:
        raise ValueError("xor_bytes wants equal-size uint8 arrays")
    cdll = lib()
    if cdll is not None and src.size:
        cdll.fedwire_xor(_ptr(np.ascontiguousarray(src)), _ptr(dst), src.size)
    else:
        np.bitwise_xor(dst, src, out=dst)
