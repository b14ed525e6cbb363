"""The safetensors file format, read and written with numpy and the
standard library (the card's machine has no ``safetensors`` package).

Layout: an 8-byte little-endian header length ``N``, ``N`` bytes of JSON
(``{"__metadata__": {...}, name: {"dtype", "shape", "data_offsets"}}``,
space-padded to a multiple of 8), then the tensors' raw little-endian
C-order bytes, back to back. :func:`save` orders the tensors as the
``safetensors`` package does (by dtype, widest first, then by name) and
writes the compact JSON it writes, so the bytes are equal to
``safetensors.numpy.save`` of the same dict. :func:`load_file` reads any
file of the format, ``transformers``' ``save_pretrained`` output among
them (with ``__metadata__ {"format": "pt"}``).
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np

#: The format's dtype names for numpy's, little-endian.
_NUMPY = {
    "BOOL": np.dtype(np.bool_),
    "U8": np.dtype("u1"),
    "I8": np.dtype("i1"),
    "I16": np.dtype("<i2"),
    "U16": np.dtype("<u2"),
    "F16": np.dtype("<f2"),
    "I32": np.dtype("<i4"),
    "U32": np.dtype("<u4"),
    "F32": np.dtype("<f4"),
    "F64": np.dtype("<f8"),
    "I64": np.dtype("<i8"),
    "U64": np.dtype("<u8"),
}
_NAME = {dt: name for name, dt in _NUMPY.items()}
#: The safetensors package's dtype order; its writer sorts by it, widest
#: (last) first. BF16 (no numpy dtype) is read only.
_RANK = ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32", "F32", "F64", "I64", "U64")


class SafetensorsError(ValueError):
    """A file that is not well-formed safetensors."""


def save(tensors: Mapping[str, np.ndarray], metadata: Mapping[str, str] | None = None) -> bytes:
    """The file's bytes for ``tensors`` (numpy arrays of the format's
    dtypes) and optional string ``metadata``."""
    arrays = {}
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
        if dt not in _NAME:
            raise SafetensorsError(f"{name}: dtype {arr.dtype} has no safetensors name")
        arrays[name] = (_NAME[dt], np.ascontiguousarray(arr, dtype=dt))
    order = sorted(arrays, key=lambda n: (-_RANK.index(arrays[n][0]), n))
    header: dict = {} if metadata is None else {"__metadata__": dict(metadata)}
    offset = 0
    for name in order:
        dtype, arr = arrays[name]
        header[name] = {"dtype": dtype, "shape": list(arr.shape), "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    text = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    return b"".join([struct.pack("<Q", len(text)), text, *(arrays[n][1].tobytes() for n in order)])


def save_file(tensors: Mapping[str, np.ndarray], path: str, metadata: Mapping[str, str] | None = None) -> None:
    with open(path, "wb") as f:
        f.write(save(tensors, metadata))


def read_header(path: str) -> tuple[dict, int]:
    """``(header, data_start)``: the parsed JSON header (``__metadata__``
    included when present) and the byte offset the tensors start at."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise SafetensorsError(f"{path}: shorter than the 8-byte header length")
        (n,) = struct.unpack("<Q", raw)
        text = f.read(n)
    if len(text) != n:
        raise SafetensorsError(f"{path}: header of {n} bytes runs past the end")
    try:
        header = json.loads(text)
    except ValueError as e:
        raise SafetensorsError(f"{path}: header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    return header, 8 + n


def tensor_names(path: str) -> list[str]:
    """The tensors' names, read from the header alone."""
    return [k for k in read_header(path)[0] if k != "__metadata__"]


def load_file(path: str) -> dict[str, np.ndarray]:
    """Every tensor of the file as a writable numpy array (BF16 tensors
    widened exactly to float32, numpy having no bfloat16)."""
    header, start = read_header(path)
    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype, shape = info["dtype"], tuple(int(d) for d in info["shape"])
            lo, hi = (int(x) for x in info["data_offsets"])
            dt = np.dtype("<u2") if dtype == "BF16" else _NUMPY.get(dtype)
            if dt is None:
                raise SafetensorsError(f"{path}: {name} has unsupported dtype {dtype}")
            count = int(np.prod(shape, dtype=np.int64))
            if hi - lo != count * dt.itemsize or start + hi > size:
                raise SafetensorsError(f"{path}: {name} offsets {lo}..{hi} do not fit {dtype}{list(shape)}")
            f.seek(start + lo)
            arr = np.fromfile(f, dtype=dt, count=count).reshape(shape)
            if dtype == "BF16":
                arr = (arr.astype(np.uint32) << np.uint32(16)).view(np.float32)
            out[name] = arr
    return out
