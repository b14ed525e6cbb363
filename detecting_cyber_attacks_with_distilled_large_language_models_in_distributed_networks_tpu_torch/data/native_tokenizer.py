"""ctypes binding of the native WordPiece batch encoder (``native/wordpiece.cpp``).

The port's copy of the JAX package's ``data/native_tokenizer.py``; the
library comes from the port's own loader (``utils/native.py``), built into
``build/torch_native/``. The native path is ASCII-exact with
``tokenizer.py``'s BasicTokenizer + WordPiece (the flow templates are
pure ASCII); ``WordPieceTokenizer.batch_encode`` sends it pure-ASCII
batches only, so the ids are the same either way.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Sequence

import numpy as np

from ..utils.native import load_native

SOURCE = "wordpiece.cpp"


def _configure(cdll: ctypes.CDLL) -> None:
    cdll.wp_create.restype = ctypes.c_void_p
    cdll.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    cdll.wp_destroy.argtypes = [ctypes.c_void_p]
    cdll.wp_encode_batch.restype = ctypes.c_int32
    cdll.wp_encode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]


def lib() -> ctypes.CDLL | None:
    return load_native(SOURCE, _configure)


class NativeWordPiece:
    """One vocab bound into the native encoder; construct with
    :meth:`create`, which returns None when the library is unavailable."""

    def __init__(self, cdll: ctypes.CDLL, handle: int):
        self._cdll = cdll
        self._handle = handle
        self._finalizer = weakref.finalize(self, cdll.wp_destroy, handle)

    @classmethod
    def create(cls, vocab_in_id_order: Sequence[str]) -> "NativeWordPiece | None":
        cdll = lib()
        if cdll is None:
            return None
        blob = "\n".join(vocab_in_id_order).encode("utf-8")
        handle = cdll.wp_create(ctypes.c_char_p(blob), len(blob))
        if not handle:
            return None
        return cls(cdll, handle)

    def encode_batch(
        self, texts: Sequence[str], max_len: int, *, lowercase: bool = True
    ) -> dict[str, np.ndarray] | None:
        """The tokenizer's feed dict, or None when a text is not pure
        ASCII (the caller takes the Python path, exact on unicode)."""
        n = len(texts)
        input_ids = np.empty((n, max_len), np.int32)
        attention_mask = np.empty((n, max_len), np.int32)
        if n == 0:
            return {"input_ids": input_ids, "attention_mask": attention_mask}
        try:
            encoded = [t.encode("ascii") for t in texts]
        except UnicodeEncodeError:
            return None
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(b) for b in encoded], out=offsets[1:])
        blob = b"".join(encoded)
        rc = self._cdll.wp_encode_batch(
            self._handle,
            ctypes.c_char_p(blob),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            max_len,
            1 if lowercase else 0,
            input_ids.ctypes.data_as(ctypes.c_void_p),
            attention_mask.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            return None
        return {"input_ids": input_ids, "attention_mask": attention_mask}
