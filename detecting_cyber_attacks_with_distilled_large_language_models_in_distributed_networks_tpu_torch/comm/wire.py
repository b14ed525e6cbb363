"""The port's wire formats, shared byte for byte with the JAX package.

Two vocabularies of the JAX package's ``comm/wire.py``:

* the scoring frames' three magics (request, reply, reject), which the
  scoring service speaks;
* the model-weight message of a federated round (``FTPW``)::

      MAGIC 'FTPW' | u32 version | u32 header_len | header JSON | payload

  where the header lists every tensor as ``{key, dtype, shape, enc,
  offset, nbytes}`` plus the payload's CRC-32 and a free-form JSON
  ``meta``. Keys are '/'-joined paths through the nested params dict.

Only the dense wire is ported: raw tensors (``compression="none"``) and no
HMAC. Any other compression, an auth key, or a message that carries an
auth tag or a packed encoding raises :class:`ModeError` naming what is not
ported. For the same inputs :func:`encode` returns the JAX package's
bytes, so a JAX peer and a port peer exchange rounds; the JAX package's
static checker tracks the uniqueness of the magics there, not here.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Mapping

import numpy as np


class WireError(ValueError):
    """Malformed, truncated, or tampered wire message."""


class ModeError(ValueError):
    """A protocol mode the peer asked for that this side does not speak
    (here: a compression or authentication the port has not ported).
    Not a :class:`WireError`: retrying cannot help."""


#: One flow record to score (text or raw features) + an optional deadline.
SCORE_REQ_MAGIC = b"SCRQ"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
#: P(attack) plus serving telemetry (model round, batch size, queue wait).
SCORE_REP_MAGIC = b"SCRP"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
#: The explicit 503/504-style refusal (admission control, deadline).
SCORE_REJ_MAGIC = b"SCRJ"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol

#: A model-weight message (a client's upload, the server's aggregate).
MAGIC = b"FTPW"  # fedtpu: allow(wire-magic-coverage): the JAX package's weight-message magic, copied byte for byte so both packages exchange rounds
VERSION = 1
_ALLOWED_DTYPES = {
    "float32", "float64", "float16", "bfloat16",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool",
}
#: The JAX package's packed tensor encodings, none of them ported.
_UNPORTED_ENCS = ("bf16", "int8", "int8c", "topk")


def _check_mode(compression: str, auth_key: bytes | None) -> None:
    if compression != "none":
        raise ModeError(
            f"compression {compression!r} is not ported: the port speaks the "
            "dense fp32 wire (compression='none') only"
        )
    if auth_key is not None:
        raise ModeError("HMAC authentication (auth_key) is not ported")


def flat_crc32(flat: Mapping[str, Any]) -> int:
    """CRC-32 over the sorted-key concatenation of a flat dict's fp32
    tensor bytes: the checksum every replay of a round's aggregate pins."""
    crc = 0
    for key in sorted(flat):
        arr = np.ascontiguousarray(np.asarray(flat[key], np.float32))
        crc = zlib.crc32(arr, crc)
    return crc & 0xFFFFFFFF


# ------------------------------------------------------- pytree <-> flat
def flatten_params(tree: Any, *, sep: str = "/") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> sorted flat ``{'a/b/c': ndarray}``."""
    out: dict[str, np.ndarray] = {}

    def _walk(node, prefix):
        if isinstance(node, Mapping):
            for key in node:
                if sep in str(key):
                    raise WireError(f"param key {key!r} contains separator {sep!r}")
                _walk(node[key], f"{prefix}{sep}{key}" if prefix else str(key))
        else:
            out[prefix] = np.asarray(node)

    _walk(tree, "")
    return dict(sorted(out.items()))


def unflatten_params(flat: Mapping[str, np.ndarray], *, sep: str = "/") -> dict:
    """Inverse of :func:`flatten_params`."""
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise WireError(f"key path {path!r} collides with a tensor")
        node[parts[-1]] = value
    return tree


# ----------------------------------------------------------------- encode
def encode(
    params: Any,
    *,
    meta: Mapping[str, Any] | None = None,
    compression: str = "none",
    auth_key: bytes | None = None,
) -> bytes:
    """Params (nested dict, or flat dict of arrays) -> wire bytes."""
    _check_mode(compression, auth_key)
    flat = (
        dict(params)
        if isinstance(params, Mapping) and all(not isinstance(v, Mapping) for v in params.values())
        else flatten_params(params)
    )
    tensors = []
    chunks: list[bytes] = []
    offset = 0
    for key, arr in flat.items():
        arr = np.asarray(arr)
        dtype = str(arr.dtype)
        if dtype not in _ALLOWED_DTYPES:
            raise WireError(f"tensor {key!r} has unsupported dtype {dtype}")
        buf = np.ascontiguousarray(arr).tobytes()
        tensors.append(
            {
                "key": key,
                "dtype": dtype,
                "shape": list(arr.shape),
                "enc": "raw",
                "offset": offset,
                "nbytes": len(buf),
            }
        )
        chunks.append(buf)
        offset += len(buf)
    payload = b"".join(chunks)
    header = {
        "tensors": tensors,
        "payload_nbytes": len(payload),
        "payload_crc32": zlib.crc32(payload),
        "meta": dict(meta or {}),
    }
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    return MAGIC + struct.pack("<II", VERSION, len(hbytes)) + hbytes + payload


def decode_tensor_entry(t: Mapping[str, Any], raw) -> np.ndarray:
    """One tensor-table entry's payload bytes -> ndarray (raw only)."""
    dtype = t["dtype"]
    if dtype not in _ALLOWED_DTYPES:
        raise WireError(f"tensor {t.get('key')!r} has unsupported dtype {dtype}")
    if t["enc"] in _UNPORTED_ENCS:
        raise ModeError(f"tensor encoding {t['enc']!r} is not ported (raw only)")
    if t["enc"] == "raw":
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(t["shape"])
    raise WireError(f"unknown tensor encoding {t['enc']!r}")


# ----------------------------------------------------------------- decode
def decode(
    data: bytes | memoryview, *, auth_key: bytes | None = None
) -> tuple[dict, dict]:
    """Wire bytes -> ``(nested params dict, meta dict)``; verifies the CRC."""
    _check_mode("none", auth_key)
    view = memoryview(data)
    if len(view) < 12 or bytes(view[:4]) != MAGIC:
        raise WireError("bad magic: not a fedwire message")
    version, hlen = struct.unpack("<II", view[4:12])
    if version != VERSION:
        raise WireError(f"wire version {version} unsupported (expected {VERSION})")
    if len(view) < 12 + hlen:
        raise WireError("truncated header")
    try:
        header = json.loads(bytes(view[12 : 12 + hlen]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"malformed header: {e}") from None
    if not isinstance(header, dict):
        raise WireError("malformed header: not a JSON object")
    if header.get("auth") is not None:
        raise ModeError(
            f"authenticated message ({header.get('auth')!r}) rejected: HMAC "
            "authentication is not ported"
        )
    payload = view[12 + hlen :]
    if len(payload) != header.get("payload_nbytes"):
        raise WireError(
            f"payload length {len(payload)} != declared {header.get('payload_nbytes')}"
        )
    crc = zlib.crc32(payload)
    if crc != header.get("payload_crc32"):
        raise WireError(
            f"payload CRC mismatch (got {crc:#010x}, "
            f"header says {header.get('payload_crc32', 0):#010x})"
        )
    flat: dict[str, np.ndarray] = {}
    # Header fields come from the peer: any inconsistency must surface as
    # WireError, not leak as KeyError/TypeError and kill a server thread.
    try:
        for t in header["tensors"]:
            key = t["key"]
            offset, nbytes = int(t["offset"]), int(t["nbytes"])
            if offset < 0 or nbytes < 0 or offset + nbytes > len(payload):
                raise WireError(f"tensor {key!r} has out-of-bounds extent")
            flat[key] = decode_tensor_entry(t, payload[offset : offset + nbytes])
        return unflatten_params(flat), dict(header.get("meta", {}))
    except (WireError, ModeError):
        raise
    except (KeyError, ValueError, TypeError, OverflowError, AttributeError) as e:
        raise WireError(f"malformed tensor table: {e}") from None
