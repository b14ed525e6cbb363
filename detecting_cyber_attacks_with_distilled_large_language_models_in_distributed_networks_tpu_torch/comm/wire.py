"""The port's wire formats, shared byte for byte with the JAX package.

Three vocabularies of the JAX package's ``comm/wire.py``:

* the scoring frames' magics (request, reply, reject, stats, reload and
  the auth proof, with the proof's HMAC domain), which the scoring
  service speaks;
* the model-weight message of a federated round (``FTPW``)::

      MAGIC 'FTPW' | u32 version | u32 header_len | header JSON | payload
      [+ 32-byte HMAC-SHA256 tag in auth mode]

  where the header lists every tensor as ``{key, dtype, shape, enc,
  offset, nbytes}`` plus the payload's CRC-32 and a free-form JSON
  ``meta``. Keys are '/'-joined paths through the nested params dict.
  A float32 tensor travels raw, as bf16 (``compression="bf16"``), with
  per-row or per-4096-element-chunk int8 scales (``"int8"``,
  ``"int8c"``), or as its top-k entries (``"topk[:frac]"``, the sparse
  round deltas of ``comm/client.py``);
* the streamed upload and reply: a header frame (``STRH``), sequential
  chunk frames (``STRC``) and a trailer (``STRT``), each with its own
  HMAC tag in auth mode, under separate tag domains for the upload
  (``direction="up"``) and the reply (``"down"``), so a client's own
  upload chunks replayed at it never verify as the aggregate.

Capabilities ride plain meta, one reply behind for the upload leg: a
server advertises its chunk size (``META_STREAM``) and the leaf
encodings it dequantizes (``META_WIRE_DTYPES``) in every reply; a client
advertises that it decodes streamed replies (``META_STREAM_REPLY``) and
which lossy reply encodings (``META_REPLY_DTYPES``) in every upload.

For the same inputs, nonce and key every encoder here returns the JAX
package's bytes, so a JAX peer and a port peer exchange rounds. The CRCs
and the bf16 pack run on ``native/fedwire.cpp`` (:mod:`.native`, round
to nearest even; a NaN keeps its payload with the quiet bit forced)
where the JAX wire calls it, and on their byte-equal numpy twins when it
did not build. The JAX package's static checker tracks the uniqueness of
the magics and domains there, not here.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import json
import struct
from typing import Any, Mapping

import numpy as np

from . import native
from .native import pack_bf16, unpack_bf16
from .quant import dequantize_int8c, int8c_nbytes, quantize_int8c


class WireError(ValueError):
    """Malformed, truncated, or tampered wire message."""


class ModeError(ValueError):
    """A protocol mode the peer asked for that this side does not speak
    (secure aggregation, central DP, relays). Not a :class:`WireError`:
    retrying cannot help."""


#: One flow record to score (text or raw features) + an optional deadline.
SCORE_REQ_MAGIC = b"SCRQ"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
#: P(attack) plus serving telemetry (model round, batch size, queue wait).
SCORE_REP_MAGIC = b"SCRP"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
#: The explicit 503/504-style refusal (admission control, deadline).
SCORE_REJ_MAGIC = b"SCRJ"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
#: The client's answer to an authenticated scoring server's NONCE
#: challenge: SCORE_AUTH_MAGIC + HMAC-SHA256(key, SCORE_AUTH_DOMAIN + nonce).
SCORE_AUTH_MAGIC = b"SCAU"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
SCORE_AUTH_DOMAIN = b"fedtpu-score-auth-v1"
#: The in-band stats probe and its reply (the server's stats() snapshot).
SCORE_STAT_MAGIC = b"SCST"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
SCORE_STATR_MAGIC = b"SCSR"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
#: Reload now: a forced watcher poll at the next batch boundary, answered
#: once the adoption attempt finished.
SCORE_RELOAD_MAGIC = b"SCRL"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
SCORE_RELOADR_MAGIC = b"SCRD"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol

#: A model-weight message (a client's upload, the server's aggregate).
MAGIC = b"FTPW"  # fedtpu: allow(wire-magic-coverage): the JAX package's weight-message magic, copied byte for byte so both packages exchange rounds
VERSION = 1
#: HMAC-SHA256 tag appended after the payload when a shared key is used.
AUTH_TAG_LEN = 32
_AUTH_SCHEME = "hmac-sha256"
#: Challenge frame an authenticated server sends on connect: NONCE_MAGIC +
#: NONCE_LEN random bytes, echoed (hex) in the client's upload meta and in
#: the server's reply meta.
NONCE_MAGIC = b"NONC"  # fedtpu: allow(wire-magic-coverage): the JAX package's auth-challenge magic, copied byte for byte so both packages authenticate one protocol
NONCE_LEN = 16
#: Streamed-upload and streamed-reply frames: header, sequential payload
#: chunk, trailer.
STREAM_MAGIC = b"STRH"  # fedtpu: allow(wire-magic-coverage): the JAX package's stream-header magic, copied byte for byte so both packages stream one protocol
STREAM_CHUNK_MAGIC = b"STRC"  # fedtpu: allow(wire-magic-coverage): the JAX package's stream-chunk magic, copied byte for byte so both packages stream one protocol
STREAM_END_MAGIC = b"STRT"  # fedtpu: allow(wire-magic-coverage): the JAX package's stream-trailer magic, copied byte for byte so both packages stream one protocol
#: Central-DP handshake (after the nonce, if any). The server speaks
#: first: DP_MAGIC + f64 clip + f64 noise multiplier + f64 sampling rate
#: q, so a plain client can diagnose the mode mismatch; the client names
#: itself (DPID_MAGIC + i64 client_id) and the server answers the round's
#: Poisson cohort verdict (DPCOHORT_MAGIC + u8 sampled). A sampled client
#: uploads its clipped round delta; a non-sampled one sits the round out
#: and still gets the round's reply. Under auth a sitting-out client first
#: proves key knowledge: DPSKIP_MAGIC + HMAC(key, DPSKIP_DOMAIN + nonce +
#: i64 id).
DP_MAGIC = b"DPAD"  # fedtpu: allow(wire-magic-coverage): the JAX package's DP-advert magic, copied byte for byte so both packages run one central-DP handshake
DPID_MAGIC = b"DPID"  # fedtpu: allow(wire-magic-coverage): the JAX package's DP id-hello magic, copied byte for byte so both packages run one central-DP handshake
DPCOHORT_MAGIC = b"DPCO"  # fedtpu: allow(wire-magic-coverage): the JAX package's DP cohort-verdict magic, copied byte for byte so both packages run one central-DP handshake
DPSKIP_MAGIC = b"DPSK"  # fedtpu: allow(wire-magic-coverage): the JAX package's DP sit-out-ack magic, copied byte for byte so both packages run one central-DP handshake
DPSKIP_DOMAIN = b"fedtpu-dp-skip-v1"
#: Secure aggregation (comm/secure.py). A secure server opens with the
#: round advert ROUND_MAGIC + u64 round + SESSION_LEN session bytes + u8
#: protocol (0 reveal, 1 double); the client answers PUBKEY_MAGIC + i64 id
#: + its DH public value [+ tag], and the server relays every keyed
#: participant's as KEYS_MAGIC + n x (i64 id + public value [+ tag]).
ROUND_MAGIC = b"RNDX"  # fedtpu: allow(wire-magic-coverage): the JAX package's secure round-advert magic, copied byte for byte so both packages mask one round
SESSION_LEN = 16
PUBKEY_MAGIC = b"DHPK"  # fedtpu: allow(wire-magic-coverage): the JAX package's DH hello magic, copied byte for byte so both packages mask one round
KEYS_MAGIC = b"DHKS"  # fedtpu: allow(wire-magic-coverage): the JAX package's DH keys-relay magic, copied byte for byte so both packages mask one round
#: The dropout reveal round (protocol "reveal"): request and answer.
REVEAL_MAGIC = b"RVLQ"  # fedtpu: allow(wire-magic-coverage): the JAX package's reveal-request magic, copied byte for byte so both packages unmask one round
REVEAL_RESP_MAGIC = b"RVLA"  # fedtpu: allow(wire-magic-coverage): the JAX package's reveal-answer magic, copied byte for byte so both packages unmask one round
#: Double masking: a dealer's share blobs, the holder's relayed shareset,
#: the unmask request and its answer.
SHARES_MAGIC = b"SHRS"  # fedtpu: allow(wire-magic-coverage): the JAX package's share-deal magic, copied byte for byte so both packages unmask one round
SHARESET_MAGIC = b"SHST"  # fedtpu: allow(wire-magic-coverage): the JAX package's shareset magic, copied byte for byte so both packages unmask one round
UNMASK_MAGIC = b"UMRQ"  # fedtpu: allow(wire-magic-coverage): the JAX package's unmask-request magic, copied byte for byte so both packages unmask one round
UNMASK_RESP_MAGIC = b"UMRS"  # fedtpu: allow(wire-magic-coverage): the JAX package's unmask-answer magic, copied byte for byte so both packages unmask one round
#: Reply meta: the server's preferred upload chunk bytes (the stream offer).
META_STREAM = "stream"
#: Upload meta: a truthy value means this client decodes streamed replies.
META_STREAM_REPLY = "stream_reply"
#: Reply meta: the strategy that produced this global, ``{"name", "params"}``.
META_STRATEGY = "strategy"
#: Reply meta: the lossy stream leaf encodings the server dequantizes.
META_WIRE_DTYPES = "wire_dtypes"
#: Upload meta: the lossy stream leaf encodings the client dequantizes.
META_REPLY_DTYPES = "reply_dtypes"
#: Upload meta: a truthy value marks a client re-homed off a dead parent;
#: the adoptive server folds it as an extra contributor.
META_REHOMED = "rehomed"
#: Upload meta on a relay's upward upload: the ascending client ids its
#: subtree partial folded (the root's assignment record).
META_SUBTREE_IDS = "subtree_ids"
#: ``--wire-dtype`` / ``--reply-dtype`` values -> the stream leaf encoding
#: each negotiates (``int8`` is the per-chunk-scale codec, comm/quant.py).
WIRE_DTYPE_ENCS = {"fp32": "raw", "bf16": "bf16", "int8": "int8c"}
DEFAULT_STREAM_CHUNK = 4 << 20  # 4 MiB: bounds receiver buffering
#: Worst-case STRC frame bytes beyond the chunk data itself (magic + u64
#: seq + auth tag): an advertised chunk size leaves this under MAX_FRAME.
STREAM_CHUNK_OVERHEAD = len(STREAM_CHUNK_MAGIC) + 8 + AUTH_TAG_LEN

#: Direction-bound HMAC domains of the stream frames (header, chunk,
#: trailer): "up" = client upload, "down" = server reply.
_STREAM_DOMAINS = {
    "up": (
        b"fedtpu-stream-hdr-v1",
        b"fedtpu-stream-chk-v1",
        b"fedtpu-stream-end-v1",
    ),
    "down": (
        b"fedtpu-stream-rhdr-v1",
        b"fedtpu-stream-rchk-v1",
        b"fedtpu-stream-rend-v1",
    ),
}
#: Leaf encodings a stream may carry: those whose encoded byte count is
#: computable from (dtype, shape) alone, so the header is planned before
#: any leaf is gathered off the card.
_STREAM_ENCS = ("raw", "bf16", "int8", "int8c")
_ALLOWED_DTYPES = {
    "float32", "float64", "float16", "bfloat16",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool",
}
DEFAULT_TOPK_FRAC = 0.01
#: Densified-tensor allocation cap: a top-k payload is ~8 bytes a kept
#: entry whatever dense shape it claims, so the claim is bounded before
#: any allocation (the JAX package's bound, one frame's worth).
MAX_DENSE_TENSOR_BYTES = 8 << 30


def stream_chunk_bytes_from_mb(mb) -> int:
    """``--stream-chunk-mb`` -> advertised chunk bytes (None = default)."""
    if mb is None:
        return DEFAULT_STREAM_CHUNK
    return int(float(mb) * (1 << 20))


def _stream_domains(direction: str) -> tuple[bytes, bytes, bytes]:
    try:
        return _STREAM_DOMAINS[direction]
    except KeyError:
        raise WireError(f"unknown stream direction {direction!r}") from None


# --------------------------------------------------- int8 row quantization
def _int8_rows(arr: np.ndarray) -> tuple[np.ndarray, int]:
    """``arr`` as [rows, cols] (leading axis = rows; scalars and 1-D are
    one row); explicit cols so zero-size tensors reshape cleanly."""
    rows = arr.shape[0] if arr.ndim >= 2 else 1
    cols = arr.size // rows if rows else 0
    return arr.reshape(rows, cols), rows


def quantize_int8(arr: np.ndarray) -> bytes:
    """fp32 tensor -> payload bytes: [rows x fp32 scale] + [int8 data]."""
    a, rows = _int8_rows(np.ascontiguousarray(arr, np.float32))
    amax = np.abs(a).max(axis=1) if a.size else np.zeros(rows, np.float32)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(a / scales[:, None]), -127, 127).astype(np.int8)
    return scales.tobytes() + q.tobytes()


def dequantize_int8(raw, shape: tuple[int, ...]) -> np.ndarray:
    """Inverse of :func:`quantize_int8` for a tensor of ``shape``."""
    rows = shape[0] if len(shape) >= 2 else 1
    cols = int(np.prod(shape)) // rows if rows else 0
    want = 4 * rows + rows * cols
    if len(raw) != want:
        raise WireError(f"int8 tensor payload is {len(raw)} bytes, expected {want}")
    scales = np.frombuffer(raw[: 4 * rows], np.float32)
    q = np.frombuffer(raw[4 * rows :], np.int8).reshape(rows, cols)
    return (q.astype(np.float32) * scales[:, None]).reshape(shape)


# ------------------------------------------------------ top-k sparsification
def parse_compression(spec: str) -> tuple[str, float | None]:
    """``"topk:0.05"`` -> ``("topk", 0.05)``; plain modes -> ``(spec, None)``."""
    if spec.startswith("topk"):
        frac = DEFAULT_TOPK_FRAC
        if spec != "topk":
            if not spec.startswith("topk:"):
                raise WireError(f"unknown compression {spec!r}")
            try:
                frac = float(spec.split(":", 1)[1])
            except ValueError:
                raise WireError(f"bad topk fraction in {spec!r}") from None
        if not 0.0 < frac <= 1.0:
            raise WireError(f"topk fraction {frac} outside (0, 1]")
        return "topk", frac
    if spec not in ("none", "bf16", "int8", "int8c"):
        raise WireError(f"unknown compression {spec!r}")
    return spec, None


def sparsify_topk(arr: np.ndarray, frac: float) -> bytes:
    """fp32 tensor -> ``u32 k | int32 idx[k] | fp32 vals[k]``, keeping the
    ``k = max(1, round(frac * size))`` largest-|value| entries, selected
    by numpy's ``argpartition`` (its tie order is part of the bytes) and
    sorted by index."""
    a = np.ascontiguousarray(arr, np.float32).reshape(-1)
    if a.size == 0:
        return struct.pack("<I", 0)
    k = max(1, int(round(frac * a.size)))
    if k >= a.size:
        idx = np.arange(a.size, dtype=np.int32)
    else:
        idx = np.sort(np.argpartition(np.abs(a), -k)[-k:]).astype(np.int32)
    return struct.pack("<I", len(idx)) + idx.tobytes() + a[idx].tobytes()


def densify_topk(raw, shape: tuple[int, ...]) -> np.ndarray:
    """Inverse of :func:`sparsify_topk`: zeros but the kept entries. The
    payload is untrusted: every bound is checked before allocating."""
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if size < 0 or 4 * size > MAX_DENSE_TENSOR_BYTES:
        raise WireError(
            f"topk tensor claims dense size {size} (> {MAX_DENSE_TENSOR_BYTES // 4} elements)"
        )
    if len(raw) < 4:
        raise WireError("topk tensor payload shorter than its count field")
    (k,) = struct.unpack("<I", bytes(raw[:4]))
    if k > size:
        raise WireError(f"topk count {k} exceeds dense tensor size {size}")
    if len(raw) != 4 + 8 * k:
        raise WireError(f"topk tensor payload is {len(raw)} bytes, expected {4 + 8 * k}")
    idx = np.frombuffer(raw, np.int32, count=k, offset=4)
    vals = np.frombuffer(raw, np.float32, count=k, offset=4 + 4 * k)
    out = np.zeros(size, np.float32)
    if k:
        if idx.min() < 0 or idx.max() >= size:
            raise WireError("topk index out of tensor bounds")
        out[idx] = vals
    return out.reshape(shape)


class PreEncoded:
    """A tensor whose wire payload is already built (the sparse-delta
    client keeps the kept entries for its error feedback and hands the
    bytes straight to :func:`encode`)."""

    __slots__ = ("enc", "buf", "shape", "dtype")

    def __init__(self, enc: str, buf: bytes, shape: tuple, dtype: str = "float32"):
        self.enc = enc
        self.buf = buf
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype


def shapes_compatible(a: Mapping[str, Any], b: Mapping[str, Any]) -> bool:
    """Identical key sets and per-key shapes: delta and residual
    arithmetic between two flat dicts is well defined."""
    if set(a) != set(b):
        return False
    return all(np.asarray(a[k]).shape == np.asarray(b[k]).shape for k in a)


def flat_l2_norm(flat: Mapping[str, Any]) -> float:
    """Global L2 norm over every tensor of a flat dict, accumulated in
    float64: the one norm the DP client's clip and the DP server's
    re-clip both compute (their tolerance depends on agreeing)."""
    return float(np.sqrt(sum(float(np.sum(np.asarray(v, np.float64) ** 2)) for v in flat.values())))


def clip_flat(flat: Mapping[str, Any], clip: float) -> tuple[dict[str, np.ndarray], float, float]:
    """Scale a flat delta dict to global L2 norm <= ``clip``; returns
    ``(clipped fp32 dict, original norm, applied scale)``."""
    norm = flat_l2_norm(flat)
    scale = min(1.0, clip / max(norm, 1e-12))
    return {k: np.asarray(v, np.float32) * np.float32(scale) for k, v in flat.items()}, norm, scale


def flat_crc32(flat: Mapping[str, Any]) -> int:
    """CRC-32 over the sorted-key concatenation of a flat dict's fp32
    tensor bytes: the checksum every replay of a round's aggregate pins,
    and the sparse tier's base-agreement stamp (``agg_crc``)."""
    crc = 0
    for key in sorted(flat):
        arr = np.ascontiguousarray(np.asarray(flat[key], np.float32))
        crc = native.crc32(arr, crc)
    return crc & 0xFFFFFFFF


# ------------------------------------------------------- pytree <-> flat
def flatten_params(tree: Any, *, sep: str = "/", leaf_fn=np.asarray) -> dict[str, Any]:
    """Nested dict of arrays -> sorted flat ``{'a/b/c': leaf_fn(leaf)}``."""
    out: dict[str, Any] = {}

    def _walk(node, prefix):
        if isinstance(node, Mapping):
            for key in node:
                if sep in str(key):
                    raise WireError(f"param key {key!r} contains separator {sep!r}")
                _walk(node[key], f"{prefix}{sep}{key}" if prefix else str(key))
        else:
            out[prefix] = leaf_fn(node)

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


def _flat(params: Any) -> dict:
    if isinstance(params, Mapping) and all(not isinstance(v, Mapping) for v in params.values()):
        return dict(params)
    return flatten_params(params)


# ----------------------------------------------------------------- encode
def _encode_leaf(arr: np.ndarray, compression: str, topk_frac: float | None) -> tuple[bytes, str]:
    if arr.dtype == np.float32:
        if compression == "bf16":
            return pack_bf16(arr).tobytes(), "bf16"
        if compression == "int8":
            return quantize_int8(arr), "int8"
        if compression == "int8c":
            return quantize_int8c(arr), "int8c"
        if compression == "topk":
            return sparsify_topk(arr, topk_frac), "topk"
    return np.ascontiguousarray(arr).tobytes(), "raw"


def encode(
    params: Any,
    *,
    meta: Mapping[str, Any] | None = None,
    compression: str = "none",
    auth_key: bytes | None = None,
) -> bytes:
    """Params (nested dict, or flat dict of arrays or :class:`PreEncoded`)
    -> wire bytes; ``auth_key`` appends an HMAC-SHA256 tag over the whole
    message."""
    compression, topk_frac = parse_compression(compression)
    tensors = []
    chunks: list[bytes] = []
    offset = 0
    for key, arr in _flat(params).items():
        if isinstance(arr, PreEncoded):
            dtype, shape, enc, buf = arr.dtype, arr.shape, arr.enc, arr.buf
        else:
            arr = np.asarray(arr)
            dtype, shape = str(arr.dtype), arr.shape
            if dtype not in _ALLOWED_DTYPES:
                raise WireError(f"tensor {key!r} has unsupported dtype {dtype}")
            buf, enc = _encode_leaf(arr, compression, topk_frac)
        tensors.append(
            {"key": key, "dtype": dtype, "shape": list(shape), "enc": enc,
             "offset": offset, "nbytes": len(buf)}
        )
        chunks.append(buf)
        offset += len(buf)
    payload = b"".join(chunks)
    header = {
        "tensors": tensors,
        "payload_nbytes": len(payload),
        "payload_crc32": native.crc32(payload),
        "meta": dict(meta or {}),
    }
    if auth_key is not None:
        header["auth"] = _AUTH_SCHEME
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    msg = MAGIC + struct.pack("<II", VERSION, len(hbytes)) + hbytes + payload
    if auth_key is not None:
        msg += hmac_mod.new(auth_key, msg, hashlib.sha256).digest()
    return msg


def decode_tensor_entry(t: Mapping[str, Any], raw) -> np.ndarray:
    """One tensor-table entry's payload bytes -> ndarray: the one per-leaf
    decoder of the single-frame and the streamed paths."""
    dtype = t["dtype"]
    if dtype not in _ALLOWED_DTYPES:
        raise WireError(f"tensor {t.get('key')!r} has unsupported dtype {dtype}")
    shape = tuple(t["shape"])
    if t["enc"] == "bf16":
        return unpack_bf16(np.frombuffer(raw, np.uint16), shape=shape)
    if t["enc"] == "int8":
        return dequantize_int8(raw, shape)
    if t["enc"] == "int8c":
        return dequantize_int8c(raw, shape)
    if t["enc"] == "topk":
        return densify_topk(raw, shape)
    if t["enc"] == "raw":
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(t["shape"])
    raise WireError(f"unknown tensor encoding {t['enc']!r}")


# ----------------------------------------------------------------- decode
def decode(
    data: bytes | memoryview, *, auth_key: bytes | None = None
) -> tuple[dict, dict]:
    """Wire bytes -> ``(nested params dict, meta dict)``; verifies the CRC.
    With ``auth_key`` only a message with a valid tag is accepted; without
    one, a trailing tag is skipped (the peer authenticated, this side has
    no key)."""
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
    auth = header.get("auth")
    if auth not in (None, _AUTH_SCHEME):
        raise WireError(f"unknown auth scheme {auth!r}")
    if auth_key is not None and auth != _AUTH_SCHEME:
        raise WireError(f"unauthenticated message rejected (this side requires {_AUTH_SCHEME})")
    if auth == _AUTH_SCHEME:
        if len(view) < 12 + hlen + AUTH_TAG_LEN:
            raise WireError("truncated auth tag")
        body_end = len(view) - AUTH_TAG_LEN
        if auth_key is not None:
            want = hmac_mod.new(auth_key, view[:body_end], hashlib.sha256).digest()
            if not hmac_mod.compare_digest(bytes(view[body_end:]), want):
                raise WireError("HMAC verification failed (tampered or wrong key)")
        payload = view[12 + hlen : body_end]
    else:
        payload = view[12 + hlen :]
    if len(payload) != header.get("payload_nbytes"):
        raise WireError(
            f"payload length {len(payload)} != declared {header.get('payload_nbytes')}"
        )
    crc = native.crc32(payload)
    if crc != header.get("payload_crc32"):
        raise WireError(
            f"payload CRC mismatch (got {crc:#010x}, "
            f"header says {header.get('payload_crc32', 0):#010x})"
        )
    flat: dict[str, np.ndarray] = {}
    # Header fields come from the peer: any inconsistency must surface as
    # WireError, not leak as KeyError/TypeError and kill a server thread.
    try:
        tensors = header["tensors"]
        # Per-message cap on the dense bytes top-k tensors claim: their
        # shapes are unbacked by payload bytes.
        claimed = sum(
            int(np.prod(t["shape"], dtype=np.int64)) * 4 for t in tensors if t.get("enc") == "topk"
        )
        if claimed > MAX_DENSE_TENSOR_BYTES:
            raise WireError(
                f"message claims {claimed} dense bytes across topk tensors (> {MAX_DENSE_TENSOR_BYTES})"
            )
        for t in tensors:
            key = t["key"]
            offset, nbytes = int(t["offset"]), int(t["nbytes"])
            if offset < 0 or nbytes < 0 or offset + nbytes > len(payload):
                raise WireError(f"tensor {key!r} has out-of-bounds extent")
            flat[key] = decode_tensor_entry(t, payload[offset : offset + nbytes])
        return unflatten_params(flat), dict(header.get("meta", {}))
    except WireError:
        raise
    except (KeyError, ValueError, TypeError, OverflowError, AttributeError) as e:
        raise WireError(f"malformed tensor table: {e}") from None


# ------------------------------------------------------- streamed uploads
def flatten_lazy(tree: Any, *, sep: str = "/") -> dict[str, Any]:
    """Like :func:`flatten_params` but leaves a leaf with ``.shape`` and
    ``.dtype`` as it is (``models.convert.HostLeaf``: a tensor on the card,
    gathered only when the stream packs it); an already-flat dict passes
    through, sorted."""

    def _leaf(node):
        if isinstance(node, PreEncoded) or (hasattr(node, "dtype") and hasattr(node, "shape")):
            return node
        return np.asarray(node)

    if isinstance(tree, Mapping) and tree and all(not isinstance(v, Mapping) for v in tree.values()):
        return dict(sorted((str(k), _leaf(v)) for k, v in tree.items()))
    return flatten_params(tree, sep=sep, leaf_fn=_leaf)


def _leaf_plan(key: str, leaf: Any, compression: str) -> dict:
    """One tensor-table entry (enc + exact encoded byte count) from the
    leaf's metadata alone: no gather, no encode."""
    if isinstance(leaf, PreEncoded):
        return {"key": key, "dtype": leaf.dtype, "shape": list(leaf.shape), "enc": leaf.enc,
                "nbytes": len(leaf.buf)}
    dtype = str(np.dtype(leaf.dtype))
    if dtype not in _ALLOWED_DTYPES:
        raise WireError(f"tensor {key!r} has unsupported dtype {dtype}")
    shape = tuple(int(s) for s in leaf.shape)
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if compression == "bf16" and dtype == "float32":
        enc, nbytes = "bf16", 2 * size
    elif compression == "int8" and dtype == "float32":
        rows = shape[0] if len(shape) >= 2 else 1
        enc, nbytes = "int8", 4 * rows + size
    elif compression == "int8c" and dtype == "float32":
        enc, nbytes = "int8c", int8c_nbytes(size)
    else:
        enc, nbytes = "raw", size * np.dtype(dtype).itemsize
    return {"key": key, "dtype": dtype, "shape": list(shape), "enc": enc, "nbytes": nbytes}


def plan_stream(flat: Mapping[str, Any], compression: str = "none") -> tuple[list[dict], int]:
    """Flat (possibly lazy) param dict -> (contiguous tensor table,
    payload bytes). ``topk`` is not plannable: its size depends on the
    values, so sparse deltas stay single-frame."""
    comp, _ = parse_compression(compression)
    if comp == "topk":
        raise WireError("topk uploads cannot be streamed (size is data-dependent)")
    tensors: list[dict] = []
    offset = 0
    for key, leaf in flat.items():
        t = _leaf_plan(key, leaf, comp)
        t["offset"] = offset
        offset += int(t["nbytes"])
        tensors.append(t)
    return tensors, offset


def encode_stream_leaf(leaf: Any, enc: str) -> bytes:
    """One planned leaf's payload bytes (a lazy leaf is gathered here)."""
    if isinstance(leaf, PreEncoded):
        return leaf.buf
    arr = np.asarray(leaf)
    if enc == "bf16":
        return pack_bf16(arr).tobytes()
    if enc == "int8":
        return quantize_int8(arr)
    if enc == "int8c":
        return quantize_int8c(arr)
    if enc == "raw":
        return np.ascontiguousarray(arr).tobytes()
    raise WireError(f"unknown stream leaf encoding {enc!r}")


def _stream_tag(domain: bytes, auth_key: bytes, nonce: bytes, body: bytes) -> bytes:
    return hmac_mod.new(auth_key, domain + nonce + body, hashlib.sha256).digest()


def encode_stream_header(
    tensors: list[dict],
    *,
    meta: Mapping[str, Any] | None = None,
    chunk_bytes: int,
    payload_nbytes: int,
    auth_key: bytes | None = None,
    direction: str,
) -> bytes:
    """The STRH frame. In auth mode the tag covers magic, version and the
    header JSON under the direction's domain; freshness comes from the
    connection nonce the meta carries."""
    hdr_domain, _, _ = _stream_domains(direction)
    header = {
        "tensors": tensors,
        "payload_nbytes": int(payload_nbytes),
        "chunk_bytes": int(chunk_bytes),
        "meta": dict(meta or {}),
    }
    if auth_key is not None:
        header["auth"] = _AUTH_SCHEME
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    msg = STREAM_MAGIC + struct.pack("<II", VERSION, len(hbytes)) + hbytes
    if auth_key is not None:
        msg += _stream_tag(hdr_domain, auth_key, b"", msg)
    return msg


def decode_stream_header(
    data,
    *,
    auth_key: bytes | None = None,
    max_payload: int = 8 << 30,
    direction: str,
) -> tuple[list[dict], dict, int, int]:
    """STRH frame -> (tensor table, meta, chunk_bytes, payload_nbytes).
    Validates what :func:`decode` validates plus the stream's invariant:
    tensor extents are contiguous from offset 0 and sum to the payload,
    so the receiver decodes leaves in one sequential pass."""
    hdr_domain, _, _ = _stream_domains(direction)
    view = memoryview(data)
    if len(view) < 12 or bytes(view[:4]) != STREAM_MAGIC:
        raise WireError("bad magic: not a stream header")
    version, hlen = struct.unpack("<II", view[4:12])
    if version != VERSION:
        raise WireError(f"stream version {version} unsupported (expected {VERSION})")
    if len(view) < 12 + hlen:
        raise WireError("truncated stream header")
    body_end = 12 + hlen
    try:
        header = json.loads(bytes(view[12:body_end]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"malformed stream header: {e}") from None
    if not isinstance(header, dict):
        raise WireError("malformed stream header: not a JSON object")
    auth = header.get("auth")
    if auth not in (None, _AUTH_SCHEME):
        raise WireError(f"unknown auth scheme {auth!r}")
    if auth_key is not None:
        if auth != _AUTH_SCHEME:
            raise WireError(f"unauthenticated stream rejected (this side requires {_AUTH_SCHEME})")
        if len(view) != body_end + AUTH_TAG_LEN:
            raise WireError("stream header missing its auth tag")
        want = _stream_tag(hdr_domain, auth_key, b"", bytes(view[:body_end]))
        if not hmac_mod.compare_digest(bytes(view[body_end:]), want):
            raise WireError("stream header HMAC verification failed")
    try:
        tensors = list(header["tensors"])
        payload_nbytes = int(header["payload_nbytes"])
        chunk_bytes = int(header["chunk_bytes"])
        if not 0 < chunk_bytes <= max_payload:
            raise WireError(f"stream chunk_bytes {chunk_bytes} out of range")
        if not 0 <= payload_nbytes <= max_payload:
            raise WireError(f"stream payload {payload_nbytes} out of range")
        offset = 0
        for t in tensors:
            if t.get("enc") not in _STREAM_ENCS:
                raise WireError(
                    f"tensor {t.get('key')!r} has non-streamable encoding {t.get('enc')!r}"
                )
            if t["dtype"] not in _ALLOWED_DTYPES:
                raise WireError(f"tensor {t.get('key')!r} has unsupported dtype {t['dtype']}")
            if int(t["offset"]) != offset or int(t["nbytes"]) < 0:
                raise WireError(
                    f"tensor {t.get('key')!r} breaks the stream's contiguous extent invariant"
                )
            offset += int(t["nbytes"])
        if offset != payload_nbytes:
            raise WireError(
                f"tensor extents sum to {offset}, header claims {payload_nbytes} payload bytes"
            )
        keys = [t["key"] for t in tensors]
        if len(set(keys)) != len(keys):
            raise WireError("duplicate tensor key in stream header")
        return tensors, dict(header.get("meta", {})), chunk_bytes, payload_nbytes
    except WireError:
        raise
    except (KeyError, ValueError, TypeError, OverflowError, AttributeError) as e:
        raise WireError(f"malformed stream tensor table: {e}") from None


def encode_stream_chunk(
    seq: int,
    data: bytes,
    *,
    auth_key: bytes | None = None,
    nonce: bytes = b"",
    direction: str,
) -> bytes:
    _, chk_domain, _ = _stream_domains(direction)
    body = STREAM_CHUNK_MAGIC + struct.pack("<Q", seq) + data
    if auth_key is not None:
        body += _stream_tag(chk_domain, auth_key, nonce, body)
    return body


def decode_stream_chunk(
    frame,
    *,
    expect_seq: int,
    auth_key: bytes | None = None,
    nonce: bytes = b"",
    direction: str,
):
    """STRC frame -> chunk bytes (memoryview), its tag verified first, so
    every byte the server folds was authenticated."""
    _, chk_domain, _ = _stream_domains(direction)
    view = memoryview(frame)
    n_magic = len(STREAM_CHUNK_MAGIC)
    tag_len = AUTH_TAG_LEN if auth_key is not None else 0
    if len(view) < n_magic + 8 + tag_len or bytes(view[:n_magic]) != STREAM_CHUNK_MAGIC:
        raise WireError("bad stream chunk frame")
    (seq,) = struct.unpack("<Q", view[n_magic : n_magic + 8])
    if seq != expect_seq:
        raise WireError(f"stream chunk out of order (got {seq}, want {expect_seq})")
    body_end = len(view) - tag_len
    if auth_key is not None:
        want = _stream_tag(chk_domain, auth_key, nonce, bytes(view[:body_end]))
        if not hmac_mod.compare_digest(bytes(view[body_end:]), want):
            raise WireError(f"stream chunk {seq} HMAC verification failed")
    return view[n_magic + 8 : body_end]


def encode_stream_end(
    n_chunks: int,
    *,
    auth_key: bytes | None = None,
    nonce: bytes = b"",
    direction: str,
) -> bytes:
    _, _, end_domain = _stream_domains(direction)
    body = STREAM_END_MAGIC + struct.pack("<Q", n_chunks)
    if auth_key is not None:
        body += _stream_tag(end_domain, auth_key, nonce, body)
    return body


def decode_stream_end(
    frame,
    *,
    expect_chunks: int,
    auth_key: bytes | None = None,
    nonce: bytes = b"",
    direction: str,
) -> None:
    _, _, end_domain = _stream_domains(direction)
    view = memoryview(frame)
    n_magic = len(STREAM_END_MAGIC)
    tag_len = AUTH_TAG_LEN if auth_key is not None else 0
    if len(view) != n_magic + 8 + tag_len or bytes(view[:n_magic]) != STREAM_END_MAGIC:
        raise WireError("bad stream trailer frame")
    (n,) = struct.unpack("<Q", view[n_magic : n_magic + 8])
    if n != expect_chunks:
        raise WireError(f"stream trailer claims {n} chunks, received {expect_chunks}")
    if auth_key is not None:
        body_end = len(view) - tag_len
        want = _stream_tag(end_domain, auth_key, nonce, bytes(view[:body_end]))
        if not hmac_mod.compare_digest(bytes(view[body_end:]), want):
            raise WireError("stream trailer HMAC verification failed")
