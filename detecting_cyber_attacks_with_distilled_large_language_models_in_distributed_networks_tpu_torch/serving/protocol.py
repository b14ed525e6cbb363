"""Scoring request/reply/reject codecs over the length-framed wire.

The port's copy of the JAX package's ``serving/protocol.py`` request,
reply and reject codecs, producing the same bytes: one frame = 4-byte
magic (``comm/wire.py``) + a compact UTF-8 JSON body. ``prob`` crosses as
a JSON double; float32 -> float64 is exact and ``repr`` round-trips, so a
reply carries the engine's float32 probability bit for bit.

The stats, reload and auth frames of the JAX service are not ported yet.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

from ..comm.wire import (
    SCORE_REJ_MAGIC,
    SCORE_REP_MAGIC,
    SCORE_REQ_MAGIC,
    WireError,
)

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
