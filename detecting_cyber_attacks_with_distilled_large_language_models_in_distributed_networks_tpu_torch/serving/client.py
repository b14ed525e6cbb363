"""Scoring-service SDK: one blocking connection per thread.

Port of the JAX package's ``serving/client.py`` ``ScoringClient``; it
speaks the same frames, so it scores against either package's server.
Concurrency comes from many clients, which is what lets the server's
micro-batcher coalesce them into one padded bucket dispatch. The
pipelined and asyncio clients and the load generator come later.
"""

from __future__ import annotations

import socket
from typing import Any, Mapping

from ..comm import framing
from ..comm.wire import WireError
from . import protocol


class ScoreRejected(Exception):
    """Explicit server-side refusal (admission control / deadline)."""

    def __init__(self, code: int, reason: str, req_id: int):
        super().__init__(f"request {req_id} rejected ({code}): {reason}")
        self.code = int(code)
        self.reason = reason
        self.req_id = int(req_id)


class ScoringClient:
    """Blocking scoring connection. Not thread-safe; one per thread."""

    def __init__(self, host: str, port: int, *, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._next_id = 0

    def score(
        self,
        *,
        text: str | None = None,
        features: Mapping[str, Any] | None = None,
        deadline_ms: float | None = None,
        trace: str | None = None,
    ) -> dict:
        """Score one flow; returns the reply dict (prob, prediction,
        round, batch_size, bucket, queue_ms). Raises :class:`ScoreRejected`
        on an explicit reject frame."""
        self._next_id += 1
        req_id = self._next_id
        framing.send_frame(
            self.sock,
            protocol.build_request(
                req_id,
                text=text,
                features=features,
                deadline_ms=deadline_ms,
                trace=trace,
            ),
            await_ack=False,
        )
        reply = bytes(framing.recv_frame(self.sock, send_ack=False))
        if protocol.is_reject(reply):
            body = protocol.parse_reject(reply)
            raise ScoreRejected(body["code"], body["reason"], body["id"])
        body = protocol.parse_reply(reply)
        if body["id"] != req_id:
            raise WireError(
                f"reply for request {body['id']} arrived while awaiting "
                f"{req_id} (synchronous client; server must answer in order)"
            )
        return body

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ScoringClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
