"""Federated client session over TCP (the port of ``comm/client.py``:
the dense, fp32, plain FedAvg exchange).

The reference's client session (connect, upload, poll a second port,
download; client1.py:276-336) is one request/response on one connection
here: upload the local params, block until the aggregate comes back on
the same socket, with seeded dial backoff standing in for the reference's
``wait_for_server`` probe loop (client1.py:298-311).

The upload is one dense ``FTPW`` frame and the client advertises no
streamed reply, so a JAX server answers it with one dense frame too. Not
ported: streamed uploads and replies, quantized and sparse wires, HMAC
auth, secure aggregation, central DP, and re-homing to fallback parents.
"""

from __future__ import annotations

import logging
import random
import socket
import time
from typing import Any, Iterator, Mapping

from . import framing, wire

log = logging.getLogger(__name__)


def backoff_intervals(
    *,
    base: float = 1.0,
    cap: float = 15.0,
    factor: float = 2.0,
    seed: int | None = None,
) -> Iterator[float]:
    """Capped exponential backoff intervals with DETERMINISTIC jitter.

    The first interval is exactly ``base`` (the reference's 1 s probe
    cadence); every later one grows by ``factor`` up to ``cap``, scaled by
    a jitter in [0.5, 1.0) from ``random.Random(seed)``: a given (client,
    seed) retries on a reproducible schedule, and clients with different
    seeds do not stampede a restarting server in lockstep."""
    r = random.Random(seed)
    k = 0
    while True:
        if k == 0:
            yield float(base)
        else:
            yield min(float(cap), float(base) * float(factor) ** k) * (0.5 + 0.5 * r.random())
        k += 1


def connect_with_retry(
    host: str,
    port: int,
    *,
    timeout: float = 300.0,
    poll_interval: float = 1.0,  # the reference's 1 s first-probe cadence
    max_interval: float = 15.0,
    retry_seed: int | None = None,
) -> socket.socket:
    """Dial until the server is up or ``timeout`` elapses, retrying on
    the :func:`backoff_intervals` schedule."""
    deadline = time.monotonic() + timeout
    last: Exception | None = None
    sched = backoff_intervals(base=poll_interval, cap=max_interval, seed=retry_seed)
    while time.monotonic() < deadline:
        try:
            return socket.create_connection(
                (host, port), timeout=max(0.1, deadline - time.monotonic())
            )
        except OSError as e:
            last = e
            time.sleep(min(next(sched), max(0.0, deadline - time.monotonic())))
    raise ConnectionError(f"server {host}:{port} unreachable after {timeout}s: {last}")


class FederatedClient:
    """One client's view of a federated round over TCP."""

    def __init__(self, host: str, port: int, *, client_id: int, timeout: float = 300.0):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.timeout = timeout
        #: The last completed exchange: upload bytes and seconds, the
        #: seconds from the end of the upload to the decoded reply (the
        #: other clients' uploads, the server's fold and the reply's
        #: transfer), reply bytes, and the reply's meta.
        self.last_exchange: dict[str, Any] = {}

    def exchange(
        self,
        params: Any,
        *,
        n_samples: int = 1,
        meta: Mapping[str, Any] | None = None,
        max_retries: int = 5,  # the reference's retry budget (client1.py:314)
    ) -> dict:
        """Upload local params (a nested dict of host arrays, the JAX
        layout), return the aggregate (nested dict of numpy arrays).

        Retries the whole round trip on connection errors and on a
        malformed reply; a :class:`~.wire.ModeError` is not retried."""
        base_meta = {"client_id": self.client_id, "n_samples": int(n_samples), **dict(meta or {})}
        msg = wire.encode(params, meta=base_meta)
        last: Exception | None = None
        for attempt in range(1, max_retries + 1):
            sock = None
            try:
                sock = connect_with_retry(
                    self.host, self.port, timeout=self.timeout, retry_seed=self.client_id
                )
                sock.settimeout(self.timeout)
                log.info(
                    f"[CLIENT {self.client_id}] uploading {len(msg) / 1e6:.1f} MB "
                    f"(attempt {attempt}/{max_retries})"
                )
                t0 = time.monotonic()
                framing.send_frame(sock, msg)
                t1 = time.monotonic()
                reply = framing.recv_frame(sock)
                agg, agg_meta = wire.decode(reply)
                self.last_exchange = {
                    "upload_bytes": len(msg),
                    "upload_s": t1 - t0,
                    "reply_wait_s": time.monotonic() - t1,
                    "reply_bytes": len(reply),
                    "meta": agg_meta,
                }
                log.info(
                    f"[CLIENT {self.client_id}] received the aggregate "
                    f"({len(reply) / 1e6:.1f} MB, clients {agg_meta.get('round_clients')})"
                )
                return agg
            except (OSError, wire.WireError) as e:
                last = e
                log.info(f"[CLIENT {self.client_id}] round attempt {attempt} failed: {e}")
                if attempt < max_retries:
                    time.sleep(min(2.0**attempt, 10.0))
            finally:
                if sock is not None:
                    sock.close()
        raise ConnectionError(
            f"client {self.client_id}: round failed after {max_retries} attempts: {last}"
        )
