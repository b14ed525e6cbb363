"""Scoring-service SDK and load generator.

The port's copy of the JAX package's ``serving/client.py``; it speaks the
same frames, so every shape here scores against either package's server.

* :class:`ScoringClient` — one blocking connection, one request at a
  time; concurrency comes from many clients, which is what lets the
  server's micro-batcher coalesce them into one padded bucket dispatch.
* :class:`PipelinedScoringClient` — many requests in flight on one
  connection: ``submit()`` returns a future and a reader thread matches
  replies by the protocol's id echo, so out-of-order replies resolve.
* :class:`AsyncScoringClient` — the asyncio twin of the pipelined shape.

Each answers an authenticated server's nonce challenge when given
``auth_key``. :func:`run_load` drives a service with them: closed loop,
pipelined, open loop at a target rate, or replaying a recorded arrival
trace, and reports client-observed throughput and latency percentiles.
"""

from __future__ import annotations

import asyncio
import collections
import socket
import struct
import threading
import time
import zlib
from concurrent.futures import Future
from typing import Any, Mapping, Sequence, Union

import numpy as np

from ..comm import framing
from ..comm.wire import NONCE_LEN, NONCE_MAGIC, WireError
from . import protocol

#: One item of load: a rendered ``text`` or a raw ``features`` record.
Flow = Union[str, Mapping[str, Any]]

_AUTH_NEEDED = (
    "server requires authentication — construct the client with auth_key "
    "(server runs with --auth)"
)


class ScoreRejected(Exception):
    """Explicit server-side refusal (admission control / deadline)."""

    def __init__(self, code: int, reason: str, req_id: int):
        super().__init__(f"request {req_id} rejected ({code}): {reason}")
        self.code = int(code)
        self.reason = reason
        self.req_id = int(req_id)


def _set_nodelay(sock: socket.socket) -> None:
    """Nagle off on a scoring socket: small frames written header +
    payload would stall on delayed ACKs, twice over behind a router."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


def _connect(host: str, port: int, timeout: float, auth_key: bytes | None) -> socket.socket:
    """A scoring connection with Nagle off, authenticated when keyed."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(timeout)
    _set_nodelay(sock)
    if auth_key is not None:
        try:
            answer_auth_challenge(sock, auth_key)
        except WireError:
            sock.close()
            raise
    return sock


def _check_challenge(chal: bytes) -> bytes:
    """The nonce of a server's auth challenge frame."""
    if len(chal) != len(NONCE_MAGIC) + NONCE_LEN or not chal.startswith(NONCE_MAGIC):
        raise WireError(f"bad auth challenge from server (magic {chal[:4]!r})")
    return chal[len(NONCE_MAGIC):]


def answer_auth_challenge(sock: socket.socket, auth_key: bytes) -> None:
    """Client side of the scoring port's HMAC handshake: read the
    server's nonce challenge, answer with the keyed proof."""
    try:
        chal = bytes(framing.recv_frame(sock, send_ack=False))
    except (OSError, ConnectionError) as e:
        raise WireError(f"server sent no auth challenge — is it running with --auth? ({e})") from None
    framing.send_frame(
        sock, protocol.build_auth_response(auth_key, _check_challenge(chal)), await_ack=False
    )


def _request_kw(flow: Flow) -> dict:
    """``text=`` for a string, ``features=`` for a mapping."""
    return {"text": flow} if isinstance(flow, str) else {"features": flow}


def _resolve(frame: bytes):
    """(result, exception) of one id-matched reply frame."""
    if protocol.is_reject(frame):
        body = protocol.parse_reject(frame)
        return None, ScoreRejected(body["code"], body["reason"], body["id"])
    if protocol.is_stats_reply(frame):
        return protocol.parse_stats_reply(frame)["stats"], None
    return protocol.parse_reply(frame), None


class ScoringClient:
    """Blocking scoring connection. Not thread-safe; one per thread.

    ``auth_key``: the scoring port's shared secret (server ``--auth``);
    the constructor answers the server's challenge. A keyless client of
    an ``--auth`` server fails with a WireError naming the fix."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        timeout: float = 30.0,
        auth_key: bytes | None = None,
    ):
        self.sock = _connect(host, port, timeout, auth_key)
        self._next_id = 0

    def _exchange(self, frame_of_id) -> bytes:
        self._next_id += 1
        req_id = self._next_id
        framing.send_frame(self.sock, frame_of_id(req_id), await_ack=False)
        reply = bytes(framing.recv_frame(self.sock, send_ack=False))
        if reply[:4] == NONCE_MAGIC:
            raise WireError(_AUTH_NEEDED)
        got = protocol.frame_id(reply)
        if got != req_id:
            raise WireError(
                f"reply for request {got} arrived while awaiting {req_id} "
                "(synchronous client; server must answer in order)"
            )
        return reply

    def score(
        self,
        *,
        text: str | None = None,
        features: Mapping[str, Any] | None = None,
        deadline_ms: float | None = None,
        trace: str | None = None,
    ) -> dict:
        """Score one flow; returns the reply dict (prob, prediction,
        round, batch_size, bucket, queue_ms, and class_probs for a K-class
        head). Raises :class:`ScoreRejected` on an explicit reject frame."""
        reply = self._exchange(lambda rid: protocol.build_request(
            rid, text=text, features=features, deadline_ms=deadline_ms, trace=trace
        ))
        if protocol.is_reject(reply):
            body = protocol.parse_reject(reply)
            raise ScoreRejected(body["code"], body["reason"], body["id"])
        return protocol.parse_reply(reply)

    def stats(self) -> dict:
        """The server's ``stats()`` snapshot over this connection."""
        return protocol.parse_stats_reply(self._exchange(protocol.build_stats_request))["stats"]

    def reload(self) -> dict:
        """Ask the server to poll its reload source now; returns the reply
        (``reloaded``, and the ``round`` serving after the attempt)."""
        return protocol.parse_reload_reply(self._exchange(protocol.build_reload_request))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ScoringClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PipelinedScoringClient:
    """Many requests in flight on one connection.

    ``submit()`` sends at once and returns a
    :class:`concurrent.futures.Future`; a reader thread resolves it when
    the reply with its id arrives, in whatever order replies come.
    Thread-safe. A rejected request's future raises
    :class:`ScoreRejected`; a dead connection fails every pending future."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        timeout: float = 30.0,
        auth_key: bytes | None = None,
    ):
        self.sock = _connect(host, port, timeout, auth_key)
        self._lock = threading.Lock()  # pending map, id counter, _err
        self._wlock = threading.Lock()  # serializes frame writes
        self._pending: dict[int, Future] = {}
        self._next_id = 0
        self._err: Exception | None = None
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _send(self, frame_of_id) -> Future:
        with self._lock:
            if self._err is not None:
                raise self._err
            self._next_id += 1
            req_id = self._next_id
            fut: Future = Future()
            self._pending[req_id] = fut
        try:
            with self._wlock:
                framing.send_frame(self.sock, frame_of_id(req_id), await_ack=False)
        except (OSError, ConnectionError) as e:
            with self._lock:
                self._pending.pop(req_id, None)
            # The reader may have failed this future already.
            if not fut.done():
                fut.set_exception(WireError(f"send failed: {e}"))
        return fut

    def submit(
        self,
        *,
        text: str | None = None,
        features: Mapping[str, Any] | None = None,
        deadline_ms: float | None = None,
        trace: str | None = None,
    ) -> Future:
        return self._send(lambda rid: protocol.build_request(
            rid, text=text, features=features, deadline_ms=deadline_ms, trace=trace
        ))

    def score(self, *, timeout: float | None = None, **kw) -> dict:
        """Synchronous convenience over :meth:`submit` (one in flight)."""
        return self.submit(**kw).result(timeout=timeout)

    def stats(self, *, timeout: float | None = None) -> dict:
        """The server's ``stats()`` snapshot, pipelined like any request."""
        return self._send(protocol.build_stats_request).result(timeout=timeout)

    def _read_loop(self) -> None:
        while True:
            try:
                frame = bytes(framing.recv_frame(self.sock, send_ack=False))
                if frame[:4] == NONCE_MAGIC:
                    raise WireError(_AUTH_NEEDED)
                req_id = protocol.frame_id(frame)
            except (OSError, ConnectionError, WireError) as e:
                self._fail_all(e if isinstance(e, WireError) else WireError(f"connection lost: {e}"))
                return
            with self._lock:
                fut = self._pending.pop(req_id, None)
            if fut is None:
                continue  # the reply of a send that already failed locally
            try:
                result, exc = _resolve(frame)
            except WireError as e:
                result, exc = None, e
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

    def _fail_all(self, err: Exception) -> None:
        with self._lock:
            if self._closed:
                err = WireError("client closed")
            self._err = err
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(err)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        try:
            # shutdown() first: a plain close() while the reader blocks in
            # recv would wait out the socket timeout.
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._reader.join(timeout=5.0)

    def __enter__(self) -> "PipelinedScoringClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncScoringClient:
    """asyncio scoring client: ``await score(...)`` from any number of
    concurrent tasks over one connection, replies matched by id.

    The transport framing is written out on asyncio streams
    (``await_ack=False`` both ways, as the blocking clients), the CRC
    checked on every frame received. Construct with
    ``await AsyncScoringClient.connect(host, port)``."""

    def __init__(self, reader, writer):
        self._reader = reader
        self._writer = writer
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._err: Exception | None = None
        self._reader_task: asyncio.Task | None = None

    async def _recv_frame(self) -> bytes:
        header = await self._reader.readexactly(len(framing.FRAME_MAGIC) + 12)
        if header[:4] != framing.FRAME_MAGIC:
            raise WireError(f"bad frame magic {bytes(header[:4])!r}")
        length, crc = struct.unpack("<QI", header[4:])
        if length > framing.MAX_FRAME:
            raise WireError(f"frame length {length} exceeds {framing.MAX_FRAME}")
        payload = await self._reader.readexactly(length)
        if zlib.crc32(payload) != crc:
            raise WireError("frame CRC mismatch")
        return bytes(payload)

    async def _send_frame(self, payload: bytes) -> None:
        self._writer.write(
            framing.FRAME_MAGIC + struct.pack("<QI", len(payload), zlib.crc32(payload)) + payload
        )
        await self._writer.drain()

    @classmethod
    async def connect(
        cls, host: str, port: int, *, auth_key: bytes | None = None
    ) -> "AsyncScoringClient":
        reader, writer = await asyncio.open_connection(host, port)
        self = cls(reader, writer)
        if auth_key is not None:
            try:
                nonce = _check_challenge(await self._recv_frame())
            except asyncio.IncompleteReadError as e:
                writer.close()
                raise WireError(f"server sent no auth challenge — is it running with --auth? ({e})") from None
            except WireError:
                writer.close()
                raise
            await self._send_frame(protocol.build_auth_response(auth_key, nonce))
        self._reader_task = asyncio.ensure_future(self._read_loop())
        return self

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await self._recv_frame()
                if frame[:4] == NONCE_MAGIC:
                    raise WireError(_AUTH_NEEDED)
                fut = self._pending.pop(protocol.frame_id(frame), None)
                if fut is None or fut.done():
                    continue
                result, exc = _resolve(frame)
                if exc is not None:
                    fut.set_exception(exc)
                else:
                    fut.set_result(result)
        except asyncio.CancelledError:
            # close() cancelled us: awaiters must not hang on futures
            # nobody will resolve.
            self._fail_pending(WireError("client closed"))
            raise
        except (OSError, ConnectionError, WireError, EOFError) as e:
            self._fail_pending(e if isinstance(e, WireError) else WireError(f"connection lost: {e}"))

    def _fail_pending(self, err: Exception) -> None:
        self._err = err
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()

    async def _ask(self, frame_of_id):
        if self._err is not None:
            raise self._err
        self._next_id += 1
        req_id = self._next_id
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            await self._send_frame(frame_of_id(req_id))
        except BaseException:
            self._pending.pop(req_id, None)  # never leak the entry
            raise
        return await fut

    async def score(
        self,
        *,
        text: str | None = None,
        features: Mapping[str, Any] | None = None,
        deadline_ms: float | None = None,
        trace: str | None = None,
    ) -> dict:
        """Score one flow; safe from many tasks at once. Raises
        :class:`ScoreRejected` on an explicit reject."""
        return await self._ask(lambda rid: protocol.build_request(
            rid, text=text, features=features, deadline_ms=deadline_ms, trace=trace
        ))

    async def stats(self) -> dict:
        return await self._ask(protocol.build_stats_request)

    async def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except asyncio.CancelledError:  # the cancel just sent
                pass
        self._fail_pending(WireError("client closed"))
        try:
            self._writer.close()
            await self._writer.wait_closed()
        except (OSError, ConnectionError):
            pass

    async def __aenter__(self) -> "AsyncScoringClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()


def fetch_stats(
    host: str, port: int, *, timeout: float = 10.0, auth_key: bytes | None = None
) -> dict:
    """One-shot ``stats()`` fetch: dial, (authenticate,) probe, close."""
    with ScoringClient(host, port, timeout=timeout, auth_key=auth_key) as cli:
        return cli.stats()


def probe_scores(
    host: str,
    port: int,
    texts: Sequence[str],
    *,
    timeout: float = 10.0,
    deadline_ms: float | None = None,
    trace: str | None = None,
    auth_key: bytes | None = None,
) -> list[tuple[dict, float]]:
    """One canary pass on one connection: ``(reply, seconds)`` per text,
    each a full round trip. An explicit reject still yields a row: the
    reject body plus ``"rejected": True``; transport errors propagate."""
    out: list[tuple[dict, float]] = []
    with ScoringClient(host, port, timeout=timeout, auth_key=auth_key) as cli:
        for text in texts:
            t0 = time.monotonic()
            try:
                reply = cli.score(text=text, deadline_ms=deadline_ms, trace=trace)
            except ScoreRejected as e:
                reply = {
                    "id": e.req_id, "rejected": True, "code": e.code, "reason": e.reason,
                    "prob": float("nan"), "prediction": 0, "round": None,
                }
            out.append((reply, time.monotonic() - t0))
    return out


def load_arrival_trace(path: str) -> list[float]:
    """A recorded inter-arrival trace: one non-negative gap (seconds) per
    line, blank lines and ``#`` comments skipped."""
    gaps: list[float] = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if line and not line.startswith("#"):
                gaps.append(float(line))
    if not gaps:
        raise ValueError(f"arrival trace {path!r} has no gaps")
    if any(g < 0.0 for g in gaps):
        raise ValueError(f"arrival trace {path!r} has negative gaps")
    return gaps


def run_load(
    host: str,
    port: int,
    texts: Sequence[Flow],
    *,
    concurrency: int = 4,
    requests: int | None = None,
    deadline_ms: float | None = None,
    timeout: float = 60.0,
    auth_key: bytes | None = None,
    pipeline: int = 1,
    target_qps: float | None = None,
    arrival_trace: Sequence[float] | None = None,
) -> dict:
    """Load generator: ``concurrency`` connections score the next flow of
    ``texts`` round-robin until ``requests`` in all (default one pass)
    are answered. A flow is a rendered text (``str``) or a ``features``
    mapping. Returns the JAX package's result keys: ``scored``,
    ``rejected``, ``wall_s``, ``flows_per_sec``, p50/p95/p99 ms (send to
    reply, on the client), ``mean_batch``, ``max_batch`` and every reply's
    ``batch_sizes``, with the mode's ``pipeline``, ``target_qps``,
    ``arrival_trace_len`` and ``arrival_cycle_s``.

    ``pipeline`` > 1 keeps that many requests in flight per connection
    (:class:`PipelinedScoringClient`). ``target_qps`` is the open loop:
    request i goes out at ``t0 + i / target_qps`` however fast replies
    come. ``arrival_trace`` replays recorded gaps instead (gap j between
    requests j and j+1, whole cycles repeated); the two are exclusive, and
    both pipeline at least 32 deep so a paced sender never waits."""
    total = len(texts) if requests is None else int(requests)
    pipeline = max(1, int(pipeline))
    if target_qps is not None:
        if target_qps <= 0:
            raise ValueError(f"target_qps={target_qps} must be > 0")
        pipeline = max(pipeline, 32)
    arrival_base: np.ndarray | None = None
    arrival_cycle = 0.0
    if arrival_trace is not None:
        if target_qps is not None:
            raise ValueError(
                "arrival_trace and target_qps are mutually exclusive "
                "(both fix the fleet-wide send schedule)"
            )
        gaps = np.asarray(list(arrival_trace), np.float64)
        if gaps.size == 0:
            raise ValueError("arrival_trace is empty")
        if (gaps < 0.0).any():
            raise ValueError("arrival_trace gaps must be >= 0")
        # Request j fires at the sum of the gaps before it; past the
        # recorded horizon the whole cycle repeats.
        arrival_base = np.concatenate(([0.0], np.cumsum(gaps[:-1])))
        arrival_cycle = float(gaps.sum())
        pipeline = max(pipeline, 32)
    idx = iter(range(total))
    idx_lock = threading.Lock()
    latencies: list[float] = []
    batch_sizes: list[int] = []
    rejects = [0]
    errors: list[Exception] = []
    out_lock = threading.Lock()
    t_sched = time.monotonic()

    def take() -> int | None:
        with idx_lock:
            return next(idx, None)

    def record(dt: float, reply: dict) -> None:
        with out_lock:
            latencies.append(dt)
            batch_sizes.append(int(reply["batch_size"]))

    def worker_sync() -> None:
        with ScoringClient(host, port, timeout=timeout, auth_key=auth_key) as cli:
            while (i := take()) is not None:
                t0 = time.monotonic()
                try:
                    reply = cli.score(**_request_kw(texts[i % len(texts)]), deadline_ms=deadline_ms)
                except ScoreRejected:
                    with out_lock:
                        rejects[0] += 1
                    continue
                record(time.monotonic() - t0, reply)

    def worker_pipelined() -> None:
        def on_done(fut, t0) -> None:
            # On the reader thread at resolution: send -> reply.
            dt = time.monotonic() - t0
            try:
                reply = fut.result()
            except ScoreRejected:
                with out_lock:
                    rejects[0] += 1
                return
            except Exception:
                return  # surfaced by drain() below
            record(dt, reply)

        def drain(fut) -> None:
            try:
                fut.result(timeout=timeout)
            except ScoreRejected:
                pass

        with PipelinedScoringClient(host, port, timeout=timeout, auth_key=auth_key) as cli:
            window: collections.deque = collections.deque()
            while (i := take()) is not None:
                if target_qps is not None:
                    offset = i / target_qps
                elif arrival_base is not None:
                    n_base = len(arrival_base)
                    offset = (i // n_base) * arrival_cycle + arrival_base[i % n_base]
                else:
                    offset = None
                if offset is not None:
                    delay = t_sched + offset - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                t0 = time.monotonic()
                fut = cli.submit(**_request_kw(texts[i % len(texts)]), deadline_ms=deadline_ms)
                fut.add_done_callback(lambda f, t0=t0: on_done(f, t0))
                window.append(fut)
                while len(window) >= pipeline:
                    drain(window.popleft())
            while window:
                drain(window.popleft())

    def worker() -> None:
        try:
            if pipeline > 1:
                worker_pipelined()
            else:
                worker_sync()
        except Exception as e:  # surfaced to the caller below
            with out_lock:
                errors.append(e)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(max(1, concurrency))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30.0)
    wall = max(time.monotonic() - t0, 1e-9)
    if errors:
        raise errors[0]
    lat = np.asarray(latencies, np.float64) * 1e3
    pct = {f"p{p}_ms": float(np.percentile(lat, p)) if lat.size else 0.0 for p in (50, 95, 99)}
    return {
        "scored": len(latencies),
        "rejected": rejects[0],
        "wall_s": wall,
        "flows_per_sec": len(latencies) / wall,
        "target_qps": target_qps,
        "arrival_trace_len": len(arrival_base) if arrival_base is not None else None,
        "arrival_cycle_s": arrival_cycle if arrival_base is not None else None,
        "pipeline": pipeline,
        "mean_batch": float(np.mean(batch_sizes)) if batch_sizes else 0.0,
        "max_batch": max(batch_sizes, default=0),
        "batch_sizes": batch_sizes,
        **pct,
    }
