"""The scoring service: accept loop, reader threads, scorer thread.

Port of the JAX package's ``serving/server.py`` core. Thread layout:

* one **accept** thread hands each connection to a reader thread;
* one **reader** thread per connection parses and tokenizes requests (the
  WordPiece work runs in parallel across clients, off the scorer's path)
  and submits them to the micro-batcher; a full queue is answered with
  the explicit reject frame right there;
* one **scorer** thread owns the device: coalesce, reject expired
  requests, score the rest through the bucketed engine, queue replies;
* one **writer** thread per connection drains a bounded outbound queue,
  so a client that stops reading stalls only its own writer.

No ACK bytes ride the scoring sockets (framing ``await_ack=False`` both
directions), so reader and writer writes cannot interleave.

Not ported yet: the auth handshake, the stats and reload frames, the
checkpoint/registry watchers, and the metrics, tracing and JSONL exports.
"""

from __future__ import annotations

import collections
import logging
import queue
import socket
import threading
import time
import numpy as np

from ..comm import framing
from ..comm.wire import WireError
from ..data.textualize import CICIDS_TEMPLATE, render_row
from . import protocol
from .batcher import MicroBatcher, ScoreRequest

log = logging.getLogger(__name__)

#: A scoring request is one flow record — bound the frame allocation far
#: below the transport's model-sized MAX_FRAME.
MAX_REQUEST_FRAME = 1 << 20  # 1 MB
#: How long the scorer waits for a first request before re-checking close.
IDLE_TICK_S = 0.05
#: Requests whose latency the percentiles in stats() cover.
LATENCY_WINDOW = 100_000


class _ConnWriter:
    """Per-connection outbound lane: a bounded queue + one writer thread.
    A full queue means the peer stopped draining replies: the connection
    is closed."""

    def __init__(self, conn: socket.socket, *, maxsize: int = 256):
        self._conn = conn
        self._q: "queue.Queue[bytes | None]" = queue.Queue(maxsize=maxsize)
        self._dead = threading.Event()
        self._t = threading.Thread(target=self._drain, daemon=True)
        self._t.start()

    def send(self, frame: bytes) -> None:
        if self._dead.is_set():
            return
        try:
            self._q.put_nowait(frame)
        except queue.Full:
            self.kill()

    def _drain(self) -> None:
        while True:
            frame = self._q.get()
            if frame is None or self._dead.is_set():
                return
            try:
                framing.send_frame(self._conn, frame, await_ack=False)
            except OSError:
                self.kill()
                return

    def kill(self) -> None:
        """Tear the connection down (peer gone or not draining)."""
        self._dead.set()
        try:
            self._conn.close()  # also unblocks the reader thread
        except OSError:
            pass
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass

    def close(self) -> None:
        """Stop the writer after the queue drains (normal teardown)."""
        try:
            self._q.put(None, timeout=1.0)
        except queue.Full:
            self._dead.set()
        self._t.join(timeout=5.0)


class ScoringServer:
    """TCP scoring service over a :class:`~.engine.ScoreEngine`.

    ``features`` requests render through the CICIDS2017 template (the same
    bytes ``predict`` feeds); ``text`` requests skip rendering.
    ``default_deadline_s`` applies to requests that name no budget (None =
    wait forever)."""

    def __init__(
        self,
        engine,
        tokenizer,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        threshold: float = 0.5,
        batcher: MicroBatcher | None = None,
        default_deadline_s: float | None = None,
    ):
        self.engine = engine
        self.tok = tokenizer
        self.threshold = float(threshold)
        self.batcher = batcher or MicroBatcher(max_batch=engine.buckets[-1])
        if self.batcher.max_batch > engine.buckets[-1]:
            raise ValueError(
                f"batcher.max_batch={self.batcher.max_batch} exceeds the "
                f"largest engine bucket {engine.buckets[-1]}"
            )
        self.default_deadline_s = default_deadline_s
        self._closed = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._scored = 0
        self._batches = 0
        self._rejects = {"deadline": 0, "overloaded": 0, "bad_request": 0, "error": 0}
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=LATENCY_WINDOW
        )
        self._t_start = time.monotonic()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]

    # ---------------------------------------------------------------- control
    def start(self) -> "ScoringServer":
        self.engine.warmup()
        self._sock.listen(64)
        for target, name in (
            (self._accept_loop, "accept"),
            (self._score_loop, "scorer"),
        ):
            t = threading.Thread(
                target=target, name=f"fedtpu-torch-serve-{name}", daemon=True
            )
            t.start()
            self._threads.append(t)
        log.info(
            f"[SERVE] scoring service on port {self.port} (buckets "
            f"{self.engine.buckets}, seq {self.engine.seq_len}, window "
            f"{self.batcher.gather_window_s * 1e3:.1f} ms, queue cap "
            f"{self.batcher.max_queue})"
        )
        return self

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        s = self.stats()
        log.info(
            f"[SERVE] served {s['scored']} flows in {s['batches']} batches "
            f"({s['flows_per_sec']:.1f} flows/s), p50 {s['p50_ms']:.2f} ms "
            f"p99 {s['p99_ms']:.2f} ms, rejects {s['rejects']}"
        )

    def __enter__(self) -> "ScoringServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """Counters and server-side latency percentiles (enqueue to scored)."""
        with self._stats_lock:
            lat = np.asarray(self._latencies, np.float64) * 1e3
            scored, batches = self._scored, self._batches
            rejects = dict(self._rejects)
        uptime = max(time.monotonic() - self._t_start, 1e-9)
        pct = {
            f"p{p}_ms": float(np.percentile(lat, p)) if lat.size else 0.0
            for p in (50, 95, 99)
        }
        return {
            "scored": scored,
            "batches": batches,
            "rejects": rejects,
            "round": self.engine.round_id,
            "uptime_s": uptime,
            "flows_per_sec": scored / uptime,
            **pct,
        }

    # ----------------------------------------------------------- accept path
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            try:
                # Small frames written header + payload: Nagle + delayed
                # ACK would stall each one.
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            with self._conn_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._reader_loop, args=(conn,), daemon=True
            ).start()

    def _reader_loop(self, conn: socket.socket) -> None:
        writer = _ConnWriter(conn)
        seq_len = self.engine.seq_len
        try:
            while not self._closed.is_set():
                try:
                    frame = framing.recv_frame(
                        conn, send_ack=False, max_frame=MAX_REQUEST_FRAME
                    )
                except (ConnectionError, OSError):
                    return
                except WireError as e:
                    # Oversized/corrupt frame: the stream is desynced.
                    log.warning(f"[SERVE] dropping connection: {e}")
                    return
                try:
                    body = protocol.parse_request(bytes(frame))
                except WireError as e:
                    log.warning(f"[SERVE] dropping connection: {e}")
                    return
                req_id = body["id"]  # parse_request pinned the type
                req_trace = body.get("trace")
                reject = self._make_reject(writer, req_id)
                if "features" in body:
                    try:
                        text = render_row(body["features"], CICIDS_TEMPLATE)
                    except KeyError as e:
                        self._count_reject("bad_request")
                        reject(400, f"features missing template column {e}")
                        continue
                else:
                    text = body["text"]
                enc = self.tok.batch_encode([text], max_len=seq_len)
                deadline_ms = body.get("deadline_ms")
                req = ScoreRequest(
                    req_id=req_id,
                    input_ids=enc["input_ids"][0],
                    attention_mask=enc["attention_mask"][0],
                    reply=self._make_reply(writer, req_id, req_trace),
                    reject=reject,
                    deadline_s=(
                        float(deadline_ms) / 1e3
                        if deadline_ms is not None
                        else self.default_deadline_s
                    ),
                    trace=req_trace,
                )
                if not self.batcher.submit(req):
                    self._count_reject("overloaded")
                    reject(
                        protocol.REJECT_OVERLOADED,
                        f"queue full ({self.batcher.max_queue} pending)",
                    )
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            writer.close()
            try:
                conn.close()
            except OSError:
                pass

    def _make_reply(self, writer: _ConnWriter, req_id: int, trace: str | None):
        def _reply(*, prob, round_id, batch_size, bucket, queue_ms, class_probs=None):
            writer.send(
                protocol.build_reply(
                    req_id,
                    prob=prob,
                    threshold=self.threshold,
                    round_id=round_id,
                    batch_size=batch_size,
                    bucket=bucket,
                    queue_ms=queue_ms,
                    trace=trace,
                    class_probs=class_probs,
                )
            )

        return _reply

    def _make_reject(self, writer: _ConnWriter, req_id: int):
        def _reject(code: int, reason: str) -> None:
            writer.send(protocol.build_reject(req_id, code=code, reason=reason))

        return _reject

    # ------------------------------------------------------------ score path
    def _count_reject(self, kind: str) -> None:
        with self._stats_lock:
            self._rejects[kind] += 1

    def _score_loop(self) -> None:
        while not self._closed.is_set():
            batch = self.batcher.next_batch(timeout=IDLE_TICK_S)
            if not batch:
                continue
            now = time.monotonic()
            live: list[ScoreRequest] = []
            for r in batch:
                if r.expired(now):
                    self._count_reject("deadline")
                    r.reject(
                        protocol.REJECT_DEADLINE,
                        f"deadline of {r.deadline_s * 1e3:.1f} ms exceeded "
                        f"after {(now - r.t_enqueue) * 1e3:.1f} ms in queue",
                    )
                else:
                    live.append(r)
            if not live:
                continue
            try:
                probs, class_probs, bucket, round_id = self.engine.score(
                    np.stack([r.input_ids for r in live]),
                    np.stack([r.attention_mask for r in live]),
                )
            except Exception as e:
                # A failed dispatch must neither hang the batch's clients
                # nor kill the scorer thread: reject them and move on.
                log.exception(
                    f"[SERVE] scoring dispatch failed; rejecting {len(live)} "
                    "request(s)"
                )
                for r in live:
                    self._count_reject("error")
                    r.reject(500, f"scoring failed: {type(e).__name__}")
                continue
            done = time.monotonic()
            n = len(live)
            # Count before replying: a client that got its reply may read
            # stats() at once, and its flow must already be counted.
            with self._stats_lock:
                self._scored += n
                self._batches += 1
                self._latencies.extend(done - r.t_enqueue for r in live)
            kclass = class_probs.shape[1] > 2
            for i, (r, p) in enumerate(zip(live, probs)):
                r.reply(
                    prob=float(p),
                    round_id=round_id,
                    batch_size=n,
                    bucket=bucket,
                    queue_ms=(now - r.t_enqueue) * 1e3,
                    class_probs=class_probs[i].tolist() if kclass else None,
                )
