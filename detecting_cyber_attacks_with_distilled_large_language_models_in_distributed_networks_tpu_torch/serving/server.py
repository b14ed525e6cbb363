"""The scoring service: accept loop, reader threads, scorer thread.

Port of the JAX package's ``serving/server.py`` core. Thread layout:

* one **accept** thread hands each connection to a reader thread;
* one **reader** thread per connection runs the auth handshake first
  when the server has a key, then parses and tokenizes requests (the
  WordPiece work runs in parallel across clients, off the scorer's path)
  and submits them to the micro-batcher; a full queue is answered with
  the explicit reject frame right there. Stats probes are answered on
  this thread (a probe must not queue behind scoring); reload-now frames
  are queued for the scorer;
* one **scorer** thread owns the device: at each batch boundary it
  answers queued reload frames after one forced watcher poll, and polls
  the reload watcher (``serving/reload.py``) on its interval, so a reload
  never races a batch; then coalesce, reject expired requests, score the
  rest through the bucketed engine, queue replies;
* one **writer** thread per connection drains a bounded outbound queue,
  so a client that stops reading stalls only its own writer.

No ACK bytes ride the scoring sockets (framing ``await_ack=False`` both
directions), so reader and writer writes cannot interleave.

Observability, as in the JAX package: the six ``fedtpu_serve_*`` families
on the process registry (``/metrics`` with ``--metrics-port``), one
``serve-batch`` span per sampled coalesced dispatch (a deterministic
batch-counter stride of ``round(1 / trace_sample)``, the first batch
always), the ``--scored-jsonl`` rows (one per answered request), the
``--metrics-jsonl`` per-batch records and close summary, and a flight
dump on a scoring-dispatch failure.
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import socket
import threading
import time

import numpy as np

from ..comm import framing
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..comm.wire import NONCE_LEN, NONCE_MAGIC, WireError
from ..data.textualize import render_row
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
#: How long an unauthenticated connection may hold a reader thread.
AUTH_TIMEOUT_S = 10.0
#: Fixed [0, 1] bins of stats()["score_hist"] (the JAX package's default).
SCORE_BINS = 10


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

    ``spec`` (a ``data.datasets.DatasetSpec``) renders ``features``
    requests through the dataset's template, the same bytes ``predict``
    feeds; without one, ``features`` requests get a 400 and only ``text``
    is scored. ``default_deadline_s`` applies to requests that name no
    budget (None = wait forever). ``watcher``: a ``CheckpointWatcher`` or
    ``RegistryWatcher`` polled by the scorer (None: the weights never
    change). ``auth_key``: every connection must answer the HMAC nonce
    challenge before its first request is read (None: an open port).
    ``replica_id``: the server's id in a fleet (router/), stamped into
    ``stats()`` so a probe tells which replica answered (None: a
    standalone deployment). ``warmup``: run every bucket once in
    ``start()``; ``idle_tick_s``: how long the scorer waits for a batch
    before it polls the watcher again."""

    def __init__(
        self,
        engine,
        tokenizer,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        spec=None,
        threshold: float = 0.5,
        batcher: MicroBatcher | None = None,
        default_deadline_s: float | None = None,
        watcher=None,
        auth_key: bytes | None = None,
        metrics_jsonl: str | None = None,
        scored_jsonl: str | None = None,
        tracer=None,
        trace_sample: float = 1.0,
        metrics_server=None,
        replica_id: int | None = None,
        warmup: bool = True,
        idle_tick_s: float = IDLE_TICK_S,
    ):
        if not 0.0 < float(trace_sample) <= 1.0:
            raise ValueError(f"trace_sample={trace_sample} must be in (0, 1]")
        # serve-batch span sampling: one span per ``stride`` coalesced
        # batches, by the batch COUNTER (reruns sample the same batches);
        # each span carries ``sampled_batches`` so consumers re-scale.
        self._trace_stride = max(1, round(1.0 / float(trace_sample)))
        self.tracer = tracer
        self.metrics_jsonl = metrics_jsonl
        # One line per ANSWERED request (its id, prob and round): the join
        # key against a delayed ground-truth journal. Off by default.
        self.scored_jsonl = scored_jsonl
        #: The process's /metrics endpoint when this server owns it
        #: (``infer-serve --metrics-port``); closed with the server.
        self.metrics_server = metrics_server
        self.engine = engine
        self.watcher = watcher
        self.replica_id = None if replica_id is None else int(replica_id)
        self._warmup = warmup
        self.idle_tick_s = float(idle_tick_s)
        self.tok = tokenizer
        self.spec = spec
        self.threshold = float(threshold)
        self.batcher = batcher or MicroBatcher(max_batch=engine.buckets[-1])
        if self.batcher.max_batch > engine.buckets[-1]:
            raise ValueError(
                f"batcher.max_batch={self.batcher.max_batch} exceeds the "
                f"largest engine bucket {engine.buckets[-1]}"
            )
        self.default_deadline_s = default_deadline_s
        self.auth_key = auth_key
        self._closed = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._scored = 0
        self._batches = 0
        self._rejects = {
            "deadline": 0, "overloaded": 0, "bad_request": 0, "error": 0, "auth": 0,
        }
        # Reload-now frames: reader threads queue (id, writer); the scorer
        # answers after a forced watcher poll at its next batch boundary.
        self._reload_q: collections.deque = collections.deque()
        self._reload_frames = 0
        self._hist_edges = np.linspace(0.0, 1.0, SCORE_BINS + 1)
        self._score_hist = np.zeros(SCORE_BINS, np.int64)
        self._batch_hist: collections.Counter[int] = collections.Counter()
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=LATENCY_WINDOW
        )
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's serving/server.py family, same name/kind/labels/help
        self._g_queue = m.gauge(
            "fedtpu_serve_queue_depth",
            help="scoring requests waiting in the micro-batcher",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's serving/server.py family, same name/kind/labels/help
        self._g_round = m.gauge(
            "fedtpu_serve_model_round",
            help="model round currently serving",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's serving/server.py family, same name/kind/labels/help
        self._m_scored = m.counter(
            "fedtpu_serve_scored_total", help="flows scored"
        )
        # fedtpu: allow(obs-metric-once): the JAX package's serving/server.py family, same name/kind/labels/help
        self._m_batches = m.counter(
            "fedtpu_serve_batches_total", help="coalesced score dispatches"
        )
        self._m_rejects = {
            # fedtpu: allow(obs-metric-once): the JAX package's serving/server.py family, same name/kind/labels/help
            kind: m.counter(
                "fedtpu_serve_rejects_total",
                help="explicit reject frames by kind",
                labels={"kind": kind},
            )
            for kind in self._rejects
        }
        # fedtpu: allow(obs-metric-once): the JAX package's serving/server.py family, same name/kind/labels/help
        self._h_queue_ms = m.histogram(
            "fedtpu_serve_queue_wait_seconds",
            help="request queue wait before dispatch",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.5, 1.0, 5.0),
        )
        self._t_start = time.monotonic()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]

    # ---------------------------------------------------------------- control
    def start(self) -> "ScoringServer":
        if self._warmup:
            self.engine.warmup()
        if self.watcher is not None and not self.watcher.primed:
            self.watcher.prime()
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
        # shutdown() wakes the accept loop: close() alone leaves a thread
        # blocked in accept() until its join times out.
        for end in (lambda: self._sock.shutdown(socket.SHUT_RDWR), self._sock.close):
            try:
                end()
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
        if self.metrics_server is not None:
            self.metrics_server.close()
        s = self.stats()
        log.info(
            f"[SERVE] served {s['scored']} flows in {s['batches']} batches "
            f"({s['flows_per_sec']:.1f} flows/s), p50 {s['p50_ms']:.2f} ms "
            f"p99 {s['p99_ms']:.2f} ms, rejects {s['rejects']}"
        )
        if self.metrics_jsonl:
            from ..reporting import append_metrics_jsonl

            append_metrics_jsonl(self.metrics_jsonl, {"phase": "serve_summary", **_flat(s)})

    def __enter__(self) -> "ScoringServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """Counters, histograms and server-side latency percentiles
        (enqueue to scored): the JAX package's key set."""
        with self._stats_lock:
            lat = np.asarray(self._latencies, np.float64) * 1e3
            scored, batches = self._scored, self._batches
            rejects = dict(self._rejects)
            batch_hist = dict(sorted(self._batch_hist.items()))
            score_hist = self._score_hist.tolist()
            reload_frames = self._reload_frames
        uptime = max(time.monotonic() - self._t_start, 1e-9)
        pct = {
            f"p{p}_ms": float(np.percentile(lat, p)) if lat.size else 0.0
            for p in (50, 95, 99)
        }
        return {
            "replica": self.replica_id,
            "scored": scored,
            "batches": batches,
            "mean_batch": scored / batches if batches else 0.0,
            "batch_size_hist": batch_hist,
            "score_hist": score_hist,
            "rejects": rejects,
            "rejects_total": sum(rejects.values()),
            "queue_depth": self.batcher.qsize(),
            "reloads": getattr(self.watcher, "reload_count", 0),
            "reload_frames": reload_frames,
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
        if self.auth_key is not None and not self._auth_handshake(conn):
            with self._conn_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
            return
        writer = _ConnWriter(conn)
        try:
            while not self._closed.is_set():
                try:
                    frame = bytes(framing.recv_frame(
                        conn, send_ack=False, max_frame=MAX_REQUEST_FRAME
                    ))
                except (ConnectionError, OSError):
                    return
                except WireError as e:
                    # Oversized/corrupt frame: the stream is desynced.
                    log.warning(f"[SERVE] dropping connection: {e}")
                    return
                if not self._handle_frame(frame, writer):
                    return
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            writer.close()
            try:
                conn.close()
            except OSError:
                pass

    def _handle_frame(self, frame: bytes, writer: _ConnWriter) -> bool:
        """One frame off a connection; False drops the connection."""
        try:
            if protocol.is_stats_request(frame):
                sid = protocol.parse_stats_request(frame)["id"]
                writer.send(protocol.build_stats_reply(sid, self.stats()))
                return True
            if protocol.is_reload_request(frame):
                rid = protocol.parse_reload_request(frame)["id"]
                with self._stats_lock:
                    self._reload_frames += 1
                self._reload_q.append((rid, writer))
                return True
            body = protocol.parse_request(frame)
        except WireError as e:
            # A whole frame arrived: if it still names an id, answer a 400
            # instead of dropping (a shared connection keeps its peers).
            try:
                bad_id = protocol.frame_id(frame)
            except WireError:
                log.warning(f"[SERVE] dropping connection: {e}")
                return False
            self._count_reject("bad_request")
            writer.send(protocol.build_reject(bad_id, code=400, reason=str(e)))
            return True
        req_id = body["id"]  # parse_request pinned the type
        req_trace = body.get("trace")
        reject = self._make_reject(writer, req_id)
        if "features" in body:
            if self.spec is None:
                self._count_reject("bad_request")
                reject(400, "this server accepts text requests only (no dataset spec configured)")
                return True
            try:
                text = render_row(body["features"], self.spec.template)
            except KeyError as e:
                self._count_reject("bad_request")
                reject(400, f"features missing template column {e}")
                return True
        else:
            text = body["text"]
        enc = self.tok.batch_encode([text], max_len=self.engine.seq_len)
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
        return True

    def _auth_handshake(self, conn: socket.socket) -> bool:
        """The challenge before the first request is read: send
        NONCE_MAGIC + a fresh nonce, require SCORE_AUTH_MAGIC + HMAC(key,
        domain + nonce). It runs before the writer thread exists, so its
        writes are the connection's only ones; a failure counts as
        ``rejects["auth"]``."""
        nonce = os.urandom(NONCE_LEN)
        try:
            conn.settimeout(AUTH_TIMEOUT_S)
            framing.send_frame(conn, NONCE_MAGIC + nonce, await_ack=False)
            proof = framing.recv_frame(conn, send_ack=False, max_frame=MAX_REQUEST_FRAME)
            conn.settimeout(None)
        except (OSError, ConnectionError, WireError) as e:
            self._count_reject("auth")
            log.warning(f"[SERVE] auth handshake failed: {e}")
            return False
        if not protocol.check_auth_response(proof, self.auth_key, nonce):
            self._count_reject("auth")
            log.warning(
                "[SERVE] dropping connection: bad or missing auth proof "
                "(the client must score with the matching key)"
            )
            return False
        return True

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
        self._m_rejects[kind].inc()

    def _drain_reload_requests(self) -> None:
        """Answer the queued reload frames: one forced watcher poll covers
        every frame that arrived since the last batch, then each reply
        names the round serving after it (no watcher: reloaded false)."""
        if not self._reload_q:
            return
        reloaded = False
        if self.watcher is not None:
            try:
                reloaded = bool(self.watcher.poll(self.engine, force=True))
            except Exception as e:  # the scorer thread must survive it
                log.warning(f"[SERVE] forced reload poll failed (non-fatal): {e}")
        round_id = self.engine.round_id
        while self._reload_q:
            req_id, writer = self._reload_q.popleft()
            writer.send(protocol.build_reload_reply(req_id, reloaded=reloaded, round_id=round_id))

    def _score_loop(self) -> None:
        while not self._closed.is_set():
            self._drain_reload_requests()
            if self.watcher is not None:
                self.watcher.poll(self.engine)
            batch = self.batcher.next_batch(timeout=self.idle_tick_s)
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
                # Flight recorder: a failed dispatch is the scoring tier's
                # moment to preserve (rate-limited; never fatal here).
                recorder = obs_flight.get_global_recorder()
                if recorder is not None:
                    try:
                        recorder.maybe_dump(
                            "scoring-error",
                            extra={
                                "error": f"{type(e).__name__}: {e}"[:300],
                                "rejected": len(live),
                                "bucket_batch": len(live),
                            },
                        )
                    except OSError as dump_err:
                        log.warning(f"[SERVE] postmortem dump failed (non-fatal): {dump_err}")
                continue
            done = time.monotonic()
            n = len(live)
            # The batch's score histogram over the fixed [0, 1] bins.
            batch_hist, _ = np.histogram(
                np.clip(np.asarray(probs[:n], np.float64), 0.0, 1.0), bins=self._hist_edges
            )
            queue_depth = self.batcher.qsize()
            # Count before replying: a client that got its reply may read
            # stats() at once, and its flow must already be counted.
            with self._stats_lock:
                self._scored += n
                self._batches += 1
                batch_no = self._batches
                self._batch_hist[n] += 1
                self._score_hist += batch_hist
                self._latencies.extend(done - r.t_enqueue for r in live)
                rejects_total = sum(self._rejects.values())
            self._m_scored.inc(n)
            self._m_batches.inc()
            self._g_queue.set(queue_depth)
            self._g_round.set(round_id)
            for r in live:
                self._h_queue_ms.observe(now - r.t_enqueue)
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
            self._export_batch(live, probs, n, bucket, round_id, now, done, batch_no, queue_depth, rejects_total, batch_hist)

    def _export_batch(self, live, probs, n, bucket, round_id, now, done, batch_no, queue_depth, rejects_total, batch_hist) -> None:
        """The scored rows, the sampled serve-batch span and the per-batch
        metrics record of one answered batch (each only when asked for)."""
        if self.scored_jsonl:
            import json

            from ..obs.trace import append_jsonl_line

            for r, p in zip(live, probs):
                append_jsonl_line(
                    self.scored_jsonl,
                    json.dumps({"schema": "fedtpu-scored-v1", "rid": str(r.req_id), "prob": round(float(p), 6), "round": round_id}),
                )
        # Counter-stride sampling: batch 1, 1 + stride, ... (the first
        # batch always emits, so a short-lived scorer leaves a span).
        if self.tracer is not None and (batch_no - 1) % self._trace_stride == 0:
            self.tracer.record(
                "serve-batch",
                t_start=time.time() - (done - now),
                dur_s=done - now,
                trace=next((r.trace for r in live if r.trace is not None), None),
                batch_size=n,
                bucket=bucket,
                round=round_id,
                sampled_batches=self._trace_stride if self._trace_stride > 1 else None,
            )
        if self.metrics_jsonl:
            from ..reporting import append_metrics_jsonl

            append_metrics_jsonl(
                self.metrics_jsonl,
                {
                    "phase": "serve_batch",
                    "batch_size": n,
                    "bucket": bucket,
                    "round": round_id,
                    "score_ms": round((done - now) * 1e3, 3),
                    "queue_ms_max": round(max((now - r.t_enqueue) for r in live) * 1e3, 3),
                    "queue_depth": queue_depth,
                    "rejects_total": rejects_total,
                    "score_hist": batch_hist.tolist(),
                },
            )


def _flat(stats: dict) -> dict:
    """Flatten stats() for the scalar-only JSONL writer."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"{k}_{kk}"] = vv
        else:
            out[k] = v
    return out
