"""Live-traffic mirroring onto the shadow artifact — never in the way
(the port's copy of the JAX package's ``shadow/mirror.py``).

Promotion gated on held-out offline eval alone misses live-distribution
drift: federated deployments see shifting, non-IID traffic that the
validation split never saw. :class:`ShadowMirror` closes the traffic
half of that gap: hooked into the router's forward path (router/core.py
``set_mirror``), it duplicates a deterministic counter-strided sample of
live scoring requests onto a shadow backend, so the candidate scores the
SAME flows the incumbent scores, at the same moment, on real traffic.

The one non-negotiable invariant is that the serving path must not be
able to tell the mirror exists:

* ``admit()`` — the only call on the serving hot path — is a counter
  increment plus a bounded-queue ``put_nowait``: no RNG (the same
  no-wall-clock/no-entropy discipline as serve-batch trace sampling —
  reruns mirror the same requests), no I/O, no blocking. A **full queue
  drops the mirror copy** (counted, never retried) — backpressure from a
  slow shadow replica sheds shadow work, never delays a live reply.
* The actual duplicate send, the shadow connection, and the reply
  decode all live on the mirror's own worker/reader threads. A **dead
  shadow replica degrades to pass-through**: dials fail quietly on a
  monotonic backoff, every affected pair is abandoned, and the serving
  tier never waits on it.

The mirror is model-free like the router: it re-addresses the already-
encoded request frame (serving/protocol.py ``rewrite_id``) to its pair
key and ships the bytes — no tokenize, no JSON rebuild. Replies come
back id-matched on the single shadow connection and land in the
comparator (shadow/compare.py) as the pair's shadow side.
"""

from __future__ import annotations

import logging
import queue
import socket
import threading
import time

from ..comm import framing
from ..comm.wire import WireError
from ..obs import metrics as obs_metrics
from ..serving import protocol
from ..serving.client import _set_nodelay, answer_auth_challenge
from ..serving.server import MAX_REQUEST_FRAME

log = logging.getLogger(__name__)


class ShadowMirror:
    """Fire-and-forget duplicator of sampled scoring requests.

    Router contract (router/core.py): ``admit(frame)`` on the forward
    path returns a mirror id when this request was sampled and enqueued
    (None otherwise — not sampled, or the queue was full and the COPY
    was dropped); ``note_serving_reply(mid, frame)`` hands the serving
    side of a sampled pair to the comparator; ``abandon(mid)`` sheds a
    pair whose serving half died (eject, no replica).

    ``sample`` is the stride: mirror one request in ``sample`` via the
    admission counter — deterministic, no RNG. 1 mirrors everything.

    ``extra_targets`` appends ranked secondary candidates:
    mirrored requests stride across the target list by mirror id
    (``(mid - 1) % n_targets`` — deterministic like the admission
    stride), each target gets its own connection + redial backoff, and
    replies land in the comparator tagged with the candidate's RANK so
    the aggregate gate evidence stays rank-0-only.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        sample: int = 1,
        compare=None,
        auth_key: bytes | None = None,
        max_queue: int = 256,
        connect_timeout_s: float = 5.0,
        redial_interval_s: float = 1.0,
        tracer=None,
        span_stride: int = 64,
        extra_targets: tuple = (),
    ):
        if int(sample) < 1:
            raise ValueError(f"sample={sample} must be >= 1 (the stride)")
        self.host = host
        self.port = int(port)
        self.targets: tuple[tuple[str, int], ...] = (
            (host, int(port)),
        ) + tuple((h, int(p)) for h, p in extra_targets)
        self.sample = int(sample)
        self.compare = compare
        self.auth_key = auth_key
        self.connect_timeout_s = float(connect_timeout_s)
        self.redial_interval_s = float(redial_interval_s)
        self.tracer = tracer
        self._span_stride = max(1, int(span_stride))
        self._lock = threading.Lock()
        self._seen = 0
        self._next_mid = 0
        self._mirrored = 0
        self._dropped = 0
        self._errors = 0
        n_targets = len(self.targets)
        self._inflight: list[set[int]] = [set() for _ in range(n_targets)]
        self._socks: list[socket.socket | None] = [None] * n_targets
        self._next_dials: list[float] = [0.0] * n_targets
        self._q: "queue.Queue[tuple[int, bytes] | None]" = queue.Queue(
            maxsize=max(1, int(max_queue))
        )
        # Serving-side pair completions ride their own bounded queue to
        # a mirror-owned thread: completing a pair appends the paired
        # JSONL record and rewrites status.json, and that disk I/O must
        # not run on the ROUTER's backend reply thread (it would delay
        # every multiplexed live reply behind it — the exact invariant
        # the mirror exists to keep). Full queue = the pair is shed.
        self._cq: "queue.Queue[tuple[str, int, bytes | None] | None]" = (
            queue.Queue(maxsize=max(4 * int(max_queue), 1024))
        )
        self._closed = threading.Event()
        self._threads: list[threading.Thread] = []
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's shadow/mirror.py family, same name/kind/labels/help
        self._m_mirrored = m.counter(
            "fedtpu_shadow_mirrored_total",
            help="live scoring requests duplicated onto the shadow backend",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's shadow/mirror.py family, same name/kind/labels/help
        self._m_dropped = m.counter(
            "fedtpu_shadow_mirror_dropped_total",
            help="mirror copies dropped (bounded queue full) — the live "
            "request was never delayed",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's shadow/mirror.py family, same name/kind/labels/help
        self._m_errors = m.counter(
            "fedtpu_shadow_errors_total",
            help="mirror sends/replies lost to a dead or failing shadow "
            "backend (pass-through: serving unaffected)",
        )

    # --------------------------------------------------------------- control
    def start(self) -> "ShadowMirror":
        for target, name in (
            (self._worker, "mirror"),
            (self._compare_loop, "compare"),
        ):
            t = threading.Thread(
                target=target, name=f"fedtpu-shadow-{name}", daemon=True
            )
            t.start()
            self._threads.append(t)
        log.info(
            f"[SHADOW] mirroring 1/{self.sample} of live requests onto "
            f"{self.host}:{self.port} (queue {self._q.maxsize})"
        )
        return self

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        for q in (self._q, self._cq):
            try:
                q.put_nowait(None)  # wake the workers
            except queue.Full:
                pass
        self._teardown_conn()
        for t in self._threads:
            t.join(timeout=5.0)
        s = self.stats()
        log.info(
            f"[SHADOW] mirror closed: {s['mirrored']} mirrored, "
            f"{s['dropped']} dropped (queue full), {s['errors']} "
            "shadow-side errors"
        )

    def __enter__(self) -> "ShadowMirror":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "seen": self._seen,
                "mirrored": self._mirrored,
                "dropped": self._dropped,
                "errors": self._errors,
                "inflight": sum(len(s) for s in self._inflight),
                "sample": self.sample,
                "targets": len(self.targets),
            }

    # ------------------------------------------------------- serving-path API
    def admit(self, frame: bytes) -> int | None:
        """Counter-strided sampling decision + O(1) enqueue. Runs ON the
        router's client loop: a counter increment, a dict-free stride
        check, and one ``put_nowait`` — never blocks, never raises out.
        Returns the pair key (mirror id) or None."""
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self.sample != 0:
                return None
            self._next_mid += 1
            mid = self._next_mid
        # Thread the live request's id to the comparator BEFORE the
        # rewrite erases it — the ground-truth plane joins on it. One
        # header parse for sampled requests only; failures are ignored
        # (the pair still works, it just can't be label-joined).
        reg = getattr(self.compare, "register_rid", None)
        if reg is not None:
            try:
                reg(mid, str(protocol.frame_id(frame)))
            except (WireError, TypeError, ValueError):
                pass
        try:
            self._q.put_nowait((mid, bytes(frame)))
        except queue.Full:
            # The mirror copy is SHED — the live request proceeds
            # untouched, and no pair is ever opened for this id.
            with self._lock:
                self._dropped += 1
            self._m_dropped.inc()
            return None
        with self._lock:
            self._mirrored += 1
            mirrored = self._mirrored
        self._m_mirrored.inc()
        if self.tracer is not None and (
            (mirrored - 1) % self._span_stride == 0
        ):
            self.tracer.record(
                "shadow-mirror",
                t_start=time.time(),
                dur_s=0.0,
                mirrored=mirrored,
                sampled_requests=(
                    self._span_stride if self._span_stride > 1 else None
                ),
            )
        return mid

    def note_serving_reply(self, mid: int, frame: bytes) -> None:
        """The serving side of a sampled pair arrived (router reply
        path). ONE bounded put_nowait and nothing else runs here: the
        parse, the pairing, and the pair-completion disk I/O all happen
        on the mirror's compare thread — the router's reply path must
        never wait on the comparator's JSONL/status writes. A full
        queue sheds the pair (counted)."""
        if self.compare is None:
            return
        try:
            self._cq.put_nowait(("serving", mid, bytes(frame)))
        except queue.Full:
            self._count_error(None)

    def abandon(self, mid: int) -> None:
        """Shed a pair (router path: eject / no replica / send failed).
        Same one-enqueue discipline as :meth:`note_serving_reply`; on a
        full queue the half-open entry is left to the comparator's
        bounded-pending eviction."""
        if self.compare is None:
            return
        try:
            self._cq.put_nowait(("abandon", mid, None))
        except queue.Full:
            self._count_error(None)

    def _compare_loop(self) -> None:
        """Drain serving-side completions into the comparator. A reject
        (shed request) abandons the pair — there is no serving
        probability to compare."""
        while True:
            try:
                item = self._cq.get(timeout=0.2)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            if item is None or self._closed.is_set():
                return
            kind, mid, payload = item
            if kind == "abandon":
                self.compare.abandon(mid)
                continue
            try:
                if protocol.is_reject(payload):
                    self.compare.abandon(mid)
                    continue
                prob = float(protocol.parse_reply(payload)["prob"])
            except (WireError, TypeError, ValueError):
                self.compare.abandon(mid)
                continue
            self.compare.note_serving(mid, prob)

    # ------------------------------------------------------- shadow-side work
    def _count_error(self, mid: int | None = None) -> None:
        with self._lock:
            self._errors += 1
        self._m_errors.inc()
        if mid is not None:
            self.abandon(mid)

    def _teardown_conn(self, idx: int | None = None) -> None:
        """Tear down one target's connection (all of them on close)."""
        indices = range(len(self.targets)) if idx is None else (idx,)
        for i in indices:
            with self._lock:
                sock, self._socks[i] = self._socks[i], None
                stranded = list(self._inflight[i])
                self._inflight[i].clear()
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
            for mid in stranded:
                self.abandon(mid)

    def _ensure_conn(self, idx: int) -> socket.socket | None:
        """Dial one shadow target lazily, at most once per
        ``redial_interval_s`` — a DEAD shadow replica must cost the
        worker one bounded connect attempt per interval, not one per
        mirrored request (pass-through, cheaply). Each target backs off
        independently: one dead secondary never throttles the rest."""
        with self._lock:
            if self._socks[idx] is not None:
                return self._socks[idx]
        now = time.monotonic()
        if now < self._next_dials[idx]:
            return None
        self._next_dials[idx] = now + self.redial_interval_s
        host, port = self.targets[idx]
        try:
            sock = socket.create_connection(
                (host, port), timeout=self.connect_timeout_s
            )
            sock.settimeout(None)
            _set_nodelay(sock)
            if self.auth_key is not None:
                sock.settimeout(self.connect_timeout_s)
                answer_auth_challenge(sock, self.auth_key)
                sock.settimeout(None)
        except (OSError, ConnectionError, WireError) as e:
            log.debug(f"[SHADOW] shadow backend {host}:{port} dial failed: {e}")
            return None
        with self._lock:
            self._socks[idx] = sock
        threading.Thread(
            target=self._reader, args=(sock, idx), daemon=True
        ).start()
        return sock

    def _worker(self) -> None:
        """Drain the bounded queue onto the shadow connections. Only this
        thread ever writes a socket, so frames cannot interleave. With a
        ranked target list, the mirror id picks the target — the same
        deterministic stride discipline as admission sampling."""
        n_targets = len(self.targets)
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            if item is None or self._closed.is_set():
                return
            mid, frame = item
            idx = (mid - 1) % n_targets
            sock = self._ensure_conn(idx)
            if sock is None:
                self._count_error(mid)
                continue
            try:
                out = protocol.rewrite_id(frame, mid)
            except WireError:
                self._count_error(mid)
                continue
            with self._lock:
                self._inflight[idx].add(mid)
            try:
                framing.send_frame(sock, out, await_ack=False)
            except (OSError, ConnectionError):
                self._count_error(None)
                with self._lock:
                    self._inflight[idx].discard(mid)
                self.abandon(mid)
                self._teardown_conn(idx)

    def _reader(self, sock: socket.socket, idx: int) -> None:
        """Resolve shadow replies by the protocol's id echo — the pair's
        shadow side goes to the comparator (tagged with the candidate's
        rank); rejects abandon the pair."""
        while not self._closed.is_set():
            try:
                frame = bytes(
                    framing.recv_frame(
                        sock, send_ack=False, max_frame=MAX_REQUEST_FRAME
                    )
                )
                mid = protocol.frame_id(frame)
            except (OSError, ConnectionError, WireError):
                with self._lock:
                    lost = self._socks[idx] is sock
                if lost:
                    self._count_error(None)
                    self._teardown_conn(idx)
                return
            with self._lock:
                known = mid in self._inflight[idx]
                self._inflight[idx].discard(mid)
            if not known or self.compare is None:
                continue
            try:
                if protocol.is_reject(frame):
                    self.compare.abandon(mid)
                elif idx:
                    self.compare.note_shadow(
                        mid, float(protocol.parse_reply(frame)["prob"]), idx
                    )
                else:
                    # Two-arg form for rank 0: stub comparators predate
                    # the candidate-rank parameter.
                    self.compare.note_shadow(
                        mid, float(protocol.parse_reply(frame)["prob"])
                    )
            except (WireError, TypeError, ValueError):
                self._count_error(mid)
