"""The serving router: one front port, N scorer replicas behind it (the
port's copy of the JAX package's ``router/core.py``).

One ``infer-serve`` process serves every connection, tokenize and
dispatch from one scorer thread, and a promotion hot-reloads the only
replica in place. The router is a thin TCP process that speaks the
scoring protocol on its front port and multiplexes requests across a
fleet of replica backends. It is model-free: it never tokenizes, never
scores and never holds params, and touches no device, so its
per-request cost is two id rewrites and two socket writes. It speaks
the JAX package's protocol byte for byte, so either package's replicas
and clients sit behind either package's router.

Design, in order of importance:

* **Per-request routing, least-in-flight.** Each request picks the
  healthy, non-draining replica with the fewest requests in flight (tie:
  lowest replica id). Client connections therefore multiplex onto shared
  backend connections, which forces the id remap: the router mints a
  backend-local id per forwarded request
  (:func:`~..serving.protocol.rewrite_id`), remembers
  ``(client writer, client id)``, and rewrites the matching reply back.
  Replies to one client connection may arrive out of order — the SDK's
  pipelined clients match by id, the synchronous client never has two
  outstanding.
* **Health probes via the stats frame.** A prober thread sends the
  in-band ``stats()`` probe (serving/protocol.py SCORE_STAT) on each
  replica's live connection every ``probe_interval_s``. In-band on
  purpose: the probe exercises the same socket, auth, and reader thread
  a real request rides, so "probe healthy" cannot diverge from
  "requests flow". A probe timeout, connect failure, or wire error
  **ejects** the replica: its pending requests are answered with
  explicit 503 rejects (shed, not hung — the admission-control
  contract), and the prober keeps dialing until the replica answers a
  probe again (**readmit**). The last probe's stats snapshot is kept
  per replica, so ``router.stats()`` reports each backend's model round
  — the rolling-reload observer reads fleet state from here.
* **Auth end-to-end.** With a key the router challenges every front
  connection exactly as a scoring server does, and answers every
  backend's challenge exactly as a scoring client does — the whole
  chain is authenticated with the one shared secret, and a keyless
  client meets the same refusal it would meet at a bare replica.
* **Drain/readmit for rolling reload.** ``drain(replica)`` removes a
  replica from the pick set without touching its in-flight requests;
  ``wait_drained`` blocks until they finish. The fleet manager
  (router/fleet.py) drains one replica at a time around each hot-swap,
  which is what makes a promotion a zero-drop event.

Threads: one accept loop, one reader per client connection, one reader
per replica connection, one prober, plus the per-connection writer
threads the serving tier already uses (``_ConnWriter`` — the scorer/
router never blocks on a slow client's socket). All shared state is
lock-guarded; the per-replica lock also
serializes backend frame writes (interleaved ``sendall`` chunks from two
threads would corrupt the stream).
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Sequence

from ..comm import framing
from ..comm.wire import NONCE_LEN, NONCE_MAGIC, WireError
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..serving import protocol
from ..serving.client import _set_nodelay, answer_auth_challenge
from ..serving.server import MAX_REQUEST_FRAME, _ConnWriter

log = logging.getLogger(__name__)


class _Pending:
    """One forwarded request awaiting its backend reply. ``writer`` is
    None for the router's own control traffic (health probes, reload
    frames). ``mirror_id`` links a shadow-mirrored request (shadow/
    mirror.py) to its pair key, so the serving-side probability can be
    handed to the comparator when the reply flows back."""

    __slots__ = ("writer", "client_id", "t_sent", "mirror_id")

    def __init__(
        self,
        writer,
        client_id: int,
        t_sent: float,
        mirror_id: int | None = None,
    ):
        self.writer = writer
        self.client_id = client_id
        self.t_sent = t_sent
        self.mirror_id = mirror_id


class Replica:
    """Router-side state for one backend scorer.

    ``lock`` guards every mutable field AND serializes frame writes on
    ``sock`` — a single lock per replica keeps the acquisition graph
    trivially acyclic (the runtime lock-order detector is armed across
    the fast lane)."""

    def __init__(self, host: str, port: int, replica_id: int):
        self.host = host
        self.port = int(port)
        self.replica_id = int(replica_id)
        self.lock = threading.Lock()
        self.sock: socket.socket | None = None
        self.healthy = False
        self.draining = False
        self.inflight = 0
        self.pending: dict[int, _Pending] = {}
        self.next_id = 0
        self.ejects = 0
        self.last_stats: dict | None = None
        self.probe_id: int | None = None
        self.probe_sent_t = 0.0
        # In-flight SCORE_RELOAD choreography (reload_replica): the
        # pending control frame's id, its parsed reply, and the event the
        # coordinating caller waits on. All guarded by ``lock``.
        self.reload_id: int | None = None
        self.reload_reply: dict | None = None
        self.reload_evt: threading.Event | None = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"


class ScoringRouter:
    """Thin TCP router over ``backends`` (a list of (host, port))."""

    def __init__(
        self,
        backends: Sequence[tuple[str, int]],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        auth_key: bytes | None = None,
        probe_interval_s: float = 1.0,
        probe_timeout_s: float = 5.0,
        connect_timeout_s: float = 5.0,
        max_inflight_per_replica: int = 1024,
        tracer=None,
        trace_sample: float = 1.0,
        eject_storm_n: int = 3,
        eject_storm_window_s: float = 60.0,
    ):
        if not backends:
            raise ValueError("router needs at least one backend")
        if not 0.0 < float(trace_sample) <= 1.0:
            raise ValueError(
                f"trace_sample={trace_sample} must be in (0, 1]"
            )
        self.replicas = [
            Replica(h, p, i) for i, (h, p) in enumerate(backends)
        ]
        self.auth_key = auth_key
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.max_inflight_per_replica = int(max_inflight_per_replica)
        self.tracer = tracer
        # router-forward span sampling, the serve-batch pattern: one span
        # per ``stride`` forwarded replies via the counter — deterministic,
        # and the events-JSONL stays bounded on a hot router.
        self._trace_stride = max(1, round(1.0 / float(trace_sample)))
        self._closed = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # Shadow mirror hook (shadow/mirror.py): when armed, a counter-
        # strided sample of live requests is duplicated onto the shadow
        # backend (fire-and-forget — admit() never blocks) and the
        # matching serving replies are handed to the comparator. None =
        # the literal pre-shadow forward path.
        self._mirror_lock = threading.Lock()
        self._mirror = None
        self._forwarded = 0
        self._rejects = {"no_replica": 0, "replica_lost": 0, "auth": 0}
        # Eject-storm detection (obs/flight.py): N ejects across the
        # fleet inside the window dumps ONE postmortem bundle — a dying
        # backend host shows up as a burst of ejects long before any
        # operator reads the counters.
        self._eject_storm_n = max(1, int(eject_storm_n))
        self._eject_storm_window_s = float(eject_storm_window_s)
        self._eject_times: list[float] = []
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's router/core.py family, same name/kind/labels/help
        self._m_forwarded = m.counter(
            "fedtpu_router_forwarded_total",
            help="scoring requests forwarded to a replica",
        )
        self._m_rejects = {
            # fedtpu: allow(obs-metric-once): the JAX package's router/core.py family, same name/kind/labels/help
            kind: m.counter(
                "fedtpu_router_rejects_total",
                help="router-issued explicit rejects by kind",
                labels={"kind": kind},
            )
            for kind in self._rejects
        }
        self._g_inflight = {
            # fedtpu: allow(obs-metric-once): the JAX package's router/core.py family, same name/kind/labels/help
            rep.replica_id: m.gauge(
                "fedtpu_router_inflight",
                help="requests in flight per replica",
                labels={"replica": str(rep.replica_id)},
            )
            for rep in self.replicas
        }
        self._m_ejects = {
            # fedtpu: allow(obs-metric-once): the JAX package's router/core.py family, same name/kind/labels/help
            rep.replica_id: m.counter(
                "fedtpu_router_ejects_total",
                help="replica ejections (probe/connection failure)",
                labels={"replica": str(rep.replica_id)},
            )
            for rep in self.replicas
        }
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]

    # --------------------------------------------------------------- control
    def start(self) -> "ScoringRouter":
        # Dial every backend before accepting traffic: the first request
        # must find a pick set, not race the prober's first pass.
        for rep in self.replicas:
            self._try_connect(rep)
        self._sock.listen(128)
        for target, name in (
            (self._accept_loop, "accept"),
            (self._probe_loop, "prober"),
        ):
            t = threading.Thread(
                target=target, name=f"fedtpu-router-{name}", daemon=True
            )
            t.start()
            self._threads.append(t)
        log.info(
            f"[ROUTER] routing on port {self.port} over "
            f"{len(self.replicas)} replica(s) "
            f"({sum(r.healthy for r in self.replicas)} up), auth "
            f"{'on' if self.auth_key else 'off'}"
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
        for rep in self.replicas:
            with rep.lock:
                sock, rep.sock = rep.sock, None
                rep.healthy = False
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        for t in self._threads:
            t.join(timeout=5.0)
        s = self.stats()
        log.info(
            f"[ROUTER] forwarded {s['forwarded']} request(s), rejects "
            f"{s['rejects']}, ejects "
            f"{sum(b['ejects'] for b in s['backends'])}"
        )

    def __enter__(self) -> "ScoringRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._stats_lock:
            forwarded = self._forwarded
            rejects = dict(self._rejects)
        backends = []
        for rep in self.replicas:
            with rep.lock:
                last = rep.last_stats or {}
                backends.append(
                    {
                        "replica": rep.replica_id,
                        "addr": rep.addr,
                        "healthy": rep.healthy,
                        "draining": rep.draining,
                        "inflight": rep.inflight,
                        "ejects": rep.ejects,
                        "round": last.get("round"),
                        "scored": last.get("scored"),
                    }
                )
        return {
            "kind": "router",
            "forwarded": forwarded,
            "rejects": rejects,
            "rejects_total": sum(rejects.values()),
            "backends": backends,
            "healthy": sum(1 for b in backends if b["healthy"]),
        }

    # -------------------------------------------------------- shadow mirror
    def set_mirror(self, mirror) -> None:
        """Arm (or, with None, disarm) the shadow-traffic mirror. The
        mirror object's contract (shadow/mirror.py ShadowMirror):
        ``admit(frame) -> mirror_id | None`` (O(1), never blocks),
        ``note_serving_reply(mirror_id, frame)``, ``abandon(mirror_id)``."""
        with self._mirror_lock:
            self._mirror = mirror

    def _get_mirror(self):
        with self._mirror_lock:
            return self._mirror

    # -------------------------------------------------------- drain control
    def drain(self, replica_id: int) -> None:
        """Remove a replica from the pick set (in-flight requests keep
        running — ``wait_drained`` waits them out)."""
        rep = self.replicas[replica_id]
        with rep.lock:
            rep.draining = True

    def undrain(self, replica_id: int) -> None:
        rep = self.replicas[replica_id]
        with rep.lock:
            rep.draining = False

    def wait_drained(self, replica_id: int, timeout: float = 30.0) -> bool:
        """True once the replica's in-flight count hits zero (poll; the
        counts move on reply/eject, both of which are prompt)."""
        rep = self.replicas[replica_id]
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with rep.lock:
                if rep.inflight == 0:
                    return True
            time.sleep(0.005)
        with rep.lock:
            return rep.inflight == 0

    # ------------------------------------------- out-of-process reload
    def reload_replica(
        self,
        replica_id: int,
        *,
        timeout_s: float = 60.0,
        drain: bool = True,
        drain_timeout_s: float = 30.0,
    ) -> dict | None:
        """Drain-then-reload-now for ONE backend the router cannot
        hot-swap directly (a subprocess/remote ``infer-serve`` replica):
        remove it from the pick set, wait out its in-flight requests,
        send the SCORE_RELOAD control frame on the same authenticated
        backend connection, and readmit once the replica answers that
        its adoption attempt finished. Returns the parsed reload reply
        (``{"reloaded": bool, "round": int}``) or None when the replica
        was unreachable / never answered — the caller decides whether a
        missing reply fails the sweep."""
        rep = self.replicas[replica_id]
        drained = True
        if drain:
            self.drain(replica_id)
            drained = self.wait_drained(
                replica_id, timeout=drain_timeout_s
            )
            if not drained:
                log.warning(
                    f"[ROUTER] replica {replica_id} did not drain within "
                    f"{drain_timeout_s}s; sending reload anyway (its "
                    "in-flight batches finish on the old weights)"
                )
        try:
            eject_sock = None
            with rep.lock:
                if rep.sock is None or rep.reload_id is not None:
                    return None
                rep.next_id += 1
                bid = rep.next_id
                rep.pending[bid] = _Pending(None, 0, time.monotonic())
                rep.reload_id = bid
                rep.reload_reply = None
                rep.reload_evt = evt = threading.Event()
                try:
                    framing.send_frame(
                        rep.sock,
                        protocol.build_reload_request(bid),
                        await_ack=False,
                    )
                except (OSError, ConnectionError):
                    rep.pending.pop(bid, None)
                    rep.reload_id = None
                    rep.reload_evt = None
                    eject_sock = rep.sock
            if eject_sock is not None:
                self._eject(rep, eject_sock, "reload send failed")
                return None
            if not evt.wait(timeout_s):
                with rep.lock:
                    rep.pending.pop(bid, None)
                    if rep.reload_id == bid:
                        rep.reload_id = None
                        rep.reload_evt = None
                log.warning(
                    f"[ROUTER] replica {replica_id} did not answer the "
                    f"reload frame within {timeout_s}s"
                )
                return None
            with rep.lock:
                return rep.reload_reply
        finally:
            if drain:
                self.undrain(replica_id)

    def rolling_remote_reload(
        self,
        *,
        drain_timeout_s: float = 30.0,
        reload_timeout_s: float = 120.0,
    ) -> dict:
        """The out-of-process rolling sweep: drain -> SCORE_RELOAD ->
        readmit, one replica at a time, so N-1 replicas keep serving
        while each one reloads — the same zero-drop choreography
        ServingFleet.rolling_reload runs for in-process replicas, for
        backends that live in their own processes/hosts. Single-replica
        deployments skip the drain (draining the whole pick set would
        CAUSE the drops). Returns per-replica outcomes."""
        sweep: list[dict] = []
        solo = len(self.replicas) == 1
        for rep in self.replicas:
            t_unix = time.time()
            t0 = time.monotonic()
            reply = self.reload_replica(
                rep.replica_id,
                timeout_s=reload_timeout_s,
                drain=not solo,
                drain_timeout_s=drain_timeout_s,
            )
            dur = time.monotonic() - t0
            out = {
                "replica": rep.replica_id,
                "answered": reply is not None,
                "reloaded": bool(reply and reply.get("reloaded")),
                "round": reply.get("round") if reply else None,
                "swap_s": dur,
            }
            sweep.append(out)
            if self.tracer is not None:
                self.tracer.record(
                    "replica-drain",
                    t_start=t_unix,
                    dur_s=dur,
                    round=out["round"],
                    replica=rep.replica_id,
                    drained=out["answered"],
                    remote=True,
                )
            log.info(
                f"[ROUTER] replica {rep.replica_id} reload "
                f"{'answered' if out['answered'] else 'UNANSWERED'} "
                f"(reloaded={out['reloaded']}, round {out['round']}) in "
                f"{dur:.3f}s"
            )
        return {"replicas": sweep}

    # ------------------------------------------------------------ accept path
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            _set_nodelay(conn)
            with self._conn_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True
            ).start()

    def _auth_front(self, conn: socket.socket) -> bool:
        """The scoring server's challenge-response, verbatim semantics:
        nonce out, keyed proof back, constant-time check."""
        import os as _os

        nonce = _os.urandom(NONCE_LEN)
        try:
            conn.settimeout(10.0)
            framing.send_frame(conn, NONCE_MAGIC + nonce, await_ack=False)
            proof = framing.recv_frame(
                conn, send_ack=False, max_frame=MAX_REQUEST_FRAME
            )
            conn.settimeout(None)
        except (OSError, ConnectionError, WireError) as e:
            self._count_reject("auth")
            log.warning(f"[ROUTER] auth handshake failed: {e}")
            return False
        if not protocol.check_auth_response(proof, self.auth_key, nonce):
            self._count_reject("auth")
            log.warning(
                "[ROUTER] dropping connection: bad or missing auth proof"
            )
            return False
        return True

    def _client_loop(self, conn: socket.socket) -> None:
        if self.auth_key is not None and not self._auth_front(conn):
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
                    frame = framing.recv_frame(
                        conn, send_ack=False, max_frame=MAX_REQUEST_FRAME
                    )
                except (ConnectionError, OSError):
                    return
                except WireError as e:
                    log.warning(f"[ROUTER] dropping connection: {e}")
                    return
                fb = bytes(frame)
                if protocol.is_stats_request(fb):
                    # The router answers stats probes itself — its own
                    # aggregate view; per-replica stats ride inside it.
                    try:
                        body = protocol.parse_stats_request(fb)
                    except WireError as e:
                        log.warning(f"[ROUTER] dropping connection: {e}")
                        return
                    writer.send(
                        protocol.build_stats_reply(body["id"], self.stats())
                    )
                    continue
                # Hot path: magic sniff + id only. Full body validation
                # is the replica's job — it answers a malformed body
                # with a 400 reject carrying this id, which flows back
                # through the ordinary reply path; the router parsing
                # every request twice would halve the tier's headroom.
                if not protocol.is_request(fb):
                    log.warning(
                        "[ROUTER] dropping connection: not a scoring "
                        f"request frame ({fb[:4]!r})"
                    )
                    return
                try:
                    req_id = protocol.frame_id(fb)
                except WireError as e:
                    log.warning(f"[ROUTER] dropping connection: {e}")
                    return
                # Shadow mirroring (shadow/mirror.py): a deterministic
                # counter-strided sample of live requests is duplicated
                # onto the shadow backend. admit() is an O(1) enqueue
                # that NEVER blocks or fails the serving path — a full
                # mirror queue drops the COPY, the live request proceeds
                # untouched.
                mirror = self._get_mirror()
                mid = mirror.admit(fb) if mirror is not None else None
                # One failover retry: the pick can race an eject (the
                # send discovers the dead socket first) — a second pick
                # excludes the replica the first attempt marked down.
                sent = False
                for _attempt in range(2):
                    rep = self._pick()
                    if rep is None:
                        break
                    if self._forward(
                        rep, fb, req_id, writer, mirror_id=mid
                    ):
                        sent = True
                        break
                if not sent:
                    if mid is not None and mirror is not None:
                        mirror.abandon(mid)
                    kind = (
                        "no_replica" if self._pick() is None
                        else "replica_lost"
                    )
                    self._count_reject(kind)
                    writer.send(
                        protocol.build_reject(
                            req_id,
                            code=protocol.REJECT_OVERLOADED,
                            reason="no healthy replica available",
                        )
                    )
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            writer.close()
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------------- forwarding
    def _pick(self) -> Replica | None:
        """Least-in-flight healthy, non-draining replica (tie: lowest
        id — deterministic, so tests can pin the spread)."""
        best: Replica | None = None
        best_load = None
        for rep in self.replicas:
            with rep.lock:
                if (
                    not rep.healthy
                    or rep.draining
                    or rep.sock is None
                    or rep.inflight >= self.max_inflight_per_replica
                ):
                    continue
                load = rep.inflight
            if best_load is None or load < best_load:
                best, best_load = rep, load
        return best

    def _forward(
        self,
        rep: Replica,
        frame: bytes,
        client_id: int,
        writer,
        mirror_id: int | None = None,
    ) -> bool:
        """Rewrite + send one request to ``rep``; False = the replica
        went away under us (caller retries elsewhere)."""
        eject_sock = None
        with rep.lock:
            if not rep.healthy or rep.sock is None:
                return False
            rep.next_id += 1
            bid = rep.next_id
            out = protocol.rewrite_id(frame, bid)
            rep.pending[bid] = _Pending(
                writer, client_id, time.monotonic(), mirror_id
            )
            rep.inflight += 1
            inflight = rep.inflight
            try:
                framing.send_frame(rep.sock, out, await_ack=False)
            except (OSError, ConnectionError):
                rep.pending.pop(bid, None)
                rep.inflight -= 1
                inflight = rep.inflight
                eject_sock = rep.sock
        self._g_inflight[rep.replica_id].set(inflight)
        if eject_sock is not None:
            self._eject(rep, eject_sock, "send failed")
            return False
        return True

    def _replica_loop(self, rep: Replica, sock: socket.socket) -> None:
        """Reader for one backend connection: match replies to pending
        requests by id, rewrite back, hand to the client's writer."""
        while not self._closed.is_set():
            try:
                frame = bytes(
                    framing.recv_frame(
                        sock, send_ack=False, max_frame=MAX_REQUEST_FRAME
                    )
                )
                bid = protocol.frame_id(frame)
            except (OSError, ConnectionError, WireError) as e:
                self._eject(rep, sock, f"connection lost ({e})")
                return
            reload_evt = None
            with rep.lock:
                pend = rep.pending.pop(bid, None)
                if pend is not None and pend.writer is not None:
                    rep.inflight -= 1
                inflight = rep.inflight
                if pend is not None and pend.writer is None:
                    if rep.reload_id is not None and bid == rep.reload_id:
                        # SCORE_RELOAD answered: the adoption attempt on
                        # the replica finished — wake the coordinator.
                        rep.reload_id = None
                        try:
                            rep.reload_reply = protocol.parse_reload_reply(
                                frame
                            )
                        except WireError:
                            rep.reload_reply = None
                        reload_evt = rep.reload_evt
                    else:
                        # Probe result: adopt the stats snapshot; a
                        # healthy answer is also the readmit signal
                        # after an eject.
                        rep.probe_id = None
                        if protocol.is_stats_reply(frame):
                            try:
                                rep.last_stats = protocol.parse_stats_reply(
                                    frame
                                )["stats"]
                            except WireError:
                                rep.last_stats = None
                        rep.healthy = True
            if reload_evt is not None:
                reload_evt.set()
            if pend is None or pend.writer is None:
                continue
            if pend.mirror_id is not None:
                # The mirrored request's serving-side reply: hand the
                # probability to the comparator (outside rep.lock — the
                # mirror takes its own locks). A reject abandons the pair.
                mirror = self._get_mirror()
                if mirror is not None:
                    mirror.note_serving_reply(pend.mirror_id, frame)
            self._g_inflight[rep.replica_id].set(inflight)
            pend.writer.send(protocol.rewrite_id(frame, pend.client_id))
            self._m_forwarded.inc()
            with self._stats_lock:
                self._forwarded += 1
                n_fwd = self._forwarded
            if self.tracer is not None and (
                (n_fwd - 1) % self._trace_stride == 0
            ):
                dur = time.monotonic() - pend.t_sent
                self.tracer.record(
                    "router-forward",
                    t_start=time.time() - dur,
                    dur_s=dur,
                    replica=rep.replica_id,
                    inflight=inflight,
                    sampled_requests=(
                        self._trace_stride
                        if self._trace_stride > 1
                        else None
                    ),
                )

    # ------------------------------------------------------------ health path
    def _try_connect(self, rep: Replica) -> bool:
        """Dial + (auth +) first probe. The replica joins the pick set
        immediately on a successful handshake; the probe reply then
        refreshes its stats snapshot."""
        try:
            sock = socket.create_connection(
                (rep.host, rep.port), timeout=self.connect_timeout_s
            )
            sock.settimeout(None)
            _set_nodelay(sock)
            if self.auth_key is not None:
                sock.settimeout(self.connect_timeout_s)
                answer_auth_challenge(sock, self.auth_key)
                sock.settimeout(None)
        except (OSError, ConnectionError, WireError) as e:
            log.debug(f"[ROUTER] replica {rep.replica_id} dial failed: {e}")
            return False
        was_down = False
        with rep.lock:
            rep.sock = sock
            was_down = not rep.healthy
            rep.healthy = True
            rep.pending.clear()
            rep.inflight = 0
            rep.probe_id = None
        threading.Thread(
            target=self._replica_loop, args=(rep, sock), daemon=True
        ).start()
        self._send_probe(rep)
        if was_down:
            log.info(
                f"[ROUTER] replica {rep.replica_id} ({rep.addr}) readmitted"
            )
        return True

    def _send_probe(self, rep: Replica) -> None:
        eject_sock = None
        with rep.lock:
            if rep.sock is None:
                return
            if rep.probe_id is not None:
                # Previous probe still unanswered; the prober's timeout
                # check decides its fate, not a second probe.
                return
            rep.next_id += 1
            bid = rep.next_id
            rep.pending[bid] = _Pending(None, 0, time.monotonic())
            rep.probe_id = bid
            rep.probe_sent_t = time.monotonic()
            try:
                framing.send_frame(
                    rep.sock,
                    protocol.build_stats_request(bid),
                    await_ack=False,
                )
            except (OSError, ConnectionError):
                eject_sock = rep.sock
        if eject_sock is not None:
            self._eject(rep, eject_sock, "probe send failed")

    def _probe_loop(self) -> None:
        while not self._closed.wait(self.probe_interval_s):
            for rep in self.replicas:
                with rep.lock:
                    sock = rep.sock
                    stale = (
                        rep.probe_id is not None
                        and time.monotonic() - rep.probe_sent_t
                        > self.probe_timeout_s
                    )
                if sock is None:
                    self._try_connect(rep)
                elif stale:
                    self._eject(rep, sock, "probe timeout")
                else:
                    self._send_probe(rep)

    def _eject(self, rep: Replica, sock: socket.socket, reason: str) -> None:
        """Take a replica out of service: fail its pending requests with
        explicit rejects, close the connection, count the eject. The
        prober's next pass starts the readmit dial. ``sock`` pins WHICH
        connection died — a racing eject from the reader and the prober
        must not double-count or tear down a fresh reconnect."""
        with rep.lock:
            if rep.sock is not sock:
                return  # stale: already ejected / reconnected
            rep.sock = None
            rep.healthy = False
            rep.probe_id = None
            dropped = [p for p in rep.pending.values() if p.writer is not None]
            rep.pending.clear()
            rep.inflight = 0
            rep.ejects += 1
            # A reload coordinator waiting on this connection must wake
            # now (its reply can never arrive) instead of its timeout.
            rep.reload_id = None
            reload_evt, rep.reload_evt = rep.reload_evt, None
        if reload_evt is not None:
            reload_evt.set()
        try:
            sock.close()
        except OSError:
            pass
        self._m_ejects[rep.replica_id].inc()
        self._g_inflight[rep.replica_id].set(0)
        mirror = self._get_mirror()
        for pend in dropped:
            if pend.mirror_id is not None and mirror is not None:
                mirror.abandon(pend.mirror_id)
            self._count_reject("replica_lost")
            pend.writer.send(
                protocol.build_reject(
                    pend.client_id,
                    code=protocol.REJECT_OVERLOADED,
                    reason=f"replica {rep.replica_id} ejected: {reason}",
                )
            )
        log.warning(
            f"[ROUTER] ejected replica {rep.replica_id} ({rep.addr}): "
            f"{reason}; {len(dropped)} in-flight request(s) shed"
        )
        now = time.monotonic()
        with self._stats_lock:
            self._eject_times.append(now)
            cutoff = now - self._eject_storm_window_s
            self._eject_times = [t for t in self._eject_times if t >= cutoff]
            in_window = len(self._eject_times)
            storm = in_window >= self._eject_storm_n
        if storm:
            recorder = obs_flight.get_global_recorder()
            if recorder is not None:
                try:
                    recorder.maybe_dump(
                        "eject-storm",
                        extra={
                            "ejects_in_window": in_window,
                            "window_s": self._eject_storm_window_s,
                            "replica": rep.replica_id,
                            "reason": reason,
                        },
                    )
                except OSError as e:
                    log.warning(
                        f"[ROUTER] postmortem dump failed (non-fatal): {e}"
                    )

    def _count_reject(self, kind: str) -> None:
        with self._stats_lock:
            self._rejects[kind] += 1
        self._m_rejects[kind].inc()
