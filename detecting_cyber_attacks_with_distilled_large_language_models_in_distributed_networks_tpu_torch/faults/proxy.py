"""Deterministic in-process TCP fault proxy (the port's copy of the JAX
package's ``faults/proxy.py``; host sockets only, so a plan replays
identically against either package's server).

Sits between a ``FederatedClient`` and an ``AggregationServer`` (or any
TCP pair) on loopback and injects wire-level faults into the REAL
protocol — the frames, HMAC challenges, and stream chunks that actually
cross the socket, not mocks. Everything is seeded: connection ``i``
draws its fault plan from a generator keyed on ``(seed, i)``, so a
failing chaos run replays byte-for-byte.

Fault vocabulary (one :class:`FaultSpec` per accepted connection):

* ``delay_s``              — hold the connection before dialing upstream
                             (a slow dialer / long route).
* ``throttle_bps``         — cap client->server forwarding to N bytes/s
                             (a slow uplink; the straggler generator).
* ``drop_after_bytes``     — forward N client bytes then close both ends
                             (a crash mid-upload; the reference's hang
                             trigger).
* ``reset_after_bytes``    — forward N client bytes then hard-RST both
                             ends (SO_LINGER 0 — the WinError 10053 /
                             ECONNRESET shape from the golden logs).
* ``flip_bit_after_bytes`` — flip one bit at byte offset N of the
                             client->server stream (in-flight
                             corruption; the frame CRC must catch it).
* ``duplicate_connect``    — open and abruptly abandon a second upstream
                             connection first (the reference's
                             probe-connect-kills-server race, SURVEY §5,
                             replayed against this server).

Only the client->server direction is faulted (byte counts are upload
bytes); the reply direction forwards verbatim — a reply-side fault is
indistinguishable from a reset at the next upload, and counting both
directions would make fault offsets depend on reply timing (goodbye
determinism).
"""

from __future__ import annotations

import random
import socket
import struct
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

import logging

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class FaultSpec:
    """One connection's fault plan; field semantics in the module
    docstring. The default is a clean pass-through."""

    delay_s: float = 0.0
    throttle_bps: float = 0.0
    drop_after_bytes: int = -1
    reset_after_bytes: int = -1
    flip_bit_after_bytes: int = -1
    duplicate_connect: bool = False

    def faulty(self) -> bool:
        return (
            self.delay_s > 0.0
            or self.throttle_bps > 0.0
            or self.drop_after_bytes >= 0
            or self.reset_after_bytes >= 0
            or self.flip_bit_after_bytes >= 0
            or self.duplicate_connect
        )


#: The clean pass-through plan.
CLEAN = FaultSpec()

#: A plan is a static spec for every connection, or a callable
#: ``(conn_index, rng) -> FaultSpec | None`` drawing per-connection
#: plans from the connection's deterministic rng (None = CLEAN).
Plan = FaultSpec | Callable[[int, random.Random], "FaultSpec | None"]

_CHUNK = 4096


def _hard_reset(sock: socket.socket) -> None:
    """Close with SO_LINGER(1, 0): the peer sees ECONNRESET, not a
    graceful FIN — the abrupt-death wire shape."""
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _quiet_close(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


@dataclass
class _Conn:
    index: int
    client: socket.socket
    upstream: socket.socket | None = None
    threads: list = field(default_factory=list)
    #: Set by a fault (reset/drop) so the OTHER pump thread exits its
    #: polling recv promptly. CRITICAL for fault latency: CPython defers
    #: the OS-level close of a socket while another thread is blocked in
    #: a syscall on it — a blocking s->c recv would delay the RST until
    #: its own timeout, turning a "mid-stream reset" into a
    #: ten-seconds-later one (measured; see tests).
    dead: threading.Event = field(default_factory=threading.Event)


class FaultProxy:
    """Forwarding proxy with per-connection deterministic fault plans.

    Binds an ephemeral loopback port (``.port``); every accepted
    connection is forwarded to ``(upstream_host, upstream_port)`` under
    the plan's :class:`FaultSpec`. ``events`` records what actually
    happened (``accept``/``delay``/``throttle``/``flip``/``drop``/
    ``reset``/``duplicate-connect``/``eof``) for assertions — the chaos
    harness's own observability.
    """

    def __init__(
        self,
        upstream_host: str,
        upstream_port: int,
        *,
        plan: Plan | None = None,
        seed: Any = 0,
        host: str = "127.0.0.1",
        on_forward: Callable[[int, int], None] | None = None,
    ):
        self.upstream = (upstream_host, int(upstream_port))
        self.plan = plan
        self.seed = seed
        # Byte-progress hook ``(conn_index, chunk_bytes)`` called after
        # every upstream-forwarded chunk — the dead-relay fault plan's
        # trigger (faults/deadrelay.py kills the victim process once the
        # cumulative upload bytes cross its seeded threshold, so the
        # kill lands genuinely MID-transfer). Runs on the pump thread;
        # keep it cheap and never raise.
        self.on_forward = on_forward
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._conns: list[_Conn] = []
        self._n_accepted = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        self._sock.settimeout(0.25)
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._stop.set()
        _quiet_close(self._sock)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            _quiet_close(c.client)
            if c.upstream is not None:
                _quiet_close(c.upstream)
        self._accept_thread.join(timeout=2.0)

    def __enter__(self) -> "FaultProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- accounting
    def _note(self, conn: int, event: str, **attrs: Any) -> None:
        rec = {"conn": conn, "event": event, **attrs}
        with self._lock:
            self.events.append(rec)

    def events_of(self, event: str) -> list[dict]:
        with self._lock:
            return [e for e in self.events if e["event"] == event]

    # ------------------------------------------------------------- plumbing
    def _spec_for(self, index: int) -> FaultSpec:
        import zlib

        # Per-connection generator keyed by crc32(repr((seed, index))):
        # stable across processes and runs (repr of ints/tuples is
        # deterministic; tuple seeding of random.Random is deprecated
        # and PYTHONHASHSEED would perturb hash()-based keys anyway).
        rng = random.Random(
            zlib.crc32(repr((self.seed, index)).encode("utf-8"))
        )
        plan = self.plan
        if plan is None:
            return CLEAN
        if callable(plan):
            return plan(index, rng) or CLEAN
        return plan

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            index = self._n_accepted
            self._n_accepted += 1
            conn = _Conn(index=index, client=client)
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            )
            conn.threads.append(t)
            t.start()

    def _handle(self, conn: _Conn) -> None:
        spec = self._spec_for(conn.index)
        self._note(
            conn.index,
            "accept",
            faulty=spec.faulty(),
            spec={
                k: v
                for k, v in vars(spec).items()
                if v not in (0.0, -1, False)
            },
        )
        if spec.delay_s > 0.0:
            self._note(conn.index, "delay", seconds=spec.delay_s)
            # Interruptible: close() mid-delay must not strand the thread.
            self._stop.wait(spec.delay_s)
        if self._stop.is_set():
            _quiet_close(conn.client)
            return
        try:
            if spec.duplicate_connect:
                # The reference's probe race, replayed: a second
                # connection that opens and dies with an RST before the
                # real exchange. A robust server shrugs it off.
                dup = socket.create_connection(self.upstream, timeout=5.0)
                self._note(conn.index, "duplicate-connect")
                _hard_reset(dup)
            conn.upstream = socket.create_connection(
                self.upstream, timeout=10.0
            )
        except OSError as e:
            self._note(conn.index, "upstream-failed", error=str(e))
            _hard_reset(conn.client)
            return
        s2c = threading.Thread(
            target=self._pump_s2c, args=(conn,), daemon=True
        )
        conn.threads.append(s2c)
        s2c.start()
        self._pump_c2s(conn, spec)
        # Let the reply direction drain (the server replies on this
        # connection up to a round deadline later), then tear down.
        s2c.join(timeout=0.5 if conn.dead.is_set() else 600.0)
        _quiet_close(conn.client)
        if conn.upstream is not None:
            _quiet_close(conn.upstream)

    def _pump_s2c(self, conn: _Conn) -> None:
        """Reply direction: verbatim forward until EOF/error. The recv
        POLLS (0.25 s timeout + the conn's dead flag) rather than
        blocking: a blocked recv would defer the fault path's
        linger-RST close until this thread's own timeout (CPython keeps
        the OS fd open while a sibling thread sits in a syscall on
        it)."""
        try:
            conn.upstream.settimeout(0.25)
        except OSError:
            return
        try:
            while not conn.dead.is_set() and not self._stop.is_set():
                try:
                    data = conn.upstream.recv(_CHUNK)
                except socket.timeout:
                    continue
                if not data:
                    break
                conn.client.sendall(data)
        except OSError:
            pass
        if not conn.dead.is_set():
            # Propagate the reply-side EOF without tearing down an
            # upload still in flight the other way.
            try:
                conn.client.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def _pump_c2s(self, conn: _Conn, spec: FaultSpec) -> None:
        """Upload direction: forward with the spec's faults applied at
        exact byte offsets (deterministic for a given plan)."""
        forwarded = 0
        throttled = False
        try:
            while True:
                # Bound reads so threshold crossings land mid-chunk at
                # worst _CHUNK bytes late — tight enough for tests to
                # pin "mid-upload".
                limit = _CHUNK
                for cut in (spec.drop_after_bytes, spec.reset_after_bytes):
                    if cut >= 0 and cut > forwarded:
                        limit = min(limit, cut - forwarded)
                data = conn.client.recv(max(1, limit))
                if not data:
                    self._note(conn.index, "eof", forwarded=forwarded)
                    try:
                        conn.upstream.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    return
                flip = spec.flip_bit_after_bytes
                if flip >= 0 and forwarded <= flip < forwarded + len(data):
                    buf = bytearray(data)
                    buf[flip - forwarded] ^= 0x01
                    data = bytes(buf)
                    self._note(conn.index, "flip", offset=flip)
                if spec.drop_after_bytes >= 0 and forwarded >= int(
                    spec.drop_after_bytes
                ):
                    self._note(
                        conn.index, "drop", forwarded=forwarded
                    )
                    conn.dead.set()  # unblock s2c so the close lands now
                    _quiet_close(conn.client)
                    _quiet_close(conn.upstream)
                    return
                if spec.reset_after_bytes >= 0 and forwarded >= int(
                    spec.reset_after_bytes
                ):
                    self._note(
                        conn.index, "reset", forwarded=forwarded
                    )
                    conn.dead.set()  # unblock s2c so the RST lands now
                    _hard_reset(conn.client)
                    _hard_reset(conn.upstream)
                    return
                conn.upstream.sendall(data)
                forwarded += len(data)
                if self.on_forward is not None:
                    self.on_forward(conn.index, len(data))
                if spec.throttle_bps > 0.0:
                    if not throttled:
                        throttled = True
                        self._note(
                            conn.index, "throttle", bps=spec.throttle_bps
                        )
                    # Interruptible pacing sleep.
                    if self._stop.wait(len(data) / spec.throttle_bps):
                        return
        except OSError:
            conn.dead.set()
            _quiet_close(conn.client)
            _quiet_close(conn.upstream)
