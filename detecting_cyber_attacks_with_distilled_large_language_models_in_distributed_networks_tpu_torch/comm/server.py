"""Aggregation server of a federated round over TCP (the port of
``comm/server.py``: the dense, fp32, plain FedAvg round).

The reference's ``server.py`` end to end, with the JAX package's
differences kept:

* one port, request/response on a single connection: a client uploads
  its params and the aggregate comes back on the same socket;
* clients are identified by the ``client_id`` in the message meta, not by
  accept order;
* FedAvg, weighted by ``n_samples`` when asked, and a ``min_clients``
  quorum with a round deadline, instead of hanging on a dead client;
* the wire is the non-executable ``FTPW`` message (comm/wire.py).

The fold runs in :class:`.stream_agg.StreamAgg` on the server's device:
the card folds every parameter leaf with the hand-written kernel K4, and
``device="cpu"`` with its plain version. The server never advertises
streamed uploads, so every peer, a JAX client included, sends one dense
frame per round and receives one dense reply.

Not ported: streamed uploads and replies, quantized wires, HMAC auth,
secure aggregation, central DP, relays and re-homing, server strategies
other than FedAvg, and the obs hooks. An upload that asks for one of
them (its meta says ``delta``, ``dp`` or ``secure``) is refused.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from . import framing, wire
from .stream_agg import StreamAgg

log = logging.getLogger(__name__)


def aggregate_flat(
    models: list[dict[str, np.ndarray]], weights: list[float] | None = None
) -> dict[str, np.ndarray]:
    """Weighted element-wise mean of flat param dicts in fp32, in numpy:
    the barrier mean every fold must equal bit for bit (the reference's
    ``aggregate_models``, server.py:67-79, without its in-place mutation)."""
    if not models:
        raise ValueError("no models to aggregate")
    keys = set(models[0])
    for i, m in enumerate(models[1:], 1):
        if set(m) != keys:
            raise wire.WireError(f"model {i} key set differs from model 0")
    if weights is None:
        w = np.ones(len(models), np.float64)
    else:
        w = np.asarray(weights, np.float64)
        if w.shape != (len(models),) or w.sum() <= 0:
            raise ValueError(f"bad weights {weights}")
    w = w / w.sum()
    out: dict[str, np.ndarray] = {}
    for key in models[0]:
        acc = np.zeros_like(np.asarray(models[0][key], np.float32))
        for wi, m in zip(w, models):
            if m[key].shape != acc.shape:
                raise wire.WireError(f"shape mismatch for {key!r}")
            acc += np.float32(wi) * np.asarray(m[key], np.float32)
        out[key] = acc
    return out


@dataclass
class _Round:
    """One aggregation round's rendezvous state."""

    expected: int
    round_no: int = 0
    #: Round-scoped id stamped into every reply's meta.
    trace: str = ""
    n_samples: dict[int, float] = field(default_factory=dict)  # client_id -> weight
    conns: dict[int, socket.socket] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)
    complete: threading.Event = field(default_factory=threading.Event)
    # Set (under lock) when serve_round snapshots the round; a handler that
    # finishes its recv after this drops the connection.
    closed: bool = False
    stream: StreamAgg | None = None


class AggregationServer:
    """Receive ``num_clients`` models, FedAvg them on ``device``, reply on
    the same connections.

    ``serve_round()`` runs one round; ``serve(rounds=N)`` loops. A round
    deadline plus ``min_clients`` lets the mean proceed over the
    survivors instead of hanging on a dead client. ``device`` is where the
    fold runs: the card unless ``"cpu"`` is given (no CUDA raises)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        num_clients: int = 2,
        weighted: bool = False,
        min_clients: int | None = None,
        timeout: float = 300.0,  # the reference's TIMEOUT (server.py:10)
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.num_clients = num_clients
        self.weighted = weighted
        self.min_clients = num_clients if min_clients is None else min_clients
        self.timeout = timeout
        self._round_counter = 0
        self._cur_rnd: _Round | None = None
        #: Where each round's wall went: wait (accept + uploads), agg (the
        #: fold and the reply's encode), reply (the fan-out).
        self.phase_seconds = {"wait": 0.0, "agg": 0.0, "reply": 0.0}
        #: ``StreamAgg.stats()`` of the last round that aggregated.
        self.last_fold_stats: dict | None = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(max(128, num_clients * 2))
        self._sock.settimeout(timeout)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        # Bounded upload-handler pool: one task per accepted connection,
        # the excess of a retry storm queued instead of spawned.
        self._pool = ThreadPoolExecutor(
            max_workers=2 * num_clients + 8, thread_name_prefix="fedtpu-upload"
        )
        # Every connection a handler is serving right now: close() sheds
        # them all, registered or not.
        self._conn_lock = threading.Lock()
        self._open_conns: set[socket.socket] = set()

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop accepting and shed the current round's connections as
        explicit failures (shutdown interrupts both ends' blocked reads)."""
        self._stop.set()
        self._sock.close()
        rnd = self._cur_rnd
        shed: list[socket.socket] = []
        if rnd is not None:
            with rnd.lock:
                shed += list(rnd.conns.values())
        with self._conn_lock:
            shed += list(self._open_conns)
        for c in shed:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "AggregationServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------------- round
    def _handle_upload(self, conn: socket.socket, rnd: _Round) -> None:
        with self._conn_lock:
            self._open_conns.add(conn)
        try:
            conn.settimeout(self.timeout)
            payload = framing.recv_frame(conn)
            flat, meta = wire.decode(payload)
            client_id = int(meta.get("client_id", -1))
            for mode in ("delta", "dp", "secure"):
                if meta.get(mode):
                    raise wire.ModeError(
                        f"client {client_id} uploaded a {mode!r} round: "
                        "the port's server folds dense fp32 FedAvg only"
                    )
            flat = wire.flatten_params(flat)
            n_samples = float(meta.get("n_samples", 1.0))
            with rnd.lock:
                if rnd.closed:
                    log.info(
                        f"[SERVER] late upload from client {client_id} after "
                        "round close; dropping connection"
                    )
                    conn.close()
                    return
                if client_id in rnd.n_samples:
                    # A retry replaces the first upload: nothing folds
                    # before the round closes, so nothing was consumed.
                    log.info(f"[SERVER] duplicate upload from client {client_id}; replacing")
                    rnd.stream.drop_client(client_id, poison=False)
                    old = rnd.conns.pop(client_id, None)
                    if old is not None and old is not conn:
                        old.close()
                rnd.n_samples[client_id] = n_samples
                rnd.conns[client_id] = conn
                rnd.stream.register(client_id, keys=tuple(flat), n_samples=n_samples)
                rnd.stream.add_dense(client_id, flat)
                done = len(rnd.n_samples) >= rnd.expected
            log.info(
                f"[SERVER] received model from client {client_id} "
                f"({len(rnd.n_samples)}/{rnd.expected})"
            )
            if done:
                rnd.complete.set()
        except (OSError, ValueError, TypeError, MemoryError) as e:
            # ValueError covers WireError and ModeError: fields of a peer's
            # message that fail to parse close this connection only.
            log.info(f"[SERVER] upload failed: {e}")
            conn.close()
        finally:
            with self._conn_lock:
                self._open_conns.discard(conn)

    def serve_round(self, *, deadline: float | None = None) -> dict[str, np.ndarray]:
        """Accept uploads until every client arrived (or ``deadline``
        seconds passed, default ``timeout``), fold, reply to every
        contributor. Returns the aggregate as a flat dict. Raises
        ``RuntimeError`` when the round fails (below quorum, a poisoned or
        failed fold); its connections are closed so clients fail fast."""
        rnd = _Round(expected=self.num_clients, round_no=self._round_counter)
        self._round_counter += 1
        self._cur_rnd = rnd
        rnd.trace = os.urandom(8).hex()
        rnd.stream = StreamAgg(device=self.device)
        t0 = time.monotonic()
        deadline = t0 + (self.timeout if deadline is None else deadline)
        futures: list = []
        listener_closed = False
        while not rnd.complete.is_set() and time.monotonic() < deadline:
            try:
                self._sock.settimeout(max(0.05, min(1.0, deadline - time.monotonic())))
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                listener_closed = self._stop.is_set()
                break
            try:
                futures.append(self._pool.submit(self._handle_upload, conn, rnd))
            except RuntimeError:  # close() shut the pool between accept and submit
                conn.close()
                listener_closed = True
                break
        if listener_closed:
            wait(futures, timeout=1.0)
        else:
            rnd.complete.wait(timeout=max(0.0, deadline - time.monotonic()))
            wait(futures, timeout=max(0.1, deadline - time.monotonic()))
        wait_s = time.monotonic() - t0
        rnd.stream.mark_wait_end()
        with rnd.lock:
            rnd.closed = True
            n_samples = dict(rnd.n_samples)
            conns = dict(rnd.conns)
        t_agg = time.monotonic()
        try:
            if len(n_samples) < self.min_clients:
                raise RuntimeError(
                    f"only {len(n_samples)}/{self.num_clients} clients arrived "
                    f"(min_clients={self.min_clients})"
                )
            ids = sorted(n_samples)
            weights = [n_samples[i] for i in ids] if self.weighted else None
            try:
                agg = rnd.stream.finalize(ids, weights)
            except wire.WireError as e:
                raise RuntimeError(f"aggregation failed: {e}") from e
            self.last_fold_stats = rnd.stream.stats()
            log.info(f"[SERVER] aggregated {len(ids)} models (clients {ids})")
            reply = wire.encode(
                agg,
                meta={"round_clients": ids, "agg_round": rnd.round_no, "trace": rnd.trace},
            )
        except BaseException:
            for c in conns.values():
                c.close()
            self._add_phases(wait_s, time.monotonic() - t_agg, 0.0)
            raise
        agg_s = time.monotonic() - t_agg
        t_rep = time.monotonic()
        self._reply_all(reply, conns)
        self._add_phases(wait_s, agg_s, time.monotonic() - t_rep)
        return agg

    def _add_phases(self, wait_s: float, agg_s: float, reply_s: float) -> None:
        for name, dur in (("wait", wait_s), ("agg", agg_s), ("reply", reply_s)):
            self.phase_seconds[name] += dur

    def _reply_all(self, reply: bytes, conns: dict[int, socket.socket]) -> None:
        """Parallel fan-out of the one shared reply: ``send_frame`` waits
        for each client's ACK, so one dead client must not stall the
        healthy ones behind it."""

        def _reply(cid: int, conn: socket.socket) -> None:
            try:
                framing.send_frame(conn, reply)
            except (OSError, wire.WireError) as e:
                log.info(f"[SERVER] reply to client {cid} failed: {e}")
            finally:
                conn.close()

        threads = [
            threading.Thread(target=_reply, args=(cid, conn), daemon=True)
            for cid, conn in conns.items()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout)

    def serve(self, rounds: int = 1) -> None:
        """Multi-round loop: a failed round is logged and the next one
        proceeds, so retrying clients can still complete it."""
        for r in range(rounds):
            log.info(f"[SERVER] round {r + 1}/{rounds}")
            try:
                self.serve_round()
            except RuntimeError as e:
                log.info(f"[SERVER] round {r + 1} failed: {e}")
