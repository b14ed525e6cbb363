"""Aggregation server of a federated round over TCP (the port of
``comm/server.py``: the plain round, dense or streamed, with its wire
encodings, HMAC and server strategies).

The reference's ``server.py`` end to end, with the JAX package's
differences kept:

* one port, request/response on a single connection: a client uploads
  its params and the aggregate comes back on the same socket;
* clients are identified by the ``client_id`` in the message meta, not by
  accept order;
* FedAvg, weighted by ``n_samples`` when asked, and a ``min_clients``
  quorum with a round deadline, instead of hanging on a dead client;
* the wire is the non-executable ``FTPW`` message (comm/wire.py).

Every reply offers streamed uploads (``wire.META_STREAM``, the chunk
size) and the lossy leaf encodings the server dequantizes
(``wire.META_WIRE_DTYPES``), so from round 2 on a capable client uploads
leaf by leaf: header, chunks, trailer. Each leaf is decoded (and
dequantized) as its bytes complete and handed to the round's
:class:`.stream_agg.StreamAgg`, which folds it into the mean the moment
every member's copy has arrived, while the slower client is still on the
wire. The fold runs on the server's device: on the card with the
hand-written kernel K4, once per leaf, and with ``device="cpu"`` with its
plain version. Dense and streamed uploads, sparse top-k deltas (folded
against the last aggregate) and a JAX peer mix in one round. A client
that advertises it gets the reply streamed too, in the ``--reply-dtype``
encoding when it advertises that.

With ``auth_key`` every connection opens with a nonce challenge; the
upload must echo it (role ``client``) under a valid HMAC, and the reply
echoes it back (role ``server``). A server strategy transforms the folded
mean at finalize; its post-strategy global and optimizer state can be
kept in a state file (the JAX package's npz layout, so either package's
server resumes the other's).

Not ported: secure aggregation, central DP, relays and re-homing, and the
obs hooks. An upload that asks for one of them is refused with
:class:`.wire.ModeError`.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..strategies import Strategy, make_strategy
from . import framing, wire
from .stream_agg import StreamAgg

log = logging.getLogger(__name__)

#: Upload meta fields of the JAX package's modes the port does not fold.
_UNPORTED_UPLOAD_MODES = {
    "secure": "secure aggregation",
    "dp": "central DP",
    "subtree_ids": "a relay's subtree upload",
    "rehomed": "client re-homing",
    wire.META_STRATEGY: "a relay's strategy claim",
}


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
    #: Clients whose upload completed (the StreamAgg holds the tensors).
    done: set = field(default_factory=set)
    n_samples: dict[int, float] = field(default_factory=dict)  # client_id -> weight
    conns: dict[int, socket.socket] = field(default_factory=dict)
    nonces: dict[int, str] = field(default_factory=dict)  # auth mode only
    lock: threading.Lock = field(default_factory=threading.Lock)
    complete: threading.Event = field(default_factory=threading.Event)
    # Set (under lock) when serve_round snapshots the round; a handler that
    # finishes its recv after this drops the connection.
    closed: bool = False
    #: A sparse-delta client took part: the reply carries ``agg_crc``.
    wants_delta: bool = False
    stream: StreamAgg | None = None
    #: Clients that advertised streamed replies, and the lossy reply
    #: encodings each said it decodes.
    stream_replies: set = field(default_factory=set)
    reply_dtype_encs: dict[int, tuple] = field(default_factory=dict)
    #: Per completed upload: ``{"shape": "dense"|"stream", "wire_dtype",
    #: "bytes"}`` (what arrived, from the frames themselves).
    uploads: dict[int, dict] = field(default_factory=dict)


class AggregationServer:
    """Receive ``num_clients`` models, fold them on ``device``, apply the
    strategy, reply on the same connections.

    ``serve_round()`` runs one round; ``serve(rounds=N)`` loops. A round
    deadline plus ``min_clients`` lets the mean proceed over the
    survivors instead of hanging on a dead client. ``device`` is where the
    fold (and a FedOpt strategy's optimizer) runs: the card unless
    ``"cpu"`` is given (no CUDA raises). ``stream_chunk_bytes=0`` turns
    the stream offer and eager folding off (the barrier round)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        num_clients: int = 2,
        weighted: bool = False,
        min_clients: int | None = None,
        timeout: float = 300.0,  # the reference's TIMEOUT (server.py:10)
        compression: str = "none",
        auth_key: bytes | None = None,
        stream_chunk_bytes: int = wire.DEFAULT_STREAM_CHUNK,
        strategy: str | Strategy | None = None,
        strategy_state_path: str | None = None,
        reply_dtype: str = "fp32",
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        if wire.parse_compression(compression)[0] == "topk":
            raise ValueError(
                "topk is an upload-side (sparse round-delta) compression; "
                "the reply is an absolute aggregate — use none/bf16/int8"
            )
        if reply_dtype not in wire.WIRE_DTYPE_ENCS:
            raise ValueError(f"reply_dtype {reply_dtype!r} must be one of {sorted(wire.WIRE_DTYPE_ENCS)}")
        if reply_dtype != "fp32" and compression != "none":
            raise ValueError(
                "reply_dtype and a reply compression are two encoders for the "
                f"same leg; pass one (compression {compression!r} already "
                "re-encodes the reply)"
            )
        cap = framing.MAX_FRAME - wire.STREAM_CHUNK_OVERHEAD
        if not 0 <= int(stream_chunk_bytes) <= cap:
            raise ValueError(f"stream_chunk_bytes={stream_chunk_bytes} must be in [0, {cap}] (0 = streaming off)")
        self.num_clients = num_clients
        self.weighted = weighted
        self.min_clients = num_clients if min_clients is None else min_clients
        self.timeout = timeout
        self.compression = compression
        self.auth_key = auth_key
        self.stream_chunk_bytes = int(stream_chunk_bytes)
        self.reply_dtype = reply_dtype
        self._strategy = make_strategy(strategy, device=self.device)
        self._round_counter = 0
        #: The last post-strategy global (flat fp32) and its round: the
        #: strategy's previous global and the sparse deltas' base.
        self._last_agg: dict | None = None
        self._last_agg_round = -1
        #: The last round's folded mean, before the strategy.
        self.last_mean: dict | None = None
        self.strategy_state_path = strategy_state_path
        self._strategy_persist_lock = threading.Lock()
        self._strategy_persist_pending: tuple | None = None
        self._strategy_persist_thread: threading.Thread | None = None
        if strategy_state_path:
            self._load_strategy_state()
        self._cur_rnd: _Round | None = None
        #: Where each round's wall went: wait (accept + uploads, with the
        #: folds that overlapped them), agg (the rest of the fold, the
        #: strategy and the replies' encode), reply (the fan-out).
        self.phase_seconds = {"wait": 0.0, "agg": 0.0, "reply": 0.0}
        #: ``StreamAgg.stats()`` of the last round that aggregated, and
        #: its per-client upload record (``_Round.uploads``).
        self.last_fold_stats: dict | None = None
        self.last_uploads: dict[int, dict] = {}
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

    # -------------------------------------------------------------- strategy
    @property
    def strategy(self) -> Strategy:
        return self._strategy

    def set_strategy(self, spec) -> Strategy:
        """Swap the aggregation strategy BETWEEN rounds; its optimizer
        state starts fresh."""
        self._strategy = make_strategy(spec, device=self.device)
        return self._strategy

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop accepting, shed the current round's connections as
        explicit failures (shutdown interrupts both ends' blocked reads),
        and let the state-file writer finish."""
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
        with self._strategy_persist_lock:
            t = self._strategy_persist_thread
        if t is not None:
            t.join(timeout=60.0)

    def __enter__(self) -> "AggregationServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- uploads
    def _validate_upload(self, meta, nonce_hex: str | None) -> int:
        """Freshness, identity and mode checks the dense and the streamed
        upload share; returns the client id."""
        if self.auth_key is not None and (
            meta.get("role") != "client" or meta.get("nonce") != nonce_hex
        ):
            raise wire.WireError(
                "authenticated upload failed the freshness check "
                "(stale nonce or wrong role) — possible replay"
            )
        client_id = int(meta.get("client_id", -1))
        for key, mode in _UNPORTED_UPLOAD_MODES.items():
            if meta.get(key):
                raise wire.ModeError(
                    f"client {client_id} uploaded with {key}={meta[key]!r}: "
                    f"{mode} is not ported"
                )
        return client_id

    def _check_delta(self, flat, meta) -> None:
        """A sparse-delta upload must name the server's current base."""
        try:
            base_round = int(meta.get("base_agg_round", -2))
        except (TypeError, ValueError):
            raise wire.WireError(
                f"malformed base_agg_round {meta.get('base_agg_round')!r} in delta upload"
            ) from None
        base = self._last_agg
        if base is None or base_round != self._last_agg_round:
            raise wire.WireError(
                f"delta upload against base round {meta.get('base_agg_round')} but server "
                f"base is {self._last_agg_round if base is not None else 'absent'} "
                "(restart or stale client) — client will resend dense"
            )
        if not wire.shapes_compatible(flat, base):
            raise wire.WireError("delta upload's tensor set/shapes do not match the base")

    @staticmethod
    def _note_reply_caps(rnd: _Round, client_id: int, meta) -> None:
        """Caller holds ``rnd.lock``: the streamed-reply advert."""
        if bool(meta.get(wire.META_STREAM_REPLY, False)):
            rnd.stream_replies.add(client_id)
            encs = meta.get(wire.META_REPLY_DTYPES)
            if isinstance(encs, (list, tuple)):
                rnd.reply_dtype_encs[client_id] = tuple(str(e) for e in encs)

    def _handle_upload(self, conn: socket.socket, rnd: _Round) -> None:
        with self._conn_lock:
            self._open_conns.add(conn)
        try:
            conn.settimeout(self.timeout)
            nonce_hex = None
            if self.auth_key is not None:
                # Freshness and direction binding: the upload echoes this
                # challenge inside its authenticated header, the reply
                # echoes it back with role=server.
                nonce_hex = os.urandom(wire.NONCE_LEN).hex()
                framing.send_frame(conn, wire.NONCE_MAGIC + bytes.fromhex(nonce_hex))
            payload = framing.recv_frame(conn)
            if bytes(payload[:4]) == wire.STREAM_MAGIC:
                self._handle_stream_upload(conn, payload, rnd, nonce_hex=nonce_hex)
                return
            flat, meta = wire.decode(payload, auth_key=self.auth_key)
            client_id = self._validate_upload(meta, nonce_hex)
            flat = wire.flatten_params(flat)
            is_delta = bool(meta.get("delta", False))
            if is_delta:
                self._check_delta(flat, meta)
            n_samples = float(meta.get("n_samples", 1.0))
            with rnd.lock:
                if rnd.closed:
                    log.info(
                        f"[SERVER] late upload from client {client_id} after "
                        "round close; dropping connection"
                    )
                    conn.close()
                    return
                dup_folded = False
                if client_id in rnd.done or client_id in rnd.stream.intents:
                    # A retry replaces the first upload, unless folds
                    # already consumed it: then the folded original stands
                    # and only the connection is adopted, so the client
                    # still gets the round's reply.
                    dup_folded = not rnd.stream.drop_client(client_id, poison=False)
                    log.info(
                        f"[SERVER] duplicate upload from client {client_id}; "
                        + ("keeping the already-aggregated original" if dup_folded else "replacing")
                    )
                    old = rnd.conns.pop(client_id, None)
                    if old is not None and old is not conn:
                        old.close()
                    if dup_folded and client_id not in rnd.done:
                        # The folded original is a stream that never
                        # reached its trailer: the retry's leaves (the
                        # same upload) complete the remaining folds.
                        it = rnd.stream.intents.get(client_id, {})
                        rnd.done.add(client_id)
                        rnd.n_samples[client_id] = float(it.get("n_samples", 1.0))
                        rnd.uploads[client_id] = {"shape": "dense", "wire_dtype": "fp32", "bytes": len(payload)}
                        if set(flat) == set(it.get("keys", ())) and is_delta == bool(it.get("delta", False)):
                            rnd.stream.add_dense(client_id, flat)
                if not dup_folded:
                    rnd.done.add(client_id)
                    rnd.n_samples[client_id] = n_samples
                    rnd.uploads[client_id] = {"shape": "dense", "wire_dtype": "fp32", "bytes": len(payload)}
                if is_delta or bool(meta.get("wants_delta", False)):
                    rnd.wants_delta = True
                self._note_reply_caps(rnd, client_id, meta)
                rnd.conns[client_id] = conn
                if nonce_hex is not None:
                    rnd.nonces[client_id] = nonce_hex
                if not dup_folded:
                    rnd.stream.register(client_id, keys=tuple(flat), n_samples=n_samples, delta=is_delta)
                    rnd.stream.add_dense(client_id, flat)
                    self._try_freeze_stream(rnd)
                done = len(rnd.done) >= rnd.expected
            log.info(
                f"[SERVER] received model from client {client_id} "
                f"({len(rnd.done)}/{rnd.expected})"
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

    def _try_freeze_stream(self, rnd: _Round) -> None:
        """Caller holds ``rnd.lock``: freeze the fold set once every
        expected client's intent has arrived, with the close-time weights,
        so folds start while slower clients are still on the wire."""
        st = rnd.stream
        if not st.eager or st.fold_ids is not None or st.poisoned:
            return
        ids = sorted(st.intents)
        if len(ids) < rnd.expected:
            return
        weights = [st.intents[c]["n_samples"] for c in ids] if self.weighted else None
        st.freeze(ids, weights)

    def _handle_stream_upload(
        self, conn: socket.socket, header, rnd: _Round, *, nonce_hex: str | None
    ) -> None:
        """Receive one streamed upload: validate the header's meta as a
        dense upload's, register the intent, then decode each leaf as its
        bytes complete and hand it to the StreamAgg, which folds it the
        moment every member's copy arrived. The trailer is the
        upload-complete handshake; only then does the client count toward
        the round. A duplicate after folds consumed the first upload is
        drained (a completed original stands) or adopted (the retry of a
        half-folded, dead stream completes the folds)."""
        st = rnd.stream
        tensors, meta, _chunk_bytes, payload_nbytes = wire.decode_stream_header(
            header, auth_key=self.auth_key, max_payload=framing.MAX_FRAME, direction="up"
        )
        client_id = self._validate_upload(meta, nonce_hex)
        if bool(meta.get("delta", False)):
            raise wire.WireError(
                "sparse-delta uploads are single-frame (topk payload sizes are "
                "data-dependent; nothing to stream)"
            )
        n_samples = float(meta.get("n_samples", 1.0))
        # The wire dtype, from what the header actually encodes.
        encs = {t["enc"] for t in tensors}
        up_dtype = "int8" if "int8c" in encs else "bf16" if "bf16" in encs else "fp32"
        keys = tuple(t["key"] for t in tensors)
        discard = adopt = False
        with rnd.lock:
            if rnd.closed:
                conn.close()
                return
            if client_id in rnd.done or client_id in st.intents:
                folded = not st.drop_client(client_id, poison=False)
                if folded and client_id not in rnd.done:
                    it = st.intents[client_id]
                    adopt = keys == tuple(it["keys"])
                    if adopt:
                        # The frozen weights came from the original intent.
                        n_samples = float(it["n_samples"])
                discard = folded and not adopt
                log.info(
                    f"[SERVER] duplicate upload from client {client_id}; "
                    + (
                        "draining it and keeping the already-aggregated original"
                        if discard
                        else "adopting it to complete the half-folded original"
                        if adopt
                        else "replacing"
                    )
                )
                old = rnd.conns.pop(client_id, None)
                if old is not None and old is not conn:
                    old.close()
                if not (discard or adopt):
                    rnd.done.discard(client_id)
            if not (discard or adopt):
                st.register(client_id, keys=keys, n_samples=n_samples)
            # Registered now: a failed round's cleanup closes a mid-stream
            # client too.
            rnd.conns[client_id] = conn
            self._try_freeze_stream(rnd)
        nonce = bytes.fromhex(nonce_hex) if nonce_hex else b""

        def on_leaf(t: dict, raw: bytes) -> None:
            if not discard:
                st.add_leaf(client_id, t["key"], wire.decode_tensor_entry(t, raw))

        try:
            seq, body = framing.recv_stream(
                conn, tensors, payload_nbytes, on_leaf, auth_key=self.auth_key, nonce=nonce, direction="up"
            )
            if not discard:
                st.mark_complete(client_id)
        except BaseException:
            # Mid-stream death: forget the client's unfolded leaves; if
            # folds consumed any, the round is poisoned and fails at close.
            # A retry that already took this client's slot owns its state.
            if not discard:
                with rnd.lock:
                    if rnd.conns.get(client_id) is conn:
                        st.drop_client(client_id)
            raise
        with rnd.lock:
            if rnd.closed or rnd.conns.get(client_id) is not conn:
                log.info(
                    f"[SERVER] stream from client {client_id} ended after round "
                    "close or was superseded by a retry; dropping connection"
                )
                conn.close()
                return
            if not discard:
                rnd.done.add(client_id)
                rnd.n_samples[client_id] = n_samples
                rnd.uploads[client_id] = {"shape": "stream", "wire_dtype": up_dtype, "bytes": len(header) + body}
            if bool(meta.get("wants_delta", False)):
                rnd.wants_delta = True
            self._note_reply_caps(rnd, client_id, meta)
            if nonce_hex is not None:
                rnd.nonces[client_id] = nonce_hex
            done = len(rnd.done) >= rnd.expected
        log.info(
            f"[SERVER] received streamed model from client {client_id} "
            f"({payload_nbytes / 1e6:.1f} MB {up_dtype} in {seq} chunk(s)"
            + ("; drained as a duplicate" if discard else "")
            + f"; {len(rnd.done)}/{rnd.expected})"
        )
        if done:
            rnd.complete.set()

    # ----------------------------------------------------------------- round
    def serve_round(self, *, deadline: float | None = None) -> dict[str, np.ndarray]:
        """Accept uploads until every client arrived (or ``deadline``
        seconds passed, default ``timeout``), fold, apply the strategy,
        reply to every contributor. Returns the new global as a flat dict.
        Raises ``RuntimeError`` when the round fails (below quorum, a
        poisoned or failed fold); its connections are closed so clients
        fail fast."""
        rnd = _Round(expected=self.num_clients, round_no=self._round_counter)
        self._round_counter = rnd.round_no + 1
        self._cur_rnd = rnd
        rnd.trace = os.urandom(8).hex()
        # Quorum deployments fold at close: an eager fold commits to the
        # full contributor set, and one mid-stream death would then fail
        # a round the barrier completes over the survivors.
        rnd.stream = StreamAgg(
            device=self.device,
            eager=self.stream_chunk_bytes > 0 and self.min_clients >= self.num_clients,
            base=self._last_agg,
        )
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
            done = set(rnd.done)
            n_samples = dict(rnd.n_samples)
            conns = dict(rnd.conns)
            nonces = dict(rnd.nonces)
        t_agg = time.monotonic()
        try:
            if len(done) < self.min_clients:
                raise RuntimeError(
                    f"only {len(done)}/{self.num_clients} clients arrived "
                    f"(min_clients={self.min_clients})"
                )
            ids = sorted(done)
            weights = [n_samples[i] for i in ids] if self.weighted else None
            try:
                mean = rnd.stream.finalize(ids, weights)
            except wire.WireError as e:
                raise RuntimeError(f"aggregation failed: {e}") from e
            self.last_fold_stats = rnd.stream.stats()
            self.last_uploads = {i: dict(rnd.uploads[i]) for i in ids}
            self.last_mean = mean
            log.info(
                f"[SERVER] aggregated {len(ids)} models (clients {ids}; "
                f"{self.last_fold_stats['overlap_frac']:.0%} of fold input consumed "
                "during the wire phase)"
            )
            agg = self._strategy.apply(
                self._last_agg, mean, round_no=rnd.round_no, client_stats=rnd.stream.client_stats()
            )
            # The post-strategy global is what clients adopt, so it is the
            # next round's strategy input and sparse-delta base.
            self._last_agg = agg
            self._last_agg_round = rnd.round_no
            self._persist_strategy_state()
            reply_meta = {
                "round_clients": ids,
                "agg_round": rnd.round_no,
                "trace": rnd.trace,
                wire.META_STRATEGY: self._strategy.describe(),
            }
            if rnd.wants_delta:
                # The base-agreement stamp: a sparse client adopts the
                # decoded reply as its delta base only if it hashes to this.
                reply_meta["agg_crc"] = wire.flat_crc32(agg)
            if self.stream_chunk_bytes > 0:
                reply_meta[wire.META_STREAM] = self.stream_chunk_bytes
                reply_meta[wire.META_WIRE_DTYPES] = sorted(set(wire.WIRE_DTYPE_ENCS.values()))
            replies, stream_jobs = self._build_replies(rnd, ids, agg, reply_meta, nonces)
        except BaseException:
            for c in conns.values():
                c.close()
            self._add_phases(wait_s, time.monotonic() - t_agg, 0.0)
            raise
        agg_s = time.monotonic() - t_agg
        t_rep = time.monotonic()
        self._reply_all(replies, conns, stream_jobs)
        self._add_phases(wait_s, agg_s, time.monotonic() - t_rep)
        return agg

    def _add_phases(self, wait_s: float, agg_s: float, reply_s: float) -> None:
        for name, dur in (("wait", wait_s), ("agg", agg_s), ("reply", reply_s)):
            self.phase_seconds[name] += dur

    def serve(self, rounds: int = 1) -> None:
        """Multi-round loop: a failed round is logged and the next one
        proceeds, so retrying clients can still complete it."""
        for r in range(rounds):
            log.info(f"[SERVER] round {r + 1}/{rounds}")
            try:
                self.serve_round()
            except RuntimeError as e:
                log.info(f"[SERVER] round {r + 1} failed: {e}")

    # --------------------------------------------------------------- replies
    def _encode_reply(self, agg: dict, meta: dict, nonce: str | None) -> bytes:
        """One dense reply; auth mode echoes the client's nonce with
        role=server."""
        if self.auth_key is None:
            return wire.encode(agg, meta=meta, compression=self.compression)
        return wire.encode(
            agg,
            meta={**meta, "role": "server", "nonce": nonce},
            compression=self.compression,
            auth_key=self.auth_key,
        )

    def _build_replies(
        self, rnd: _Round, ids: list[int], agg: dict, reply_meta: dict, nonces: dict[int, str]
    ) -> tuple[dict[int, bytes], dict[int, tuple[bytes, dict, bytes]]]:
        """The round's dense reply blobs and streamed-reply jobs. A client
        that advertised streamed replies gets the stream (in the
        ``reply_dtype`` encoding when it advertised that); the payload
        chunks of each encoding are built once and shared."""
        stream_ids = (
            [cid for cid in ids if cid in rnd.stream_replies] if self.stream_chunk_bytes > 0 else []
        )
        quant_enc = wire.WIRE_DTYPE_ENCS[self.reply_dtype]
        quant_ids = (
            {cid for cid in stream_ids if quant_enc in rnd.reply_dtype_encs.get(cid, ())}
            if self.reply_dtype != "fp32"
            else set()
        )
        quant_plan = self._plan_reply_stream(agg, quant_enc) if quant_ids else None
        base_plan = (
            self._plan_reply_stream(agg, self.compression)
            if any(cid not in quant_ids for cid in stream_ids)
            else None
        )
        dense_ids = [c for c in ids if c not in stream_ids]
        if not dense_ids:
            replies = {}
        elif self.auth_key is None:
            shared = wire.encode(agg, meta=reply_meta, compression=self.compression)
            replies = {cid: shared for cid in dense_ids}
        else:
            replies = {cid: self._encode_reply(agg, reply_meta, nonces.get(cid)) for cid in dense_ids}
        jobs = {}
        for cid in stream_ids:
            plan = quant_plan if cid in quant_ids else base_plan
            meta = reply_meta
            if self.auth_key is not None:
                meta = {**reply_meta, "role": "server", "nonce": nonces.get(cid)}
            header = wire.encode_stream_header(
                plan["tensors"], meta=meta, chunk_bytes=self.stream_chunk_bytes,
                payload_nbytes=plan["payload_nbytes"], auth_key=self.auth_key, direction="down",
            )
            jobs[cid] = (header, plan, bytes.fromhex(nonces[cid]) if cid in nonces else b"")
        return replies, jobs

    def _plan_reply_stream(self, agg: dict, compression: str) -> dict:
        """One encoding's streamed-reply payload, built once per round:
        the tensor plan and the chunk list every client's fan-out shares
        (per-client headers and tags are layered on when sending)."""
        flat = wire.flatten_lazy(agg)
        tensors, payload_nbytes = wire.plan_stream(flat, compression)
        chunks: list[bytes] = []
        buf = bytearray()
        for t in tensors:
            buf += wire.encode_stream_leaf(flat[t["key"]], t["enc"])
            while len(buf) >= self.stream_chunk_bytes:
                chunks.append(bytes(buf[: self.stream_chunk_bytes]))
                del buf[: self.stream_chunk_bytes]
        if buf:
            chunks.append(bytes(buf))
        return {"tensors": tensors, "chunks": chunks, "payload_nbytes": payload_nbytes}

    def _send_stream_reply(self, conn: socket.socket, header: bytes, plan: dict, nonce: bytes) -> None:
        """ACKed header, fire-and-forget chunks, ACKed trailer, each under
        the reply direction's tag domain."""
        framing.send_frame(conn, header)
        for seq, chunk in enumerate(plan["chunks"]):
            framing.send_frame(
                conn,
                wire.encode_stream_chunk(seq, chunk, auth_key=self.auth_key, nonce=nonce, direction="down"),
                await_ack=False,
            )
        framing.send_frame(
            conn,
            wire.encode_stream_end(len(plan["chunks"]), auth_key=self.auth_key, nonce=nonce, direction="down"),
        )

    def _reply_all(
        self,
        replies: dict[int, bytes],
        conns: dict[int, socket.socket],
        stream_jobs: dict[int, tuple[bytes, dict, bytes]],
    ) -> None:
        """Parallel fan-out: ``send_frame`` waits for each client's ACK,
        so one dead client must not stall the healthy ones behind it."""

        def _reply(cid: int, conn: socket.socket) -> None:
            try:
                if cid in stream_jobs:
                    self._send_stream_reply(conn, *stream_jobs[cid])
                else:
                    framing.send_frame(conn, replies[cid])
            except (OSError, wire.WireError) as e:
                log.info(f"[SERVER] reply to client {cid} failed: {e}")
            finally:
                conn.close()

        threads = [
            threading.Thread(target=_reply, args=(cid, conns[cid]), daemon=True)
            for cid in sorted({*replies, *stream_jobs})
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout)

    # ------------------------------------------------------ strategy state
    def _load_strategy_state(self) -> None:
        """Reload the state file: the last post-strategy global, its
        round, and the strategy's optimizer leaves. A missing file is a
        fresh deployment; a corrupt one, or one of another strategy, is
        logged and ignored."""
        try:
            with np.load(self.strategy_state_path, allow_pickle=False) as z:
                index = json.loads(bytes(z["__index__"].tobytes()).decode())
                agg = {k: np.asarray(z[f"a{j}"], np.float32) for j, k in enumerate(index["keys"])}
                opt_leaves = [np.asarray(z[f"o{j}"]) for j in range(int(index.get("n_opt", 0)))]
        except FileNotFoundError:
            return
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            log.warning(
                f"[SERVER] could not reload server strategy state from "
                f"{self.strategy_state_path} ({e}); starting fresh"
            )
            return
        if index.get("strategy") != self._strategy.describe():
            log.warning(
                f"[SERVER] persisted strategy state is for {index.get('strategy')}, this "
                f"server runs {self._strategy.describe()}; starting fresh"
            )
            return
        self._last_agg = agg
        self._last_agg_round = int(index["round"])
        self._round_counter = self._last_agg_round + 1
        restored_opt = bool(opt_leaves) and self._strategy.restore_state(opt_leaves, agg)
        if opt_leaves and not restored_opt:
            log.warning(
                "[SERVER] persisted optimizer-state leaves do not match this "
                "strategy/model; optimizer memory starts fresh"
            )
        log.info(
            f"[SERVER] reloaded round {self._last_agg_round} global"
            + (" + optimizer state" if restored_opt else "")
            + f" from {self.strategy_state_path} (strategy {self._strategy.name})"
        )

    def _persist_strategy_state(self) -> None:
        """Queue the current global and optimizer state for the background
        writer (a latest-snapshot slot: the round never waits on disk)."""
        if not self.strategy_state_path or self._last_agg is None:
            return
        opt = self._strategy.export_state()
        snap = (
            int(self._last_agg_round),
            {k: np.asarray(v, np.float32) for k, v in self._last_agg.items()},
            self._strategy.describe(),
            [np.asarray(a) for a in (opt or [])],
        )
        with self._strategy_persist_lock:
            self._strategy_persist_pending = snap
            if self._strategy_persist_thread is None or not self._strategy_persist_thread.is_alive():
                self._strategy_persist_thread = threading.Thread(
                    target=self._strategy_persist_loop, daemon=True
                )
                self._strategy_persist_thread.start()

    def _strategy_persist_loop(self) -> None:
        while True:
            with self._strategy_persist_lock:
                snap = self._strategy_persist_pending
                self._strategy_persist_pending = None
                if snap is None:
                    self._strategy_persist_thread = None
                    return
            self._write_strategy_state(snap)

    def _write_strategy_state(self, snap: tuple) -> None:
        """One atomic snapshot (tmp + replace) in the JAX package's npz
        layout: a JSON ``__index__`` (round, strategy, global key order,
        optimizer leaf count), the global as ``a{j}``, the optimizer leaves
        as ``o{j}``."""
        round_no, agg, described, opt_leaves = snap
        index = {"round": int(round_no), "strategy": described, "keys": list(agg), "n_opt": len(opt_leaves)}
        arrays: dict[str, np.ndarray] = {
            "__index__": np.frombuffer(json.dumps(index).encode(), dtype=np.uint8)
        }
        for j, k in enumerate(agg):
            arrays[f"a{j}"] = agg[k]
        for j, leaf in enumerate(opt_leaves):
            arrays[f"o{j}"] = leaf
        tmp = self.strategy_state_path + ".tmp"
        try:
            os.makedirs(os.path.dirname(os.path.abspath(tmp)) or ".", exist_ok=True)
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, self.strategy_state_path)
        except OSError as e:
            log.warning(f"[SERVER] could not persist server strategy state to {self.strategy_state_path}: {e}")
