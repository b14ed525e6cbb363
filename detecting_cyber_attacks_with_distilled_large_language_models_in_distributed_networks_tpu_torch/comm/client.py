"""Federated client session over TCP (the port of ``comm/client.py``: the
plain round, dense or streamed, with its wire encodings and HMAC).

The reference's client session (connect, upload, poll a second port,
download; client1.py:276-336) is one request/response on one connection
here: upload the local params, block until the aggregate comes back on
the same socket, with seeded dial backoff standing in for the reference's
``wait_for_server`` probe loop (client1.py:298-311).

Capabilities are negotiated in plain meta, so a JAX peer on either side
interoperates:

* every upload advertises that this client decodes streamed replies in
  every lossy encoding (``wire.META_STREAM_REPLY``,
  ``wire.META_REPLY_DTYPES``), unless ``stream=False``
  (``--no-stream-upload``): then it neither streams nor asks for a
  streamed reply;
* a reply's stream offer (``wire.META_STREAM``) and wire-dtype offer
  (``wire.META_WIRE_DTYPES``) take effect one reply behind: round 1 goes
  dense, and from round 2 on the upload is streamed leaf by leaf, in the
  ``wire_dtype`` encoding once the server offers it. Each leaf is
  gathered (a ``models.convert.HostLeaf`` comes off the card only now)
  and encoded while the previous chunks are on the wire
  (``framing.PipelinedSender``);
* a retry, or a server that stops offering streams, goes dense: the
  single frame is always correct (``_log_dense_fallback`` says why, once
  per reason);
* with a ``topk[:frac]`` compression, rounds after the first upload sparse
  deltas against the last aggregate with client-side error feedback; the
  base is adopted only when it hashes to the server's ``agg_crc`` stamp,
  so a lossy reply keeps the client dense;
* with ``auth_key`` the server's nonce is echoed in the upload's meta, and
  the reply must echo it back with role ``server``;
* with ``dp=True`` (central DP, ``--dp``) the client reads the server's
  DP advert, names itself, and on its cohort verdict either uploads its
  round delta against ``round_base`` clipped to the advertised bound
  (dense, never streamed), or sits the round out; the reply is the
  noised mean delta (applied to the base), a ``noop``, or a ``resync``
  sequence replayed onto a stale base;
* a plain client whose first attempt failed peeks at the server's first
  frame, and names the fix when the server runs DP or auth.

* with ``secure_agg`` (``--secure-agg``) the client reads the secure
  round advert, sends its DH hello, masks its update over the relayed key
  set (under double masking after dealing Shamir shares of its seeds) and
  answers the unmask or reveal request; the three retry pins of the JAX
  client hold (the keyed set and U2 per round, the answered unmask
  partition, and the ``min_participants`` floor);
* with ``fallback_parents`` a dead parent (its dial budget spent, or its
  connection lost mid-exchange) moves the client to the next parent of
  the ranked list for good; every later upload carries
  ``wire.META_REHOMED`` and ``fedtpu_client_rehomes_total`` counts the
  move.

With a ``tracer`` the client writes its round's spans once the reply
reveals the round's (trace, round) identity: the caller's buffered
``client-local`` phase (:meth:`FederatedClient.note_local_phase`), then
``wire-upload`` and ``wire-reply``; with ``--profile-stride`` those carry
the sampled per-leaf pack / unpack timings of the streamed legs
(``step_wire_ms_*``), as in the JAX package.
"""

from __future__ import annotations

import hmac
import logging
import os
import random
import socket
import struct
import threading
import time
from typing import Any, Iterator, Mapping

import numpy as np

from ..obs import metrics as obs_metrics

from . import framing, secure, shamir, wire

log = logging.getLogger(__name__)


#: Re-home reasons (the ``fedtpu_client_rehomes_total`` label values).
REHOME_REASONS = ("dial-exhausted", "mid-exchange")


def _rehome_counters() -> dict:
    """Per-reason re-home counters on the default registry, registered as
    the JAX client registers them (get-or-create: every client of a
    process shares the family)."""
    m = obs_metrics.default_registry()
    return {
        # fedtpu: allow(obs-metric-once): the JAX package's comm/client.py family, same name/kind/labels/help
        r: m.counter(
            "fedtpu_client_rehomes_total",
            help="exchanges moved to a fallback parent, by reason "
            "(dial-exhausted | mid-exchange)",
            labels={"reason": r},
        )
        for r in REHOME_REASONS
    }


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
    abort_event: threading.Event | None = None,
) -> socket.socket:
    """Dial until the server is up or ``timeout`` elapses, retrying on
    the :func:`backoff_intervals` schedule; ``abort_event`` (a closing
    relay) interrupts the backoff."""
    deadline = time.monotonic() + timeout
    last: Exception | None = None
    sched = backoff_intervals(base=poll_interval, cap=max_interval, seed=retry_seed)
    while time.monotonic() < deadline:
        if abort_event is not None and abort_event.is_set():
            raise ConnectionError(f"dial of {host}:{port} aborted")
        try:
            return socket.create_connection(
                (host, port), timeout=max(0.1, deadline - time.monotonic())
            )
        except OSError as e:
            last = e
            pause = min(next(sched), max(0.0, deadline - time.monotonic()))
            if abort_event is None:
                time.sleep(pause)
            elif abort_event.wait(pause):
                raise ConnectionError(f"dial of {host}:{port} aborted") from e
    raise ConnectionError(f"server {host}:{port} unreachable after {timeout}s: {last}")


class FederatedClient:
    """One client's view of a federated round over TCP."""

    #: After giving up on sparse mode, re-advertise wants_delta once every
    #: this many dense uploads, so a server that became lossless is found.
    PROBE_EVERY = 8

    def __init__(
        self,
        host: str,
        port: int,
        *,
        client_id: int,
        timeout: float = 300.0,
        compression: str = "none",
        auth_key: bytes | None = None,
        stream: bool = True,
        wire_dtype: str = "fp32",
        dp: bool = False,
        secure_agg: bool = False,
        num_clients: int | None = None,
        fp_bits: int = secure.DEFAULT_FP_BITS,
        client_key: bytes | None = None,
        min_participants: int | None = None,
        secure_protocol: str = "double",
        secure_threshold: int | None = None,
        fallback_parents: list[tuple[str, int]] | None = None,
        rehome_dial_budget: float = 8.0,
        tracer=None,
    ):
        _, self._topk_frac = wire.parse_compression(compression)
        if wire_dtype != "fp32" and secure_agg:
            raise ValueError(
                "wire_dtype quantization is incompatible with secure "
                "aggregation: masked uploads are uniform ring "
                "elements — quantizing them destroys mask "
                "cancellation"
            )
        if fallback_parents and (secure_agg or dp):
            # A secure session is keyed to one server's (session, round),
            # a DP base to one server's history.
            raise ValueError(
                "fallback_parents (client re-homing) is a plain/relay-"
                "tree feature: secure aggregation and central DP bind "
                "the exchange to a single aggregator"
            )
        if rehome_dial_budget <= 0.0:
            raise ValueError(f"rehome_dial_budget={rehome_dial_budget} must be > 0")
        if client_key is not None and auth_key is None:
            raise ValueError(
                "client_key (per-client DH identity binding) requires "
                "auth_key: the rest of the exchange is authenticated "
                "under the group key"
            )
        if secure_agg and num_clients is None:
            raise ValueError(
                "secure aggregation needs num_clients: each client must "
                "mask against the full advertised participant set"
            )
        if secure_protocol not in ("reveal", "double"):
            raise ValueError(f"secure_protocol {secure_protocol!r} must be reveal|double")
        if secure_threshold is not None and secure_threshold < 2:
            raise ValueError(
                "secure_threshold < 2 would let the server reconstruct "
                "secrets from a single holder"
            )
        if secure_agg and secure_protocol == "double" and num_clients > 254:
            raise ValueError("double-masking Shamir x-coordinates support <= 254 clients")
        if secure_agg:
            # The client-side floor on the mask-partner set (default: the
            # whole fleet): a compromised server cannot shrink it to one
            # colluder.
            floor = num_clients if min_participants is None else int(min_participants)
            if not 2 <= floor <= num_clients:
                raise ValueError(
                    f"min_participants={min_participants} must be in "
                    f"[2, num_clients={num_clients}]"
                )
            self.min_participants = floor
        else:
            if min_participants is not None:
                raise ValueError(
                    "min_participants is a secure-aggregation knob (the "
                    "mask-partner quorum floor); it has no meaning "
                    "without secure_agg"
                )
            self.min_participants = None
        if secure_agg and self._topk_frac is not None:
            raise ValueError(
                "topk compression is incompatible with secure "
                "aggregation: masked uploads are uniform ring elements "
                "with no sparsity to exploit"
            )
        if dp and self._topk_frac is not None:
            raise ValueError(
                "central DP uploads are clipped dense deltas; the sparse "
                "topk path would bypass the clip and the base-agreement "
                "rounds — drop --dp or topk"
            )
        if wire_dtype not in wire.WIRE_DTYPE_ENCS:
            raise ValueError(f"wire_dtype {wire_dtype!r} must be {'|'.join(sorted(wire.WIRE_DTYPE_ENCS))}")
        if wire_dtype != "fp32" and compression != "none":
            raise ValueError(
                f"wire_dtype={wire_dtype} needs compression='none': the upload "
                "encoding is owned by one knob — lossy dense compression would "
                "stack two quantizers, and sparse topk deltas are single-frame "
                "(never streamed)"
            )
        self.host = host
        self.port = port
        self.client_id = client_id
        self.timeout = timeout
        self.compression = compression
        self.auth_key = auth_key
        #: False: never stream and never ask for a streamed reply (every
        #: reply then comes dense, in the server's --compression: a
        #: sparse-delta client keeps its exact base against a server with
        #: a lossy --reply-dtype).
        self.stream = bool(stream)
        self.wire_dtype = wire_dtype
        #: Central DP: uploads are clipped round deltas (the server's
        #: --dp-clip), and replies are noised mean deltas.
        self.dp = bool(dp)
        #: Secure aggregation: the fleet size, fixed-point bits, recovery
        #: protocol and Shamir threshold; the per-client identity key (own
        #: key when provisioned, else the group key) the hello, reveal,
        #: share and unmask frames ride; per (session, round) the DH
        #: keypair and dealt shares (retries reuse them), and per session
        #: the last round masked (a replayed round is refused).
        self.secure_agg = bool(secure_agg)
        self.num_clients = num_clients
        self.fp_bits = int(fp_bits)
        self.secure_protocol = secure_protocol
        self.secure_threshold = secure_threshold
        self.client_key = client_key
        self._identity_key = client_key if client_key is not None else auth_key
        self._round_keys: dict[tuple[bytes, int], tuple[bytes, int, bytes]] = {}
        self._round_shares: dict[tuple[bytes, int], dict] = {}
        self._used_rounds: dict[bytes, int] = {}
        #: The ranked parent list (primary first); a re-home advances it
        #: for good and marks every later upload.
        self._parents: list[tuple[str, int]] = [(host, int(port))] + [
            (h, int(p)) for h, p in (fallback_parents or [])
        ]
        self._parent_idx = 0
        self.rehome_dial_budget = float(rehome_dial_budget)
        self._rehomed = False
        #: Re-homes performed, by reason (the counter's labels).
        self.rehomes: dict[str, int] = {}
        # abort(): the live socket, shut down from another thread.
        self._abort = threading.Event()
        self._sock_lock = threading.Lock()
        self._live_sock: socket.socket | None = None
        #: The server's last offers (one reply behind): its chunk bytes
        #: (None = no stream offer) and the stream encodings it decodes.
        self._server_stream: int | None = None
        self._server_wire_dtypes: tuple[str, ...] = ()
        # Sparse-delta state (topk): the base both sides agree on (keyed
        # by the server's agg_round) and the error-feedback residual.
        self._base: dict | None = None
        self._base_round: int | None = None
        self._residual: dict | None = None
        self._warned_lossy_base = False
        self._gave_up_delta = False
        self._dense_rounds_since_giveup = 0
        self._probe_this_round = False
        self._fallback_logged: set[str] = set()
        # ``reply_leaf_sink``: optional ``(key, ndarray) -> leaf`` applied to
        # each plain streamed-reply leaf the moment it decodes: the mesh
        # tier's hook (train/client_mesh.py) places leaves onto the mesh's
        # slots while later chunks are still on the wire. Never applied to
        # DP or sparse replies (their deltas need host arithmetic first) or
        # to dense replies.
        self.reply_leaf_sink = None
        #: The last completed exchange: what went up (``upload_shape``
        #: dense|stream, ``wire_dtype``, ``upload_bytes`` on the wire,
        #: ``upload_s``; for a stream ``chunks`` and ``overlap_s``, the
        #: pack time hidden behind the sends), the seconds from the end of
        #: the upload to the decoded reply (the other clients' uploads, the
        #: server's fold and the reply's transfer), the reply's bytes and
        #: shape, and its meta.
        self.last_exchange: dict[str, Any] = {}
        self._m_rehomes = _rehome_counters()
        # Observability: spans are written only once the reply reveals the
        # round's (trace, round), so both sides of the wire share it.
        self.tracer = tracer
        if self.secure_agg and auth_key is None:
            log.warning(
                f"[CLIENT {client_id}] --secure-agg without an auth key "
                "(FEDTPU_SECRET): the DH key exchange has no integrity — "
                "an ACTIVE on-path attacker could substitute keys and "
                "unmask uploads; protection is against passive observers "
                "and the curious server only"
            )
        self.last_trace: tuple[str | None, int | None] = (None, None)
        self._pending_spans: list[tuple[str, float, float, dict]] = []
        # Wire-codec step profiler (--profile-stride): samples the streamed
        # pack and unpack loops; re-armed lazily per exchange.
        self._wire_profiler = None

    # -------------------------------------------------------------- round
    def exchange(
        self,
        params: Any,
        *,
        n_samples: int = 1,
        meta: Mapping[str, Any] | None = None,
        max_retries: int = 5,  # the reference's retry budget (client1.py:314)
        round_base: Any | None = None,
    ) -> dict:
        """Upload local params (a nested dict in the JAX layout, of host
        arrays or ``HostLeaf``), return the aggregate (nested dict of
        numpy arrays).

        Retries the whole round trip on connection errors and on a
        malformed reply; a :class:`~.wire.ModeError` or
        :class:`~.secure.SecureAggError` is not retried. With a topk
        compression the caller must adopt the returned aggregate as its
        model (the error feedback assumes it). Under DP ``round_base`` is
        the params this round's training started from (the adopted
        aggregate, or the shared init in round 1); the upload is
        ``clip(params - round_base)`` and the return is absolute.

        With ``secure_agg`` the upload is the pairwise-masked fixed-point
        form of the params (of the clipped delta under DP), masked over
        the key set the server relays; one DH keypair per (session,
        round), reused by the retries of this exchange. With fallback
        parents a dead parent (its dial budget spent, or its connection
        lost mid-exchange) moves this client to the next one for good."""
        base_meta = {"client_id": self.client_id, "n_samples": int(n_samples), **dict(meta or {})}
        if self._rehomed:
            # Sticky: the adoptive parent folds this client as an extra
            # contributor every round.
            base_meta[wire.META_REHOMED] = 1
        if self.stream and not self.secure_agg:
            base_meta[wire.META_STREAM_REPLY] = 1
            base_meta[wire.META_REPLY_DTYPES] = sorted(set(wire.WIRE_DTYPE_ENCS.values()))
        flat = wire.flatten_lazy(params)
        dp_base = dp_delta = None
        if self.dp:
            if round_base is None:
                raise ValueError("central DP needs round_base: the params this round's training started from")
            dp_base = {k: np.asarray(v, np.float32) for k, v in wire.flatten_params(round_base).items()}
            flat = wire.flatten_params(params)
            if not wire.shapes_compatible(flat, dp_base):
                raise ValueError("round_base tensor set/shapes do not match params")
            dp_delta = {k: np.asarray(flat[k], np.float32) - dp_base[k] for k in flat}
            base_meta["dp"] = True
            base_meta["dp_base_crc"] = wire.flat_crc32(dp_base)
        elif self.secure_agg:
            # The masks need every leaf on the host, once.
            flat = {k: np.asarray(v) for k, v in flat.items()}
        msg = None  # a dense frame, encoded once unless auth, topk, DP or masks re-encode it
        last: Exception | None = None
        #: The (session, round) this exchange masked for: its retries may
        #: re-mask the same params under it, nothing else may.
        sec: dict = {"this_call": None}
        fresh_parent = False  # just re-homed: the next dial is this parent's first
        for attempt in range(1, max_retries + 1):
            sock = None
            sparse_in_flight = False
            upload_started = None  # (unix start, monotonic start, bytes) once the send began
            try:
                if self._abort.is_set():
                    raise ConnectionError(f"client {self.client_id}: exchange aborted")
                # With fallback parents each dial gets the re-home budget:
                # a dead parent costs seconds, not the exchange timeout.
                sock = connect_with_retry(
                    self.host, self.port,
                    timeout=min(self.timeout, self.rehome_dial_budget) if len(self._parents) > 1 else self.timeout,
                    retry_seed=self.client_id, abort_event=self._abort,
                )
                sock.settimeout(self.timeout)
                with self._sock_lock:
                    self._live_sock = sock
                if self._abort.is_set():
                    # abort() landed between the dial and the registration.
                    raise ConnectionError(f"client {self.client_id}: exchange aborted")
                first_contact, fresh_parent = fresh_parent, False
                nonce_hex = None
                attempt_meta = dict(base_meta)
                if self.auth_key is not None:
                    chal = framing.recv_frame(sock)
                    if len(chal) != len(wire.NONCE_MAGIC) + wire.NONCE_LEN or not chal.startswith(wire.NONCE_MAGIC):
                        raise wire.WireError("bad auth challenge from server")
                    nonce_hex = bytes(chal[len(wire.NONCE_MAGIC) :]).hex()
                    attempt_meta.update(role="client", nonce=nonce_hex)
                if not self.secure_agg and not self.dp and attempt > 1 and not first_contact:
                    # A re-homed attempt is the adoptive parent's first
                    # contact: no peek for a failure that happened elsewhere.
                    self._diagnose_mode(sock)
                upload, delta_flat, sent_flat = flat, None, None
                sitting_out = False
                to_mask = flat
                if self.dp:
                    clipped = self._dp_handshake(sock, nonce_hex, dp_delta)
                    sitting_out = clipped is None
                    upload = to_mask = clipped
                sec_round = None
                if self.secure_agg and not sitting_out:
                    upload, sec_round = self._secure_upload(sock, to_mask, attempt_meta, sec)
                if self._topk_frac is not None:
                    upload, delta_flat, sent_flat = self._prepare_topk_upload(flat, attempt, attempt_meta)
                # Streamed on the first attempt only: a retry may be
                # recovering from a server that stopped streaming. Never
                # under DP (the clipped delta goes in one frame) nor
                # secure aggregation (masked uploads are single-frame).
                use_stream = (
                    self.stream and not self.dp and not self.secure_agg and self._topk_frac is None
                    and self._server_stream is not None and attempt == 1
                )
                t_up_unix = time.time()
                t0 = time.monotonic()
                wire_attrs: dict = {}
                if sitting_out:
                    up = {"upload_shape": "none", "wire_dtype": "fp32", "upload_bytes": 0}
                elif use_stream:
                    enc = wire.WIRE_DTYPE_ENCS[self.wire_dtype]
                    stream_comp, used_dtype = self.compression, "fp32"
                    if self.wire_dtype != "fp32" and enc in self._server_wire_dtypes:
                        stream_comp, used_dtype = enc, self.wire_dtype
                        attempt_meta["wire_dtype"] = self.wire_dtype
                    upload_started = (t_up_unix, t0, 0)
                    sent, chunks, overlap_s, wire_attrs = self._stream_upload(
                        sock, upload, attempt_meta, stream_comp, nonce_hex
                    )
                    up = {"upload_shape": "stream", "wire_dtype": used_dtype, "upload_bytes": sent,
                          "chunks": chunks, "overlap_s": overlap_s}
                else:
                    self._log_dense_fallback(attempt)
                    if (
                        msg is None or self.auth_key is not None or self._topk_frac is not None
                        or self.dp or self.secure_agg
                    ):
                        # A topk client's frame is raw (dense rounds) or
                        # carries its pre-encoded top-k leaves.
                        comp = "none" if self._topk_frac is not None else self.compression
                        msg = wire.encode(upload, meta=attempt_meta, compression=comp, auth_key=self.auth_key)
                    log.info(
                        f"[CLIENT {self.client_id}] uploading {len(msg) / 1e6:.1f} MB "
                        f"(attempt {attempt}/{max_retries})"
                    )
                    sparse_in_flight = delta_flat is not None
                    upload_started = (t_up_unix, t0, len(msg))
                    framing.send_frame(sock, msg)
                    up = {"upload_shape": "dense", "wire_dtype": "fp32", "upload_bytes": len(msg)}
                t1 = time.monotonic()
                t_rep_unix = time.time()
                reply = framing.recv_frame(sock)
                if sec_round is not None:
                    reply = self._secure_sub_round(sock, reply, sec_round)
                reply_attrs: dict = {}
                if bytes(reply[:4]) == wire.STREAM_MAGIC:
                    agg_flat, agg_meta, reply_bytes, reply_attrs = self._recv_stream_reply(sock, reply, nonce_hex)
                    agg = wire.unflatten_params(agg_flat)
                    reply_shape = "stream"
                else:
                    agg, agg_meta = wire.decode(reply, auth_key=self.auth_key)
                    reply_bytes, reply_shape = len(reply), "dense"
                if self.auth_key is not None and (
                    agg_meta.get("role") != "server" or agg_meta.get("nonce") != nonce_hex
                ):
                    raise wire.WireError(
                        "aggregated reply failed the freshness check (stale "
                        "nonce or wrong role) — possible replay"
                    )
                self._adopt_offers(agg_meta)
                t2 = time.monotonic()
                self.last_exchange = {
                    **up, "upload_s": t1 - t0, "reply_wait_s": t2 - t1,
                    "reply_bytes": reply_bytes, "reply_shape": reply_shape, "meta": agg_meta,
                }
                if sec_round is not None:
                    self.last_exchange["secure_s"] = dict(sec_round["seconds"])
                upload_span = None
                if not sitting_out:
                    upload_attrs = (
                        {"chunks": up["chunks"], "overlap_s": round(up["overlap_s"], 6),
                         "wire_dtype": up["wire_dtype"], **wire_attrs}
                        if up["upload_shape"] == "stream" else None
                    )
                    upload_span = (t_up_unix, t1 - t0, up["upload_bytes"], upload_attrs)
                self._flush_spans(agg_meta, upload_span, (t_rep_unix, t2 - t1, reply_bytes, reply_attrs or None))
                if sec["this_call"] is not None:
                    # Round complete: this round's (and older) keypairs and
                    # shares must not linger.
                    done_session, done_round = sec["this_call"]
                    for store in (self._round_keys, self._round_shares):
                        for k in [k for k in store if k[0] == done_session and k[1] <= done_round]:
                            del store[k]
                log.info(
                    f"[CLIENT {self.client_id}] received the aggregate "
                    f"({reply_bytes / 1e6:.1f} MB {reply_shape}, clients {agg_meta.get('round_clients')})"
                )
                if self.dp:
                    return self._apply_dp_reply(agg, agg_meta, dp_base, base_meta["dp_base_crc"])
                if self._topk_frac is not None:
                    self._finish_topk(agg, agg_meta, delta_flat, sent_flat)
                return agg
            except (OSError, wire.WireError) as e:
                last = e
                if sparse_in_flight:
                    # The sparse upload may have reached the server before
                    # the failure: its delta embedded the residual, which a
                    # retry must not deliver twice.
                    self._residual = None
                log.info(f"[CLIENT {self.client_id}] round attempt {attempt} failed: {e}")
                if self._abort.is_set():
                    # Teardown: the remaining retries would hold the caller.
                    break
                failed_upload = None
                if upload_started is not None:
                    failed_upload = (upload_started[0], time.monotonic() - upload_started[1], upload_started[2])
                if attempt < max_retries and self._rehome(
                    "dial-exhausted" if sock is None else "mid-exchange", err=e, failed_upload=failed_upload
                ):
                    # The next attempt dials the adoptive parent now: the
                    # backoff is for a server that may come back.
                    base_meta[wire.META_REHOMED] = 1
                    msg = None  # re-encode: the meta gains the marker
                    fresh_parent = True
                    continue
                if attempt < max_retries:
                    time.sleep(min(2.0**attempt, 10.0))
            finally:
                with self._sock_lock:
                    self._live_sock = None
                if sock is not None:
                    sock.close()
        raise ConnectionError(
            f"client {self.client_id}: round failed after {max_retries} attempts: {last}"
        )

    # ------------------------------------------------ re-homing and abort
    def _rehome(self, reason: str, *, err: Exception | None = None, failed_upload=None) -> bool:
        """Move to the next parent of the ranked list; False when none is
        left (the caller then retries the last one). The move is sticky.
        Offers and the sparse base learned from the dead parent do not
        carry over. A failed attempt whose upload reached the wire is kept
        as a ``wire-upload`` span with ``rehome_failed=1``, written with
        the adoptive round's spans."""
        if self._parent_idx + 1 >= len(self._parents):
            return False
        self._parent_idx += 1
        self.host, self.port = self._parents[self._parent_idx]
        self._rehomed = True
        self._server_stream = None
        self._server_wire_dtypes = ()
        self._base = self._base_round = None
        self.rehomes[reason] = self.rehomes.get(reason, 0) + 1
        self._m_rehomes[reason].inc()
        if failed_upload is not None:
            self.note_phase(
                "wire-upload", failed_upload[0], failed_upload[1],
                client=self.client_id, bytes=failed_upload[2], rehome_failed=1,
            )
        log.warning(
            f"[CLIENT {self.client_id}] re-homing ({reason}"
            + (f": {err}" if err is not None else "")
            + f") -> fallback parent {self.host}:{self.port} "
            f"({self._parent_idx}/{len(self._parents) - 1})"
        )
        return True

    def abort(self) -> None:
        """Tear an in-flight exchange down now (a closing relay): stop the
        dial backoff and shut the live socket, so a blocked recv fails
        instead of waiting out its timeout. A later exchange raises."""
        self._abort.set()
        with self._sock_lock:
            s = self._live_sock
        if s is not None:
            # shutdown first: close() alone waits while another thread is
            # blocked on the descriptor.
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    # ------------------------------------------------- secure aggregation
    def _secure_upload(self, sock: socket.socket, flat: dict, attempt_meta: dict, sec: dict) -> tuple[dict, dict]:
        """The secure handshake of one attempt: read the round advert
        (refusing another protocol and a replayed round), send the DH
        hello, take the key set, deal and collect shares under double
        masking, and mask ``flat`` over the round's mask set. Returns the
        masked upload and the round's state for the unmask sub-round."""
        secs: dict[str, float] = {}
        t0 = time.monotonic()
        # A secure server adverts at once; silence means it is not one.
        sock.settimeout(min(self.timeout, 30.0))
        try:
            adv = bytes(framing.recv_frame(sock))
        except socket.timeout:
            raise secure.SecureAggError("server sent no round advert — is it running with --secure-agg?") from None
        finally:
            sock.settimeout(self.timeout)
        n_magic = len(wire.ROUND_MAGIC)
        if len(adv) != n_magic + 8 + wire.SESSION_LEN + 1 or not adv.startswith(wire.ROUND_MAGIC):
            raise wire.WireError("bad round advert from server")
        round_no = struct.unpack("<Q", adv[n_magic : n_magic + 8])[0]
        if round_no >= 2**63:
            raise wire.WireError(f"round advert {round_no} out of range")
        session = adv[n_magic + 8 : n_magic + 8 + wire.SESSION_LEN]
        # A pin, not a negotiation: an advert cannot downgrade double
        # masking to the reveal round.
        want_proto = secure.PROTO_DOUBLE if self.secure_protocol == "double" else secure.PROTO_REVEAL
        if adv[-1] != want_proto:
            raise secure.SecureAggError(
                f"server advertises secure protocol "
                f"{'double' if adv[-1] else 'reveal'}, this "
                f"client is configured for "
                f"{self.secure_protocol} — refusing (set "
                "--secure-protocol identically on both ends)"
            )
        # Retries of this exchange may re-mask the same params for the
        # same (session, round); an earlier round replayed would mask
        # other params under the same stream (the differencing attack).
        prev = self._used_rounds.get(session, -1)
        if round_no <= prev and (session, round_no) != sec["this_call"]:
            raise secure.SecureAggError(
                f"server replayed round {round_no} (already "
                f"masked up to round {prev} this session) — "
                "refusing to reuse a mask stream"
            )
        sec["this_call"] = (session, round_no)
        if (session, round_no) not in self._round_keys:
            # A seed-derived keypair: double masking Shamir-shares the seed.
            sk_seed = os.urandom(secure.SEED_LEN)
            self._round_keys[(session, round_no)] = (sk_seed, *secure.dh_keypair(entropy=sk_seed))
        sk_seed, priv, pub = self._round_keys[(session, round_no)]
        hello = wire.PUBKEY_MAGIC + struct.pack("<q", self.client_id) + pub
        if self.auth_key is not None:
            hello += secure.pubkey_tag(self._identity_key, session, round_no, self.client_id, pub)
        framing.send_frame(sock, hello)
        participants, pair_secrets = self._parse_keys_frame(bytes(framing.recv_frame(sock)), priv, session, round_no)
        secs["keys"] = time.monotonic() - t0
        share_st = None
        mask_set = participants
        if self.secure_protocol == "double":
            t1 = time.monotonic()
            share_st = self._double_share_exchange(sock, participants, pair_secrets, sk_seed, session, round_no)
            mask_set = share_st["u2"]
            secs["shares"] = time.monotonic() - t1
        t1 = time.monotonic()
        upload = secure.masked_upload(
            flat, pair_secrets=pair_secrets, round_index=round_no, client_id=self.client_id,
            participants=mask_set, fp_bits=self.fp_bits, session=session,
        )
        if share_st is not None:
            # The self-mask stays on until the unmask round rebuilds b from
            # other holders' shares.
            secure.apply_self_stream(upload, share_st["b_seed"], session, round_no, self.client_id, add=True)
        secs["mask"] = time.monotonic() - t1
        self._used_rounds[session] = max(prev, round_no)
        attempt_meta.update(secure=True, fp_bits=self.fp_bits, round=round_no, participants=len(mask_set))
        return upload, {
            "session": session, "round": round_no, "share_st": share_st,
            "pair_secrets": pair_secrets, "seconds": secs,
        }

    def _secure_sub_round(self, sock: socket.socket, reply, st: dict):
        """Answer the round's unmask request (double masking) or reveal
        request (the reveal protocol, after a dropout) and return the
        frame after it; any other frame is the reply itself."""
        magic = bytes(reply[:4])
        session, round_no = st["session"], st["round"]
        t0 = time.monotonic()
        if st["share_st"] is not None and magic == wire.UNMASK_MAGIC:
            reply = self._answer_unmask(sock, bytes(reply), st["share_st"], session, round_no)
            st["seconds"]["unmask"] = time.monotonic() - t0
        elif self.secure_protocol == "reveal" and magic == wire.REVEAL_MAGIC:
            # A revealed secret unlocks only this round's streams of pairs
            # whose other end contributed nothing.
            dead = secure.parse_reveal_request(
                bytes(reply), session=session, round_index=round_no, auth_key=self._identity_key
            )
            bad = [d for d in dead if d == self.client_id or d not in st["pair_secrets"]]
            if bad:
                raise secure.SecureAggError(f"reveal request names invalid partners {bad}")
            framing.send_frame(
                sock,
                secure.build_reveal_response(
                    {d: st["pair_secrets"][d] for d in dead}, session=session, round_index=round_no,
                    client_id=self.client_id, auth_key=self._identity_key,
                ),
            )
            reply = framing.recv_frame(sock)
            st["seconds"]["reveal"] = time.monotonic() - t0
        return reply

    def _parse_keys_frame(
        self, frame: bytes, priv: int, session: bytes, round_no: int
    ) -> tuple[list[int], dict[int, bytes]]:
        """The keys frame -> (sorted participant ids, {partner: DH pair
        secret}), each public value checked and, under auth, its tag. The
        set may be a quorum subset of the fleet; it must hold this client
        and at least ``min_participants`` members (the floor that stops a
        compromised server shrinking the mask partners to a colluder: a
        SecureAggError, not retried)."""
        entry = 8 + secure.DH_PUB_LEN + (wire.AUTH_TAG_LEN if self.auth_key is not None else 0)
        n_magic = len(wire.KEYS_MAGIC)
        if not frame.startswith(wire.KEYS_MAGIC) or (len(frame) - n_magic) % entry != 0:
            raise wire.WireError("bad DH keys frame from server")
        seen: dict[int, bytes] = {}
        for off in range(n_magic, len(frame), entry):
            cid = struct.unpack("<q", frame[off : off + 8])[0]
            if cid in seen:
                raise wire.WireError(f"duplicate client {cid} in keys frame")
            pub = frame[off + 8 : off + 8 + secure.DH_PUB_LEN]
            if self.auth_key is not None:
                secure.verify_pubkey_tag(
                    self.auth_key, session, round_no, cid, pub, frame[off + 8 + secure.DH_PUB_LEN : off + entry]
                )
            seen[cid] = pub
        participants = sorted(seen)
        if not all(0 <= c < self.num_clients for c in participants):
            raise wire.WireError(
                f"DH keys frame covers unknown clients {participants} (fleet is 0..{self.num_clients - 1})"
            )
        if self.client_id not in seen or len(seen) < 2:
            raise wire.WireError(
                f"DH keys frame covers {participants}: it must include "
                f"this client ({self.client_id}) and at least one partner"
            )
        if len(seen) < self.min_participants:
            raise secure.SecureAggError(
                f"DH keys frame covers only {len(seen)} participants "
                f"{participants}; this client's floor is "
                f"min_participants={self.min_participants} — refusing the "
                "downgraded set (pass min_participants to opt into "
                "dropout-recovery quorums)"
            )
        return participants, {
            cid: secure.dh_pair_secret(priv, pub) for cid, pub in seen.items() if cid != self.client_id
        }

    def _double_share_exchange(
        self, sock, participants: list[int], pair_secrets: dict[int, bytes], sk_seed: bytes,
        session: bytes, round_no: int,
    ) -> dict:
        """Deal Shamir shares of this client's self-mask seed and DH key
        seed to the keyed participants (each blob encrypted under the pair
        secret), send them through the server, and adopt the relayed
        share-complete set U2. The state is cached per (session, round):
        retries resend the same shares, and a retry that relays another
        U2 or other shares is refused (the U2 pin)."""
        t = self.secure_threshold if self.secure_threshold is not None else secure.majority_threshold(len(participants))
        if not 2 <= t <= len(participants):
            raise secure.SecureAggError(f"Shamir threshold {t} infeasible for {len(participants)} participants")
        key = (session, round_no)
        st = self._round_shares.get(key)
        if st is not None and (st["participants"] != list(participants) or st["t"] != t):
            raise secure.SecureAggError("keyed participant set changed across retries of one round")
        if st is None:
            b_seed = os.urandom(secure.SEED_LEN)
            xs = [secure.share_x(p) for p in participants]
            shares_b = shamir.split(b_seed, xs, t)
            shares_sk = shamir.split(sk_seed, xs, t)
            st = {
                "participants": list(participants),
                "t": t,
                "b_seed": b_seed,
                "own_b_share": shares_b[secure.share_x(self.client_id)],
                "commit": secure.b_seed_commitment(b_seed, session, round_no, self.client_id),
                "blobs": {
                    p: secure.encrypt_share_blob(
                        pair_secrets[p], session, round_no, self.client_id, p,
                        shares_b[secure.share_x(p)], shares_sk[secure.share_x(p)],
                    )
                    for p in participants
                    if p != self.client_id
                },
            }
            self._round_shares[key] = st
        wire_key = self._identity_key if self.auth_key is not None else None
        framing.send_frame(
            sock,
            secure.build_shares_frame(
                self.client_id, st["commit"], st["blobs"], threshold=t, session=session,
                round_index=round_no, auth_key=wire_key,
            ),
        )
        u2, entries = secure.parse_shareset_frame(
            bytes(framing.recv_frame(sock)), session=session, round_index=round_no, auth_key=wire_key
        )
        u2_sorted = sorted(u2)
        u2set = set(u2_sorted)
        if self.client_id not in u2set:
            raise secure.SecureAggError(f"share-complete set {u2_sorted} excludes this client")
        if not u2set <= set(participants):
            raise wire.WireError(
                f"shareset U2 {u2_sorted} is not a subset of the keyed participants {sorted(participants)}"
            )
        if len(u2_sorted) < self.min_participants:
            raise secure.SecureAggError(
                f"share-complete set covers only {len(u2_sorted)} "
                f"participants {u2_sorted}; this client's floor is "
                f"min_participants={self.min_participants} — refusing the "
                "downgraded set"
            )
        if len(u2_sorted) < t:
            raise secure.SecureAggError(
                f"share-complete set {u2_sorted} is smaller than the "
                f"Shamir threshold {t} — the round could never unmask"
            )
        if set(entries) != u2set - {self.client_id}:
            raise wire.WireError(
                f"shareset entries cover dealers {sorted(entries)}, expected {sorted(u2set - {self.client_id})}"
            )
        holder_shares = {
            dealer: secure.decrypt_share_blob(pair_secrets[dealer], session, round_no, dealer, self.client_id, blob)
            for dealer, blob in entries.items()
        }
        # The U2 pin: a retried connection relaying another set, or other
        # shares, would steer this client between mask partitions.
        if "u2" in st:
            if st["u2"] != u2_sorted:
                raise secure.SecureAggError(
                    "share-complete set changed across retries of one "
                    f"round (pinned {st['u2']}, relayed {u2_sorted}) — "
                    "refusing the substituted shareset"
                )
            if st["holder_shares"] != holder_shares:
                changed = sorted(d for d in holder_shares if st["holder_shares"].get(d) != holder_shares[d])
                raise secure.SecureAggError(
                    f"dealers {changed} re-dealt different shares on a "
                    "retry of one round (U2 unchanged) — refusing the "
                    "substituted shareset"
                )
        st["u2"] = u2_sorted
        st["holder_shares"] = holder_shares
        return st

    def _answer_unmask(self, sock, request: bytes, share_st: dict, session: bytes, round_no: int) -> bytes:
        """Check an unmask request against this round's U2, answer with
        the either/or shares (b-shares of the alive, key-seed shares of
        the dead, never both for one id), return the next frame. The
        first answered partition is pinned: a retry that asks another is
        the answer-then-drop share harvest, refused."""
        alive, dead = secure.parse_unmask_request(
            request, session=session, round_index=round_no, auth_key=self._identity_key
        )
        u2set = set(share_st["u2"])
        if self.client_id not in alive:
            raise secure.SecureAggError(
                "unmask request claims this client did not contribute — "
                "refusing (it would expose our self-mask while the server "
                "holds our upload)"
            )
        if set(alive) | set(dead) != u2set:
            raise secure.SecureAggError(
                f"unmask request partition alive={sorted(alive)} / "
                f"dead={sorted(dead)} does not cover this round's "
                f"participant set {sorted(u2set)} exactly"
            )
        partition = (tuple(sorted(alive)), tuple(sorted(dead)))
        pinned = share_st.get("unmask_partition")
        if pinned is not None and pinned != partition:
            raise secure.SecureAggError(
                "unmask request partition changed across retries of one "
                f"round (answered alive={list(pinned[0])}/"
                f"dead={list(pinned[1])}, now asked alive={sorted(alive)}/"
                f"dead={sorted(dead)}) — refusing the replayed unmask "
                "(answer-then-drop share harvest)"
            )
        share_st["unmask_partition"] = partition
        holder = share_st["holder_shares"]
        b_shares = {d: share_st["own_b_share"] if d == self.client_id else holder[d][0] for d in alive}
        sk_shares = {d: holder[d][1] for d in dead}
        framing.send_frame(
            sock,
            secure.build_unmask_response(
                b_shares, sk_shares, session=session, round_index=round_no,
                client_id=self.client_id, auth_key=self._identity_key,
            ),
        )
        return framing.recv_frame(sock)

    # ---------------------------------------------------------- central DP
    def _diagnose_mode(self, sock: socket.socket) -> None:
        """After a failed attempt a plain client peeks at the server's
        first frame: a DP or auth server speaks first, and a plain upload
        there dies as a malformed hello on every retry. A stray frame
        becomes a non-retryable :class:`~.wire.ModeError` naming the fix."""
        sock.settimeout(min(self.timeout, 2.0))
        try:
            stray = framing.recv_frame(sock)
        except OSError:  # ConnectionError and socket.timeout included
            stray = None
        finally:
            sock.settimeout(self.timeout)
        if stray is None:
            return
        magic = bytes(stray[:4])
        if magic == wire.ROUND_MAGIC:
            raise secure.SecureAggError(
                "server is running --secure-agg; run this client with --secure-agg"
                + (
                    " (and drop topk: sparse deltas cannot be masked — masked "
                    "uploads are uniform ring elements with no sparsity)"
                    if self._topk_frac is not None
                    else ""
                )
            )
        if magic == wire.DP_MAGIC:
            raise wire.ModeError("server is running --dp-clip; run this client with --dp")
        if magic == wire.NONCE_MAGIC:
            raise wire.ModeError("server requires authentication; set FEDTPU_SECRET for this client")
        raise wire.ModeError(f"server opened with an unexpected frame ({magic!r}) — client/server mode mismatch")

    def _dp_handshake(self, sock: socket.socket, nonce_hex: str | None, dp_delta: dict) -> dict | None:
        """Read the DP advert, name this client, read the cohort verdict.
        Returns the delta clipped to the advertised bound, or None when
        this client sits the round out (under auth after proving key
        knowledge). A server that sends no advert raises ModeError."""
        sock.settimeout(min(self.timeout, 30.0))
        try:
            adv = framing.recv_frame(sock)
        except socket.timeout:
            # Not retried: every attempt would stall the same way.
            raise wire.ModeError("server sent no DP advert — is it running with --dp-clip?") from None
        finally:
            sock.settimeout(self.timeout)
        n_magic = len(wire.DP_MAGIC)
        if len(adv) != n_magic + 24 or not bytes(adv).startswith(wire.DP_MAGIC):
            raise wire.ModeError("bad DP advert from server")
        dp_clip, dp_noise, dp_q = struct.unpack("<ddd", bytes(adv[n_magic:]))
        if not dp_clip > 0.0:
            raise wire.WireError(f"DP advert carries clip={dp_clip}")
        if not 0.0 < dp_q <= 1.0:
            raise wire.WireError(f"DP advert carries sampling rate q={dp_q}")
        framing.send_frame(sock, wire.DPID_MAGIC + struct.pack("<q", self.client_id))
        verdict = framing.recv_frame(sock)
        if len(verdict) != len(wire.DPCOHORT_MAGIC) + 1 or not bytes(verdict).startswith(wire.DPCOHORT_MAGIC):
            raise wire.WireError("bad DP cohort verdict")
        if verdict[-1] == 0:
            if dp_q >= 1.0:
                raise wire.WireError("server claims this client is not sampled under full participation (q=1)")
            if self.auth_key is not None:
                framing.send_frame(
                    sock,
                    wire.DPSKIP_MAGIC + hmac.new(
                        self.auth_key,
                        wire.DPSKIP_DOMAIN + bytes.fromhex(nonce_hex) + struct.pack("<q", self.client_id),
                        "sha256",
                    ).digest(),
                )
            log.info(
                f"[CLIENT {self.client_id}] sitting out this round (Poisson cohort "
                f"sampling q={dp_q}); waiting for the round reply"
            )
            return None
        clipped, norm, scale = wire.clip_flat(dp_delta, dp_clip)
        log.info(
            f"[CLIENT {self.client_id}] DP round: update norm {norm:.4g}, clip {dp_clip} "
            f"(scale {scale:.3g}), noise x{dp_noise}"
        )
        return clipped

    def _apply_dp_reply(self, agg: dict, agg_meta: Mapping[str, Any], dp_base: dict, base_crc: int) -> dict:
        """The absolute aggregate from a DP reply: ``noop`` keeps the base,
        ``resync`` replays the retained round deltas onto it in order (the
        fleet's own fp32 additions, so the base lands bit for bit), and
        ``delta`` is added to the base, unless it targets another base
        (this client is stale): then the base is kept and the next
        contributing round resyncs it."""
        kind = agg_meta.get("dp_reply")
        if kind == "noop":
            log.info(f"[CLIENT {self.client_id}] no-op round (empty sampled cohort); keeping the round base")
            return wire.unflatten_params(dp_base)
        if kind == "resync":
            try:
                n_rounds = int(agg_meta["dp_resync_rounds"])
            except (KeyError, TypeError, ValueError):
                raise wire.WireError("resync reply missing dp_resync_rounds") from None
            cur = dp_base
            for i in range(n_rounds):
                if str(i) not in agg:
                    raise wire.WireError(f"resync reply missing round delta {i}")
                step = wire.flatten_params(agg[str(i)])
                if not wire.shapes_compatible(step, cur):
                    raise wire.WireError(f"resync delta {i} shapes do not match the base")
                cur = {k: cur[k] + np.asarray(step[k], np.float32) for k in cur}
            log.info(f"[CLIENT {self.client_id}] stale round base resynced: replayed {n_rounds} retained round delta(s)")
            return wire.unflatten_params(cur)
        if kind != "delta":
            raise wire.WireError("DP reply missing dp_reply=delta marker")
        reply_crc = agg_meta.get("dp_base_crc")
        if reply_crc is not None and int(reply_crc) != int(base_crc):
            log.info(
                f"[CLIENT {self.client_id}] round delta targets a different base than ours "
                "(stale base); keeping the base — the next contributing round resyncs it"
            )
            return wire.unflatten_params(dp_base)
        agg_flat = wire.flatten_params(agg)
        if not wire.shapes_compatible(agg_flat, dp_base):
            raise wire.WireError("DP reply delta shapes do not match the base")
        return wire.unflatten_params({k: dp_base[k] + np.asarray(agg_flat[k], np.float32) for k in agg_flat})

    def _adopt_offers(self, agg_meta: Mapping[str, Any]) -> None:
        """The reply's stream and wire-dtype offers, for the NEXT upload;
        a reply without them drops this client back to dense fp32, and
        only encodings this client knows survive."""
        try:
            adv = int(agg_meta.get(wire.META_STREAM, 0))
        except (TypeError, ValueError):
            adv = 0
        self._server_stream = (
            adv if 0 < adv <= framing.MAX_FRAME - wire.STREAM_CHUNK_OVERHEAD else None
        )
        encs = agg_meta.get(wire.META_WIRE_DTYPES)
        self._server_wire_dtypes = tuple(
            str(e) for e in (encs if isinstance(encs, (list, tuple)) else ())
            if str(e) in wire.WIRE_DTYPE_ENCS.values()
        )

    # ------------------------------------------------------ observability
    def note_local_phase(self, t_start: float, dur_s: float, **attrs) -> None:
        """Buffer a ``client-local`` span measured by the caller (the round
        loop times local training before the exchange); it is written on
        the next successful exchange, once the reply names the round."""
        self.note_phase("client-local", t_start, dur_s, **attrs)

    def note_phase(self, name: str, t_start: float, dur_s: float, **attrs) -> None:
        """Buffer a caller-measured span (``client-local``,
        ``batch-prefetch``, ...) for the next successful exchange, which
        stamps it with the round's (trace, round) identity."""
        self._pending_spans.append((str(name), float(t_start), float(dur_s), dict(attrs)))

    def _flush_spans(self, agg_meta: Mapping[str, Any], upload, reply) -> None:
        """Adopt the reply's (trace, round) identity and write this round's
        spans: the buffered phases first (they happened first), then
        ``wire-upload`` and ``wire-reply``. ``upload``/``reply``: ``(unix
        start, seconds, bytes, extra attrs or None)``."""
        trace = agg_meta.get("trace")
        rnd = agg_meta.get("agg_round")
        try:
            rnd = int(rnd) if rnd is not None else None
        except (TypeError, ValueError):
            rnd = None
        self.last_trace = (trace if isinstance(trace, str) else None, rnd)
        trace = self.last_trace[0]
        if self.tracer is None:
            self._pending_spans.clear()
            return
        for name, t_start, dur_s, attrs in self._pending_spans:
            self.tracer.record(name, t_start=t_start, dur_s=dur_s, trace=trace, round=rnd, **attrs)
        self._pending_spans.clear()
        for span, timing in (("wire-upload", upload), ("wire-reply", reply)):
            if timing is not None:
                self.tracer.record(
                    span, t_start=timing[0], dur_s=timing[1], trace=trace, round=rnd,
                    bytes=timing[2], **(timing[3] or {}),
                )

    def _armed_wire_profiler(self):
        """The wire-codec StepProfiler with a fresh window, or None when
        profiling is off (re-checked per call: the CLI installs the
        stride after construction)."""
        from ..obs.profile import maybe_step_profiler

        prof = self._wire_profiler
        if prof is None:
            prof = self._wire_profiler = maybe_step_profiler("wire")
        if prof is not None:
            prof.begin_window()
        return prof

    # ------------------------------------------------------------ streams
    def _stream_upload(
        self, sock: socket.socket, flat: dict, meta: dict, compression: str, nonce_hex: str | None
    ) -> tuple[int, int, float, dict]:
        """Ship one upload as header + chunk frames + trailer. Leaves are
        gathered and encoded one at a time on THIS thread while a wire
        thread sends the chunks already packed. Returns ``(bytes sent,
        chunk count, overlap seconds, wire attrs)``, the overlap being the
        pack and send time hidden by running the two at once and the wire
        attrs the sampled per-leaf pack timings (``step_wire_ms_*``, {}
        when profiling is off)."""
        tensors, payload_nbytes = wire.plan_stream(flat, compression)
        chunk_bytes = int(self._server_stream or wire.DEFAULT_STREAM_CHUNK)
        nonce = bytes.fromhex(nonce_hex) if nonce_hex else b""
        header = wire.encode_stream_header(
            tensors, meta=meta, chunk_bytes=chunk_bytes, payload_nbytes=payload_nbytes,
            auth_key=self.auth_key, direction="up",
        )
        log.info(
            f"[CLIENT {self.client_id}] streaming {payload_nbytes / 1e6:.1f} MB upload in "
            f"{-(-payload_nbytes // chunk_bytes)} chunk(s) of <= {chunk_bytes / 1e6:.1f} MB"
        )
        t0 = time.monotonic()
        # ACKed header: a peer that stopped speaking the stream protocol
        # fails here, before any model bytes move.
        framing.send_frame(sock, header)
        sender = framing.PipelinedSender(sock)
        pack_s = 0.0
        seq = 0
        sent = len(header)
        buf = bytearray()
        wire_prof = self._armed_wire_profiler()
        try:
            for t in tensors:
                sampled = wire_prof.tick() if wire_prof is not None else False
                tp0 = time.monotonic()
                buf += wire.encode_stream_leaf(flat[t["key"]], t["enc"])
                leaf_dt = time.monotonic() - tp0
                pack_s += leaf_dt
                if sampled:
                    # One pack "step": one leaf's gather off the card and encode.
                    wire_prof.note("wire", leaf_dt)
                while len(buf) >= chunk_bytes:
                    frame = wire.encode_stream_chunk(
                        seq, bytes(buf[:chunk_bytes]), auth_key=self.auth_key, nonce=nonce, direction="up"
                    )
                    del buf[:chunk_bytes]
                    sender.send(frame)
                    sent += len(frame)
                    seq += 1
            if buf:
                frame = wire.encode_stream_chunk(seq, bytes(buf), auth_key=self.auth_key, nonce=nonce, direction="up")
                sender.send(frame)
                sent += len(frame)
                seq += 1
            # ACKed trailer: the upload-complete handshake.
            trailer = wire.encode_stream_end(seq, auth_key=self.auth_key, nonce=nonce, direction="up")
            sender.send(trailer, await_ack=True)
            sent += len(trailer)
            send_s = sender.close()
        except BaseException:
            try:
                sender.close()
            except (OSError, wire.WireError):
                pass
            raise
        wall = max(time.monotonic() - t0, 1e-9)
        return sent, seq, max(0.0, pack_s + send_s - wall), wire_prof.span_attrs() if wire_prof is not None else {}

    def _log_dense_fallback(self, attempt: int) -> None:
        """One line naming why this upload goes dense while streaming
        exists, once per reason."""
        if not self.stream:
            reason = "--no-stream-upload"
        elif self.dp:
            reason = "central DP (the clipped delta goes in one frame)"
        elif self.secure_agg:
            reason = "secure-agg (masked uploads are single-frame by design)"
        elif self._topk_frac is not None:
            reason = "topk (payload size is data-dependent; nothing to plan)"
        elif self._server_stream is None:
            reason = "no stream offer seen yet (old peer, or round 1)"
        else:
            reason = f"retry attempt {attempt} (dense is always correct after a failed streamed attempt)"
        if reason not in self._fallback_logged:
            self._fallback_logged.add(reason)
            log.info(f"[CLIENT {self.client_id}] upload falls back to a dense single frame: {reason}")

    def _recv_stream_reply(
        self, sock: socket.socket, header, nonce_hex: str | None
    ) -> tuple[dict, dict, int, dict]:
        """Receive a streamed aggregate, decoding each leaf the moment its
        bytes complete; every frame's tag verifies under the REPLY
        direction's domain first. Returns ``(flat leaves, meta, bytes,
        wire attrs)``, the last the sampled per-leaf unpack timings ({}
        when profiling is off)."""
        tensors, meta, _chunk_bytes, payload_nbytes = wire.decode_stream_header(
            header, auth_key=self.auth_key, max_payload=framing.MAX_FRAME, direction="down"
        )
        if self.auth_key is not None and (meta.get("role") != "server" or meta.get("nonce") != nonce_hex):
            # Checked before any model bytes move.
            raise wire.WireError(
                "streamed reply failed the freshness check (stale nonce or wrong role) — possible replay"
            )
        flat: dict[str, Any] = {}
        wire_prof = self._armed_wire_profiler()
        sink = self.reply_leaf_sink
        if self.dp or self._topk_frac is not None or meta.get("dp_reply") is not None:
            # DP deltas and sparse bases need host arithmetic before any
            # placement; the sink takes absolute aggregate leaves only.
            sink = None

        def on_leaf(t: dict, raw: bytes) -> None:
            sampled = wire_prof.tick() if wire_prof is not None else False
            td0 = time.monotonic() if sampled else 0.0
            arr = wire.decode_tensor_entry(t, raw)
            # One unpack step = one leaf's decode and (meshed client) placement.
            flat[t["key"]] = sink(t["key"], arr) if sink else arr
            if sampled:
                wire_prof.note("wire", time.monotonic() - td0)

        _, got = framing.recv_stream(
            sock, tensors, payload_nbytes, on_leaf, auth_key=self.auth_key,
            nonce=bytes.fromhex(nonce_hex) if nonce_hex else b"", direction="down",
        )
        return flat, meta, len(header) + got, wire_prof.span_attrs() if wire_prof is not None else {}

    # ------------------------------------------------- sparse round deltas
    def _prepare_topk_upload(
        self, flat: dict, attempt: int, attempt_meta: dict
    ) -> tuple[dict, dict | None, dict | None]:
        """This attempt's upload in topk mode: ``(upload, delta, sent)``.
        Sparse needs a shared base; round 1, a server that never echoed an
        ``agg_round``, a changed model and every retry go dense (dense is
        always correct)."""
        use_sparse = attempt == 1 and self._base is not None and self._base_round is not None
        if use_sparse and not wire.shapes_compatible(flat, self._base):
            log.warning(
                f"[CLIENT {self.client_id}] param key set or shapes changed since the "
                "last aggregate — uploading dense this round"
            )
            use_sparse = False
        if not use_sparse:
            # wants_delta asks the server for the agg_crc stamp the next
            # round's sparse upload needs; after giving up, only a probe
            # every PROBE_EVERY rounds asks.
            if self._gave_up_delta:
                if attempt == 1:
                    self._probe_this_round = self._dense_rounds_since_giveup % self.PROBE_EVERY == 0
                    self._dense_rounds_since_giveup += 1
                attempt_meta.update(delta=False, wants_delta=self._probe_this_round)
            else:
                attempt_meta.update(delta=False, wants_delta=True)
            return flat, None, None
        residual = self._residual
        if residual is not None and not wire.shapes_compatible(residual, flat):
            residual = self._residual = None
        delta: dict[str, np.ndarray] = {}
        sent: dict[str, np.ndarray] = {}
        upload: dict[str, wire.PreEncoded] = {}
        for k, v in flat.items():
            d = np.asarray(v, np.float32) - self._base[k]
            if residual is not None:
                d = d + residual[k]
            delta[k] = d
            # One top-k selection: the payload goes to the wire as is, and
            # its densified mirror feeds the residual.
            buf = wire.sparsify_topk(d, self._topk_frac)
            sent[k] = wire.densify_topk(buf, d.shape)
            upload[k] = wire.PreEncoded("topk", buf, d.shape)
        attempt_meta.update(delta=True, base_agg_round=self._base_round)
        return upload, delta, sent

    def _finish_topk(self, agg: dict, agg_meta: Mapping[str, Any], delta_flat, sent_flat) -> None:
        """Adopt the reply as the next round's base (only when it hashes
        to the server's exact fp32 aggregate) and fold this round's
        dropped mass into the residual. A dense round keeps the residual:
        it holds earlier drift the dense upload did not carry."""
        if delta_flat is not None:
            self._residual = {k: delta_flat[k] - sent_flat[k] for k in delta_flat}
        agg_round = agg_meta.get("agg_round")
        if agg_round is None:
            self._base = self._base_round = None
            if not self._gave_up_delta:
                self._gave_up_delta = True
                self._dense_rounds_since_giveup = 1
            return
        base = {k: np.asarray(v, np.float32) for k, v in wire.flatten_params(agg).items()}
        try:
            matches = wire.flat_crc32(base) == int(agg_meta["agg_crc"])
        except (KeyError, TypeError, ValueError):
            matches = False
        if not matches:
            if not self._warned_lossy_base:
                self._warned_lossy_base = True
                log.warning(
                    f"[CLIENT {self.client_id}] reply aggregate does not match the "
                    "server's exact fp32 base (lossy reply, or a pre-delta server) "
                    "— uploads stay dense"
                )
            self._base = self._base_round = self._residual = None
            if not self._gave_up_delta:
                self._gave_up_delta = True
                self._dense_rounds_since_giveup = 1
            return
        self._base = base
        self._base_round = int(agg_round)
        self._gave_up_delta = False
