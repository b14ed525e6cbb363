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

Not ported: secure aggregation and re-homing to fallback parents.

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
import random
import socket
import struct
import time
from typing import Any, Iterator, Mapping

import numpy as np

from ..obs import metrics as obs_metrics

from . import framing, wire

log = logging.getLogger(__name__)


#: Re-home reasons (the ``fedtpu_client_rehomes_total`` label values).
REHOME_REASONS = ("dial-exhausted", "mid-exchange")


def _rehome_counters() -> dict:
    """Per-reason re-home counters on the default registry, registered as
    the JAX client registers them. The port's client has no fallback
    parent, so they stay at 0; /metrics shows the same families either
    way."""
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
        tracer=None,
    ):
        _, self._topk_frac = wire.parse_compression(compression)
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
        malformed reply; a :class:`~.wire.ModeError` is not retried. With
        a topk compression the caller must adopt the returned aggregate as
        its model (the error feedback assumes it). Under DP ``round_base``
        is the params this round's training started from (the adopted
        aggregate, or the shared init in round 1); the upload is
        ``clip(params - round_base)`` and the return is absolute."""
        base_meta = {"client_id": self.client_id, "n_samples": int(n_samples), **dict(meta or {})}
        if self.stream:
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
        msg = None  # a dense frame, encoded once unless auth or topk re-encode it
        last: Exception | None = None
        for attempt in range(1, max_retries + 1):
            sock = None
            sparse_in_flight = False
            try:
                sock = connect_with_retry(
                    self.host, self.port, timeout=self.timeout, retry_seed=self.client_id
                )
                sock.settimeout(self.timeout)
                nonce_hex = None
                attempt_meta = dict(base_meta)
                if self.auth_key is not None:
                    chal = framing.recv_frame(sock)
                    if len(chal) != len(wire.NONCE_MAGIC) + wire.NONCE_LEN or not chal.startswith(wire.NONCE_MAGIC):
                        raise wire.WireError("bad auth challenge from server")
                    nonce_hex = bytes(chal[len(wire.NONCE_MAGIC) :]).hex()
                    attempt_meta.update(role="client", nonce=nonce_hex)
                if not self.dp and attempt > 1:
                    self._diagnose_mode(sock)
                upload, delta_flat, sent_flat = flat, None, None
                sitting_out = False
                if self.dp:
                    clipped = self._dp_handshake(sock, nonce_hex, dp_delta)
                    sitting_out = clipped is None
                    upload = clipped
                if self._topk_frac is not None:
                    upload, delta_flat, sent_flat = self._prepare_topk_upload(flat, attempt, attempt_meta)
                # Streamed on the first attempt only: a retry may be
                # recovering from a server that stopped streaming. Never
                # under DP (the clipped delta goes in one frame).
                use_stream = (
                    self.stream and not self.dp and self._topk_frac is None
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
                    sent, chunks, overlap_s, wire_attrs = self._stream_upload(
                        sock, upload, attempt_meta, stream_comp, nonce_hex
                    )
                    up = {"upload_shape": "stream", "wire_dtype": used_dtype, "upload_bytes": sent,
                          "chunks": chunks, "overlap_s": overlap_s}
                else:
                    self._log_dense_fallback(attempt)
                    if msg is None or self.auth_key is not None or self._topk_frac is not None or self.dp:
                        # A topk client's frame is raw (dense rounds) or
                        # carries its pre-encoded top-k leaves.
                        comp = "none" if self._topk_frac is not None else self.compression
                        msg = wire.encode(upload, meta=attempt_meta, compression=comp, auth_key=self.auth_key)
                    log.info(
                        f"[CLIENT {self.client_id}] uploading {len(msg) / 1e6:.1f} MB "
                        f"(attempt {attempt}/{max_retries})"
                    )
                    sparse_in_flight = delta_flat is not None
                    framing.send_frame(sock, msg)
                    up = {"upload_shape": "dense", "wire_dtype": "fp32", "upload_bytes": len(msg)}
                t1 = time.monotonic()
                t_rep_unix = time.time()
                reply = framing.recv_frame(sock)
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
                upload_span = None
                if not sitting_out:
                    upload_attrs = (
                        {"chunks": up["chunks"], "overlap_s": round(up["overlap_s"], 6),
                         "wire_dtype": up["wire_dtype"], **wire_attrs}
                        if up["upload_shape"] == "stream" else None
                    )
                    upload_span = (t_up_unix, t1 - t0, up["upload_bytes"], upload_attrs)
                self._flush_spans(agg_meta, upload_span, (t_rep_unix, t2 - t1, reply_bytes, reply_attrs or None))
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
                if attempt < max_retries:
                    time.sleep(min(2.0**attempt, 10.0))
            finally:
                if sock is not None:
                    sock.close()
        raise ConnectionError(
            f"client {self.client_id}: round failed after {max_retries} attempts: {last}"
        )

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
        flat: dict[str, np.ndarray] = {}
        wire_prof = self._armed_wire_profiler()

        def on_leaf(t: dict, raw: bytes) -> None:
            sampled = wire_prof.tick() if wire_prof is not None else False
            td0 = time.monotonic() if sampled else 0.0
            flat[t["key"]] = wire.decode_tensor_entry(t, raw)
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
