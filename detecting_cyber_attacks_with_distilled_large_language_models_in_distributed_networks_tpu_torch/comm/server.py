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

Central DP (``dp_clip > 0``): every connection opens with the DP
handshake (the ``DPAD`` advert, the client's ``DPID`` hello, the
``DPCO`` cohort verdict of the round's Poisson draw, and under auth the
``DPSK`` sit-out proof). Uploads are clipped round deltas against a
declared base crc, which the server re-clips (dense, streamed, and held
lossy-encoded streams); K4 folds them, and the reply is their mean plus
fp32 Gaussian noise from an OS-seeded Philox: the noised mean DELTA, so
the server never holds absolute weights. A round with an empty cohort
replies ``noop``. A client whose base is a retained earlier round's is
excluded from the mean and answered with the catch-up sequence of
retained deltas (``dp_resync_rounds`` of them, optionally persisted to
``dp_history_path``).

Observability, registered and written as in the JAX package: the
``fedtpu_server_*``, ``fedtpu_strategy_rounds_total`` and ``fedtpu_relay_*``
families on the process registry (``/metrics``), and with a ``tracer`` the
``round``, ``agg``, ``wire-reply`` and ``wire-overlap`` spans under the
round's trace id (stamped into every reply's meta, so the clients' spans
share it); a failed round dumps a flight-recorder bundle, and every round
snapshots device memory at its aggregation boundary.

Secure aggregation (``secure_agg``, comm/secure.py): every connection
opens with the round advert (round, session, protocol), relays the DH
public keys of the round's keyed participants, and under the ``double``
protocol the Shamir share blobs; uploads are pairwise-masked uint64 ring
elements, dense and single-frame. Their ring sum is host numpy (it is not
a fold), followed by the unmask round (``double``: every round; ``reveal``:
when a keyed participant died) and de-quantization. The server never holds
a private key or a raw update.

Fold trees (comm/relay.py): a relay is this server with ``reply_via``
set, which ships the subtree's folded mean to the parent and fans the
root's aggregate back down. A relay's upward upload carries its
contributor record (``wire.META_SUBTREE_IDS``); the root keeps the
round's assignment (``last_assignment``), refuses a client claimed by two
subtrees and a relay that claims another strategy, and completes a
degraded round without a dead subtree. A re-homed client
(``wire.META_REHOMED``) is folded as an extra contributor that never
counts toward the round's own quorum.
"""

from __future__ import annotations

import hmac
import json
import logging
import os
import socket
import struct
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs.profile import note_memory
from ..obs.trace import new_trace_id
from ..strategies import Strategy, make_strategy
from . import framing, secure, shamir, wire
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
    #: Central DP: each upload's declared round-base crc (the round
    #: aggregates only over one agreed base).
    dp_crcs: dict[int, int] = field(default_factory=dict)
    #: Poisson cohort (``dp_participation < 1``): the round's sampled ids;
    #: non-sampled clients register in ``skip_conns`` for the reply.
    cohort: set | None = None
    skip_conns: dict[int, socket.socket] = field(default_factory=dict)
    #: ``StreamAgg.stats()`` once the round folded (None before, and for
    #: a failed, no-op or secure round).
    fold_stats: dict | None = None
    #: Secure aggregation: each upload's masked uint64 tree (there is no
    #: fold), each keyed participant's (public value, tag) hello, the key
    #: set U1 the keys frame covered; under double masking each dealer's
    #: share blobs and commitment and the share-complete set U2.
    secure_models: dict[int, dict] = field(default_factory=dict)
    pubkeys: dict[int, bytes] = field(default_factory=dict)
    key_set: list | None = None
    keys_ready: threading.Event = field(default_factory=threading.Event)
    share_blobs: dict[int, dict] = field(default_factory=dict)
    share_commits: dict[int, bytes] = field(default_factory=dict)
    share_set: list | None = None
    shares_ready: threading.Event = field(default_factory=threading.Event)
    #: Re-homed ids adopted as extra contributors (never counted toward
    #: ``expected``), and per relay upload the client ids its partial
    #: folded.
    adopted: set = field(default_factory=set)
    subtree_ids: dict[int, list] = field(default_factory=dict)


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
        secure_agg: bool = False,
        fp_bits: int = secure.DEFAULT_FP_BITS,
        key_grace: float | None = None,
        client_keys: dict[int, bytes] | None = None,
        secure_protocol: str = "double",
        secure_threshold: int | None = None,
        stream_chunk_bytes: int = wire.DEFAULT_STREAM_CHUNK,
        strategy: str | Strategy | None = None,
        strategy_state_path: str | None = None,
        reply_dtype: str = "fp32",
        dp_clip: float = 0.0,
        dp_noise_multiplier: float = 0.0,
        dp_participation: float = 1.0,
        dp_resync_rounds: int = 8,
        dp_history_path: str | None = None,
        device: str | torch.device | None = None,
        tracer=None,
    ):
        self.device = resolve_device(device)
        if client_keys is not None and auth_key is None:
            raise ValueError(
                "client_keys (per-client DH identity binding) requires "
                "auth_key: the wire messages and the relayed keys frame "
                "are authenticated under the group key"
            )
        if dp_noise_multiplier > 0.0 and dp_clip <= 0.0:
            raise ValueError("dp_noise_multiplier needs dp_clip > 0")
        if dp_clip > 0.0 and weighted:
            raise ValueError(
                "central DP is a uniform mean over clipped updates; "
                "weighted=True is incompatible"
            )
        if secure_agg and weighted:
            raise ValueError(
                "secure aggregation is an unweighted ring sum; "
                "weighted=True is incompatible"
            )
        if secure_agg and min_clients is not None and min_clients < 2:
            raise ValueError(
                "secure aggregation needs min_clients >= 2: a lone "
                "survivor's 'sum' is its raw update"
            )
        if secure_protocol not in ("reveal", "double"):
            raise ValueError(f"secure_protocol {secure_protocol!r} must be reveal|double")
        if secure_agg and secure_protocol == "double" and num_clients > 254:
            raise ValueError("double-masking Shamir x-coordinates support <= 254 clients")
        if secure_threshold is not None and secure_threshold < 2:
            raise ValueError(
                "secure_threshold < 2 would let the server reconstruct "
                "secrets from a single holder"
            )
        if not 0.0 < dp_participation <= 1.0:
            raise ValueError(f"dp_participation={dp_participation} must be in (0, 1]")
        if dp_participation < 1.0 and dp_clip <= 0.0:
            raise ValueError(
                "dp_participation < 1 is the DP cohort sampler; it needs "
                "dp_clip > 0 (the sampling exists for the accountant's "
                "privacy amplification)"
            )
        if wire.parse_compression(compression)[0] == "topk":
            raise ValueError(
                "topk is an upload-side (sparse round-delta) compression; "
                "the reply is an absolute aggregate — use none/bf16/int8"
            )
        if reply_dtype not in wire.WIRE_DTYPE_ENCS:
            raise ValueError(f"reply_dtype {reply_dtype!r} must be one of {sorted(wire.WIRE_DTYPE_ENCS)}")
        if reply_dtype != "fp32" and secure_agg:
            raise ValueError(
                "lossy reply_dtype is refused under secure aggregation:"
                " the unmask release is bit-exact by contract"
            )
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
        #: Secure aggregation: the recovery protocol (``double``: Bonawitz
        #: double masking, an unmask round every round; ``reveal``: an
        #: unmask round only after a dropout), the Shamir threshold (None:
        #: a strict majority of U1), the fixed-point bits, and the per-run
        #: session nonce advertised with the round (mask streams are keyed
        #: by (session, round): fresh across rounds and restarts).
        self.secure_agg = bool(secure_agg)
        self.secure_protocol = secure_protocol
        self.secure_threshold = secure_threshold
        self.fp_bits = int(fp_bits)
        self._session = os.urandom(wire.SESSION_LEN)
        #: Per-client DH identity keys: a hello claiming id i must carry a
        #: tag under client i's own key.
        self.client_keys = dict(client_keys) if client_keys else None
        #: After this long without every hello (or every dealer's shares),
        #: the key set (U2) closes at the quorum that did arrive.
        self.key_grace = timeout / 2.0 if key_grace is None else float(key_grace)
        self._strategy = make_strategy(strategy, device=self.device)
        if self._strategy.name != "fedavg" and secure_agg:
            raise ValueError(
                f"strategy {self._strategy.name!r} is incompatible "
                "with secure aggregation: the unmask protocol "
                "releases exactly the masked SUM; a server-side "
                "post-transform would operate on (and leak through) "
                "a different release"
            )
        if self._strategy.name != "fedavg" and dp_clip > 0.0:
            raise ValueError(
                f"strategy {self._strategy.name!r} is incompatible "
                "with central DP: the DP release is the noised mean "
                "DELTA with a calibrated sensitivity; an optimizer "
                "transform on top would change what is released "
                "without re-deriving the bound"
            )
        self.dp_clip = float(dp_clip)
        self.dp_noise_multiplier = float(dp_noise_multiplier)
        self.dp_participation = float(dp_participation)
        # The resync window: the last dp_resync_rounds released (post-noise)
        # round deltas with the base crc their round agreed on. A client
        # that missed a reply declares one of those crcs; its upload is
        # excluded and it is answered with every retained delta from its
        # base forward, which it replays in order (the fleet's own fp32
        # additions, so its base lands on the fleet's bit for bit).
        # Re-releasing released values is post-processing: no privacy
        # cost. Lossy reply compression disables it (the fleet's bases are
        # the decoded deltas, which fp32 retention cannot reproduce).
        self.dp_resync_rounds = int(dp_resync_rounds)
        self._dp_history: list[tuple[int, dict]] = []
        # Persisted after every round by one background writer holding the
        # latest snapshot (never on the round's critical path), reloaded
        # on start, so a restart does not re-strand stale clients.
        self.dp_history_path = dp_history_path
        self._dp_persist_lock = threading.Lock()
        self._dp_persist_pending: list | None = None
        self._dp_persist_thread: threading.Thread | None = None
        if dp_history_path:
            self._load_dp_history()
        # Noise and cohort draws: Philox keyed from OS entropy, never from
        # a run artifact. The samples are fp32 Gaussians (Mironov's 2012
        # floating-point attack applies; a discrete Gaussian would not).
        self._dp_rng = np.random.Generator(np.random.Philox(key=int.from_bytes(os.urandom(16), "little")))
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
        #: The fold-tree hook (comm/relay.py): when set, the round's folded
        #: mean goes through ``reply_via(mean, info)`` between aggregation
        #: and the reply fan-out, and what it returns (the root's
        #: aggregate) is what the subtree's clients receive. Refused under
        #: central DP and secure aggregation.
        self.reply_via = None
        #: Per-server totals for harnesses that hold the server object:
        #: streamed uploads and replies, dense fallbacks, and the peak fold
        #: state over all rounds; dropped subtrees, shed stragglers and
        #: degraded rounds.
        self._totals_lock = threading.Lock()
        self.stream_totals = {"stream_uploads": 0, "stream_replies": 0, "stream_fallbacks": 0, "peak_agg_bytes": 0}
        self.tree_totals = {"subtree_failures": 0, "stragglers_shed": 0, "degraded_rounds": 0}
        #: The last completed round's assignment, ``{"round", "groups"}``:
        #: per contributor in fold order its id, or the client ids its
        #: subtree partial folded (``comm.relay.aggregate_tree``'s groups).
        self.last_assignment: dict | None = None
        #: The last double-masked round's split: the unmask sub-round, the
        #: ring sum and the residue subtraction (seconds).
        self.last_secure_s: dict[str, float] = {}
        #: Where each round's wall went: wait (accept + uploads, with the
        #: folds that overlapped them), agg (the rest of the fold, the
        #: strategy and the replies' encode), reply (the fan-out).
        self.phase_seconds = {"wait": 0.0, "agg": 0.0, "reply": 0.0}
        #: Span writer (obs/trace.py) for round/agg/wire-reply spans; the
        #: last round's (trace id, round).
        self.tracer = tracer
        self.last_trace: tuple[str, int] | None = None
        #: The process's /metrics endpoint when this server owns it
        #: (``serve --metrics-port``); closed with the server.
        self.metrics_server = None
        self._register_metrics()
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

    def _register_metrics(self) -> None:
        """The JAX server's families on the process registry (get-or-create:
        a second server in one process shares them)."""
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_stream_uploads = m.counter(
            "fedtpu_server_stream_uploads_total",
            help="chunk-streamed client uploads accepted into a round",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_stream_replies = m.counter(
            "fedtpu_server_stream_replies_total",
            help="aggregate replies fanned out as chunk streams",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_stream_fallbacks = m.counter(
            "fedtpu_server_stream_fallbacks_total",
            help="dense single-frame uploads accepted while streaming "
            "was advertised (topk/secure-agg/old-peer/retry fallbacks)",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._g_inflight_streams = m.gauge(
            "fedtpu_server_stream_inflight",
            help="chunk-streamed uploads currently mid-transfer",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_uploads_by_dtype = lambda wd: m.counter(
            "fedtpu_server_stream_uploads_by_wire_dtype_total",
            help="chunk-streamed uploads accepted, by negotiated wire "
            "dtype (fp32|bf16|int8)",
            labels={"wire_dtype": wd},
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._g_fold_throughput = m.gauge(
            "fedtpu_server_fold_throughput_gbps",
            help="last round's fold throughput (bytes folded / fold "
            "seconds), by the active fold engine",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._g_peak_agg = m.gauge(
            "fedtpu_server_peak_agg_bytes",
            help="peak aggregation-state bytes of the last round "
            "(accumulator + pending leaves)",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_rounds = m.counter(
            "fedtpu_server_rounds_total",
            help="aggregation rounds started",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_strategy_rounds = lambda name: m.counter(
            "fedtpu_strategy_rounds_total",
            help="aggregation rounds finalized, by server strategy",
            labels={"strategy": name},
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_round_failures = m.counter(
            "fedtpu_server_round_failures_total",
            help="rounds that raised (quorum miss, deadline, bad uploads)",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_uploads = m.counter(
            "fedtpu_server_uploads_total",
            help="client model uploads accepted into a round",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_bytes_in = m.counter(
            "fedtpu_server_wire_bytes_received_total",
            help="model upload payload bytes received",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_bytes_out = m.counter(
            "fedtpu_server_wire_bytes_sent_total",
            help="aggregate reply payload bytes sent",
        )
        self._m_phase = {
            # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
            p: m.counter(
                "fedtpu_server_round_phase_seconds_total",
                help="round wall-clock by phase (wait|agg|reply)",
                labels={"phase": p},
            )
            for p in ("wait", "agg", "reply")
        }
        # A degraded round counts its missing children as dropped
        # subtrees at a parent of relays, as shed stragglers elsewhere.
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_subtree_failures = m.counter(
            "fedtpu_relay_subtree_failures_total",
            help="expected fold-tree children missing from a completed "
            "round at a parent of relays (the subtree was dropped from "
            "the fold; the mean renormalized over survivors)",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._m_stragglers_shed = m.counter(
            "fedtpu_relay_stragglers_shed_total",
            help="expected leaf clients missing from a completed quorum "
            "round (shed locally at this aggregator's deadline instead "
            "of stalling its parent)",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's comm/server.py family, same name/kind/labels/help
        self._h_round = m.histogram(
            "fedtpu_server_round_seconds",
            help="aggregation round wall-clock, failed rounds included "
            "(the round-duration SLO's burn-rate source, obs/slo.py)",
            buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0),
        )

    # -------------------------------------------------------------- strategy
    @property
    def strategy(self) -> Strategy:
        return self._strategy

    def set_strategy(self, spec) -> Strategy:
        """Swap the aggregation strategy BETWEEN rounds; its optimizer
        state starts fresh."""
        strat = make_strategy(spec, device=self.device)
        if strat.name != "fedavg" and (self.secure_agg or self.dp_clip > 0.0):
            raise ValueError(
                f"strategy {strat.name!r} is incompatible with "
                "secure-agg/DP rounds (see the constructor's rationale)"
            )
        self._strategy = strat
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
                shed += list(rnd.conns.values()) + list(rnd.skip_conns.values())
        with self._conn_lock:
            shed += list(self._open_conns)
        for c in shed:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        self._pool.shutdown(wait=False, cancel_futures=True)
        # Drain both writers: a clean shutdown leaves the newest resync
        # window and strategy state on disk.
        for lock, attr in (
            (self._dp_persist_lock, "_dp_persist_thread"),
            (self._strategy_persist_lock, "_strategy_persist_thread"),
        ):
            with lock:
                t = getattr(self, attr)
            if t is not None:
                t.join(timeout=60.0)
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None

    def __enter__(self) -> "AggregationServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- uploads
    def _validate_upload(self, meta, nonce_hex: str | None, dpid: int | None = None) -> int:
        """Freshness and identity checks the dense and the streamed upload
        share; returns the client id (which must be the DP id hello's,
        under DP)."""
        if self.auth_key is not None and (
            meta.get("role") != "client" or meta.get("nonce") != nonce_hex
        ):
            raise wire.WireError(
                "authenticated upload failed the freshness check "
                "(stale nonce or wrong role) — possible replay"
            )
        client_id = int(meta.get("client_id", -1))
        if dpid is not None and client_id != dpid:
            raise wire.WireError(f"upload claims client {client_id} but the DP id hello said {dpid}")
        return client_id

    def _validate_dp_meta(self, meta, *, is_delta: bool) -> tuple[bool, int | None]:
        """Central-DP mode agreement and the base crc, for both upload
        shapes; returns ``(dp_mode, dp_crc)``."""
        dp_mode = self.dp_clip > 0.0
        if bool(meta.get("dp", False)) != dp_mode:
            raise wire.WireError(
                f"central-DP mode mismatch: server dp={dp_mode}, "
                f"upload dp={meta.get('dp', False)} — run the client "
                f"with --dp iff the server has --dp-clip"
            )
        dp_crc = None
        if dp_mode:
            if is_delta:
                raise wire.WireError("sparse-delta upload in central-DP mode")
            try:
                dp_crc = int(meta["dp_base_crc"])
            except (KeyError, TypeError, ValueError):
                raise wire.WireError("DP upload missing its dp_base_crc") from None
        return dp_mode, dp_crc

    def _reclip(self, flat: dict, client_id: int, what: str) -> dict:
        """The server's enforced clip: a delta above ``dp_clip`` (past the
        fp tolerance) is scaled down as the client should have."""
        norm = wire.flat_l2_norm(flat)
        if norm > self.dp_clip * (1.0 + 1e-5):
            flat, _, _ = wire.clip_flat(flat, self.dp_clip)
            log.info(f"[SERVER] re-clipped client {client_id}'s {what} ({norm:.4g} -> {self.dp_clip})")
        return flat

    def _round_done(self, rnd: _Round) -> bool:
        """Caller holds ``rnd.lock``: every expected upload arrived (the
        fleet, the secure key set or the cohort; adopted re-homed ids do
        not count toward it, but each must itself complete) and, under a
        Poisson cohort, every non-sampled client connected for its
        reply."""
        own = len(rnd.done - rnd.adopted)
        uploads_done = (own >= rnd.expected and rnd.adopted <= rnd.done) or (
            self.secure_agg and rnd.key_set is not None and set(rnd.key_set) <= rnd.done
        )
        if rnd.cohort is None:
            return uploads_done
        return uploads_done and len(rnd.skip_conns) >= self.num_clients - len(rnd.cohort)

    def _dp_handshake(self, conn: socket.socket, rnd: _Round, nonce_hex: str | None) -> tuple[int, bool]:
        """The DP handshake, server first: the advert (so a plain client
        can diagnose the mismatch), the client's id hello, the round's
        cohort verdict. A non-sampled client (under auth, after proving
        key knowledge) is registered for the reply. Returns ``(client id,
        sampled)``."""
        framing.send_frame(
            conn, wire.DP_MAGIC + struct.pack("<ddd", self.dp_clip, self.dp_noise_multiplier, self.dp_participation)
        )
        idf = framing.recv_frame(conn)
        if len(idf) != len(wire.DPID_MAGIC) + 8 or not bytes(idf).startswith(wire.DPID_MAGIC):
            raise wire.WireError("bad DP id hello")
        dpid = struct.unpack("<q", bytes(idf[len(wire.DPID_MAGIC):]))[0]
        if not 0 <= dpid < self.num_clients:
            raise wire.WireError(f"DP id hello from unknown client {dpid}")
        with rnd.lock:
            sampled = rnd.cohort is None or dpid in rnd.cohort
        framing.send_frame(conn, wire.DPCOHORT_MAGIC + bytes([1 if sampled else 0]))
        if sampled:
            return dpid, True
        if self.auth_key is not None:
            # Without this proof anyone could claim a non-sampled id,
            # evict the real registration and collect the aggregate.
            ack = framing.recv_frame(conn)
            want = wire.DPSKIP_MAGIC + hmac.new(
                self.auth_key, wire.DPSKIP_DOMAIN + bytes.fromhex(nonce_hex) + struct.pack("<q", dpid), "sha256"
            ).digest()
            if not hmac.compare_digest(bytes(ack), want):
                raise wire.WireError(f"sit-out ack for client {dpid} failed its authenticity check")
        with rnd.lock:
            if rnd.closed:
                conn.close()
                return dpid, False
            old = rnd.skip_conns.pop(dpid, None)
            if old is not None and old is not conn:
                old.close()
            rnd.skip_conns[dpid] = conn
            if nonce_hex is not None:
                rnd.nonces[dpid] = nonce_hex
            done = self._round_done(rnd)
        log.info(
            f"[SERVER] client {dpid} sits out round {rnd.round_no} "
            f"(cohort sampling q={self.dp_participation})"
        )
        if done:
            rnd.complete.set()
        return dpid, False

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

    def _handle_upload(self, conn: socket.socket, rnd: _Round, deadline: float | None = None) -> None:
        if deadline is None:
            deadline = time.monotonic() + self.timeout
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
            dpid = None
            if self.dp_clip > 0.0:
                dpid, sampled = self._dp_handshake(conn, rnd, nonce_hex)
                if not sampled:
                    return
            if self.secure_agg and not self._secure_handshake(conn, rnd, deadline):
                return
            payload = framing.recv_frame(conn)
            if bytes(payload[:4]) == wire.STREAM_MAGIC:
                self._handle_stream_upload(conn, payload, rnd, nonce_hex=nonce_hex, dpid=dpid)
                return
            self._m_bytes_in.inc(float(len(payload)))
            flat, meta = wire.decode(payload, auth_key=self.auth_key)
            client_id = self._validate_upload(meta, nonce_hex, dpid)
            flat = wire.flatten_params(flat)
            is_delta = bool(meta.get("delta", False))
            if is_delta:
                if self.secure_agg:
                    raise wire.WireError("sparse-delta upload in secure-aggregation mode")
                self._check_delta(flat, meta)
            if bool(meta.get("secure", False)) != self.secure_agg:
                raise wire.WireError(
                    f"secure-aggregation mode mismatch: server "
                    f"secure_agg={self.secure_agg}, upload "
                    f"secure={meta.get('secure', False)}"
                )
            dp_mode, dp_crc = self._validate_dp_meta(meta, is_delta=is_delta)
            if dp_mode and not self.secure_agg:
                # Enforced, not trusted: a client that skipped its clip
                # cannot widen the mechanism's sensitivity. (A masked
                # upload cannot be re-clipped: there the guarantee
                # assumes honest clients clip.)
                flat = self._reclip(flat, client_id, "delta")
            if self.secure_agg:
                self._check_secure_meta(rnd, meta)
            n_samples = float(meta.get("n_samples", 1.0))
            with rnd.lock:
                if rnd.closed:
                    log.info(
                        f"[SERVER] late upload from client {client_id} after "
                        "round close; dropping connection"
                    )
                    conn.close()
                    return
                if not self._register_tree_meta(rnd, conn, client_id, meta):
                    return
                dup_folded = False
                if self.secure_agg:
                    # A masked retry replaces the first upload (there is
                    # no fold to have consumed it).
                    old = rnd.conns.pop(client_id, None)
                    if old is not None and old is not conn:
                        old.close()
                elif client_id in rnd.done or client_id in rnd.stream.intents:
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
                        if it.get("dp_crc") is not None:
                            rnd.dp_crcs[client_id] = it["dp_crc"]
                        rnd.n_samples[client_id] = float(it.get("n_samples", 1.0))
                        rnd.uploads[client_id] = {"shape": "dense", "wire_dtype": "fp32", "bytes": len(payload)}
                        if set(flat) == set(it.get("keys", ())) and is_delta == bool(it.get("delta", False)):
                            rnd.stream.add_dense(client_id, flat)
                if not dup_folded:
                    rnd.done.add(client_id)
                    rnd.n_samples[client_id] = n_samples
                    rnd.uploads[client_id] = {"shape": "dense", "wire_dtype": "fp32", "bytes": len(payload)}
                    if dp_crc is not None:
                        rnd.dp_crcs[client_id] = dp_crc
                    if self.secure_agg:
                        rnd.secure_models[client_id] = flat
                if is_delta or bool(meta.get("wants_delta", False)):
                    rnd.wants_delta = True
                self._note_reply_caps(rnd, client_id, meta)
                rnd.conns[client_id] = conn
                if nonce_hex is not None:
                    rnd.nonces[client_id] = nonce_hex
                if not dup_folded and not self.secure_agg:
                    rnd.stream.register(
                        client_id, keys=tuple(flat), n_samples=n_samples, delta=is_delta, dp_crc=dp_crc
                    )
                    rnd.stream.add_dense(client_id, flat)
                    self._try_freeze_stream(rnd)
                done = self._round_done(rnd)
            if self.stream_chunk_bytes > 0 and not self.secure_agg and not dup_folded:
                # Dense while streaming was offered: a fallback (round 1,
                # topk, DP, a retry or an old peer).
                with self._totals_lock:
                    self.stream_totals["stream_fallbacks"] += 1
                self._m_stream_fallbacks.inc()
            self._m_uploads.inc()
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
        have = set(st.intents)
        if rnd.cohort is not None:
            if not rnd.cohort <= have:
                return
            ids = sorted(rnd.cohort)
        else:
            # Adopted (re-homed) intents join the fold set but do not
            # satisfy the expected count.
            if len(have - rnd.adopted) < rnd.expected:
                return
            ids = sorted(have)
        if self.dp_clip > 0.0:
            # The close-time staleness partition over the same inputs (the
            # history changes only after the wait), so the frozen set is
            # the one serve_round aggregates over. Current clients that
            # disagree on their base leave it unfrozen: close time raises.
            crcs = {c: st.intents[c].get("dp_crc") for c in ids}
            hist = {crc for crc, _ in self._dp_history}
            stale = [c for c in ids if crcs[c] in hist]
            current = [c for c in ids if c not in stale]
            if not current and stale and len({crcs[c] for c in stale}) == 1:
                current = stale
            if not current or len({crcs[c] for c in current}) != 1:
                return
            ids = current
        weights = [st.intents[c]["n_samples"] for c in ids] if self.weighted else None
        st.freeze(ids, weights)

    def _handle_stream_upload(
        self, conn: socket.socket, header, rnd: _Round, *, nonce_hex: str | None, dpid: int | None = None
    ) -> None:
        """Receive one streamed upload: validate the header's meta as a
        dense upload's, register the intent, then decode each leaf as its
        bytes complete and hand it to the StreamAgg, which folds it the
        moment every member's copy arrived. The trailer is the
        upload-complete handshake; only then does the client count toward
        the round. A duplicate after folds consumed the first upload is
        drained (a completed original stands) or adopted (the retry of a
        half-folded, dead stream completes the folds).

        Under DP a raw stream folds eagerly and its norm is summed as its
        leaves arrive; past the clip its pending leaves are scaled, or the
        round fails closed when folds already consumed some. A
        lossy-encoded stream is held whole and re-clipped before it joins
        the fold (its decode can inflate an honest clip)."""
        st = rnd.stream
        if self.secure_agg:
            raise wire.WireError(
                "streamed upload refused: this round aggregates masked "
                "uploads (secure-agg), which are single-frame by design"
            )
        tensors, meta, _chunk_bytes, payload_nbytes = wire.decode_stream_header(
            header, auth_key=self.auth_key, max_payload=framing.MAX_FRAME, direction="up"
        )
        client_id = self._validate_upload(meta, nonce_hex, dpid)
        if bool(meta.get("delta", False)):
            raise wire.WireError(
                "sparse-delta uploads are single-frame (topk payload sizes are "
                "data-dependent; nothing to stream)"
            )
        if bool(meta.get("secure", False)):
            raise wire.WireError(
                "secure-aggregation mode mismatch: server "
                "secure_agg=False, upload secure=True"
            )
        dp_mode, dp_crc = self._validate_dp_meta(meta, is_delta=False)
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
            if not self._register_tree_meta(rnd, conn, client_id, meta):
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
                st.register(client_id, keys=keys, n_samples=n_samples, dp_crc=dp_crc)
            # Registered now: a failed round's cleanup closes a mid-stream
            # client too.
            rnd.conns[client_id] = conn
            self._try_freeze_stream(rnd)
        nonce = bytes.fromhex(nonce_hex) if nonce_hex else b""
        dp_hold: dict[str, np.ndarray] | None = (
            {} if dp_mode and any(t["enc"] != "raw" for t in tensors) else None
        )
        sumsq = 0.0  # header order = sorted keys = flat_l2_norm's order
        self._m_bytes_in.inc(float(len(header)))

        def on_leaf(t: dict, raw: bytes) -> None:
            nonlocal sumsq
            if discard:
                return
            arr = wire.decode_tensor_entry(t, raw)
            if dp_hold is not None:
                dp_hold[t["key"]] = arr
                return
            if dp_mode:
                sumsq += float(np.sum(np.asarray(arr, np.float64) ** 2))
            st.add_leaf(client_id, t["key"], arr)

        self._g_inflight_streams.inc()
        try:
            try:
                seq, body = framing.recv_stream(
                    conn, tensors, payload_nbytes, on_leaf, auth_key=self.auth_key, nonce=nonce, direction="up"
                )
            finally:
                self._g_inflight_streams.dec()
            self._m_bytes_in.inc(float(body))
            if not discard and dp_hold is not None:
                st.add_dense(client_id, self._reclip(dp_hold, client_id, "streamed lossy-encoded delta"))
            elif not discard:
                st.mark_complete(client_id)
            if dp_mode and not discard and dp_hold is None:
                norm = float(np.sqrt(sumsq))
                if norm > self.dp_clip * (1.0 + 1e-5):
                    if not st.scale_client(client_id, min(1.0, self.dp_clip / max(norm, 1e-12))):
                        raise wire.WireError(
                            f"client {client_id} exceeded its DP clip "
                            f"({norm:.4g} > {self.dp_clip}) after folds "
                            "already consumed its leaves — round fails closed"
                        )
                    log.info(f"[SERVER] re-clipped client {client_id}'s streamed delta ({norm:.4g} -> {self.dp_clip})")
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
                if dp_crc is not None:
                    rnd.dp_crcs[client_id] = dp_crc
            if bool(meta.get("wants_delta", False)):
                rnd.wants_delta = True
            self._note_reply_caps(rnd, client_id, meta)
            if nonce_hex is not None:
                rnd.nonces[client_id] = nonce_hex
            done = self._round_done(rnd)
        if not discard:
            with self._totals_lock:
                self.stream_totals["stream_uploads"] += 1
            self._m_uploads.inc()
            self._m_stream_uploads.inc()
            self._m_uploads_by_dtype(up_dtype).inc()
        log.info(
            f"[SERVER] received streamed model from client {client_id} "
            f"({payload_nbytes / 1e6:.1f} MB {up_dtype} in {seq} chunk(s)"
            + ("; drained as a duplicate" if discard else "")
            + f"; {len(rnd.done)}/{rnd.expected})"
        )
        if done:
            rnd.complete.set()

    # ---------------------------------------------------- secure aggregation
    def _secure_handshake(self, conn: socket.socket, rnd: _Round, deadline: float) -> bool:
        """One connection's key exchange: advertise (round, session,
        protocol), take the client's DH hello (tag checked under its own
        identity key when provisioned, re-tagged under the group key for
        the relay), wait for the fleet's hellos (after ``key_grace`` the
        key set closes at the quorum that arrived), relay the key set and,
        under double masking, run the share exchange. Returns False when
        the connection was dropped (a conflicting or late hello, a client
        outside the closed set)."""
        proto = secure.PROTO_DOUBLE if self.secure_protocol == "double" else secure.PROTO_REVEAL
        framing.send_frame(
            conn, wire.ROUND_MAGIC + struct.pack("<Q", rnd.round_no) + self._session + bytes([proto])
        )
        hello = bytes(framing.recv_frame(conn))
        tag_len = wire.AUTH_TAG_LEN if self.auth_key is not None else 0
        want_len = len(wire.PUBKEY_MAGIC) + 8 + secure.DH_PUB_LEN + tag_len
        if len(hello) != want_len or not hello.startswith(wire.PUBKEY_MAGIC):
            raise wire.WireError("bad DH pubkey hello")
        off = len(wire.PUBKEY_MAGIC)
        hello_id = struct.unpack("<q", hello[off : off + 8])[0]
        pub_and_tag = hello[off + 8 :]
        pub = pub_and_tag[: secure.DH_PUB_LEN]
        secure.check_dh_public(pub)
        if self.auth_key is not None:
            hello_key = self.auth_key
            if self.client_keys is not None:
                # Identity binding: the tag must verify under the claimed
                # id's own key.
                hello_key = self.client_keys.get(hello_id)
                if hello_key is None:
                    raise wire.WireError(f"DH hello from client {hello_id} with no registered per-client key")
            secure.verify_pubkey_tag(
                hello_key, self._session, rnd.round_no, hello_id, pub, pub_and_tag[secure.DH_PUB_LEN :]
            )
            if self.client_keys is not None:
                # Receivers hold the group key, not each other's identity
                # keys: the server attests what it verified.
                pub_and_tag = pub + secure.pubkey_tag(self.auth_key, self._session, rnd.round_no, hello_id, pub)
        with rnd.lock:
            if rnd.closed:
                conn.close()
                return False
            if not 0 <= hello_id < self.num_clients:
                raise wire.WireError(f"DH hello from unknown client id {hello_id}")
            prev_hello = rnd.pubkeys.get(hello_id)
            if prev_hello is not None and prev_hello != pub_and_tag:
                # First registration wins: another key for a registered id
                # is an impersonation or a client that lost its keypair.
                log.info(f"[SERVER] conflicting DH hello for client {hello_id}; dropping connection")
                conn.close()
                return False
            if prev_hello is None and rnd.keys_ready.is_set():
                # A new key after distribution could never cancel.
                log.info(f"[SERVER] late DH hello from client {hello_id} after key distribution; dropping connection")
                conn.close()
                return False
            # A fresh registration, or a retry's idempotent re-hello (the
            # same per-round keypair), which re-binds the connection.
            old = rnd.conns.pop(hello_id, None)
            if old is not None and old is not conn:
                old.close()
            rnd.pubkeys[hello_id] = pub_and_tag
            # Registered now: a failed round's cleanup closes this socket.
            rnd.conns[hello_id] = conn
            if len(rnd.pubkeys) >= rnd.expected:
                rnd.key_set = sorted(rnd.pubkeys)
                rnd.keys_ready.set()
        log.info(f"[SERVER] DH pubkey from client {hello_id} ({len(rnd.pubkeys)}/{rnd.expected})")
        self._wait_closed_set(
            rnd, rnd.keys_ready, deadline, floor=max(2, self.min_clients),
            close=lambda: setattr(rnd, "key_set", sorted(rnd.pubkeys)),
            have=lambda: len(rnd.pubkeys), what="remaining participants' DH public keys", label="key set",
        )
        with rnd.lock:
            key_set = list(rnd.key_set or [])
            entries = b"".join(struct.pack("<q", cid) + rnd.pubkeys[cid] for cid in key_set)
        if hello_id not in key_set:
            log.info(f"[SERVER] client {hello_id} missed the key set {key_set}; dropping connection")
            conn.close()
            return False
        framing.send_frame(conn, wire.KEYS_MAGIC + entries)
        if self.secure_protocol == "double":
            return self._shares_exchange(conn, rnd, hello_id, key_set, deadline)
        return True

    def _wait_closed_set(
        self, rnd: _Round, ready: threading.Event, deadline: float, *, floor: int, close, have, what: str, label: str
    ) -> None:
        """Wait for ``ready`` (the full key set, or U2); once ``key_grace``
        passed, close the set at ``floor`` or more members (``close()``
        under the round lock). Raises at the round deadline."""
        grace_end = time.monotonic() + self.key_grace
        while not ready.is_set():
            now = time.monotonic()
            if now >= deadline:
                raise wire.WireError(f"round deadline passed waiting for the {what}")
            # Before the grace ends wake at its end to try the quorum
            # close; after it, another handler closes the set and wakes us.
            if ready.wait(timeout=max(0.0, (grace_end if now < grace_end else deadline) - now)):
                break
            with rnd.lock:
                if not ready.is_set() and time.monotonic() >= grace_end and have() >= floor:
                    close()
                    ready.set()
                    log.info(f"[SERVER] grace expired; closing the {label} at quorum")
                    break

    def _check_secure_meta(self, rnd: _Round, meta) -> None:
        """A masked upload must match the server's fixed-point bits, be
        masked over the round's distributed mask set, and be keyed to this
        round."""
        if int(meta.get("fp_bits", -1)) != self.fp_bits:
            raise wire.WireError(
                f"secure upload fp_bits={meta.get('fp_bits')} != server "
                f"fp_bits={self.fp_bits}: de-quantization would be wrong"
            )
        with rnd.lock:
            n_mask = len((rnd.share_set if self.secure_protocol == "double" else rnd.key_set) or [])
        if int(meta.get("participants", -1)) != n_mask:
            # Masked against another set, its pair masks would not cancel.
            raise wire.WireError(
                f"secure upload masked for {meta.get('participants')} participants, "
                f"server distributed the round's mask set to {n_mask}"
            )
        if int(meta.get("round", -1)) != rnd.round_no:
            raise wire.WireError(f"secure upload keyed to round {meta.get('round')}, server round is {rnd.round_no}")

    def _client_wire_key(self, cid: int) -> bytes | None:
        """The key the reveal, unmask and share frames for ``cid`` ride:
        its identity key when provisioned, else the group key (None
        without auth)."""
        if self.auth_key is None:
            return None
        if self.client_keys is not None:
            return self.client_keys[cid]
        return self.auth_key

    def _shares_exchange(self, conn: socket.socket, rnd: _Round, hello_id: int, key_set: list, deadline: float) -> bool:
        """Double masking's share distribution for one connection: take
        this dealer's encrypted share blobs, wait for the keyed fleet's
        (after the grace U2 closes at the dealers that delivered, never
        below the Shamir threshold), relay this holder's shareset."""
        dealer, dealt_t, commit, blobs = secure.parse_shares_frame(
            bytes(framing.recv_frame(conn)), session=self._session, round_index=rnd.round_no,
            auth_key=self._client_wire_key(hello_id),
        )
        if dealer != hello_id:
            raise wire.WireError(f"shares frame claims dealer {dealer} on client {hello_id}'s connection")
        want_t = self.secure_threshold if self.secure_threshold is not None else secure.majority_threshold(len(key_set))
        if dealt_t != want_t:
            raise wire.WireError(
                f"client {hello_id} dealt shares at threshold {dealt_t}, "
                f"server expects {want_t} (set secure_threshold "
                "identically on both ends)"
            )
        want = set(key_set) - {hello_id}
        if set(blobs) != want:
            raise wire.WireError(
                f"shares frame covers holders {sorted(blobs)}, expected every other keyed participant {sorted(want)}"
            )
        with rnd.lock:
            if rnd.closed:
                conn.close()
                return False
            prev = rnd.share_blobs.get(hello_id)
            if prev is not None and (prev != blobs or rnd.share_commits.get(hello_id) != commit):
                log.info(f"[SERVER] conflicting shares from client {hello_id}; dropping connection")
                conn.close()
                return False
            if prev is None and rnd.shares_ready.is_set():
                log.info(f"[SERVER] late shares from client {hello_id} after shareset distribution; dropping connection")
                conn.close()
                return False
            rnd.share_blobs[hello_id] = blobs
            rnd.share_commits[hello_id] = commit
            if set(key_set) <= set(rnd.share_blobs):
                rnd.share_set = sorted(rnd.share_blobs)
                rnd.shares_ready.set()
        # U2 below the threshold could never unmask: refuse it at the close.
        self._wait_closed_set(
            rnd, rnd.shares_ready, deadline, floor=max(2, self.min_clients, want_t),
            close=lambda: setattr(rnd, "share_set", sorted(rnd.share_blobs)),
            have=lambda: len(rnd.share_blobs), what="remaining participants' secret shares", label="share set U2",
        )
        with rnd.lock:
            u2 = list(rnd.share_set or [])
            entries = {d: rnd.share_blobs[d][hello_id] for d in u2 if d != hello_id}
        if hello_id not in u2:
            log.info(f"[SERVER] client {hello_id} missed the share set {u2}; dropping connection")
            conn.close()
            return False
        framing.send_frame(
            conn,
            secure.build_shareset_frame(
                u2, entries, session=self._session, round_index=rnd.round_no, auth_key=self._client_wire_key(hello_id)
            ),
        )
        return True

    def _ask_all(self, ids: list[int], conns: dict, request) -> tuple[dict, dict]:
        """One request/answer sub-round to every id in parallel under a
        bounded budget (a stalled client neither blocks the others nor
        extends the round by a socket timeout). ``request(cid, conn)``
        sends and parses; returns ``(answers, errors)``."""
        budget = min(self.timeout, 30.0)
        answers: dict[int, object] = {}
        errors: dict[int, Exception] = {}

        def _one(cid: int) -> None:
            conn = conns[cid]
            try:
                conn.settimeout(budget)
                answers[cid] = request(cid, conn)
                conn.settimeout(self.timeout)
            except (OSError, wire.WireError, secure.SecureAggError) as e:
                errors[cid] = e

        threads = [threading.Thread(target=_one, args=(cid,), daemon=True) for cid in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=budget + 5.0)
        return answers, errors

    def _aggregate_secure(self, rnd: _Round, ids: list[int], models: dict, conns: dict) -> dict:
        """The round's mean from the masked uploads: the ring sum in host
        numpy (there is no fold), the protocol's unmask round,
        de-quantization."""
        if self.secure_protocol == "double":
            agg = self._aggregate_double(rnd, models, conns)
            log.info(
                f"[SERVER] secure-aggregated {len(ids)} masked models "
                "(double-masking; server never saw raw weights)"
            )
            return agg
        key_set = list(rnd.key_set or [])
        extra = [i for i in ids if i not in key_set]
        if extra:
            raise RuntimeError(f"secure uploads from clients {extra} outside the key set {key_set}")
        dead = [i for i in key_set if i not in models]
        if not dead:
            agg = secure.aggregate_masked([models[i] for i in ids], self.fp_bits)
        else:
            # Reveal round: survivors disclose their pair secrets with the
            # dead, whose uncancelled mask halves leave the ring sum.
            log.info(f"[SERVER] secure round lost clients {dead}; asking {ids} to reveal their pair secrets")

            def reveal(cid: int, conn: socket.socket):
                key = self._client_wire_key(cid)
                framing.send_frame(
                    conn, secure.build_reveal_request(dead, session=self._session, round_index=rnd.round_no, auth_key=key)
                )
                return secure.parse_reveal_response(
                    bytes(framing.recv_frame(conn)), session=self._session, round_index=rnd.round_no,
                    client_id=cid, expect_dead=dead, auth_key=key,
                )

            revealed, errs = self._ask_all(ids, conns, reveal)
            if errs or set(revealed) != set(ids):
                # A dropout during the reveal cannot be recovered.
                raise RuntimeError(
                    f"reveal round failed for clients {sorted(set(ids) - set(revealed))}: "
                    f"{ {c: str(e) for c, e in errs.items()} }"
                )
            summed = secure.sum_masked([models[i] for i in ids])
            residue = secure.residual_mask_sum(summed, revealed, session=self._session, round_index=rnd.round_no)
            agg = secure.dequantize_sum({k: summed[k] - residue[k] for k in summed}, len(ids), self.fp_bits)
        log.info(
            f"[SERVER] secure-aggregated {len(ids)} masked models "
            + (f"after revealing {len(dead)} dropout(s) " if dead else "")
            + "(server never saw raw weights)"
        )
        return agg

    def _aggregate_double(self, rnd: _Round, models: dict, conns: dict) -> dict:
        """Double masking's completion, every round: the unmask round
        (any t responders suffice), Shamir reconstruction of the
        contributors' self-mask seeds and the dead participants' key seeds
        (each checked against its commitment or public key), then the
        residues leave the ring sum and it is de-quantized. Its split
        lands in ``last_secure_s`` (``unmask``, ``ring_sum``)."""
        with rnd.lock:
            u2 = list(rnd.share_set or [])
            u1 = list(rnd.key_set or [])
            commits = dict(rnd.share_commits)
            pubs = {cid: rnd.pubkeys[cid][: secure.DH_PUB_LEN] for cid in rnd.pubkeys}
        alive = sorted(models)
        extra = [i for i in alive if i not in u2]
        if extra:
            raise RuntimeError(f"secure uploads from clients {extra} outside the share set {u2}")
        dead = [i for i in u2 if i not in alive]
        # t comes from U1, the set the shares were dealt over.
        t = self.secure_threshold if self.secure_threshold is not None else secure.majority_threshold(len(u1))
        if len(alive) < t:
            raise RuntimeError(
                f"only {len(alive)} secure uploads survived, below the "
                f"Shamir threshold {t} — the self-masks cannot be "
                "reconstructed (dropouts exceeded the double-masking "
                "tolerance)"
            )

        def unmask(cid: int, conn: socket.socket):
            key = self._client_wire_key(cid)
            framing.send_frame(
                conn,
                secure.build_unmask_request(alive, dead, session=self._session, round_index=rnd.round_no, auth_key=key),
            )
            return secure.parse_unmask_response(
                bytes(framing.recv_frame(conn)), session=self._session, round_index=rnd.round_no, client_id=cid,
                expect_alive=alive, expect_dead=dead, auth_key=key,
            )

        t0 = time.monotonic()
        responses, errs = self._ask_all(alive, conns, unmask)
        unmask_s = time.monotonic() - t0
        if len(responses) < t:
            raise RuntimeError(
                f"unmask round got {len(responses)} responses "
                f"(clients {sorted(responses)}), need the Shamir "
                f"threshold {t}; failures: "
                f"{ {c: str(e) for c, e in errs.items()} }"
            )
        b_seeds: dict[int, bytes] = {}
        for d in alive:
            seed = shamir.combine({secure.share_x(h): responses[h][0][d] for h in responses})
            if secure.b_seed_commitment(seed, self._session, rnd.round_no, d) != commits[d]:
                raise RuntimeError(
                    f"reconstructed self-mask seed for client {d} fails its commitment — inconsistent shares"
                )
            b_seeds[d] = seed
        revealed: dict[int, dict[int, bytes]] = {}
        for d in dead:
            sk_seed = shamir.combine({secure.share_x(h): responses[h][1][d] for h in responses})
            priv, pub = secure.dh_keypair(entropy=sk_seed)
            if pub != pubs.get(d):
                raise RuntimeError(
                    f"reconstructed key seed for dead client {d} does not "
                    "match its registered public key — inconsistent shares"
                )
            for s in alive:
                revealed.setdefault(s, {})[d] = secure.dh_pair_secret(priv, pubs[s])
        t0 = time.monotonic()
        summed = secure.sum_masked([models[i] for i in alive])
        ring_sum_s = time.monotonic() - t0
        self_res = secure.self_mask_sum(summed, b_seeds, session=self._session, round_index=rnd.round_no)
        out = {k: summed[k] - self_res[k] for k in summed}
        if revealed:
            pair_res = secure.residual_mask_sum(summed, revealed, session=self._session, round_index=rnd.round_no)
            out = {k: out[k] - pair_res[k] for k in out}
        self.last_secure_s = {"unmask": unmask_s, "ring_sum": ring_sum_s, "residues": time.monotonic() - t0 - ring_sum_s}
        log.info(
            f"[SERVER] double-mask unmasked {len(alive)} uploads with "
            f"{len(responses)}/{len(alive)} responders (threshold {t})"
            + (f", {len(dead)} dropout(s) recovered" if dead else "")
        )
        return secure.dequantize_sum(out, len(alive), self.fp_bits)

    # ------------------------------------------------------------ fold trees
    def _register_tree_meta(self, rnd: _Round, conn: socket.socket, client_id: int, meta) -> bool:
        """Caller holds ``rnd.lock``; the dense and the streamed upload
        share it. Records a relay upload's contributor list, refuses a
        relay that claims another strategy, and adopts a re-homed new id
        as an extra contributor (un-freezing a fold set no fold consumed
        yet; refused once folds did). Returns False when the adoption was
        refused: the connection is closed and the client retries its next
        parent or the next round."""
        sub = meta.get(wire.META_SUBTREE_IDS)
        if sub is not None:
            try:
                rnd.subtree_ids[client_id] = [int(c) for c in sub]
            except (TypeError, ValueError):
                raise wire.WireError(
                    f"malformed {wire.META_SUBTREE_IDS} meta {sub!r} (want a list of client ids)"
                ) from None
        claimed = meta.get(wire.META_STRATEGY)
        if claimed is not None:
            name = claimed.get("name") if isinstance(claimed, dict) else claimed
            if str(name) != self._strategy.name:
                raise wire.WireError(
                    f"relay {client_id} fans down strategy {name!r} but "
                    f"this root runs {self._strategy.name!r}; refusing "
                    "the split-brain round (restart the relay with the "
                    "root's --strategy)"
                )
        if not bool(meta.get(wire.META_REHOMED, False)) or self.secure_agg or self.dp_clip > 0.0:
            # Single-aggregator modes never sit behind a fold tree.
            return True
        if client_id in rnd.done or client_id in rnd.stream.intents or client_id in rnd.adopted:
            # An adopted client's retry: the duplicate rules apply.
            return True
        if not rnd.stream.admit(client_id):
            log.info(
                f"[SERVER] re-homed client {client_id} arrived after "
                "folds began; refusing the adoption (it retries against "
                "its next parent or the next round)"
            )
            conn.close()
            return False
        rnd.adopted.add(client_id)
        log.info(f"[SERVER] adopted re-homed client {client_id} into round {rnd.round_no} as an extra contributor")
        return True

    def _round_quorum(self, cohort: set | None) -> int:
        """The round's upload quorum: ``min_clients``, clamped to a drawn
        cohort but never below 2 under secure aggregation (a one-member
        'sum' is that client's raw update)."""
        quorum = self.min_clients
        if cohort is not None:
            quorum = min(quorum, len(cohort))
        if self.secure_agg:
            quorum = max(2, quorum)
        return quorum

    # ----------------------------------------------------------------- round
    def serve_round(
        self, *, deadline: float | None = None, round_index: int | None = None
    ) -> dict[str, np.ndarray] | None:
        """Accept uploads until every client arrived (or ``deadline``
        seconds passed, default ``timeout``), fold, apply the strategy,
        reply to every contributor. Returns the new global as a flat dict
        (under DP the noised mean delta; None for a no-op round of an
        empty cohort). Raises ``RuntimeError`` when the round fails (below
        quorum, a poisoned or failed fold, a DP base mismatch); its
        connections are closed so clients fail fast. ``round_index``
        replaces the server's own round counter for this round and the
        ones after it (a resumed controller campaign numbers its rounds
        from its state file); the replies' meta and ``last_trace`` carry
        it."""
        if self.reply_via is not None and (self.dp_clip > 0.0 or self.secure_agg):
            raise ValueError(
                "reply_via (the relay tier's parent-forward hook) is "
                "incompatible with central DP (the subtree partial would "
                "be an un-noised release) and secure aggregation (the "
                "unmask protocol needs the single-aggregator shape)"
            )
        rnd = _Round(
            expected=self.num_clients,
            round_no=self._round_counter if round_index is None else int(round_index),
        )
        self._round_counter = rnd.round_no + 1
        self._cur_rnd = rnd
        # The round's trace identity, stamped into every reply's meta:
        # clients adopt it for their own spans.
        rnd.trace = new_trace_id()
        self.last_trace = (rnd.trace, rnd.round_no)
        self._m_rounds.inc()
        t_round_unix = time.time()
        if self.dp_clip > 0.0 and self.dp_participation < 1.0:
            # Each client independently with probability q, from OS
            # entropy: the sampler the subsampled-Gaussian accountant
            # assumes. An empty draw is a legitimate sample (a no-op).
            rnd.cohort = {i for i in range(self.num_clients) if self._dp_rng.random() < self.dp_participation}
            rnd.expected = len(rnd.cohort)
            log.info(f"[SERVER] round {rnd.round_no} Poisson cohort (q={self.dp_participation}): {sorted(rnd.cohort)}")
        # Quorum deployments fold at close: an eager fold commits to the
        # full contributor set, and one mid-stream death would then fail
        # a round the barrier completes over the survivors.
        # A secure round folds nothing (its masked uploads are summed in
        # the ring); its StreamAgg stays empty.
        rnd.stream = StreamAgg(
            device=self.device,
            eager=self.stream_chunk_bytes > 0 and self.min_clients >= self.num_clients and not self.secure_agg,
            base=self._last_agg,
        )
        t0 = time.monotonic()
        deadline = t0 + (self.timeout if deadline is None else deadline)
        futures: list = []
        listener_closed = False
        # Once every cohort upload landed, a missing sitting-out client
        # gets a short grace, not the round's whole deadline.
        uploads_done_at = None
        skip_grace = min(self.key_grace, 10.0)
        while not rnd.complete.is_set() and time.monotonic() < deadline:
            if rnd.cohort is not None:
                with rnd.lock:
                    up_done = len(rnd.done) >= rnd.expected
                    all_done = self._round_done(rnd)
                if up_done and not all_done:
                    if uploads_done_at is None:
                        uploads_done_at = time.monotonic()
                    elif time.monotonic() - uploads_done_at > skip_grace:
                        log.info(
                            "[SERVER] cohort uploads complete; proceeding without the missing "
                            f"sitting-out client(s) after {skip_grace:.0f}s grace"
                        )
                        rnd.complete.set()
                        break
                else:
                    uploads_done_at = None
            try:
                self._sock.settimeout(max(0.05, min(1.0, deadline - time.monotonic())))
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                listener_closed = self._stop.is_set()
                break
            try:
                futures.append(self._pool.submit(self._handle_upload, conn, rnd, deadline))
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
            skip_conns = dict(rnd.skip_conns)
            nonces = dict(rnd.nonces)
            dp_crcs = dict(rnd.dp_crcs)
            secure_models = dict(rnd.secure_models)
            adopted = set(rnd.adopted)
            subtree_ids = {k: list(v) for k, v in rnd.subtree_ids.items()}
        # Failure cleanup covers contributors and sitting-out clients alike.
        all_conns = {**skip_conns, **conns}
        t_agg_unix = time.time()
        t_agg = time.monotonic()
        try:
            if rnd.cohort is not None and not rnd.cohort:
                # Empty Poisson cohort: nothing is aggregated or released;
                # the connected clients are told to keep their base.
                log.info(
                    f"[SERVER] round {rnd.round_no}: empty Poisson cohort — no-op round, "
                    f"replying noop to {len(skip_conns)} client(s)"
                )
                noop_meta = {"round_clients": [], "agg_round": rnd.round_no, "dp_reply": "noop", "trace": rnd.trace}
                if self.stream_chunk_bytes > 0 and not self.secure_agg:
                    noop_meta[wire.META_STREAM] = self.stream_chunk_bytes
                    noop_meta[wire.META_WIRE_DTYPES] = sorted(set(wire.WIRE_DTYPE_ENCS.values()))
                replies = {cid: self._encode_reply({}, noop_meta, nonces.get(cid)) for cid in skip_conns}
                agg_s = time.monotonic() - t_agg
                t_rep = time.monotonic()
                self._m_bytes_out.inc(float(self._reply_all(replies, skip_conns, {})))
                self._finish_round(rnd, t_round_unix, t0, wait_s, agg_s, time.monotonic() - t_rep)
                return None
            quorum = self._round_quorum(rnd.cohort)
            if len(done) < quorum:
                raise RuntimeError(
                    f"only {len(done)}/{self.num_clients} clients arrived "
                    f"(min_clients={self.min_clients}"
                    + (f", cohort {sorted(rnd.cohort)}" if rnd.cohort is not None else "")
                    + ")"
                )
            ids = sorted(done)
            # Missing expected contributors (adopted re-homed ids do not
            # count), and the double-count tripwire: one client in two
            # subtree partials means a re-homed upload was also folded by
            # its surviving old parent; no mean can repair that.
            missing_n = max(0, rnd.expected - len(done - adopted))
            listed = [c for i in ids for c in subtree_ids.get(i, [])]
            if len(listed) != len(set(listed)):
                raise RuntimeError(
                    f"clients {sorted({c for c in listed if listed.count(c) > 1})} appear in more than one "
                    "subtree's contributor record — a re-homed upload "
                    "was double-counted; failing the round"
                )
            stale_resync: dict[int, int] = {}  # client id -> history index
            crc_set: set = set()
            if self.dp_clip > 0.0:
                ids, stale_resync, crc_set = self._dp_partition(rnd, ids, dp_crcs, quorum, all_conns, nonces)
            if self.secure_agg:
                mean = self._aggregate_secure(rnd, ids, secure_models, conns)
            else:
                weights = [n_samples[i] for i in ids] if self.weighted else None
                try:
                    mean = rnd.stream.finalize(ids, weights)
                except wire.WireError as e:
                    raise RuntimeError(f"aggregation failed: {e}") from e
                self.last_fold_stats = rnd.fold_stats = rnd.stream.stats()
                log.info(
                    f"[SERVER] aggregated {len(ids)} models (clients {ids}; "
                    f"{self.last_fold_stats['overlap_frac']:.0%} of fold input consumed "
                    "during the wire phase)"
                )
            self.last_uploads = {i: dict(rnd.uploads[i]) for i in ids}
            self.last_mean = mean
            if self.reply_via is not None:
                # The fold tree: the subtree's mean goes to the parent, and
                # the root's aggregate comes back for this subtree's
                # clients (a parent failure fails the round here).
                mean = {
                    k: np.asarray(v, np.float32)
                    for k, v in self.reply_via(
                        mean,
                        {"ids": list(ids), "n_samples": {i: n_samples[i] for i in ids},
                         "subtree_ids": {i: rnd.subtree_ids[i] for i in ids if i in rnd.subtree_ids},
                         "round": rnd.round_no, "trace": rnd.trace},
                    ).items()
                }
            resync_payloads: dict[int, tuple[dict, int]] = {}
            if self.dp_clip > 0.0:
                agg, reply_meta, resync_payloads = self._dp_release(rnd, ids, mean, crc_set, stale_resync)
            else:
                agg = mean
                if self.reply_via is None:
                    # A relay never transforms: the root already did, and
                    # a subtree partial is not a global.
                    agg = self._strategy.apply(
                        self._last_agg, mean, round_no=rnd.round_no,
                        client_stats=None if self.secure_agg else rnd.stream.client_stats(),
                    )
                    self._m_strategy_rounds(self._strategy.name).inc()
                # The post-strategy global is what clients adopt, so it is
                # the next round's strategy input and sparse-delta base.
                self._last_agg = agg
                self._last_agg_round = rnd.round_no
                self._persist_strategy_state()
                reply_meta = {"round_clients": ids, "agg_round": rnd.round_no, "trace": rnd.trace}
                if self.reply_via is None:
                    reply_meta[wire.META_STRATEGY] = self._strategy.describe()
                if rnd.wants_delta and not self.secure_agg:
                    # The base-agreement stamp: a sparse client adopts the
                    # decoded reply as its delta base only if it hashes to this.
                    reply_meta["agg_crc"] = wire.flat_crc32(agg)
            if self.stream_chunk_bytes > 0 and not self.secure_agg:
                reply_meta[wire.META_STREAM] = self.stream_chunk_bytes
                reply_meta[wire.META_WIRE_DTYPES] = sorted(set(wire.WIRE_DTYPE_ENCS.values()))
            # Sitting-out clients get the identical reply (their bases must
            # track the fleet's), dense.
            replies, stream_jobs = self._build_replies(rnd, ids, agg, reply_meta, nonces, sorted(skip_conns))
            for cid, (sequence, n_rounds) in resync_payloads.items():
                replies[cid] = self._encode_reply(
                    sequence, {**reply_meta, "dp_reply": "resync", "dp_resync_rounds": n_rounds}, nonces.get(cid)
                )
                log.info(f"[SERVER] client {cid} resynced with a catch-up sequence of {n_rounds} retained round delta(s)")
            for cid in stale_resync:
                if cid not in resync_payloads and cid in all_conns:
                    # Unresyncable after all (shape drift mid-window):
                    # close now so the client fails fast.
                    all_conns[cid].close()
        except BaseException:
            for c in all_conns.values():
                c.close()
            self._finish_round(rnd, t_round_unix, t0, wait_s, time.monotonic() - t_agg, 0.0, failed=True)
            raise
        agg_s = time.monotonic() - t_agg
        self.last_assignment = {
            "round": rnd.round_no,
            "groups": [list(subtree_ids[i]) if i in subtree_ids else int(i) for i in ids],
        }
        degraded = missing_n > 0 and rnd.cohort is None and not self.secure_agg
        if degraded:
            # Quorum semantics: the round completed over the survivors.
            # At a parent of relays the missing children are whole
            # subtrees (counted, and their evidence kept in a flight
            # bundle); elsewhere stragglers shed at the local deadline.
            tree_key = "subtree_failures" if subtree_ids else "stragglers_shed"
            with self._totals_lock:
                self.tree_totals[tree_key] += missing_n
                self.tree_totals["degraded_rounds"] += 1
            if subtree_ids:
                self._m_subtree_failures.inc(float(missing_n))
                log.warning(
                    f"[SERVER] round {rnd.round_no} completed DEGRADED: "
                    f"{missing_n} expected subtree(s) never uploaded "
                    f"within the deadline; folded the surviving "
                    f"contributors {ids} (mean renormalized over their mass)"
                )
                recorder = obs_flight.get_global_recorder()
                if recorder is not None:
                    try:
                        recorder.maybe_dump(
                            "subtree-failure",
                            extra={"round": rnd.round_no, "trace": rnd.trace, "expected": rnd.expected,
                                   "missing_subtrees": missing_n, "survivors": [int(i) for i in ids]},
                        )
                    except OSError as e:
                        log.warning(f"[SERVER] subtree-failure postmortem dump failed (non-fatal): {e}")
            else:
                self._m_stragglers_shed.inc(float(missing_n))
        if self.tracer is not None:
            extra: dict = {}
            if degraded:
                extra["missing_subtrees" if subtree_ids else "stragglers_shed"] = missing_n
            if adopted:
                extra["adopted"] = sorted(int(i) for i in adopted)
            if subtree_ids:
                extra["assignment"] = self.last_assignment["groups"]
            if self.dp_clip <= 0.0 and self.reply_via is None:
                # Which strategy produced this round's global.
                extra["strategy"] = self._strategy.name
                s_params = self._strategy.params()
                if s_params:
                    extra["strategy_params"] = {k: s_params[k] for k in sorted(s_params)}
            self.tracer.record(
                "agg",
                t_start=t_agg_unix,
                dur_s=agg_s,
                trace=rnd.trace,
                round=rnd.round_no,
                clients=len(ids),
                contributors=[int(i) for i in ids],
                **extra,
            )
        t_rep_unix = time.time()
        t_rep = time.monotonic()
        out_bytes = self._reply_all(replies, all_conns, stream_jobs)
        reply_s = time.monotonic() - t_rep
        if stream_jobs:
            with self._totals_lock:
                self.stream_totals["stream_replies"] += len(stream_jobs)
            self._m_stream_replies.inc(float(len(stream_jobs)))
        self._m_bytes_out.inc(float(out_bytes))
        if self.tracer is not None:
            self.tracer.record(
                "wire-reply",
                t_start=t_rep_unix,
                dur_s=reply_s,
                trace=rnd.trace,
                round=rnd.round_no,
                replies=len(replies) + len(stream_jobs),
            )
        self._finish_round(rnd, t_round_unix, t0, wait_s, agg_s, reply_s)
        return agg

    # -------------------------------------------------------- central DP
    def _dp_partition(
        self, rnd: _Round, ids: list[int], dp_crcs: dict[int, int], quorum: int, conns: dict, nonces: dict
    ) -> tuple[list[int], dict[int, int], set]:
        """Split the round's uploads into the current-base contributors and
        the stale but resyncable ones (their base crc is a retained
        round's). Returns ``(contributors, {stale id: history index},
        {the agreed base crc})``; raises when the current clients disagree
        on their base, or (after healing the stale ones with the retained
        rounds alone) when too few current clients remain."""
        stale_resync: dict[int, int] = {}
        if self.compression == "none" and not self.secure_agg:
            # Latest entry wins on a crc collision. (A masked upload cannot
            # be left out of the ring sum: no resync under secure DP.)
            hist_index = {crc: j for j, (crc, _) in enumerate(self._dp_history)}
            stale_resync = {i: hist_index[dp_crcs[i]] for i in ids if dp_crcs[i] in hist_index}
        current = [i for i in ids if i not in stale_resync]
        if not current and stale_resync and len({dp_crcs[i] for i in stale_resync}) == 1:
            # Every upload agrees on a retained base: the deltas released
            # past it reached nobody (a fleet-wide missed reply), so the
            # consensus IS the fleet's base.
            log.info("[SERVER] all uploads share a retained base crc (fleet-wide missed reply); treating the consensus as current")
            current, stale_resync = sorted(stale_resync), {}
        crc_set = {dp_crcs[i] for i in current}
        if not current or len(crc_set) != 1:
            raise RuntimeError(
                "DP round base mismatch: clients disagree on the "
                f"round base (crcs per client: "
                f"{ {i: f'{dp_crcs[i]:#010x}' for i in ids} }) — "
                "every client must start the round from the same "
                "adopted aggregate / shared init (stale clients "
                f"resync only within the last {self.dp_resync_rounds} "
                "retained round(s) of this server process)"
            )
        if stale_resync:
            if len(current) < quorum:
                # The round cannot proceed, but the stale clients are healed
                # now with the retained rounds alone; they rejoin the
                # current base next round, which then meets quorum.
                self._heal_stale_clients(rnd, stale_resync, conns, nonces)
                raise RuntimeError(
                    f"only {len(current)} current-base clients "
                    f"uploaded (stale: {sorted(stale_resync)}, "
                    "served catch-up sequences), below the quorum "
                    f"of {quorum} — retrying clients complete the "
                    "next round from the common base"
                )
            log.info(
                f"[SERVER] clients {sorted(stale_resync)} declared stale round bases; excluding their "
                f"uploads and serving composed catch-up deltas (contributors: {current})"
            )
        return current, stale_resync, crc_set

    def _dp_release(
        self, rnd: _Round, ids: list[int], mean: dict, crc_set: set, stale_resync: dict[int, int]
    ) -> tuple[dict, dict, dict[int, tuple[dict, int]]]:
        """The Gaussian mechanism on the mean of the clipped deltas:
        ``(noised mean delta, reply meta, resync payloads)``. Retains the
        release for the resync window and composes each stale client's
        catch-up sequence."""
        n = len(ids)
        sigma = self.dp_noise_multiplier * self.dp_clip / n
        agg = {k: np.asarray(v, np.float32) for k, v in mean.items()}
        if sigma > 0.0:
            # fp32 draws (no model-sized float64 intermediate).
            agg = {
                k: v + self._dp_rng.standard_normal(np.shape(v), dtype=np.float32) * np.float32(sigma)
                for k, v in agg.items()
            }
        log.info(
            f"[SERVER] central DP: mean of {n} clipped deltas (clip {self.dp_clip}) "
            f"+ Gaussian noise std {sigma:.3g}/coordinate"
        )
        base_crc = next(iter(crc_set))
        # dp_base_crc: the base this delta applies to; a receiver on
        # another base (stale, sitting out) keeps its own.
        reply_meta = {"agg_round": rnd.round_no, "trace": rnd.trace, "dp_reply": "delta", "dp_base_crc": base_crc}
        if rnd.cohort is None:
            # Under cohort sampling who was sampled stays out of the
            # replies (amplification assumes the adversary cannot
            # condition on it); with everyone in, it is public anyway.
            reply_meta["round_clients"] = ids
        resync_payloads: dict[int, tuple[dict, int]] = {}
        if self.compression == "none" and not self.secure_agg:
            # An exactly-zero delta is not retained: its base crc would
            # equal every current client's next declaration.
            if any(np.any(v) for v in agg.values()):
                self._dp_history.append((base_crc, agg))
            for cid, j in stale_resync.items():
                # Every retained delta from the client's base forward (this
                # round's included), as a SEQUENCE: the client replays the
                # fleet's fp32 additions in order; a pre-summed delta
                # would land ulps away.
                entries = [d for _, d in self._dp_history[j:]]
                if not all(wire.shapes_compatible(d, agg) for d in entries):
                    log.info(f"[SERVER] client {cid} cannot resync: retained deltas changed shape mid-window")
                    continue
                resync_payloads[cid] = ({str(i): wire.unflatten_params(d) for i, d in enumerate(entries)}, len(entries))
            # Trim after composing: the stale indices address the untrimmed list.
            if len(self._dp_history) > self.dp_resync_rounds:
                del self._dp_history[: len(self._dp_history) - self.dp_resync_rounds]
            self._persist_dp_history()
        return agg, reply_meta, resync_payloads

    def _heal_stale_clients(self, rnd: _Round, stale_resync: dict[int, int], conns: dict, nonces: dict) -> None:
        """Serve catch-up sequences of retained deltas to the stale clients
        of a round about to fail (no new delta exists); send failures are
        logged and ignored."""
        for cid, j in stale_resync.items():
            conn = conns.get(cid)
            entries = [d for _, d in self._dp_history[j:]]
            if conn is None or not entries or not all(wire.shapes_compatible(d, entries[0]) for d in entries):
                continue
            try:
                conn.settimeout(min(self.timeout, 30.0))
                framing.send_frame(
                    conn,
                    self._encode_reply(
                        {str(i): wire.unflatten_params(d) for i, d in enumerate(entries)},
                        {
                            "agg_round": rnd.round_no,
                            "trace": rnd.trace,
                            "dp_reply": "resync",
                            "dp_resync_rounds": len(entries),
                        },
                        nonces.get(cid),
                    ),
                )
                log.info(f"[SERVER] client {cid} healed with a catch-up sequence of {len(entries)} retained round delta(s)")
            except (OSError, wire.WireError) as e:
                log.info(f"[SERVER] catch-up for client {cid} failed: {e}")

    def _load_dp_history(self) -> None:
        """Reload the persisted resync window. A missing file is a fresh
        deployment; a corrupt one is logged and gives an empty window (the
        server must come up)."""
        try:
            with np.load(self.dp_history_path, allow_pickle=False) as z:
                index = json.loads(bytes(z["__index__"].tobytes()).decode())
                self._dp_history = [
                    (
                        int(entry["crc"]),
                        {k: np.asarray(z[f"e{i}_{j}"], np.float32) for j, k in enumerate(entry["keys"])},
                    )
                    for i, entry in enumerate(index)
                ]
            log.info(f"[SERVER] reloaded {len(self._dp_history)} retained DP round delta(s) from {self.dp_history_path}")
        except FileNotFoundError:
            pass
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            log.warning(
                f"[SERVER] could not reload DP resync history from {self.dp_history_path} "
                f"({e}); starting with an empty window"
            )
            self._dp_history = []

    def _persist_dp_history(self) -> None:
        """Queue the window for the background writer (latest snapshot
        wins: a slow disk skips intermediate windows)."""
        if not self.dp_history_path:
            return
        snap = list(self._dp_history)
        with self._dp_persist_lock:
            self._dp_persist_pending = snap
            if self._dp_persist_thread is None or not self._dp_persist_thread.is_alive():
                self._dp_persist_thread = threading.Thread(target=self._dp_persist_loop, daemon=True)
                self._dp_persist_thread.start()

    def _dp_persist_loop(self) -> None:
        while True:
            with self._dp_persist_lock:
                snap = self._dp_persist_pending
                self._dp_persist_pending = None
                if snap is None:
                    self._dp_persist_thread = None
                    return
            self._write_dp_history(snap)

    def _write_dp_history(self, history: list[tuple[int, dict]]) -> None:
        """One atomic snapshot (tmp + replace) in the JAX package's layout:
        a JSON ``__index__`` (per entry its base crc and leaf key order)
        and the leaves as fp32 ``e{i}_{j}``."""
        index = [{"crc": int(crc), "keys": list(d)} for crc, d in history]
        arrays: dict[str, np.ndarray] = {"__index__": np.frombuffer(json.dumps(index).encode(), dtype=np.uint8)}
        for i, (_, d) in enumerate(history):
            for j, k in enumerate(d):
                arrays[f"e{i}_{j}"] = np.asarray(d[k], np.float32)
        tmp = self.dp_history_path + ".tmp"
        try:
            os.makedirs(os.path.dirname(os.path.abspath(tmp)) or ".", exist_ok=True)
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, self.dp_history_path)
        except OSError as e:
            log.warning(f"[SERVER] could not persist DP resync history to {self.dp_history_path}: {e}")

    def _finish_round(
        self, rnd: _Round, t_unix: float, t0: float, wait_s: float, agg_s: float, reply_s: float, *, failed: bool = False
    ) -> None:
        """Close a round's observability: the wait/agg/reply seconds (the
        process totals and the /metrics counters), the round histogram,
        the post-aggregate memory watermark, the fold's gauges and its
        ``wire-overlap`` span when folds overlapped the wire, the round
        span, and on failure the counter and a flight-recorder bundle."""
        round_wall = time.monotonic() - t0
        for name, dur in (("wait", wait_s), ("agg", agg_s), ("reply", reply_s)):
            self.phase_seconds[name] += dur
            self._m_phase[name].inc(max(dur, 0.0))
        self._h_round.observe(max(round_wall, 0.0))
        # The fold ran on this server's device (K4 on the card).
        note_memory("post-aggregate")
        if failed:
            self._m_round_failures.inc()
        s = rnd.fold_stats
        if s is not None:
            with self._totals_lock:
                self.stream_totals["peak_agg_bytes"] = max(self.stream_totals["peak_agg_bytes"], int(s["peak_bytes"]))
            self._g_peak_agg.set(float(s["peak_bytes"]))
            if s["fold_s"] > 0.0:
                self._g_fold_throughput.set(float(s["fold_throughput_gbps"]))
            if self.tracer is not None and s["early_s"] > 0.0:
                # Fold work that ran DURING the wait phase (hidden behind
                # other clients' transfers).
                dtypes = sorted({u["wire_dtype"] for u in rnd.uploads.values() if u.get("shape") == "stream"})
                self.tracer.record(
                    "wire-overlap",
                    t_start=t_unix,
                    dur_s=s["early_s"],
                    trace=rnd.trace,
                    round=rnd.round_no,
                    folded_bytes=s["early_bytes"],
                    overlap_frac=round(s["overlap_frac"], 4),
                    peak_agg_bytes=s["peak_bytes"],
                    fold_engine=s["fold_engine"],
                    fold_throughput_gbps=round(s["fold_throughput_gbps"], 3),
                    wire_dtypes=dtypes or None,
                )
        if self.tracer is not None:
            self.tracer.record(
                "round",
                t_start=t_unix,
                dur_s=round_wall,
                trace=rnd.trace,
                round=rnd.round_no,
                failed=True if failed else None,
            )
        if failed:
            # After the round span, so the bundle's ring holds the failure.
            recorder = obs_flight.get_global_recorder()
            if recorder is not None:
                try:
                    recorder.maybe_dump(
                        "round-failure",
                        extra={
                            "round": rnd.round_no,
                            "trace": rnd.trace,
                            "expected": rnd.expected,
                            "wall_s": round(round_wall, 3),
                        },
                    )
                except OSError as e:
                    log.warning(f"[SERVER] postmortem dump failed (non-fatal): {e}")

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
        self,
        rnd: _Round,
        ids: list[int],
        agg: dict,
        reply_meta: dict,
        nonces: dict[int, str],
        dense_extra: list[int] = (),
    ) -> tuple[dict[int, bytes], dict[int, tuple[bytes, dict, bytes]]]:
        """The round's dense reply blobs and streamed-reply jobs. A
        contributor that advertised streamed replies gets the stream (in
        the ``reply_dtype`` encoding when it advertised that); the payload
        chunks of each encoding are built once and shared. ``dense_extra``
        (the sitting-out clients) get the dense reply."""
        stream_ids = (
            [cid for cid in ids if cid in rnd.stream_replies]
            if self.stream_chunk_bytes > 0 and not self.secure_agg
            else []
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
        dense_ids = [c for c in ids if c not in stream_ids] + list(dense_extra)
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

    def _send_stream_reply(self, conn: socket.socket, header: bytes, plan: dict, nonce: bytes) -> int:
        """ACKed header, fire-and-forget chunks, ACKed trailer, each under
        the reply direction's tag domain. Returns the frame bytes sent."""
        framing.send_frame(conn, header)
        sent = len(header)
        for seq, chunk in enumerate(plan["chunks"]):
            frame = wire.encode_stream_chunk(seq, chunk, auth_key=self.auth_key, nonce=nonce, direction="down")
            framing.send_frame(conn, frame, await_ack=False)
            sent += len(frame)
        trailer = wire.encode_stream_end(len(plan["chunks"]), auth_key=self.auth_key, nonce=nonce, direction="down")
        framing.send_frame(conn, trailer)
        return sent + len(trailer)

    def _reply_all(
        self,
        replies: dict[int, bytes],
        conns: dict[int, socket.socket],
        stream_jobs: dict[int, tuple[bytes, dict, bytes]],
    ) -> int:
        """Parallel fan-out: ``send_frame`` waits for each client's ACK,
        so one dead client must not stall the healthy ones behind it.
        Returns the reply frame bytes that went out."""
        sent: dict[int, int] = {}

        def _reply(cid: int, conn: socket.socket) -> None:
            try:
                if cid in stream_jobs:
                    sent[cid] = self._send_stream_reply(conn, *stream_jobs[cid])
                else:
                    framing.send_frame(conn, replies[cid])
                    sent[cid] = len(replies[cid])
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
        return sum(sent.values())

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
