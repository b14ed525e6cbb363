"""Round-scoped trace contexts: span records on a unified events-JSONL (the
port's copy of the JAX package's ``obs/trace.py``: the same schema, run id
rule, wire meta key and ``SPAN_NAMES``, so a round with JAX and port peers
merges into one timeline).

The per-tier metrics-JSONL streams (reporting.append_metrics_jsonl) are
uncorrelated — no shared round/span identity crosses the wire, so nobody
can answer "where did round N's wall-clock go: client compute, straggler
wait, wire transfer, eval gate, or promotion?". This module is the shared
identity layer:

* the **server** mints one ``trace`` id per round (:func:`new_trace_id`)
  and stamps it into every reply's free-form wire ``meta`` (comm/wire.py
  — the format itself is unchanged, so old peers that omit the field
  still interop byte-for-byte);
* every process appends :class:`Span` records to its own events-JSONL
  through a :class:`Tracer` — one JSON object per line, written with a
  single atomic ``os.write`` append so concurrent writers (server round
  thread + reply fan-out threads) can never interleave partial lines;
* ``fedtpu obs`` (obs/timeline.py) merges the per-process files on the
  (trace, round) key into a per-round timeline and a Chrome trace-event
  export.

Span vocabulary (names are the contract the timeline tool groups by)::

    round         one aggregation round, server side (contains agg/reply)
    client-local  a client's local training phase
    wire-upload   a client's model upload send (streamed uploads carry
                  ``chunks`` + ``overlap_s``: pack/send seconds hidden by
                  running the two concurrently)
    wire-overlap  server-side: aggregation folds that ran DURING the wire
                  phase (streaming chunk aggregation) — overlapped wire
                  time, with ``overlap_frac`` and ``peak_agg_bytes``
    agg           the server's EXPOSED aggregation compute
    wire-reply    the reply transfer (server: fan-out; client: recv)
    batch-prefetch  a client's next-round input-pipeline work that ran
                  under the reply wait (train/batches.EpochPrefetcher)
    relay-forward a relay's upward exchange window (comm/relay.py): the
                  subtree partial going up + the root aggregate coming
                  back, with ``parent_trace``/``parent_round`` linking
                  this subtree round to the parent tier's round
    eval-gate     the controller's held-out eval + gate decision
    promote       a registry state transition / pointer swap
    serve-batch   one coalesced scoring dispatch on the serving tier
                  (``sampled_batches`` when span sampling is on)
    router-forward  one request's trip through the serving router
                  (router/core.py): send-to-replica -> reply-rewritten,
                  with ``replica`` + ``inflight`` (``sampled_requests``
                  when span sampling is on)
    replica-drain one replica's drain -> hot-swap -> readmit cycle of a
                  rolling fleet reload (router/fleet.py), with
                  ``replica``/``artifact``/``drained``
    slo-eval      one scrape-hub pass over the fleet's /metrics.json +
                  burn-rate evaluation (obs/fleet.py), with ``targets``/
                  ``up``/``firing``/``scrape_lag_ms``
    postmortem-dump  a flight-recorder bundle write (obs/flight.py),
                  with ``reason``/``bundle``/``spans``
    drift-trigger the controller's drift verdict that started a round
                  (control/controller.py), with the distance, method,
                  and ``top_bins`` per-bin PSI localization
    xla-compile   one XLA trace+compile of a jitted program (on the port:
                  the first dispatch of a shape signature at a site)
                  (obs/profile.py CompileLedger), with ``site``/
                  ``signature`` and ``recompile=True`` when the shape
                  appeared at an already-warm site (the flagged event
                  that can trip the flight recorder)
    shadow-mirror a sampled live request duplicated onto the shadow
                  backend (shadow/mirror.py), counter-strided like
                  serve-batch spans, with the running ``mirrored`` count
    shadow-compare one completed serving/shadow probability pair's
                  running disagreement stats (shadow/compare.py), with
                  ``pairs``/``flip_rate``/``psi``
    shadow-gate   the controller's live disagreement verdict for a
                  shadow-state candidate (shadow/gate.py), with
                  ``artifact``/``passed``/``pairs``/``flip_rate``/``psi``
    label-join    one deterministic join of scored-request records
                  against the ground-truth journal (labels/join.py),
                  with ``total``/``joined``/``coverage``
    label-gate    the controller's SUPERVISED verdict for a shadow-state
                  candidate over joined ground truth (labels/join.py),
                  with ``artifact``/``passed``/``joined``/``coverage``/
                  ``serving_error``/``candidate_error``
    canary-probe  one sentinel canary pass through the live serving
                  chain (obs/sentinel.py), with ``probes``/``failures``/
                  ``mismatches``/``flips``/``artifact``/
                  ``latency_p99_ms``
    sentinel-eval one full sentinel tick over every configured rung
                  (obs/sentinel.py), with ``tick``/``canary_incidents``/
                  ``drift_fired``/``regressions``
    regression-fire  a long-horizon trend regression against the pinned
                  baseline window (obs/sentinel.py RetentionRing), with
                  ``field``/``baseline``/``now_mean``/``ratio``/
                  ``direction``

Timestamps are wall-clock unix seconds (``ts``) with a separately
measured monotonic duration (``dur_s``): cross-process correlation needs
a shared clock, phase arithmetic needs one that never steps backwards.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

from .flight import get_global_recorder

#: Every span record carries this so stream consumers can reject (or
#: version-switch on) foreign JSONL lines when files get concatenated.
SCHEMA = "fedtpu-obs-v1"

#: The span-name vocabulary (documentation + timeline-tool contract; the
#: writer does not enforce membership — new tiers may add names).
SPAN_NAMES = (
    "round",
    "client-local",
    "wire-upload",
    "wire-overlap",
    "agg",
    "wire-reply",
    "batch-prefetch",
    "relay-forward",
    "eval-gate",
    "promote",
    "serve-batch",
    "router-forward",
    "replica-drain",
    "slo-eval",
    "postmortem-dump",
    "drift-trigger",
    "xla-compile",
    "shadow-mirror",
    "shadow-compare",
    "shadow-gate",
    "label-join",
    "label-gate",
    "canary-probe",
    "sentinel-eval",
    "regression-fire",
)

#: Wire meta key the trace id rides under (comm/server.py reply meta,
#: serving/protocol.py request/reply bodies). Optional everywhere. The
#: JAX package's ``TRACE_META_KEY``; the port names its meta keys
#: ``META_*``, as comm/wire.py does.
META_TRACE = "trace"

_RUN_LOCK = threading.Lock()
_RUN_ID: str | None = None


def new_trace_id() -> str:
    """64 random bits of hex — one per round, minted by the round owner."""
    return os.urandom(8).hex()


def get_run_id() -> str:
    """Process-wide run id stamped on every span AND every metrics-JSONL
    record (reporting.append_metrics_jsonl), so `fedtpu obs` and the drift
    monitor can merge streams from several runs without guessing.
    FEDTPU_RUN_ID (or :func:`set_run_id` — the ObsConfig.run_id hook)
    pins it across processes of one deployment."""
    global _RUN_ID
    with _RUN_LOCK:
        if _RUN_ID is None:
            _RUN_ID = os.environ.get("FEDTPU_RUN_ID") or os.urandom(4).hex()
        return _RUN_ID


def set_run_id(run_id: str) -> None:
    """Pin the process run id (how ObsConfig.run_id takes effect — the
    CLI calls this before the first span/metrics record is written)."""
    global _RUN_ID
    with _RUN_LOCK:
        _RUN_ID = str(run_id)


_FD_LOCK = threading.Lock()
_FDS: dict[str, int] = {}


def _append_fd(path: str) -> int:
    """Long-lived O_APPEND descriptor per path (makedirs + open once,
    not per record — the serving tier appends per coalesced batch).
    O_APPEND atomicity is a property of the write, not of a fresh open.
    Trade-off: external rotation of a live file keeps writes going to
    the rotated inode — give each run its own file (the documented
    layout) rather than rotating one in place."""
    path = os.path.abspath(path)
    with _FD_LOCK:
        fd = _FDS.get(path)
        if fd is None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            _FDS[path] = fd
        return fd


def append_jsonl_line(path: str, line: str) -> None:
    """One ATOMIC append: a single ``os.write`` of the whole line on an
    ``O_APPEND`` descriptor. Python's buffered ``open(path, "a").write``
    can flush a long line in several syscalls, and two threads' partial
    flushes interleave into unparseable garbage — exactly what the
    multi-threaded server and serving tiers would do to a shared
    stream."""
    data = line.encode()
    if not data.endswith(b"\n"):
        data += b"\n"
    os.write(_append_fd(path), data)


class Tracer:
    """Append-only span writer for ONE process/role.

    ``proc`` names the emitting role (``server``, ``client-0``,
    ``controller``, ``registry``, ``serve``, ``fed``); the timeline tool
    uses it as the per-lane identity, so give every process a distinct
    value. A Tracer is thread-safe by construction (each record is one
    atomic append; no shared mutable state beyond the path)."""

    def __init__(self, path: str, *, proc: str, run_id: str | None = None):
        self.path = path
        self.proc = str(proc)
        self.run_id = run_id or get_run_id()

    def record(
        self,
        name: str,
        *,
        t_start: float,
        dur_s: float,
        trace: str | None = None,
        round: int | None = None,
        **attrs: Any,
    ) -> dict:
        """Write one finished span. ``t_start`` is unix seconds,
        ``dur_s`` a monotonic-measured duration. Returns the record."""
        rec: dict[str, Any] = {
            "schema": SCHEMA,
            "run_id": self.run_id,
            "proc": self.proc,
            "span": str(name),
            "ts": float(t_start),
            "dur_s": float(dur_s),
        }
        if trace is not None:
            rec["trace"] = str(trace)
        if round is not None:
            rec["round"] = int(round)
        for k, v in attrs.items():
            if v is not None:
                rec[k] = v
        append_jsonl_line(self.path, json.dumps(rec))
        # Flight recorder tap (obs/flight.py): every traced process
        # keeps its recent spans in the postmortem ring for free — one
        # deque append when a recorder is installed, nothing otherwise.
        recorder = get_global_recorder()
        if recorder is not None:
            recorder.note_span(rec)
        return rec

    @contextmanager
    def span(
        self,
        name: str,
        *,
        trace: str | None = None,
        round: int | None = None,
        **attrs: Any,
    ) -> Iterator[dict]:
        """Measure a block and write the span on exit. The yielded dict
        may be mutated inside the block — in particular ``trace`` and
        ``round`` may be filled in late (a client learns the round's
        trace id only from the reply meta)."""
        info: dict[str, Any] = {"trace": trace, "round": round, **attrs}
        t_unix = time.time()
        t0 = time.monotonic()
        try:
            yield info
        finally:
            dur = time.monotonic() - t0
            trace = info.pop("trace", None)
            rnd = info.pop("round", None)
            self.record(
                name, t_start=t_unix, dur_s=dur, trace=trace, round=rnd, **info
            )


@contextmanager
def maybe_span(
    tracer: Tracer | None, name: str, **kw: Any
) -> Iterator[dict]:
    """``tracer.span(...)`` that degrades to a no-op when tracing is off —
    call sites stay one-liners with no ``if tracer is not None`` forest."""
    if tracer is None:
        yield {}
    else:
        with tracer.span(name, **kw) as info:
            yield info


_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Tracer | None = None


def set_global_tracer(tracer: Tracer | None) -> None:
    """Install a process-wide tracer for call sites with no injection
    path (the mesh-tier trainers); CLI commands set it once at startup."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = tracer


def get_global_tracer() -> Tracer | None:
    with _GLOBAL_LOCK:
        return _GLOBAL
