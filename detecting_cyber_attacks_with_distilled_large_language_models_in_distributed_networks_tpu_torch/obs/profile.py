"""Device performance plane: dispatch ledger, phase records, step
attribution, watermarks (the port of the JAX package's ``obs/profile.py``
to PyTorch and CUDA).

* **Phase records** — the port's own piece, with no JAX counterpart: one
  bounded in-memory log a site (:class:`PhaseLog`, read through
  :func:`phase_records`) that holds one :class:`PhaseRecord` a call of a
  hot path: the site, a sequence number, the id of the owning object, the
  call's start stamp and the end stamp of each phase in order. Phases are
  contiguous, so their durations sum to the call. Two sites record:
  ``engine.train_step`` (``Trainer``'s step: ``place`` the batch on the
  device, ``forward`` with the loss, ``backward``, ``optimizer``) and
  ``serving.score`` (``ScoreEngine.score``: ``prep`` the padded bucket and
  its copies to the device, ``dispatch`` the forward and softmax, ``wait``
  for the probabilities on the host). A phase is host time: the Python
  time that queues the phase's kernels, or (``wait``) blocks on the card.
  Stamps are integer nanoseconds of :func:`phase_clock`, the Unix-time
  clock ``torch.profiler`` stamps its events with, so a record lines up
  with a profile's ranges and kernels without conversion. Always on: a
  call pays a few clock reads and one append, and emits no
  ``record_function`` range (nothing enters a device trace), no span and
  no metric.

Four pieces are each the counterpart of the JAX one:

* :class:`CompileLedger` — per-site accounting of the shapes a hot path
  runs. PyTorch runs eagerly, so there is no trace or compile per shape:
  the port's ledger counts the **first dispatch of each (site, shape
  signature)**, and that first call's wall seconds (which include the
  kernel library's load, the cuBLAS handle and the allocator's growth)
  stand where the JAX ledger puts trace+compile seconds. The API, the
  ``xla-compile`` span, the recompile event after :meth:`mark_warm` (and
  the flight-recorder trip it offers) and the ``fedtpu_xla_compiles_total``
  / ``fedtpu_xla_recompiles_total`` / ``fedtpu_xla_trace_seconds``
  families keep their JAX names, so one dashboard reads both packages.
* :class:`StepProfiler` — deterministically strided fenced step timers:
  every Nth step is split into host batch-prep / dispatch (the Python
  time that enqueues the step's kernels, taken from the call's phase
  record where its site keeps one) / device (the wait in
  ``torch.cuda.synchronize`` on the value's device after the dispatch
  returned: the part of the card's work the host did not overlap, not
  the card's busy time; a CPU value needs no fence; the name is the JAX
  package's), observed into ``fedtpu_train_step_seconds`` /
  ``fedtpu_score_step_seconds`` / ``fedtpu_wire_step_seconds`` histograms
  and stamped as attrs on the train-phase spans. Stride 0 (the default)
  is the zero-overhead path: one attribute check per step, no fence, no
  timer read, no metric registration.
* **Memory watermarks** — :func:`note_memory` snapshots the CUDA caching
  allocator at phase boundaries (post-restore, post-first-step,
  post-round, post-aggregate) into peak-bytes gauges: ``bytes_in_use``
  is ``allocated_bytes.all.current`` and the peak
  ``allocated_bytes.all.peak`` (ALLOCATED bytes, the tensors alive, not
  the allocator's reserved segments), ``bytes_limit`` the card's total
  memory. "Unavailable" on the CPU, and in a process that has not
  initialized CUDA (no context is created for the answer).
* **FLOPs cross-check** — :func:`counted_flops` runs one call under
  ``torch.utils.flop_counter.FlopCounterMode`` (the JAX package's
  ``xla_cost_flops``, which reads XLA's cost model) so the analytic
  ``train_step_flops`` behind the MFU figure is held against what torch
  dispatched (:data:`FLOPS_RATIO_TOLERANCE`).

``run_profile_session`` drives all four end to end (the implementation
behind ``obs profile``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, NamedTuple

from .metrics import MetricsRegistry, default_registry

#: Counted-vs-analytic FLOPs ratio bounds (the JAX package's, unchanged).
#: The counter sees the same 2·M·N·K per matmul the analytic model
#: counts; it cannot see a kernel launched outside torch's dispatcher
#: (the flash kernels K1-K3, launched through ctypes), so on the card the
#: attention score and value contractions drop out (about 2.7% of a
#: DistilBERT-base step at L=128). [0.5, 2.0] flags a real divergence (a
#: wrong model config, a broken backward) without flaking on that.
FLOPS_RATIO_TOLERANCE = (0.5, 2.0)

#: First-dispatch wall-time histogram edges: 10 ms (a warm CPU op) to
#: minutes (a cold card loading its kernel libraries).
TRACE_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 300.0)

#: Step-phase histogram edges: 100 µs host prep to multi-second steps.
STEP_BUCKETS = (
    1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
)

#: StepProfiler site -> /metrics histogram family (one literal per
#: family, registered from this module only). The "wire" site covers the
#: TCP client's streamed-upload leaf encode and streamed-reply leaf
#: decode loops.
_STEP_FAMILIES = {
    "train": "fedtpu_train_step_seconds",
    "score": "fedtpu_score_step_seconds",
    "wire": "fedtpu_wire_step_seconds",
}

#: Per-site phase vocabulary: the train/score sites split a step into
#: host/dispatch/device; the wire site times one leaf's encode or decode
#: as a single "wire" phase (direction comes from the span the attrs
#: land on: wire-upload = pack, wire-reply = unpack).
_SITE_PHASES = {
    "wire": ("wire",),
}

#: The part of a call's phase record each StepProfiler phase samples, by
#: StepProfiler site (None: the whole call).
_RECORD_SAMPLES = {
    "train": (("dispatch", None),),
    "score": (("host", "prep"), ("dispatch", "dispatch")),
}


# ------------------------------------------------------------- phase records
#: Records a site's log keeps, the oldest dropped first: minutes of
#: back-to-back steps or calls.
PHASE_LOG_LEN = 16_384

#: The clock of every phase stamp: Unix time in integer nanoseconds, the
#: clock of ``torch.profiler``'s events (``start_ns()``), so a record and a
#: profile's ranges compare without conversion.
phase_clock = time.time_ns


class PhaseRecord(NamedTuple):
    """One call of a recording site. ``ends_ns[i]`` is where
    ``phases[i]`` ends; each phase starts where the one before it ends,
    the first at ``start_ns``."""

    site: str
    seq: int  # the site's call count before this call
    owner: int  # id() of the object whose call it was
    start_ns: int
    ends_ns: tuple[int, ...]
    phases: tuple[str, ...]

    @property
    def end_ns(self) -> int:
        return self.ends_ns[-1]

    @property
    def call_ns(self) -> int:
        return self.ends_ns[-1] - self.start_ns

    def phase_ns(self) -> dict[str, int]:
        """Each phase's duration in order; they sum to :attr:`call_ns`."""
        bounds = (self.start_ns, *self.ends_ns)
        return {p: b - a for p, a, b in zip(self.phases, bounds, bounds[1:])}


_new_tuple = tuple.__new__


class PhaseLog:
    """One site's bounded record log. :meth:`record` takes no lock: a
    ``deque`` append under a ``maxlen`` and ``next`` on an
    ``itertools.count`` are each atomic under the GIL, so threads that
    call one site share its log."""

    def __init__(self, site: str, phases: tuple[str, ...], maxlen: int = PHASE_LOG_LEN):
        self.site = str(site)
        self.phases = tuple(phases)
        self._records: deque[PhaseRecord] = deque(maxlen=int(maxlen))
        self._append = self._records.append
        self._seq = itertools.count()

    @property
    def maxlen(self) -> int:
        return self._records.maxlen

    def record(self, owner: Any, start_ns: int, ends_ns: tuple[int, ...]) -> PhaseRecord:
        """Append the record of one call of ``owner`` (the stamps are
        :func:`phase_clock` reads, one a phase end) and return it."""
        # tuple.__new__ skips the named tuple's Python-level __new__.
        rec = _new_tuple(PhaseRecord, (self.site, next(self._seq), id(owner), start_ns, ends_ns, self.phases))
        self._append(rec)
        return rec

    def records(self) -> list[PhaseRecord]:
        # list() of a deque runs in C without giving up the GIL: a
        # consistent copy while other threads append.
        return list(self._records)


_PHASE_LOGS_LOCK = threading.Lock()
_PHASE_LOGS: dict[str, PhaseLog] = {}


def phase_log(site: str, phases: tuple[str, ...]) -> PhaseLog:
    """The process-wide log of ``site``, made on first use; a site's
    phases never change."""
    with _PHASE_LOGS_LOCK:
        log = _PHASE_LOGS.get(site)
        if log is None:
            log = _PHASE_LOGS[site] = PhaseLog(site, phases)
        elif log.phases != tuple(phases):
            raise ValueError(f"site {site!r} records phases {log.phases}, not {tuple(phases)}")
        return log


def phase_records(site: str) -> list[PhaseRecord]:
    """A copy of ``site``'s records, oldest first ([] for a site that
    has recorded nothing)."""
    log = _PHASE_LOGS.get(site)
    return log.records() if log is not None else []


# ------------------------------------------------------------ compile ledger
class _Site:
    """Per-site ledger state (guarded by the owning ledger's lock)."""

    __slots__ = (
        "name", "sigs", "trace_s", "warm", "timed", "fresh", "gen",
        "inflight",
    )

    def __init__(self, name: str):
        self.name = name
        self.sigs: dict[Any, int] = {}  # signature -> note count
        self.trace_s: dict[Any, float] = {}  # signature -> wall seconds
        self.warm = False
        self.timed = False  # a timed() wrapper owns span emission
        self.fresh: list[tuple[Any, bool]] = []  # (sig, recompile) in-flight
        self.gen = 0  # bumps per note — the timed wrapper's cheap check
        self.inflight = 0  # wrapper calls currently executing


class CompileLedger:
    """First dispatches per (site, shape-signature), with recompile
    flagging.

    Two touch points per hot path, as in the JAX package:

    * ``note = ledger.hook("tier.step")`` returns the callable that
      records one signature (``note(signature)``);
    * ``fn = ledger.timed("tier.step", fn, signature=sig_of)`` wraps a
      callable: a call whose ``sig_of(*args, **kwargs)`` the site has
      not seen yet is noted before it runs, and its wall seconds are
      attributed to that first dispatch. Calls with a known signature
      pay one dict lookup and two monotonic reads. Without
      ``signature`` the wrapper only attributes the calls during which
      something noted the site (the JAX form). The original is
      ``__wrapped__``.

    ``mark_warm()`` freezes the signature set: a NEW signature at a
    warm site afterwards is a *recompile* — counted, logged, listed in
    :meth:`recompiles`, and offered to the installed flight recorder
    (``maybe_dump("xla-recompile")``, rate-limited by the recorder).

    Thread-safe; the default process-wide instance is
    :func:`default_ledger` (serving engines hold private instances so
    per-engine ``compile_counts`` stay per-engine while the /metrics
    families — get-or-create on the shared registry — stay process
    totals).
    """

    def __init__(self, *, registry: MetricsRegistry | None = None):
        self._lock = threading.Lock()
        self._sites: dict[str, _Site] = {}
        self._reg = registry or default_registry()
        self._events: list[dict] = []  # recompile events, oldest first

    # ------------------------------------------------------------- plumbing
    def _site(self, name: str) -> _Site:
        site = self._sites.get(name)
        if site is None:
            site = self._sites.setdefault(name, _Site(str(name)))
        return site

    def _metrics(self, site: str):
        return (
            # fedtpu: allow(obs-metric-once): the JAX package's obs/profile.py family, same name/kind/labels/help
            self._reg.counter(
                "fedtpu_xla_compiles_total",
                help="XLA traces/compiles per jitted site",
                labels={"site": site},
            ),
            # fedtpu: allow(obs-metric-once): the JAX package's obs/profile.py family, same name/kind/labels/help
            self._reg.counter(
                "fedtpu_xla_recompiles_total",
                help="new shape signatures traced at a warm site",
                labels={"site": site},
            ),
            # fedtpu: allow(obs-metric-once): the JAX package's obs/profile.py family, same name/kind/labels/help
            self._reg.histogram(
                "fedtpu_xla_trace_seconds",
                help="wall seconds of calls that traced+compiled",
                labels={"site": site},
                buckets=TRACE_BUCKETS,
            ),
        )

    # ------------------------------------------------------------ recording
    def hook(self, site: str) -> Callable[[Any], None]:
        """The callable that records one signature at ``site``."""
        name = str(site)

        def note(signature: Any) -> None:
            self.note(name, signature)

        return note

    def note(self, site: str, signature: Any) -> None:
        """Record one first dispatch of ``signature`` at ``site``."""
        emit_span = False
        recompile = False
        with self._lock:
            s = self._site(site)
            count = s.sigs.get(signature, 0) + 1
            s.sigs[signature] = count
            s.gen += 1
            recompile = s.warm and count == 1
            if recompile:
                self._events.append(
                    {
                        "site": site,
                        "signature": signature,
                        "ts": time.time(),
                    }
                )
            # Defer span/time attribution to the timed wrapper ONLY when
            # one is actually in flight: a note made outside it would
            # otherwise sit stale in `fresh` and corrupt the NEXT
            # attributed dispatch's wall-second share.
            deferred = s.timed and s.inflight > 0
            if deferred:
                s.fresh.append((signature, recompile))
            emit_span = not deferred
        compiles, recompiles, _hist = self._metrics(site)
        compiles.inc()
        if recompile:
            recompiles.inc()
            self._flag_recompile(site, signature)
        if emit_span:
            # Untimed site: the span still lands (its duration unknown);
            # a timed() wrapper emits it instead, with the wall seconds.
            self._emit_span(site, signature, 0.0, recompile)

    def _flag_recompile(self, site: str, signature: Any) -> None:
        import logging

        logging.getLogger(__name__).warning(
            f"[PROFILE] new shape at warm site {site!r}: signature "
            f"{signature!r} — a shape leak on a hot path (bucket the "
            "input, or mark_warm later)"
        )
        # Flight recorder (obs/flight.py): a new shape mid-traffic is
        # exactly the moment whose surrounding spans an operator wants
        # preserved. maybe_dump rate-limits per reason; a dump failure
        # must never break the training/serving path.
        from .flight import get_global_recorder

        recorder = get_global_recorder()
        if recorder is not None:
            try:
                recorder.maybe_dump(
                    "xla-recompile",
                    extra={"site": site, "signature": repr(signature)},
                )
            except OSError:
                pass

    def _emit_span(
        self, site: str, signature: Any, dur_s: float, recompile: bool
    ) -> None:
        from .trace import get_global_tracer

        tracer = get_global_tracer()
        if tracer is None:
            return
        tracer.record(
            "xla-compile",
            t_start=time.time() - dur_s,
            dur_s=dur_s,
            site=site,
            signature=repr(signature),
            recompile=True if recompile else None,
        )

    def timed(
        self,
        site: str,
        fn: Callable,
        *,
        signature: Callable[..., Any] | None = None,
    ) -> Callable:
        """Wrap ``fn``: with ``signature``, a call whose signature is new
        at ``site`` is noted as the site's first dispatch of it; the wall
        seconds of any call during which ``site`` was noted are
        attributed to those notes."""
        name = str(site)
        with self._lock:
            s = self._site(name)
            s.timed = True

        def wrapper(*args, **kwargs):
            sig = None if signature is None else signature(*args, **kwargs)
            first = sig is not None and sig not in s.sigs
            gen0 = s.gen
            # Plain GIL-atomic counter (no lock on the hot path): note()
            # only defers to the wrapper while a call is in flight.
            s.inflight += 1
            t0 = time.monotonic()
            try:
                if first:
                    self.note(name, sig)
                out = fn(*args, **kwargs)
            finally:
                s.inflight -= 1
            if s.gen != gen0:  # a note fired during this call
                self._attribute(s, time.monotonic() - t0)
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    def _attribute(self, s: _Site, dt: float) -> None:
        with self._lock:
            fresh, s.fresh = s.fresh, []
        if not fresh:
            return
        share = dt / len(fresh)
        _c, _r, hist = self._metrics(s.name)
        with self._lock:
            for sig, _rec in fresh:
                s.trace_s[sig] = s.trace_s.get(sig, 0.0) + share
        for sig, rec in fresh:
            hist.observe(share)
            self._emit_span(s.name, sig, share, rec)

    # ------------------------------------------------------------- lifecycle
    def mark_warm(self, site: str | None = None) -> None:
        """Freeze the signature set (all sites, or one): any new
        signature afterwards is flagged as a recompile. Call after the
        warmup phase — the serving engine does it from ``warmup()``."""
        with self._lock:
            targets = (
                [self._site(site)] if site is not None
                else list(self._sites.values())
            )
            for s in targets:
                s.warm = True

    # ------------------------------------------------------------- reporting
    def compile_counts(self, site: str) -> dict[Any, int]:
        """signature -> note count for one site (the serving engine's
        ``compile_counts`` rides this verbatim)."""
        with self._lock:
            s = self._sites.get(site)
            return dict(s.sigs) if s is not None else {}

    def recompiles(self, site: str | None = None) -> list[dict]:
        """Flagged recompile events, oldest first — exactly one per new
        signature at a warm site."""
        with self._lock:
            return [
                dict(e)
                for e in self._events
                if site is None or e["site"] == site
            ]

    def report(self) -> dict:
        """``{site: {compiles, signatures, trace_s, warm}}`` + events."""
        with self._lock:
            sites = {
                name: {
                    "compiles": sum(s.sigs.values()),
                    "signatures": len(s.sigs),
                    "trace_s": round(sum(s.trace_s.values()), 4),
                    "warm": s.warm,
                }
                for name, s in sorted(self._sites.items())
            }
            return {
                "sites": sites,
                "compile_count": sum(
                    s["compiles"] for s in sites.values()
                ),
                "recompiles": [dict(e) for e in self._events],
            }


_LEDGER_LOCK = threading.Lock()
_LEDGER: CompileLedger | None = None


def default_ledger() -> CompileLedger:
    """The process-wide ledger every hot path notes into (the
    default-registry pattern: no plumbing to share one /metrics view)."""
    global _LEDGER
    with _LEDGER_LOCK:
        if _LEDGER is None:
            _LEDGER = CompileLedger()
        return _LEDGER


def shape_signature(*args: Any, **kwargs: Any) -> tuple:
    """The signature of a step called as ``step(state, batch, ...)``:
    its batch's ``input_ids`` shape (a host array or a tensor)."""
    batch = args[1] if len(args) > 1 else kwargs["batch"]
    return tuple(int(d) for d in batch["input_ids"].shape)


# --------------------------------------------------------- step attribution
def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def _synchronize(value) -> None:
    """Wait until the device work producing the tensor ``value`` is done:
    one ``torch.cuda.synchronize`` on its card; nothing for a CPU one."""
    if value.is_cuda:
        import torch

        torch.cuda.synchronize(value.device)


class StepProfiler:
    """Deterministically strided fenced step timers.

    ``tick()`` advances the step counter and answers "is this step
    sampled" (step k is sampled iff ``k % stride == 0`` — a plain counter
    stride, no RNG, so reruns sample identically). On sampled steps the
    caller brackets the three phases:

    * ``note_host(dt)`` — input-pipeline work (batch gather/pad),
    * ``note_dispatch(dt)`` — the step call's Python return time (the
      kernels are queued, not finished); :meth:`note_record` takes host
      and dispatch from the call's phase record instead, at the sites
      that keep one,
    * ``fence(value)`` — ``torch.cuda.synchronize`` on ``value``'s card,
      the wait recorded under the JAX package's ``device`` phase
      (``drain(value)`` first empties the queue so the sampled step
      measures itself, not its backlog). It is the wait for the card
      after the host returned, not the card's busy time: whatever device
      work ran while the host dispatched is not in it, so it reads near
      zero on a host-paced step. Device busy time comes from a device
      trace.

    Unsampled steps — and every step at stride 0, the default — pay one
    attribute read. Stride 0 additionally registers nothing on the
    metrics registry.
    """

    PHASES = ("host", "dispatch", "device")

    def __init__(
        self,
        stride: int,
        *,
        site: str = "train",
        registry: MetricsRegistry | None = None,
        max_samples: int = 4096,
    ):
        self.stride = int(stride)
        self.enabled = self.stride > 0
        self.site = str(site)
        self.phases: tuple[str, ...] = _SITE_PHASES.get(self.site, self.PHASES)
        self._n = 0
        self._lock = threading.Lock()
        self._samples: dict[str, list[float]] = {p: [] for p in self.phases}
        self._max_samples = int(max_samples)
        self._hists = None
        if self.enabled:
            family = _STEP_FAMILIES.get(self.site)
            if family is not None:
                reg = registry or default_registry()
                self._hists = {
                    p: reg.histogram(
                        family,
                        help="sampled step seconds by phase",
                        labels={"phase": p},
                        buckets=STEP_BUCKETS,
                    )
                    for p in self.phases
                }

    # ------------------------------------------------------------- sampling
    def tick(self) -> bool:
        """Advance the step counter; True when THIS step is sampled."""
        if not self.enabled:
            return False
        n = self._n
        self._n = n + 1
        return n % self.stride == 0

    def clock(self) -> float:
        return time.monotonic()

    def drain(self, value) -> None:
        """Fence the queued device work BEFORE timing a sampled step, so
        the device-execute measurement is this step's own work and not
        the backlog of the unsampled steps before it."""
        if value is not None:
            _synchronize(value)

    def _note(self, phase: str, dt: float) -> None:
        with self._lock:
            vals = self._samples[phase]
            if len(vals) < self._max_samples:
                vals.append(float(dt))
        if self._hists is not None:
            self._hists[phase].observe(float(dt))

    def note(self, phase: str, dt: float) -> None:
        """Record one sampled duration for a named phase — the generic
        entry for sites whose phases aren't the host/dispatch/device
        split (the wire pack/unpack loops note ``"wire"``)."""
        if phase not in self._samples:
            raise ValueError(
                f"unknown phase {phase!r} for site {self.site!r} "
                f"(have {self.phases})"
            )
        self._note(phase, dt)

    def note_host(self, dt: float) -> None:
        self._note("host", dt)

    def note_dispatch(self, dt: float) -> None:
        self._note("dispatch", dt)

    def note_record(self, rec: PhaseRecord) -> None:
        """Sample one call from its phase record, with no clock read of
        its own: at the ``train`` site dispatch is the whole call; at
        ``score`` host is the record's ``prep`` and dispatch its
        ``dispatch``."""
        parts = rec.phase_ns()
        for phase, part in _RECORD_SAMPLES[self.site]:
            self._note(phase, (rec.call_ns if part is None else parts[part]) * 1e-9)

    def fence(self, value) -> None:
        """Block until ``value`` is ready; the wait is the ``device``
        phase: the card's work left when the host returned."""
        t0 = time.monotonic()
        _synchronize(value)
        self._note("device", time.monotonic() - t0)

    # ------------------------------------------------------------ reporting
    def begin_window(self) -> None:
        """Start a fresh reporting window (one fit/round): the sample
        lists are CLEARED, so summary/span_attrs always describe the
        current window (the histograms carry the cumulative record)."""
        with self._lock:
            for p in self.phases:
                self._samples[p].clear()

    def _phase_stats(self, vals: list[float]) -> dict | None:
        if not vals:
            return None
        v = sorted(vals)
        return {
            "n": len(v),
            "p50": _percentile(v, 0.50),
            "p95": _percentile(v, 0.95),
        }

    def summary(self) -> dict:
        """{phase: {n, p50, p95}} in seconds over the current window
        (empty when no samples)."""
        with self._lock:
            out = {}
            for p in self.phases:
                st = self._phase_stats(self._samples[p])
                if st is not None:
                    out[p] = st
            return out

    def span_attrs(self) -> dict:
        """Flat span attrs (milliseconds) for stamping on the existing
        train-phase spans — the timeline's device-vs-host row."""
        s = self.summary()
        out: dict[str, Any] = {}
        for p, st in s.items():
            out[f"step_{p}_ms_p50"] = round(st["p50"] * 1e3, 3)
            out[f"step_{p}_ms_p95"] = round(st["p95"] * 1e3, 3)
        if s:
            out["step_sampled"] = max(st["n"] for st in s.values())
        return out


_STRIDE_LOCK = threading.Lock()
_PROFILE_STRIDE = 0


def set_profile_stride(stride: int) -> None:
    """Install the process-wide step-profiling stride (0 = off, the
    default). The CLI calls this from ``--profile-stride`` /
    ObsConfig.profile_stride; trainers and engines re-check it when they
    start a fit or a dispatch."""
    global _PROFILE_STRIDE
    with _STRIDE_LOCK:
        _PROFILE_STRIDE = max(0, int(stride))


def profile_stride() -> int:
    # Lock-free read (a GIL-atomic int load): the scoring hot path asks
    # per call and must not pay a lock acquire for "off".
    return _PROFILE_STRIDE


def maybe_step_profiler(site: str) -> StepProfiler | None:
    """A StepProfiler when profiling is armed process-wide, else None —
    the hook trainers and engines call. None keeps the hot loops on the
    literal unprofiled path."""
    stride = profile_stride()
    if stride <= 0:
        return None
    return StepProfiler(stride, site=site)


def profiled_step_iter(
    profiler: "StepProfiler | None", batches: Iterator
) -> Iterator[tuple[Any, bool]]:
    """Yield ``(batch, sampled)`` pairs, timing host batch-prep on the
    sampled steps — the shared loop shim for the engine and federated
    fit loops (profiling off = the bare iterator, zero overhead)."""
    it = iter(batches)
    if profiler is None or not profiler.enabled:
        for batch in it:
            yield batch, False
        return
    while True:
        sampled = profiler.tick()
        t0 = profiler.clock() if sampled else 0.0
        try:
            batch = next(it)
        except StopIteration:
            return
        if sampled:
            profiler.note_host(profiler.clock() - t0)
        yield batch, sampled


# ---------------------------------------------------------- memory watermarks
_MEM_LOCK = threading.Lock()
_MEM_REPORT: dict[str, dict] = {}


def device_memory_stats(device: Any = None) -> dict | None:
    """The CUDA caching allocator's counters under the JAX package's
    ``memory_stats()`` keys, or None — the graceful-"unavailable"
    contract: None on the CPU (a CPU ``device``, or no CUDA), and None in
    a process that has not initialized CUDA, so a host-only daemon that
    calls :func:`note_memory` at a phase boundary never creates a context
    for the answer.

    ``bytes_in_use`` / ``peak_bytes_in_use`` are the ALLOCATED bytes
    (``allocated_bytes.all.current`` / ``.peak``: live tensors), not the
    allocator's reserved segments; ``bytes_limit`` is the card's total
    memory (``torch.cuda.mem_get_info``)."""
    try:
        import sys

        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return None
        dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
        if dev.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
        _free, total = torch.cuda.mem_get_info(dev)
    except Exception:
        return None
    if not stats:
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def note_memory(
    phase: str,
    *,
    device: Any = None,
    registry: MetricsRegistry | None = None,
) -> dict | None:
    """Snapshot device memory at a phase boundary (post-restore /
    post-first-step / post-round / post-aggregate). Returns the
    snapshot, or None when no stats are available — the phase is still
    recorded as unavailable so ``memory_report`` shows it was visited."""
    stats = device_memory_stats(device)
    phase = str(phase)
    if stats is None:
        with _MEM_LOCK:
            _MEM_REPORT.setdefault(phase, {"available": False})
        return None
    in_use = float(stats.get("bytes_in_use", 0.0))
    peak = float(stats.get("peak_bytes_in_use", in_use))
    snap = {
        "available": True,
        "bytes_in_use": in_use,
        "peak_bytes": peak,
        "ts": time.time(),
    }
    with _MEM_LOCK:
        prev = _MEM_REPORT.get(phase)
        if prev is not None and prev.get("available"):
            # Watermark semantics: keep the high-water peak across
            # repeated visits (every round hits post-round).
            snap["peak_bytes"] = max(peak, prev["peak_bytes"])
        _MEM_REPORT[phase] = snap
    reg = registry or default_registry()
    # fedtpu: allow(obs-metric-once): the JAX package's obs/profile.py family, same name/kind/labels/help
    reg.gauge(
        "fedtpu_device_bytes_in_use",
        help="device bytes in use at the last phase-boundary snapshot",
        labels={"phase": phase},
    ).set(in_use)
    # fedtpu: allow(obs-metric-once): the JAX package's obs/profile.py family, same name/kind/labels/help
    reg.gauge(
        "fedtpu_device_peak_bytes",
        help="high-water device bytes across phase-boundary snapshots",
        labels={"phase": phase},
    ).set(snap["peak_bytes"])
    return snap


def memory_report() -> dict[str, dict]:
    """phase -> last snapshot (``{"available": False}`` for phases
    visited without stats)."""
    with _MEM_LOCK:
        return {k: dict(v) for k, v in _MEM_REPORT.items()}


def peak_device_bytes() -> float:
    """The process high-water mark over every recorded phase (0.0 when
    no stats were ever available)."""
    with _MEM_LOCK:
        return max(
            (
                v["peak_bytes"]
                for v in _MEM_REPORT.values()
                if v.get("available")
            ),
            default=0.0,
        )


# ------------------------------------------------------ FLOPs cross-check
def counted_flops(fn: Callable, *args: Any, **kwargs: Any) -> float | None:
    """FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts over one
    call of ``fn(*args, **kwargs)`` — the port's counterpart of the JAX
    package's ``xla_cost_flops`` (which reads XLA's cost model of the
    compiled program). The call RUNS (eager torch has no separate
    program to inspect), so a train step advances its state. Matmuls,
    convolutions and attention ops that go through torch's dispatcher
    are counted; a kernel launched around it (the flash kernels K1-K3
    through ctypes) is not. None when nothing was counted."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return flops if flops > 0.0 else None


def flops_ratio_ok(ratio: float | None) -> bool:
    """None (nothing counted) is not a failure; a number outside
    :data:`FLOPS_RATIO_TOLERANCE` is."""
    if ratio is None:
        return True
    lo, hi = FLOPS_RATIO_TOLERANCE
    return lo <= ratio <= hi


# ------------------------------------------------------------- full session
def run_profile_session(
    model_cfg=None,
    train_cfg=None,
    *,
    steps: int = 8,
    batch_size: int = 16,
    stride: int = 1,
    warmup: int = 2,
    capture_dir: str | None = None,
    serving: bool = True,
    seed: int = 0,
    device=None,
) -> dict:
    """One end-to-end pass over the device performance plane: train
    ``steps`` real engine steps with the step profiler armed, snapshot
    memory at the phase boundaries, cross-check analytic vs counted
    FLOPs, and storm the bucketed serving path asserting zero new
    shapes after warmup. ``capture_dir`` wraps ``torch.profiler`` around
    the profiled steps (utils/profiling.trace). ``device``: the card
    unless ``"cpu"`` is given. The report has the JAX package's keys;
    ``flops_xla`` holds the counted FLOPs."""
    import numpy as np

    from ..config import ModelConfig, TrainConfig
    from ..train.engine import Trainer
    from ..utils.profiling import trace, train_step_flops

    model_cfg = model_cfg or ModelConfig()
    train_cfg = train_cfg or TrainConfig()
    ledger = default_ledger()
    before = ledger.report()
    events_before = len(before["recompiles"])

    trainer = Trainer(model_cfg, train_cfg, device=device)
    # The session drives its own step loop below (tick/drain/fence
    # directly) rather than trainer.fit — the fit-loop integration has
    # its own tests.
    prof = StepProfiler(stride, site="train")
    rng = np.random.default_rng(seed)
    L = model_cfg.max_len
    # The batch stays HOST-side: each sampled step times its copy to the
    # device as the host batch-prep phase (what an input pipeline pays
    # per step), so the session reports all three phases like the fit
    # loops.
    batch = {
        "input_ids": rng.integers(
            0, model_cfg.vocab_size, (batch_size, L)
        ).astype(np.int32),
        "attention_mask": np.ones((batch_size, L), np.int32),
        "labels": rng.integers(0, 2, batch_size).astype(np.int32),
    }
    state = trainer.init_state(seed=seed)
    loss = None
    # Warmup FIRST, through the ledger's wrapper, so the first
    # dispatch's wall seconds are attributed to the ledger.
    for _ in range(max(1, warmup)):
        state, loss = trainer.train_step(state, batch)
    _synchronize(loss)
    note_memory("post-first-step")
    # The counted FLOPs of one more step (it runs: eager torch has no
    # program to inspect without running it). Before mark_warm, as in
    # the JAX session.
    flops_xla = counted_flops(trainer.train_step, state, batch)
    flops_analytic = train_step_flops(model_cfg, batch_size)
    ratio = (
        flops_xla / flops_analytic
        if flops_xla is not None and flops_analytic > 0
        else None
    )
    # Warm ONLY the site this session just exercised: a blanket
    # mark_warm would freeze sibling sites with zero or partial
    # signature sets and misflag their next legitimate first dispatch.
    ledger.mark_warm("engine.train_step")

    with trace(capture_dir):
        for _ in range(max(1, steps)):
            if prof.tick():
                prof.drain(loss)
                t_h = prof.clock()
                placed = trainer.place_batch(batch)
                prof.note_host(prof.clock() - t_h)
                state, loss = trainer.train_step(state, placed)
                prof.note_record(trainer.last_step_record)
                prof.fence(loss)
            else:
                state, loss = trainer.train_step(state, batch)
        _synchronize(loss)
    note_memory("post-round")

    serving_report = None
    if serving:
        serving_report = _serving_bucket_storm(seed=seed, device=trainer.device)

    after = ledger.report()
    sites = {}
    for name, rec in after["sites"].items():
        prev = before["sites"].get(name)
        compiles = rec["compiles"] - (prev["compiles"] if prev else 0)
        if compiles > 0:
            sites[name] = {
                "compiles": compiles,
                "signatures": rec["signatures"],
                "trace_s": round(
                    rec["trace_s"] - (prev["trace_s"] if prev else 0.0), 4
                ),
            }
    recompiles = after["recompiles"][events_before:]
    report = {
        "sites": sites,
        "compile_count": sum(s["compiles"] for s in sites.values()),
        "recompiles": recompiles,
        "step": prof.summary(),
        "stride": stride,
        "memory": memory_report(),
        "peak_device_bytes": peak_device_bytes(),
        "flops_analytic": flops_analytic,
        "flops_xla": flops_xla,
        "flops_ratio": round(ratio, 4) if ratio is not None else None,
        "flops_ratio_ok": flops_ratio_ok(ratio),
        "flops_tolerance": list(FLOPS_RATIO_TOLERANCE),
        "capture_dir": capture_dir,
    }
    if serving_report is not None:
        report["serving"] = serving_report
    return report


def _serving_bucket_storm(*, seed: int = 0, device=None) -> dict:
    """Warm a tiny bucketed ScoreEngine, then storm mixed batch sizes:
    the bucket ladder must absorb every size into an already-dispatched
    shape — new shapes after warmup asserted 0 (the discipline the
    serving tests pin, exercised live)."""
    import numpy as np
    import torch

    from ..config import ModelConfig
    from ..models.distilbert import init_params
    from ..serving.engine import ScoreEngine

    cfg = ModelConfig.tiny()
    eng = ScoreEngine(
        cfg,
        init_params(cfg, torch.Generator().manual_seed(seed)),
        buckets=(1, 4),
        device=device,
    )
    eng.warmup()  # dispatches both buckets, then marks the site warm
    rng = np.random.default_rng(seed)
    L = cfg.max_len
    for n in (1, 2, 3, 4, 1, 4, 2):
        ids = rng.integers(0, cfg.vocab_size, (n, L)).astype(np.int32)
        mask = np.ones((n, L), np.int32)
        eng.score(ids, mask)
    counts = eng.compile_counts
    return {
        "compiles": sum(counts.values()),
        "signatures": len(counts),
        "recompiles": len(eng.ledger.recompiles()),
        "buckets": list(eng.buckets),
    }


def render_profile_report(report: dict) -> str:
    """The ``obs profile`` human rendering of a session report."""
    out: list[str] = []
    out.append("dispatch ledger (this session; first dispatch per shape):")
    sites = report.get("sites") or {}
    if sites:
        out.append(
            f"  {'site':<24} {'compiles':>9} {'signatures':>11} "
            f"{'trace_s':>9}"
        )
        for name, s in sorted(sites.items()):
            out.append(
                f"  {name:<24} {s['compiles']:>9} {s['signatures']:>11} "
                f"{s['trace_s']:>9.3f}"
            )
    else:
        out.append("  (no first dispatches — every shape was already seen)")
    rec = report.get("recompiles") or []
    if rec:
        out.append(f"recompiles: {len(rec)} FLAGGED")
        for e in rec:
            out.append(f"  {e['site']}  signature {e['signature']!r}")
    else:
        out.append("recompiles: none")
    step = report.get("step") or {}
    if step:
        out.append(f"step time (stride {report.get('stride')}, sampled):")
        for phase in StepProfiler.PHASES:
            st = step.get(phase)
            if st:
                out.append(
                    f"  {phase:<9} p50 {st['p50'] * 1e3:8.2f}ms  "
                    f"p95 {st['p95'] * 1e3:8.2f}ms  ({st['n']} samples)"
                )
    mem = report.get("memory") or {}
    out.append("memory watermarks:")
    if mem:
        for phase, snap in mem.items():
            if snap.get("available"):
                out.append(
                    f"  {phase:<16} {snap['bytes_in_use'] / 1e6:9.1f} MB "
                    f"in use, peak {snap['peak_bytes'] / 1e6:9.1f} MB"
                )
            else:
                out.append(
                    f"  {phase:<16} unavailable (no CUDA memory stats in "
                    "this process)"
                )
    else:
        out.append("  (no snapshots)")
    lo, hi = report.get("flops_tolerance", FLOPS_RATIO_TOLERANCE)
    ratio = report.get("flops_ratio")
    out.append(
        "flops cross-check: analytic "
        f"{report.get('flops_analytic', 0.0):.3g}, counted "
        + (
            f"{report['flops_xla']:.3g}, ratio {ratio}"
            f" (tolerance {lo}-{hi}"
            + (", OK)" if report.get("flops_ratio_ok") else ", BROKEN)")
            if report.get("flops_xla") is not None
            else "unavailable (nothing counted)"
        )
    )
    srv = report.get("serving")
    if srv:
        out.append(
            f"serving bucketed path: {srv['compiles']} first dispatches over "
            f"buckets {srv['buckets']}, {srv['recompiles']} recompiles"
            + (" (OK)" if srv["recompiles"] == 0 else " (BROKEN)")
        )
    if report.get("capture_dir"):
        out.append(
            f"torch.profiler capture: {report['capture_dir']} "
            "(a Chrome trace: open it in ui.perfetto.dev)"
        )
    return "\n".join(out) + "\n"
