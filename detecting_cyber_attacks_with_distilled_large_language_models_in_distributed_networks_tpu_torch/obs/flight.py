"""Failure flight recorder: postmortem bundles from an in-memory ring (the
port's copy of the JAX package's ``obs/flight.py``; the bundle layout is
the same, so ``obs postmortem`` of either package reads the other's).

When a round fails at 3 a.m., the spans that explain it are scattered
across per-process JSONLs (if tracing was even on) and the /metrics
counters have already moved past the moment. This module keeps the last
N spans + the most recent metric snapshots + the last alerts in a
bounded in-memory ring inside EVERY daemon, and on a trigger — round
failure (comm/server.py), replica eject storm (router/core.py), or an
SLO page (obs/slo.py) — dumps one self-contained postmortem bundle to
disk: ring + current /metrics snapshot + config + trigger context.
``fedtpu obs postmortem`` lists and inspects the bundles.

Design constraints:

* **Zero hot-path cost when off.** Nothing records unless a
  :class:`FlightRecorder` is installed (``set_global_recorder`` — the
  CLI does it from ``--flight-dir`` / ObsConfig.flight_dir). When on,
  a span costs one deque append under a lock.
* **No daemon-side capture wiring.** obs/trace.py feeds every span a
  Tracer writes into the installed recorder, so any process that
  already traces records flight data for free; metric state is pulled
  from the process default registry at dump time (plus whatever
  periodic snapshots the owner pushed via :meth:`note_metrics`).
* **Storm-safe.** ``maybe_dump`` rate-limits per reason
  (``min_interval_s``) and the directory is bounded (``max_bundles``,
  oldest pruned) — an eject storm writes one bundle, not hundreds.
* **Atomic bundles.** Each bundle is one JSON file written to a temp
  name and renamed, so ``fedtpu obs postmortem`` never reads a torn
  half-dump.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from collections import deque

#: Schema tag inside every bundle file.
BUNDLE_SCHEMA = "fedtpu-postmortem-v1"

#: Bundle filename shape: postmortem-<proc>-<seq>-<reason>.json
_BUNDLE_GLOB = "postmortem-*.json"


class FlightRecorder:
    """Bounded ring of recent observability state for ONE process."""

    def __init__(
        self,
        out_dir: str,
        *,
        proc: str,
        ring: int = 256,
        snapshots: int = 8,
        alerts: int = 32,
        max_bundles: int = 16,
        min_interval_s: float = 30.0,
        config: dict | None = None,
        tracer=None,
    ):
        if ring < 1:
            raise ValueError(f"ring={ring} must be >= 1")
        if max_bundles < 1:
            raise ValueError(f"max_bundles={max_bundles} must be >= 1")
        self.out_dir = out_dir
        self.proc = str(proc)
        self.min_interval_s = float(min_interval_s)
        self.max_bundles = int(max_bundles)
        self.config = dict(config or {})
        #: Optional span writer: a dump also emits a ``postmortem-dump``
        #: span so the timeline shows WHEN the recorder fired relative
        #: to the round that tripped it.
        self.tracer = tracer
        self._lock = threading.Lock()
        self._spans: deque[dict] = deque(maxlen=int(ring))
        self._snapshots: deque[dict] = deque(maxlen=int(snapshots))
        self._alerts: deque[dict] = deque(maxlen=int(alerts))
        self._last_dump: dict[str, float] = {}
        # Seed the sequence past any bundles a PREVIOUS run of this
        # proc left behind: a daemon restart (exactly what follows a
        # failure) starting back at 1 would silently os.replace() the
        # prior run's evidence — the one thing the recorder exists to
        # preserve.
        self._seq = self._existing_max_seq()
        self.bundles_written = 0

    def _my_bundles(self) -> list[tuple[int, str]]:
        """(seq, path) for THIS proc's bundles on disk. The filename is
        ``postmortem-<proc>-<seq>-<reason>.json`` with seq always
        ``%04d``-formatted; requiring a >=4-digit segment right after
        the exact proc prefix keeps a proc whose name is a dash-prefix
        of another's ("relay-1" vs "relay-12") from claiming — or
        later pruning — the sibling's files in a shared directory."""
        prefix = f"postmortem-{self.proc}-"
        out: list[tuple[int, str]] = []
        for path in glob.glob(os.path.join(self.out_dir, prefix + "*.json")):
            seq_part = os.path.basename(path)[len(prefix):].split("-", 1)[0]
            if len(seq_part) >= 4 and seq_part.isdigit():
                out.append((int(seq_part), path))
        return out

    def _existing_max_seq(self) -> int:
        return max((seq for seq, _ in self._my_bundles()), default=0)

    # ------------------------------------------------------------- capture
    def note_span(self, rec: dict) -> None:
        """Called by obs/trace.py for every span the process writes."""
        with self._lock:
            self._spans.append(rec)

    def note_metrics(self, snapshot: dict, *, now: float) -> None:
        """Optional periodic metric snapshots (the scrape hub pushes its
        own polls; daemons rely on the dump-time pull instead)."""
        with self._lock:
            self._snapshots.append({"ts": float(now), **snapshot})

    def note_alert(self, event: dict) -> None:
        with self._lock:
            self._alerts.append(event)

    # --------------------------------------------------------------- dump
    def maybe_dump(self, reason: str, *, extra: dict | None = None) -> str | None:
        """Rate-limited :meth:`dump`: at most one bundle per ``reason``
        per ``min_interval_s`` — the storm guard. Returns the bundle
        path or None when suppressed. The limiter stamps only AFTER a
        successful write: a transient dump failure (ENOSPC — the
        callers catch OSError and log) must not suppress the retry
        that would have preserved the evidence."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.min_interval_s:
                return None
            # Provisional claim inside the SAME lock section as the
            # check: two near-simultaneous triggers (racing router
            # reader threads) must produce one bundle, not two.
            self._last_dump[reason] = now
        try:
            path = self.dump(reason, extra=extra)
        except BaseException:
            with self._lock:
                # Roll the claim back so a transient failure (ENOSPC)
                # doesn't suppress the retry that would have preserved
                # the evidence.
                if self._last_dump.get(reason) == now:
                    del self._last_dump[reason]
            raise
        with self._lock:
            self._last_dump[reason] = time.monotonic()
        return path

    def dump(self, reason: str, *, extra: dict | None = None) -> str:
        """Write one postmortem bundle NOW (no rate limit): the span
        ring, retained metric snapshots, a fresh pull of the process
        default registry, the last alerts, and the trigger context."""
        from .metrics import default_registry

        t_unix = time.time()
        t0 = time.monotonic()
        with self._lock:
            spans = list(self._spans)
            snapshots = list(self._snapshots)
            alerts = list(self._alerts)
            self._seq += 1
            seq = self._seq
        try:
            current_metrics = default_registry().snapshot()
        except Exception:  # a torn registry must not lose the spans
            current_metrics = None
        bundle = {
            "schema": BUNDLE_SCHEMA,
            "ts": t_unix,
            "proc": self.proc,
            "reason": str(reason),
            "seq": seq,
            "config": self.config,
            "extra": extra or {},
            "alerts": alerts,
            "metric_snapshots": snapshots,
            "metrics_now": current_metrics,
            "spans": spans,
        }
        os.makedirs(self.out_dir, exist_ok=True)
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in str(reason)
        )
        name = f"postmortem-{self.proc}-{seq:04d}-{safe_reason}.json"
        path = os.path.join(self.out_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f)
        os.replace(tmp, path)
        with self._lock:
            self.bundles_written += 1
        self._prune()
        if self.tracer is not None:
            self.tracer.record(
                "postmortem-dump",
                t_start=t_unix,
                dur_s=time.monotonic() - t0,
                reason=str(reason),
                bundle=name,
                spans=len(spans),
            )
        return path

    def _prune(self) -> None:
        """Oldest-first prune beyond ``max_bundles`` (mtime order; this
        process's bundles ONLY — :meth:`_my_bundles` — because fleets
        may share one directory: a sibling's evidence must never be
        counted against this proc's budget or deleted, and a sibling
        removing files between glob and stat must not raise)."""

        def _mtime(p: str) -> float:
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0

        mine = sorted(
            (p for _seq, p in self._my_bundles()),
            key=lambda p: (_mtime(p), p),
        )
        for path in mine[: max(0, len(mine) - self.max_bundles)]:
            try:
                os.remove(path)
            except OSError:
                pass


# ------------------------------------------------------- global install
_GLOBAL_LOCK = threading.Lock()
_GLOBAL: FlightRecorder | None = None


def set_global_recorder(rec: FlightRecorder | None) -> None:
    """Install the process flight recorder (the CLI does this once at
    startup from --flight-dir / ObsConfig.flight_dir; None disarms —
    required between in-process CLI invocations in tests)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = rec


def get_global_recorder() -> FlightRecorder | None:
    with _GLOBAL_LOCK:
        return _GLOBAL


# ----------------------------------------------------------- inspection
def list_bundles(out_dir: str) -> list[dict]:
    """Bundle summaries (path, proc, reason, ts, span/alert counts) for
    ``fedtpu obs postmortem``, newest first. Torn or foreign files are
    skipped, not fatal."""
    out: list[dict] = []
    for path in glob.glob(os.path.join(out_dir, _BUNDLE_GLOB)):
        b = load_bundle(path)
        if b is None:
            continue
        out.append(
            {
                "path": path,
                "name": os.path.basename(path),
                "ts": b.get("ts"),
                "proc": b.get("proc"),
                "reason": b.get("reason"),
                "spans": len(b.get("spans") or ()),
                "alerts": len(b.get("alerts") or ()),
            }
        )
    out.sort(key=lambda r: (r["ts"] or 0.0), reverse=True)
    return out


def load_bundle(path: str) -> dict | None:
    try:
        with open(path) as f:
            b = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(b, dict) or b.get("schema") != BUNDLE_SCHEMA:
        return None
    return b
