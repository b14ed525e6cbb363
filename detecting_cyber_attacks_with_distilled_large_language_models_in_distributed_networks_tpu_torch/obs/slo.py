"""Declarative SLOs evaluated as multi-window burn rates over /metrics
(the port's copy of the JAX package's ``obs/slo.py``: the same objectives,
burn arithmetic and ``fedtpu-alert-v1`` events).

The fleet's daemons export Prometheus counters and histograms, but
nothing WATCHES them — a scoring tier whose p99 quietly doubles, a
round cadence that rots under stragglers, or a replica eject storm all
scroll past as numbers nobody reads (the silent-regression failure mode
the FL-communication surveys call out). This module is the judgment
layer: the operator declares what "healthy" means once, and the scrape
hub (obs/fleet.py) evaluates it continuously.

The evaluation model is the SRE-workbook **multi-window burn rate**:

* An :class:`SLO` promises that at least ``objective`` of events are
  good — good = a histogram observation at or under a latency bound
  (``kind="latency"``), or membership in the complement of a bad-event
  counter over a total counter (``kind="ratio"``). The error budget is
  ``1 - objective``.
* The **burn rate** over a window is ``bad_fraction / budget`` computed
  on DELTAS of the cumulative snapshots (the same ``increase()``
  arithmetic a Prometheus alert would run). Burn 1.0 = spending budget
  exactly as fast as the objective allows; 14.4 = the classic
  page-worthy pace (2% of a 30-day budget in one hour).
* An alert **fires** only when EVERY configured window breaches its
  factor — the long window keeps one blip from paging, the short window
  proves the problem is still happening — and **clears** when the
  shortest window's burn drops back under its factor (no fresh bad
  events = the budget stops burning; a trafficless window burns
  nothing by definition).

Everything here is pure arithmetic over ``(now, snapshot)`` pairs the
caller supplies — no wall-clock reads, no sleeps — so the burn state
machine is unit-testable from synthetic histogram deltas and the
`fedtpu check` determinism discipline stays trivially intact. Fired and
cleared events append to an alerts-JSONL (one atomic line each, the
obs/trace.py writer) and optionally trip the failure flight recorder
(obs/flight.py) on page-severity fires.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping

from .trace import append_jsonl_line

#: Schema tag on every alert-JSONL record.
ALERT_SCHEMA = "fedtpu-alert-v1"

#: The classic SRE-workbook page pace: 2% of a 30-day budget in 1 hour.
PAGE_BURN_FACTOR = 14.4


@dataclass(frozen=True)
class SLO:
    """One service-level objective over an exported metric family.

    ``kind="latency"``: ``metric`` names a histogram family; an event is
    good when its observation is <= ``le`` seconds (``le`` should sit on
    a bucket edge — the evaluator uses the largest edge <= ``le``).

    ``kind="ratio"``: ``metric`` names the BAD-event counter and
    ``total`` the denominator counter (e.g. stream fallbacks over
    uploads, ejects over forwards).

    ``windows`` is ``((window_s, burn_factor), ...)`` ordered however;
    the evaluator fires on ALL breaching and clears on the shortest.
    """

    name: str
    metric: str
    kind: str = "latency"
    le: float | None = None
    total: str | None = None
    objective: float = 0.99
    windows: tuple[tuple[float, float], ...] = (
        (3600.0, PAGE_BURN_FACTOR),
        (300.0, PAGE_BURN_FACTOR),
    )
    severity: str = "page"
    #: Optional label filter: only samples carrying every (k, v) count.
    labels: tuple[tuple[str, str], ...] = ()

    def __post_init__(self) -> None:
        if self.kind not in ("latency", "ratio"):
            raise ValueError(f"SLO kind={self.kind!r} must be latency|ratio")
        if self.kind == "latency" and self.le is None:
            raise ValueError(f"latency SLO {self.name!r} needs le=<bound>")
        if self.kind == "ratio" and not self.total:
            raise ValueError(f"ratio SLO {self.name!r} needs total=<family>")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective={self.objective} must be in (0, 1)"
            )
        if not self.windows:
            raise ValueError(f"SLO {self.name!r} needs at least one window")
        for w, f in self.windows:
            if w <= 0.0 or f <= 0.0:
                raise ValueError(
                    f"SLO {self.name!r} window ({w}, {f}) must be positive"
                )
        if self.severity not in ("page", "ticket"):
            raise ValueError(
                f"severity={self.severity!r} must be page|ticket"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    @property
    def shortest_window(self) -> tuple[float, float]:
        return min(self.windows, key=lambda wf: wf[0])


def default_slos() -> tuple[SLO, ...]:
    """The fleet's stock objectives over the families the daemons already
    export — the ``fedtpu obs health`` defaults when no --slo file names
    others. Windows are deliberately short (minutes, not the workbook's
    hours): loopback fleets and CI campaigns live on that timescale, and
    an operator file overrides them for real deployments."""
    return (
        # Scoring latency: 99% of requests wait <= 50 ms in the
        # micro-batcher queue (the serving tier's own histogram).
        SLO(
            name="scoring-queue-p99",
            metric="fedtpu_serve_queue_wait_seconds",
            kind="latency",
            le=0.05,
            objective=0.99,
            windows=((300.0, PAGE_BURN_FACTOR), (60.0, PAGE_BURN_FACTOR)),
        ),
        # Round cadence: 90% of aggregation rounds finish within a
        # minute (straggler rot shows up here first).
        SLO(
            name="round-duration",
            metric="fedtpu_server_round_seconds",
            kind="latency",
            le=60.0,
            objective=0.9,
            windows=((600.0, 6.0), (120.0, 6.0)),
        ),
        # Stream health: dense fallbacks while streaming is advertised
        # stay under 10% of uploads.
        SLO(
            name="stream-fallback-ratio",
            metric="fedtpu_server_stream_fallbacks_total",
            kind="ratio",
            total="fedtpu_server_uploads_total",
            objective=0.9,
            windows=((600.0, 6.0), (120.0, 6.0)),
            severity="ticket",
        ),
        # Replica fleet: ejects stay under one per thousand forwards.
        SLO(
            name="replica-eject-rate",
            metric="fedtpu_router_ejects_total",
            kind="ratio",
            total="fedtpu_router_forwarded_total",
            objective=0.999,
            windows=((600.0, PAGE_BURN_FACTOR), (60.0, PAGE_BURN_FACTOR)),
        ),
        # Canary end-to-end: 99% of sentinel canary probes score through
        # the full router->replica chain within 250 ms (obs/sentinel.py
        # feeds the histogram — the known-truth proof of the live path).
        SLO(
            name="canary-latency-p99",
            metric="fedtpu_canary_latency_seconds",
            kind="latency",
            le=0.25,
            objective=0.99,
            windows=((300.0, PAGE_BURN_FACTOR), (60.0, PAGE_BURN_FACTOR)),
        ),
    )


def slos_from_spec(spec: Iterable[Mapping[str, Any]]) -> tuple[SLO, ...]:
    """Operator SLO file (a JSON list of SLO-field objects) -> SLO
    tuple. Windows round-trip from JSON lists; unknown keys fail loudly
    (a typo'd field must not silently weaken an objective)."""
    out = []
    for d in spec:
        kw = dict(d)
        if "windows" in kw:
            kw["windows"] = tuple(
                (float(w), float(f)) for w, f in kw["windows"]
            )
        if "labels" in kw:
            kw["labels"] = tuple(
                (str(k), str(v)) for k, v in kw["labels"]
            )
        out.append(SLO(**kw))
    return tuple(out)


# --------------------------------------------------------- event extraction
def _labels_match(sample: Mapping, labels: tuple) -> bool:
    got = sample.get("labels") or {}
    return all(got.get(k) == v for k, v in labels)


def _hist_good_total(
    families: Mapping, metric: str, le: float, labels: tuple
) -> tuple[float, float] | None:
    fam = families.get(metric)
    if not fam or fam.get("type") != "histogram":
        return None
    good = total = 0.0
    seen = False
    for s in fam.get("samples", ()):
        if not _labels_match(s, labels):
            continue
        seen = True
        total += float(s.get("count", 0))
        best = 0.0
        for edge_str, cum in s.get("buckets", ()):
            try:
                edge = float(edge_str)
            except ValueError:  # garbage edge in a foreign snapshot
                continue
            # float("+Inf") parses fine; inf <= le is simply never
            # true, so the +Inf bucket (== count) can't claim "good".
            if edge <= le:
                best = float(cum)
        good += best
    return (good, total) if seen else None


def _counter_sum(
    families: Mapping, metric: str, labels: tuple
) -> float | None:
    fam = families.get(metric)
    if not fam:
        return None
    vals = [
        float(s.get("value", 0.0))
        for s in fam.get("samples", ())
        if _labels_match(s, labels)
    ]
    return sum(vals) if vals else None


def extract_bad_total(
    slo: SLO, families: Mapping
) -> tuple[float, float] | None:
    """Cumulative (bad_events, total_events) for one SLO out of one
    metrics snapshot's ``families`` dict, or None when the family is not
    exported (that tier isn't running here — not an error)."""
    if slo.kind == "latency":
        gt = _hist_good_total(families, slo.metric, slo.le, slo.labels)
        if gt is None:
            return None
        good, total = gt
        return max(total - good, 0.0), total
    bad = _counter_sum(families, slo.metric, slo.labels)
    total = _counter_sum(families, slo.total, slo.labels)
    if bad is None or total is None:
        return None
    return bad, total


# ----------------------------------------------------------- burn windows
class _BurnSeries:
    """Timestamped cumulative (bad, total) points for one (SLO, instance);
    answers "burn rate over the trailing W seconds" by the increase()
    delta between now and the last point at or before now - W."""

    def __init__(self, max_window_s: float):
        self.max_window_s = float(max_window_s)
        self.points: deque[tuple[float, float, float]] = deque()

    def add(self, now: float, bad: float, total: float) -> None:
        last = self.points[-1] if self.points else None
        if last is not None and (bad < last[1] or total < last[2]):
            # Counter reset (daemon restart): drop history — deltas
            # across a reset would go negative or phantom-burn.
            self.points.clear()
        self.points.append((float(now), float(bad), float(total)))
        horizon = now - self.max_window_s - 1.0
        while len(self.points) > 2 and self.points[1][0] <= horizon:
            self.points.popleft()

    def burn(self, now: float, window_s: float, budget: float) -> dict:
        """{"burn": rate, "bad": d_bad, "total": d_total} over the
        trailing window; no-traffic windows burn 0.0 by definition."""
        if not self.points:
            return {"burn": 0.0, "bad": 0.0, "total": 0.0}
        cutoff = now - window_s
        base = self.points[0]
        for p in self.points:
            if p[0] <= cutoff:
                base = p
            else:
                break
        head = self.points[-1]
        d_bad = max(head[1] - base[1], 0.0)
        d_total = max(head[2] - base[2], 0.0)
        if d_total <= 0.0:
            return {"burn": 0.0, "bad": 0.0, "total": 0.0}
        return {
            "burn": (d_bad / d_total) / budget,
            "bad": d_bad,
            "total": d_total,
        }


class AlertManager:
    """Fire/clear state machines for a set of SLOs across fleet
    instances, with a JSONL alert sink.

    ``ingest(families, now=..., instance=...)`` pushes one metrics
    snapshot; ``evaluate(now=...)`` advances every state machine and
    returns the fire/clear events of this pass (also appended to
    ``sink_path`` and handed to ``on_event``). Page-severity fires trip
    the installed flight recorder, so an SLO page leaves a postmortem
    bundle behind without any daemon-side wiring.

    ``alert_cmd`` is the notification fan-out (``--alert-cmd``): a user
    shell command spawned once per page-severity fire with the alert
    event JSON on stdin — the alerts-JSONL stops being the only
    consumer. Rate-limited to one spawn per ``alert_cmd_interval_s``
    on the EVENT clock (the same injectable timeline the burn windows
    ride, so tests drive it synthetically), and OSError-guarded: a
    broken pager never kills the poll loop.

    Thread-safe: the scrape hub's watch loop and a test driving
    synthetic snapshots both funnel through one lock.
    """

    def __init__(
        self,
        slos: Iterable[SLO] | None = None,
        *,
        sink_path: str | None = None,
        on_event: Callable[[dict], None] | None = None,
        recorder=None,
        alert_cmd: str | None = None,
        alert_cmd_interval_s: float = 30.0,
    ):
        self.slos = tuple(slos if slos is not None else default_slos())
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self.sink_path = sink_path
        self.on_event = on_event
        self._recorder = recorder
        self.alert_cmd = alert_cmd
        self.alert_cmd_interval_s = float(alert_cmd_interval_s)
        self._lock = threading.Lock()
        self._last_notify_ts: float | None = None
        # (slo.name, instance) -> {"series": _BurnSeries, "firing": bool,
        #                          "since": ts, "last_burn": {...}}
        self._state: dict[tuple[str, str], dict] = {}
        self.fired_total = 0
        self.cleared_total = 0
        self.notified_total = 0
        self.notify_suppressed_total = 0

    # ------------------------------------------------------------- ingest
    def ingest(
        self, families: Mapping, *, now: float, instance: str = "local"
    ) -> None:
        with self._lock:
            for slo in self.slos:
                bt = extract_bad_total(slo, families)
                if bt is None:
                    continue
                key = (slo.name, instance)
                st = self._state.get(key)
                if st is None:
                    st = {
                        "series": _BurnSeries(
                            max(w for w, _ in slo.windows)
                        ),
                        "firing": False,
                        "since": None,
                        "last_burn": {},
                    }
                    self._state[key] = st
                st["series"].add(now, *bt)

    # ----------------------------------------------------------- evaluate
    def evaluate(self, *, now: float) -> list[dict]:
        events: list[dict] = []
        with self._lock:
            by_name = {s.name: s for s in self.slos}
            for (name, instance), st in sorted(self._state.items()):
                slo = by_name[name]
                # One burn computation per window, reused by the breach
                # and clear decisions below; keyed by the EXACT window
                # ("%g" — int(w) would collapse 90.0 and 90.5 into one
                # reported key while the decisions still saw both).
                per_window = {
                    (w, f): st["series"].burn(now, w, slo.budget)
                    for w, f in slo.windows
                }
                burns = {
                    f"{w:g}s": b for (w, _f), b in per_window.items()
                }
                st["last_burn"] = burns
                breach_all = all(
                    b["burn"] >= f for (_w, f), b in per_window.items()
                )
                w_short, f_short = slo.shortest_window
                short_ok = (
                    per_window[(w_short, f_short)]["burn"] < f_short
                )
                if not st["firing"] and breach_all:
                    st["firing"] = True
                    st["since"] = now
                    self.fired_total += 1
                    events.append(
                        self._event("fire", slo, instance, now, burns)
                    )
                elif st["firing"] and short_ok:
                    st["firing"] = False
                    st["since"] = None
                    self.cleared_total += 1
                    events.append(
                        self._event("clear", slo, instance, now, burns)
                    )
        for ev in events:
            self._sink(ev)
        return events

    def _event(
        self, kind: str, slo: SLO, instance: str, now: float, burns: dict
    ) -> dict:
        return {
            "schema": ALERT_SCHEMA,
            "ts": float(now),
            "event": kind,
            "slo": slo.name,
            "instance": instance,
            "severity": slo.severity,
            "objective": slo.objective,
            "burn": {
                k: round(v["burn"], 4) for k, v in burns.items()
            },
            "bad": {k: v["bad"] for k, v in burns.items()},
        }

    def _sink(self, ev: dict) -> None:
        if self.sink_path:
            import json

            try:
                append_jsonl_line(self.sink_path, json.dumps(ev))
            except OSError:
                # A full disk must not crash the poll loop at the exact
                # moment the fleet went unhealthy; the event still
                # reaches on_event/recorder below and the in-memory
                # state machine stays correct.
                pass
        if self.on_event is not None:
            self.on_event(ev)
        self._notify(ev)
        rec = self._recorder
        if rec is None:
            from .flight import get_global_recorder

            rec = get_global_recorder()
        if rec is None:
            return
        # EVERY event reaches the ring (a bundle whose alert history
        # shows a fire with no matching clear misleads the postmortem
        # reader); only page-severity fires additionally dump. A dump
        # failure (full disk, unwritable dir) must not crash the poll
        # loop at the precise moment the fleet went unhealthy.
        rec.note_alert(ev)
        if ev["event"] == "fire" and ev["severity"] == "page":
            try:
                rec.maybe_dump("slo-page", extra=ev)
            except OSError:
                pass

    def _notify(self, ev: dict) -> None:
        """Spawn ``alert_cmd`` for one page-severity fire (event JSON on
        stdin, fire-and-forget). Rate limit rides the event's own ``ts``
        — the injectable clock every burn decision already uses."""
        if (
            self.alert_cmd is None
            or ev["event"] != "fire"
            or ev["severity"] != "page"
        ):
            return
        now = float(ev["ts"])
        with self._lock:
            last = self._last_notify_ts
            if last is not None and now - last < self.alert_cmd_interval_s:
                self.notify_suppressed_total += 1
                return
            self._last_notify_ts = now
        import json
        import subprocess

        try:
            proc = subprocess.Popen(
                self.alert_cmd,
                shell=True,
                stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        except (OSError, ValueError):
            # A broken pager (missing shell, bad fd) must never kill
            # the poll loop at the moment the fleet paged. The rate-
            # limit slot stays claimed: a persistently broken command
            # retries once per interval, not once per event.
            return
        try:
            if proc.stdin is not None:
                proc.stdin.write((json.dumps(ev) + "\n").encode())
                proc.stdin.close()
        except OSError:
            # The command spawned but exited before reading stdin
            # (BrokenPipe) — that IS a delivered notification; a pager
            # is free to ignore its input.
            pass
        with self._lock:
            self.notified_total += 1

    # ------------------------------------------------------------- render
    def states(self) -> list[dict]:
        """Current per-(slo, instance) state for the health screen."""
        out = []
        with self._lock:
            by_name = {s.name: s for s in self.slos}
            for (name, instance), st in sorted(self._state.items()):
                slo = by_name[name]
                out.append(
                    {
                        "slo": name,
                        "instance": instance,
                        "severity": slo.severity,
                        "firing": st["firing"],
                        "since": st["since"],
                        "burn": {
                            k: round(v["burn"], 4)
                            for k, v in st["last_burn"].items()
                        },
                    }
                )
        return out
