"""Fleet scrape hub: one process that watches every daemon's health (the
port's copy of the JAX package's ``obs/fleet.py``: it scrapes daemons of
either package, and its records are the JAX hub's).

fedtpu grew into a six-daemon fleet (serve/relay/controller/infer-serve/
route/fleet) where each process exports its own ``/metrics`` and span
JSONL but nothing merges them — the operator's view of "is the fleet
healthy" was N browser tabs. The hub is that missing process:

* **Scrape.** :class:`ScrapeHub` polls every target's ``/metrics.json``
  (the machine-readable twin obs/metrics.py serves next to the
  Prometheus text format) and incrementally tails its events-JSONL
  (byte-offset resume, complete lines only — the DriftMonitor tail
  pattern). A scrape failure marks the target down; it never raises.
* **Merge.** Each poll appends ONE fleet snapshot record to a JSONL
  keyed by (tier, instance): per-target up/down, scrape lag, a compact
  counter/gauge summary, round cadence (rounds_total deltas between
  polls), and the SLO burn states — the file a dashboard or a later
  ``fedtpu obs`` analysis reads back.
* **Judge.** Every poll feeds the snapshots into an
  :class:`~.slo.AlertManager`; burn-rate fires/clears land on the
  alerts-JSONL and page-severity fires trip the flight recorder.
* **Render.** :meth:`ScrapeHub.render_status` is the one-screen fleet
  view behind ``fedtpu obs health`` / ``watch``: per-tier state, SLO
  burn, round cadence, replica in-flight/ejects, controller drift
  state, recent postmortems.

The hub is deliberately a READER of the fleet — it holds no locks any
daemon shares, and a hub crash costs dashboards, never rounds.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Iterable, Mapping

from . import metrics as obs_metrics
from .slo import SLO, AlertManager
from .timeline import read_new_jsonl_lines
from .trace import SCHEMA as TRACE_SCHEMA
from .trace import append_jsonl_line

#: Schema tag on every fleet snapshot record.
FLEET_SCHEMA = "fedtpu-fleet-v1"

#: Schema tag on the ``obs health --json`` machine-readable verdict.
HEALTH_SCHEMA = "fedtpu-health-v1"

#: The daemon tiers the hub knows how to summarize (anything else still
#: scrapes — it just renders the generic counter summary).
KNOWN_TIERS = (
    "serve", "relay", "controller", "infer-serve", "route", "fleet",
)

#: Counter families whose per-poll delta is worth keeping in the
#: snapshot summary (the health screen's cadence/ratio columns).
_SUMMARY_COUNTERS = (
    "fedtpu_server_rounds_total",
    "fedtpu_server_round_failures_total",
    "fedtpu_server_uploads_total",
    "fedtpu_server_stream_fallbacks_total",
    "fedtpu_controller_rounds_total",
    "fedtpu_controller_promotions_total",
    "fedtpu_controller_gate_rejections_total",
    "fedtpu_controller_drift_triggers_total",
    "fedtpu_serve_scored_total",
    "fedtpu_serve_rejects_total",
    "fedtpu_router_forwarded_total",
    "fedtpu_router_ejects_total",
    "fedtpu_router_rejects_total",
)

_SUMMARY_GAUGES = (
    "fedtpu_serve_queue_depth",
    "fedtpu_serve_model_round",
    "fedtpu_server_stream_inflight",
    "fedtpu_router_inflight",
)


@dataclass(frozen=True)
class Target:
    """One scrape target: a daemon's tier + its /metrics.json address,
    plus (optionally) its events-JSONL path for span-level state."""

    tier: str
    host: str
    port: int
    events_jsonl: str | None = None

    @property
    def instance(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def key(self) -> str:
        return f"{self.tier}/{self.instance}"

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics.json"


def parse_target(spec: str) -> Target:
    """``TIER=HOST:PORT[,events=PATH]`` -> :class:`Target` (the --target
    flag's shape). The tier names a lane on the health screen; unknown
    tiers scrape fine but get the generic rendering."""
    head, _, rest = spec.partition(",")
    tier, sep, addr = head.partition("=")
    if not sep or ":" not in addr:
        raise ValueError(
            f"--target {spec!r}: expected TIER=HOST:PORT[,events=PATH]"
        )
    host, _, port_s = addr.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"--target {spec!r}: bad port {port_s!r}") from None
    events = None
    if rest:
        k, _, v = rest.partition("=")
        if k != "events" or not v:
            raise ValueError(
                f"--target {spec!r}: unknown option {rest!r} "
                "(only events=PATH)"
            )
        events = v
    return Target(tier=tier.strip(), host=host, port=port, events_jsonl=events)


def summarize_families(families: Mapping) -> dict:
    """Compact per-target summary out of a /metrics.json body: total
    value per known counter family, per-label values for the known
    gauges (replica in-flight wants the per-replica split)."""
    counters: dict[str, float] = {}
    gauges: dict[str, dict[str, float]] = {}
    for name in _SUMMARY_COUNTERS:
        fam = families.get(name)
        if fam:
            counters[name] = sum(
                float(s.get("value", 0.0)) for s in fam.get("samples", ())
            )
    for name in _SUMMARY_GAUGES:
        fam = families.get(name)
        if fam:
            gauges[name] = {
                ",".join(
                    f"{k}={v}" for k, v in sorted(
                        (s.get("labels") or {}).items()
                    )
                ): float(s.get("value", 0.0))
                for s in fam.get("samples", ())
            }
    return {"counters": counters, "gauges": gauges}


class ScrapeHub:
    """Poll -> merge -> judge -> render, one instance per operator
    console (or per cron tick). All clocks are injectable for tests:
    ``poll(now=...)`` threads one timestamp through scrape records,
    burn windows, and the snapshot JSONL."""

    def __init__(
        self,
        targets: Iterable[Target],
        *,
        slos: Iterable[SLO] | None = None,
        alerts_jsonl: str | None = None,
        snapshot_jsonl: str | None = None,
        snapshot_max_mb: float | None = None,
        scrape_timeout_s: float = 2.0,
        tracer=None,
        recorder=None,
        alert_cmd: str | None = None,
        alert_cmd_interval_s: float = 30.0,
    ):
        self.targets = list(targets)
        if not self.targets:
            raise ValueError("scrape hub needs at least one target")
        keys = [t.key for t in self.targets]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate scrape targets: {keys}")
        self.snapshot_jsonl = snapshot_jsonl
        if snapshot_max_mb is not None and float(snapshot_max_mb) <= 0:
            raise ValueError(
                f"snapshot_max_mb={snapshot_max_mb} must be > 0"
            )
        self.snapshot_max_mb = (
            float(snapshot_max_mb) if snapshot_max_mb is not None else None
        )
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.tracer = tracer
        self.alerts = AlertManager(
            slos,
            sink_path=alerts_jsonl,
            recorder=recorder,
            alert_cmd=alert_cmd,
            alert_cmd_interval_s=alert_cmd_interval_s,
        )
        self._lock = threading.Lock()
        # target.key -> scrape state: last summary, cadence base, events
        # tail offset, recent notable spans.
        self._state: dict[str, dict] = {
            t.key: {
                "up": False,
                "summary": None,
                "prev": None,  # (now, counters) for cadence deltas
                "cadence": {},
                "events_offset": 0,
                "last_drift": None,
                "postmortems": 0,
                "last_postmortem": None,
                "last_round_failed": False,
                "scrape_lag_ms": None,
                "error": None,
            }
            for t in self.targets
        }
        self.polls = 0
        self.last_scrape_lag_ms: float | None = None
        # The hub's own exported health (it may itself be scraped).
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's obs/fleet.py family, same name/kind/labels/help
        self._m_polls = m.counter(
            "fedtpu_obs_polls_total",
            help="fleet scrape-hub poll passes",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's obs/fleet.py family, same name/kind/labels/help
        self._m_scrape_errors = m.counter(
            "fedtpu_obs_scrape_errors_total",
            help="failed target scrapes (marked down, never fatal)",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's obs/fleet.py family, same name/kind/labels/help
        self._g_scrape_lag = m.gauge(
            "fedtpu_obs_scrape_lag_ms",
            help="worst per-target scrape latency of the last poll",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's obs/fleet.py family, same name/kind/labels/help
        self._g_targets_up = m.gauge(
            "fedtpu_obs_targets_up",
            help="targets answering /metrics.json on the last poll",
        )

    # --------------------------------------------------------------- scrape
    def _scrape(self, target: Target) -> tuple[dict | None, float, str | None]:
        """(families | None, lag_ms, error)."""
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(
                target.url, timeout=self.scrape_timeout_s
            ) as resp:
                doc = json.loads(resp.read())
        except Exception as e:  # connection refused, timeout, bad JSON
            return None, (time.monotonic() - t0) * 1e3, f"{type(e).__name__}: {e}"
        lag_ms = (time.monotonic() - t0) * 1e3
        if (
            not isinstance(doc, dict)
            or doc.get("schema") != obs_metrics.SNAPSHOT_SCHEMA
        ):
            return None, lag_ms, "foreign document (not a fedtpu metrics snapshot)"
        return doc.get("families") or {}, lag_ms, None

    def _tail_events(self, target: Target, st: dict) -> None:
        """Incremental events-JSONL tail (read_new_jsonl_lines): keep
        the spans that matter to the health screen — drift verdicts,
        postmortem dumps, failed rounds."""
        path = target.events_jsonl
        if not path:
            return
        st["events_offset"], lines = read_new_jsonl_lines(
            path, st["events_offset"]
        )
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict) or rec.get("schema") != TRACE_SCHEMA:
                continue
            span = rec.get("span")
            if span == "drift-trigger":
                st["last_drift"] = {
                    k: rec.get(k)
                    for k in ("ts", "drift", "method", "top_bins")
                }
            elif span == "postmortem-dump":
                st["postmortems"] += 1
                st["last_postmortem"] = {
                    "ts": rec.get("ts"),
                    "reason": rec.get("reason"),
                    "bundle": rec.get("bundle"),
                }
            elif span == "round":
                st["last_round_failed"] = bool(rec.get("failed"))

    # ----------------------------------------------------------------- poll
    def poll(self, *, now: float | None = None) -> dict:
        """One scrape pass over every target: updates burn state, fires/
        clears alerts, appends the fleet snapshot record, and returns
        it. ``now`` is injectable so burn-window tests never sleep."""
        t_unix = time.time()
        if now is None:
            now = t_unix
        events: list[dict]
        rows: list[dict] = []
        worst_lag: float | None = None
        n_up = 0
        # Scrape every target CONCURRENTLY: each down/slow daemon costs
        # up to scrape_timeout_s, and paying that serially would stall
        # the whole screen by N*timeout exactly during the incident the
        # health view exists for (and skew the burn-window timestamps
        # of the targets scraped last). The hub is a pure reader —
        # nothing shared is touched until the locked section below.
        scraped: dict[str, tuple] = {}

        def _scrape_into(t: Target) -> None:
            scraped[t.key] = self._scrape(t)

        if len(self.targets) == 1:
            _scrape_into(self.targets[0])
        else:
            threads = [
                threading.Thread(
                    target=_scrape_into, args=(t,), daemon=True
                )
                for t in self.targets
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=self.scrape_timeout_s + 2.0)
        for target in self.targets:
            families, lag_ms, err = scraped.get(
                target.key,
                (None, self.scrape_timeout_s * 1e3, "scrape timed out"),
            )
            with self._lock:
                st = self._state[target.key]
                st["scrape_lag_ms"] = round(lag_ms, 3)
                st["error"] = err
                st["up"] = families is not None
                if families is not None:
                    n_up += 1
                    summary = summarize_families(families)
                    st["summary"] = summary
                    prev = st["prev"]
                    cadence: dict[str, float] = {}
                    if prev is not None and now > prev[0]:
                        dt = now - prev[0]
                        for name, v in summary["counters"].items():
                            base = prev[1].get(name)
                            if base is not None and v >= base:
                                cadence[name] = (v - base) / dt
                    st["cadence"] = cadence
                    st["prev"] = (now, dict(summary["counters"]))
                else:
                    self._m_scrape_errors.inc()
                self._tail_events(target, st)
                row = self._row(target, st)
            rows.append(row)
            if families is not None:
                self.alerts.ingest(
                    families, now=now, instance=target.key
                )
            worst_lag = lag_ms if worst_lag is None else max(worst_lag, lag_ms)
        events = self.alerts.evaluate(now=now)
        with self._lock:
            self.polls += 1
            self.last_scrape_lag_ms = (
                round(worst_lag, 3) if worst_lag is not None else None
            )
        self._m_polls.inc()
        self._g_targets_up.set(float(n_up))
        if worst_lag is not None:
            self._g_scrape_lag.set(round(worst_lag, 3))
        snapshot = {
            "schema": FLEET_SCHEMA,
            "ts": t_unix,
            "targets": rows,
            "slo": self.alerts.states(),
            "events": events,
            "scrape_lag_ms": self.last_scrape_lag_ms,
        }
        if self.snapshot_jsonl:
            try:
                self._write_snapshot(json.dumps(snapshot))
            except OSError:
                pass  # a full disk costs the record, never the poll loop
        if self.tracer is not None:
            self.tracer.record(
                "slo-eval",
                t_start=t_unix,
                dur_s=(worst_lag or 0.0) / 1e3,
                targets=len(self.targets),
                up=n_up,
                firing=sum(1 for s in snapshot["slo"] if s["firing"]),
                scrape_lag_ms=self.last_scrape_lag_ms,
            )
        return snapshot

    def _write_snapshot(self, line: str) -> None:
        """Append one snapshot record, with bounded retention when
        ``snapshot_max_mb`` is set: once the live file crosses the cap
        it is atomically rolled to ``<path>.1`` (os.replace — a reader
        sees the old file or the new, never a torn middle) and the
        write starts a fresh generation, so an unattended ``--watch``
        holds at most ~2x the cap on disk. The capped path deliberately
        avoids append_jsonl_line's shared long-lived fd: a cached fd
        would pin the rotated inode and keep growing it invisibly."""
        if self.snapshot_max_mb is None:
            append_jsonl_line(self.snapshot_jsonl, line)
            return
        path = self.snapshot_jsonl
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            if os.path.getsize(path) >= self.snapshot_max_mb * 1024 * 1024:
                os.replace(path, path + ".1")
        except OSError:
            pass  # no file yet — the append below creates it
        with open(path, "a") as f:
            f.write(line + "\n")

    @staticmethod
    def _row(target: Target, st: dict) -> dict:
        """The per-target snapshot row — the ONE shape both poll()'s
        fleet-JSONL record and render_status(None) emit (two hand-built
        copies had already drifted once). Caller holds ``_lock``."""
        return {
            "tier": target.tier,
            "instance": target.instance,
            "up": st["up"],
            "scrape_lag_ms": st["scrape_lag_ms"],
            "summary": st["summary"],
            "cadence": {k: round(v, 4) for k, v in st["cadence"].items()},
            "last_drift": st["last_drift"],
            "postmortems": st["postmortems"],
            "last_round_failed": st["last_round_failed"],
            "error": st["error"],
        }

    # --------------------------------------------------------------- render
    def render_status(self, snapshot: dict | None = None) -> str:
        """The one-screen fleet view (``fedtpu obs health``). Pass the
        snapshot :meth:`poll` just returned, or None to render the last
        known state without scraping."""
        if snapshot is None:
            with self._lock:
                rows = [
                    self._row(t, self._state[t.key]) for t in self.targets
                ]
            states = self.alerts.states()
        else:
            rows = snapshot["targets"]
            states = snapshot["slo"]
        out: list[str] = []
        n_up = sum(1 for r in rows if r["up"])
        out.append(
            f"fedtpu fleet health  {time.strftime('%H:%M:%S')}  "
            f"({n_up}/{len(rows)} targets up, "
            f"{sum(1 for s in states if s['firing'])} alert(s) firing)"
        )
        out.append("")
        out.append(
            f"  {'tier':<12} {'instance':<22} {'up':<5} "
            f"{'lag':>7}  state"
        )
        for r in rows:
            lag = (
                f"{r['scrape_lag_ms']:.0f}ms"
                if r.get("scrape_lag_ms") is not None
                else "-"
            )
            out.append(
                f"  {r['tier']:<12} {r['instance']:<22} "
                f"{'ok' if r['up'] else 'DOWN':<5} {lag:>7}  "
                f"{self._state_line(r)}"
            )
        firing = [s for s in states if s["firing"]]
        out.append("")
        out.append("  SLO burn:")
        if not states:
            out.append("    (no SLO has seen data yet)")
        for s in states:
            burn = ", ".join(
                f"{w} {v:.1f}" for w, v in sorted(s["burn"].items())
            )
            flag = "FIRING" if s["firing"] else "ok"
            out.append(
                f"    {s['slo']:<24} {s['instance']:<30} {flag:<7} {burn}"
            )
        if firing:
            out.append("")
            out.append(
                f"  {len(firing)} alert(s) FIRING: "
                + ", ".join(f"{s['slo']}@{s['instance']}" for s in firing)
            )
        notable: list[str] = []
        for r in rows:
            if r.get("last_drift"):
                d = r["last_drift"]
                notable.append(
                    f"drift {d.get('method')}={d.get('drift')} on "
                    f"{r['tier']}/{r['instance']} top_bins="
                    f"{d.get('top_bins')}"
                )
            if r.get("postmortems"):
                notable.append(
                    f"{r['postmortems']} postmortem bundle(s) from "
                    f"{r['tier']}/{r['instance']}"
                )
        if notable:
            out.append("")
            out.append("  recent: " + "; ".join(notable))
        return "\n".join(out) + "\n"

    @staticmethod
    def _state_line(row: dict) -> str:
        """Per-tier key state out of the counter/gauge summary."""
        if not row["up"]:
            return row.get("error") or "unreachable"
        summary = row.get("summary") or {}
        c = summary.get("counters", {})
        g = summary.get("gauges", {})
        cadence = row.get("cadence", {})
        bits: list[str] = []
        if row.get("last_round_failed"):
            bits.append("LAST ROUND FAILED")

        def _count(name: str, label: str) -> None:
            if name in c:
                bits.append(f"{label} {c[name]:.0f}")

        rounds_rate = cadence.get(
            "fedtpu_server_rounds_total"
        ) or cadence.get("fedtpu_controller_rounds_total")
        if rounds_rate is not None:
            bits.append(f"{rounds_rate * 60.0:.1f} rounds/min")
        _count("fedtpu_server_rounds_total", "rounds")
        _count("fedtpu_server_round_failures_total", "failed")
        _count("fedtpu_server_uploads_total", "uploads")
        _count("fedtpu_server_stream_fallbacks_total", "fallbacks")
        _count("fedtpu_controller_promotions_total", "promoted")
        _count("fedtpu_controller_gate_rejections_total", "gate-rejected")
        _count("fedtpu_controller_drift_triggers_total", "drift-triggers")
        _count("fedtpu_serve_scored_total", "scored")
        _count("fedtpu_serve_rejects_total", "rejects")
        _count("fedtpu_router_forwarded_total", "fwd")
        _count("fedtpu_router_ejects_total", "ejects")
        if "fedtpu_serve_queue_depth" in g:
            depth = sum(g["fedtpu_serve_queue_depth"].values())
            bits.append(f"queue {depth:.0f}")
        if "fedtpu_router_inflight" in g:
            per = g["fedtpu_router_inflight"]
            bits.append(
                "inflight "
                + "/".join(
                    f"{per[k]:.0f}" for k in sorted(per)
                )
            )
        return ", ".join(bits) if bits else "(no known families)"

    # ---------------------------------------------------------------- watch
    def watch(
        self,
        *,
        interval_s: float = 2.0,
        max_seconds: float | None = None,
        out=None,
        stop=None,
    ) -> int:
        """The ``--watch`` loop: poll + render every ``interval_s``,
        clearing the screen between frames (the obs tail follow shape:
        deadline-bounded, stop-callable, KeyboardInterrupt = clean
        exit). Returns the number of polls."""
        import sys

        out = out or sys.stdout
        deadline = (
            time.monotonic() + float(max_seconds)
            if max_seconds is not None
            else None
        )
        n = 0
        try:
            while True:
                snapshot = self.poll()
                frame = self.render_status(snapshot)
                out.write("\x1b[2J\x1b[H" if out.isatty() else "")
                out.write(frame)
                out.flush()
                n += 1
                if stop is not None and stop():
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                sleep_for = float(interval_s)
                if deadline is not None:
                    sleep_for = min(
                        sleep_for, max(deadline - time.monotonic(), 0.0)
                    )
                time.sleep(sleep_for)
        except KeyboardInterrupt:
            pass
        return n


def health_verdict(snapshot: dict) -> dict:
    """The machine-readable twin of :meth:`ScrapeHub.render_status` —
    ``fedtpu obs health --json``'s contract for cron/CI consumers.

    Same judgement the rendered screen (and the CLI's exit code) makes,
    as one schema-versioned dict: ``healthy`` is False exactly when a
    target is down or an SLO is firing. Raw per-target summaries stay
    in the snapshot JSONL; this is the verdict layer."""
    rows = snapshot.get("targets") or []
    states = snapshot.get("slo") or []
    down = [
        {
            "tier": r["tier"],
            "instance": r["instance"],
            "error": r.get("error"),
        }
        for r in rows
        if not r["up"]
    ]
    firing = [
        {
            "slo": s["slo"],
            "instance": s["instance"],
            "severity": s.get("severity"),
            "burn": s.get("burn"),
        }
        for s in states
        if s["firing"]
    ]
    notable: list[dict] = []
    for r in rows:
        if r.get("last_drift"):
            notable.append(
                {
                    "kind": "drift",
                    "tier": r["tier"],
                    "instance": r["instance"],
                    **{
                        k: r["last_drift"].get(k)
                        for k in ("ts", "drift", "method")
                    },
                }
            )
        if r.get("postmortems"):
            notable.append(
                {
                    "kind": "postmortems",
                    "tier": r["tier"],
                    "instance": r["instance"],
                    "count": r["postmortems"],
                }
            )
        if r.get("last_round_failed"):
            notable.append(
                {
                    "kind": "round-failed",
                    "tier": r["tier"],
                    "instance": r["instance"],
                }
            )
    return {
        "schema": HEALTH_SCHEMA,
        "ts": snapshot.get("ts"),
        "healthy": not down and not firing,
        "targets": len(rows),
        "targets_up": sum(1 for r in rows if r["up"]),
        "targets_down": down,
        "slo_total": len(states),
        "slo_firing": firing,
        "scrape_lag_ms": snapshot.get("scrape_lag_ms"),
        "notable": notable,
    }
