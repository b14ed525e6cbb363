"""Sentinel plane: canary probing, journal-tailing supervised drift, and
long-horizon regression detection — ``obs sentinel`` (the port's copy of
the JAX package's ``obs/sentinel.py``; its probes go through the port's
scoring client, its journal tail feeds the port's ``ErrorRateMonitor``).

The health plane up to here answers "what is burning NOW": every scrape-
hub verdict is a two-poll delta with no memory, the supervised error
monitor only ran when a gate happened to look, and nothing continuously
proved the router -> replica -> score chain end to end against known
truth. Fleets degrade *gradually* between rounds — exactly the failure
mode an instantaneous view structurally cannot see. The sentinel is one
standalone watch daemon with three rungs:

* **Canary probes** (:class:`CanaryProber`). A checked-in set of
  known-label flows (benign + attack, per preset — the
  ``tests/data/canary_flows.jsonl`` fixture shape) is scored on a
  cadence through the REAL serving chain via the scoring SDK
  (serving/client.probe_scores). Each pass asserts (1) the reply's
  model round matches the registry's promoted serving pointer — a stale
  replica answering for a superseded artifact is an incident — and
  (2) the score is bit-stable per (serving artifact, canary id): a
  score flip WITHOUT a promotion is an incident (a legitimate promotion
  changes the artifact id, which re-keys the expectation and never
  fires). End-to-end latency feeds ``fedtpu_canary_latency_seconds``
  (the canary SLO's histogram); results ride ``canary-probe`` spans and
  page-severity incidents trip the flight recorder.
* **Journal tailing** (:class:`JournalTail`). The serving tier's
  scored-JSONL export and the ground-truth journal (labels/store.py)
  are tailed incrementally (byte-offset resume, complete lines only —
  the DriftMonitor discipline); joined (prediction, label) pairs feed a
  :class:`~..control.drift.ErrorRateMonitor` CONTINUOUSLY, so a
  supervised-drift verdict can fire BETWEEN gates. A fired verdict is
  journaled to a verdicts-JSONL the controller's
  :class:`~..control.drift.SentinelLink` tails — the cross-process poke
  that starts a corrective round.
* **Long-horizon retention** (:class:`RetentionRing`). A downsampled
  on-disk ring of compact per-tick rows (canary p99, round cadence,
  supervised error, eject rate) with pure-arithmetic trend checks
  against a PINNED baseline window: the first ``baseline_n`` retained
  rows are frozen, and a current-window mean moving past
  ``baseline * ratio + floor`` (direction-aware — cadence regresses
  DOWN) fires a ``regression-fire`` span + alert with the
  baseline-vs-now evidence attached.

The sentinel is a READER of the fleet (the scrape-hub contract): it
holds no lock any daemon shares, and a sentinel crash costs detection,
never rounds or requests.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Mapping

from . import metrics as obs_metrics
from .flight import get_global_recorder
from .slo import ALERT_SCHEMA
from .timeline import read_new_jsonl_lines
from .trace import append_jsonl_line

#: Schema tag on every canary-fixture line (tests/data/canary_flows.jsonl).
CANARY_SCHEMA = "fedtpu-canary-v1"

#: Schema tag on every sentinel tick report (``obs sentinel --json``).
SENTINEL_SCHEMA = "fedtpu-sentinel-v1"

#: Schema tag on every retention-ring row.
RING_SCHEMA = "fedtpu-ring-v1"

#: Schema tag on every journaled supervised-drift verdict (the file the
#: controller's SentinelLink tails).
VERDICT_SCHEMA = "fedtpu-sentinel-verdict-v1"

#: The ring fields the stock trend check watches, with (ratio, floor,
#: direction): a regression fires when the current-window mean moves
#: past ``baseline * ratio + floor`` for "up" fields, or below
#: ``baseline / ratio - floor`` for "down" fields (round cadence
#: regresses by DROPPING).
DEFAULT_TREND_FIELDS: dict[str, tuple[float, float, str]] = {
    "latency_p99_ms": (1.5, 5.0, "up"),
    "round_cadence": (1.5, 0.0, "down"),
    "supervised_error": (1.5, 0.02, "up"),
    "eject_rate": (1.5, 0.001, "up"),
}


def parse_trend_field_spec(spec: str) -> tuple[str, tuple[float, float, str]]:
    """One ``--trend-field NAME[:direction]`` value -> a
    ``(name, (ratio, floor, direction))`` trend-fields entry.

    Per-deployment ring fields: the named counter's per-tick rate is
    pulled from the fleet snapshot's cadence dicts (max across targets,
    exactly how the stock ``round_cadence``/``eject_rate`` rows are
    built) and judged by the same pure-arithmetic baseline/window check
    as the stock fields. Direction defaults to "up" (a counter whose
    RATE growing past baseline*ratio is the regression); ":down" watches
    for the rate collapsing (a heartbeat counter going quiet). The
    stock ratio/floor defaults (1.5, 0.0) apply — deployments needing
    custom thresholds pair this with ``--regression-ratio``."""
    name, sep, direction = spec.partition(":")
    name = name.strip()
    direction = direction.strip() if sep else "up"
    if not name:
        raise ValueError(
            f"--trend-field {spec!r}: want NAME or NAME:direction "
            "(e.g. fedtpu_server_stream_fallbacks_total:up)"
        )
    if direction not in ("up", "down"):
        raise ValueError(
            f"--trend-field {spec!r}: direction must be up|down "
            f"(got {direction!r})"
        )
    return name, (1.5, 0.0, direction)


# ------------------------------------------------------------------ canaries
@dataclass(frozen=True)
class CanaryFlow:
    """One checked-in known-truth flow: a rendered template text plus
    the label the fleet must keep agreeing with itself about."""

    id: str
    preset: str
    label: int
    text: str
    #: K-class presets carry the class NAME too (class 0 = benign by
    #: the data/datasets.py convention); binary presets leave it None.
    class_label: str | None = None


def load_canary_flows(
    path: str, *, preset: str | None = None
) -> list[CanaryFlow]:
    """Read + validate a ``fedtpu-canary-v1`` fixture JSONL.

    Every line must carry the schema tag, a unique non-empty ``id``, a
    ``preset``, an integer ``label`` >= 0, and a non-empty ``text``.
    Foreign or torn lines FAIL LOUDLY — a silently dropped canary is a
    silently narrowed proof. ``preset`` filters to one dataset's
    canaries (the fixture is per-preset by design)."""
    flows: list[CanaryFlow] = []
    seen: set[str] = set()
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: not JSON ({e})"
                ) from None
            if not isinstance(rec, dict) or rec.get("schema") != CANARY_SCHEMA:
                raise ValueError(
                    f"{path}:{lineno}: not a {CANARY_SCHEMA} record"
                )
            missing = [
                k for k in ("id", "preset", "label", "text") if not rec.get(k)
                and rec.get(k) != 0
            ]
            if missing:
                raise ValueError(f"{path}:{lineno}: missing {missing}")
            cid = str(rec["id"])
            if cid in seen:
                raise ValueError(f"{path}:{lineno}: duplicate canary id {cid!r}")
            seen.add(cid)
            label = rec["label"]
            if not isinstance(label, int) or label < 0:
                raise ValueError(
                    f"{path}:{lineno}: label {label!r} must be an int >= 0"
                )
            flows.append(
                CanaryFlow(
                    id=cid,
                    preset=str(rec["preset"]),
                    label=label,
                    text=str(rec["text"]),
                    class_label=rec.get("class_label"),
                )
            )
    if preset is not None:
        have = sorted({f.preset for f in flows})
        flows = [f for f in flows if f.preset == preset]
        if not flows:
            raise ValueError(
                f"{path}: no canaries for preset {preset!r} (have {have})"
            )
    if not flows:
        raise ValueError(f"{path}: no canary flows")
    return flows


class CanaryProber:
    """Rung 1: score the canary set through the live serving chain and
    hold the fleet to the registry's promoted pointer.

    ``probe_fn`` defaults to :func:`~..serving.client.probe_scores`
    (one real TCP connection per pass); tests inject a fake. A probe
    pass NEVER raises — a down serving tier is a counted failure, not a
    sentinel crash."""

    def __init__(
        self,
        flows: Iterable[CanaryFlow],
        host: str,
        port: int,
        *,
        registry=None,
        timeout_s: float = 5.0,
        deadline_ms: float | None = None,
        auth_key: bytes | None = None,
        tracer=None,
        recorder=None,
        probe_fn: Callable | None = None,
    ):
        self.flows = list(flows)
        if not self.flows:
            raise ValueError("canary prober needs at least one flow")
        self.host = host
        self.port = int(port)
        self.registry = registry
        self.timeout_s = float(timeout_s)
        self.deadline_ms = deadline_ms
        self.auth_key = auth_key
        self.tracer = tracer
        self._recorder = recorder
        if probe_fn is None:
            from ..serving.client import probe_scores

            probe_fn = probe_scores
        self._probe_fn = probe_fn
        # (serving artifact id, canary id) -> last observed probability.
        # A legitimate promotion changes the artifact id, so its score
        # change lands under a FRESH key and can never fire.
        self._scores: dict[tuple[str, str], float] = {}
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's obs/sentinel.py family, same name/kind/labels/help
        self._m_probes = m.counter(
            "fedtpu_canary_probes_total",
            help="canary flows scored through the live serving chain",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's obs/sentinel.py family, same name/kind/labels/help
        self._m_failures = m.counter(
            "fedtpu_canary_failures_total",
            help="canary probe passes that could not reach the serving tier",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's obs/sentinel.py family, same name/kind/labels/help
        self._m_incidents = m.counter(
            "fedtpu_canary_incidents_total",
            help="canary incidents: stale-pointer round mismatches plus "
            "score flips without a promotion",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's obs/sentinel.py family, same name/kind/labels/help
        self._m_latency = m.histogram(
            "fedtpu_canary_latency_seconds",
            help="end-to-end canary score latency through the SDK "
            "(the canary SLO's histogram)",
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5),
        )

    def _pointer(self) -> tuple[str | None, int | None]:
        """(serving artifact id, its round) off the registry — None/None
        when no registry is wired or nothing is promoted yet."""
        if self.registry is None:
            return None, None
        try:
            info = self.registry.serving_info()
        except Exception:
            return None, None
        if not info:
            return None, None
        return info.get("artifact"), info.get("round")

    def probe(self, *, now: float | None = None) -> dict:
        """One pass: score every canary, judge identity + bit-stability
        + latency, ride a ``canary-probe`` span, trip the recorder on
        incidents. Returns the pass verdict dict."""
        if now is None:
            now = time.time()
        artifact, expected_round = self._pointer()
        t0 = time.monotonic()
        incidents: list[dict] = []
        latencies_ms: list[float] = []
        failures = 0
        replies: list[tuple[dict, float]] = []
        try:
            replies = self._probe_fn(
                self.host,
                self.port,
                [f.text for f in self.flows],
                timeout=self.timeout_s,
                deadline_ms=self.deadline_ms,
                auth_key=self.auth_key,
            )
        except Exception as e:  # down tier = counted, never fatal
            failures = len(self.flows)
            self._m_failures.inc(failures)
            incidents.append(
                {
                    "kind": "probe-failure",
                    "detail": f"{type(e).__name__}: {str(e)[:200]}",
                }
            )
        flips = mismatches = wrong = 0
        for flow, (reply, lat_s) in zip(self.flows, replies):
            self._m_probes.inc()
            self._m_latency.observe(lat_s)
            latencies_ms.append(lat_s * 1e3)
            if reply.get("rejected"):
                failures += 1
                self._m_failures.inc()
                incidents.append(
                    {
                        "kind": "probe-reject",
                        "canary": flow.id,
                        "code": reply.get("code"),
                        "reason": reply.get("reason"),
                    }
                )
                continue
            got_round = reply.get("round")
            stale = (
                expected_round is not None
                and got_round is not None
                and int(got_round) != int(expected_round)
            )
            if stale:
                mismatches += 1
                incidents.append(
                    {
                        "kind": "pointer-mismatch",
                        "canary": flow.id,
                        "reply_round": int(got_round),
                        "expected_round": int(expected_round),
                        "artifact": artifact,
                    }
                )
            prob = float(reply["prob"])
            # Bit-stability is keyed by what actually ANSWERED: on a
            # pointer mismatch the registry's artifact id is exactly the
            # claim that proved false, so keying the score under it
            # would fire a spurious flip when the replica is repaired.
            key = (
                (artifact if not stale else None) or f"round-{got_round}",
                flow.id,
            )
            prev = self._scores.get(key)
            if prev is not None and prob != prev:
                flips += 1
                incidents.append(
                    {
                        "kind": "score-flip",
                        "canary": flow.id,
                        "artifact": key[0],
                        "prev_prob": prev,
                        "prob": prob,
                    }
                )
            self._scores[key] = prob
            if int(reply.get("prediction", 0)) != (1 if flow.label else 0):
                # A persistently misclassified canary is a QUALITY
                # signal the report surfaces, not a stability incident
                # — a weak model is the gate's problem, not an outage.
                wrong += 1
        if incidents:
            self._m_incidents.inc(len(incidents))
        latencies_ms.sort()
        p99_ms = (
            latencies_ms[max(0, int(len(latencies_ms) * 0.99) - 1)]
            if latencies_ms
            else None
        )
        result = {
            "probes": len(replies),
            "failures": failures,
            "mismatches": mismatches,
            "flips": flips,
            "wrong_label": wrong,
            "incidents": incidents,
            "artifact": artifact,
            "expected_round": expected_round,
            "latency_p99_ms": round(p99_ms, 3) if p99_ms is not None else None,
        }
        if self.tracer is not None:
            self.tracer.record(
                "canary-probe",
                t_start=now,
                dur_s=time.monotonic() - t0,
                canaries=len(self.flows),
                probes=len(replies),
                failures=failures,
                mismatches=mismatches,
                flips=flips,
                artifact=artifact,
                latency_p99_ms=result["latency_p99_ms"],
            )
        if mismatches or flips:
            rec = self._recorder or get_global_recorder()
            if rec is not None:
                try:
                    rec.maybe_dump(
                        "canary-incident",
                        extra={"incidents": incidents[:10]},
                    )
                except OSError:
                    pass
        return result


# ------------------------------------------------------------ journal tailing
class JournalTail:
    """Rung 2: the between-gates supervised drift poll loop.

    Tails the serving tier's scored-JSONL (rid -> prob) and the
    ground-truth journal (rid -> label, plus the completeness
    watermark), joins pairs as both sides arrive, and feeds an
    :class:`~..control.drift.ErrorRateMonitor` continuously — closing
    the "error monitor only observes at gate time" gap. A fired verdict
    is journaled to ``verdicts_jsonl`` for the controller's
    SentinelLink to tail."""

    #: Unjoined scored flows retained while their label is in flight;
    #: oldest evicted beyond this (delayed truth is partial by nature).
    MAX_PENDING = 100_000

    def __init__(
        self,
        scored_jsonl: str,
        journal: str,
        *,
        monitor,
        threshold: float = 0.5,
        verdicts_jsonl: str | None = None,
        tracer=None,
    ):
        self.scored_jsonl = scored_jsonl
        self.journal = journal
        self.monitor = monitor
        self.threshold = float(threshold)
        self.verdicts_jsonl = verdicts_jsonl
        self.tracer = tracer
        self._scored_offset = 0
        self._journal_offset = 0
        self._pending: dict[str, float] = {}  # rid -> prob, label not yet seen
        self._labels: dict[str, int] = {}  # rid -> label, score not yet seen
        # Recent (wrong, total) per poll — the tail's OWN error window
        # for the retention ring, surviving the monitor's reset-on-fire.
        self._recent: list[tuple[int, int]] = []
        self.watermark: float | None = None
        self.joined_total = 0
        self.fires = 0
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's obs/sentinel.py family, same name/kind/labels/help
        self._m_joined = m.counter(
            "fedtpu_sentinel_joined_total",
            help="scored flows joined against delayed ground truth by "
            "the sentinel's journal tail",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's obs/sentinel.py family, same name/kind/labels/help
        self._m_drift_fires = m.counter(
            "fedtpu_sentinel_drift_fires_total",
            help="supervised-drift verdicts fired between gates",
        )

    def _evict(self) -> None:
        while len(self._pending) > self.MAX_PENDING:
            self._pending.pop(next(iter(self._pending)))

    def poll(self, *, now: float | None = None) -> dict:
        """One tail pass: ingest new scored records + labels, join, feed
        the monitor, check for a verdict. Returns the rung status (with
        ``verdict`` set on a fire, None otherwise)."""
        if now is None:
            now = time.time()
        pairs: list[tuple[int, int]] = []  # (prediction, label)
        self._scored_offset, scored_lines = read_new_jsonl_lines(
            self.scored_jsonl, self._scored_offset
        )
        for line in scored_lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict) or "rid" not in rec or "prob" not in rec:
                continue
            rid = str(rec["rid"])
            prob = float(rec["prob"])
            label = self._labels.pop(rid, None)
            if label is not None:
                pairs.append((1 if prob >= self.threshold else 0, label))
            else:
                self._pending[rid] = prob
        self._evict()
        self._journal_offset, label_lines = read_new_jsonl_lines(
            self.journal, self._journal_offset
        )
        for line in label_lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            if "watermark" in rec:
                wm = float(rec["watermark"])
                if self.watermark is None or wm > self.watermark:
                    self.watermark = wm
                continue
            if "rid" not in rec or "label" not in rec:
                continue
            rid = str(rec["rid"])
            label = 1 if int(rec["label"]) else 0
            prob = self._pending.pop(rid, None)
            if prob is not None:
                pairs.append((1 if prob >= self.threshold else 0, label))
            else:
                self._labels[rid] = label
        verdict = None
        if pairs:
            wrong = sum(1 for pred, label in pairs if pred != label)
            self.monitor.observe(wrong, len(pairs))
            self.joined_total += len(pairs)
            self._m_joined.inc(len(pairs))
            self._recent.append((wrong, len(pairs)))
            del self._recent[:-32]
        # check() even on an empty poll: the window may already hold
        # enough joined evidence from earlier passes.
        fired = self.monitor.check()
        if fired is not None:
            self.fires += 1
            self._m_drift_fires.inc()
            verdict = {"schema": VERDICT_SCHEMA, "ts": float(now), **fired}
            if self.watermark is not None:
                verdict["watermark"] = self.watermark
            if self.verdicts_jsonl:
                try:
                    append_jsonl_line(self.verdicts_jsonl, json.dumps(verdict))
                except OSError:
                    pass  # a full disk costs the poke, never the loop
        return {
            "joined": self.joined_total,
            "pending": len(self._pending),
            "unmatched_labels": len(self._labels),
            "watermark": self.watermark,
            "window_error": self._window_error(),
            "fires": self.fires,
            "verdict": verdict,
        }

    def _window_error(self) -> float | None:
        """Error rate over the last <=32 polls' joined pairs (None
        before any join) — the retention ring's supervised_error input.
        Kept here rather than read off the monitor: a fired verdict
        resets the monitor's window, and the ring wants continuity."""
        wrong = sum(w for w, _ in self._recent)
        total = sum(t for _, t in self._recent)
        return (wrong / total) if total else None


# ------------------------------------------------------------- retention ring
class RetentionRing:
    """Rung 3: bounded long-horizon memory + pure-arithmetic trend
    verdicts.

    ``note`` keeps every ``stride``-th row (downsampling makes a day of
    2 s polls a few hundred rows) in memory AND on disk; the file is
    compacted with an atomic ``os.replace`` roll when it doubles past
    ``max_records`` (a plain per-note append — the ring is single-
    writer, so the obs/trace.py shared-fd discipline is not needed and
    would pin the rotated inode). The BASELINE window is the first
    ``baseline_n`` retained rows, frozen once full: "how the fleet
    looked when watching began" is exactly the pin a slow regression is
    measured against."""

    def __init__(
        self,
        path: str | None = None,
        *,
        max_records: int = 512,
        stride: int = 1,
        baseline_n: int = 8,
        window_n: int = 8,
        trend_fields: Mapping[str, tuple[float, float, str]] | None = None,
    ):
        if max_records < max(baseline_n, window_n):
            raise ValueError(
                f"max_records={max_records} must hold at least the "
                f"baseline ({baseline_n}) and current ({window_n}) windows"
            )
        if stride < 1:
            raise ValueError(f"stride={stride} must be >= 1")
        self.path = path
        self.max_records = int(max_records)
        self.stride = int(stride)
        self.baseline_n = int(baseline_n)
        self.window_n = int(window_n)
        self.trend_fields = dict(
            DEFAULT_TREND_FIELDS if trend_fields is None else trend_fields
        )
        self._lock = threading.Lock()
        self._records: list[dict] = []
        self._baseline: list[dict] = []
        self._seen = 0
        self._firing: set[str] = set()
        if path and os.path.exists(path):
            self._load(path)
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's obs/sentinel.py family, same name/kind/labels/help
        self._g_records = m.gauge(
            "fedtpu_sentinel_ring_records",
            help="retained long-horizon ring rows",
        )

    def _load(self, path: str) -> None:
        """Resume a prior watch: replay the on-disk ring (tolerating
        torn tails) so the pinned baseline survives a sentinel restart."""
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            return
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("schema") == RING_SCHEMA:
                self._records.append(rec)
                if len(self._baseline) < self.baseline_n:
                    self._baseline.append(rec)
        self._records = self._records[-self.max_records:]

    def note(self, row: Mapping, *, now: float) -> None:
        """Retain one tick's compact row (every ``stride``-th; the first
        is always kept so a short watch still has a baseline)."""
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self.stride:
                return
            rec = {"schema": RING_SCHEMA, "ts": float(now), **row}
            self._records.append(rec)
            if len(self._baseline) < self.baseline_n:
                self._baseline.append(rec)
            if len(self._records) > self.max_records:
                self._records = self._records[-self.max_records:]
            self._g_records.set(float(len(self._records)))
            if not self.path:
                return
            try:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                self._maybe_compact()
            except OSError:
                pass  # a full disk costs retention, never the loop

    def _maybe_compact(self) -> None:
        """Atomic roll: once the file doubles past the ring bound,
        rewrite the retained tail to a tmp twin and ``os.replace`` it
        over the live file — a reader sees the old file or the new one,
        never a truncated middle. Caller holds ``_lock``."""
        try:
            with open(self.path) as f:
                n_lines = sum(1 for _ in f)
        except OSError:
            return
        if n_lines <= 2 * self.max_records:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for rec in self._records:
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, self.path)

    @property
    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    @property
    def baseline_pinned(self) -> bool:
        with self._lock:
            return len(self._baseline) >= self.baseline_n

    @staticmethod
    def _mean(rows: list[dict], field: str) -> float | None:
        vals = [
            float(r[field])
            for r in rows
            if isinstance(r.get(field), (int, float))
        ]
        return (sum(vals) / len(vals)) if vals else None

    def trend(self) -> list[dict]:
        """Judge the current window against the pinned baseline. Pure
        arithmetic over retained rows — no clock, no state mutation
        beyond fire/clear edge tracking (a regression fires ONCE per
        excursion, re-arming when the trend recovers)."""
        fired: list[dict] = []
        with self._lock:
            if len(self._baseline) < self.baseline_n:
                return []
            if len(self._records) < self.baseline_n + self.window_n:
                # The current window must not overlap the rows that
                # seeded the baseline, or a fleet that was ALWAYS slow
                # would "regress" against itself.
                return []
            recent = self._records[-self.window_n:]
            for field, (ratio, floor, direction) in self.trend_fields.items():
                base = self._mean(self._baseline, field)
                cur = self._mean(recent, field)
                if base is None or cur is None:
                    continue
                if direction == "down":
                    breached = cur < base / ratio - floor
                else:
                    breached = cur > base * ratio + floor
                if breached and field not in self._firing:
                    self._firing.add(field)
                    fired.append(
                        {
                            "field": field,
                            "baseline": round(base, 6),
                            "now": round(cur, 6),
                            "ratio": ratio,
                            "floor": floor,
                            "direction": direction,
                            "baseline_window": len(self._baseline),
                            "current_window": len(recent),
                        }
                    )
                elif not breached:
                    self._firing.discard(field)
        return fired


# ------------------------------------------------------------------ sentinel
class Sentinel:
    """The composed watch daemon: one ``tick`` runs every configured
    rung and returns a schema-versioned report; ``watch`` is the
    ``fedtpu obs sentinel`` loop. Any rung may be absent — a sentinel
    with only canaries (or only the journal tail) is a valid deployment."""

    def __init__(
        self,
        *,
        prober: CanaryProber | None = None,
        tail: JournalTail | None = None,
        ring: RetentionRing | None = None,
        hub=None,
        alerts_jsonl: str | None = None,
        tracer=None,
        recorder=None,
    ):
        if prober is None and tail is None and ring is None:
            raise ValueError("sentinel needs at least one rung")
        self.prober = prober
        self.tail = tail
        self.ring = ring
        self.hub = hub
        self.alerts_jsonl = alerts_jsonl
        self.tracer = tracer
        self._recorder = recorder
        self.ticks = 0
        self.canary_flips = 0  # pointer mismatches + unexplained flips
        self.drift_fires = 0
        self.regression_fires = 0
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's obs/sentinel.py family, same name/kind/labels/help
        self._m_ticks = m.counter(
            "fedtpu_sentinel_ticks_total",
            help="sentinel evaluation passes",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's obs/sentinel.py family, same name/kind/labels/help
        self._m_regressions = m.counter(
            "fedtpu_sentinel_regression_fires_total",
            help="long-horizon trend regressions fired against the "
            "pinned baseline window",
        )

    @staticmethod
    def _fleet_rates(snapshot: dict | None) -> tuple[float | None, float | None]:
        """(round cadence, eject rate) out of a fleet snapshot's
        per-target cadence deltas — the ring's fleet-side inputs."""
        if not snapshot:
            return None, None
        cadence = eject = None
        for row in snapshot.get("targets", ()):
            c = row.get("cadence") or {}
            r = c.get("fedtpu_server_rounds_total")
            if r is None:
                r = c.get("fedtpu_controller_rounds_total")
            if r is not None:
                cadence = max(cadence or 0.0, float(r))
            e = c.get("fedtpu_router_ejects_total")
            if e is not None:
                eject = max(eject or 0.0, float(e))
        return cadence, eject

    def _alert(self, ev: dict) -> None:
        """Sentinel-originated alert: same ``fedtpu-alert-v1`` shape the
        burn machinery emits, so alert consumers need one parser."""
        if self.alerts_jsonl:
            try:
                append_jsonl_line(self.alerts_jsonl, json.dumps(ev))
            except OSError:
                pass
        rec = self._recorder or get_global_recorder()
        if rec is not None:
            try:
                rec.note_alert(ev)
                rec.maybe_dump(f"sentinel-{ev['slo']}", extra=ev)
            except OSError:
                pass

    def tick(self, *, now: float | None = None) -> dict:
        """One sentinel pass over every configured rung."""
        if now is None:
            now = time.time()
        t0 = time.monotonic()
        self.ticks += 1
        self._m_ticks.inc()
        snapshot = self.hub.poll(now=now) if self.hub is not None else None
        canary = self.prober.probe(now=now) if self.prober is not None else None
        drift = self.tail.poll(now=now) if self.tail is not None else None
        if canary is not None:
            self.canary_flips += canary["mismatches"] + canary["flips"]
        if drift is not None and drift["verdict"] is not None:
            self.drift_fires += 1
            self._alert(
                {
                    "schema": ALERT_SCHEMA,
                    "ts": float(now),
                    "event": "fire",
                    "slo": "sentinel-supervised-drift",
                    "instance": "sentinel",
                    "severity": "page",
                    "objective": None,
                    "burn": {},
                    "verdict": {
                        k: v
                        for k, v in drift["verdict"].items()
                        if k != "schema"
                    },
                }
            )
        regressions: list[dict] = []
        if self.ring is not None:
            cadence, eject = self._fleet_rates(snapshot)
            row = {
                "latency_p99_ms": (
                    canary.get("latency_p99_ms") if canary else None
                ),
                "round_cadence": cadence,
                "supervised_error": (
                    drift.get("window_error") if drift else None
                ),
                "eject_rate": eject,
            }
            # Custom --trend-field rows: any watched field that is not a
            # stock row input is a per-deployment counter rate, pulled
            # from the fleet snapshot's cadence dicts the same way the
            # stock fleet-side inputs are (max across targets — the
            # hottest instance is the one regressing).
            for field in self.ring.trend_fields:
                if field in row:
                    continue
                val = None
                for t in (snapshot or {}).get("targets", ()):
                    v = (t.get("cadence") or {}).get(field)
                    if v is not None:
                        val = max(val or 0.0, float(v))
                row[field] = val
            self.ring.note(row, now=now)
            regressions = self.ring.trend()
            for reg in regressions:
                self.regression_fires += 1
                self._m_regressions.inc()
                if self.tracer is not None:
                    self.tracer.record(
                        "regression-fire",
                        t_start=now,
                        dur_s=0.0,
                        field=reg["field"],
                        baseline=reg["baseline"],
                        now_mean=reg["now"],
                        ratio=reg["ratio"],
                        direction=reg["direction"],
                    )
                self._alert(
                    {
                        "schema": ALERT_SCHEMA,
                        "ts": float(now),
                        "event": "fire",
                        "slo": "sentinel-regression",
                        "instance": "sentinel",
                        "severity": "page",
                        "objective": None,
                        "burn": {},
                        "evidence": reg,
                    }
                )
        report = {
            "schema": SENTINEL_SCHEMA,
            "ts": float(now),
            "tick": self.ticks,
            "canary": canary,
            "drift": drift,
            "regressions": regressions,
            "counters": {
                "canary_flips": self.canary_flips,
                "drift_fires": self.drift_fires,
                "regression_fires": self.regression_fires,
            },
            "fleet": (
                {
                    "targets_up": sum(
                        1 for r in snapshot["targets"] if r["up"]
                    ),
                    "targets": len(snapshot["targets"]),
                    "slo_firing": sum(
                        1 for s in snapshot["slo"] if s["firing"]
                    ),
                }
                if snapshot
                else None
            ),
        }
        if self.tracer is not None:
            self.tracer.record(
                "sentinel-eval",
                t_start=now,
                dur_s=time.monotonic() - t0,
                tick=self.ticks,
                canary_incidents=(
                    len(canary["incidents"]) if canary else None
                ),
                drift_fired=bool(drift and drift["verdict"]),
                regressions=len(regressions),
            )
        return report

    # ---------------------------------------------------------------- render
    def render_status(self, report: dict) -> str:
        """The one-screen sentinel view (``fedtpu obs sentinel``)."""
        out = [
            f"fedtpu sentinel  tick {report['tick']}  "
            f"{time.strftime('%H:%M:%S', time.localtime(report['ts']))}"
        ]
        c = report.get("canary")
        if c is not None:
            state = "ok"
            if c["failures"]:
                state = "UNREACHABLE"
            elif c["mismatches"] or c["flips"]:
                state = "INCIDENT"
            out.append(
                f"  canary     {state:<12} {c['probes']} probe(s), "
                f"{c['mismatches']} mismatch(es), {c['flips']} flip(s), "
                f"p99 {c['latency_p99_ms']} ms, artifact "
                f"{(c['artifact'] or '?')[:12]} round {c['expected_round']}"
            )
        d = report.get("drift")
        if d is not None:
            err = d.get("window_error")
            out.append(
                f"  supervised {'DRIFT' if d['verdict'] else 'ok':<12} "
                f"{d['joined']} joined, window error "
                f"{'-' if err is None else f'{err:.4f}'}, "
                f"watermark {d['watermark']}, {d['fires']} fire(s)"
            )
        regs = report.get("regressions") or []
        if self.ring is not None:
            base = "pinned" if self.ring.baseline_pinned else "filling"
            out.append(
                f"  long-term  {'REGRESSION' if regs else 'ok':<12} "
                f"{len(self.ring.records)} ring row(s), baseline {base}"
            )
            for reg in regs:
                out.append(
                    f"    {reg['field']}: baseline {reg['baseline']} -> "
                    f"now {reg['now']} ({reg['direction']}, x{reg['ratio']})"
                )
        fleet = report.get("fleet")
        if fleet is not None:
            out.append(
                f"  fleet      {fleet['targets_up']}/{fleet['targets']} up, "
                f"{fleet['slo_firing']} SLO(s) firing"
            )
        ctr = report["counters"]
        out.append(
            f"  totals     canary {ctr['canary_flips']}, drift "
            f"{ctr['drift_fires']}, regression {ctr['regression_fires']}"
        )
        return "\n".join(out) + "\n"

    # ----------------------------------------------------------------- watch
    def watch(
        self,
        *,
        interval_s: float = 5.0,
        max_seconds: float | None = None,
        out=None,
        stop=None,
    ) -> int:
        """The daemon loop (the ScrapeHub.watch shape: deadline-bounded,
        stop-callable, KeyboardInterrupt = clean exit). Returns ticks."""
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
                report = self.tick()
                frame = self.render_status(report)
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
