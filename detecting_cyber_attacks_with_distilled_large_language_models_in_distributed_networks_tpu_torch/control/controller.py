"""The ``fedtpu controller`` daemon: continuous eval-gated federated rounds.

One controller cycle::

    trigger (drift verdict | max-interval clock | bootstrap)
      -> serve one TCP round through the EXISTING round engine
         (comm/server.py AggregationServer.serve_round — clients connect
         exactly as they always did; the straggler deadline / quorum /
         retry machinery is reused, not reimplemented)
      -> evaluate the aggregate on the held-out split (eval_fn)
      -> register an immutable candidate artifact (registry/)
      -> eval gate (train/fedeval.eval_gate) vs the serving incumbent
           pass  -> promote candidate -> shadow -> serving
                    (atomic pointer swap; the scoring tier follows it)
           fail  -> reject; the pointer NEVER moves — automatic
                    rollback-by-refusal on regression
      -> feed the promoted artifact's eval histogram to the drift
         monitor as the new reference

Every cycle appends one structured record to the controller-state JSONL;
a restarted controller replays that file to resume mid-campaign (round
counter, promotion/rejection tallies) instead of starting a colliding
round 0. The registry's serving pointer survives restarts by
construction, so the drift reference re-anchors from the registry.

The port's copy of the JAX package's ``control/controller.py``: the same
triggers (bootstrap, drift, sentinel, the clock), adaptive cadence, the
drift-scaled cohort, SLO actuation, resume, gc, spans and families, and
the same ``controller_state.jsonl`` records, so either package resumes a
campaign the other began. The round is the port's ``AggregationServer``
(its fold is the K4 kernel on the card) and ``eval_fn`` scores the
aggregate on the card. The shadow gate, the label gate and the
error-rate monitor (ROADMAP item 14b) are not ported: passing one raises.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Mapping

import numpy as np

from ..comm import wire
from ..config import ControlConfig
from ..obs import metrics as obs_metrics
from ..registry import ModelRegistry, RegistryError
from ..train.fedeval import eval_gate, reference_histogram
from .drift import (
    DriftMonitor,
    ErrorRateMonitor,
    cadence_interval_s,
    drift_cohort_fraction,
)

log = logging.getLogger(__name__)


class SloActuator:
    """Health-plane actuation (the first SLO->control rung): tail the
    scrape hub's alerts-JSONL and, WHILE a round-duration burn alert is
    firing, tighten the controller's straggler deadline by a configured
    factor — a fleet already blowing its round SLO should cut stragglers
    loose sooner, not spend the full budget waiting on them. The alert
    clearing restores the configured deadline.

    Pure event arithmetic: no clock reads, no sleeps — state is exactly
    the fire/clear events consumed so far (per (slo, instance), so two
    hubs or two instances can fire independently), which is what makes
    the whole behavior unit-testable from a synthetic alerts file."""

    def __init__(
        self,
        alerts_jsonl: str,
        *,
        slo_name: str = "round-duration",
        factor: float = 0.5,
    ):
        if not 0.0 < float(factor) <= 1.0:
            raise ValueError(
                f"factor={factor} must be in (0, 1] (1 = no tightening)"
            )
        self.alerts_jsonl = alerts_jsonl
        self.slo_name = str(slo_name)
        self.factor = float(factor)
        self._offset = 0
        self._firing: set[str] = set()

    @property
    def firing(self) -> bool:
        return bool(self._firing)

    def poll(self) -> bool:
        """Ingest new alert events; True while the matched SLO fires
        somewhere. Malformed lines are skipped (the alerts file is
        another process's output)."""
        from ..obs.timeline import read_new_jsonl_lines

        self._offset, lines = read_new_jsonl_lines(
            self.alerts_jsonl, self._offset
        )
        for line in lines:
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(ev, dict) or ev.get("slo") != self.slo_name:
                continue
            key = str(ev.get("instance"))
            if ev.get("event") == "fire":
                self._firing.add(key)
            elif ev.get("event") == "clear":
                self._firing.discard(key)
        return self.firing

    def effective_deadline(self, base: float | None) -> float | None:
        """The straggler deadline to hand the round engine: tightened by
        ``factor`` while firing, the configured ``base`` otherwise (a
        None base — server-timeout-governed rounds — stays None; there
        is no number to tighten)."""
        if base is None or not self._firing:
            return base
        return float(base) * self.factor

#: eval_fn contract: nested params dict -> metrics mapping. Must carry the
#: gate metric; a "probs" array (np.ndarray) makes the candidate's eval
#: reference histogram available to the drift monitor.
EvalFn = Callable[[Any], Mapping[str, Any]]


@dataclass
class ControllerStats:
    rounds_attempted: int = 0
    rounds_completed: int = 0
    rounds_failed: int = 0
    promotions: int = 0
    gate_rejections: int = 0
    #: Candidates that passed offline eval but FAILED the live shadow
    #: disagreement gate (shadow/) — rejected with the verdict recorded.
    shadow_rejections: int = 0
    #: Candidates that FAILED the supervised label gate (labels/) —
    #: wrong against delayed ground truth where the incumbent was right.
    label_rejections: int = 0
    drift_triggers: int = 0
    #: round-engine wall seconds (inside serve_round) vs full cycle wall:
    #: the orchestration overhead the bench record reports.
    round_wall_s: float = 0.0
    cycle_wall_s: float = 0.0
    promotion_latency_s: list = field(default_factory=list)


class Controller:
    """Drive ``server`` round after round, gate every candidate, and keep
    the registry's serving pointer on the best evaluated artifact.

    ``server`` is an already-bound :class:`~..comm.AggregationServer`
    (central DP is refused — a DP server only ever holds noised mean
    DELTAS, never the absolute params an artifact needs). ``eval_fn``
    maps a nested params dict to held-out metrics.
    """

    def __init__(
        self,
        server,
        registry: ModelRegistry,
        eval_fn: EvalFn,
        *,
        control: ControlConfig | None = None,
        state_path: str | None = None,
        drift_monitor: DriftMonitor | None = None,
        model_config: Any | None = None,
        drift_poll_s: float = 1.0,
        tracer=None,
        shadow_gate=None,
        slo_actuator: SloActuator | None = None,
        label_gate=None,
        error_monitor: ErrorRateMonitor | None = None,
        sentinel_link=None,
    ):
        unported = [
            name
            for name, v in (
                ("shadow_gate", shadow_gate),
                ("label_gate", label_gate),
                ("error_monitor", error_monitor),
            )
            if v is not None
        ]
        if unported:
            raise NotImplementedError(
                f"{', '.join(unported)}: the shadow gate, the label gate and "
                "the error-rate monitor are not ported (ROADMAP item 14b)"
            )
        if getattr(server, "dp_clip", 0.0) > 0.0:
            raise ValueError(
                "the controller cannot gate a central-DP server: it never "
                "holds absolute params to register or evaluate (run the DP "
                "tier with its own cadence, or gate on the mesh tier)"
            )
        self.server = server
        self.registry = registry
        self.eval_fn = eval_fn
        self.control = control or ControlConfig()
        self.state_path = state_path
        self.drift = drift_monitor
        self.model_config = model_config
        self.drift_poll_s = float(drift_poll_s)
        # slo_actuator: the health plane's round-duration alert
        # tightening the straggler deadline.
        self.slo_actuator = slo_actuator
        # Sentinel link (control/drift.py SentinelLink): the tail of the
        # standalone sentinel's verdicts-JSONL — supervised drift the
        # sentinel detected BETWEEN gates, in another process, poking
        # the same corrective-round path the in-process monitor uses.
        self.sentinel_link = sentinel_link
        self.stats = ControllerStats()
        # Drift-scaled cohort: a drift verdict's magnitude picks the
        # NEXT round's quorum between the configured fractions of the
        # server's base min_clients (mild drift -> lean fast cohort,
        # severe drift -> the full quorum's evidence).
        self._base_min_clients: int | None = getattr(
            server, "min_clients", None
        )
        self._cohort_override: int | None = None
        # Adaptive cadence: a drift verdict's magnitude sets the NEXT
        # inter-round throttle (None = the configured min_interval_s).
        self._interval_override: float | None = None
        self._slo_tightened = False
        # Observability (obs/): spans stamped with the round engine's
        # (trace, round) — server.last_trace after each serve_round — so
        # the obs timeline shows eval-gate/promote time next to the
        # round's compute/wait/wire phases; counters feed /metrics.
        self.tracer = tracer
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's control/controller.py family, same name/kind/labels/help
        self._m_rounds = m.counter(
            "fedtpu_controller_rounds_total",
            help="controller cycles attempted",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's control/controller.py family, same name/kind/labels/help
        self._m_promotions = m.counter(
            "fedtpu_controller_promotions_total",
            help="candidates promoted to serving",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's control/controller.py family, same name/kind/labels/help
        self._m_gate_rejections = m.counter(
            "fedtpu_controller_gate_rejections_total",
            help="candidates rejected by the eval gate",
        )
        # The shadow and label gates' families stay registered (at 0), so
        # a scrape of either package's controller shows the same families.
        # fedtpu: allow(obs-metric-once): the JAX package's control/controller.py family, same name/kind/labels/help
        m.counter(
            "fedtpu_controller_shadow_rejections_total",
            help="candidates rejected by the live shadow disagreement gate",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's control/controller.py family, same name/kind/labels/help
        m.counter(
            "fedtpu_controller_label_rejections_total",
            help="candidates rejected by the supervised label gate",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's control/controller.py family, same name/kind/labels/help
        self._m_drift_triggers = m.counter(
            "fedtpu_controller_drift_triggers_total",
            help="rounds triggered by the drift monitor",
        )
        self._next_round = 0
        self._last_round_start: float | None = None
        if state_path:
            self._resume(state_path)
        if self.drift is not None:
            self._seed_drift_reference()

    # ----------------------------------------------------------------- state
    def _resume(self, path: str) -> None:
        """Replay the controller-state JSONL: round counter + tallies. A
        half-written trailing line (crash mid-append) is skipped."""
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            return
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            r = rec.get("round")
            if isinstance(r, int):
                self._next_round = max(self._next_round, r + 1)
            ev = rec.get("event")
            # Every cycle writes exactly one of these five records, so
            # the attempted/completed tallies replay exactly (a restarted
            # campaign's summary must stay internally consistent —
            # promotions can never exceed completed rounds).
            if ev in (
                "promoted",
                "gate_rejected",
                "shadow_rejected",
                "label_rejected",
                "promote_noop",
                "round_noop",
                "round_failed",
                "cycle_error",
            ):
                self.stats.rounds_attempted += 1
            if ev in (
                "promoted", "gate_rejected", "shadow_rejected",
                "label_rejected", "promote_noop", "cycle_error",
            ):
                self.stats.rounds_completed += 1
            if ev == "promoted":
                self.stats.promotions += 1
            elif ev == "gate_rejected":
                self.stats.gate_rejections += 1
            elif ev == "shadow_rejected":
                self.stats.shadow_rejections += 1
            elif ev == "label_rejected":
                self.stats.label_rejections += 1
            elif ev == "round_failed":
                self.stats.rounds_failed += 1
            elif ev == "drift_trigger":
                self.stats.drift_triggers += 1
        if self._next_round or self.stats.promotions:
            log.info(
                f"[CONTROLLER] resumed campaign from {path}: next round "
                f"{self._next_round} ({self.stats.promotions} promotion(s), "
                f"{self.stats.gate_rejections} gate rejection(s) so far)"
            )

    def _record(self, event: str, **fields: Any) -> None:
        if not self.state_path:
            return
        os.makedirs(os.path.dirname(self.state_path) or ".", exist_ok=True)
        with open(self.state_path, "a") as f:
            f.write(json.dumps({"ts": time.time(), "event": event, **fields}) + "\n")

    def _seed_drift_reference(self) -> None:
        """Re-anchor the drift reference from whatever is serving (resume
        path: the registry outlives the controller process)."""
        try:
            m = self.registry.serving_manifest()
        except RegistryError:
            return
        if m and m.get("eval_hist"):
            self.drift.set_reference(m["eval_hist"])
            log.info(
                f"[CONTROLLER] drift reference = serving artifact "
                f"{m['id']}'s eval histogram"
            )

    # --------------------------------------------------------------- trigger
    def _wait_for_trigger(self, stop: threading.Event) -> str | None:
        """Block until the next round should run; returns the trigger name
        (``bootstrap`` | ``drift`` | ``interval``) or None when stopped."""
        c = self.control
        # Back-to-back throttle applies to every trigger source.
        if self._last_round_start is not None and c.min_interval_s > 0.0:
            wake = self._last_round_start + c.min_interval_s
            while time.monotonic() < wake:
                if stop.wait(min(0.2, wake - time.monotonic())):
                    return None
        if self.registry.serving_info() is None:
            return "bootstrap"  # nothing serving: a round is needed regardless
        if self.drift is None:
            return "interval"  # fixed cadence (min_interval is the clock)
        if not self.drift.has_reference:
            # Serving artifact without an eval histogram (e.g. published
            # by `federated --registry-dir` and hand-promoted): drift can
            # NEVER fire against nothing — waiting on it would idle the
            # campaign forever. Run a round on the clock instead; its
            # promotion re-anchors the reference and drift takes over.
            log.warning(
                "[CONTROLLER] no drift reference (serving artifact "
                "carries no eval histogram); triggering a round on the "
                "clock so the campaign can re-anchor"
            )
            return "interval"
        start = time.monotonic()
        # Adaptive cadence applies to the CLOCK FALLBACK, not the hard
        # min-interval throttle above: a mild verdict relaxes the next
        # guaranteed round toward max_interval_s, a severe one pulls it
        # toward min_interval_s — while drift keeps being polled the
        # whole time, so a new emergency still fires immediately. The
        # recorded next_interval_s is therefore the true time to the
        # next round absent further drift.
        effective_max = (
            self._interval_override
            if self._interval_override is not None
            else c.max_interval_s
        )
        while True:
            verdict = self.drift.poll()
            if verdict is not None:
                self.stats.drift_triggers += 1
                self._m_drift_triggers.inc()
                # Adaptive cadence: the verdict's MAGNITUDE (for PSI,
                # exactly the psi_contributions total) picks the next
                # inter-round throttle between the configured bounds.
                next_interval = None
                if c.adaptive_cadence:
                    next_interval = cadence_interval_s(
                        verdict["drift"],
                        threshold=self.drift.threshold,
                        min_s=c.min_interval_s,
                        max_s=c.max_interval_s,
                    )
                    self._interval_override = next_interval
                    log.info(
                        f"[CONTROLLER] adaptive cadence: drift "
                        f"{verdict['drift']:.4f} -> next interval "
                        f"{next_interval:.1f}s"
                    )
                # Drift-scaled cohort: the verdict's magnitude picks the
                # corrective round's quorum (applied to the server for
                # ONE round in run_cycle, then restored).
                cohort = None
                if c.drift_cohort and self._base_min_clients:
                    frac = drift_cohort_fraction(
                        verdict["drift"],
                        threshold=self.drift.threshold,
                        min_frac=c.cohort_min_frac,
                        max_frac=c.cohort_max_frac,
                    )
                    base = int(self._base_min_clients)
                    cohort = max(1, min(base, int(round(base * frac))))
                    self._cohort_override = cohort
                    log.info(
                        f"[CONTROLLER] drift-scaled cohort: drift "
                        f"{verdict['drift']:.4f} -> quorum {cohort}/{base} "
                        "for the corrective round"
                    )
                self._record(
                    "drift_trigger",
                    **verdict,
                    **(
                        {"next_interval_s": round(next_interval, 3)}
                        if next_interval is not None
                        else {}
                    ),
                    **(
                        {"cohort_target": cohort}
                        if cohort is not None
                        else {}
                    ),
                )
                if self.tracer is not None:
                    # No (trace, round) yet — the round this verdict
                    # starts hasn't minted one; the round index links
                    # them. top_bins is the PSI localization: WHICH
                    # score region moved (control/drift.py).
                    self.tracer.record(
                        "drift-trigger",
                        t_start=time.time(),
                        dur_s=0.0,
                        round=self._next_round,
                        drift=verdict["drift"],
                        method=verdict["method"],
                        scores=verdict["scores"],
                        top_bins=verdict.get("top_bins"),
                        next_interval_s=(
                            round(next_interval, 3)
                            if next_interval is not None
                            else None
                        ),
                    )
                return "drift"
            if self.sentinel_link is not None:
                # The standalone sentinel's between-gates verdict, same
                # handling as the in-process monitor — the verdict shape
                # is the ErrorRateMonitor's, journaled cross-process.
                sup = self.sentinel_link.poll()
                if sup is not None:
                    self.stats.drift_triggers += 1
                    self._m_drift_triggers.inc()
                    self._record(
                        "drift_trigger",
                        **{
                            k: sup.get(k)
                            for k in (
                                "drift", "method", "threshold",
                                "scores", "error", "reference_error",
                            )
                        },
                    )
                    if self.tracer is not None:
                        self.tracer.record(
                            "drift-trigger",
                            t_start=time.time(),
                            dur_s=0.0,
                            round=self._next_round,
                            drift=sup["drift"],
                            method=sup["method"],
                            scores=sup.get("scores"),
                        )
                    log.info(
                        f"[CONTROLLER] sentinel drift verdict: error "
                        f"{sup.get('error')} vs reference "
                        f"{sup.get('reference_error')} over "
                        f"{sup.get('scores')} joined flow(s)"
                    )
                    return "drift"
            if (
                effective_max is not None
                and time.monotonic() - start >= effective_max
            ):
                # A clock round means the drift stayed quiet for the
                # whole (possibly adapted) interval: relax the override
                # back to the configured cadence.
                self._interval_override = None
                return "interval"
            if stop.wait(self.drift_poll_s):
                return None

    # ----------------------------------------------------------------- cycle
    def run_cycle(self, trigger: str = "interval") -> dict:
        """One round -> gate -> promote/reject cycle. Returns the cycle's
        state record (also appended to the state JSONL)."""
        c = self.control
        r = self._next_round
        self._next_round += 1
        self._last_round_start = time.monotonic()
        self.stats.rounds_attempted += 1
        self._m_rounds.inc()
        log.info(f"[CONTROLLER] round {r} starting (trigger: {trigger})")
        # SLO-driven actuation: while the health plane's round-duration
        # alert fires, the straggler deadline tightens by the configured
        # factor (and restores the moment the alert clears).
        deadline = c.round_deadline_s
        self._slo_tightened = False
        if self.slo_actuator is not None and self.slo_actuator.poll():
            tightened = self.slo_actuator.effective_deadline(deadline)
            if tightened != deadline:
                self._slo_tightened = True
                log.info(
                    f"[CONTROLLER] round-duration SLO firing: straggler "
                    f"deadline {deadline:.1f}s -> {tightened:.1f}s until "
                    "the alert clears"
                )
                deadline = tightened
        cohort = self._cohort_override
        if cohort is not None and self._base_min_clients:
            # One corrective round at the drift-scaled quorum; the base
            # quorum restores whatever the round's outcome.
            self.server.min_clients = cohort
        try:
            t0 = time.monotonic()
            agg = self.server.serve_round(
                deadline=deadline, round_index=r
            )
            round_wall = time.monotonic() - t0
        except (RuntimeError, OSError, ConnectionError, ValueError) as e:
            # Quorum miss / straggler deadline (RuntimeError), a malformed
            # upload surviving to aggregation (WireError/SecureAggError,
            # both ValueErrors), or a socket error: the campaign continues
            # — one failed round must not kill the daemon (the single most
            # important behavioral difference from the reference server).
            self.stats.rounds_failed += 1
            rec = {"round": r, "trigger": trigger, "error": str(e)}
            self._record("round_failed", **rec)
            log.info(f"[CONTROLLER] round {r} failed: {e}")
            return {"event": "round_failed", **rec}
        finally:
            if cohort is not None and self._base_min_clients:
                self.server.min_clients = int(self._base_min_clients)
                self._cohort_override = None
        self.stats.round_wall_s += round_wall
        if agg is None:
            rec = {"round": r, "trigger": trigger}
            self._record("round_noop", **rec)
            return {"event": "round_noop", **rec}
        self.stats.rounds_completed += 1
        t_end = time.monotonic()
        try:
            return self._gate_and_promote(
                r, trigger, agg, t_end=t_end, round_wall=round_wall
            )
        except Exception as e:
            # Eval of a foreign-architecture aggregate, a full disk under
            # the registry write, any other post-round surprise: the ROUND
            # engine is healthy, so the campaign continues — same
            # one-bad-cycle-must-not-kill-the-daemon contract as above.
            rec = {"round": r, "trigger": trigger, "error": f"{type(e).__name__}: {e}"}
            self._record("cycle_error", **rec)
            log.info(
                f"[CONTROLLER] round {r} completed but its gate/promote "
                f"cycle failed ({type(e).__name__}: {e}); serving pointer "
                "unchanged"
            )
            return {"event": "cycle_error", **rec}

    def _maybe_gc(self) -> None:
        """Registry GC after a promotion/rejection moved the state
        machine (ControlConfig.max_artifacts): prune oldest retired/
        rejected artifacts beyond the budget. A GC failure is logged,
        never fatal — disk hygiene must not fail a healthy round."""
        budget = self.control.max_artifacts
        if budget is None:
            return
        try:
            self.registry.gc(max_artifacts=budget)
        except (OSError, RegistryError) as e:
            log.info(f"[CONTROLLER] registry gc failed (non-fatal): {e}")

    def _gate_and_promote(
        self, r: int, trigger: str, agg: dict, *, t_end: float, round_wall: float
    ) -> dict:
        c = self.control
        # The round engine's (trace, round) identity for this cycle's
        # follow-on spans (server.last_trace is set by serve_round).
        trace, _ = getattr(self.server, "last_trace", None) or (None, None)
        nested = wire.unflatten_params(agg)
        t_gate_unix = time.time()
        t_gate0 = time.monotonic()
        metrics = dict(self.eval_fn(nested))
        probs = metrics.pop("probs", None)
        metrics.pop("labels", None)
        eval_hist = (
            reference_histogram(probs, bins=c.score_bins)
            if probs is not None
            else None
        )
        incumbent = self.registry.serving_manifest()
        aid = self.registry.add(
            agg,
            round_index=r,
            metrics=metrics,
            eval_hist=eval_hist,
            model_config=self.model_config,
            parent=incumbent["id"] if incumbent else None,
        )
        if incumbent is not None and aid == incumbent["id"]:
            # Content-addressed dedup: this round's aggregate is
            # bit-identical to what already serves. Short-circuit BEFORE
            # any state transition — promote(to='shadow') would demote
            # the serving artifact's manifest just to fail the final swap.
            rec = {"round": r, "trigger": trigger, "artifact": aid}
            self._record("promote_noop", **rec)
            log.info(
                f"[CONTROLLER] round {r}: aggregate identical to the "
                f"serving artifact {aid}; nothing to promote"
            )
            return {"event": "promote_noop", **rec}
        ok, reason = eval_gate(
            metrics,
            incumbent["metrics"] if incumbent else None,
            metric=c.gate_metric,
            min_delta=c.gate_min_delta,
        )
        if self.tracer is not None:
            self.tracer.record(
                "eval-gate",
                t_start=t_gate_unix,
                dur_s=time.monotonic() - t_gate0,
                trace=trace,
                round=r,
                artifact=aid,
                passed=bool(ok),
            )
        rec: dict[str, Any] = {
            "round": r,
            "trigger": trigger,
            "artifact": aid,
            "gate": c.gate_metric,
            "reason": reason,
            "round_wall_s": round(round_wall, 3),
        }
        if self._slo_tightened:
            rec["slo_tightened"] = True
        if c.gate_metric in metrics:
            try:
                rec["metric_value"] = float(metrics[c.gate_metric])
            except (TypeError, ValueError):
                pass
        if not ok:
            # Regression: reject; the serving pointer stays on the
            # incumbent (the rollback IS the refusal to move it).
            self.stats.gate_rejections += 1
            self._m_gate_rejections.inc()
            self.registry.reject(aid, reason=reason)
            self._maybe_gc()
            rec["incumbent"] = incumbent["id"] if incumbent else None
            self._record("gate_rejected", **rec)
            log.info(
                f"[CONTROLLER] round {r}: candidate {aid} REJECTED "
                f"({reason}); serving pointer unchanged"
                + (f" ({rec['incumbent']})" if rec["incumbent"] else "")
            )
            return {"event": "gate_rejected", **rec}
        t_pro_unix = time.time()
        t_pro0 = time.monotonic()
        try:
            self.registry.promote(aid, to="shadow")
        except RegistryError as e:
            # Content-addressed dedup corner: a round whose aggregate is
            # bit-identical to the serving artifact has nothing to swap.
            rec["note"] = str(e)
            self._record("promote_noop", **rec)
            return {"event": "promote_noop", **rec}
        try:
            self.registry.promote(aid, to="serving")
        except RegistryError as e:
            rec["note"] = str(e)
            self._record("promote_noop", **rec)
            return {"event": "promote_noop", **rec}
        if self.tracer is not None:
            self.tracer.record(
                "promote",
                t_start=t_pro_unix,
                dur_s=time.monotonic() - t_pro0,
                trace=trace,
                round=r,
                artifact=aid,
            )
        latency = time.monotonic() - t_end
        self.stats.promotions += 1
        self._m_promotions.inc()
        self.stats.promotion_latency_s.append(latency)
        rec["promotion_latency_s"] = round(latency, 4)
        if self.drift is not None and eval_hist is not None:
            self.drift.set_reference(eval_hist)
        self._maybe_gc()
        self._record("promoted", **rec)
        log.info(
            f"[CONTROLLER] round {r}: promoted {aid} to serving "
            f"({reason}; pointer swap {latency * 1e3:.0f} ms after round end)"
        )
        return {"event": "promoted", **rec}

    # ------------------------------------------------------------------- run
    def run(
        self,
        *,
        max_rounds: int | None = None,
        stop: threading.Event | None = None,
    ) -> ControllerStats:
        """The daemon loop: trigger-wait, cycle, repeat. ``max_rounds``
        bounds COMPLETED+failed cycles (None = until ``stop`` is set)."""
        stop = stop or threading.Event()
        cycles = 0
        while not stop.is_set():
            if max_rounds is not None and cycles >= max_rounds:
                break
            trigger = self._wait_for_trigger(stop)
            if trigger is None:
                break
            t0 = time.monotonic()
            self.run_cycle(trigger)
            self.stats.cycle_wall_s += time.monotonic() - t0
            cycles += 1
        log.info(
            f"[CONTROLLER] campaign halted: "
            f"{self.stats.rounds_completed} round(s) completed, "
            f"{self.stats.promotions} promoted, "
            f"{self.stats.gate_rejections} gate-rejected, "
            f"{self.stats.drift_triggers} drift-triggered"
        )
        return self.stats

    def summary(self) -> dict:
        s = asdict(self.stats)
        lat = s.pop("promotion_latency_s")
        s["promotion_latency_ms_mean"] = (
            round(float(np.mean(lat)) * 1e3, 3) if lat else None
        )
        return s
