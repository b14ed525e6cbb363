"""``controller`` and ``registry``: the control plane's operator surface
(the port of the JAX package's ``cli/control.py``).

``controller`` turns the hand-run three-script round into an unattended
campaign: it owns the TCP aggregation endpoint (the fold is K4 on the
card), serves round after round, scores every aggregate on the pooled
validation rows on the card (K1 at rate 0), registers it as an immutable
candidate, and moves the registry's serving pointer only through the eval
gate. Its records, artifacts and state file are the JAX controller's, so
either package resumes a campaign the other began; ``--secure-agg``
serves masked rounds (comm/secure.py), the gate scoring the recovered
mean. ``--shadow-gate`` holds each eval-passing candidate in the shadow
state until a ``fleet --shadow-sample`` has mirrored enough live traffic
onto it; ``--label-gate`` then rules on the delayed ground truth joined
against those pairs, and ``--error-drift`` turns the same joined evidence
into a round trigger.

``registry`` is the manual override: ``list``, ``promote``, ``rollback``
and ``gc``. A registry root may be written by both packages in turn.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import NamedTuple

import numpy as np

from ..comm import AggregationServer
from ..config import ExperimentConfig
from ..control import Controller
from ..data.pipeline import TokenizedSplit
from ..registry import ModelRegistry, RegistryError
from ..train.engine import Trainer

log = logging.getLogger(__name__)

#: controller flag -> ControlConfig field (the JAX verb's table).
_CONTROL_FLAGS = (
    ("gate_metric", "gate_metric"),
    ("gate_min_delta", "gate_min_delta"),
    ("interval", "min_interval_s"),
    ("max_interval", "max_interval_s"),
    ("drift_threshold", "drift_threshold"),
    ("drift_min_scores", "drift_min_scores"),
    ("drift_method", "drift_method"),
    ("round_deadline", "round_deadline_s"),
    ("max_artifacts", "max_artifacts"),
    ("slo_deadline_factor", "slo_deadline_factor"),
    ("cohort_min_frac", "cohort_min_frac"),
    ("cohort_max_frac", "cohort_max_frac"),
)
#: controller flag -> ShadowConfig field.
_SHADOW_FLAGS = (
    ("shadow_min_pairs", "min_pairs"),
    ("shadow_timeout", "timeout_s"),
    ("shadow_max_flip_rate", "max_flip_rate"),
    ("shadow_psi_threshold", "psi_threshold"),
)
#: controller flag -> LabelsConfig field.
_LABEL_FLAGS = (
    ("label_journal", "journal"),
    ("label_min_joined", "min_joined"),
    ("label_coverage_floor", "coverage_floor"),
    ("label_max_regression", "max_regression"),
)


def _flagged(args, section, table, **kw):
    """``section`` with ``kw`` and the fields whose flags were given
    replaced (a bad value exits with the config's own message)."""
    kw.update({f: getattr(args, flag) for flag, f in table if getattr(args, flag, None) is not None})
    try:
        return dataclasses.replace(section, **kw)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _gate_val_split(args, cfg, tok, num_clients):
    """Every client's VALIDATION rows, tokenized and pooled, as the
    held-out gate split — val, never test: the gate is model selection,
    and reusing test data to pick what serves would leak the final
    numbers. Only the val rows are tokenized (the controller never
    trains); the --stream reader has no split-level entry point, so that
    path tokenizes everything."""
    from ..data.pipeline import tokenize_split
    from .common import _load_client_splits, _load_clients

    if getattr(args, "stream", False):
        vals = [c.val for c in _load_clients(args, cfg, tok, num_clients) if len(c.val)]
    else:
        splits = _load_client_splits(args, cfg, num_clients)
        vals = [tokenize_split(s.val, tok, cfg.model.max_len) for s in splits if len(s.val)]
    if not vals:
        raise SystemExit(
            "no validation rows for the eval gate (val_fraction too small "
            "for this corpus?)"
        )
    return TokenizedSplit(
        np.concatenate([v.input_ids for v in vals]),
        np.concatenate([v.attention_mask for v in vals]),
        np.concatenate([v.labels for v in vals]),
    )


class ControllerRun(NamedTuple):
    """What ``build_controller`` assembles: the controller, its bound
    round server (which closes the /metrics endpoint with itself), the
    eval gate's trainer and pooled validation split, and the resolved
    config."""

    controller: Controller
    server: AggregationServer
    trainer: Trainer
    val: TokenizedSplit
    cfg: ExperimentConfig


def build_controller(args) -> ControllerRun:
    """The controller the ``controller`` flags describe, its server bound
    and listening (``server.port``), no round served yet."""
    from ..comm import wire
    from ..control import DriftMonitor, SentinelLink, SloActuator
    from .comm import _auth_key, _server_client_keys
    from .common import _obs_setup, _resolve_with_pretrained

    tok, cfg, _ = _resolve_with_pretrained(args, load_weights=False)
    C = cfg.fed.num_clients
    # The two switches only turn a config file's setting on.
    switches = {f: True for f in ("adaptive_cadence", "drift_cohort") if getattr(args, f, False)}
    ctl = _flagged(args, cfg.control, _CONTROL_FLAGS, **switches)
    shw = _flagged(args, cfg.shadow, _SHADOW_FLAGS)
    lbl = _flagged(args, cfg.labels, _LABEL_FLAGS)

    # The gate's held-out data: the pooled per-client VAL split, scored
    # on the card.
    log.info("[DATA] loading the eval-gate validation pool")
    val = _gate_val_split(args, cfg, tok, C)
    trainer = Trainer(cfg.model, cfg.train, pad_id=tok.pad_id, device=args.device)
    log.info(
        f"[CONTROLLER] eval gate: {len(val.input_ids)} pooled validation "
        f"rows on {trainer.device}, metric {ctl.gate_metric} (min delta "
        f"{ctl.gate_min_delta})"
    )

    def eval_fn(params):
        return trainer.evaluate(params, val, batch_size=cfg.data.eval_batch_size)

    tracer, metrics_server = _obs_setup(args, proc="controller", cfg=cfg, metrics_host=args.host)
    registry = ModelRegistry(args.registry_dir, tracer=tracer)
    state_path = args.state_jsonl or os.path.join(args.registry_dir, "controller_state.jsonl")
    drift = None
    if args.drift_jsonl:
        drift = DriftMonitor(
            args.drift_jsonl,
            threshold=ctl.drift_threshold,
            min_scores=ctl.drift_min_scores,
            method=ctl.drift_method,
        )
        log.info(
            f"[CONTROLLER] drift-triggered rounds: tailing {args.drift_jsonl} "
            f"({ctl.drift_method} >= {ctl.drift_threshold} over >= "
            f"{ctl.drift_min_scores} scores"
            + (
                f"; clock fallback every {ctl.max_interval_s:.0f}s"
                if ctl.max_interval_s is not None
                else "; no clock fallback"
            )
            + ")"
        )
    sentinel_link = None
    if args.sentinel_jsonl:
        sentinel_link = SentinelLink(args.sentinel_jsonl)
        log.info(
            f"[CONTROLLER] sentinel link armed: supervised-drift verdicts "
            f"appended to {args.sentinel_jsonl} trigger corrective rounds "
            "(existing verdicts skipped)"
        )
    actuator = None
    if args.slo_alerts_jsonl:
        actuator = SloActuator(args.slo_alerts_jsonl, factor=ctl.slo_deadline_factor)
        log.info(
            f"[CONTROLLER] SLO actuation armed: round-duration fire on "
            f"{args.slo_alerts_jsonl} tightens the straggler deadline "
            f"x{ctl.slo_deadline_factor}"
        )
    server = AggregationServer(
        host=args.host,
        port=args.port,
        num_clients=C,
        min_clients=args.min_clients,
        timeout=args.timeout,
        auth_key=_auth_key(),
        secure_agg=args.secure_agg,
        client_keys=_server_client_keys(),
        stream_chunk_bytes=wire.stream_chunk_bytes_from_mb(args.stream_chunk_mb),
        device=args.device,
        tracer=tracer,
    )
    server.metrics_server = metrics_server
    shadow_gate = None
    if args.shadow_gate:
        from ..shadow import ShadowGate

        shadow_gate = ShadowGate(
            args.registry_dir,
            min_pairs=shw.min_pairs,
            max_flip_rate=shw.max_flip_rate,
            psi_threshold=shw.psi_threshold,
            timeout_s=shw.timeout_s,
            poll_s=shw.poll_s,
            tracer=tracer,
        )
        log.info(
            f"[CONTROLLER] shadow gate armed: promote after >= "
            f"{shw.min_pairs} mirrored pair(s) with flip_rate <= "
            f"{shw.max_flip_rate} and psi <= {shw.psi_threshold} "
            f"(fail closed after {shw.timeout_s:.0f}s)"
        )
    label_gate = None
    error_monitor = None
    if args.label_gate:
        from ..control import ErrorRateMonitor
        from ..labels import LabelGate

        label_gate = LabelGate(
            args.registry_dir,
            journal=lbl.journal,
            threshold=lbl.threshold,
            min_joined=lbl.min_joined,
            coverage_floor=lbl.coverage_floor,
            max_regression=lbl.max_regression,
            tracer=tracer,
        )
        log.info(
            f"[CONTROLLER] label gate armed: supervised rung over >= "
            f"{lbl.min_joined} joined flow(s) at coverage >= "
            f"{lbl.coverage_floor} (candidate error may exceed "
            f"serving by <= {lbl.max_regression}; fails closed)"
        )
        if args.error_drift:
            error_monitor = ErrorRateMonitor(margin=lbl.error_margin, min_joined=lbl.error_min_joined)
            log.info(
                f"[CONTROLLER] supervised drift armed: serving error "
                f"rising {lbl.error_margin} past its promoted reference "
                f"over >= {lbl.error_min_joined} joined flow(s) triggers a round"
            )
    controller = Controller(
        server,
        registry,
        eval_fn,
        control=ctl,
        state_path=state_path,
        drift_monitor=drift,
        model_config=cfg.model,
        tracer=tracer,
        shadow_gate=shadow_gate,
        slo_actuator=actuator,
        label_gate=label_gate,
        error_monitor=error_monitor,
        sentinel_link=sentinel_link,
    )
    return ControllerRun(controller, server, trainer, val, cfg)


def cmd_controller(args) -> int:
    run = build_controller(args)
    max_rounds = args.rounds if args.rounds and args.rounds > 0 else None
    with run.server:  # closes the /metrics endpoint too
        log.info(
            f"[CONTROLLER] round endpoint {args.host}:{run.server.port} "
            f"({run.server.num_clients} clients, quorum {run.server.min_clients}, "
            f"fold on {run.server.device}); campaign: "
            + (f"{max_rounds} round(s)" if max_rounds else "until stopped")
        )
        try:
            run.controller.run(max_rounds=max_rounds)
        except KeyboardInterrupt:
            log.info("[CONTROLLER] interrupted; campaign state saved")
    log.info(f"[CONTROLLER] campaign summary: {run.controller.summary()}")
    return 0


def cmd_registry(args) -> int:
    registry = ModelRegistry(args.registry_dir)
    try:
        if args.action == "list":
            serving = registry.serving_info()
            serving_id = serving["artifact"] if serving else None
            rows = registry.list()
            if not rows:
                print(f"(registry {args.registry_dir} is empty)")
                return 0
            for m in rows:
                metrics = m.get("metrics") or {}
                headline = ", ".join(
                    f"{k}={v:.4f}" for k, v in sorted(metrics.items()) if isinstance(v, float)
                )
                marker = " <- serving" if m["id"] == serving_id else ""
                print(f"{m['id']}  round={m.get('round')}  state={m.get('state')}  {headline}{marker}")
            return 0
        if args.action == "promote":
            if not args.artifact:
                raise SystemExit("registry promote needs --artifact <id>")
            m = registry.promote(args.artifact, to=args.to)
            print(f"{m['id']} -> {m['state']}")
            return 0
        if args.action == "rollback":
            m = registry.rollback()
            print(f"serving pointer -> {m['id']} (round {m.get('round')})")
            return 0
        if args.max_artifacts is None:  # gc
            raise SystemExit("registry gc needs --max-artifacts N")
        removed = registry.gc(max_artifacts=args.max_artifacts)
        for aid in removed:
            print(f"pruned {aid}")
        print(f"{len(removed)} artifact(s) pruned, {len(registry.list())} kept")
        return 0
    except RegistryError as e:
        raise SystemExit(str(e)) from None
