"""``federated`` — N clients in one process on one card: lockstep local
epochs, FedAvg over the stacked clients axis, several rounds, with
checkpoint, resume and registry publication (the port of the JAX
package's ``cli/federated.py``, single process). Runs on the card unless
``--device cpu``."""

from __future__ import annotations

import logging
import os

import numpy as np

from ..device import resolve_device
from ..reporting import METRIC_COLUMNS
from .common import _load_clients, _resolve_with_pretrained, _write_reports

log = logging.getLogger(__name__)


def run_federated(args) -> dict:
    """The ``federated`` command's work: :meth:`FederatedTrainer.run` over
    the clients' train splits, scoring val and test, with a checkpoint
    (``--checkpoint-dir``) and a registry artifact of the global model
    (``--registry-dir``) after each round. A checkpoint directory that
    holds a finished round resumes from it. The final evaluation (with
    probs) writes the per-client metrics CSVs.

    With ``fed.personalize_epochs`` each client then fine-tunes a copy of
    the aggregate and is scored as a third phase
    (``client{c}_personalized_metrics.csv``); with DP noise the ``[DP]``
    banner states the guarantee of the rounds run.

    Returns ``config``, ``trainer``, ``state``, ``clients`` (token
    arrays), ``stacked_train``, ``start_round``, ``history`` (the
    :class:`RoundRecord` of each round this launch ran), ``final``
    (aggregated test metrics with probs), ``personalized`` (test metrics,
    or None), ``dp_banner`` (or None), ``artifacts`` (registry ids) and
    ``metrics_csvs``."""
    from ..data.pipeline import stack_clients_ragged
    from ..train.checkpoint import Checkpointer, maybe_warm_start
    from ..train.federated import FederatedTrainer

    device = resolve_device(args.device)  # raises before any work without CUDA
    tok, cfg, pretrained = _resolve_with_pretrained(args)
    C = cfg.fed.num_clients
    clients = _load_clients(args, cfg, tok, C)
    # Ragged stack to the fleet-max row count: no client's rows are
    # truncated (the reference's N processes each train on all of theirs).
    stacked_train = stack_clients_ragged([c.train for c in clients], pad_id=tok.pad_id)
    trainer = FederatedTrainer(cfg, pad_id=tok.pad_id, device=device)
    log.info(f"[FED] {C} clients on {device}, train rows {[len(c.train) for c in clients]}")

    state = trainer.init_state(params=pretrained)
    start_round = 0
    ckpt = None
    if cfg.checkpoint_dir:
        restored, step = maybe_warm_start(cfg.checkpoint_dir, state)
        if restored is not None:
            state, start_round = restored, int(step)
            log.info(f"[FED] resumed from round {start_round}")
            # Checkpoints are written before the per-round optimizer
            # reset; apply the reset an uninterrupted run would have done.
            if start_round < cfg.fed.rounds and cfg.fed.reset_optimizer_each_round:
                state = trainer.reset_optimizer(state)
        ckpt = Checkpointer(cfg.checkpoint_dir)
    registry = None
    if getattr(args, "registry_dir", None):
        from ..registry import ModelRegistry

        registry = ModelRegistry(args.registry_dir)
    artifacts = []

    def save(state, record) -> None:
        r = record.round + 1
        if ckpt is not None:
            ckpt.save(r, state, meta={"round": r, "kind": "federated", "config": cfg.to_dict()})
        if registry is not None:
            # Row 0 is the global model (the mean is written into every
            # row); fleet-mean validation metrics, never test.
            fleet_val = {k: float(np.mean([m[k] for m in record.aggregated_val])) for k in METRIC_COLUMNS}
            artifacts.append(registry.add(
                {n: p[0] for n, p in state.params.items()},
                round_index=r,
                metrics=fleet_val,
                model_config=cfg.model,
                extra={"tier": "mesh", "clients": C},
            ))

    test = [c.test for c in clients]
    state, history = trainer.run(
        state, stacked_train, test, val_splits=[c.val for c in clients], start_round=start_round, on_round=save
    )
    if ckpt is not None:
        ckpt.close()

    dp_banner = _log_dp_guarantee(cfg, start_round)
    final = trainer.evaluate_clients(state.params, test, collect_probs=True)
    personalized = None
    if cfg.fed.personalize_epochs > 0:
        # FedAvg + local fine-tuning on a copy of the aggregate (scope
        # 'head' = FedPer), evaluated as a third phase; the aggregate
        # itself, evaluated above, stays as it is.
        log.info(
            f"[FED] personalization ({cfg.fed.personalize_epochs} epoch(s), "
            f"scope {cfg.fed.personalize_scope})"
        )
        pstate, _ = trainer.personalize(state, stacked_train)
        personalized = trainer.evaluate_clients(pstate.params, test)
        for c in range(C):
            log.info(
                f"[FED] client {c}: aggregated test acc {final[c]['Accuracy']:.4f} "
                f"-> personalized {personalized[c]['Accuracy']:.4f}"
            )
    if not history:
        # No round trained in this launch (a finished run relaunched):
        # there are no local-model metrics to report.
        log.info("[FED] all rounds already complete; writing aggregated reports only")
    local = history[-1].local_metrics if history else [None] * C
    paths = [p for c in range(C) for p in _write_reports(c, local[c], final[c], cfg.output_dir)]
    if personalized is not None:
        paths += _save_phase_csvs(personalized, "personalized", cfg.output_dir)
    return {
        "config": cfg, "trainer": trainer, "state": state, "clients": clients,
        "stacked_train": stacked_train, "start_round": start_round,
        "history": history, "final": final, "personalized": personalized,
        "dp_banner": dp_banner, "artifacts": artifacts, "metrics_csvs": paths,
    }


def _log_dp_guarantee(cfg, start_round: int) -> str | None:
    """Log (and return) the ``[DP]`` banner: the client-level guarantee
    of the rounds this launch ran, under both adjacencies; None without
    DP noise."""
    if not cfg.fed.dp_enabled():
        return None
    from ..parallel.dp import dp_epsilon_both

    # Only this launch's rounds are known to have run under this DP
    # config: a resumed checkpoint's earlier rounds may have had none.
    dp_rounds = cfg.fed.rounds - start_round
    # participation < 1: the subsampled-Gaussian accountant credits the
    # amplification; q is exact under the Poisson sampler (the default
    # with DP on), the cohort_size/C approximation under the fixed one.
    q, q_exact = cfg.fed.dp_sampling_rate()
    eps_zeroed, eps_replace = dp_epsilon_both(dp_rounds, cfg.fed.dp_noise_multiplier, 1e-5, sampling_rate=q)
    caveat = (
        ""
        if start_round == 0
        else (
            f" — covers rounds {start_round + 1}..{cfg.fed.rounds} only; "
            f"the {start_round} resumed round(s) carry whatever DP "
            "config they were run with"
        )
    )
    if q >= 1.0:
        sampling_note = ""
    elif q_exact:
        sampling_note = f"; Poisson sampling q={q:.3g} (accountant exact)"
    else:
        sampling_note = (
            f"; fixed-size cohort accounted as Poisson sampling "
            f"q={q:.3g} (approximation — use "
            f"--participation-mode poisson for an exact bound)"
        )
    banner = (
        f"[DP] client-level guarantee for {dp_rounds} round(s): "
        f"({eps_zeroed:.3g}, 1e-05)-DP under zeroed-contribution "
        f"adjacency; ({eps_replace:.3g}, 1e-05)-DP under replace-one "
        f"adjacency (clip {cfg.fed.dp_clip}, "
        f"noise x{cfg.fed.dp_noise_multiplier}{sampling_note})"
        f"{caveat}"
    )
    log.info(banner)
    return banner


def _save_phase_csvs(metrics: list, phase_name: str, out_dir: str) -> list[str]:
    """One ``client{c}_{phase}_metrics.csv`` per client (the reference
    schema); returns their paths."""
    from .. import reporting

    os.makedirs(out_dir, exist_ok=True)
    return [
        reporting.save_metrics(m, os.path.join(out_dir, f"client{c}_{phase_name}_metrics.csv"))
        for c, m in enumerate(metrics)
    ]


def cmd_federated(args) -> int:
    run_federated(args)
    return 0
