"""``federated`` — N clients in one process on one card: lockstep local
epochs, FedAvg over the stacked clients axis, several rounds, with
checkpoint, resume and registry publication (the port of the JAX
package's ``cli/federated.py``, single process). Runs on the card unless
``--device cpu``."""

from __future__ import annotations

import logging

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

    Returns ``config``, ``trainer``, ``state``, ``clients`` (token
    arrays), ``stacked_train``, ``start_round``, ``history`` (the
    :class:`RoundRecord` of each round this launch ran), ``final``
    (aggregated test metrics with probs), ``artifacts`` (registry ids)
    and ``metrics_csvs``."""
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

    final = trainer.evaluate_clients(state.params, test, collect_probs=True)
    if not history:
        # No round trained in this launch (a finished run relaunched):
        # there are no local-model metrics to report.
        log.info("[FED] all rounds already complete; writing aggregated reports only")
    local = history[-1].local_metrics if history else [None] * C
    paths = [p for c in range(C) for p in _write_reports(c, local[c], final[c], cfg.output_dir)]
    return {
        "config": cfg, "trainer": trainer, "state": state, "clients": clients,
        "stacked_train": stacked_train, "start_round": start_round,
        "history": history, "final": final, "artifacts": artifacts, "metrics_csvs": paths,
    }


def cmd_federated(args) -> int:
    run_federated(args)
    return 0
