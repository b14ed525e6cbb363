"""``federated`` — N clients on a mesh: lockstep local epochs, FedAvg over
the clients axis, several rounds, with checkpoint, resume and registry
publication (the port of the JAX package's ``cli/federated.py``). One
process holds every client; with ``--coordinator HOST:PORT
--num-processes N --process-id I`` N processes each hold a block of them
and the round's mean crosses processes (parallel/multihost.py). With
``--seq-parallel N`` each client trains with ring attention over N seq
slots (train/seqfed.py). Runs on the card unless ``--device cpu``."""

from __future__ import annotations

import logging
import os

import numpy as np

from ..parallel import multihost
from ..reporting import METRIC_COLUMNS
from ..utils.logging import phase
from .common import _append_metrics, _load_client_splits, _obs_setup, _resolve_with_pretrained, _write_reports

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
    ``metrics_csvs``.

    Obs, as the JAX verb: the trainer's per-round ``client-local`` and
    ``agg`` spans go to ``--trace-jsonl`` (proc ``fed``), ``--profile-dir``
    wraps the rounds in a torch.profiler trace, and ``--metrics-jsonl``
    gets one record per (round, client, phase, split) and the
    personalized test records.

    Multi-process (``--coordinator``): each process tokenizes and trains
    only its own block of clients; every process logs the whole fleet's
    round metrics; process 0 alone writes the reports, the metrics
    stream and the registry artifacts. Each process checkpoints its own
    clients under ``<checkpoint dir>/process-<id>``, and a relaunch
    resumes from the latest round every process holds. The returned
    ``clients`` and ``stacked_train`` are this process's."""
    from ..data.pipeline import stack_clients_ragged, tokenize_client
    from ..train.checkpoint import Checkpointer, maybe_warm_start
    from ..train.federated import FederatedTrainer
    from ..utils.profiling import trace

    try:
        multihost.initialize(args.coordinator, args.num_processes, args.process_id, device=args.device)
    except Exception as e:
        raise SystemExit(
            f"multi-host bootstrap failed: {e}\n"
            "Pass --coordinator HOST:PORT --num-processes N --process-id I "
            "together (every process the same coordinator)."
        )
    pid, nproc = multihost.process_index(), multihost.process_count()
    device = multihost.local_device(args.device, pid)  # raises before any work without CUDA
    if nproc == 1 and args.data_parallel and args.data_parallel > len(multihost.process_devices(device)):
        raise SystemExit(
            f"--data-parallel {args.data_parallel} exceeds the "
            f"{len(multihost.process_devices(device))} available devices"
        )
    tok, cfg, pretrained = _resolve_with_pretrained(args)
    C = cfg.fed.num_clients
    mesh = local_sl = None
    if nproc > 1:
        if C != cfg.mesh.clients:
            raise SystemExit(
                f"multi-host runs need one mesh row per client "
                f"(num_clients={C}, mesh.clients={cfg.mesh.clients})"
            )
        if cfg.mesh.seq > 1:
            # Clients across processes, each client's seq ring (and data
            # sum) inside one process.
            mesh = multihost.make_global_seq_mesh(cfg.mesh.clients, cfg.mesh.data, cfg.mesh.seq, device=device)
        else:
            mesh = multihost.make_global_mesh(
                cfg.mesh.clients, cfg.mesh.data, axis_names=cfg.mesh.axis_names, device=device
            )
        local_sl = multihost.local_client_slice(mesh)
        log.info(f"[FED] process {pid}/{nproc} owns clients [{local_sl.start}, {local_sl.stop})")
    local_ids = list(range(C)) if local_sl is None else list(range(local_sl.start, local_sl.stop))
    if getattr(args, "stream", False):
        if not getattr(args, "csv", None):
            raise SystemExit("--stream needs --csv (chunked two-pass reader)")
        from ..data.streaming import stream_client_tokens_for

        # Every process computes the same global plan and materializes
        # tokens only for its clients, learning every client's sizes.
        with phase(f"streaming {args.csv} for clients {local_ids}", tag="DATA"):
            clients, sizes = stream_client_tokens_for(
                args.csv, cfg.data, C, tok, local_ids, max_len=cfg.model.max_len
            )
        train_sizes = [s["train"] for s in sizes]
    else:
        # The partition runs over the whole fleet in every process (it must
        # agree); tokenizing runs only for this process's clients.
        splits = _load_client_splits(args, cfg, C)
        with phase(f"tokenize clients {local_ids}", tag="DATA"):
            clients = [tokenize_client(splits[c], tok, max_len=cfg.model.max_len) for c in local_ids]
        train_sizes = [len(s.train) for s in splits]
    # Ragged stack to the fleet-max row count: no client's rows are
    # truncated (the reference's N processes each train on all of theirs).
    stacked_train = stack_clients_ragged([c.train for c in clients], pad_id=tok.pad_id, target_rows=max(train_sizes))
    if cfg.mesh.seq > 1:
        # --seq-parallel N: the clients x data x seq composition (ring
        # attention per client) behind the same trainer surface.
        from ..train.seqfed import FedSeqTrainer

        try:
            trainer = FedSeqTrainer(cfg, pad_id=tok.pad_id, device=device, mesh=mesh)
        except ValueError as e:  # max_len or the slots against the axes
            raise SystemExit(str(e)) from None
    else:
        trainer = FederatedTrainer(cfg, pad_id=tok.pad_id, device=device, mesh=mesh)
    # The round boundary is a collective: one proc's spans cover the fleet.
    trainer.tracer, metrics_server = _obs_setup(args, proc="fed", cfg=cfg)
    log.info(f"[FED] {C} clients on {device}, train rows {train_sizes}")
    lead = pid == 0

    state = trainer.init_state(params=pretrained)
    start_round = 0
    ckpt = None
    if cfg.checkpoint_dir:
        ckpt_dir = cfg.checkpoint_dir if nproc == 1 else os.path.join(cfg.checkpoint_dir, f"process-{pid}")
        if nproc == 1:
            restored, step = maybe_warm_start(ckpt_dir, state)
        else:
            restored, step = _agreed_warm_start(ckpt_dir, state)
        if restored is not None:
            state, start_round = restored, int(step)
            log.info(f"[FED] resumed from round {start_round}")
            # Checkpoints are written before the per-round optimizer
            # reset; apply the reset an uninterrupted run would have done.
            if start_round < cfg.fed.rounds and cfg.fed.reset_optimizer_each_round:
                state = trainer.reset_optimizer(state)
        ckpt = Checkpointer(ckpt_dir)
    registry = None
    if getattr(args, "registry_dir", None) and lead:
        from ..registry import ModelRegistry

        registry = ModelRegistry(args.registry_dir)
    artifacts = []

    def save(state, record) -> None:
        r = record.round + 1
        if lead:
            _append_metrics(args, (
            {"round": r, "client": c, "phase": phase_name, "split": split_name, **m[c]}
                for c in range(C)
                for phase_name, split_name, m in (
                    ("local", "val", record.local_val),
                    ("local", "test", record.local_metrics),
                    ("aggregated", "val", record.aggregated_val),
                    ("aggregated", "test", record.aggregated_metrics),
                )
            ))
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
    with trace(args.profile_dir):
        state, history = trainer.run(
            state, stacked_train, test, val_splits=[c.val for c in clients], start_round=start_round, on_round=save,
            round_bracket=True,
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
        with phase(
            f"personalization ({cfg.fed.personalize_epochs} epoch(s), "
            f"scope {cfg.fed.personalize_scope})",
            tag="FED",
        ):
            pstate, _ = trainer.personalize(state, stacked_train)
            personalized = trainer.evaluate_clients(pstate.params, test)
        for c in range(C):
            log.info(
                f"[FED] client {c}: aggregated test acc {final[c]['Accuracy']:.4f} "
                f"-> personalized {personalized[c]['Accuracy']:.4f}"
            )
        if lead:
            _append_metrics(args, (
                {"round": cfg.fed.rounds, "client": c, "phase": "personalized", "split": "test", **personalized[c]}
                for c in range(C)
            ))
    if not history:
        # No round trained in this launch (a finished run relaunched):
        # there are no local-model metrics to report.
        log.info("[FED] all rounds already complete; writing aggregated reports only")
    local = history[-1].local_metrics if history else [None] * C
    paths = []
    if lead:
        paths = [p for c in range(C) for p in _write_reports(c, local[c], final[c], cfg.output_dir)]
        if personalized is not None:
            paths += _save_phase_csvs(personalized, "personalized", cfg.output_dir)
    if metrics_server is not None:
        metrics_server.close()
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


def _agreed_warm_start(directory: str, template):
    """Multi-process resume: the latest round EVERY process saved (each
    process checkpoints its own clients), or ``(None, None)``."""
    from ..train.checkpoint import Checkpointer, latest_finalized_step

    mine = latest_finalized_step(directory) if os.path.isdir(directory) else None
    step = int(multihost.allgather_hosts(-1 if mine is None else mine).min())
    if step < 0:
        return None, None
    with Checkpointer(directory) as ckpt:
        # Agreed too: a process that cannot resume makes every process
        # start fresh (the rounds are collectives).
        ok = int(multihost.allgather_hosts(int(ckpt.saved_compatible(template, step=step))).min())
        if not ok:
            log.warning(f"checkpoint {directory} (round {step}) does not fit every process; starting fresh")
            return None, None
        return ckpt.restore(template, step=step), step


def cmd_federated(args) -> int:
    try:
        run_federated(args)
    finally:
        multihost.shutdown()
    return 0
