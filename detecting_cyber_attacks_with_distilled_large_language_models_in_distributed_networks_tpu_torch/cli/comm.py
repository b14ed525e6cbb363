"""``serve`` / ``client``: the federated round over TCP (the reference's
socket deployment, server.py + client1.py end to end; the port of the JAX
package's ``cli/comm.py`` without secure aggregation: dense or streamed
uploads and replies, the bf16/int8/top-k wires, HMAC, server strategies,
the client's FedProx, and central DP with its accountant banner).

Both run on the card unless ``--device cpu`` is given. A JAX ``serve`` or
``client`` interoperates with these. The HMAC key comes from the
``FEDTPU_SECRET`` environment variable, never from argv.
"""

from __future__ import annotations

import logging
import os
import time

from ..comm import AggregationServer, FederatedClient, wire
from ..device import resolve_device
from .common import _load_clients, _resolve_with_pretrained, _write_reports

log = logging.getLogger(__name__)


def _auth_key() -> bytes | None:
    """The shared HMAC key of the TCP round, from FEDTPU_SECRET (never
    argv: process listings leak flags). Unset, the round is the
    reference's open protocol."""
    secret = os.environ.get("FEDTPU_SECRET")
    return secret.encode() if secret else None


def _refuse_identity_keys(name: str) -> None:
    """Per-client identity keys (the JAX secure tier's DH binding, from
    ``name`` in the environment) are not ported: refused, never ignored."""
    if os.environ.get(name):
        raise wire.ModeError(
            f"{name} is set: per-client identity keys (secure aggregation's "
            "key binding) are not ported"
        )


def build_server(args) -> AggregationServer:
    """The aggregation server the ``serve`` flags describe, bound and
    listening (``server.port`` is the bound port), not yet serving."""
    _refuse_identity_keys("FEDTPU_CLIENT_SECRETS")
    if not 0.0 < args.dp_participation <= 1.0:
        raise SystemExit(f"--dp-participation {args.dp_participation} must be in (0, 1]")
    _log_dp_banner(args)
    return AggregationServer(
        host=args.host,
        port=args.port,
        num_clients=args.num_clients,
        weighted=args.weighted,
        min_clients=args.min_clients,
        timeout=args.timeout,
        compression=args.compression,
        auth_key=_auth_key(),
        stream_chunk_bytes=wire.stream_chunk_bytes_from_mb(args.stream_chunk_mb),
        strategy=args.strategy,
        strategy_state_path=args.strategy_state_file,
        reply_dtype=args.reply_dtype,
        dp_clip=args.dp_clip,
        dp_noise_multiplier=args.dp_noise_multiplier,
        dp_participation=args.dp_participation,
        dp_history_path=args.dp_history_file,
        device=args.device,
    )


def _log_dp_banner(args) -> str | None:
    """The serve verb's ``[DP]`` banner (and its return): the client-level
    guarantee of the served rounds under both adjacencies. The Poisson
    cohort is the sampler the subsampled-Gaussian accountant assumes, so
    the epsilon is exact at any q."""
    if not args.dp_clip > 0.0:
        return None
    if not args.dp_noise_multiplier > 0.0:
        log.warning(
            "[DP] --dp-clip without --dp-noise-multiplier clips uploads "
            "but adds NO noise: no (epsilon, delta) guarantee"
        )
        return None
    from ..parallel.dp import dp_epsilon_both

    rounds = args.rounds or 1
    q = args.dp_participation
    eps_zeroed, eps_replace = dp_epsilon_both(rounds, args.dp_noise_multiplier, 1e-5, sampling_rate=q)
    sampling_note = (
        "full participation, accountant exact"
        if q >= 1.0
        else (
            f"Poisson cohort sampling q={q:.3g} (accountant "
            "exact; sampled sets are kept out of replies — "
            "amplification assumes a hidden cohort)"
        )
    )
    banner = (
        f"[DP] client-level guarantee for {rounds} round(s): "
        f"({eps_zeroed:.3g}, 1e-05)-DP under zeroed-contribution "
        f"adjacency; ({eps_replace:.3g}, 1e-05)-DP under replace-one "
        f"adjacency (clip {args.dp_clip}, noise x{args.dp_noise_multiplier}; "
        f"{sampling_note}). Noise caveat: float32 Gaussian draws "
        "(OS-entropy Philox) — not hardened against the Mironov "
        "floating-point precision attack (no discrete Gaussian)"
    )
    log.info(banner)
    return banner


def cmd_serve(args) -> int:
    with build_server(args) as server:
        log.info(f"[SERVER] listening on {args.host}:{server.port} (fold on {server.device})")
        server.serve(rounds=args.rounds)
    return 0


def run_client(args) -> dict:
    """The ``client`` command's work: (train -> evaluate -> exchange ->
    evaluate the aggregate -> adopt it) per round, then the metrics CSVs;
    degrades to local-only reports when an exchange fails
    (client1.py:405-410). While the exchange waits for the aggregate, the
    next round's first batches are built on a thread (``prefetch_epoch``;
    the same batches either way). Returns what it measured and wrote:
    ``config``, ``trainer``, ``state``, ``local`` and ``aggregated``
    metrics (None after a failed exchange), ``rounds`` (per round: the
    params as sent, JAX layout, whose leaves are host arrays once sent;
    the aggregate as received; the metrics; the seconds per phase;
    ``exchange``, the client's wire record; and under DP ``round_base``,
    the params the round's training started from), ``uploaded``, ``aggregate``,
    ``seconds`` and ``exchange`` of the last round (with the data and
    model set-up before the first in ``seconds``), ``metrics_csvs``, and
    with a checkpoint directory ``warm_step`` (the step warm-started
    from, None for a fresh start) and ``saved_steps``.

    With a checkpoint directory the client warm-starts from its latest
    step and saves twice a round: after local training (the reference's
    client1.py:388) and after adopting the aggregate (:403, meta
    ``"aggregated": True``). The saves take their own step ids, seeded
    past the directory's latest, since ``state.step`` alone can lag
    them. Epoch offsets start from 0 on every launch, as in the JAX
    package."""
    from ..train.checkpoint import Checkpointer, maybe_warm_start
    from ..train.engine import Trainer

    t_start = time.perf_counter()
    device = resolve_device(args.device)  # raises before any work without CUDA
    # Refuses what the JAX client refuses (--wire-dtype with --compression)
    # before any data is loaded.
    _refuse_identity_keys("FEDTPU_CLIENT_SECRET")
    fed = FederatedClient(
        args.host, args.port, client_id=args.client_id, timeout=args.timeout,
        compression=args.compression, auth_key=_auth_key(), stream=args.stream_upload,
        wire_dtype=args.wire_dtype, dp=args.dp,
    )
    tok, cfg, pretrained = _resolve_with_pretrained(args)
    client = _load_clients(args, cfg, tok, cfg.fed.num_clients)[args.client_id]
    trainer = Trainer(
        cfg.model, cfg.train, pad_id=tok.pad_id,
        drop_remainder=cfg.data.drop_remainder, device=device,
    )
    state = trainer.init_state(params=pretrained)
    tag = f"[CLIENT {args.client_id}] "
    ckpt = warm_step = None
    saved_steps: list[int] = []
    if cfg.checkpoint_dir:
        restored, warm_step = maybe_warm_start(cfg.checkpoint_dir, state)
        if restored is not None:
            state = restored
            log.info(f"{tag}warm start from {cfg.checkpoint_dir} (step {warm_step})")
        ckpt = Checkpointer(cfg.checkpoint_dir)
        save_seq = max(state.step, ckpt.latest_step() or 0)

    def save(**extra) -> None:
        nonlocal save_seq
        save_seq += 1
        ckpt.save(
            save_seq, state,
            meta={"client_id": args.client_id, "kind": "local", "config": cfg.to_dict(), **extra},
        )
        saved_steps.append(save_seq)

    E = cfg.train.epochs_per_round
    eval_bs = cfg.data.eval_batch_size
    rounds = cfg.fed.rounds
    local = agg_metrics = uploaded = aggregated = None
    setup_s = time.perf_counter() - t_start
    seconds: dict[str, float] = {}
    records: list[dict] = []
    for r in range(rounds):
        # Central DP: the round base is what this round's training starts
        # from (the shared init in round 1, the adopted aggregate after);
        # host_params copies, so training cannot alias it.
        round_base = trainer.host_params(state) if fed.dp else None
        t0 = time.perf_counter()
        state, _ = trainer.fit(
            state, client.train, batch_size=cfg.data.batch_size, epoch_offset=r * E, tag=tag
        )
        t1 = time.perf_counter()
        local = trainer.evaluate_state(state, client.test, batch_size=eval_bs)
        t2 = time.perf_counter()
        if ckpt is not None:
            save()
        t_saved = time.perf_counter()
        # Lazy: each leaf comes off the card when the upload packs it.
        uploaded = trainer.host_params(state, lazy=True)
        t3 = time.perf_counter()
        seconds = {"setup": setup_s, "train": t1 - t0, "eval_local": t2 - t1,
                   "save": t_saved - t2, "host_params": t3 - t_saved}
        prefetch = (
            trainer.prefetch_epoch(client.train, (r + 1) * E, cfg.data.batch_size)
            if r + 1 < rounds
            else None
        )
        try:
            aggregated = fed.exchange(uploaded, n_samples=len(client.train), round_base=round_base)
        except OSError as e:  # ConnectionError included: the server is gone
            agg_metrics = aggregated = None
            log.info(f"{tag}round {r + 1} exchange failed ({e}); local-only reports")
            break
        t4 = time.perf_counter()
        if prefetch is not None and prefetch.ready():
            # The input-pipeline seconds hidden behind the reply wait.
            seconds["prefetch"] = prefetch.busy_s
        agg_metrics = trainer.evaluate(aggregated, client.test, batch_size=eval_bs)
        t5 = time.perf_counter()
        log.info(
            f"{tag}round {r + 1}: local acc {local['Accuracy']:.4f} -> "
            f"aggregated acc {agg_metrics['Accuracy']:.4f}"
        )
        # The next round trains FROM the aggregate with a fresh Adam and a
        # continuing step counter.
        state = trainer.adopt_aggregate(state, aggregated)
        if ckpt is not None:
            save(aggregated=True)
        seconds.update(exchange=t4 - t3, eval_aggregated=t5 - t4, adopt=time.perf_counter() - t5)
        records.append({
            "uploaded": uploaded, "aggregate": aggregated, "local": local,
            "aggregated": agg_metrics, "seconds": dict(seconds), "exchange": fed.last_exchange,
            "round_base": round_base,
        })
    paths = _write_reports(args.client_id, local, agg_metrics, cfg.output_dir)
    return {
        "config": cfg, "trainer": trainer, "state": state, "local": local,
        "aggregated": agg_metrics, "rounds": records, "uploaded": uploaded, "aggregate": aggregated,
        "seconds": seconds, "exchange": fed.last_exchange, "metrics_csvs": paths,
        "warm_step": warm_step, "saved_steps": saved_steps,
    }


def cmd_client(args) -> int:
    run_client(args)
    return 0
