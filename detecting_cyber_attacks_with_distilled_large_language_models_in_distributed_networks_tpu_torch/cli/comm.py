"""``serve`` / ``client`` / ``relay``: the federated round over TCP (the
reference's socket deployment, server.py + client1.py end to end, and the
fold tree's intermediate aggregator; the port of the JAX package's
``cli/comm.py``: dense or streamed uploads and replies, the bf16/int8/top-k
wires, HMAC, server strategies, the client's FedProx, central DP with its
accountant banner, secure aggregation, ranked parents with re-homing, and
the client personas of the fault harness).

Both run on the card unless ``--device cpu`` is given. A JAX ``serve``,
``relay`` or ``client`` interoperates with these. The HMAC key comes from
the ``FEDTPU_SECRET`` environment variable, never from argv; under secure
aggregation a client's own identity key from ``FEDTPU_CLIENT_SECRET`` and
the server's registry of them from ``FEDTPU_CLIENT_SECRETS``
(``id:secret,id:secret``).

The obs flags are the JAX verbs': ``serve --trace-jsonl --metrics-port
--flight-dir`` (round/agg/wire-reply spans, the server families on
/metrics bound on ``--host``, a bundle on round failure) and ``client
--trace-jsonl --metrics-jsonl --profile-stride`` (client-local,
batch-prefetch and wire spans under the server's trace id, one metrics
record per round and phase, device memory at post-restore,
post-aggregate and post-round).
"""

from __future__ import annotations

import logging
import os
import time

from ..comm import AggregationServer, FederatedClient, wire
from ..device import resolve_device
from .common import _append_metrics, _load_clients, _obs_setup, _resolve_with_pretrained, _write_reports

log = logging.getLogger(__name__)


def _auth_key() -> bytes | None:
    """The shared HMAC key of the TCP round, from FEDTPU_SECRET (never
    argv: process listings leak flags). Unset, the round is the
    reference's open protocol."""
    secret = os.environ.get("FEDTPU_SECRET")
    return secret.encode() if secret else None


def _client_identity_key() -> bytes | None:
    """This client's own DH identity secret (FEDTPU_CLIENT_SECRET): the
    secure key exchange binds its hello to this id."""
    secret = os.environ.get("FEDTPU_CLIENT_SECRET")
    return secret.encode() if secret else None


def _server_client_keys() -> dict[int, bytes] | None:
    """The server's registry of per-client identity secrets
    (FEDTPU_CLIENT_SECRETS='0:alpha,1:bravo'); ids not listed are refused
    in the secure key exchange."""
    raw = os.environ.get("FEDTPU_CLIENT_SECRETS")
    if not raw:
        return None
    keys: dict[int, bytes] = {}
    for entry in raw.split(","):
        cid, _, secret = entry.partition(":")
        try:
            keys[int(cid.strip())] = secret.encode()
        except ValueError:
            raise SystemExit(
                f"malformed FEDTPU_CLIENT_SECRETS entry {entry!r} (want 'id:secret,id:secret,...')"
            ) from None
        if not secret:
            raise SystemExit(f"empty secret for client {cid} in FEDTPU_CLIENT_SECRETS")
    return keys


def _parse_parents(entries) -> tuple[tuple[str, int] | None, list[tuple[str, int]] | None]:
    """``--parent HOST:PORT`` (repeatable): the primary (None when absent)
    and the ranked fallbacks (None when there are none)."""
    if not entries:
        return None, None
    parsed = []
    for entry in entries:
        host, sep, port = str(entry).rpartition(":")
        if not sep or not host or not port.isdigit():
            raise SystemExit(f"malformed --parent {entry!r} (want HOST:PORT)")
        parsed.append((host, int(port)))
    return parsed[0], parsed[1:] or None


def build_server(args) -> AggregationServer:
    """The aggregation server the ``serve`` flags describe, bound and
    listening (``server.port`` is the bound port), not yet serving."""
    if not 0.0 < args.dp_participation <= 1.0:
        raise SystemExit(f"--dp-participation {args.dp_participation} must be in (0, 1]")
    _log_dp_banner(args)
    tracer, metrics_server = _obs_setup(args, proc="server", metrics_host=args.host)
    server = AggregationServer(
        host=args.host,
        port=args.port,
        num_clients=args.num_clients,
        weighted=args.weighted,
        min_clients=args.min_clients,
        timeout=args.timeout,
        compression=args.compression,
        auth_key=_auth_key(),
        secure_agg=args.secure_agg,
        client_keys=_server_client_keys(),
        secure_protocol=args.secure_protocol,
        secure_threshold=args.secure_threshold,
        stream_chunk_bytes=wire.stream_chunk_bytes_from_mb(args.stream_chunk_mb),
        strategy=args.strategy,
        strategy_state_path=args.strategy_state_file,
        reply_dtype=args.reply_dtype,
        dp_clip=args.dp_clip,
        dp_noise_multiplier=args.dp_noise_multiplier,
        dp_participation=args.dp_participation,
        dp_history_path=args.dp_history_file,
        device=args.device,
        tracer=tracer,
    )
    server.metrics_server = metrics_server
    return server


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
    if args.secure_agg:
        # Masked uploads cannot be re-clipped: the bound assumes every
        # client clips honestly.
        banner += (
            ". Secure-agg caveat: clipping is HONEST-CLIENT-ONLY "
            "(masked uploads cannot be re-clipped server-side); one "
            "dishonest client can widen the mechanism's sensitivity"
        )
    log.info(banner)
    return banner


def cmd_serve(args) -> int:
    with build_server(args) as server:  # closes its /metrics endpoint too
        log.info(f"[SERVER] listening on {args.host}:{server.port} (fold on {server.device})")
        server.serve(rounds=args.rounds)
    return 0


def build_relay(args):
    """The relay the ``relay`` flags describe (comm/relay.py), bound and
    listening, not yet serving: a subtree of ``--num-clients`` folded on
    the card (K4) and forwarded to ``--parent-host:--parent-port``."""
    from ..comm.relay import RelayAggregator

    tracer, metrics_server = _obs_setup(args, proc=f"relay-{args.relay_id}", metrics_host=args.host)
    relay = RelayAggregator(
        args.host,
        args.port,
        parent_host=args.parent_host,
        parent_port=args.parent_port,
        relay_id=args.relay_id,
        num_clients=args.num_clients,
        min_clients=args.min_clients,
        timeout=args.timeout,
        compression=args.compression,
        auth_key=_auth_key(),
        stream_chunk_bytes=wire.stream_chunk_bytes_from_mb(args.stream_chunk_mb),
        stream=args.stream_upload,
        subtree_deadline_factor=args.subtree_deadline_factor,
        tracer=tracer,
        strategy=args.strategy or "fedavg",
        upward_topk=args.upward_topk,
        device=args.device,
    )
    relay.server.metrics_server = metrics_server
    return relay


def cmd_relay(args) -> int:
    """One intermediate aggregator of the fold tree: clients point at it
    as at a root; run the root ``serve`` with ``--weighted`` so subtree
    means recombine by their sample mass."""
    with build_relay(args) as relay:
        log.info(
            f"[RELAY {args.relay_id}] listening on {args.host}:{relay.port}"
            f" -> parent {args.parent_host}:{args.parent_port} (fold on {relay.server.device})"
        )
        relay.serve(rounds=args.rounds or 1)
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
    ``exchange``, the client's wire record; ``n_samples``, the weight the
    upload declared; and under DP ``round_base``,
    the params the round's training started from), ``uploaded``, ``aggregate``,
    ``seconds`` and ``exchange`` of the last round (with the data and
    model set-up before the first in ``seconds``), ``metrics_csvs``,
    ``client`` (the FederatedClient, whose ``rehomes`` count the moves to
    a fallback parent), and with a checkpoint directory ``warm_step``
    (the step warm-started from, None for a fresh start) and
    ``saved_steps``.

    ``--parent HOST:PORT`` (repeatable) gives the ranked parents, the
    first replacing ``--host/--port``. ``--persona`` runs the client as a
    fault-harness persona: a lazy client trains a fraction of the epochs,
    a stale one sits out every second round (waiting the round window
    out), and the wire personas dial the server through an in-process
    seeded fault proxy (``--fault-seed``; start the server first: behind
    the proxy the dial succeeds while the server is down).

    Obs: with ``--trace-jsonl`` each round's ``client-local`` span (the
    training seconds, with the sampled step attrs under
    ``--profile-stride``) and the next-round ``batch-prefetch`` span are
    written with the exchange's wire spans under the server's trace id;
    ``--metrics-jsonl`` gets the round's local and aggregated records.

    ``--data-parallel N [--fsdp]`` trains the local phase over N of this
    host's devices (train/client_mesh.py): the wire exchange is the
    single-device client's, and a streamed reply's leaves land on the
    mesh as they arrive (``reply_leaf_sink``), so a round's recorded
    ``aggregate`` then holds those placed leaves (the port's layout).

    With a checkpoint directory the client warm-starts from its latest
    step and saves twice a round: after local training (the reference's
    client1.py:388) and after adopting the aggregate (:403, meta
    ``"aggregated": True``). The saves take their own step ids, seeded
    past the directory's latest, since ``state.step`` alone can lag
    them. Epoch offsets start from 0 on every launch, as in the JAX
    package."""
    t_start = time.perf_counter()
    device = resolve_device(args.device)  # raises before any work without CUDA
    tok, cfg, pretrained = _resolve_with_pretrained(args)
    server_host, server_port = args.host, args.port
    primary, fallback_parents = _parse_parents(args.parent)
    if primary is not None:
        server_host, server_port = primary
    persona = proxy = None
    if args.persona:
        from ..faults.personas import get_persona, start_persona_proxy

        persona = get_persona(args.persona)
        # The proxy fronts the primary only; fallbacks are dialed directly.
        proxy = start_persona_proxy(
            persona, server_host, server_port, fault_seed=args.fault_seed, client_id=args.client_id
        )
        if proxy is not None:
            server_host, server_port = proxy.host, proxy.port
        log.info(
            f"[CLIENT {args.client_id}] persona '{persona.name}' (fault seed {args.fault_seed})"
            + (f": wire faults via proxy {proxy.host}:{proxy.port}" if proxy is not None else ": client-side behavior only")
        )
    try:
        return _run_client_rounds(args, device, tok, cfg, pretrained, server_host, server_port,
                                  fallback_parents, persona, t_start)
    finally:
        if proxy is not None:
            proxy.close()


def _run_client_rounds(args, device, tok, cfg, pretrained, server_host, server_port, fallback_parents,
                       persona, t_start) -> dict:
    """``run_client``'s rounds, against ``server_host:server_port``."""
    from ..comm.secure import SecureAggError
    from ..obs.profile import note_memory
    from ..train.checkpoint import Checkpointer, maybe_warm_start
    from ..train.client_mesh import make_client_trainer

    fed = FederatedClient(
        server_host, server_port, client_id=args.client_id, timeout=args.timeout,
        compression=args.compression, auth_key=_auth_key(), stream=args.stream_upload,
        wire_dtype=args.wire_dtype, dp=args.dp, secure_agg=args.secure_agg,
        num_clients=cfg.fed.num_clients, client_key=_client_identity_key(),
        min_participants=args.min_participants, secure_protocol=args.secure_protocol,
        secure_threshold=args.secure_threshold, fallback_parents=fallback_parents,
        rehome_dial_budget=args.rehome_dial_budget,
    )
    # The round loop writes its own client-local span (note_local_phase),
    # so the global tracer stays disarmed.
    fed.tracer, _metrics = _obs_setup(args, proc=f"client-{args.client_id}", cfg=cfg, install_global=False)
    client = _load_clients(args, cfg, tok, cfg.fed.num_clients)[args.client_id]
    try:
        trainer = make_client_trainer(cfg, pad_id=tok.pad_id, device=device)
    except ValueError as e:
        # Operator error (the axis against the local devices or the batch),
        # not a traceback: --data-parallel 4 on a 2-card host etc.
        raise SystemExit(str(e)) from None
    if cfg.mesh.data > 1:
        log.info(
            f"[CLIENT {args.client_id}] local mesh: data={cfg.mesh.data} over "
            f"{cfg.mesh.data} local device(s)"
            + (" — FSDP shard-at-rest (params+opt ~1/N per device, gather-at-use)" if cfg.mesh.fsdp else "")
        )
    sink = getattr(trainer, "reply_leaf_sink", None)
    if sink is not None:
        # Meshed client: streamed-reply leaves land on the local mesh as
        # their chunks arrive, so adopt_aggregate never waits for a full
        # host-side tree.
        fed.reply_leaf_sink = sink
    state = trainer.init_state(params=pretrained)
    tag = f"[CLIENT {args.client_id}] "
    ckpt = warm_step = None
    saved_steps: list[int] = []
    if cfg.checkpoint_dir:
        restored, warm_step = maybe_warm_start(cfg.checkpoint_dir, state)
        if restored is not None:
            state = restored
            log.info(f"{tag}warm start from {cfg.checkpoint_dir} (step {warm_step})")
        note_memory("post-restore")
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
        if persona is not None and persona.skips_round(r):
            # Stale persona: offline this round. Wait the round window out,
            # or the next round's upload would land in this one.
            log.info(f"{tag}persona '{persona.name}': sitting out round {r + 1}/{rounds}")
            if r + 1 < rounds:
                time.sleep(args.timeout)
            continue
        # Central DP: the round base is what this round's training starts
        # from (the shared init in round 1, the adopted aggregate after);
        # host_params copies, so training cannot alias it.
        round_base = trainer.host_params(state) if fed.dp else None
        t_local = time.time()
        t0 = time.perf_counter()
        state, _ = trainer.fit(
            state, client.train, batch_size=cfg.data.batch_size, epoch_offset=r * E, tag=tag,
            # A lazy persona trains a fraction of the epochs (at least one).
            epochs=persona.scaled(E) if persona is not None else None,
        )
        t1 = time.perf_counter()
        # Buffered until the exchange names the round (trace, round).
        fed.note_local_phase(t_local, t1 - t0, client=args.client_id, **trainer.step_profile_attrs())
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
        except (OSError, SecureAggError) as e:  # ConnectionError included: the server is gone
            agg_metrics = aggregated = None
            log.info(f"{tag}round {r + 1} exchange failed ({e}); local-only reports")
            break
        t4 = time.perf_counter()
        if prefetch is not None and prefetch.ready():
            # The input-pipeline seconds hidden behind the reply wait,
            # stamped with the round identity on the NEXT exchange.
            seconds["prefetch"] = prefetch.busy_s
            fed.note_phase(
                "batch-prefetch", prefetch.t_unix, prefetch.busy_s,
                client=args.client_id, batches=prefetch.n_prefetched,
            )
        agg_metrics = trainer.evaluate(aggregated, client.test, batch_size=eval_bs)
        t5 = time.perf_counter()
        log.info(
            f"{tag}round {r + 1}: local acc {local['Accuracy']:.4f} -> "
            f"aggregated acc {agg_metrics['Accuracy']:.4f}"
        )
        _append_metrics(args, (
            {"round": r + 1, "client": args.client_id, "phase": phase_name, **m}
            for phase_name, m in (("local", local), ("aggregated", agg_metrics))
        ))
        # The next round trains FROM the aggregate with a fresh Adam and a
        # continuing step counter.
        state = trainer.adopt_aggregate(state, aggregated)
        # The adoption boundary: fresh Adam moments land here.
        note_memory("post-aggregate")
        if ckpt is not None:
            save(aggregated=True)
        note_memory("post-round")
        seconds.update(exchange=t4 - t3, eval_aggregated=t5 - t4, adopt=time.perf_counter() - t5)
        records.append({
            "uploaded": uploaded, "aggregate": aggregated, "local": local,
            "aggregated": agg_metrics, "seconds": dict(seconds), "exchange": fed.last_exchange,
            "round_base": round_base, "n_samples": len(client.train),
        })
    paths = _write_reports(args.client_id, local, agg_metrics, cfg.output_dir)
    return {
        "config": cfg, "trainer": trainer, "state": state, "local": local,
        "aggregated": agg_metrics, "rounds": records, "uploaded": uploaded, "aggregate": aggregated,
        "seconds": seconds, "exchange": fed.last_exchange, "metrics_csvs": paths,
        "warm_step": warm_step, "saved_steps": saved_steps, "client": fed,
    }


def cmd_client(args) -> int:
    run_client(args)
    return 0
