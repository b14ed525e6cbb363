"""``route`` and ``fleet``: the serving replica tier (the port of the JAX
package's ``cli/router.py``).

``route`` runs the thin model-free router standalone over already-
running ``infer-serve`` backends (either package's: the protocol is
one). ``fleet`` is the one-command local shape: N in-process replicas of
the registry's promoted artifact, each scoring on the card, the router
in front, and the serving pointer followed with **rolling hot-reload**:
on every promotion the manager drains and swaps one replica at a time,
so the pointer move never drops a request. With ``--shadow-sample N``
the manager also follows the registry's shadow pointer, scores one live
request in N on a shadow replica of the candidate, and publishes the
paired evidence the controller's shadow gate rules on.

:func:`build_router` and :func:`build_fleet` assemble the objects the
flags describe without starting them; ``cmd_route`` and ``cmd_fleet``
run them until interrupted.
"""

from __future__ import annotations

import logging
import time
from typing import NamedTuple

from ..config import ExperimentConfig
from ..router import ScoringRouter, ServingFleet
from .common import _obs_setup, _resolve_with_pretrained

log = logging.getLogger(__name__)


def _parse_backends(specs) -> list[tuple[str, int]]:
    backends = []
    for spec in specs or ():
        host, sep, port = str(spec).rpartition(":")
        if not sep or not port.isdigit():
            raise SystemExit(
                f"--backend {spec!r}: want HOST:PORT (e.g. 127.0.0.1:12380)"
            )
        backends.append((host or "127.0.0.1", int(port)))
    if not backends:
        raise SystemExit(
            "route needs at least one --backend HOST:PORT (repeatable) — "
            "the infer-serve replicas to route across"
        )
    return backends


def _auth_key_or_exit(args) -> bytes | None:
    if not getattr(args, "auth", False):
        return None
    from .comm import _auth_key

    auth_key = _auth_key()
    if auth_key is None:
        raise SystemExit(
            "--auth needs the shared secret in the FEDTPU_SECRET env var "
            "(same value on the router, every replica, and every client)"
        )
    return auth_key


def _log_router_stats(tag: str, s: dict) -> None:
    ups = ", ".join(
        f"r{b['replica']}"
        f"{'' if b['healthy'] else ' DOWN'}"
        f"{' draining' if b['draining'] else ''}"
        f"(inflight {b['inflight']}, round {b['round']})"
        for b in s["backends"]
    )
    log.info(
        f"[{tag}] forwarded {s['forwarded']}, rejects {s['rejects_total']}, "
        f"{s['healthy']}/{len(s['backends'])} replicas up: {ups}"
    )


class RouterRun(NamedTuple):
    """What :func:`build_router` assembles: the router (bound, not
    started) and the /metrics endpoint it owns (or None)."""

    router: ScoringRouter
    metrics_server: object | None


def build_router(args) -> RouterRun:
    backends = _parse_backends(getattr(args, "backend", None))
    auth_key = _auth_key_or_exit(args)
    tracer, metrics_server = _obs_setup(args, proc="router", metrics_host=args.host)
    router = ScoringRouter(
        backends,
        host=args.host,
        port=args.port,
        auth_key=auth_key,
        probe_interval_s=args.probe_interval,
        probe_timeout_s=args.probe_timeout,
        max_inflight_per_replica=args.max_inflight,
        tracer=tracer,
        trace_sample=args.trace_sample if args.trace_sample is not None else 1.0,
    )
    return RouterRun(router, metrics_server)


def cmd_route(args) -> int:
    run = build_router(args)
    try:
        with run.router as router:
            log.info(
                f"[ROUTER] fronting {len(router.replicas)} replica(s) on "
                f"{args.host}:{router.port} (auth "
                f"{'on' if router.auth_key else 'off — open port'})"
            )
            try:
                while True:
                    time.sleep(30.0)
                    _log_router_stats("ROUTER", router.stats())
            except KeyboardInterrupt:
                log.info("[ROUTER] interrupted; draining")
    finally:
        if run.metrics_server is not None:
            run.metrics_server.close()
    return 0


class FleetRun(NamedTuple):
    """What :func:`build_fleet` assembles: the fleet (replicas started
    and warm, router and manager not yet), the /metrics endpoint it owns
    (or None) and the resolved config."""

    fleet: ServingFleet
    metrics_server: object | None
    cfg: ExperimentConfig


def build_fleet(args) -> FleetRun:
    from ..config import ModelConfig
    from ..data.datasets import get_dataset
    from ..models.convert import params_from_jax
    from ..registry import ModelRegistry
    from ..router import FleetReplica
    from .serving import _parse_buckets

    tok, cfg, _pretrained = _resolve_with_pretrained(args, load_weights=False)
    auth_key = _auth_key_or_exit(args)
    buckets = _parse_buckets(args.buckets)
    n = int(args.replicas) if args.replicas else cfg.router.replicas
    if n < 1:
        raise SystemExit(f"--replicas {n}: a fleet needs at least one")
    # Pointer-following only: a fleet exists to make PROMOTIONS
    # zero-downtime, and promotions are a registry concept.
    registry = ModelRegistry(args.registry_dir)
    info = registry.serving_info()
    if info is None:
        raise SystemExit(
            f"registry {args.registry_dir} has no serving artifact yet — "
            "run `controller` (or `registry promote`) to promote one first"
        )
    manifest = registry.manifest(info["artifact"])
    model_cfg = cfg.model
    if manifest.get("model_config"):
        model_cfg = ModelConfig(**manifest["model_config"])
    if model_cfg.vocab_size != len(tok.vocab):
        raise SystemExit(
            f"serving artifact's model vocab ({model_cfg.vocab_size}) != "
            f"tokenizer vocab ({len(tok.vocab)}); pass the matching "
            "--hf-dir / vocab"
        )
    params = params_from_jax(registry.load_params(info["artifact"]))
    round_id = int(manifest.get("round", 0))
    tracer, metrics_server = _obs_setup(args, proc="fleet", cfg=cfg, metrics_host=args.host)
    log.info(
        f"[FLEET] spawning {n} replica(s) of artifact {info['artifact']} "
        f"(round {round_id}) from registry {args.registry_dir} on {args.device}"
    )
    spec = get_dataset(cfg.data.dataset)

    def replica(i, r_params, r_round):
        return FleetReplica(
            i,
            model_cfg,
            r_params,
            tok,
            spec=spec,
            round_id=r_round,
            buckets=buckets,
            max_queue=args.max_queue,
            gather_window_s=args.max_wait_ms / 1e3,
            threshold=args.threshold,
            auth_key=auth_key,
            tracer=tracer,
            device=args.device,
        ).start()

    replicas = [replica(i, params, round_id) for i in range(n)]
    shadow_sample = args.shadow_sample if args.shadow_sample is not None else cfg.shadow.sample
    shadow_factory = None
    if shadow_sample >= 1:
        # The shadow replica: one more replica built like the serving
        # ones, spun up and down by the fleet manager as artifacts enter
        # and leave the shadow state, and never in the router's pick set.
        # Its id is one past the serving fleet's: a distinct stats identity.
        def shadow_factory(s_params, *, round_id):
            return replica(n, s_params, round_id)

        log.info(
            f"[FLEET] shadow plane enabled: mirroring 1/{shadow_sample} "
            "of live traffic onto shadow-state artifacts"
        )
    fleet = ServingFleet(
        replicas,
        registry=registry,
        auth_key=auth_key,
        router_host=args.host,
        router_port=args.port,
        probe_interval_s=cfg.router.probe_interval_s,
        probe_timeout_s=cfg.router.probe_timeout_s,
        drain_timeout_s=cfg.router.drain_timeout_s,
        reload_poll_s=args.reload_poll,
        max_inflight_per_replica=cfg.router.max_inflight_per_replica,
        tracer=tracer,
        shadow_factory=shadow_factory,
        shadow_sample=shadow_sample,
        shadow_threshold=cfg.shadow.threshold,
        shadow_bins=cfg.shadow.bins,
        shadow_queue=cfg.shadow.queue,
    )
    return FleetRun(fleet, metrics_server, cfg)


def cmd_fleet(args) -> int:
    run = build_fleet(args)
    try:
        with run.fleet as fleet:  # closes every replica too
            log.info(
                f"[FLEET] scoring {run.cfg.data.dataset} flows on "
                f"{args.host}:{fleet.port} ({len(fleet.replicas)} replicas, "
                f"rolling reload on promotion; auth "
                f"{'on' if fleet.auth_key else 'off'})"
            )
            try:
                while True:
                    time.sleep(30.0)
                    s = fleet.stats()
                    _log_router_stats("FLEET", s)
                    log.info(
                        f"[FLEET] serving {s['serving_artifact']} "
                        f"(rounds {s['replica_rounds']}, "
                        f"{s['reloads']} rolling reload(s))"
                    )
            except KeyboardInterrupt:
                log.info("[FLEET] interrupted; draining")
    finally:
        if run.metrics_server is not None:
            run.metrics_server.close()
    return 0
