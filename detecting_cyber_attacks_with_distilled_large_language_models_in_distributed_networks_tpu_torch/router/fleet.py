"""The replica fleet: N local scorers + router + rolling hot-reload (the
port's copy of the JAX package's ``router/fleet.py``; every replica's
engine scores on the card unless the caller asks for the CPU).

``fleet`` composes what already exists — :class:`~..serving.
server.ScoringServer` replicas (each with its own bucketed engine) and
the :class:`~.core.ScoringRouter` in front — and adds the one genuinely
new behavior: **rolling reload**. The single-replica tiers swap params
in place (atomic under the engine lock, fine for a same-architecture
swap); a fleet can do strictly better: take ONE replica out of the pick
set, wait out its in-flight requests, swap it, readmit it, move to the
next. During the whole sweep N-1 replicas keep serving, so a promotion
— however slow the params load — is a zero-drop event. A swap builds a
new model from the new weights and never writes into the tensors the
old one holds, so replicas that share storage stay correct mid-sweep.

The manager follows the registry's serving pointer exactly like
serving/reload.RegistryWatcher, with the fleet-shaped differences: ONE
poll for the whole fleet (N replicas polling independently would reload
in an uncoordinated burst, the opposite of rolling), the architecture
guard runs once against the shared engine config, and every completed
per-replica swap is recorded back into the registry's events trail
(:meth:`~..registry.store.ModelRegistry.record_reload`) — the audit
answer to "which replica is serving which artifact right now".

Each drain→swap→readmit cycle emits a ``replica-drain`` span (obs
vocabulary), so the obs timeline shows promotion cost per replica next
to round compute and the eval gate.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time

from ..models.convert import params_from_jax
from ..serving import MicroBatcher, ScoreEngine, ScoringServer
from .core import ScoringRouter

log = logging.getLogger(__name__)


class FleetReplica:
    """One in-process serving replica: engine + scoring server on its
    own loopback port. ``params`` is a port state dict; ``adopt()`` is
    the hot-swap target the rolling reload drives (same-architecture
    params only: the fleet manager guards architecture before the sweep
    starts). ``device``: where the engine scores (default the card).
    ``mesh``: a host mesh (parallel/mesh.py) makes this a sharded
    replica: params at rest split per leaf over the mesh's slots,
    gathered at use for each dispatch; ``adopt()`` re-places onto the
    same shape-determined layout."""

    def __init__(
        self,
        replica_id: int,
        model_cfg,
        params,
        tok,
        *,
        spec=None,
        round_id: int = 0,
        host: str = "127.0.0.1",
        buckets: tuple[int, ...] = (1, 8, 32),
        max_queue: int = 256,
        gather_window_s: float = 0.002,
        threshold: float = 0.5,
        auth_key: bytes | None = None,
        warmup: bool = True,
        idle_tick_s: float = 0.02,
        tracer=None,
        trace_sample: float = 1.0,
        device=None,
        mesh=None,
    ):
        self.replica_id = int(replica_id)
        self.engine = ScoreEngine(
            model_cfg,
            params,
            pad_id=tok.pad_id,
            buckets=buckets,
            round_id=round_id,
            device=device,
            mesh=mesh,
        )
        self.server = ScoringServer(
            self.engine,
            tok,
            host=host,
            port=0,
            spec=spec,
            threshold=threshold,
            batcher=MicroBatcher(
                max_batch=buckets[-1],
                max_queue=max(max_queue, buckets[-1]),
                gather_window_s=gather_window_s,
            ),
            auth_key=auth_key,
            warmup=warmup,
            idle_tick_s=idle_tick_s,
            tracer=tracer,
            trace_sample=trace_sample,
            replica_id=replica_id,
        )
        self.host = host

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def round_id(self) -> int:
        return self.engine.round_id

    def adopt(self, params, *, round_id: int) -> None:
        """Atomic same-architecture hot-swap (engine lock); ``params`` a
        port state dict."""
        self.engine.swap(params, round_id=round_id)

    def start(self) -> "FleetReplica":
        self.server.start()
        return self

    def close(self) -> None:
        self.server.close()


class ServingFleet:
    """Replicas + router + (optionally) the pointer-following rolling-
    reload manager.

    ``registry``: a :class:`~..registry.store.ModelRegistry` to follow —
    the manager thread polls its serving pointer every
    ``reload_poll_s`` and answers a pointer move with one rolling
    sweep. None = no manager; :meth:`rolling_reload` can still be driven
    directly (tests, manual ops).

    **Shadow plane** (shadow/): with ``shadow_factory`` set and
    ``shadow_sample >= 1``, the same manager poll also follows the
    registry's SHADOW pointer — an artifact promoted to the ``shadow``
    state gets its own replica (spun from ``shadow_factory``, NEVER in
    the router's pick set), the router's traffic mirror is armed at the
    configured stride, and the comparator publishes paired records +
    an atomic status file under ``<registry>/shadow/`` for the
    controller's disagreement gate. When the artifact leaves the shadow
    state (promoted or rejected) the mirror disarms and the shadow
    replica is torn down.
    """

    def __init__(
        self,
        replicas: list[FleetReplica],
        *,
        registry=None,
        auth_key: bytes | None = None,
        router_host: str = "127.0.0.1",
        router_port: int = 0,
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 5.0,
        drain_timeout_s: float = 30.0,
        reload_poll_s: float = 2.0,
        max_inflight_per_replica: int = 1024,
        tracer=None,
        trace_sample: float = 1.0,
        shadow_factory=None,
        shadow_sample: int = 0,
        shadow_threshold: float = 0.5,
        shadow_bins: int = 10,
        shadow_queue: int = 256,
    ):
        if not replicas:
            raise ValueError("fleet needs at least one replica")
        if shadow_sample < 0:
            raise ValueError(
                f"shadow_sample={shadow_sample} must be >= 0 (0 = off)"
            )
        self.replicas = replicas
        self.registry = registry
        self.drain_timeout_s = float(drain_timeout_s)
        self.reload_poll_s = float(reload_poll_s)
        self.tracer = tracer
        self.auth_key = auth_key
        # Shadow plane state (all guarded by _lock; the manager thread
        # owns the lifecycle, stats() reads).
        self.shadow_factory = shadow_factory
        self.shadow_sample = int(shadow_sample)
        self.shadow_threshold = float(shadow_threshold)
        self.shadow_bins = int(shadow_bins)
        self.shadow_queue = int(shadow_queue)
        self._shadow_aid: str | None = None
        self._shadow_replica = None
        self._shadow_mirror = None
        self._shadow_compare = None
        self._shadow_warned: str | None = None
        # Spin-up failure backoff: a corrupt artifact or failing factory
        # must not cost a full params load + engine build every poll.
        self._shadow_retry_at = 0.0
        self.router = ScoringRouter(
            [(r.host, r.port) for r in replicas],
            host=router_host,
            port=router_port,
            auth_key=auth_key,
            probe_interval_s=probe_interval_s,
            probe_timeout_s=probe_timeout_s,
            max_inflight_per_replica=max_inflight_per_replica,
            tracer=tracer,
            trace_sample=trace_sample,
        )
        self.port = self.router.port
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._manager: threading.Thread | None = None
        self._seen: str | None = None
        self._warned: str | None = None
        self.reloads = 0  # completed rolling sweeps
        self.serving_artifact: str | None = None

    # --------------------------------------------------------------- control
    def start(self) -> "ServingFleet":
        self.router.start()
        if self.registry is not None:
            info = self.registry.serving_info()
            # Prime on the artifact the replicas were BUILT from (the
            # caller restored the current pointer); a promotion that
            # lands between restore and here is caught by the first poll.
            with self._lock:
                self._seen = info["artifact"] if info else None
                self.serving_artifact = self._seen
            self._manager = threading.Thread(
                target=self._manager_loop,
                name="fedtpu-fleet-manager",
                daemon=True,
            )
            self._manager.start()
        log.info(
            f"[FLEET] {len(self.replicas)} replica(s) behind router port "
            f"{self.port}"
            + (
                f", following registry pointer ({self._seen})"
                if self.registry is not None
                else ""
            )
        )
        return self

    def close(self) -> None:
        self._closed.set()
        if self._manager is not None:
            self._manager.join(timeout=10.0)
        self._teardown_shadow()
        self.router.close()
        for rep in self.replicas:
            rep.close()

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            reloads = self.reloads
            artifact = self.serving_artifact
            shadow_aid = self._shadow_aid
            mirror = self._shadow_mirror
        return {
            **self.router.stats(),
            "reloads": reloads,
            "serving_artifact": artifact,
            "replica_rounds": [r.round_id for r in self.replicas],
            "shadow_artifact": shadow_aid,
            "shadow_mirror": mirror.stats() if mirror is not None else None,
        }

    # ------------------------------------------------------- rolling reload
    def rolling_reload(
        self, params, *, round_id: int, artifact: str | None = None
    ) -> dict:
        """Drain → swap → readmit, one replica at a time. Never drains
        the only pick-set member to zero on a single-replica fleet (the
        swap is atomic anyway — draining the whole pick set would CAUSE
        the drops rolling reload exists to prevent). ``params``: a port
        state dict. Returns per-replica timings for the caller's logs."""
        sweep: list[dict] = []
        solo = len(self.replicas) == 1
        for rep in self.replicas:
            t_unix = time.time()
            t0 = time.monotonic()
            drained = True
            if not solo:
                self.router.drain(rep.replica_id)
                drained = self.router.wait_drained(
                    rep.replica_id, timeout=self.drain_timeout_s
                )
                if not drained:
                    log.warning(
                        f"[FLEET] replica {rep.replica_id} did not drain "
                        f"within {self.drain_timeout_s}s; swapping anyway "
                        "(in-flight batches finish on the old weights)"
                    )
            rep.adopt(params, round_id=round_id)
            if not solo:
                self.router.undrain(rep.replica_id)
            dur = time.monotonic() - t0
            sweep.append(
                {
                    "replica": rep.replica_id,
                    "drained": drained,
                    "swap_s": dur,
                }
            )
            if self.tracer is not None:
                self.tracer.record(
                    "replica-drain",
                    t_start=t_unix,
                    dur_s=dur,
                    round=round_id,
                    replica=rep.replica_id,
                    artifact=artifact,
                    drained=drained,
                )
            if self.registry is not None and artifact is not None:
                self.registry.record_reload(
                    artifact, consumer=f"replica-{rep.replica_id}"
                )
            log.info(
                f"[FLEET] replica {rep.replica_id} -> round {round_id}"
                + (f" ({artifact})" if artifact else "")
                + f" in {dur:.3f}s (drained={drained})"
            )
        with self._lock:
            self.reloads += 1
            self.serving_artifact = artifact
        return {"replicas": sweep, "round": round_id, "artifact": artifact}

    # ----------------------------------------------------- the shadow plane
    def shadow_enabled(self) -> bool:
        return self.shadow_factory is not None and self.shadow_sample >= 1

    def _teardown_shadow(self) -> None:
        """Disarm the mirror FIRST (the router's forward path must stop
        touching it before it dies), publish the final status, then
        close the shadow replica."""
        with self._lock:
            aid = self._shadow_aid
            mirror, self._shadow_mirror = self._shadow_mirror, None
            compare, self._shadow_compare = self._shadow_compare, None
            replica, self._shadow_replica = self._shadow_replica, None
            self._shadow_aid = None
        if aid is None:
            return
        self.router.set_mirror(None)
        if mirror is not None:
            mirror.close()
        if compare is not None:
            compare.write_status()
        if replica is not None:
            try:
                replica.close()
            except Exception as e:
                log.warning(
                    f"[FLEET] shadow replica close failed (non-fatal): {e}"
                )
        log.info(f"[FLEET] shadow plane for {aid} torn down")

    def _poll_shadow(self) -> None:
        """One manager pass over the registry's SHADOW pointer: arm the
        plane when an artifact enters the shadow state, tear it down
        when it leaves. Any failure degrades to no-shadow — the live
        fleet must never die for its shadow."""
        if not self.shadow_enabled():
            return
        from ..shadow import ShadowCompare, ShadowMirror, pairs_path, status_path

        try:
            info = self.registry.shadow_info()
        except Exception as e:
            log.warning(f"[FLEET] shadow pointer read failed: {e}")
            return
        aid = info.get("artifact") if info else None
        with self._lock:
            cur = self._shadow_aid
        if aid == cur:
            return
        if cur is not None:
            self._teardown_shadow()
        if aid is None:
            return
        if (
            self._shadow_warned == aid
            and time.monotonic() < self._shadow_retry_at
        ):
            return  # recent spin-up failure for this artifact: back off
        engine = self.replicas[0].engine
        try:
            manifest = self.registry.manifest(aid)
            mc = manifest.get("model_config")
            if mc is not None and mc != dataclasses.asdict(engine.model_cfg):
                if self._shadow_warned != aid:
                    with self._lock:
                        self._shadow_warned = aid
                    log.warning(
                        f"[FLEET] shadow artifact {aid} declares a "
                        "different architecture than the fleet's engines; "
                        "not mirroring (the gate will fail closed)"
                    )
                return
            params = params_from_jax(self.registry.load_params(aid))
            replica = self.shadow_factory(
                params, round_id=int(manifest.get("round", 0))
            )
        except Exception as e:
            with self._lock:
                self._shadow_warned = aid
            self._shadow_retry_at = time.monotonic() + max(
                5.0, 10.0 * self.reload_poll_s
            )
            log.warning(
                f"[FLEET] shadow replica spin-up for {aid} failed "
                f"({type(e).__name__}: {e}); not mirroring (retrying "
                "with backoff while the shadow pointer names it)"
            )
            return
        root = self.registry.root
        # Fresh evidence per evaluation: a PREVIOUS shadow run of this
        # same artifact (a gate rejection later re-promoted, a crashed
        # gate) left its status/pairs files behind, and the gate would
        # rule on that stale evidence within one poll — the registry
        # events keep the historical verdicts, the files do not need to.
        # The pairs JSONL is TRUNCATED, not removed: the obs append path
        # caches one O_APPEND fd per path, and unlinking would strand a
        # previous in-process comparator's cached fd on a dead inode.
        try:
            os.remove(status_path(root, aid))
        except OSError:
            pass
        try:
            os.truncate(pairs_path(root, aid), 0)
        except OSError:
            pass
        compare = ShadowCompare(
            threshold=self.shadow_threshold,
            bins=self.shadow_bins,
            pairs_jsonl=pairs_path(root, aid),
            status_path=status_path(root, aid),
            # Publish every 8th pair, not every pair: the status rewrite
            # (snapshot + tmp + os.replace) per pair would make the
            # compare thread the bottleneck at exactly the mirror rates
            # the plane exists to measure; the gate's min_pairs is
            # always a multiple of this granularity in practice.
            status_every=8,
            tracer=self.tracer,
        )
        mirror = ShadowMirror(
            replica.host,
            replica.port,
            sample=self.shadow_sample,
            compare=compare,
            auth_key=self.auth_key,
            max_queue=self.shadow_queue,
            tracer=self.tracer,
        ).start()
        with self._lock:
            self._shadow_aid = aid
            self._shadow_replica = replica
            self._shadow_mirror = mirror
            self._shadow_compare = compare
            self._shadow_warned = None
        self.router.set_mirror(mirror)
        log.info(
            f"[FLEET] shadow plane armed for {aid}: replica on "
            f"{replica.host}:{replica.port}, mirroring "
            f"1/{self.shadow_sample} of live requests"
        )

    # ---------------------------------------------------------- the manager
    def _manager_loop(self) -> None:
        while not self._closed.wait(self.reload_poll_s):
            try:
                self._poll_shadow()
            except Exception as e:
                log.warning(
                    f"[FLEET] shadow poll failed (non-fatal): {e}"
                )
            try:
                info = self.registry.serving_info()
            except Exception as e:
                log.warning(f"[FLEET] registry pointer read failed: {e}")
                continue
            with self._lock:
                seen, warned = self._seen, self._warned
            if info is None or info.get("artifact") == seen:
                continue
            aid = info["artifact"]
            engine = self.replicas[0].engine
            try:
                manifest = self.registry.manifest(aid)
                mc = manifest.get("model_config")
                if mc is not None and mc != dataclasses.asdict(
                    engine.model_cfg
                ):
                    # Not marked seen: a rollback to a compatible
                    # artifact must still be adopted (RegistryWatcher's
                    # contract, fleet-wide).
                    if warned != aid:
                        with self._lock:
                            self._warned = aid
                        log.warning(
                            f"[FLEET] serving artifact {aid} declares a "
                            "different architecture than the fleet's "
                            "engines; skipping rolling reload (restart "
                            "the fleet to change shapes)"
                        )
                    continue
                params = params_from_jax(self.registry.load_params(aid))
            except Exception as e:
                log.warning(
                    f"[FLEET] reload of serving artifact {aid} failed "
                    f"({type(e).__name__}: {e}); keeping the serving "
                    "weights"
                )
                continue
            self.rolling_reload(
                params,
                round_id=int(manifest.get("round", 0)),
                artifact=aid,
            )
            with self._lock:
                self._seen = aid
                self._warned = None
