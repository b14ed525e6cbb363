"""``scenario``: a persona x partition matrix over LIVE loopback rounds (the
port's copy of the JAX package's ``faults/scenario.py``; every cell's
server folds on ``ScenarioConfig.device``, with K4 on the card).

Each cell of the matrix is a real federated campaign — an
``AggregationServer`` plus ``FederatedClient`` threads on loopback,
personas driving wire faults through :class:`~.proxy.FaultProxy` and
client-side misbehavior (lazy steps, skipped rounds) — never a mock.
Outcomes come from the obs timeline (every process traces to its own
events-JSONL; the merged (trace, round) groups give contributor sets,
drop attribution, and straggler wait), and every successful round's
aggregate is pinned BIT-EXACT against the clean barrier mean over the
same survivor set (``aggregate_flat`` over the captured survivor uploads
with the same weights).

Two payload modes:

* synthetic (default) — deterministic model-shaped fp32 trees per
  (client, round); fast enough for the CPU tests.
  Partition still matters: the server runs weighted FedAvg and
  each client's weight is its shard size, so quantity/label skew
  changes the mean.
* ``train=True`` — a tiny real model trains on the partitioned
  synthetic shards each round (serialized under a lock: one
  trainer serves every client) and the final aggregate's held-out accuracy lands in the
  grid — the per-cell accuracy column. The model is
  ``ModelConfig.tiny()`` with its default attention, as in the JAX
  package.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
import numpy as np

import logging
import zlib

from ..comm import wire
from ..comm.client import FederatedClient
from ..comm.relay import RelayAggregator, aggregate_tree
from ..comm.secure import SecureAggError
from ..comm.server import AggregationServer, aggregate_flat
from ..config import DataConfig, ModelConfig, TrainConfig
from ..data.partition import partition_indices, partition_manifest
from ..data.pipeline import TokenizedSplit
from ..obs import metrics as obs_metrics
from ..obs.timeline import load_spans, round_summaries
from ..obs.trace import Tracer, wall_clock
from ..strategies import make_strategy, parse_strategy
from .deadrelay import DeadRelayFault, wait_registered
from .personas import Persona, get_persona, start_persona_proxy

log = logging.getLogger(__name__)

#: Shared-secret for the matrix's auth cell (loopback test traffic; the
#: point is exercising the HMAC challenge path, not secrecy).
AUTH_KEY = b"fedtpu-scenario-auth"

#: Matrix partition labels -> DataConfig scheme.
PARTITION_LABELS = {
    "iid": "disjoint",
    "dirichlet": "dirichlet",
    "quantity": "quantity",
}


@dataclass(frozen=True)
class ScenarioConfig:
    num_clients: int = 3
    rounds: int = 2
    personas: tuple[str, ...] = ("lazy", "slow", "intermittent")
    partitions: tuple[str, ...] = ("iid", "dirichlet")
    dirichlet_alpha: float = 0.1
    seed: int = 0
    #: Per-client synthetic payload (model stand-in) size.
    payload_kb: int = 64
    #: Synthetic label-source rows the partitioners shard.
    data_rows: int = 480
    #: Per-round straggler deadline (the slow persona's upload must fit).
    deadline_s: float = 8.0
    #: Streamed-upload advert (0 = dense frames only).
    stream_chunk_bytes: int = 1 << 15
    #: Append one extra cell running the first persona under HMAC auth.
    auth_cell: bool = True
    #: Append the dead-relay cell: a depth-2 fold tree (two relays, one
    #: weighted root) with a seeded mid-round relay kill
    #: (faults/deadrelay.py) — the victim's clients re-home to the
    #: surviving relay and the root completes a degraded round,
    #: crc-pinned against the actual-contributor replay.
    dead_relay_cell: bool = False
    #: Train a tiny real model per client (accuracy column) instead of
    #: synthetic payloads.
    train: bool = False
    #: Server strategy specs (strategies/, ``NAME[:k=v,...]``) to APPEND
    #: as extra cells: every persona x partition pair re-runs under each
    #: non-fedavg spec, with the base cells as the fedavg baseline. The
    #: default () adds nothing — the matrix shape (and the fast lane's
    #: cell-count pin) is unchanged unless strategies are asked for.
    strategies: tuple[str, ...] = ()
    #: Where every cell's servers fold and a train cell's clients train:
    #: the card unless "cpu" is given.
    device: str | None = None


@dataclass(frozen=True)
class CellSpec:
    name: str
    personas: tuple[str, ...]  # one per client
    partition: str  # "iid" | "dirichlet" | "quantity"
    auth: bool = False
    stream: bool = True
    #: Server aggregation strategy spec for this cell's root
    #: (strategies/); "fedavg" is the identity baseline.
    strategy: str = "fedavg"


@dataclass
class RoundOutcome:
    round: int
    ok: bool
    error: str | None = None
    contributors: list[int] = field(default_factory=list)
    #: Clients that never made it into the aggregate this round.
    dropped: list[int] = field(default_factory=list)
    straggler_wait_s: float = 0.0
    round_wall_s: float | None = None
    live_crc: int | None = None
    clean_crc: int | None = None
    bitexact: bool | None = None


@dataclass
class CellResult:
    spec: CellSpec
    manifest: dict
    rounds: list[RoundOutcome] = field(default_factory=list)
    stream_uploads: int = 0
    accuracy: float | None = None
    quorum: int = 0
    notes: list[str] = field(default_factory=list)

    @property
    def ok_rounds(self) -> int:
        return sum(1 for r in self.rounds if r.ok)

    @property
    def exact_rounds(self) -> int:
        return sum(1 for r in self.rounds if r.bitexact)


def build_matrix(cfg: ScenarioConfig) -> list[CellSpec]:
    """Persona x partition matrix: each cell puts ONE persona on client
    0 with an honest remainder (a quorum of honest clients is the
    contract's precondition), plus the auth cell."""
    cells = []
    for p in cfg.personas:
        for part in cfg.partitions:
            if part not in PARTITION_LABELS:
                raise ValueError(
                    f"unknown partition label {part!r} "
                    f"({'|'.join(PARTITION_LABELS)})"
                )
            cells.append(
                CellSpec(
                    name=f"{p}|{part}",
                    personas=(p,)
                    + ("honest",) * (cfg.num_clients - 1),
                    partition=part,
                )
            )
    if cfg.auth_cell and cfg.personas:
        p = cfg.personas[0]
        cells.append(
            CellSpec(
                name=f"{p}|{cfg.partitions[0]}|auth",
                personas=(p,) + ("honest",) * (cfg.num_clients - 1),
                partition=cfg.partitions[0],
                auth=True,
            )
        )
    # Strategy comparison cells: every persona x partition pair re-runs
    # under each requested non-fedavg strategy. The base cells above ARE
    # the fedavg arm (identity strategy), so a "fedavg" spec is skipped
    # rather than duplicated — the comparator reads base vs strategy
    # cells for the same (persona, partition) key.
    for spec_str in cfg.strategies:
        s_name, _ = parse_strategy(spec_str)  # validates early
        if s_name == "fedavg":
            continue
        for p in cfg.personas:
            for part in cfg.partitions:
                cells.append(
                    CellSpec(
                        name=f"{p}|{part}|{spec_str}",
                        personas=(p,)
                        + ("honest",) * (cfg.num_clients - 1),
                        partition=part,
                        strategy=spec_str,
                    )
                )
    return cells


# ------------------------------------------------------------ payloads
def _take(split: TokenizedSplit, idx: np.ndarray) -> TokenizedSplit:
    return TokenizedSplit(split.input_ids[idx], split.attention_mask[idx], split.labels[idx])


def _partition_config(cfg: ScenarioConfig, spec: CellSpec) -> DataConfig:
    return DataConfig(
        partition=PARTITION_LABELS[spec.partition],
        data_fraction=1.0 / cfg.num_clients,
        dirichlet_alpha=cfg.dirichlet_alpha,
        seed_base=cfg.seed,
    )


def _cell_partition(
    cfg: ScenarioConfig, spec: CellSpec
) -> tuple[list[np.ndarray], np.ndarray, dict]:
    """(per-client row indices, source labels, manifest) for one cell."""
    rng = np.random.default_rng(cfg.seed)
    labels = (rng.random(cfg.data_rows) < 0.4).astype(np.int64)
    dcfg = _partition_config(cfg, spec)
    parts = partition_indices(labels, cfg.num_clients, dcfg)
    manifest = partition_manifest(
        [labels[idx] for idx in parts], cfg=dcfg, total_rows=len(labels)
    )
    return parts, labels, manifest


def _synthetic_upload(
    cfg: ScenarioConfig, spec: CellSpec, persona: Persona, cid: int, r: int
) -> dict[str, np.ndarray]:
    """Deterministic model-shaped payload for (cell, client, round):
    a pure function, so the clean-run reference regenerates survivor
    uploads exactly. The persona's ``train_scale`` scales the values
    (a lazy client's smaller local step) and the cell's partition seeds
    differ, so no two cells aggregate identical trees."""
    elems = max(64, int(cfg.payload_kb) * 1024 // 4 // 4)
    # crc32, not hash(): str hashing is randomized per process, and the
    # payloads must replay identically across runs (and in the clean-run
    # reference) for a given seed.
    rng = np.random.default_rng(
        [cfg.seed, zlib.crc32(spec.partition.encode()), cid, r]
    )
    scale = np.float32(persona.train_scale)
    return {
        f"w{j}": (rng.standard_normal(elems, dtype=np.float32) * scale)
        for j in range(4)
    }


# ------------------------------------------------------------ cell run
def run_cell(
    spec: CellSpec, cfg: ScenarioConfig, out_dir: str
) -> CellResult:
    """One live loopback campaign for one matrix cell."""
    workdir = os.path.join(out_dir, "cells", spec.name.replace("|", "_"))
    trace_dir = os.path.join(workdir, "traces")
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(trace_dir, exist_ok=True)
    personas = [get_persona(n) for n in spec.personas]
    parts, labels, manifest = _cell_partition(cfg, spec)
    n_samples = [max(1, len(p)) for p in parts]
    quorum = max(1, sum(1 for p in personas if p.name == "honest"))
    auth_key = AUTH_KEY if spec.auth else None
    rounds = cfg.rounds
    result = CellResult(spec=spec, manifest=manifest, quorum=quorum)

    # Captured uploads: (cid, round) -> (flat fp32 tree, n_samples) —
    # the clean-run A/B's input. Synthetic payloads are regenerable;
    # trained ones are captured at upload time.
    captured: dict[tuple[int, int], tuple[dict, float]] = {}
    aggs: list[dict | None] = [None] * rounds
    round_errors: list[str | None] = [None] * rounds
    round_done = [threading.Event() for _ in range(rounds)]
    client_errors: dict[tuple[int, int], str] = {}

    # The cell's strategy, twice over: the SERVER instance transforms
    # the live fold at finalize; the REPLAY instance is fed the clean
    # barrier means in round order, so the crc pin extends to any
    # strategy — both sides run the identical pure (prev, mean)
    # transform, and client stats stay telemetry-only by contract.
    replay_strategy = make_strategy(spec.strategy)
    client_mu = replay_strategy.client_mu()

    trainer = None
    shards = eval_split = None
    train_lock = threading.Lock()
    # Train mode arming barriers: local training (first-step
    # dispatch included) can outlast a round deadline, so the server must not
    # START round r until every non-skipping client is about to
    # exchange — otherwise the serve loop burns its rounds against an
    # empty wire. One barrier per round: the server + that round's
    # exchangers.
    arm_barriers: list[threading.Barrier] | None = None
    if cfg.train:
        trainer, shards, eval_split = _build_training(
            cfg, parts, labels, prox_mu=client_mu
        )
        arm_barriers = [
            threading.Barrier(
                1 + sum(
                    1 for p in personas if not p.skips_round(r)
                )
            )
            for r in range(rounds)
        ]

    with AggregationServer(
        port=0,
        num_clients=cfg.num_clients,
        min_clients=quorum,
        weighted=True,
        timeout=max(30.0, cfg.deadline_s * 3),
        auth_key=auth_key,
        stream_chunk_bytes=cfg.stream_chunk_bytes if spec.stream else 0,
        strategy=spec.strategy,
        device=cfg.device,
        tracer=Tracer(
            os.path.join(trace_dir, "server.jsonl"), proc="server"
        ),
    ) as server:

        def serve_loop() -> None:
            for r in range(rounds):
                if arm_barriers is not None:
                    try:
                        arm_barriers[r].wait(timeout=300.0)
                    except threading.BrokenBarrierError:
                        pass  # a dead client thread; run the round anyway
                try:
                    aggs[r] = server.serve_round(deadline=cfg.deadline_s)
                except RuntimeError as e:
                    round_errors[r] = str(e)
                finally:
                    round_done[r].set()

        def client_loop(cid: int) -> None:
            persona = personas[cid]
            proxy = start_persona_proxy(
                persona,
                "127.0.0.1",
                server.port,
                fault_seed=cfg.seed,
                client_id=cid,
            )
            host, port = (
                (proxy.host, proxy.port)
                if proxy is not None
                else ("127.0.0.1", server.port)
            )
            try:
                fc = FederatedClient(
                    host,
                    port,
                    client_id=cid,
                    timeout=max(15.0, cfg.deadline_s * 2),
                    auth_key=auth_key,
                    tracer=Tracer(
                        os.path.join(trace_dir, f"client-{cid}.jsonl"),
                        proc=f"client-{cid}",
                    ),
                )
                state = None
                if trainer is not None:
                    # Under the lock: one trainer (and its dropout
                    # generator) serves every client thread.
                    with train_lock:
                        state = trainer.init_state(seed=cfg.seed)
                for r in range(rounds):
                    if persona.skips_round(r):
                        # Sitting the round out: wait until the server
                        # moved on so the NEXT upload cannot land in the
                        # skipped round's window.
                        round_done[r].wait(
                            timeout=cfg.deadline_s * 3
                        )
                        continue
                    if trainer is not None:
                        # The client-local span's start (timing only).
                        t0 = wall_clock()
                        tm0 = time.monotonic()
                        with train_lock:
                            shard = shards[cid]
                            sub = _take(
                                shard,
                                np.arange(persona.scaled(len(shard))),
                            )
                            state, _ = trainer.fit(
                                state, sub, batch_size=8, epochs=1,
                                epoch_offset=r,
                                tag=f"[scenario c{cid}] ",
                            )
                            upload = trainer.host_params(state)
                        fc.note_local_phase(
                            t0, time.monotonic() - tm0, client=cid
                        )
                        weight = float(len(sub))
                    else:
                        upload = _synthetic_upload(
                            cfg, spec, persona, cid, r
                        )
                        weight = float(n_samples[cid])
                    captured[(cid, r)] = (
                        {
                            k: np.asarray(v, np.float32)
                            for k, v in wire.flatten_params(
                                upload
                            ).items()
                        },
                        weight,
                    )
                    if arm_barriers is not None:
                        try:
                            arm_barriers[r].wait(timeout=300.0)
                        except threading.BrokenBarrierError:
                            pass
                    try:
                        agg = fc.exchange(
                            upload, n_samples=int(weight), max_retries=4
                        )
                    except (
                        ConnectionError,
                        OSError,
                        SecureAggError,
                        wire.WireError,
                    ) as e:
                        client_errors[(cid, r)] = str(e)
                        # Dropped this round; realign on the next one.
                        round_done[r].wait(timeout=cfg.deadline_s * 3)
                        continue
                    if trainer is not None:
                        with train_lock:
                            state = trainer.adopt_aggregate(state, agg)
            except Exception as e:  # last resort: a silently dead
                # client thread reads as "never arrived" in the grid,
                # hiding the harness's own bug — record it instead.
                client_errors[(cid, -1)] = f"{type(e).__name__}: {e}"
                log.warning(
                    f"[SCENARIO] client {cid} thread died: "
                    f"{type(e).__name__}: {e}"
                )
            finally:
                if proxy is not None:
                    proxy.close()

        st = threading.Thread(target=serve_loop, daemon=True)
        ct = [
            threading.Thread(target=client_loop, args=(c,), daemon=True)
            for c in range(cfg.num_clients)
        ]
        st.start()
        for t in ct:
            t.start()
        st.join(timeout=rounds * (cfg.deadline_s * 3 + 10))
        for t in ct:
            t.join(timeout=cfg.deadline_s * 3 + 10)
        result.stream_uploads = int(
            server.stream_totals["stream_uploads"]
        )

    # ------------------------------------------------ outcomes (obs)
    spans = load_spans(trace_dir=trace_dir)
    by_round = {
        b["round"]: b for b in round_summaries(spans) if b["round"] is not None
    }
    # The replay chain's previous-global: the live server transformed
    # each successful round's mean against ITS previous post-strategy
    # global, so the replay feeds refs forward the same way (FedAvg is
    # the identity and chains trivially). A round without a clean
    # reference resyncs the chain from the live aggregate — the later
    # rounds' pins stay meaningful instead of inheriting the gap.
    replay_strategy.reset()
    replay_prev: dict | None = None
    for r in range(rounds):
        b = by_round.get(r, {})
        contributors = list(b.get("contributors") or [])
        waits = [
            row.get("wait_s", 0.0)
            for row in (b.get("clients") or {}).values()
        ]
        out = RoundOutcome(
            round=r,
            ok=aggs[r] is not None,
            error=round_errors[r],
            contributors=contributors,
            dropped=sorted(
                set(range(cfg.num_clients)) - set(contributors)
            )
            if contributors or aggs[r] is not None
            else [],
            straggler_wait_s=round(max(waits, default=0.0), 4),
            round_wall_s=b.get("round_wall_s"),
        )
        if aggs[r] is not None:
            live = {
                k: np.asarray(v, np.float32) for k, v in aggs[r].items()
            }
            out.live_crc = wire.flat_crc32(live)
            missing = [c for c in contributors if (c, r) not in captured]
            if contributors and not missing:
                ref = aggregate_flat(
                    [captured[(c, r)][0] for c in contributors],
                    [captured[(c, r)][1] for c in contributors],
                )
                # Replay the strategy transform over the clean barrier
                # mean — fedavg returns it unchanged, so base cells pin
                # exactly what they always pinned.
                ref = replay_strategy.apply(replay_prev, ref, round_no=r)
                replay_prev = ref
                out.clean_crc = wire.flat_crc32(ref)
                out.bitexact = out.clean_crc == out.live_crc
            else:
                replay_prev = live  # resync the chain for later rounds
                result.notes.append(
                    f"round {r}: no clean reference "
                    f"(contributors {contributors}, missing {missing})"
                )
        result.rounds.append(out)
    if cfg.train and trainer is not None:
        final = next(
            (aggs[r] for r in reversed(range(rounds)) if aggs[r]), None
        )
        if final is not None:
            m = trainer.evaluate(
                wire.unflatten_params(
                    {k: np.asarray(v) for k, v in final.items()}
                ),
                eval_split,
                batch_size=8,
            )
            result.accuracy = round(float(m["Accuracy"]), 4)
            # Comparator surface: the final aggregate's held-out
            # accuracy, labeled by cell and strategy — what the
            # strategy sweep scrapes to pin the non-IID lift over the
            # fedavg baseline cells.
            # fedtpu: allow(obs-metric-once): the JAX package's faults/scenario.py family, same name/kind/labels/help
            obs_metrics.default_registry().gauge(
                "fedtpu_round_accuracy",
                help="final-aggregate held-out accuracy per scenario "
                "cell, by server strategy",
                labels={
                    "cell": spec.name,
                    "strategy": replay_strategy.name,
                },
            ).set(result.accuracy)
    for (cid, r), err in sorted(client_errors.items()):
        result.notes.append(f"client {cid} round {r}: {err[:160]}")
    return result


def _build_training(
    cfg: ScenarioConfig, parts, labels, prox_mu: float = 0.0
):
    """Tiny-model training assets for ``train=True`` cells: per-client
    tokenized shards over the partitioned rows + a shared held-out eval
    split (the accuracy column's denominator). ``prox_mu`` > 0 makes
    every client run the FedProx local step (train/engine.py) against
    each round's adopted aggregate — the client half of a fedprox
    cell."""
    from ..train.engine import Trainer

    model = ModelConfig.tiny()
    trainer = Trainer(
        model, TrainConfig(learning_rate=1e-3, epochs_per_round=1,
                           seed=cfg.seed, log_every=0,
                           prox_mu=float(prox_mu)),
        device=cfg.device,
    )
    rng = np.random.default_rng(cfg.seed + 1)
    L = model.max_len

    def _rows(n, lab):
        ids = rng.integers(0, model.vocab_size, (n, L)).astype(np.int32)
        # Label-correlated token bias so accuracy is learnable.
        ids[lab == 1, : L // 4] = 7
        return ids

    def _split(idx):
        idx = np.asarray(idx, int)
        if len(idx) == 0:
            idx = np.arange(8)
        lab = labels[idx].astype(np.int32)
        return TokenizedSplit(
            _rows(len(idx), lab), np.ones((len(idx), L), np.int32), lab
        )

    shards = [_split(p) for p in parts]
    ev = rng.integers(0, len(labels), 64)
    eval_split = _split(ev)
    # Warm up front (train + eval step): the first dispatch
    # costs seconds, and paying it inside a round would eat the round
    # deadline for every cell's first client.
    warm = trainer.init_state(seed=cfg.seed)
    warm, _ = trainer.fit(
        warm, _split(np.arange(8)), batch_size=8, epochs=1,
        tag="[scenario warmup] ",
    )
    trainer.evaluate(
        trainer.host_params(warm), eval_split, batch_size=8
    )
    return trainer, shards, eval_split


# ------------------------------------------------------ dead-relay cell
def run_dead_relay_cell(
    cfg: ScenarioConfig, out_dir: str
) -> CellResult:
    """One live depth-2 fold-tree campaign with a seeded mid-round relay
    kill (faults/deadrelay.py): the victim relay's clients dial through
    the fault's throttling proxy, the kill lands while their uploads are
    in flight, they re-home to the surviving relay (ranked fallback
    parents), and the weighted root completes a DEGRADED round over the
    surviving subtree within its deadline. The outcome is attributed on
    the obs timeline (the re-home is a second ``wire-upload`` span on
    the re-homed client's trace) and the aggregate is crc-pinned
    bit-exact against :func:`~..comm.relay.aggregate_tree` replayed over
    the round's ACTUAL recorded (relay -> contributors) assignment."""
    spec = CellSpec(
        name=f"dead-relay|{cfg.partitions[0]}",
        personas=("honest",) * cfg.num_clients,
        partition=cfg.partitions[0],
    )
    workdir = os.path.join(out_dir, "cells", spec.name.replace("|", "_"))
    trace_dir = os.path.join(workdir, "traces")
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(trace_dir, exist_ok=True)
    parts, labels, manifest = _cell_partition(cfg, spec)
    n_samples = [max(1, len(p)) for p in parts]
    result = CellResult(spec=spec, manifest=manifest, quorum=1)
    n = cfg.num_clients
    half = max(1, n // 2)  # clients [0, half) on the surviving relay
    victims = list(range(half, n))
    persona = get_persona("honest")
    uploads = {
        cid: _synthetic_upload(cfg, spec, persona, cid, 0)
        for cid in range(n)
    }
    timeout = max(30.0, cfg.deadline_s * 3)
    results: dict[int, dict] = {}
    errors: dict[int, str] = {}
    root_agg: list = [None]
    root_err: list = [None]
    with AggregationServer(
        port=0, num_clients=2, min_clients=1, weighted=True,
        timeout=timeout, stream_chunk_bytes=cfg.stream_chunk_bytes,
        device=cfg.device,
        tracer=Tracer(os.path.join(trace_dir, "root.jsonl"), proc="root"),
    ) as root:
        relays = [
            RelayAggregator(
                "127.0.0.1", 0, parent_host="127.0.0.1",
                parent_port=root.port, relay_id=r,
                num_clients=(half if r == 0 else n - half),
                timeout=timeout,
                stream_chunk_bytes=cfg.stream_chunk_bytes,
                device=cfg.device,
            )
            for r in range(2)
        ]
        fault = DeadRelayFault(relays[1], seed=cfg.seed)
        try:
            def root_loop() -> None:
                try:
                    root_agg[0] = root.serve_round(
                        deadline=cfg.deadline_s * 2
                    )
                except RuntimeError as e:
                    root_err[0] = str(e)

            rt = threading.Thread(target=root_loop, daemon=True)
            rt.start()
            for rel in relays:
                threading.Thread(
                    target=rel.serve, args=(1,), daemon=True
                ).start()

            def client_loop(cid: int) -> None:
                victim = cid in victims
                fc = FederatedClient(
                    fault.host if victim else "127.0.0.1",
                    fault.port if victim else relays[0].port,
                    client_id=cid,
                    timeout=timeout,
                    fallback_parents=(
                        [("127.0.0.1", relays[0].port)] if victim else None
                    ),
                    rehome_dial_budget=2.0,
                    tracer=Tracer(
                        os.path.join(trace_dir, f"client-{cid}.jsonl"),
                        proc=f"client-{cid}",
                    ),
                )
                try:
                    results[cid] = fc.exchange(
                        uploads[cid],
                        n_samples=n_samples[cid],
                        max_retries=3,
                    )
                    if fc.rehomes:
                        result.notes.append(
                            f"client {cid} rehomes: {fc.rehomes}"
                        )
                except (ConnectionError, OSError, wire.WireError) as e:
                    errors[cid] = str(e)

            vt = [
                threading.Thread(target=client_loop, args=(c,), daemon=True)
                for c in victims
            ]
            for t in vt:
                t.start()
            # The survivors' clients hold their uploads until the kill
            # landed AND the re-homed uploads registered at the adoptive
            # relay — the deterministic ordering that keeps relay 0's
            # round open through the adoption window.
            fault.killed.wait(timeout=cfg.deadline_s * 2)
            wait_registered(
                relays[0].server, victims, timeout=cfg.deadline_s * 2
            )
            st = [
                threading.Thread(target=client_loop, args=(c,), daemon=True)
                for c in range(half)
            ]
            for t in st:
                t.start()
            for t in vt + st:
                t.join(timeout=timeout)
            rt.join(timeout=timeout)
        finally:
            fault.close()
            for rel in relays:
                rel.close()
    out = RoundOutcome(
        round=0,
        ok=root_agg[0] is not None,
        error=root_err[0],
        contributors=sorted(results),
        dropped=sorted(errors),
    )
    if root_agg[0] is not None and root.last_assignment is not None:
        # The recorded assignment's groups hold CLIENT ids, which here
        # are exactly indices into the uploads list — aggregate_tree
        # replays the round's ACTUAL tree directly (dropped clients are
        # simply absent from every group).
        groups = root.last_assignment["groups"]
        ref = aggregate_tree(
            [uploads[c] for c in range(n)],
            [float(n_samples[c]) for c in range(n)],
            groups,
        )
        out.live_crc = wire.flat_crc32(
            {k: np.asarray(v, np.float32) for k, v in root_agg[0].items()}
        )
        out.clean_crc = wire.flat_crc32(ref)
        out.bitexact = out.live_crc == out.clean_crc
        result.notes.append(f"assignment: {groups}")
    result.rounds.append(out)
    # Re-home visibility: the obs timeline shows a second wire-upload
    # span (the failed attempt against the dead relay, rehome_failed=1)
    # for each victim.
    spans = load_spans(trace_dir=trace_dir)
    rehome_spans = [
        s for s in spans
        if s["span"] == "wire-upload" and s.get("rehome_failed")
    ]
    result.notes.append(
        f"rehome wire-upload spans: {len(rehome_spans)} "
        f"(victims: {victims})"
    )
    if not rehome_spans:
        result.notes.append(
            "round 0: no rehome_failed wire-upload span on the timeline "
            "(bookkeeping slip)"
        )
    return result


# ----------------------------------------------------------- reporting
def run_matrix(
    cfg: ScenarioConfig, out_dir: str
) -> tuple[list[CellResult], str]:
    """Run every cell, write ``scenario.jsonl`` + ``grid.txt`` under
    ``out_dir``, and return (results, rendered grid)."""
    os.makedirs(out_dir, exist_ok=True)
    cells = build_matrix(cfg)
    results: list[CellResult] = []
    for spec in cells:
        log.info(
            f"[SCENARIO] cell {spec.name}: personas {spec.personas} "
            f"partition {spec.partition}"
            + (" auth" if spec.auth else "")
        )
        t0 = time.monotonic()
        res = run_cell(spec, cfg, out_dir)
        log.info(
            f"[SCENARIO] cell {spec.name}: {res.ok_rounds}/{cfg.rounds} "
            f"rounds ok, {res.exact_rounds} crc-exact, "
            f"{time.monotonic() - t0:.1f}s"
        )
        results.append(res)
    if cfg.dead_relay_cell:
        log.info(
            "[SCENARIO] cell dead-relay: depth-2 tree, seeded mid-round "
            "relay kill, re-home + degraded root"
        )
        t0 = time.monotonic()
        res = run_dead_relay_cell(cfg, out_dir)
        log.info(
            f"[SCENARIO] cell {res.spec.name}: "
            f"{res.ok_rounds}/1 rounds ok, {res.exact_rounds} crc-exact, "
            f"{time.monotonic() - t0:.1f}s"
        )
        results.append(res)
    grid = comparison_grid(results, cfg)
    with open(os.path.join(out_dir, "grid.txt"), "w") as f:
        f.write(grid)
    write_jsonl(results, os.path.join(out_dir, "scenario.jsonl"))
    return results, grid


def write_jsonl(results: list[CellResult], path: str) -> str:
    with open(path, "w") as f:
        for res in results:
            f.write(json.dumps(cell_record(res)) + "\n")
    return path


def cell_record(res: CellResult) -> dict:
    return {
        "cell": res.spec.name,
        "personas": list(res.spec.personas),
        "partition": res.spec.partition,
        "auth": res.spec.auth,
        "strategy": res.spec.strategy,
        "quorum": res.quorum,
        "stream_uploads": res.stream_uploads,
        "accuracy": res.accuracy,
        "manifest": res.manifest,
        "rounds": [vars(r) for r in res.rounds],
        "notes": res.notes,
    }


def comparison_grid(
    results: list[CellResult], cfg: ScenarioConfig
) -> str:
    """The persona x partition comparison grid (one compact cell per
    campaign) plus a per-cell detail block — the human-readable face of
    ``scenario.jsonl``."""

    def _cell_text(res: CellResult) -> str:
        n = len(res.rounds)
        txt = f"ok {res.ok_rounds}/{n}"
        txt += (
            f" crc {res.exact_rounds}/{res.ok_rounds}"
            if res.ok_rounds
            else ""
        )
        wait = max(
            (r.straggler_wait_s for r in res.rounds), default=0.0
        )
        txt += f" wait {wait:.1f}s"
        dropped = sorted({c for r in res.rounds for c in r.dropped})
        if dropped:
            txt += f" drop {dropped}"
        if res.accuracy is not None:
            txt += f" acc {res.accuracy:.3f}"
        return txt

    by_key = {(r.spec.personas[0], r.spec.partition, r.spec.auth): r
              for r in results
              if not r.spec.name.startswith("dead-relay")
              and r.spec.strategy == "fedavg"}
    parts = list(cfg.partitions)
    width = 34
    lines = [
        "scenario grid (rows: persona on client 0 of "
        f"{cfg.num_clients}; cols: partition; {cfg.rounds} live rounds "
        "per cell)",
        "  " + "persona".ljust(14) + "".join(p.ljust(width) for p in parts),
    ]
    for p in cfg.personas:
        row = "  " + p.ljust(14)
        for part in parts:
            res = by_key.get((p, part, False))
            row += (_cell_text(res) if res else "-").ljust(width)
        lines.append(row)
    for res in results:
        if res.spec.auth:
            lines.append(
                "  "
                + f"{res.spec.personas[0]}+auth".ljust(14)
                + _cell_text(res).ljust(width)
                + f"({res.spec.partition})"
            )
        elif res.spec.strategy != "fedavg":
            # Strategy comparison rows: same (persona, partition) key as
            # a base cell above — read down a column to compare against
            # the fedavg arm's accuracy/crc line.
            lines.append(
                "  "
                + res.spec.personas[0].ljust(14)
                + _cell_text(res).ljust(width)
                + f"({res.spec.partition}; strategy {res.spec.strategy})"
            )
        elif res.spec.name.startswith("dead-relay"):
            lines.append(
                "  "
                + "dead-relay".ljust(14)
                + _cell_text(res).ljust(width)
                + f"({res.spec.partition}; depth-2 tree, mid-round kill, "
                "re-home)"
            )
    lines.append("")
    for res in results:
        lines.append(f"cell {res.spec.name}  quorum {res.quorum}  "
                     f"stream_uploads {res.stream_uploads}")
        for r in res.rounds:
            lines.append(
                f"  round {r.round}: "
                + ("ok" if r.ok else f"FAILED ({r.error})")
                + f"  contributors {r.contributors}"
                + (f"  dropped {r.dropped}" if r.dropped else "")
                + f"  wait {r.straggler_wait_s:.2f}s"
                + (
                    "  crc-exact"
                    if r.bitexact
                    else ("  CRC-MISMATCH" if r.bitexact is False else "")
                )
            )
        for note in res.notes:
            lines.append(f"  note: {note}")
    return "\n".join(lines) + "\n"


def contract_violations(results: list[CellResult]) -> list[str]:
    """The robustness contract, checkable: every quorum-satisfiable
    cell's every round succeeds over survivors, and every successful
    round's aggregate is bit-exact with the clean survivor mean."""
    out = []
    for res in results:
        for r in res.rounds:
            if not r.ok:
                out.append(
                    f"{res.spec.name} round {r.round}: failed ({r.error})"
                )
            elif r.bitexact is False:
                out.append(
                    f"{res.spec.name} round {r.round}: aggregate crc "
                    f"{r.live_crc:#010x} != clean survivor mean "
                    f"{r.clean_crc:#010x}"
                )
            elif r.bitexact is None:
                out.append(
                    f"{res.spec.name} round {r.round}: no clean "
                    "reference (bookkeeping slip)"
                )
    return out
