"""N-client federated training (the port of the JAX package's
``train/federated.py``).

Replaces the reference's process topology (client1.py + client2.py +
server.py: N scripts, a threaded TCP server, pickled state dicts) with
one process on one card, or one process per block of clients:

* one stacked ``[C, ...]`` leaf per parameter holding every client's
  replica (:class:`.fedsteps.FedState`);
* one lockstep train step advancing every client on its own batch;
* the round boundary is a weighted, masked mean over the clients axis
  written back into every row (:mod:`..parallel.fedavg`), or DP-FedAvg's
  clipped, noised uniform mean (:mod:`..parallel.dp`), optionally
  through a FedOpt server optimizer;
* per-client local-vs-aggregated evaluation in the reference's order
  (train -> local eval -> aggregate -> aggregated eval,
  client1.py:379-404), over one stacked sweep.

The mesh: a ``clients x data`` :class:`..parallel.mesh.Mesh` whose rows
are fitted to the client count (several replicas stack per row). A
single process runs its stacked clients on its device. Under
``torch.distributed`` (``federated --coordinator``, :mod:`..parallel.multihost`)
each process owns a contiguous block of clients (``client_offset``,
``C_local``): its stack holds only their rows, their batches and dropout
streams are the ones a single process would give them, and the round's
mean crosses processes once: every process gathers the fleet's rows (one
all-gather, process-major = client order) and computes the same
aggregate on them, so every process holds the same bits, the bits one
process would compute. Batch counts, eval row counts, the DP noise seed
and the metrics are agreed the same way.

Observability as in the JAX trainer: each ``fit_local`` writes one
``client-local`` span (with the sampled step attrs under
``--profile-stride``) and each aggregation an ``agg`` span, to
``self.tracer`` or else the global tracer; the dispatch ledger notes the
first lockstep step of each shape (``fed.train_step``, ragged
``fed.ragged_step``) and eval step (``fed.eval_step``); device memory is
snapshotted after the first step and at every aggregation.

Rounds are a loop, with a fresh client Adam each round when
``fed.reset_optimizer_each_round`` (every reference re-launch builds a
new one, client1.py:380). After the last round, :meth:`FederatedTrainer.personalize`
fine-tunes a copy of each client's aggregate on its own shard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.pipeline import StackedClients, TokenizedSplit
from ..device import resolve_device
from ..models.distilbert import build_trainable_params, init_params, model_skeleton
from ..obs.profile import default_ledger, maybe_step_profiler, note_memory, profiled_step_iter
from ..parallel import multihost
from ..parallel.dp import noise_seed, round_generator
from ..parallel.fedavg import make_server_optimizer, stack_params
from ..parallel.mesh import Mesh, fit_clients_axis, make_mesh
from ..utils.logging import phase
from .batches import federated_batches, federated_batches_ragged
from .engine import Trainer
from .fedeval import PreparedEval, evaluate_stacked, stack_eval_splits
from .fedsteps import FedAdamState, FedState, aggregate_round, check_survivors, init_opt_state, train_step

log = logging.getLogger(__name__)


@dataclass
class RoundRecord:
    round: int  # 0-based
    epoch_losses: np.ndarray  # [E, C]
    local_metrics: list[dict]  # per client, on the eval splits
    aggregated_metrics: list[dict] = field(default_factory=list)
    local_val: list[dict] = field(default_factory=list)  # on the val splits, when given
    aggregated_val: list[dict] = field(default_factory=list)
    # Wall seconds by phase: fit, local_eval, aggregate, aggregated_eval,
    # and save (the on_round hook) when there is one.
    seconds: dict[str, float] = field(default_factory=dict)


def _clone_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


class FederatedTrainer:
    """N-client FedAvg on a ``clients x data`` mesh, on the card unless
    ``device="cpu"`` is given (no CUDA raises). ``mesh``: a global mesh
    (:func:`..parallel.multihost.make_global_mesh`) under a process group;
    by default one over this process's slots, its rows fitted to the
    client count."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        *,
        pad_id: int = 0,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        self.cfg = cfg
        self.C = cfg.fed.num_clients
        self.pad_id = pad_id
        self.device = resolve_device(device)
        self.P = multihost.process_count()
        self.mesh = mesh if mesh is not None else self._default_mesh()
        if self.P > 1:
            rows = self.mesh.devices.shape[0]
            sl = multihost.local_client_slice(self.mesh)
            self.client_offset = sl.start * (self.C // rows)
            self.C_local = (sl.stop - sl.start) * (self.C // rows)
        else:
            self.client_offset, self.C_local = 0, self.C
        if cfg.mesh.data > 1:
            log.info(
                f"[FED] the lockstep step runs this process's {self.C_local} client(s) on {self.device}: the "
                f"mesh's data axis ({cfg.mesh.data}) lays out slots but does not split their batch rows "
                "(the TCP client's --data-parallel does)"
            )
        # Holds no storage (meta device): every call passes one client's
        # rows of the stacked leaves through functional_call.
        self.model = model_skeleton(cfg.model)
        self.server_tx = make_server_optimizer(cfg.fed)
        # DP noise seed (fed.dp_seed, else fresh OS entropy): drawn once
        # a run, mixed with the round index for each round's generator.
        # Under a process group everyone adopts process 0's draw, so the
        # noise is the same everywhere.
        self._dp_seed = noise_seed(cfg.fed.dp_seed) if cfg.fed.dp_clip > 0.0 else None
        if self._dp_seed is not None and self.P > 1:
            self._dp_seed = int(multihost.allgather_hosts(self._dp_seed)[0])
        # Observability (obs/trace.py): set by the CLI (or any caller) to
        # emit per-round client-local/agg spans; None falls back to the
        # global tracer.
        self.tracer = None
        # Step-time attribution: None unless profiling is armed
        # process-wide; re-checked at fit time.
        self.step_profiler = maybe_step_profiler("train")
        # Dispatch ledger: the first lockstep step of each [C, B, L]
        # shape, dense and ragged apart, as the JAX trainer's sites.
        ledger = default_ledger()

        def fed_signature(trainer, state, batch, anchor=None) -> tuple:
            return tuple(int(d) for d in batch["input_ids"].shape)

        self._timed_steps = {
            site: ledger.timed(site, train_step, signature=fed_signature)
            for site in ("fed.train_step", "fed.ragged_step")
        }

    # One client's rows through the meta-device skeleton, as the
    # single-client engine runs its state.
    _logits = Trainer._logits

    def _default_mesh(self) -> Mesh:
        """``mesh.clients x mesh.data`` over this process's slots, the rows
        fitted to the hardware (several client replicas per row) when the
        configured axis does not fit or does not divide the client count."""
        cfg = self.cfg
        if self.P > 1:
            return multihost.make_global_mesh(
                cfg.mesh.clients, cfg.mesh.data, axis_names=cfg.mesh.axis_names, device=self.device
            )
        rows = cfg.mesh.clients
        n_dev = len(multihost.process_devices(self.device))
        if rows * cfg.mesh.data > n_dev or self.C % rows:
            rows = fit_clients_axis(self.C, cfg.mesh.data, n_dev)
            log.info(
                f"[FED] {self.C} clients on {n_dev} device(s): mesh "
                f"{cfg.mesh.clients}x{cfg.mesh.data} -> {rows}x{cfg.mesh.data} "
                f"({self.C // rows} client replicas per row)"
            )
        return make_mesh(rows, cfg.mesh.data, axis_names=cfg.mesh.axis_names, device=self.device)

    # -------------------------------------------------------------- lifecycle
    def init_state(self, seed: int | None = None, params: dict | None = None) -> FedState:
        """Every client starts from the same params (the reference's shared
        pretrained start, client1.py:56): ``params`` (a state dict) or a
        seeded init. Client c's dropout generator is seeded from the run
        seed and c, on the training device."""
        seed = self.cfg.train.seed if seed is None else seed
        if params is None:
            params = init_params(self.cfg.model, torch.Generator().manual_seed(seed))
        single = build_trainable_params(
            self.cfg.model, params, self.device, trainable=self.cfg.train.trainable
        )
        stacked = {
            n: t.requires_grad_(single[n].requires_grad)
            for n, t in stack_params(single, self.C_local).items()
        }
        server_opt = None
        if self.server_tx is not None:
            server_opt = self.server_tx.init(single)
        return FedState(
            params=stacked,
            opt_state=self._opt_init(stacked),
            step=0,
            generators=[self._generator(seed, self.client_offset + c) for c in range(self.C_local)],
            server_opt=server_opt,
        )

    def _generator(self, seed: int, client: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed((seed + 1) * 1_000_003 + client)

    def _opt_init(self, params: dict) -> FedAdamState:
        return init_opt_state(params, self.C_local, self.cfg.train.grad_accum_steps)

    def reset_optimizer(self, state: FedState) -> FedState:
        state.opt_state = self._opt_init(state.params)
        return state

    def personalize(
        self,
        state: FedState,
        stacked_train: TokenizedSplit | StackedClients,
        *,
        epochs: int | None = None,
        scope: str | None = None,
    ) -> tuple[FedState, np.ndarray]:
        """FedAvg + local fine-tuning: each client trains its replica on its
        own shard from the current (just aggregated) params, with no
        closing aggregate: the per-client personalized models of the third
        evaluation phase. ``scope="head"`` freezes the encoder and adapts
        only the classifier (FedPer); ``"full"`` fine-tunes everything
        (FedAvg+FT).

        A side branch: it trains copies of the leaves and of the dropout
        generators under a fresh optimizer state, so ``state`` stays the
        aggregate. Returns the personalized state and the ``[E, C]`` epoch
        losses."""
        epochs = self.cfg.fed.personalize_epochs if epochs is None else epochs
        scope = self.cfg.fed.personalize_scope if scope is None else scope
        if epochs <= 0:
            raise ValueError("personalize needs epochs > 0")
        if scope not in ("full", "head"):
            raise ValueError(f"personalize scope {scope!r} must be full|head")
        # A scope-matched trainer in either direction: head scope on an
        # all-params config, or full scope on a trainable="head" one.
        want = "head" if scope == "head" else "all"
        ptrainer = self
        if self.cfg.train.trainable != want:
            cfg = dataclasses.replace(self.cfg, train=dataclasses.replace(self.cfg.train, trainable=want))
            ptrainer = type(self)(cfg, pad_id=self.pad_id, device=self.device, mesh=self.mesh)
        params = {
            n: p.detach().clone().requires_grad_(want == "all" or n.startswith("classifier."))
            for n, p in state.params.items()
        }
        branch = FedState(
            params=params,
            opt_state=ptrainer._opt_init(params),
            step=state.step,
            generators=[_clone_generator(g) for g in state.generators],
            server_opt=state.server_opt,
        )
        return ptrainer.fit_local(branch, stacked_train, epochs=epochs)

    # ---------------------------------------------------------------- phases
    def train_step(self, state: FedState, batch: dict, anchor=None) -> tuple[torch.Tensor, np.ndarray]:
        """One lockstep step (:func:`.fedsteps.train_step`)."""
        site = "fed.ragged_step" if "valid" in batch else "fed.train_step"
        return self._timed_steps[site](self, state, batch, anchor)

    def _armed_profiler(self):
        """The fit loop's step profiler: the one built at construction, or
        a late arm when the CLI installed the stride afterwards, with a
        fresh reporting window either way. None = profiling off."""
        prof = self.step_profiler
        if prof is None:
            prof = self.step_profiler = maybe_step_profiler("train")
        if prof is not None:
            prof.begin_window()
        return prof

    def fit_local(
        self,
        state: FedState,
        stacked_train: TokenizedSplit | StackedClients,
        *,
        epochs: int | None = None,
        epoch_offset: int = 0,
    ) -> tuple[FedState, np.ndarray]:
        """E local epochs for every client in lockstep; returns the state
        and ``[E, C]`` per-client epoch losses.

        A :class:`StackedClients` input takes the ragged path: every
        client's whole split trains each epoch over the fleet's longest
        epoch (the final short batch included), idle clients gated off,
        and a client's epoch loss averages its own batches. A plain
        ``[C, N, ...]`` :class:`TokenizedSplit` takes the dense path
        (``N // bs`` full batches for everyone).

        Writes one ``client-local`` span per call, its round derived from
        ``epoch_offset`` (the loops pass ``round * epochs_per_round``)."""
        prof = self._armed_profiler()
        t_unix = time.time()
        t0 = time.monotonic()
        out = self._fit_local_impl(state, stacked_train, epochs=epochs, epoch_offset=epoch_offset, prof=prof)
        self._trace_phase(
            "client-local",
            t_unix,
            time.monotonic() - t0,
            epoch_offset // max(self.cfg.train.epochs_per_round, 1),
            **(prof.span_attrs() if prof is not None else {}),
        )
        return out

    def _fit_local_impl(
        self,
        state: FedState,
        stacked_train: TokenizedSplit | StackedClients,
        *,
        epochs: int | None,
        epoch_offset: int,
        prof,
    ) -> tuple[FedState, np.ndarray]:
        bs = self.cfg.data.batch_size
        E = self.cfg.train.epochs_per_round if epochs is None else epochs
        ragged = isinstance(stacked_train, StackedClients)
        if ragged:
            n_batches = max((-(-int(n) // bs) for n in stacked_train.n_rows), default=0)
            if self.P > 1:
                # Every process runs the fleet's longest epoch (each round
                # ends in a collective); short blocks idle through it.
                n_batches = int(multihost.allgather_hosts(n_batches).max())
            if n_batches == 0:
                raise ValueError("every client's train split is empty: nothing to fit")
        else:
            n_batches = stacked_train.labels.shape[1] // bs
            if self.P > 1:
                n_batches = int(multihost.allgather_hosts(n_batches).min())
            if n_batches == 0:
                raise ValueError(
                    f"common per-client train rows ({stacked_train.labels.shape[1]}) "
                    f"< batch_size ({bs}): zero batches per epoch. Stack with "
                    "stack_clients_ragged to train tiny clients without "
                    "dragging the fleet down."
                )
        anchor = None
        if self.cfg.fed.prox_mu > 0.0:
            # FedProx: the round-start params, a copy the steps never touch.
            anchor = {n: p.detach().clone() for n, p in state.params.items()}
        out = []
        first_memory = prof is not None
        last_loss = None
        for epoch in range(epoch_offset, epoch_offset + E):
            if ragged:
                batches = federated_batches_ragged(
                    stacked_train, bs, seed=self.cfg.train.seed, epoch=epoch,
                    client_offset=self.client_offset, n_batches=n_batches,
                )
            else:
                batches = federated_batches(
                    stacked_train, bs, seed=self.cfg.train.seed, epoch=epoch, client_offset=self.client_offset
                )
                if self.P > 1:
                    batches = itertools.islice(batches, n_batches)
            losses, had = [], []
            for batch, sampled in profiled_step_iter(prof, batches):
                if sampled:
                    prof.drain(last_loss)
                    td = prof.clock()
                    loss, has = self.train_step(state, batch, anchor)
                    prof.note_dispatch(prof.clock() - td)
                    prof.fence(loss)
                else:
                    loss, has = self.train_step(state, batch, anchor)
                last_loss = loss
                if first_memory:
                    first_memory = False
                    note_memory("post-first-step")
                losses.append(loss)
                had.append(has)
            if ragged:
                # Per-client mean over ITS OWN batches: gated steps carry
                # loss 0 and has 0, so they drop out of both sums.
                count = torch.from_numpy(np.stack(had).sum(axis=0)).to(self.device)
                epoch_avg = torch.stack(losses).sum(dim=0) / torch.clamp(count, min=1.0)
            else:
                epoch_avg = torch.stack(losses).mean(dim=0)
            out.append(multihost.global_rows(epoch_avg.cpu().numpy(), self.C))
            for c in range(self.C):
                log.info(f"Client {c} Epoch [{epoch - epoch_offset + 1}/{E}], Average Loss: {out[-1][c]:.4f}")
        return state, np.stack(out) if out else np.zeros((0, self.C))

    def prepare_eval(self, splits: Sequence[TokenizedSplit], *, target_rows: int | None = None) -> PreparedEval:
        """Pad and stack eval splits once; reuse across rounds. Under a
        process group each process passes its own clients' splits, and the
        processes agree on the row count (the fleet's longest split)."""
        bs = self.cfg.data.eval_batch_size
        if target_rows is None and self.P > 1:
            target_rows = int(multihost.allgather_hosts(max(len(s) for s in splits)).max())
        stacked, valid = stack_eval_splits(splits, bs, pad_id=self.pad_id, target_rows=target_rows)
        return PreparedEval(stacked, valid, bs)

    def evaluate_clients(
        self,
        stacked_params: dict,
        splits: Sequence[TokenizedSplit] | None = None,
        *,
        prepared: PreparedEval | None = None,
        collect_probs: bool = False,
    ) -> list[dict]:
        """Per-client metrics dicts (the reference's five-metric schema),
        on ``splits`` or on eval data ``prepared`` once."""
        if (splits is None) == (prepared is None):
            raise ValueError("pass either splits or prepared")
        if prepared is None:
            prepared = self.prepare_eval(splits)
        local = evaluate_stacked(self, stacked_params, prepared, collect_probs=collect_probs)
        if self.P == 1:
            return local
        # Every process reports the whole fleet, process-major = client order.
        return [m for block in multihost.all_gather_objects(local) for m in block]

    # ------------------------------------------------------- round boundary
    def participation_mask(self, round_index: int) -> np.ndarray | None:
        """The round's seeded 0/1 cohort (``fed.participation < 1``), None
        when everyone takes part. "fixed" draws exactly ``cohort_size()``
        clients without replacement; "poisson" each client independently
        with probability ``participation`` (the cohort may be empty)."""
        if self.cfg.fed.participation >= 1.0:
            return None
        rng = np.random.default_rng(self.cfg.train.seed * 7919 + round_index)
        if self.cfg.fed.resolve_participation_mode() == "poisson":
            return (rng.random(self.C) < self.cfg.fed.participation).astype(np.float64)
        mask = np.zeros(self.C, np.float64)
        mask[rng.choice(self.C, size=self.cfg.fed.cohort_size(), replace=False)] = 1.0
        return mask

    def round_anchor(self, state: FedState) -> dict | None:
        """Round-start params for DP and/or FedOpt aggregation, captured
        before ``fit_local`` (a copy); None when neither needs it."""
        if self.server_tx is None and self._dp_seed is None:
            return None
        return {n: p.detach().clone() for n, p in state.params.items()}

    def dp_generator(self, round_index: int) -> torch.Generator:
        """The round's DP noise generator, on the training device."""
        return round_generator(self._dp_seed, round_index, self.device)

    def round_aggregate(
        self,
        state: FedState,
        *,
        round_index: int,
        weights: np.ndarray | None = None,
        base_mask: np.ndarray | None = None,
        faults: np.ndarray | None = None,
        anchor: Any | None = None,
    ) -> FedState:
        """One round's participation sampling, gating and aggregation
        (:meth:`run`'s round boundary).

        ``min_client_fraction`` gates the clients ``base_mask`` excludes
        (those with no train rows) and the crashed ones ``faults`` drops,
        never the Poisson draw; an empty effective Poisson cohort makes the
        round a no-op, while a drawn cohort whose every member crashed
        fails the round."""
        mask = self.participation_mask(round_index)
        poisson = mask is not None and self.cfg.fed.resolve_participation_mode() == "poisson"
        gate = base_mask
        if base_mask is not None:
            mask = base_mask if mask is None else mask * base_mask
        # Keyed on the draw gated by the structural base_mask only: a crash
        # is a fault event, not a benign sampling outcome.
        draw_empty = poisson and float(mask.sum()) == 0.0
        if faults is not None:
            faults = np.asarray(faults, np.float64)
            mask = faults if mask is None else mask * faults
            gate = faults if gate is None else gate * faults
        if poisson and gate is not None:
            check_survivors(float(gate.sum()), self.C, self.cfg.fed.min_client_fraction)
        if draw_empty:
            log.info(
                f"[FED] round {round_index + 1}: empty effective Poisson "
                "cohort (no sampled client holds data); aggregation skipped"
            )
            return state
        t_unix = time.time()
        t0 = time.monotonic()
        state = self.aggregate(
            state,
            weights=weights,
            client_mask=mask,
            anchor=anchor,
            round_index=round_index,
            enforce_min_fraction=not poisson,
        )
        self._trace_phase("agg", t_unix, time.monotonic() - t0, round_index)
        note_memory("post-aggregate")
        return state

    def aggregate(
        self,
        state: FedState,
        *,
        weights: np.ndarray | None = None,
        client_mask: np.ndarray | None = None,
        anchor: Any | None = None,
        round_index: int = 0,
        enforce_min_fraction: bool = True,
    ) -> FedState:
        """The FedAvg round boundary (:func:`.fedsteps.aggregate_round`).
        Under a process group every process gathers the fleet's rows (and
        the anchor's), aggregates them as one process would and keeps its
        own rows."""
        kw = dict(
            weights=weights, client_mask=client_mask, round_index=round_index,
            enforce_min_fraction=enforce_min_fraction,
        )
        if self.P == 1:
            return aggregate_round(self, state, anchor=anchor, **kw)
        fleet = FedState(
            params=self._fleet_rows(state.params), opt_state=state.opt_state, step=state.step,
            generators=state.generators, server_opt=state.server_opt,
        )
        aggregate_round(self, fleet, anchor=None if anchor is None else self._fleet_rows(anchor), **kw)
        mine = slice(self.client_offset, self.client_offset + self.C_local)
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(fleet.params[n][mine])
        state.server_opt = fleet.server_opt
        return state

    def _fleet_rows(self, leaves: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Every client's rows of ``[C_local, ...]`` leaves, ``[C, ...]``
        on this process's device: one all-gather of the flattened block."""
        flat = torch.cat([p.detach().reshape(self.C_local, -1) for p in leaves.values()], dim=1)
        full = multihost.global_rows(flat, self.C)
        out, off = {}, 0
        for n, p in leaves.items():
            size = int(p[0].numel())
            out[n] = full[:, off : off + size].reshape(self.C, *p.shape[1:]).contiguous()
            off += size
        return out

    def fleet_weights(self, stacked_train: TokenizedSplit | StackedClients) -> tuple[np.ndarray | None, np.ndarray | None]:
        """``(weights, base_mask)`` for a run over ``stacked_train``:
        sample-count weights when ``fed.resolve_weighted()`` (a dense
        stack lost its counts, so ``weighted=True`` raises there), and
        under a uniform mean a mask that excludes clients with no train
        rows (they would average their untrained start in at full
        weight)."""
        weights = base_mask = None
        ragged = isinstance(stacked_train, StackedClients)
        # The fleet's counts (every process's block under a process group).
        n_rows = multihost.global_rows(np.asarray(stacked_train.n_rows, np.int64), self.C) if ragged else None
        if self.cfg.fed.resolve_weighted():
            if ragged:
                weights = np.asarray(n_rows, np.float64)
            elif self.cfg.fed.weighted:
                raise ValueError(
                    "fed.weighted=True needs per-client sample counts, which "
                    "a dense stack lost: stack with stack_clients_ragged"
                )
        if weights is None and ragged:
            empty = np.asarray(n_rows) == 0
            if empty.any():
                base_mask = (~empty).astype(np.float64)
                log.warning(
                    f"[FED] clients {np.flatnonzero(empty).tolist()} have "
                    "zero train rows; excluding them from the uniform mean"
                )
        return weights, base_mask

    # ------------------------------------------------------- observability
    def _trace_attrs(self) -> dict:
        """Span attributes naming this trainer's path (the JAX package's
        two-axis federated trainer's)."""
        return {"path": "fed2", "clients": self.C}

    def _obs_tracer(self):
        from ..obs.trace import get_global_tracer

        return self.tracer if self.tracer is not None else get_global_tracer()

    def _trace_phase(self, name: str, t_start: float, dur_s: float, round_index: int, **extra: Any) -> None:
        tracer = self._obs_tracer()
        if tracer is not None:
            tracer.record(
                name,
                t_start=t_start,
                dur_s=dur_s,
                round=round_index,
                **self._trace_attrs(),
                **extra,
            )

    # ------------------------------------------------------------------- run
    @staticmethod
    def _bracket(name: str, inside_round: bool):
        return contextlib.nullcontext() if inside_round else phase(name, tag="FED")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(
        self,
        state: FedState,
        stacked_train: TokenizedSplit | StackedClients,
        eval_splits: Sequence[TokenizedSplit],
        *,
        val_splits: Sequence[TokenizedSplit] | None = None,
        start_round: int = 0,
        on_round: Callable[[FedState, RoundRecord], None] | None = None,
        fault_mask_fn: Callable[[int], np.ndarray | None] | None = None,
        round_bracket: bool = False,
    ) -> tuple[FedState, list[RoundRecord]]:
        """The federated flow, rounds ``start_round .. fed.rounds - 1``: local
        epochs -> local eval -> FedAvg -> aggregated eval (the reference's
        one-shot flow, client1.py:379-404, looped), the client optimizer
        reset between rounds.

        ``val_splits`` are evaluated beside ``eval_splits`` at both points
        (the reference scores val and test, client1.py:383-385,398-400).
        ``on_round(state, record)`` runs after each round's aggregated
        evaluation and before the reset; the CLI saves its checkpoint and
        registry artifact there. ``fault_mask_fn(round) -> [C] 0/1 mask |
        None`` injects deterministic client failures for a round: a
        dropped client is left out of the masked mean as a crashed one
        would be, both masks must keep a client under partial
        participation, and ``min_client_fraction`` still gates the round
        (below it the round raises).

        Phase brackets (utils/logging.py): ``round r/R local training``
        and ``round r/R FedAvg``, the JAX trainer's; with
        ``round_bracket`` one ``round r/R`` bracket from the fit to the
        aggregated evaluation instead, the JAX ``federated`` verb's."""
        R = self.cfg.fed.rounds
        E = self.cfg.train.epochs_per_round
        weights, base_mask = self.fleet_weights(stacked_train)
        test = self.prepare_eval(eval_splits)
        val = None if val_splits is None else self.prepare_eval(val_splits)

        def evaluate() -> tuple[list[dict], list[dict]]:
            on_val = [] if val is None else self.evaluate_clients(state.params, prepared=val)
            return on_val, self.evaluate_clients(state.params, prepared=test)

        history: list[RoundRecord] = []
        for r in range(start_round, R):
            sec: dict[str, float] = {}
            # The JAX verb's one bracket over the round, or the trainer's two.
            with phase(f"round {r + 1}/{R}", tag="FED") if round_bracket else contextlib.nullcontext():
                t = time.perf_counter()
                anchor = self.round_anchor(state)
                with self._bracket(f"round {r + 1}/{R} local training", round_bracket):
                    state, losses = self.fit_local(state, stacked_train, epoch_offset=r * E)
                sec["fit"] = time.perf_counter() - t  # the epoch losses sync the device
                t = time.perf_counter()
                local_val, local = evaluate()
                sec["local_eval"] = time.perf_counter() - t
                t = time.perf_counter()
                faults = None
                if fault_mask_fn is not None:
                    faults = fault_mask_fn(r)
                    if faults is not None:
                        faults = np.asarray(faults, np.float64)
                        dropped = [c for c in range(self.C) if faults[c] == 0]
                        if dropped:
                            log.info(f"[FED] round {r + 1}: injected faults drop clients {dropped}")
                with self._bracket(f"round {r + 1}/{R} FedAvg", round_bracket):
                    state = self.round_aggregate(
                        state, round_index=r, weights=weights, base_mask=base_mask, faults=faults, anchor=anchor
                    )
                    self._sync()
                sec["aggregate"] = time.perf_counter() - t
                t = time.perf_counter()
                aggregated_val, aggregated = evaluate()
                sec["aggregated_eval"] = time.perf_counter() - t
            record = RoundRecord(r, losses, local, aggregated, local_val, aggregated_val, sec)
            if on_round is not None:
                t = time.perf_counter()
                on_round(state, record)
                sec["save"] = time.perf_counter() - t
            history.append(record)
            for c in range(self.C):
                log.info(
                    f"Round {r + 1} client {c}: local acc {local[c]['Accuracy']:.4f} -> "
                    f"aggregated {aggregated[c]['Accuracy']:.4f}"
                )
            if r + 1 < R and self.cfg.fed.reset_optimizer_each_round:
                state = self.reset_optimizer(state)
        return state, history
