"""Single-process N-client federated training (the port of the JAX
package's ``train/federated.py``, without its mesh, multi-host, FSDP,
profiler and tracer parts).

Replaces the reference's process topology (client1.py + client2.py +
server.py: N scripts, a threaded TCP server, pickled state dicts) with
one process on one card:

* one stacked ``[C, ...]`` leaf per parameter holding every client's
  replica (:class:`.fedsteps.FedState`);
* one lockstep train step advancing every client on its own batch;
* the round boundary is a weighted, masked mean over the clients axis
  written back into every row (:mod:`..parallel.fedavg`), optionally
  through a FedOpt server optimizer;
* per-client local-vs-aggregated evaluation in the reference's order
  (train -> local eval -> aggregate -> aggregated eval,
  client1.py:379-404), over one stacked sweep.

Rounds are a loop, with a fresh client Adam each round when
``fed.reset_optimizer_each_round`` (every reference re-launch builds a
new one, client1.py:380).
"""

from __future__ import annotations

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
from ..parallel.fedavg import make_server_optimizer, stack_params
from .batches import federated_batches, federated_batches_ragged
from .engine import Trainer
from .fedeval import PreparedEval, evaluate_stacked, stack_eval_splits
from .fedsteps import FedState, aggregate_round, check_survivors, init_opt_state, train_step

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


class FederatedTrainer:
    """N-client FedAvg in one process, on the card unless ``device="cpu"``
    is given (no CUDA raises)."""

    def __init__(self, cfg: ExperimentConfig, *, pad_id: int = 0, device: str | torch.device | None = None):
        self.cfg = cfg
        self.C = cfg.fed.num_clients
        self.pad_id = pad_id
        self.device = resolve_device(device)
        # Holds no storage (meta device): every call passes one client's
        # rows of the stacked leaves through functional_call.
        self.model = model_skeleton(cfg.model)
        self.server_tx = make_server_optimizer(cfg.fed)

    # One client's rows through the meta-device skeleton, as the
    # single-client engine runs its state.
    _logits = Trainer._logits

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
            for n, t in stack_params(single, self.C).items()
        }
        server_opt = None
        if self.server_tx is not None:
            server_opt = self.server_tx.init(single)
        return FedState(
            params=stacked,
            opt_state=init_opt_state(stacked, self.C),
            step=0,
            generators=[self._generator(seed, c) for c in range(self.C)],
            server_opt=server_opt,
        )

    def _generator(self, seed: int, client: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed((seed + 1) * 1_000_003 + client)

    def reset_optimizer(self, state: FedState) -> FedState:
        state.opt_state = init_opt_state(state.params, self.C)
        return state

    def personalize(self, *args, **kwargs):
        raise NotImplementedError(
            "personalization (FedAvg + local fine-tuning) is not ported yet "
            "(ROADMAP queue 1, item 16)"
        )

    # ---------------------------------------------------------------- phases
    def train_step(self, state: FedState, batch: dict, anchor=None) -> tuple[torch.Tensor, np.ndarray]:
        """One lockstep step (:func:`.fedsteps.train_step`)."""
        return train_step(self, state, batch, anchor)

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
        (``N // bs`` full batches for everyone)."""
        bs = self.cfg.data.batch_size
        E = self.cfg.train.epochs_per_round if epochs is None else epochs
        ragged = isinstance(stacked_train, StackedClients)
        if ragged:
            n_batches = max((-(-int(n) // bs) for n in stacked_train.n_rows), default=0)
            if n_batches == 0:
                raise ValueError("every client's train split is empty: nothing to fit")
        else:
            n_batches = stacked_train.labels.shape[1] // bs
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
        for epoch in range(epoch_offset, epoch_offset + E):
            if ragged:
                batches = federated_batches_ragged(
                    stacked_train, bs, seed=self.cfg.train.seed, epoch=epoch, n_batches=n_batches
                )
            else:
                batches = federated_batches(stacked_train, bs, seed=self.cfg.train.seed, epoch=epoch)
            losses, had = [], []
            for batch in batches:
                loss, has = self.train_step(state, batch, anchor)
                losses.append(loss)
                had.append(has)
            if ragged:
                # Per-client mean over ITS OWN batches: gated steps carry
                # loss 0 and has 0, so they drop out of both sums.
                count = torch.from_numpy(np.stack(had).sum(axis=0)).to(self.device)
                epoch_avg = torch.stack(losses).sum(dim=0) / torch.clamp(count, min=1.0)
            else:
                epoch_avg = torch.stack(losses).mean(dim=0)
            out.append(epoch_avg.cpu().numpy())
            for c in range(self.C):
                log.info(f"Client {c} Epoch [{epoch - epoch_offset + 1}/{E}], Average Loss: {out[-1][c]:.4f}")
        return state, np.stack(out) if out else np.zeros((0, self.C))

    def prepare_eval(self, splits: Sequence[TokenizedSplit]) -> PreparedEval:
        """Pad and stack eval splits once; reuse across rounds."""
        bs = self.cfg.data.eval_batch_size
        stacked, valid = stack_eval_splits(splits, bs, pad_id=self.pad_id)
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
        return evaluate_stacked(self, stacked_params, prepared, collect_probs=collect_probs)

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
        """Round-start params for FedOpt aggregation, captured before
        ``fit_local`` (a copy); None under plain FedAvg."""
        if self.server_tx is None:
            return None
        return {n: p.detach().clone() for n, p in state.params.items()}

    def round_aggregate(
        self,
        state: FedState,
        *,
        round_index: int,
        weights: np.ndarray | None = None,
        base_mask: np.ndarray | None = None,
        anchor: Any | None = None,
    ) -> FedState:
        """One round's participation sampling, gating and aggregation
        (:meth:`run`'s round boundary).

        ``min_client_fraction`` gates the clients ``base_mask`` excludes
        (those with no train rows), never the Poisson draw; an empty
        effective Poisson cohort makes the round a no-op."""
        mask = self.participation_mask(round_index)
        poisson = mask is not None and self.cfg.fed.resolve_participation_mode() == "poisson"
        if base_mask is not None:
            if poisson:
                check_survivors(float(base_mask.sum()), self.C, self.cfg.fed.min_client_fraction)
            mask = base_mask if mask is None else mask * base_mask
        if poisson and float(mask.sum()) == 0.0:
            log.info(
                f"[FED] round {round_index + 1}: empty effective Poisson "
                "cohort (no sampled client holds data); aggregation skipped"
            )
            return state
        return self.aggregate(
            state,
            weights=weights,
            client_mask=mask,
            anchor=anchor,
            round_index=round_index,
            enforce_min_fraction=not poisson,
        )

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
        """The FedAvg round boundary (:func:`.fedsteps.aggregate_round`)."""
        return aggregate_round(
            self,
            state,
            weights=weights,
            client_mask=client_mask,
            anchor=anchor,
            round_index=round_index,
            enforce_min_fraction=enforce_min_fraction,
        )

    def fleet_weights(self, stacked_train: TokenizedSplit | StackedClients) -> tuple[np.ndarray | None, np.ndarray | None]:
        """``(weights, base_mask)`` for a run over ``stacked_train``:
        sample-count weights when ``fed.resolve_weighted()`` (a dense
        stack lost its counts, so ``weighted=True`` raises there), and
        under a uniform mean a mask that excludes clients with no train
        rows (they would average their untrained start in at full
        weight)."""
        weights = base_mask = None
        ragged = isinstance(stacked_train, StackedClients)
        if self.cfg.fed.resolve_weighted():
            if ragged:
                weights = np.asarray(stacked_train.n_rows, np.float64)
            elif self.cfg.fed.weighted:
                raise ValueError(
                    "fed.weighted=True needs per-client sample counts, which "
                    "a dense stack lost: stack with stack_clients_ragged"
                )
        if weights is None and ragged:
            empty = np.asarray(stacked_train.n_rows) == 0
            if empty.any():
                base_mask = (~empty).astype(np.float64)
                log.warning(
                    f"[FED] clients {np.flatnonzero(empty).tolist()} have "
                    "zero train rows; excluding them from the uniform mean"
                )
        return weights, base_mask

    # ------------------------------------------------------------------- run
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
    ) -> tuple[FedState, list[RoundRecord]]:
        """The federated flow, rounds ``start_round .. fed.rounds - 1``: local
        epochs -> local eval -> FedAvg -> aggregated eval (the reference's
        one-shot flow, client1.py:379-404, looped), the client optimizer
        reset between rounds.

        ``val_splits`` are evaluated beside ``eval_splits`` at both points
        (the reference scores val and test, client1.py:383-385,398-400).
        ``on_round(state, record)`` runs after each round's aggregated
        evaluation and before the reset; the CLI saves its checkpoint and
        registry artifact there."""
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
            t = time.perf_counter()
            anchor = self.round_anchor(state)
            state, losses = self.fit_local(state, stacked_train, epoch_offset=r * E)
            sec["fit"] = time.perf_counter() - t  # the epoch losses sync the device
            t = time.perf_counter()
            local_val, local = evaluate()
            sec["local_eval"] = time.perf_counter() - t
            t = time.perf_counter()
            state = self.round_aggregate(state, round_index=r, weights=weights, base_mask=base_mask, anchor=anchor)
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
