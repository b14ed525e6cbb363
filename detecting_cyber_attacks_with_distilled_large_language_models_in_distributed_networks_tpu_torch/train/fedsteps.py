"""The federated trainer's steps (the port of the JAX package's
``train/fedsteps.py``): the stacked state, the lockstep train step, the
stacked eval step and the round boundary.

One stacked ``[C, ...]`` fp32 leaf per parameter holds every client's
replica. A lockstep step runs each client's forward on its own rows of
those leaves (``unbind`` views through ``functional_call``), then ONE
backward of the sum of the clients' losses: a client's loss depends only
on its own rows, so the gradient of the sum is the stacked per-client
gradient (the trick of the JAX package's FSDP step). Adam then updates
each client's rows with the client's own count, so its bias corrections
and warmup follow the steps that client actually took.

A client whose lockstep batch holds no valid row (a short client idling
through the epoch's tail) keeps its params, moments and count untouched,
as the JAX package's gated update does. Its outputs are defined (loss 0,
``has`` 0), so its forward is skipped: the flash kernels launch once per
layer per client-step that ran.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from ..ops.metrics import BinaryCounts, ClassCounts
from ..parallel.fedavg import broadcast_rows, fedavg, weighted_mean
from .engine import adam_update, eval_counts, masked_loss_fn, prox_sq

log = logging.getLogger(__name__)


class FedAdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` vmapped over clients: one Adam count
    per client and ``[C, ...]`` moments of the trainable leaves."""

    count: list[int]
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclass
class FedState:
    """Stacked per-client training state; every tensor leaf's axis 0 is
    clients."""

    params: dict[str, torch.Tensor]  # [C, ...] fp32; trainable leaves require grad
    opt_state: FedAdamState
    step: int  # lockstep counter, shared by all clients
    generators: list[torch.Generator]  # one dropout stream per client, on the device
    # FedOpt server-optimizer state (single-model leaves), None under plain
    # FedAvg. Persists across rounds; the per-round client reset leaves it.
    server_opt: dict | None = None


def init_opt_state(params: Mapping[str, torch.Tensor], num_clients: int) -> FedAdamState:
    """Zero moments for the leaves that train, count 0 for every client."""
    names = [n for n, t in params.items() if t.requires_grad]
    return FedAdamState(
        [0] * num_clients,
        {n: torch.zeros_like(params[n], requires_grad=False) for n in names},
        {n: torch.zeros_like(params[n], requires_grad=False) for n in names},
    )


def _device_batch(batch: Mapping[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    return {
        k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
        for k in ("input_ids", "attention_mask", "labels")
    }


def train_step(
    trainer, state: FedState, batch: Mapping[str, np.ndarray], anchor: Mapping[str, torch.Tensor] | None = None
) -> tuple[torch.Tensor, np.ndarray]:
    """One lockstep step of every client on a ``[C, B, ...]`` host batch;
    updates ``state`` in place and returns the ``[C]`` task losses (on the
    device) and the ``[C]`` 0/1 mask of clients that stepped.

    A ragged batch (``valid`` and ``warmup_step`` present) averages each
    client's loss over its valid rows, gates off all-padding clients and
    keys warmup on the client's own step count; a dense batch (neither)
    has every row valid and keys warmup on the lockstep counter.
    ``anchor`` (FedProx, ``fed.prox_mu > 0``): the round-start stacked
    params, pulled toward by ``mu/2 · ||w - anchor||²``."""
    C, B = batch["labels"].shape[:2]
    dev = trainer.device
    valid = batch.get("valid")
    if valid is None:
        valid = np.ones((C, B), np.int32)
        warm = np.full(C, state.step, np.int64)
    else:
        warm = np.asarray(batch["warmup_step"])[:, 0]
    has = (np.asarray(valid).sum(axis=1) > 0).astype(np.float32)
    active = [c for c in range(C) if has[c]]
    losses = torch.zeros(C, dtype=torch.float32, device=dev)
    mu = float(trainer.cfg.fed.prox_mu)
    opt = state.opt_state
    names = list(opt.mu)
    if active:
        tb = _device_batch(batch, dev)
        v = torch.from_numpy(np.ascontiguousarray(valid)).to(dev)
        rows = {n: p.unbind(0) for n, p in state.params.items()}
        anchor_rows = {n: a.unbind(0) for n, a in anchor.items()} if mu > 0.0 else None
        total = None
        for c in active:
            lane = {n: r[c] for n, r in rows.items()}
            logits = trainer._logits(
                lane, tb["input_ids"][c], tb["attention_mask"][c], generator=state.generators[c]
            )
            task = masked_loss_fn(logits, tb["labels"][c], v[c])
            obj = task
            if mu > 0.0:
                obj = task + 0.5 * mu * prox_sq(list(lane.values()), [anchor_rows[n][c] for n in lane])
            total = obj if total is None else total + obj
            losses[c] = task.detach()
        grads = torch.autograd.grad(total, [state.params[n] for n in names])
        with torch.no_grad():
            g_rows = [g.unbind(0) for g in grads]
            p_rows = [state.params[n].detach().unbind(0) for n in names]
            m_rows = [opt.mu[n].unbind(0) for n in names]
            v_rows = [opt.nu[n].unbind(0) for n in names]
            for c in active:
                opt.count[c] += 1
                adam_update(
                    trainer.cfg.train,
                    [r[c] for r in p_rows], [r[c] for r in m_rows], [r[c] for r in v_rows],
                    [g[c] for g in g_rows], opt.count[c], int(warm[c]),
                )
    state.step += 1
    return losses, has


@torch.no_grad()
def eval_step(
    trainer, stacked_params: Mapping[str, torch.Tensor], batch: Mapping[str, np.ndarray], valid: np.ndarray
) -> list[tuple[BinaryCounts | ClassCounts, torch.Tensor] | None]:
    """Every client's sufficient statistics and scores on its ``[B, ...]``
    slice of a ``[C, B, ...]`` eval batch; None for a client whose slice
    is all padding (it would add nothing: no rows, no batch to count)."""
    dev = trainer.device
    tb = _device_batch(batch, dev)
    v = torch.from_numpy(np.ascontiguousarray(valid)).to(dev)
    rows = {n: p.detach().unbind(0) for n, p in stacked_params.items()}
    out: list = []
    for c in range(v.shape[0]):
        if not valid[c].any():
            out.append(None)
            continue
        lane = {n: r[c] for n, r in rows.items()}
        logits = trainer._logits(lane, tb["input_ids"][c], tb["attention_mask"][c])
        out.append(eval_counts(logits, tb["labels"][c], v[c]))
    return out


def check_survivors(surviving: float, C: int, min_frac: float) -> None:
    """The survivor floor (zero survivors always abort: a zero-mask mean
    would zero or NaN the params)."""
    if surviving == 0.0 or surviving < min_frac * C:
        raise RuntimeError(
            f"only {int(surviving)}/{C} clients survived the round "
            f"(min_client_fraction={min_frac})"
        )


def aggregate_round(
    trainer,
    state: FedState,
    *,
    weights: np.ndarray | None = None,
    client_mask: np.ndarray | None = None,
    anchor: Mapping[str, torch.Tensor] | None = None,
    round_index: int = 0,
    enforce_min_fraction: bool = True,
) -> FedState:
    """The FedAvg round boundary, in place on ``state``: plain, weighted
    or masked FedAvg, or FedOpt over the mean update (``anchor`` = the
    round-start params, from ``round_anchor``). Enforces
    min_client_fraction unless ``enforce_min_fraction=False`` (the
    Poisson path, where the caller gates crashes itself)."""
    cfg = trainer.cfg
    C = trainer.C
    if client_mask is not None:
        check_survivors(
            float(np.asarray(client_mask).sum()),
            C,
            cfg.fed.min_client_fraction if enforce_min_fraction else 0.0,
        )
    if weights is not None:
        eff = np.asarray(weights, dtype=np.float64)
        if client_mask is not None:
            eff = eff * np.asarray(client_mask, dtype=np.float64)
        if eff.sum() <= 0.0:
            # The mean clamps its divisor; a zero weight sum would silently
            # zero every parameter.
            raise ValueError(
                "effective FedAvg weight sum is zero (all-zero weights, "
                "or every weighted client masked out)"
            )
    if trainer.server_tx is None:
        fedavg(state.params, weights, client_mask)
        return state
    if anchor is None:
        raise ValueError(
            "FedOpt aggregation needs the round-start anchor — capture it "
            "with round_anchor(state) before fit_local"
        )
    mean = weighted_mean(state.params, weights, client_mask)
    # The anchor's rows are identical (the previous round's broadcast);
    # their mean is the single-model value, computed as JAX computes it.
    anchor1 = weighted_mean(anchor)
    g = {n: anchor1[n] - mean[n] for n in mean}
    updates, state.server_opt = trainer.server_tx.update(g, state.server_opt)
    broadcast_rows(state.params, {n: anchor1[n] + updates[n] for n in anchor1})
    return state
