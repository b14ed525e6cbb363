"""FedAvg over a stacked ``[C, ...]`` parameter dict (the port of the JAX
package's ``parallel/fedavg.py``).

The reference's aggregation is a Python loop computing an unweighted mean
of two pickled state dicts (server.py:67-79). Here every client's
parameters live in one stacked leaf per tensor on the card, and the round
boundary is a weighted, masked fp32 mean over the leading axis, written
back into every client's row:

* weighted FedAvg (weights = client sample counts);
* masked FedAvg (dropped or unsampled clients excluded from the mean).

The FedOpt server optimizers (FedAvgM, FedAdam, FedYogi) are written
out in ``optax``'s order of operations with its defaults, so a round
matches the JAX package's on the same inputs; the port imports no optax.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..train.engine import bias_correction


def stack_params(params: Mapping[str, torch.Tensor], num_clients: int) -> dict[str, torch.Tensor]:
    """Single-model params -> ``[C, ...]`` leaves, every row a copy of the
    same weights (the reference's shared pretrained start, client1.py:56).
    The rows are real copies, not an ``expand`` view: training updates
    each client's row in place."""
    return {
        n: t.detach().unsqueeze(0).repeat(num_clients, *([1] * t.ndim))
        for n, t in params.items()
    }


def _client_weights(C: int, weights, mask, device) -> torch.Tensor:
    """``w / max(sum w, 1e-9)`` in fp32, with the mask folded into w —
    the JAX package's arithmetic, step for step."""
    w = torch.ones(C, dtype=torch.float32) if weights is None else torch.as_tensor(
        np.asarray(weights), dtype=torch.float32
    )
    if mask is not None:
        w = w * torch.as_tensor(np.asarray(mask), dtype=torch.float32)
    return (w / torch.clamp(w.sum(), min=1e-9)).to(device)


@torch.no_grad()
def weighted_mean(
    stacked_params: Mapping[str, torch.Tensor],
    weights: Any | None = None,
    mask: Any | None = None,
) -> dict[str, torch.Tensor]:
    """Weighted, masked fp32 mean over the leading (clients) axis: the
    single-model result, not broadcast back (:func:`fedavg` does that).

    ``weights``: ``[C]`` client weights (uniform if None, the reference's
    unweighted mean, server.py:73-76). ``mask``: ``[C]`` 0/1 survivors;
    a masked-out client contributes nothing and the divisor shrinks."""
    if not stacked_params:
        return {}
    first = next(iter(stacked_params.values()))
    wn = _client_weights(int(first.shape[0]), weights, mask, first.device)
    return {n: (x * wn.view(-1, *([1] * (x.ndim - 1)))).sum(0) for n, x in stacked_params.items()}


@torch.no_grad()
def broadcast_rows(stacked_params: Mapping[str, torch.Tensor], single: Mapping[str, torch.Tensor]) -> None:
    """Write each single-model leaf into every client row of its stacked
    leaf, in place (``copy_`` into the stacked buffer: an ``expand`` view
    shared by C clients would be updated C times by the next in-place
    optimizer step)."""
    for n, x in stacked_params.items():
        x.copy_(single[n].to(x.dtype).unsqueeze(0).expand_as(x))


def fedavg(
    stacked_params: Mapping[str, torch.Tensor],
    weights: Any | None = None,
    mask: Any | None = None,
) -> Mapping[str, torch.Tensor]:
    """:func:`weighted_mean` written back into every client's row (in
    place); returns ``stacked_params``."""
    broadcast_rows(stacked_params, weighted_mean(stacked_params, weights, mask))
    return stacked_params


class ServerOptimizer:
    """The FedOpt server optimizer over the round's pseudo-gradient, in
    ``optax``'s order of operations with its defaults:

    * ``momentum`` = ``optax.sgd(lr, momentum)``: ``trace = g + m·trace``,
      update ``-lr·trace``;
    * ``adam`` = ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8):
      ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, update
      ``-lr · mu_hat / (sqrt(nu_hat) + eps)`` with bias corrections of the
      incremented count;
    * ``yogi`` = ``optax.yogi(lr)`` (b1 0.9, b2 0.999, eps 1e-3, both
      moments starting at 1e-6): ``nu = nu - (1-b2)·sign(nu - g²)·g²``,
      otherwise as adam.

    State is a dict of fp32 single-model leaves (and ``count``), so it
    checkpoints with ``torch.save``."""

    B1, B2 = 0.9, 0.999

    def __init__(self, kind: str, lr: float, momentum: float = 0.9):
        if kind not in ("momentum", "adam", "yogi"):
            raise ValueError(f"unknown server optimizer {kind!r} (momentum|adam|yogi)")
        self.kind, self.lr, self.momentum = kind, float(lr), float(momentum)
        self.eps = 1e-3 if kind == "yogi" else 1e-8

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        if self.kind == "momentum":
            return {"trace": {n: torch.zeros_like(t, dtype=torch.float32) for n, t in params.items()}}
        fill = 1e-6 if self.kind == "yogi" else 0.0
        return {
            "count": 0,
            "mu": {n: torch.full_like(t, fill, dtype=torch.float32) for n, t in params.items()},
            "nu": {n: torch.full_like(t, fill, dtype=torch.float32) for n, t in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict) -> tuple[dict, dict]:
        """``(updates, new_state)``; ``params + updates`` is the new global."""
        if self.kind == "momentum":
            trace = {n: g + self.momentum * state["trace"][n] for n, g in grads.items()}
            return {n: t * -self.lr for n, t in trace.items()}, {"trace": trace}
        b1, b2 = self.B1, self.B2
        count = int(state["count"]) + 1
        c1, c2 = bias_correction(b1, count), bias_correction(b2, count)
        mu, nu, updates = {}, {}, {}
        for n, g in grads.items():
            mu[n] = (1 - b1) * g + b1 * state["mu"][n]
            g2 = g * g
            v = state["nu"][n]
            if self.kind == "yogi":
                nu[n] = v - ((1 - b2) * torch.sign(v - g2)) * g2
            else:
                nu[n] = (1 - b2) * g2 + b2 * v
            updates[n] = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + self.eps) * -self.lr
        return updates, {"count": count, "mu": mu, "nu": nu}


def make_server_optimizer(fed_cfg) -> ServerOptimizer | None:
    """The FedOpt server optimizer of ``fed_cfg.server_opt`` ("momentum" =
    FedAvgM, "adam" = FedAdam, "yogi" = FedYogi), or None for plain
    FedAvg. At server_lr=1 with no momentum a step is plain FedAvg."""
    if fed_cfg.server_opt == "none":
        return None
    return ServerOptimizer(fed_cfg.server_opt, fed_cfg.server_lr, fed_cfg.server_momentum)
