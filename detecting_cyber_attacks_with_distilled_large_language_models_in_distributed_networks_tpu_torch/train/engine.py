"""Single-client train/eval engine (the port of ``train/engine.py``).

One train step is ``forward -> mean softmax-CE -> backward -> clip ->
Adam(W) -> warmup -> apply``, with the optimizer written out in
``optax``'s order of operations so a step matches the JAX engine's on
the same batch:

* ``clip_by_global_norm``: ``g`` if ``norm < max`` else ``(g / norm) * max``;
* ``scale_by_adam``: ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``,
  count ``t += 1``, ``mu / (1 - b1^t)`` and ``nu / (1 - b2^t)`` (the powers
  rounded once to fp32, as XLA's ``pow`` computes them), then
  ``mu_hat / (sqrt(nu_hat) + eps)``;
* AdamW adds ``weight_decay · param``; the learning rate scales by ``-lr``;
* the linear warmup multiplies the update by a factor of the GLOBAL step.

With ``TrainConfig.prox_mu > 0`` (FedProx, the TCP client's local phase)
the step's loss adds ``0.5 · mu · ||params - anchor||²``, the anchor being
the round's start: the last adopted aggregate, or the fit-entry params
before any round. The proximal term is plain torch, as it is plain XLA in
the JAX engine.

``trainable="head"`` is ``optax.multi_transform``: the encoder's leaves
are frozen (no gradient, no moments, no update) and the clip norm covers
the head alone. Parameters are updated in place under ``no_grad``: the
state owns fresh copies (``init_state`` never aliases its input).

Evaluation accumulates on-device sufficient statistics per batch
(:mod:`..ops.metrics`) over a split padded to the batch size; pad rows
(all-zero attention mask) go through the model and are masked out of the
counts, as in the JAX engine.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Iterator, Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..config import ModelConfig, TrainConfig
from ..data.pipeline import TokenizedSplit, batch_iterator, pad_split_to_batch
from ..device import resolve_device
from ..models.convert import params_from_jax, params_to_jax
from ..models.distilbert import build_trainable_params, init_params, model_skeleton
from ..ops.metrics import (
    BinaryCounts,
    ClassCounts,
    binary_counts,
    class_counts,
    finalize_class_metrics,
    finalize_metrics,
)
from .batches import EpochPrefetcher, PrefetchSlot

log = logging.getLogger(__name__)


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` over the trainable leaves."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # every leaf, fp32; trainable ones require grad
    opt_state: AdamState
    step: int  # global step: the warmup factor reads it
    generator: torch.Generator  # the dropout stream, on the training device


def warmup_factor(step: int, warmup_steps: int) -> float:
    """Linear LR warmup multiplier of the GLOBAL step, in fp32."""
    if warmup_steps <= 0:
        return 1.0
    w = np.float32(step + 1) / np.float32(warmup_steps)
    return float(min(np.float32(1.0), w))


def _pow_f32(x: float, n: int) -> np.float32:
    """``x ** n`` for an int ``n``, rounded once to fp32: the bits XLA's
    ``pow`` gives ``decay ** count`` in optax's bias correction (fp64 holds
    the power to well under an fp32 ulp; a subnormal result, which XLA
    flushes to 0, leaves ``1 - x**n`` at 1 either way)."""
    return np.float32(np.float64(np.float32(x)) ** int(n))


def bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - _pow_f32(decay, count))


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over fp32 logits."""
    return F.cross_entropy(logits.float(), labels.long())


def masked_loss_fn(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy averaged over the ``valid`` rows only (0 for
    an all-padding batch): :func:`loss_fn` on the valid subset, the
    ragged federated step's objective."""
    per_example = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    v = valid.to(torch.float32)
    return (per_example * v).sum() / torch.clamp(v.sum(), min=1.0)


def prox_sq(params: list[torch.Tensor], anchor: list[torch.Tensor]) -> torch.Tensor:
    """FedProx squared distance ``sum ||p - anchor||^2`` over paired leaves."""
    return sum(torch.sum(torch.square(p - a)) for p, a in zip(params, anchor))


def adam_update(
    cfg: TrainConfig,
    params: list[torch.Tensor],
    mus: list[torch.Tensor],
    nus: list[torch.Tensor],
    grads: list[torch.Tensor],
    count: int,
    warmup_step: int,
) -> None:
    """One optax clip -> Adam(W) -> lr -> warmup step, in place on
    ``params``, ``mus`` and ``nus`` (call under ``no_grad``). ``count``
    is Adam's incremented count (its bias corrections); ``warmup_step``
    the step the warmup factor reads."""
    if cfg.max_grad_norm is not None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < cfg.max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * cfg.max_grad_norm) for g in grads]
    torch._foreach_mul_(mus, cfg.b1)
    torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - cfg.b1))
    torch._foreach_mul_(nus, cfg.b2)
    torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - cfg.b2))
    mu_hat = torch._foreach_div(mus, bias_correction(cfg.b1, count))
    nu_hat = torch._foreach_div(nus, bias_correction(cfg.b2, count))
    den = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(den, cfg.eps)
    updates = torch._foreach_div(mu_hat, den)
    if cfg.weight_decay > 0.0:
        torch._foreach_add_(updates, torch._foreach_mul(params, cfg.weight_decay))
    torch._foreach_mul_(updates, -cfg.learning_rate)
    if cfg.warmup_steps > 0:
        torch._foreach_mul_(updates, warmup_factor(warmup_step, cfg.warmup_steps))
    torch._foreach_add_(params, updates)


def eval_counts(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor
) -> tuple[BinaryCounts | ClassCounts, torch.Tensor]:
    """Masked batch-mean loss + sufficient statistics + a scalar score per
    row: ``P(class 1)`` for K = 2, ``1 - P(class 0)`` (any attack) for
    K > 2."""
    logits = logits.float()
    labels = labels.long()
    per_example = F.cross_entropy(logits, labels, reduction="none")
    v = valid.to(torch.float32)
    loss = (per_example * v).sum() / torch.clamp(v.sum(), min=1.0)
    probs = torch.softmax(logits, dim=-1)
    if int(logits.shape[-1]) == 2:
        return binary_counts(logits, labels, loss, valid), probs[:, 1]
    return class_counts(logits, labels, loss, valid), 1.0 - probs[:, 0]


class Trainer:
    """Single-client engine: fit for E epochs, evaluate with full metrics.

    Runs on the card unless ``device="cpu"`` is given (no CUDA raises)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        *,
        pad_id: int = 0,
        drop_remainder: bool = True,
        device: str | torch.device | None = None,
    ):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.pad_id = pad_id
        self.drop_remainder = drop_remainder
        self.device = resolve_device(device)
        # The module holds no storage (meta device): every call passes the
        # state's leaves through functional_call.
        self.model = model_skeleton(model_cfg)
        # One-slot epoch prefetch: the TCP round loop arms it before the
        # exchange, so the next epoch's first batches are built while the
        # client waits for the aggregate.
        self._prefetch = PrefetchSlot()
        # FedProx anchor (prox_mu > 0): copies of the trainable leaves at
        # the round's start.
        self._prox_anchor: dict[str, torch.Tensor] | None = None

    # ------------------------------------------------------------ state
    def init_state(self, seed: int | None = None, params=None) -> TrainState:
        """Fresh state: ``params`` (a state dict, e.g. from
        ``params_from_jax``) or a seeded init, zero moments, step 0 and
        a dropout generator on the training device."""
        seed = self.train_cfg.seed if seed is None else seed
        if params is None:
            params = init_params(self.model_cfg, torch.Generator().manual_seed(seed))
        leaves = build_trainable_params(
            self.model_cfg, params, self.device, trainable=self.train_cfg.trainable
        )
        names = [n for n, t in leaves.items() if t.requires_grad]
        opt = AdamState(
            0,
            {n: torch.zeros_like(leaves[n]) for n in names},
            {n: torch.zeros_like(leaves[n]) for n in names},
        )
        generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        return TrainState(leaves, opt, 0, generator)

    # ------------------------------------------------------------ steps
    def _batch(self, batch: dict) -> tuple[torch.Tensor, ...]:
        return tuple(
            torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device)
            for k in ("input_ids", "attention_mask", "labels")
        )

    def _logits(self, params, ids, mask, *, generator=None) -> torch.Tensor:
        return functional_call(
            self.model, params, (ids, mask),
            {"deterministic": generator is None, "generator": generator},
        )

    def train_step(
        self, state: TrainState, batch: dict, anchor: Mapping[str, torch.Tensor] | None = None
    ) -> tuple[TrainState, torch.Tensor]:
        """One SGD step on a host batch; returns the state (updated in
        place) and the batch's loss as a device scalar. With ``anchor``
        (FedProx) the loss adds ``0.5 · prox_mu · ||params - anchor||²``
        over the trainable leaves."""
        ids, mask, labels = self._batch(batch)
        names = list(state.opt_state.mu)
        loss = loss_fn(self._logits(state.params, ids, mask, generator=state.generator), labels)
        if anchor is not None:
            mu = float(self.train_cfg.prox_mu)
            loss = loss + 0.5 * mu * prox_sq([state.params[n] for n in names], [anchor[n] for n in names])
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        with torch.no_grad():
            state.opt_state = self._apply(state, names, list(grads))
        state.step += 1
        return state, loss.detach()

    def _apply(self, state: TrainState, names: list[str], grads: list) -> AdamState:
        count = state.opt_state.count + 1
        adam_update(
            self.train_cfg,
            [state.params[n] for n in names],
            [state.opt_state.mu[n] for n in names],
            [state.opt_state.nu[n] for n in names],
            grads, count, state.step,
        )
        return AdamState(count, state.opt_state.mu, state.opt_state.nu)

    def epoch_batches(self, split: TokenizedSplit, epoch: int, batch_size: int) -> Iterator[dict]:
        """The epoch's shuffled batches, seeded as the JAX engine seeds
        them; a matching armed prefetch (:meth:`prefetch_epoch`) serves
        the head, so the sequence is the same either way."""
        it = self._prefetch.consume((id(split), int(epoch), int(batch_size)))
        if it is not None:
            return it
        return self._epoch_iterator(split, epoch, batch_size)

    def _epoch_iterator(self, split: TokenizedSplit, epoch: int, batch_size: int) -> Iterator[dict]:
        return batch_iterator(
            split,
            batch_size,
            shuffle=True,
            seed=self.train_cfg.seed * 100_003 + epoch,
            drop_remainder=self.drop_remainder,
        )

    def prefetch_epoch(self, split: TokenizedSplit, epoch: int, batch_size: int) -> EpochPrefetcher:
        """Arm the one-slot prefetch for ``epoch``: its permutation and
        first batches are built on a thread now (the TCP client arms it
        right before it blocks on the exchange). The next matching
        :meth:`epoch_batches` consumes it."""
        return self._prefetch.arm(
            (id(split), int(epoch), int(batch_size)),
            lambda: self._epoch_iterator(split, epoch, batch_size),
        )

    def _round_anchor(self, state: TrainState) -> dict[str, torch.Tensor]:
        """The FedProx anchor of this fit: the last adopted aggregate, or
        (before any round) a copy of the fit-entry params, where the
        proximal term starts at zero."""
        if self._prox_anchor is None:
            self._prox_anchor = {n: state.params[n].detach().clone() for n in state.opt_state.mu}
        return self._prox_anchor

    def fit(
        self,
        state: TrainState,
        split: TokenizedSplit,
        *,
        batch_size: int = 16,
        epochs: int | None = None,
        epoch_offset: int = 0,
        tag: str = "",
    ) -> tuple[TrainState, list[float]]:
        """Train for E epochs; returns the state and each epoch's mean
        loss. Losses stay on the device until the epoch's end.
        ``epoch_offset`` shifts the shuffle seeds (a round loop passes
        ``round * E``), so every round draws new batch permutations."""
        epochs = self.train_cfg.epochs_per_round if epochs is None else epochs
        anchor = self._round_anchor(state) if self.train_cfg.prox_mu > 0.0 else None
        log_every = self.train_cfg.log_every
        epoch_losses: list[float] = []
        steps, samples, t0 = 0, 0, time.perf_counter()
        for epoch in range(epoch_offset, epoch_offset + epochs):
            losses: list[torch.Tensor] = []
            for batch in self.epoch_batches(split, epoch, batch_size):
                state, loss = self.train_step(state, batch, anchor)
                losses.append(loss)
                steps += 1
                samples += len(batch["labels"])
                if log_every and steps % log_every == 0:
                    mean = float(torch.stack(losses[-log_every:]).mean())
                    now = time.perf_counter()
                    log.info(f"{tag}Step {steps}: loss {mean:.4f} "
                             f"({samples / max(now - t0, 1e-9):.1f} samples/s)")
                    samples, t0 = 0, now
            avg = float(torch.stack(losses).mean()) if losses else 0.0
            epoch_losses.append(avg)
            log.info(f"{tag}Epoch [{epoch - epoch_offset + 1}/{epochs}], Average Loss: {avg:.4f}")
        return state, epoch_losses

    # ------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(
        self,
        params: Mapping[str, Any],
        split: TokenizedSplit,
        *,
        batch_size: int = 16,
    ) -> dict:
        """Five reference metrics + confusion matrix (+ labels and probs
        of the valid rows, the reference's evaluate_model return shape).

        ``params``: a state's leaves, or a nested JAX-layout tree of host
        arrays (a round's aggregate, as ``FederatedClient.exchange``
        returns it), which is converted through ``params_from_jax``."""
        if any(isinstance(v, Mapping) for v in params.values()):
            params = build_trainable_params(self.model_cfg, params_from_jax(params), self.device)
        padded, valid = pad_split_to_batch(split, batch_size, pad_id=self.pad_id)
        totals: BinaryCounts | ClassCounts | None = None
        probs_dev: list[torch.Tensor] = []
        for start in range(0, len(padded), batch_size):
            sl = slice(start, start + batch_size)
            ids, mask, labels = self._batch({
                "input_ids": padded.input_ids[sl],
                "attention_mask": padded.attention_mask[sl],
                "labels": padded.labels[sl],
            })
            v = torch.from_numpy(valid[sl]).to(self.device)
            counts, probs = eval_counts(self._logits(params, ids, mask), labels, v)
            totals = counts if totals is None else totals + counts
            probs_dev.append(probs)
        if totals is None:
            totals = BinaryCounts.zero(self.device)
        metrics = (
            finalize_class_metrics(totals)
            if isinstance(totals, ClassCounts)
            else finalize_metrics(totals)
        )
        all_probs = torch.cat(probs_dev).cpu().numpy() if probs_dev else np.array([])
        metrics["probs"] = all_probs[valid == 1] if probs_dev else all_probs
        metrics["labels"] = split.labels.copy()
        return metrics

    def evaluate_state(self, state: TrainState, split: TokenizedSplit, **kw: Any) -> dict:
        """Metrics of the live training state."""
        return self.evaluate(state.params, split, **kw)

    # ------------------------------------------------------------ rounds
    def host_params(self, state: TrainState, *, lazy: bool = False) -> dict:
        """The state's params as the JAX-layout nested tree of host numpy
        fp32 arrays (flax names, dense kernels ``[in, out]``): the upload
        form ``FederatedClient.exchange`` sends. The arrays are copies;
        ``lazy`` returns ``HostLeaf`` leaves, each copied off the card when
        first read (the streamed upload gathers leaf by leaf)."""
        return params_to_jax(state.params, lazy=lazy)

    def adopt_aggregate(self, state: TrainState, aggregated: Mapping[str, Any]) -> TrainState:
        """Continue the next round FROM a received aggregate (JAX layout)
        with a fresh Adam (every reference re-launch builds a new
        optimizer, client1.py:380) and a continuing step counter, so the
        LR warmup does not restart: the JAX package's
        ``adopt_aggregate_with_fresh_opt``. Under FedProx the adopted
        aggregate is the next round's anchor."""
        new = self.init_state(params=params_from_jax(aggregated))
        new.step = state.step
        if self.train_cfg.prox_mu > 0.0:
            self._prox_anchor = {n: new.params[n].detach().clone() for n in new.opt_state.mu}
        return new
