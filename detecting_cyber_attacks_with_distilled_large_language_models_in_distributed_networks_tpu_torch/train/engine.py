"""Single-client train/eval engine (the port of ``train/engine.py``).

One train step is ``forward -> mean softmax-CE -> backward -> clip ->
Adam(W) -> warmup -> apply``, with the optimizer written out in
``optax``'s order of operations so a step matches the JAX engine's on
the same batch:

* ``clip_by_global_norm``: ``g`` if ``norm < max`` else ``(g / norm) * max``;
* ``scale_by_adam``: ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``,
  count ``t += 1``, ``mu / (1 - b1^t)`` and ``nu / (1 - b2^t)`` (the powers
  by fp32 square-and-multiply, as XLA computes them), then
  ``mu_hat / (sqrt(nu_hat) + eps)``;
* AdamW adds ``weight_decay · param``; the learning rate scales by ``-lr``;
* the linear warmup multiplies the update by a factor of the GLOBAL step.

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
from typing import Iterator, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..config import ModelConfig, TrainConfig
from ..data.pipeline import TokenizedSplit, batch_iterator, pad_split_to_batch
from ..device import resolve_device
from ..models.distilbert import build_trainable_params, init_params, model_skeleton
from ..ops.metrics import (
    BinaryCounts,
    ClassCounts,
    binary_counts,
    class_counts,
    finalize_class_metrics,
    finalize_metrics,
)

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
    """``x ** n`` for an int ``n`` by square-and-multiply in fp32 — the
    bits XLA gives ``decay ** count`` in optax's bias correction."""
    acc, base = np.float32(1.0), np.float32(x)
    while n:
        if n & 1:
            acc = np.float32(acc * base)
        base = np.float32(base * base)
        n >>= 1
    return acc


def bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - _pow_f32(decay, count))


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over fp32 logits."""
    return F.cross_entropy(logits.float(), labels.long())


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

    def train_step(self, state: TrainState, batch: dict) -> tuple[TrainState, torch.Tensor]:
        """One SGD step on a host batch; returns the state (updated in
        place) and the batch's loss as a device scalar."""
        ids, mask, labels = self._batch(batch)
        names = list(state.opt_state.mu)
        loss = loss_fn(self._logits(state.params, ids, mask, generator=state.generator), labels)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        with torch.no_grad():
            state.opt_state = self._apply(state, names, list(grads))
        state.step += 1
        return state, loss.detach()

    def _apply(self, state: TrainState, names: list[str], grads: list) -> AdamState:
        cfg = self.train_cfg
        params = [state.params[n] for n in names]
        mus = [state.opt_state.mu[n] for n in names]
        nus = [state.opt_state.nu[n] for n in names]
        if cfg.max_grad_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < cfg.max_grad_norm
            grads = [torch.where(keep, g, (g / g_norm) * cfg.max_grad_norm) for g in grads]
        torch._foreach_mul_(mus, cfg.b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - cfg.b1))
        torch._foreach_mul_(nus, cfg.b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - cfg.b2))
        count = state.opt_state.count + 1
        mu_hat = torch._foreach_div(mus, bias_correction(cfg.b1, count))
        nu_hat = torch._foreach_div(nus, bias_correction(cfg.b2, count))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, cfg.eps)
        updates = torch._foreach_div(mu_hat, den)
        if cfg.weight_decay > 0.0:
            torch._foreach_add_(updates, torch._foreach_mul(params, cfg.weight_decay))
        torch._foreach_mul_(updates, -cfg.learning_rate)
        w = warmup_factor(state.step, cfg.warmup_steps)
        if cfg.warmup_steps > 0:
            torch._foreach_mul_(updates, w)
        torch._foreach_add_(params, updates)
        return AdamState(count, state.opt_state.mu, state.opt_state.nu)

    def epoch_batches(self, split: TokenizedSplit, epoch: int, batch_size: int) -> Iterator[dict]:
        """The epoch's shuffled batches, seeded as the JAX engine seeds them."""
        return batch_iterator(
            split,
            batch_size,
            shuffle=True,
            seed=self.train_cfg.seed * 100_003 + epoch,
            drop_remainder=self.drop_remainder,
        )

    def fit(
        self,
        state: TrainState,
        split: TokenizedSplit,
        *,
        batch_size: int = 16,
        epochs: int | None = None,
        tag: str = "",
    ) -> tuple[TrainState, list[float]]:
        """Train for E epochs; returns the state and each epoch's mean
        loss. Losses stay on the device until the epoch's end."""
        epochs = self.train_cfg.epochs_per_round if epochs is None else epochs
        log_every = self.train_cfg.log_every
        epoch_losses: list[float] = []
        steps, samples, t0 = 0, 0, time.perf_counter()
        for epoch in range(epochs):
            losses: list[torch.Tensor] = []
            for batch in self.epoch_batches(split, epoch, batch_size):
                state, loss = self.train_step(state, batch)
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
            log.info(f"{tag}Epoch [{epoch + 1}/{epochs}], Average Loss: {avg:.4f}")
        return state, epoch_losses

    # ------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(
        self,
        params: dict[str, torch.Tensor],
        split: TokenizedSplit,
        *,
        batch_size: int = 16,
    ) -> dict:
        """Five reference metrics + confusion matrix (+ labels and probs
        of the valid rows, the reference's evaluate_model return shape)."""
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
