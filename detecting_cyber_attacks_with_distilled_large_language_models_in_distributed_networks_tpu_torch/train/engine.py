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

The update itself is :mod:`..ops.adam`: on the card one multi-tensor
kernel over every leaf, on the CPU the chain as ``_foreach_*`` passes;
the two agree bit for bit.

With ``TrainConfig.grad_accum_steps = k > 1`` the chain runs inside
``optax.MultiSteps``: every micro step folds its gradients into a running
mean, ``acc + (g - acc) / (mini_step + 1)``, and only the k-th applies
clip -> Adam(W) -> warmup to that mean (Adam's count advances there
alone; the warmup reads the emitting micro step's global step). The
global step advances every micro step, and the accumulator and
``mini_step`` carry across epoch ends, as MultiSteps' state does.

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

The device performance plane (:mod:`..obs.profile`) rides the same
sites as in the JAX engine: the dispatch ledger notes the first train
and eval step of each batch shape (``engine.train_step``,
``engine.eval_step``), and with ``--profile-stride`` the fit loop fences
every Nth step into host / dispatch / device timers and snapshots device
memory after its first step.

Every train step also appends a phase record to the process-wide
``engine.train_step`` log: ``place`` (the batch onto the device),
``forward`` (logits, the loss and any proximal term), ``backward``
(``torch.autograd.grad``) and ``optimizer`` (the update under
``no_grad``). Each phase is the host time that queues its kernels; the
four sum to the call. The trainer keeps the last one as
``last_step_record``, which a sampled fit step's dispatch time is read
from.
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
from ..obs.profile import (
    default_ledger,
    maybe_step_profiler,
    note_memory,
    phase_clock,
    phase_log,
    profiled_step_iter,
    shape_signature,
)
from ..ops.adam import AdamStep, adam
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

#: One record a train step (``Trainer`` and its subclasses that keep its
#: step), shared by every trainer in the process.
STEP_PHASES = phase_log("engine.train_step", ("place", "forward", "backward", "optimizer"))


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` over the trainable leaves."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # every leaf, fp32; trainable ones require grad
    opt_state: AdamState
    step: int  # global step (every micro step): the warmup factor reads it
    generator: torch.Generator  # the dropout stream, on the training device
    # optax.MultiSteps' state under grad_accum_steps > 1: the running mean
    # of the window's gradients (trainable leaves) and the micro steps it
    # holds. None and 0 without accumulation.
    acc: dict[str, torch.Tensor] | None = None
    mini_step: int = 0


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
    g_norm: torch.Tensor | None = None,
) -> None:
    """One optax clip -> Adam(W) -> lr -> warmup step, in place on
    ``params``, ``mus`` and ``nus`` (call under ``no_grad``). ``count``
    is Adam's incremented count (its bias corrections); ``warmup_step``
    the step the warmup factor reads. ``g_norm``: the global gradient
    norm when ``grads`` are only part of the gradient (one slot's FSDP
    shards); by default the norm of ``grads``. Leaves on the card take
    the multi-tensor kernel, leaves on the CPU the ``_foreach_*`` chain
    (:mod:`..ops.adam`)."""
    step = AdamStep(
        cfg.b1, cfg.b2, cfg.eps, cfg.learning_rate,
        bias_correction(cfg.b1, count), bias_correction(cfg.b2, count),
        weight_decay=cfg.weight_decay,
        warmup=warmup_factor(warmup_step, cfg.warmup_steps) if cfg.warmup_steps > 0 else None,
        max_norm=cfg.max_grad_norm,
    )
    adam(step, params, mus, nus, grads, g_norm)


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
        # Dispatch ledger (obs/profile.py): the first step of each batch
        # shape is noted, with its wall seconds.
        ledger = default_ledger()
        self._timed_step = ledger.timed("engine.train_step", self._train_step, signature=shape_signature)
        self._timed_eval = ledger.timed(
            "engine.eval_step", self._eval_batch, signature=lambda params, ids, *a: tuple(ids.shape)
        )
        # Step-time attribution: None unless profiling is armed
        # process-wide (--profile-stride); re-checked at fit time.
        self.step_profiler = maybe_step_profiler("train")
        # The phase record of this trainer's last step (None before one,
        # and for a subclass whose own step keeps none).
        self.last_step_record = None

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
        acc = None
        if self.train_cfg.grad_accum_steps > 1:
            acc = {n: torch.zeros_like(leaves[n]) for n in names}
        return TrainState(leaves, opt, 0, generator, acc)

    # ------------------------------------------------------------ steps
    def _batch(self, batch: dict) -> tuple[torch.Tensor, ...]:
        return tuple(
            batch[k].to(self.device) if isinstance(batch[k], torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device)
            for k in ("input_ids", "attention_mask", "labels")
        )

    def place_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """A host batch's ``input_ids``/``attention_mask``/``labels`` on the
        training device (what :meth:`train_step` does first); a placed
        batch goes through :meth:`train_step` without another copy."""
        return dict(zip(("input_ids", "attention_mask", "labels"), self._batch(batch)))

    def _logits(self, params, ids, mask, *, generator=None) -> torch.Tensor:
        return functional_call(
            self.model, params, (ids, mask),
            {"deterministic": generator is None, "generator": generator},
        )

    def _loss(self, logits: torch.Tensor, ids, mask, labels) -> torch.Tensor:
        """The step's objective on the student's logits (the distillation
        trainer puts its KD loss here)."""
        return loss_fn(logits, labels)

    def train_step(
        self, state: TrainState, batch: dict, anchor: Mapping[str, torch.Tensor] | None = None
    ) -> tuple[TrainState, torch.Tensor]:
        """One SGD step on a host batch; returns the state (updated in
        place) and the batch's loss as a device scalar. With ``anchor``
        (FedProx) the loss adds ``0.5 · prox_mu · ||params - anchor||²``
        over the trainable leaves."""
        return self._timed_step(state, batch, anchor)

    def _train_step(self, state: TrainState, batch: dict, anchor=None) -> tuple[TrainState, torch.Tensor]:
        t0 = phase_clock()
        ids, mask, labels = self._batch(batch)
        t_place = phase_clock()
        names = list(state.opt_state.mu)
        logits = self._logits(state.params, ids, mask, generator=state.generator)
        loss = self._loss(logits, ids, mask, labels)
        if anchor is not None:
            mu = float(self.train_cfg.prox_mu)
            loss = loss + 0.5 * mu * prox_sq([state.params[n] for n in names], [anchor[n] for n in names])
        t_forward = phase_clock()
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        t_backward = phase_clock()
        with torch.no_grad():
            self._update(state, names, list(grads))
        state.step += 1
        self.last_step_record = STEP_PHASES.record(self, t0, (t_place, t_forward, t_backward, phase_clock()))
        return state, loss.detach()

    def _update(self, state: TrainState, names: list[str], grads: list) -> None:
        """Apply one micro step's gradients: directly, or (accumulation)
        into the running mean, applied on the window's last micro step."""
        k = self.train_cfg.grad_accum_steps
        if k <= 1:
            state.opt_state = self._apply(state, names, grads)
            return
        acc = [state.acc[n] for n in names]
        torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(grads, acc), float(state.mini_step + 1)))
        if state.mini_step < k - 1:
            state.mini_step += 1
            return
        state.opt_state = self._apply(state, names, acc)
        torch._foreach_zero_(acc)
        state.mini_step = 0

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

    def step_profile_attrs(self) -> dict:
        """The last fit's sampled step attrs (``step_*_ms_p50/p95``) for
        the client-local span; {} when profiling is off."""
        prof = self.step_profiler
        return prof.span_attrs() if prof is not None else {}

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
        prof = self._armed_profiler()
        first_memory = prof is not None
        last_loss = None  # carried ACROSS epochs: the drain fence's target
        for epoch in range(epoch_offset, epoch_offset + epochs):
            losses: list[torch.Tensor] = []
            for batch, sampled in profiled_step_iter(prof, self.epoch_batches(split, epoch, batch_size)):
                if sampled:
                    # Fenced sampled step: drain the queue so the
                    # measurement is this step's own, then split dispatch
                    # (the step's phase record, or the clock around a
                    # step that keeps none) from the wait for the card.
                    prof.drain(last_loss)
                    before, td = self.last_step_record, prof.clock()
                    state, loss = self.train_step(state, batch, anchor)
                    if self.last_step_record is not before:
                        prof.note_record(self.last_step_record)
                    else:
                        prof.note_dispatch(prof.clock() - td)
                    prof.fence(loss)
                else:
                    state, loss = self.train_step(state, batch, anchor)
                last_loss = loss
                if first_memory:
                    first_memory = False
                    note_memory("post-first-step")
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
            params = build_trainable_params(self.model_cfg, self.wire_params(params), self.device)
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
            counts, probs = self._timed_eval(params, ids, mask, labels, v)
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

    def _eval_batch(self, params, ids, mask, labels, valid) -> tuple[BinaryCounts | ClassCounts, torch.Tensor]:
        return eval_counts(self._logits(params, ids, mask), labels, valid)

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

    def wire_params(self, tree: Mapping[str, Any]) -> dict:
        """A received aggregate (the JAX-layout tree) as a port state dict."""
        return params_from_jax(tree)

    def adopt_aggregate(self, state: TrainState, aggregated: Mapping[str, Any]) -> TrainState:
        """Continue the next round FROM a received aggregate (JAX layout)
        with a fresh Adam (every reference re-launch builds a new
        optimizer, client1.py:380) and a continuing step counter, so the
        LR warmup does not restart: the JAX package's
        ``adopt_aggregate_with_fresh_opt``. Under FedProx the adopted
        aggregate is the next round's anchor."""
        new = self.init_state(params=self.wire_params(aggregated))
        new.step = state.step
        if self.train_cfg.prox_mu > 0.0:
            self._prox_anchor = {n: new.params[n].detach().clone() for n in new.opt_state.mu}
        return new
