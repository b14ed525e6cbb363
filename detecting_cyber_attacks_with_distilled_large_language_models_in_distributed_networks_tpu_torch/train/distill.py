"""Knowledge distillation, teacher -> student (the port of the JAX
package's ``train/distill.py``).

The reference only consumes a pre-distilled encoder (HF DistilBERT,
client1.py:56); here the recipe itself trains: a deeper teacher's soft
targets supervise the student through a temperature-T KL term blended
with hard-label CE (``DistillConfig.alpha``), and the student can start
from every other teacher layer (the published DistilBERT init).

One distill step is the :class:`~.engine.Trainer` step with the KD loss
in place of CE: the teacher's forward runs in eval mode under
``torch.no_grad`` (attention at dropout rate 0, no autograd state kept),
then the student's forward and backward with dropout, then the same
clip -> Adam(W) -> warmup update (gradient accumulation included).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..config import DistillConfig, ModelConfig, TrainConfig
from ..data.pipeline import TokenizedSplit
from ..models.distilbert import model_skeleton
from .engine import Trainer, TrainState


def distillation_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    temperature: float,
    alpha: float,
) -> torch.Tensor:
    """``alpha * T^2 * KL(teacher_T || student_T) + (1 - alpha) * CE``.

    The T^2 factor keeps the soft-target gradient's size independent of T
    (Hinton et al., as the DistilBERT recipe). In fp32."""
    s = student_logits.float()
    t = teacher_logits.float()
    log_p_t = F.log_softmax(t / temperature, dim=-1)
    log_p_s = F.log_softmax(s / temperature, dim=-1)
    kl = (torch.exp(log_p_t) * (log_p_t - log_p_s)).sum(dim=-1).mean()
    ce = F.cross_entropy(s, labels.long())
    return alpha * temperature * temperature * kl + (1.0 - alpha) * ce


def _layer_count(params: Mapping[str, torch.Tensor]) -> int:
    return len({k.split(".")[1] for k in params if k.startswith("encoder.layer_")})


def init_student_from_teacher(
    student_params: Mapping[str, torch.Tensor],
    teacher_params: Mapping[str, torch.Tensor],
    *,
    stride: int,
) -> dict[str, torch.Tensor]:
    """The DistilBERT init: student layer ``i`` <- teacher layer
    ``i * stride``, the embeddings and the head copied as they are. Every
    leaf is a fresh copy (on the teacher leaf's device): a student tensor
    sharing storage with the teacher's would let Adam's in-place update
    train the teacher too. Widths must match; a shape mismatch raises, so
    an uninitialized student never trains."""
    n_student = _layer_count(student_params)
    n_teacher = _layer_count(teacher_params)
    if (n_student - 1) * stride >= n_teacher:
        raise ValueError(
            f"stride {stride} maps student layer {n_student - 1} to teacher "
            f"layer {(n_student - 1) * stride}, but teacher has {n_teacher}"
        )
    out: dict[str, torch.Tensor] = {}
    for name, dst in student_params.items():
        parts = name.split(".")
        where, src_name = parts[0], name
        if name.startswith("encoder.embeddings."):
            where = "embeddings"
        elif name.startswith("encoder.layer_"):
            i = int(parts[1][len("layer_"):])
            where = f"layer_{i}"
            src_name = ".".join(["encoder", f"layer_{i * stride}", *parts[2:]])
        src = teacher_params[src_name]
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(
                f"{where}: teacher leaf {tuple(src.shape)} != student "
                f"{tuple(dst.shape)} — depth-only distillation requires "
                "matching widths"
            )
        out[name] = src.detach().clone()
    return out


class DistillTrainer(Trainer):
    """Student trainer whose step distills from a frozen teacher: init,
    evaluation and the update are :class:`Trainer`'s, only the loss is
    the KD loss. Runs on the card unless ``device="cpu"``."""

    def __init__(
        self,
        student_cfg: ModelConfig,
        teacher_cfg: ModelConfig,
        train_cfg: TrainConfig,
        distill_cfg: DistillConfig,
        *,
        pad_id: int = 0,
        drop_remainder: bool = True,
        device: str | torch.device | None = None,
    ):
        super().__init__(student_cfg, train_cfg, pad_id=pad_id, drop_remainder=drop_remainder, device=device)
        if teacher_cfg.dim != student_cfg.dim:
            raise ValueError(
                f"teacher dim {teacher_cfg.dim} != student dim "
                f"{student_cfg.dim}: depth-only distillation"
            )
        self.teacher_cfg = teacher_cfg
        self.distill_cfg = distill_cfg
        self.teacher_model = model_skeleton(teacher_cfg)
        self._teacher: dict[str, torch.Tensor] | None = None

    def teacher_logits(self, teacher_params: Mapping[str, torch.Tensor], ids, mask) -> torch.Tensor:
        """The teacher's eval-mode logits, no autograd state kept."""
        with torch.no_grad():
            return torch.func.functional_call(self.teacher_model, dict(teacher_params), (ids, mask), {"deterministic": True})

    def _loss(self, logits, ids, mask, labels) -> torch.Tensor:
        if self._teacher is None:
            raise RuntimeError("DistillTrainer steps run inside distill(), which names the teacher")
        dcfg = self.distill_cfg
        return distillation_loss(
            logits, self.teacher_logits(self._teacher, ids, mask), labels,
            temperature=dcfg.temperature, alpha=dcfg.alpha,
        )

    def init_student_state(self, teacher_params: Mapping[str, torch.Tensor], seed: int | None = None) -> TrainState:
        """A fresh student state, layer-initialized from the teacher when
        ``DistillConfig.init_from_teacher``, at stride ``teacher_layers //
        student_layers`` (floored: 5 -> 2 copies teacher layers 0 and 2)."""
        if not self.distill_cfg.init_from_teacher:
            return self.init_state(seed=seed)
        # Every student leaf comes from the teacher: the skeleton's (meta)
        # leaves give the names and shapes, and no init is drawn.
        student = self.model.state_dict()
        stride = max(1, self.teacher_cfg.n_layers // self.model_cfg.n_layers)
        return self.init_state(seed=seed, params=init_student_from_teacher(student, teacher_params, stride=stride))

    def distill_step(
        self, state: TrainState, teacher_params: Mapping[str, torch.Tensor], batch: dict
    ) -> tuple[TrainState, torch.Tensor]:
        """One KD step on a host batch (the JAX trainer's ``distill_step``)."""
        self._teacher = dict(teacher_params)
        try:
            return self.train_step(state, batch)
        finally:
            self._teacher = None

    def distill(
        self,
        state: TrainState,
        teacher_params: Mapping[str, torch.Tensor],
        split: TokenizedSplit,
        *,
        batch_size: int = 16,
        epochs: int | None = None,
        epoch_offset: int = 0,
        tag: str = "",
    ) -> tuple[TrainState, list[float]]:
        """KD epochs over ``split``: :meth:`Trainer.fit` with the teacher
        named for the loss (the same shuffles, logging and mean losses)."""
        self._teacher = dict(teacher_params)
        try:
            return self.fit(state, split, batch_size=batch_size, epochs=epochs, epoch_offset=epoch_offset, tag=tag)
        finally:
            self._teacher = None
