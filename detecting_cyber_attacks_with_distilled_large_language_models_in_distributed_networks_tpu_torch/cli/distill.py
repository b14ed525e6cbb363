"""``distill``: teacher -> student knowledge distillation (the port of the
JAX package's ``cli/distill.py``; the recipe behind the reference's
pre-distilled encoder, client1.py:56). Runs on the card unless
``--device cpu``.

Teacher sources, in order: ``--teacher-checkpoint`` (a model trained
here, e.g. a federated aggregate), ``--pth`` with ``--hf-dir`` (a model
the reference trained), else a fresh teacher trained in the run at
``--teacher-layers`` (default twice the student's depth; a bare
``--hf-dir`` encoder warm-starts it when the depths agree).
``--student-layers`` sets the student below the resolved model's depth.
Writes ``teacher_metrics.csv`` and ``student_metrics.csv`` (test split);
the JAX package's comparison plot is not drawn.
"""

from __future__ import annotations

import dataclasses
import logging
import os

from ..device import resolve_device
from .common import _load_clients, _resolve_with_pretrained
from .predict import restore_inference

log = logging.getLogger(__name__)


def run_distill(args) -> dict:
    """The ``distill`` command's work. Returns ``config`` (the student's
    experiment config), ``teacher_config``, ``teacher_params``,
    ``teacher_trainer``, ``trainer`` (the :class:`DistillTrainer`),
    ``client`` (its token arrays), ``initial`` (the student's params at
    init, copies), ``state``, ``teacher_steps`` and ``teacher_losses``
    (per epoch; 0 and None unless the teacher trained here),
    ``losses`` (KD, per epoch), ``teacher_metrics``, ``student_metrics``
    and ``metrics_csvs``. ``--profile-dir`` wraps the teacher's and the
    student's training in one torch.profiler trace, as the JAX verb
    does."""
    from .. import reporting
    from ..train.checkpoint import Checkpointer
    from ..train.distill import DistillTrainer
    from ..train.engine import Trainer
    from ..utils.profiling import trace

    if getattr(args, "teacher_checkpoint", None) and getattr(args, "pth", None):
        raise SystemExit("--teacher-checkpoint and --pth are both teacher sources; pass one")
    if getattr(args, "pth", None) and args.teacher_layers is not None:
        raise SystemExit(
            "--teacher-layers has no effect when --pth supplies the "
            "teacher (its depth comes from --hf-dir's config.json)"
        )
    if args.student_layers is not None and args.student_layers < 1:
        raise SystemExit(f"--student-layers {args.student_layers} must be >= 1")
    device = resolve_device(args.device)  # raises before any work without CUDA
    # --teacher-checkpoint brings the weights: --hf-dir then gives the
    # tokenizer and architecture alone.
    tok, cfg, pretrained = _resolve_with_pretrained(args, load_weights=not args.teacher_checkpoint)
    # Flags override the config where given; invalid values reach
    # DistillConfig's validation, and --no-teacher-init only turns off.
    d = cfg.distill
    cfg = dataclasses.replace(cfg, distill=dataclasses.replace(
        d,
        temperature=d.temperature if args.temperature is None else args.temperature,
        alpha=d.alpha if args.alpha is None else args.alpha,
        init_from_teacher=d.init_from_teacher and not args.no_teacher_init,
    ))
    client = _load_clients(args, cfg, tok, 1)[0]
    student_cfg = cfg.model if args.student_layers is None else cfg.model.replace(n_layers=args.student_layers)
    teacher_layers = 2 * student_cfg.n_layers if args.teacher_layers is None else args.teacher_layers
    if teacher_layers < student_cfg.n_layers:
        raise SystemExit(
            f"--teacher-layers {teacher_layers} is shallower than the "
            f"{student_cfg.n_layers}-layer student"
        )
    teacher_cfg = cfg.model.replace(n_layers=teacher_layers)

    def check_teacher(tc) -> None:
        if tc.n_layers < student_cfg.n_layers:
            raise SystemExit(
                f"teacher has {tc.n_layers} layers — shallower than the "
                f"{student_cfg.n_layers}-layer student"
            )
        if (tc.dim, tc.n_heads, tc.hidden_dim) != (student_cfg.dim, student_cfg.n_heads, student_cfg.hidden_dim):
            raise SystemExit(
                f"teacher width (dim {tc.dim}, heads {tc.n_heads}, ffn "
                f"{tc.hidden_dim}) != student (dim {student_cfg.dim}, heads "
                f"{student_cfg.n_heads}, ffn {student_cfg.hidden_dim}): "
                "depth-only distillation"
            )

    def trainer_for(model_cfg) -> Trainer:
        return Trainer(model_cfg, cfg.train, pad_id=tok.pad_id, drop_remainder=cfg.data.drop_remainder, device=device)

    # --profile-dir: one torch.profiler trace over both trainings.
    with trace(args.profile_dir):
        teacher_steps, teacher_losses = 0, None
        if args.teacher_checkpoint:
            # A model trained elsewhere (say a federated fleet's aggregate); a
            # checkpoint without a recorded config is read at the teacher's
            # resolved architecture, as the JAX verb reads it.
            teacher_cfg, teacher_params = restore_inference(
                dataclasses.replace(cfg, model=teacher_cfg), device, args.teacher_checkpoint
            )
            check_teacher(teacher_cfg)
            log.info(f"[DISTILL] teacher from {args.teacher_checkpoint} ({teacher_cfg.n_layers} layers)")
        elif args.pth:
            # The migrated reference model is the (trained) teacher.
            teacher_cfg, teacher_params = cfg.model, {n: t.to(device) for n, t in pretrained.items()}
            check_teacher(teacher_cfg)
            log.info(f"[DISTILL] teacher from reference .pth {args.pth} ({teacher_cfg.n_layers} layers)")
        else:
            t_trainer = trainer_for(teacher_cfg)
            warm = pretrained if teacher_cfg == cfg.model else None
            if pretrained is not None and warm is None:
                log.info(
                    f"[DISTILL] --hf-dir encoder ({cfg.model.n_layers} layers) cannot "
                    f"warm-start the {teacher_cfg.n_layers}-layer teacher; pass "
                    f"--teacher-layers {cfg.model.n_layers} to use it"
                )
            t_state = t_trainer.init_state(params=warm)
            log.info(f"[DISTILL] training the {teacher_cfg.n_layers}-layer teacher")
            t_state, teacher_losses = t_trainer.fit(t_state, client.train, batch_size=cfg.data.batch_size, tag="[TEACHER] ")
            teacher_params = {n: t.detach() for n, t in t_state.params.items()}
            teacher_steps = t_state.step
        t_trainer = trainer_for(teacher_cfg)
        teacher_metrics = t_trainer.evaluate(teacher_params, client.test)

        trainer = DistillTrainer(
            student_cfg, teacher_cfg, cfg.train, cfg.distill, pad_id=tok.pad_id,
            drop_remainder=cfg.data.drop_remainder, device=device,
        )
        state = trainer.init_student_state(teacher_params)
        initial = {n: t.detach().clone() for n, t in state.params.items()}
        log.info(f"[DISTILL] distilling into the {student_cfg.n_layers}-layer student")
        state, losses = trainer.distill(
            state, teacher_params, client.train, batch_size=cfg.data.batch_size,
            epochs=args.distill_epochs, tag="[STUDENT] ",
        )
    student_metrics = trainer.evaluate(state.params, client.test)
    log.info(
        f"[DISTILL] teacher acc {teacher_metrics['Accuracy']:.4f} -> student acc "
        f"{student_metrics['Accuracy']:.4f} ({teacher_cfg.n_layers} -> {student_cfg.n_layers} layers)"
    )
    os.makedirs(cfg.output_dir, exist_ok=True)
    paths = [
        reporting.save_metrics(m, os.path.join(cfg.output_dir, f"{who}_metrics.csv"))
        for who, m in (("teacher", teacher_metrics), ("student", student_metrics))
    ]
    # The saved config records the STUDENT's architecture: what the
    # checkpoint's params are.
    student_experiment = dataclasses.replace(cfg, model=student_cfg)
    if cfg.checkpoint_dir:
        with Checkpointer(cfg.checkpoint_dir) as ckpt:
            ckpt.save(
                state.step, state,
                meta={"distilled": True, "kind": "local", "config": student_experiment.to_dict()},
            )
    return {
        "config": student_experiment, "teacher_config": teacher_cfg, "teacher_params": teacher_params,
        "teacher_trainer": t_trainer, "trainer": trainer, "client": client, "initial": initial,
        "state": state, "teacher_steps": teacher_steps, "teacher_losses": teacher_losses,
        "losses": losses, "teacher_metrics": teacher_metrics, "student_metrics": student_metrics,
        "metrics_csvs": paths,
    }


def cmd_distill(args) -> int:
    run_distill(args)
    return 0
