"""Shared CLI plumbing of the ported commands: config resolution from
flags, data loading and per-client report writing (the port's copy of
the parts of the JAX package's ``cli/common.py`` that ``local`` uses)."""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Any

from ..config import DataConfig, ExperimentConfig, ModelConfig

log = logging.getLogger(__name__)


def _preset_model(preset: str, vocab_size: int) -> ModelConfig:
    from ..models.presets import model_preset

    try:
        return model_preset(preset, vocab_size=vocab_size)
    except ValueError as e:
        raise SystemExit(f"--preset: {e}") from None


def resolve_config(args: argparse.Namespace, *, vocab_size: int) -> ExperimentConfig:
    """The preset's defaults <- flags (the JAX package's precedence)."""
    model = _preset_model(getattr(args, "preset", "tiny"), vocab_size)
    model_kw: dict[str, Any] = {}
    if getattr(args, "max_len", None):
        model_kw.update(max_len=args.max_len)
    if getattr(args, "attention_impl", None):
        model_kw.update(attention_impl=args.attention_impl)
    try:
        model = model.replace(**model_kw) if model_kw else model
    except ValueError as e:
        raise SystemExit(str(e)) from None

    data_kw: dict[str, Any] = {"max_len": model.max_len}
    if getattr(args, "batch_size", None):
        data_kw.update(batch_size=args.batch_size, eval_batch_size=args.batch_size)
    if getattr(args, "data_fraction", None):
        data_kw.update(data_fraction=args.data_fraction)
    cfg = ExperimentConfig(model=model, data=DataConfig(**data_kw))

    train_kw: dict[str, Any] = {}
    if getattr(args, "epochs", None):
        train_kw.update(epochs_per_round=args.epochs)
    if getattr(args, "learning_rate", None):
        train_kw.update(learning_rate=args.learning_rate)
    if getattr(args, "seed", None) is not None:
        train_kw.update(seed=args.seed)
    if train_kw:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))
    if getattr(args, "output_dir", None):
        cfg = dataclasses.replace(cfg, output_dir=args.output_dir)
    return cfg


def _load_clients(args, cfg: ExperimentConfig, tok, num_clients: int):
    """CSV or synthetic flows -> per-client splits -> token arrays."""
    from ..data.cicids import load_flow_csv, make_all_client_splits
    from ..data.pipeline import tokenize_client
    from ..data.synthetic import make_synthetic_flows

    if getattr(args, "csv", None):
        log.info(f"[DATA] loading {args.csv}")
        frame = load_flow_csv(args.csv)
    else:
        n = getattr(args, "synthetic", None) or 2400
        log.info(f"[DATA] generating {n} synthetic {cfg.data.dataset} flows")
        frame = make_synthetic_flows(n, seed=cfg.data.seed_base)
    splits = make_all_client_splits(frame, num_clients, cfg.data)
    return [tokenize_client(s, tok, max_len=cfg.model.max_len) for s in splits]


def _write_reports(client_id: int, local: dict, output_dir: str) -> str:
    """The reference's one-row metrics CSV ``client{N}_local_metrics.csv``
    (client1.py:386). The JAX package's plots are not ported."""
    from .. import reporting

    os.makedirs(output_dir, exist_ok=True)
    path = reporting.save_metrics(
        local, os.path.join(output_dir, f"client{client_id}_local_metrics.csv")
    )
    log.info(f"[CLIENT {client_id}] wrote {path}")
    return path
