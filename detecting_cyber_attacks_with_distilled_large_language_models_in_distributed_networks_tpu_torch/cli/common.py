"""Shared CLI plumbing of the ported commands: config resolution from
flags, data loading (a CSV, a mixed ``--source`` corpus or synthetic
flows of the ``--dataset`` schema) and per-client report writing (the
port's copy of the parts of the JAX package's ``cli/common.py`` that
``local``, ``client``, ``federated`` and ``predict`` use)."""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Any

from ..config import DataConfig, ExperimentConfig, FedConfig, ModelConfig

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
    if getattr(args, "dataset", None):
        data_kw.update(dataset=args.dataset)
    if getattr(args, "batch_size", None):
        data_kw.update(batch_size=args.batch_size, eval_batch_size=args.batch_size)
    if getattr(args, "data_fraction", None):
        data_kw.update(data_fraction=args.data_fraction)
    if getattr(args, "partition", None):
        data_kw.update(partition=args.partition)
    if getattr(args, "dirichlet_alpha", None) is not None:
        data_kw.update(dirichlet_alpha=args.dirichlet_alpha)
    fed = _resolve_fed(args)
    cfg = ExperimentConfig(model=model, data=DataConfig(**data_kw), fed=fed)

    train_kw: dict[str, Any] = {}
    if getattr(args, "epochs", None):
        train_kw.update(epochs_per_round=args.epochs)
    if getattr(args, "learning_rate", None):
        train_kw.update(learning_rate=args.learning_rate)
    if getattr(args, "seed", None) is not None:
        train_kw.update(seed=args.seed)
    if getattr(args, "prox_mu", None) is not None:
        # The TCP client's local phase reads TrainConfig.prox_mu, the
        # federated trainer FedConfig.prox_mu: one flag feeds both.
        train_kw.update(prox_mu=args.prox_mu)
    if train_kw:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))
    if getattr(args, "output_dir", None):
        cfg = dataclasses.replace(cfg, output_dir=args.output_dir)
    if getattr(args, "checkpoint_dir", None):
        cfg = dataclasses.replace(cfg, checkpoint_dir=args.checkpoint_dir)
    return cfg


def _resolve_fed(args: argparse.Namespace) -> FedConfig:
    """The FedConfig of the flags (the JAX package's precedence); the
    untouched survivor floor is lowered to ``--participation``, as there."""
    d = FedConfig()
    kw: dict[str, Any] = dict(
        num_clients=getattr(args, "num_clients", None) or d.num_clients,
        rounds=getattr(args, "rounds", None) or d.rounds,
    )
    if getattr(args, "weighted", False):
        kw.update(weighted=True)
    elif getattr(args, "unweighted", False):
        kw.update(weighted=False)
    for name in ("prox_mu", "participation", "server_lr", "server_momentum"):
        if getattr(args, name, None) is not None:
            kw[name] = getattr(args, name)
    for name in ("participation_mode", "server_opt"):
        if getattr(args, name, None):
            kw[name] = getattr(args, name)
    if kw.get("participation", 1.0) < d.min_client_fraction:
        kw.update(min_client_fraction=kw["participation"])
    return FedConfig(**kw)


def _load_client_splits(args, cfg: ExperimentConfig, num_clients: int):
    """CSV, mixed corpus (``--source``) or synthetic flows -> per-client
    text splits, as the JAX package's ``cli/common.py`` loads them."""
    from ..data.cicids import (
        load_flow_csv,
        make_all_client_splits,
        make_all_client_splits_from_corpus,
    )
    from ..data.datasets import load_mixed_corpus, parse_source_arg
    from ..data.partition import MANIFEST_FILENAME
    from ..data.synthetic import make_synthetic

    # The non-IID schemes record each client's label histogram next to
    # the run outputs (data/partition.py).
    manifest_path = (
        os.path.join(cfg.output_dir, MANIFEST_FILENAME)
        if cfg.data.partition != "sample" and cfg.output_dir
        else None
    )
    if getattr(args, "source", None):
        if getattr(args, "csv", None):
            raise SystemExit("--csv and --source are mutually exclusive")
        # --dataset pins the schema of unprefixed --source entries; an
        # entry with neither is sniffed (datasets.detect_dataset).
        try:
            entries = [
                (name or getattr(args, "dataset", None), path)
                for name, path in map(parse_source_arg, args.source)
            ]
        except ValueError as e:
            raise SystemExit(f"--source: {e}") from None
        log.info(f"[DATA] loading a {len(entries)}-source mixed corpus")
        corpus = load_mixed_corpus(entries)
        return make_all_client_splits_from_corpus(
            corpus, num_clients, cfg.data, manifest_path=manifest_path
        )
    if getattr(args, "csv", None):
        log.info(f"[DATA] loading {args.csv}")
        frame = load_flow_csv(args.csv)
    else:
        n = getattr(args, "synthetic", None) or 2400
        log.info(f"[DATA] generating {n} synthetic {cfg.data.dataset} flows")
        try:
            frame = make_synthetic(cfg.data.dataset, n, seed=cfg.data.seed_base)
        except ValueError as e:
            raise SystemExit(f"--synthetic: {e}") from None
    return make_all_client_splits(frame, num_clients, cfg.data, manifest_path=manifest_path)


def _load_clients(args, cfg: ExperimentConfig, tok, num_clients: int):
    """Per-client text splits -> token arrays."""
    from ..data.pipeline import tokenize_client

    splits = _load_client_splits(args, cfg, num_clients)
    return [tokenize_client(s, tok, max_len=cfg.model.max_len) for s in splits]


def _write_reports(
    client_id: int, local: dict | None, aggregated: dict | None, output_dir: str
) -> list[str]:
    """The reference's one-row metrics CSVs ``client{N}_local_metrics.csv``
    and ``client{N}_aggregated_metrics.csv`` (client1.py:386,401), each
    when its metrics are given; returns their paths. The JAX package's
    plots are not ported."""
    from .. import reporting

    os.makedirs(output_dir, exist_ok=True)
    phases = [(p, m) for p, m in (("local", local), ("aggregated", aggregated)) if m is not None]
    paths = [
        reporting.save_metrics(
            metrics, os.path.join(output_dir, f"client{client_id}_{phase}_metrics.csv")
        )
        for phase, metrics in phases
    ]
    log.info(f"[CLIENT {client_id}] wrote {', '.join(paths)}")
    return paths
