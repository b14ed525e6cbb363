"""Shared CLI plumbing of the ported commands: the per-process obs setup
(tracer, flight recorder, profile stride, ``/metrics``), config
resolution (defaults <- ``--config`` <- flags), the pretrained start
(``--hf-dir``, ``--pth``), data loading (a CSV, a mixed ``--source``
corpus or synthetic flows of the ``--dataset`` schema) and per-client
report writing (the port's copy of the parts of the JAX package's
``cli/common.py`` that ``local``, ``client``, ``federated``, ``distill``,
``predict``, ``serve`` and ``infer-serve`` use)."""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import os
from typing import Any

from ..config import DataConfig, ExperimentConfig, FedConfig, MeshConfig, ModelConfig
from ..utils.logging import phase

log = logging.getLogger(__name__)


# ------------------------------------------------------------- observability
def _obs_setup(
    args,
    *,
    proc: str,
    cfg: ExperimentConfig | None = None,
    install_global: bool = True,
    metrics_host: str = "127.0.0.1",
):
    """One call per CLI process: build this process's span Tracer (from
    --trace-jsonl, falling back to the config's obs.trace_jsonl), install
    it as the global tracer, arm the flight recorder (--flight-dir /
    obs.flight_dir), install the step-profiling stride (--profile-stride /
    obs.profile_stride), and start the /metrics endpoint when
    --metrics-port (or obs.metrics_port) asks for one. Returns
    ``(tracer | None, metrics_server | None)``; the caller closes the
    server when it is done.

    Each setting is installed unconditionally, so one in-process
    invocation's tracer, recorder or stride never leaks into the next.
    ``install_global=False`` (the TCP client): the round loop writes its
    own client-local span through ``FederatedClient.note_local_phase``,
    so the global tracer stays disarmed. The endpoint is
    unauthenticated: it binds loopback unless the verb passes its own
    ``--host``."""
    from ..obs import (
        FlightRecorder,
        Tracer,
        maybe_start_metrics_server,
        set_global_recorder,
        set_global_tracer,
    )
    from ..obs.profile import set_profile_stride
    from ..obs.trace import set_run_id

    obs_cfg = cfg.obs if cfg is not None else None
    if obs_cfg is not None and obs_cfg.run_id:
        # Pinned BEFORE the first span/metrics record.
        set_run_id(obs_cfg.run_id)
    trace_path = getattr(args, "trace_jsonl", None) or (
        obs_cfg.trace_jsonl if obs_cfg else None
    )
    tracer = None
    if trace_path:
        tracer = Tracer(trace_path, proc=proc)
        log.info(f"[OBS] {proc}: appending spans to {trace_path}")
    set_global_tracer(tracer if install_global else None)
    flight_dir = getattr(args, "flight_dir", None) or (
        obs_cfg.flight_dir if obs_cfg else None
    )
    recorder = None
    if flight_dir:
        recorder = FlightRecorder(
            flight_dir,
            proc=proc,
            ring=obs_cfg.flight_ring if obs_cfg else 256,
            # What this process was running with: the first thing a
            # postmortem reader checks.
            config={
                "proc": proc,
                **({"experiment": cfg.to_dict()} if cfg is not None else {}),
            },
            tracer=tracer,
        )
        log.info(f"[OBS] {proc}: flight recorder armed, postmortem bundles -> {flight_dir}")
    set_global_recorder(recorder)
    stride = getattr(args, "profile_stride", None)
    if stride is None and obs_cfg is not None:
        stride = obs_cfg.profile_stride
    set_profile_stride(stride or 0)
    if stride:
        log.info(
            f"[OBS] {proc}: step profiling armed (every {stride}th step "
            "fenced into host/dispatch/device)"
        )
    port = getattr(args, "metrics_port", None) or (
        obs_cfg.metrics_port if obs_cfg else 0
    )
    server = maybe_start_metrics_server(port, host=metrics_host)
    if server is not None:
        log.info(f"[OBS] {proc}: Prometheus /metrics on {metrics_host}:{server.port}")
    return tracer, server


def _append_metrics(args, records) -> None:
    """``--metrics-jsonl``: append each record of ``records`` (the JAX
    package's keys) to the stream; nothing without the flag."""
    path = getattr(args, "metrics_jsonl", None)
    if not path:
        return
    from ..reporting import append_metrics_jsonl

    for rec in records:
        append_metrics_jsonl(path, rec)


def _preset_model(preset: str, vocab_size: int) -> ModelConfig:
    from ..models.presets import model_preset

    try:
        return model_preset(preset, vocab_size=vocab_size)
    except ValueError as e:
        raise SystemExit(f"--preset: {e}") from None


def resolve_config(args: argparse.Namespace, *, vocab_size: int) -> ExperimentConfig:
    """defaults <- ``--config`` file <- flags (the JAX package's
    precedence): the file, when given, replaces the preset."""
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = ExperimentConfig.from_dict(json.load(f))
    else:
        model = _preset_model(getattr(args, "preset", "tiny"), vocab_size)
        cfg = ExperimentConfig(model=model, data=DataConfig(max_len=model.max_len))

    model_kw: dict[str, Any] = {}
    if getattr(args, "max_len", None):
        model_kw.update(max_len=args.max_len)
    if getattr(args, "gelu", None):
        model_kw.update(gelu=args.gelu)
    if getattr(args, "attention_impl", None):
        model_kw.update(attention_impl=args.attention_impl)
    if getattr(args, "attention_dropout", None) is not None:
        # An explicit 0 must reach the config.
        model_kw.update(attention_dropout=args.attention_dropout)
    if getattr(args, "remat", None) is not None:
        # Three-way: --remat / --no-remat / absent (the config wins).
        model_kw.update(remat=args.remat)
    try:
        model = cfg.model.replace(**model_kw) if model_kw else cfg.model
    except ValueError as e:
        raise SystemExit(str(e)) from None

    # The model and the data change together: ExperimentConfig checks
    # data.max_len == model.max_len on every replace.
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
    cfg = dataclasses.replace(cfg, model=model, data=dataclasses.replace(cfg.data, **data_kw))

    train_kw: dict[str, Any] = {}
    if getattr(args, "epochs", None):
        train_kw.update(epochs_per_round=args.epochs)
    if getattr(args, "learning_rate", None):
        train_kw.update(learning_rate=args.learning_rate)
    if getattr(args, "warmup_steps", None) is not None:
        train_kw.update(warmup_steps=args.warmup_steps)
    if getattr(args, "seed", None) is not None:
        train_kw.update(seed=args.seed)
    if getattr(args, "prox_mu", None) is not None:
        # The TCP client's local phase reads TrainConfig.prox_mu, the
        # federated trainer FedConfig.prox_mu: one flag feeds both.
        train_kw.update(prox_mu=args.prox_mu)
    if train_kw:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))
    if hasattr(args, "num_clients"):
        fed = _resolve_fed(args, cfg.fed)
        cfg = dataclasses.replace(cfg, fed=fed, mesh=_resolve_mesh(args, cfg, fed.num_clients))
    if getattr(args, "output_dir", None):
        cfg = dataclasses.replace(cfg, output_dir=args.output_dir)
    if getattr(args, "checkpoint_dir", None):
        cfg = dataclasses.replace(cfg, checkpoint_dir=args.checkpoint_dir)
    return cfg


def _resolve_mesh(args, cfg: ExperimentConfig, n: int) -> MeshConfig:
    """Mesh axes from flags: ``is None`` checks (an explicit 0 must reach
    MeshConfig's own validation, not silently fall back to the config
    default), and validation errors surface as operator messages."""
    dp = getattr(args, "data_parallel", None)
    sp = getattr(args, "seq_parallel", None)
    fsdp = getattr(args, "fsdp", None)
    try:
        return MeshConfig(
            clients=n,
            data=cfg.mesh.data if dp is None else dp,
            seq=cfg.mesh.seq if sp is None else sp,
            # store_true default is None; the config file wins unless
            # the flag was actually given.
            fsdp=cfg.mesh.fsdp or bool(fsdp),
        )
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _resolve_fed(args: argparse.Namespace, fed: FedConfig) -> FedConfig:
    """``fed`` (the file's or the defaults) <- the flags; the untouched
    default survivor floor is lowered to ``--participation``, as in the
    JAX package (an explicitly configured floor still collides)."""
    kw: dict[str, Any] = dict(
        num_clients=getattr(args, "num_clients", None) or fed.num_clients,
        rounds=getattr(args, "rounds", None) or fed.rounds,
    )
    if getattr(args, "weighted", False):
        kw.update(weighted=True)
    elif getattr(args, "unweighted", False):
        kw.update(weighted=False)
    for name in (
        "prox_mu", "participation", "server_lr", "server_momentum", "dp_clip", "dp_noise_multiplier",
        "personalize_epochs",
    ):
        if getattr(args, name, None) is not None:
            kw[name] = getattr(args, name)
    for name in ("participation_mode", "server_opt", "personalize_scope"):
        if getattr(args, name, None):
            kw[name] = getattr(args, name)
    participation = kw.get("participation", fed.participation)
    if participation < fed.min_client_fraction and fed.min_client_fraction == FedConfig().min_client_fraction:
        kw.update(min_client_fraction=participation)
    return dataclasses.replace(fed, **kw)


def _resolve_with_pretrained(args: argparse.Namespace, *, load_weights: bool = True):
    """``(tokenizer, config, initial params or None)``.

    Without ``--hf-dir``: the domain tokenizer, the resolved config and no
    params (a seeded init). With it (the reference's required
    ``./distilbert-base-uncased``, client1.py:357,360-361): the vocabulary
    from its ``vocab.txt``, the architecture from its ``config.json``,
    every other model knob from the resolved config, and the encoder's
    weights with a fresh head drawn from the train seed, or with ``--pth``
    the reference's own trained state dict (client1.py:374-377).
    ``load_weights=False`` resolves tokenizer and architecture alone.
    ``--gelu`` follows the flag, then a config file that names ``gelu``,
    then the checkpoint's ``activation``; ``--max-len`` is checked against
    the checkpoint's position table, not the preset's."""
    hf_dir = getattr(args, "hf_dir", None)
    if getattr(args, "pth", None) and not hf_dir:
        raise SystemExit(
            "--pth needs --hf-dir alongside it: the .pth holds only weights; "
            "the tokenizer and architecture come from the HF checkpoint dir "
            "(the reference requires the same directory, client1.py:357)"
        )
    if not hf_dir:
        from ..data.tokenizer import default_tokenizer

        tok = default_tokenizer()
        return tok, resolve_config(args, vocab_size=len(tok.vocab)), None

    import numpy as np

    from ..data.tokenizer import WordPieceTokenizer
    from ..models.hf_convert import config_from_hf_dir, load_hf_dir

    tok = WordPieceTokenizer.from_vocab_file(os.path.join(hf_dir, "vocab.txt"))
    # Resolved WITHOUT --max-len: the preset model is discarded below, and
    # its position table is not the checkpoint's.
    args_sans_len = copy.copy(args)
    args_sans_len.max_len = None
    cfg = resolve_config(args_sans_len, vocab_size=len(tok.vocab))
    m = cfg.model
    overrides: dict[str, Any] = dict(
        dropout=m.dropout,
        attention_dropout=m.attention_dropout,
        head_dropout=m.head_dropout,
        n_classes=m.n_classes,
        compute_dtype=m.compute_dtype,
        param_dtype=m.param_dtype,
        attention_impl=m.attention_impl,
        ring_axis=m.ring_axis,
        remat=m.remat,
        fused_qkv=m.fused_qkv,
    )
    if getattr(args, "gelu", None):
        overrides["gelu"] = args.gelu
    elif getattr(args, "config", None):
        with open(args.config) as f:
            if "gelu" in json.load(f).get("model", {}):
                overrides["gelu"] = m.gelu
    if getattr(args, "max_len", None):
        overrides["max_len"] = args.max_len
    model_cfg = config_from_hf_dir(hf_dir, **overrides)
    if len(tok.vocab) != model_cfg.vocab_size:
        raise SystemExit(
            f"--hf-dir vocab.txt has {len(tok.vocab)} entries but config.json "
            f"says vocab_size={model_cfg.vocab_size}"
        )
    cfg = dataclasses.replace(
        cfg, model=model_cfg, data=dataclasses.replace(cfg.data, max_len=model_cfg.max_len)
    )
    if not load_weights:
        return tok, cfg, None
    if getattr(args, "pth", None):
        from ..models.hf_convert import load_reference_pth

        with phase(f"loading reference .pth {args.pth}", tag="MODEL"):
            try:
                params = load_reference_pth(args.pth, model_cfg)
            except Exception as e:
                # KeyError: another architecture than --hf-dir's; FileNotFoundError:
                # a bad path; ValueError: a headless dict. Operator errors all.
                raise SystemExit(
                    f"--pth {args.pth}: {type(e).__name__}: {e} — expected "
                    "the reference's DDoSClassifier state dict matching "
                    "--hf-dir's architecture (client1.py:53-58,388)"
                ) from None
        return tok, cfg, params
    with phase(f"loading HF checkpoint {hf_dir}", tag="MODEL"):
        params, _ = load_hf_dir(hf_dir, cfg=model_cfg, head_rng=np.random.default_rng(cfg.train.seed))
    return tok, cfg, params


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
        with phase(f"loading {len(entries)}-source mixed corpus", tag="DATA"):
            corpus = load_mixed_corpus(entries)
        with phase("partition/split", tag="DATA"):
            return make_all_client_splits_from_corpus(
                corpus, num_clients, cfg.data, manifest_path=manifest_path
            )
    if getattr(args, "csv", None):
        with phase(f"loading {args.csv}", tag="DATA"):
            frame = load_flow_csv(args.csv)
    else:
        n = getattr(args, "synthetic", None) or 2400
        with phase(f"generating {n} synthetic {cfg.data.dataset} flows", tag="DATA"):
            try:
                frame = make_synthetic(cfg.data.dataset, n, seed=cfg.data.seed_base)
            except ValueError as e:
                raise SystemExit(f"--synthetic: {e}") from None
    with phase("partition/split", tag="DATA"):
        return make_all_client_splits(frame, num_clients, cfg.data, manifest_path=manifest_path)


def _load_clients(args, cfg: ExperimentConfig, tok, num_clients: int):
    """Per-client text splits -> token arrays; with ``--stream`` the
    two-pass chunked reader of ``--csv`` (data/streaming.py), which never
    holds the whole CSV."""
    from ..data.pipeline import tokenize_client

    if getattr(args, "stream", False):
        if not getattr(args, "csv", None):
            raise SystemExit("--stream needs --csv (chunked two-pass reader)")
        from ..data.streaming import stream_client_tokens

        with phase(f"streaming {args.csv}", tag="DATA"):
            return stream_client_tokens(args.csv, cfg.data, num_clients, tok, max_len=cfg.model.max_len)
    splits = _load_client_splits(args, cfg, num_clients)
    with phase("tokenize", tag="DATA"):
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
