"""``infer-serve``: the online scoring service over a promoted artifact.

:func:`build_server` resolves the registry's serving artifact, builds the
engine on the requested device and returns the (not yet started) server;
:func:`cmd_infer_serve` runs it until interrupted.
"""

from __future__ import annotations

import dataclasses
import logging
import time

from ..config import ModelConfig
from ..data.tokenizer import default_tokenizer
from ..models.convert import params_from_jax
from ..models.presets import model_preset
from ..registry import ModelRegistry
from ..serving import MicroBatcher, ScoreEngine, ScoringServer

log = logging.getLogger(__name__)


def _parse_buckets(spec: str) -> tuple[int, ...]:
    try:
        buckets = tuple(sorted({int(b) for b in spec.split(",") if b.strip()}))
    except ValueError:
        raise SystemExit(
            f"--buckets {spec!r}: want a comma-separated int list, e.g. "
            "1,8,32,128"
        ) from None
    if not buckets or buckets[0] < 1:
        raise SystemExit(f"--buckets {spec!r}: bucket sizes must be >= 1")
    return buckets


def _model_config(args, manifest: dict, vocab_size: int) -> ModelConfig:
    """The manifest's model_config wins; else the preset plus flags."""
    if manifest.get("model_config"):
        return ModelConfig(**manifest["model_config"])
    try:
        cfg = model_preset(args.preset, vocab_size=vocab_size)
    except ValueError as e:
        raise SystemExit(f"--preset: {e}") from None
    if args.attention_impl:
        cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    return cfg


def build_server(args) -> ScoringServer:
    tok = default_tokenizer()
    buckets = _parse_buckets(args.buckets)
    if args.max_queue < buckets[-1]:
        raise SystemExit(
            f"--max-queue {args.max_queue} is smaller than the largest "
            f"bucket {buckets[-1]}: the queue could never fill one batch"
        )
    registry = ModelRegistry(args.registry_dir)
    info = registry.serving_info()
    if info is None:
        raise SystemExit(
            f"registry {args.registry_dir} has no serving artifact yet — "
            "promote one first"
        )
    manifest = registry.manifest(info["artifact"])
    model_cfg = _model_config(args, manifest, len(tok.vocab))
    if model_cfg.vocab_size != len(tok.vocab):
        raise SystemExit(
            f"serving artifact's model vocab ({model_cfg.vocab_size}) != "
            f"tokenizer vocab ({len(tok.vocab)})"
        )
    params = params_from_jax(registry.load_params(info["artifact"]))
    engine = ScoreEngine(
        model_cfg,
        params,
        pad_id=tok.pad_id,
        buckets=buckets,
        round_id=int(manifest.get("round", 0)),
        device=args.device,
    )
    log.info(
        f"[SERVE] serving artifact {info['artifact']} (round "
        f"{engine.round_id}, attention {model_cfg.attention_impl}, "
        f"{model_cfg.compute_dtype}) on {engine.device}"
    )
    return ScoringServer(
        engine,
        tok,
        host=args.host,
        port=args.port,
        threshold=args.threshold,
        batcher=MicroBatcher(
            max_batch=buckets[-1],
            max_queue=args.max_queue,
            gather_window_s=args.max_wait_ms / 1e3,
        ),
        default_deadline_s=(
            args.default_deadline_ms / 1e3
            if args.default_deadline_ms is not None
            else None
        ),
    )


def cmd_infer_serve(args) -> int:
    server = build_server(args)
    with server:
        log.info(f"[SERVE] scoring on {args.host}:{server.port}")
        try:
            while True:
                time.sleep(60.0)
                s = server.stats()
                log.info(
                    f"[SERVE] {s['scored']} flows served "
                    f"({s['flows_per_sec']:.1f}/s), p50 {s['p50_ms']:.2f} ms "
                    f"p99 {s['p99_ms']:.2f} ms, rejects {s['rejects']}"
                )
        except KeyboardInterrupt:
            log.info("[SERVE] interrupted; draining")
    return 0
