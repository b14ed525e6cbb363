"""``infer-serve``: the online scoring service.

:func:`build_server` resolves the weights (the registry's serving
artifact, or a training checkpoint's latest step), builds the engine on
the requested device and returns the (not yet started) server with its
reload watcher; :func:`cmd_infer_serve` runs it until interrupted.

The weight sources, as in the JAX package: ``--registry-dir`` follows
the serving pointer (only what the control plane promoted is served,
hot-swapped on promotion or rollback); ``--checkpoint-dir`` follows the
directory's latest finished step, the initial load and every reload
through one restore path (``predict``'s); ``--hf-dir`` (with the
reference's ``--pth``, or a checkpoint with a trained head) serves fixed
weights. The first two are exclusive. The tokenizer is ``--hf-dir``'s
vocabulary when given, and the model config the registry manifest's,
else the checkpoint's, else ``--config``/``--preset`` with the flags.
``features`` requests render through ``--dataset``'s template; ``--auth``
requires the HMAC challenge on every connection, keyed by FEDTPU_SECRET.
The obs flags are the JAX verb's: ``--trace-jsonl`` (serve-batch spans,
sampled by ``--trace-sample``), ``--metrics-port`` (bound on ``--host``),
``--metrics-jsonl``, ``--scored-jsonl``, ``--flight-dir`` and
``--profile-stride`` (the score step's fenced timers).
"""

from __future__ import annotations

import logging
import time

from ..config import ModelConfig
from ..data.datasets import get_dataset
from ..models.convert import params_from_jax
from ..registry import ModelRegistry
from ..serving import CheckpointWatcher, MicroBatcher, RegistryWatcher, ScoreEngine, ScoringServer
from ..serving.reload import checkpoint_restorer
from ..train.checkpoint import CheckpointError
from .comm import _auth_key
from .common import _obs_setup, _resolve_with_pretrained

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


def build_server(args) -> ScoringServer:
    tok, cfg, pretrained = _resolve_with_pretrained(args)
    buckets = _parse_buckets(args.buckets)
    if args.max_queue < buckets[-1]:
        raise SystemExit(
            f"--max-queue {args.max_queue} is smaller than the largest "
            f"bucket {buckets[-1]}: the queue could never fill one batch"
        )
    auth_key = None
    if args.auth:
        auth_key = _auth_key()
        if auth_key is None:
            raise SystemExit(
                "--auth needs the shared secret in the FEDTPU_SECRET env "
                "var (same value on the server and every scoring client)"
            )
    if args.registry_dir and cfg.checkpoint_dir:
        raise SystemExit(
            "--registry-dir and --checkpoint-dir are two different reload "
            "sources (eval-gated pointer vs raw latest step); pass one"
        )
    if args.registry_dir:
        registry = ModelRegistry(args.registry_dir)
        info = registry.serving_info()
        if info is None:
            raise SystemExit(
                f"registry {args.registry_dir} has no serving artifact yet — "
                "promote one first"
            )
        manifest = registry.manifest(info["artifact"])
        model_cfg = ModelConfig(**manifest["model_config"]) if manifest.get("model_config") else cfg.model
        if model_cfg.vocab_size != len(tok.vocab):
            raise SystemExit(
                f"serving artifact's model vocab ({model_cfg.vocab_size}) != "
                f"tokenizer vocab ({len(tok.vocab)})"
            )
        params = params_from_jax(registry.load_params(info["artifact"]))
        round_id = int(manifest.get("round", 0))
        watcher = RegistryWatcher(registry, poll_interval_s=args.reload_poll)
        watcher.prime(info["artifact"])
        source = f"artifact {info['artifact']}"
    elif cfg.checkpoint_dir:
        restore = checkpoint_restorer(cfg.checkpoint_dir, cfg.model, device=args.device)
        try:
            model_cfg, params, round_id, step = restore(None)
        except CheckpointError as e:
            raise SystemExit(str(e)) from None
        watcher = CheckpointWatcher(cfg.checkpoint_dir, restore, poll_interval_s=args.reload_poll)
        # Primed with the step just restored, never a fresh scan: a step
        # finished since then is new on the first poll.
        watcher.prime(step)
        source = f"checkpoint {cfg.checkpoint_dir} step {step}"
    elif pretrained is not None:
        model_cfg, params, round_id, watcher = cfg.model, pretrained, 0, None
        source = f"HF checkpoint {args.hf_dir}" + (f" with {args.pth}" if args.pth else "")
    else:
        raise SystemExit(
            "infer-serve needs trained weights: pass --registry-dir (the "
            "registry's promoted artifact, hot-swapped on promotion), "
            "--checkpoint-dir (a local training checkpoint, hot-reloaded "
            "on each new step) or --hf-dir (a fine-tuned classifier "
            "checkpoint)"
        )
    engine = ScoreEngine(
        model_cfg,
        params,
        pad_id=tok.pad_id,
        buckets=buckets,
        round_id=round_id,
        device=args.device,
    )
    dataset = cfg.data.dataset
    tracer, metrics_server = _obs_setup(args, proc="serve", cfg=cfg, metrics_host=args.host)
    log.info(
        f"[SERVE] serving {source} (round {engine.round_id}, attention "
        f"{model_cfg.attention_impl}, {model_cfg.compute_dtype}) on {engine.device}; "
        f"{dataset} features; auth {'on' if auth_key else 'off (open port)'}"
    )
    return ScoringServer(
        engine,
        tok,
        host=args.host,
        port=args.port,
        spec=get_dataset(dataset),
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
        watcher=watcher,
        auth_key=auth_key,
        metrics_jsonl=args.metrics_jsonl,
        scored_jsonl=args.scored_jsonl,
        tracer=tracer,
        # --trace-sample overrides the config's obs.trace_sample.
        trace_sample=args.trace_sample if args.trace_sample is not None else cfg.obs.trace_sample,
        metrics_server=metrics_server,
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
                    f"p99 {s['p99_ms']:.2f} ms, rejects {s['rejects']}, "
                    f"round {s['round']} ({s['reloads']} reloads)"
                )
        except KeyboardInterrupt:
            log.info("[SERVE] interrupted; draining")
    return 0
