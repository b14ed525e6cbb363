#!/usr/bin/env python3
"""Where a served batch's time goes on the card: a device-time breakdown.

    python3 chip_profile.py [--bucket 128] [--seed 0]

Builds the port's scoring engine for full-width DistilBERT-base (6
layers, dim 768, 12 heads, L=128, flash attention, bf16, seeded random
weights), scores one full bucket of token rows a few times under
``torch.profiler``, and prints per-category device time (the flash
kernel K1, GEMMs, LayerNorm, other elementwise, copies), the host wall
time per ``score`` call, and the device's idle share of that wall, then
one JSON line with the same numbers. Needs CUDA; exits non-zero without
it or when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    default_tokenizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
    ScoreEngine,
)

#: Kernel-name fragments -> category, first match wins.
CATEGORIES = (
    ("K1 flash_fwd", ("flash_fwd",)),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("softmax", ("softmax", "SoftMax")),
    ("copy/cast", ("copy", "Memcpy", "memcpy", "cat", "Cat")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "gelu")),
)


def category(name: str) -> str:
    for cat, frags in CATEGORIES:
        if any(f in name for f in frags):
            return cat
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bucket", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    tok = default_tokenizer()
    cfg = ModelConfig.distilbert_base(
        vocab_size=len(tok.vocab), attention_impl="flash", compute_dtype="bfloat16"
    )
    engine = ScoreEngine(
        cfg, init_params(cfg, torch.Generator().manual_seed(args.seed)),
        pad_id=tok.pad_id, buckets=(args.bucket,),
    )
    rng = np.random.default_rng(args.seed)
    ids = rng.integers(5, cfg.vocab_size, (args.bucket, cfg.max_len)).astype(np.int32)
    lengths = rng.integers(40, cfg.max_len + 1, args.bucket)
    mask = (np.arange(cfg.max_len)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask == 0] = tok.pad_id
    for _ in range(3):
        engine.score(ids, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        engine.score(ids, mask)  # ends in a device->host copy: synchronous
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            engine.score(ids, mask)
        torch.cuda.synchronize()
    per_cat: dict[str, float] = {}
    per_kernel: dict[str, float] = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        if us <= 0:
            continue
        per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us
        cat = category(evt.key)
        per_cat[cat] = per_cat.get(cat, 0.0) + us
    device_ms = sum(per_cat.values()) / 1e3 / args.iters
    if device_ms <= 0:
        raise SystemExit("chip_profile: the profiler recorded no device time")
    print(f"{card}: bucket {args.bucket}, wall {wall_ms:.3f} ms/score, device busy {device_ms:.3f} ms, idle share {max(0.0, 1 - device_ms / wall_ms):.3f}")
    for cat, us in sorted(per_cat.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / args.iters
        print(f"  {cat:12s} {ms:8.4f} ms  {ms / device_ms:6.1%}")
    print("top kernels (ms per score):")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3 / args.iters:8.4f}  {name[:110]}")
    print(json.dumps({
        "card": card,
        "bucket": args.bucket,
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "idle_share": max(0.0, 1 - device_ms / wall_ms),
        "categories_ms": {k: v / 1e3 / args.iters for k, v in per_cat.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
