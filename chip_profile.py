#!/usr/bin/env python3
"""Where a served batch's or a train step's time goes on the card.

    python3 chip_profile.py [--mode serve|train|fold] [--bucket 128] [--seed 0]

``serve`` builds the port's scoring engine for full-width DistilBERT-base
(6 layers, dim 768, 12 heads, L=128, flash attention, bf16, seeded random
weights) and scores one full bucket of token rows a few times under
``torch.profiler``. ``train`` runs the port's ``Trainer`` on the same
model with dropout on (the ``local`` command's configuration, bs16): it
times 100 steps by the host clock for the step's wall time and samples/s,
profiles a few more, then profiles each flash kernel alone at
the training shape (B=16, H=12, L=128, D=64, bf16, dropout 0.1) for its
device time per launch, free of the wrapper's host work.

``fold`` profiles the fold kernel K4 alone on DistilBERT-base's largest
leaf (the 30522 x 768 word embedding) at K=2 and K=8 clients for its
device time per launch, then one round's fold as the aggregation server
runs it: two uploads of the ``client`` command's full-width model (102
leaves), host numpy in and out, each leaf copied to the card, folded and
copied back.

All print per-category device time (the flash kernels K1/K2/K3, K4, GEMMs,
LayerNorm, the optimizer, dropout masks, other elementwise, copies), the
host wall time per call or step, and the device's idle share of that
wall, then one JSON line with the same numbers. Needs CUDA; exits
non-zero without it or when the profiler records no device time.
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
    TrainConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    default_tokenizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    flatten_tree,
    init_params,
    params_to_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    flash_attention as flash_mod,
    fold as fold_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    make_attention_bias,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
    ScoreEngine,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
)

#: Train steps timed by the host clock for the wall time per step.
TIMED_TRAIN_STEPS = 100

#: Kernel-name fragments -> category, first match wins.
CATEGORIES = (
    ("K1 flash_fwd", ("flash_fwd",)),
    ("K2 flash_dkdv", ("flash_dkdv",)),
    ("K3 flash_dq", ("flash_dq",)),
    ("K4 fold", ("fold_",)),
    ("optimizer", ("foreach", "multi_tensor", "MultiTensor")),
    ("dropout rng", ("philox", "distribution", "uniform", "random")),
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


def device_times(prof) -> dict[str, tuple[float, int]]:
    """Kernel name -> (total device µs, launches) over a profile."""
    out: dict[str, tuple[float, int]] = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        if us > 0:
            t, n = out.get(evt.key, (0.0, 0))
            out[evt.key] = (t + us, n + int(evt.count))
    return out


def report(card: str, what: str, wall_ms: float, prof, iters: int, extra: dict) -> None:
    per_kernel = device_times(prof)
    per_cat: dict[str, float] = {}
    for name, (us, _) in per_kernel.items():
        per_cat[category(name)] = per_cat.get(category(name), 0.0) + us
    device_ms = sum(per_cat.values()) / 1e3 / iters
    if device_ms <= 0:
        raise SystemExit("chip_profile: the profiler recorded no device time")
    idle = max(0.0, 1 - device_ms / wall_ms)
    print(f"{card}: {what}, wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms, idle share {idle:.3f}")
    for cat, us in sorted(per_cat.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / iters
        print(f"  {cat:14s} {ms:8.4f} ms  {ms / device_ms:6.1%}")
    print("top kernels (ms per call or step, launches):")
    for name, (us, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"  {us / 1e3 / iters:8.4f}  x{n // iters:<4d} {name[:100]}")
    print(json.dumps({
        "card": card,
        **extra,
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "idle_share": idle,
        "categories_ms": {k: v / 1e3 / iters for k, v in per_cat.items()},
    }))


def profile_train(card: str, args) -> None:
    """A few train steps of the ``local`` configuration, then each flash
    kernel alone at the training shape."""
    tok = default_tokenizer()
    cfg = ModelConfig.distilbert_base(
        vocab_size=len(tok.vocab), attention_impl="flash", compute_dtype="bfloat16"
    )
    trainer = Trainer(cfg, TrainConfig(seed=args.seed), pad_id=tok.pad_id, device="cuda")
    state = trainer.init_state()
    rng = np.random.default_rng(args.seed)
    bs = 16
    ids = rng.integers(5, cfg.vocab_size, (bs, cfg.max_len)).astype(np.int32)
    lengths = rng.integers(60, cfg.max_len + 1, bs)
    mask = (np.arange(cfg.max_len)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask == 0] = tok.pad_id
    batch = {"input_ids": ids, "attention_mask": mask, "labels": rng.integers(0, 2, bs).astype(np.int32)}
    for _ in range(3):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_TRAIN_STEPS):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED_TRAIN_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
    report(card, f"train step bs{bs} L{cfg.max_len} ({bs / wall_ms * 1e3:.1f} samples/s)",
           wall_ms, prof, args.iters, {"mode": "train", "batch_size": bs,
                                       "samples_per_s": bs / wall_ms * 1e3})

    # Each kernel alone: device time per launch at the training shape.
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v, do = (torch.randn(bs, 12, 128, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    bias = make_attention_bias(torch.from_numpy(mask).cuda())
    words = flash_mod.draw_seed_words(g)
    out, lse = flash_mod.flash_forward(q, k, v, bias, seed=words, rate=0.1)
    x = flash_mod._BwdInputs(q, k, v, bias, words, out, lse, do, 0.1)
    n = 50
    launches = {
        "flash_fwd (rate 0.1)": lambda: flash_mod.flash_forward(q, k, v, bias, seed=words, rate=0.1),
        "flash_fwd (rate 0)": lambda: flash_mod.flash_forward(q, k, v, bias),
        "flash_bwd_dkdv": lambda: flash_mod.flash_bwd_dkdv(x),
        "flash_bwd_dq": lambda: flash_mod.flash_bwd_dq(x),
    }
    alone = {}
    for label, fn in launches.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as kprof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        frag = "flash_fwd" if label.startswith("flash_fwd") else label.replace("bwd_", "")
        us, count = (0.0, 0)
        for name, (t, c) in device_times(kprof).items():
            if frag in name:
                us, count = us + t, count + c
        if count != n:
            raise SystemExit(f"chip_profile: {label}: {count} kernel launches recorded, want {n}")
        alone[label] = us / count / 1e3
        print(f"{card}: {label} alone, B={bs} bf16: {alone[label]:.4f} ms device per launch")
    print(json.dumps({"card": card, "mode": "kernels", "device_ms_per_launch": alone}))


def profile_fold(card: str, args) -> None:
    """K4 alone on the word-embedding leaf, then one round's fold."""
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    n_embed = 30522 * 768
    alone = {}
    for k in (2, 8):
        x = torch.randn(k, n_embed, generator=g, device="cuda")
        w = torch.rand(k, generator=g, device="cuda") + 0.05
        fold_mod.fold_stacked(x, w)
        torch.cuda.synchronize()
        n = 20
        with profile(activities=[ProfilerActivity.CUDA]) as kprof:
            for _ in range(n):
                fold_mod.fold_stacked(x, w)
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for name, (t, c) in device_times(kprof).items():
            if "fold_" in name:
                us, count = us + t, count + c
        if count != n:
            raise SystemExit(f"chip_profile: K4 at K={k}: {count} launches recorded, want {n}")
        alone[f"K={k}"] = us / count / 1e3
        gbps = (k + 1) * n_embed * 4 / (alone[f"K={k}"] * 1e-3) / 1e9
        print(f"{card}: fold alone, K={k} n={n_embed}: {alone[f'K={k}']:.4f} ms device per launch ({gbps:.1f} GB/s)")
        del x
    tok = default_tokenizer()
    cfg = ModelConfig.distilbert_base(vocab_size=len(tok.vocab))
    first = flatten_tree(params_to_jax(init_params(cfg, torch.Generator().manual_seed(args.seed))))
    uploads = [first, {key: a * np.float32(0.5) for key, a in first.items()}]
    weights = [np.float32(0.5)] * 2

    def fold_round() -> None:
        for key in first:
            fold_mod.fold_ordered([u[key] for u in uploads], weights, device="cuda")

    fold_round()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        fold_round()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            fold_round()
        torch.cuda.synchronize()
    n_params = sum(a.size for a in first.values())
    report(card, f"one round's fold, K=2 uploads of {len(first)} leaves ({n_params} fp32)",
           wall_ms, prof, args.iters,
           {"mode": "fold", "leaves": len(first), "params": n_params, "device_ms_per_launch": alone})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["serve", "train", "fold"], default="serve")
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
    if args.mode == "train":
        profile_train(card, args)
        return 0
    if args.mode == "fold":
        profile_fold(card, args)
        return 0
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
    report(card, f"bucket {args.bucket} score", wall_ms, prof, args.iters,
           {"mode": "serve", "bucket": args.bucket})
    return 0


if __name__ == "__main__":
    sys.exit(main())
