#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero before the last line is printed:

1. card   — the card's name and power limit (nvidia-smi) and torch's name;
2. build  — every CUDA kernel of the serving path, compiled from csrc/;
3. kernel — the flash forward kernel (K1) held against its plain PyTorch
            version on the card at the serving shapes (B in 1/8/32/128,
            H=12, L=128, D=64, random key masks with fully masked rows,
            plus ragged lengths), in fp32 (atol 2e-5) and bf16 (atol 2e-2:
            p and O each take one bf16 rounding; lse compared in fp32),
            with its time beside the plain version's, SDPA's (a yardstick
            the port never calls) and the least time the card could take;
4. path   — full-width DistilBERT-base (6 layers, dim 768, 12 heads,
            L=128, flash attention, bf16) with seeded random weights,
            written as a registry artifact and served by the port's
            ``infer-serve`` on the card; a few dozen concurrent text and
            features requests through the port's client. Every prob must
            be finite in [0, 1] and match the same weights through
            attention_impl="dot" on the card (bf16 atol 1e-2), and the
            kernel must have launched once per layer of every batch;
5. the kernels' JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

Needs CUDA: without a card (or without the repository beside it) it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
    build_server,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    FLOW_TEXT_COLUMNS,
    default_tokenizer,
    flow_to_text,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    flatten_tree,
    init_params,
    params_to_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    _build,
    flash_attention as flash_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    make_attention_bias,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
    ScoreEngine,
    ScoringClient,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
BUCKETS = (1, 8, 32, 128)
H, L, D = 12, 128, 64


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b: int, h: int, l: int, d: int, elsize: int) -> tuple[float, str]:
    """Least time (ms) for one forward: q, k, v, O once each, lse and the
    key bias; 2 products of 2·L·L·D flops per (b, h) at the bf16 peak."""
    nbytes = 4 * b * h * l * d * elsize + b * h * l * 4 + b * l * 4
    flops = 4 * b * h * l * l * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_inputs(g, b, l, dtype, fully_masked_row):
    q, k, v = (
        torch.randn(b, H, l, D, generator=g, device="cuda").to(dtype)
        for _ in range(3)
    )
    mask = (torch.rand(b, l, generator=g, device="cuda") > 0.3).to(torch.int32)
    mask[:, 0] = 1
    if fully_masked_row:
        mask[-1] = 0  # a bucket pad row: every key masked
    return q, k, v, make_attention_bias(mask)


def kernel_phase(seed: int) -> dict:
    """Phase 3: K1 against its plain version, then its times."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(b, L, True) for b in BUCKETS] + [(1, L, False), (8, 40, True), (2, 200, True)]
    bf16_err = 0.0
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for b, l, masked_row in cases:
            q, k, v, bias = attention_inputs(g, b, l, dtype, masked_row)
            out, lse = flash_mod.flash_forward(q, k, v, bias)
            torch.cuda.synchronize()
            ref, ref_lse = flash_mod.flash_attention_reference(q, k, v, bias)
            check(out.dtype == dtype and out.shape == q.shape, f"K1 output {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()), f"K1 non-finite at B={b} L={l} {dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            # lse of a fully masked row sits near -1e9, where an fp32 ulp is
            # 64: compare it relative to its size there.
            lse_diff = (lse - ref_lse).abs()
            lse_ok = bool((lse_diff <= 2e-5 + 2e-7 * ref_lse.abs()).all())
            print(f"K1 check {str(dtype):14s} B={b:3d} L={l:3d} max|O-ref|={err:.3e} (atol {atol}) max|lse-ref|={lse_diff.max().item():.3e}", flush=True)
            check(err <= atol, f"K1 disagrees with its plain version: {err} > {atol} at B={b} L={l} {dtype}")
            check(lse_ok, f"K1 lse disagrees at B={b} L={l} {dtype}")
            if dtype == torch.bfloat16 and l == L:
                bf16_err = max(bf16_err, err)
    times = {}
    for b in BUCKETS:
        q, k, v, bias = attention_inputs(g, b, L, torch.bfloat16, True)
        mask_bf16 = bias.to(torch.bfloat16)
        t_k = time_ms(lambda: flash_mod.flash_forward(q, k, v, bias))
        t_p = time_ms(lambda: flash_mod.flash_attention_reference(q, k, v, bias))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask_bf16))
        bound, bound_by = attention_bound(b, H, L, D, 2)
        times[b] = (t_k, t_p, t_l, bound, bound_by)
        print(f"K1 time B={b:3d} bf16 kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_us={bound * 1e3:.1f} ({bound_by})", flush=True)
    t_k, t_p, t_l, bound, bound_by = times[BUCKETS[-1]]
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu/ops/flash_attention.py:135",
        "launches": None,
        "max_abs_err": bf16_err,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": t_l,
    }


def flow_records(seed: int, n: int) -> list[dict]:
    """CICIDS2017-shaped flow records (the template's ten columns)."""
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        pkts_f, pkts_b = int(rng.integers(1, 5000)), int(rng.integers(0, 5000))
        dur = int(rng.integers(1, 120_000_000))
        bytes_f = int(pkts_f * rng.integers(0, 1500))
        vals = [
            int(rng.choice([80, 443, 53, 22, int(rng.integers(1024, 65535))])),
            dur, pkts_f, pkts_b, bytes_f, int(pkts_b * rng.integers(0, 1500)),
            int(rng.integers(0, 1500)), int(rng.integers(0, 60)),
            round(bytes_f / dur * 1e6, 4), round((pkts_f + pkts_b) / dur * 1e6, 4),
        ]
        recs.append(dict(zip(FLOW_TEXT_COLUMNS, vals)))
    return recs


def write_artifact(root: str, cfg: ModelConfig, params: dict, round_id: int) -> None:
    """The registry layout the JAX package's ModelRegistry writes."""
    aid = f"chip-smoke-r{round_id}"
    art = os.path.join(root, "artifacts", aid)
    os.makedirs(art)
    flat = flatten_tree(params_to_jax(params))
    with open(os.path.join(art, "params.npz"), "wb") as f:
        np.savez(f, **flat)
    manifest = {
        "id": aid,
        "state": "serving",
        "round": round_id,
        "model_config": dataclasses.asdict(cfg),
        "n_tensors": len(flat),
        "n_params": int(sum(v.size for v in flat.values())),
    }
    with open(os.path.join(art, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(root, "serving.json"), "w") as f:
        json.dump({"artifact": aid, "round": round_id}, f)


def path_phase(seed: int, device_name: str) -> int:
    """Phase 4: DistilBERT-base through infer-serve. Returns K1 launches."""
    tok = default_tokenizer()
    cfg = ModelConfig.distilbert_base(
        vocab_size=len(tok.vocab), attention_impl="flash", compute_dtype="bfloat16"
    )
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    records = flow_records(seed, 49)
    texts = [flow_to_text(r) for r in records]
    enc = tok.batch_encode(texts, max_len=cfg.max_len)
    with tempfile.TemporaryDirectory() as reg:
        write_artifact(reg, cfg, params, round_id=1)
        args = build_parser().parse_args(
            ["infer-serve", "--registry-dir", reg, "--host", "127.0.0.1",
             "--port", "0", "--max-wait-ms", "10"]
        )
        server = build_server(args)
        check(server.engine.device.type == "cuda", f"engine on {server.engine.device}")
        replies: dict[int, dict] = {}
        latencies: list[float] = []
        lock = threading.Lock()
        errors: list[BaseException] = []

        def drive(rows):
            try:
                with ScoringClient("127.0.0.1", server.port, timeout=120) as c:
                    for i in rows:
                        t0 = time.perf_counter()
                        if i % 2:
                            r = c.score(features=records[i])
                        else:
                            r = c.score(text=texts[i])
                        with lock:
                            latencies.append(time.perf_counter() - t0)
                            replies[i] = r
            except BaseException as e:  # re-raised below, after the join
                errors.append(e)

        with server:  # warmup runs every bucket here
            flash_mod.FWD_LAUNCHES = 0
            batches0 = server.stats()["batches"]
            drive([0])  # a lone request: bucket 1
            workers = [threading.Thread(target=drive, args=(range(1 + t, 49, 16),)) for t in range(16)]
            t_burst = time.perf_counter()
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=300)
            burst_s = time.perf_counter() - t_burst
            launches = flash_mod.FWD_LAUNCHES
            batches = server.stats()["batches"] - batches0
        check(not any(w.is_alive() for w in workers), "client threads hung")
        if errors:
            raise errors[0]
    check(sorted(replies) == list(range(49)), f"replies for {len(replies)}/49 requests")
    probs = np.array([replies[i]["prob"] for i in range(49)], np.float64)
    buckets = sorted({replies[i]["bucket"] for i in replies})
    print(f"path: {len(replies)} replies in {batches} batches, buckets {buckets}, K1 launches {launches}", flush=True)
    check(bool(np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all()), "probs not finite in [0, 1]")
    check(len(buckets) >= 2, f"only bucket sizes {buckets} were hit")
    check(launches == cfg.n_layers * batches and batches > 0, f"K1 launched {launches} times for {batches} batches (want {cfg.n_layers} per batch)")

    # The same weights through the plain dot attention on the card.
    dot = ScoreEngine(dataclasses.replace(cfg, attention_impl="dot"), params, pad_id=tok.pad_id)
    want = dot.score(enc["input_ids"], enc["attention_mask"])[0]
    diff = float(np.abs(probs - want).max())
    print(f"path: max|prob_flash - prob_dot| = {diff:.3e} (bf16 atol 1e-2)", flush=True)
    check(diff <= 1e-2, f"flash path disagrees with the dot path: {diff}")
    # fp32 activations: the kernel's fp32 route against dot, tighter.
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    got32 = ScoreEngine(f32, params, pad_id=tok.pad_id).score(enc["input_ids"], enc["attention_mask"])[0]
    want32 = ScoreEngine(dataclasses.replace(f32, attention_impl="dot"), params, pad_id=tok.pad_id).score(
        enc["input_ids"], enc["attention_mask"]
    )[0]
    diff32 = float(np.abs(got32 - want32).max())
    print(f"path: fp32 max|prob_flash - prob_dot| = {diff32:.3e} (atol 1e-4)", flush=True)
    check(diff32 <= 1e-4, f"fp32 flash path disagrees with the dot path: {diff32}")
    lat = np.array(latencies) * 1e3
    print(
        f"path: {device_name}: burst of 48 flows in {burst_s:.3f} s = {48 / burst_s:.1f} flows/s; "
        f"client latency p50 {np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} ms",
        flush=True,
    )
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke run needs a card")

    phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device_name = torch.cuda.get_device_name(0)
    print(f"torch: {device_name}, {torch.cuda.device_count()} card(s), torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase("build")
    t0 = time.monotonic()
    built = _build.build()
    print(f"built {sorted(built) or 'nothing (cached)'} in {time.monotonic() - t0:.1f} s", flush=True)

    phase("kernel")
    k1 = kernel_phase(seed)

    phase("path")
    k1["launches"] = path_phase(seed, device_name)

    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
