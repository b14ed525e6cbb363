#!/usr/bin/env python3
"""Where a served batch's or a train step's time goes on the card.

    python3 chip_profile.py [--mode serve|train|fold|k1|bwd] [--bucket 128] [--seed 0]

``serve`` builds the port's scoring engine for full-width DistilBERT-base
(6 layers, dim 768, 12 heads, L=128, flash attention, bf16, seeded random
weights) and scores one full bucket of token rows a few times under
``torch.profiler``. ``train`` runs the port's ``Trainer`` on the same
model with dropout on (the ``local`` command's configuration, bs16): it
times 100 steps by the host clock for the step's wall time and samples/s,
profiles a few more, then profiles each flash kernel alone at
the training shape (B=16, H=12, L=128, D=64, bf16, dropout 0.1; K1 also at
rate 0 and at the serving shape B=128, on the model's q/k/v views) for
its device time per launch, free of the wrapper's host work.

``fold`` profiles the fold kernel K4 alone on DistilBERT-base's largest
leaf (the 30522 x 768 word embedding) at K=2 and K=8 clients for its
device time per launch, then one round's fold as the aggregation server
runs it: two uploads of the ``client`` command's full-width model (102
leaves), host numpy in and out, each leaf copied to the card, folded and
copied back.

``k1`` weighs K1's design choices where its time is spent: it profiles
the bf16 kernel alone (device time per launch at B=128 rate 0 and B=16
rate 0.1, on the model's q/k/v views) as built and with one choice
undone at a time: each variant is a copy of ``csrc/`` under
``build/k1_variants/`` with a text edit to ``flash_fwd.cu`` (the register
cap removed or tightened, ``expf`` in place of ``exp2f``, the exp2
argument as one FMA), built like the real one. Variants run in turns,
forward then backward, each held to the plain version (bf16 atol 2e-2)
and to the exact keep-mask read-out; registers and spills come from
``nvcc -Xptxas -v``. Then SDPA's device time on the same views, the
yardstick.

``bwd`` does the same for K3 and K2 (``csrc/flash_bwd.cu``, under
``build/bwd_variants/``) at the training shape (B=16, H=12, L=128, bf16,
rate 0.1, the model's q/k/v views and dO in O's layout): as built, with y
and ds fed as one bf16 each, with y as one, with ds as a hi/lo pair, with
the gradient products summed in place, with the two 32-column halves
unrolled, without the register cap or capped for 4 CTAs an SM, and with
the eager delta of the plain version in place of K3's. Each
variant's elements outside the bf16 bound on chip_smoke's hardest cases
(a fully masked batch row, L=200) are reported, not fatal (as built must
have none). Then the device time of SDPA's backward on the same views
with dropout 0.1, the yardstick.

The other modes print per-category device time (the flash kernels K1/K2/K3, K4, GEMMs,
LayerNorm, the optimizer, dropout masks, other elementwise, copies), the
host wall time per call or step, and the device's idle share of that
wall, then one JSON line with the same numbers. Needs CUDA; exits
non-zero without it or when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
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
    _build,
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

    # Each kernel alone: device time per launch at the training shape, K1
    # on the model's layout (views of [B, L, H*D] projections), and K1 at
    # rate 0 at the serving shape B=128 too.
    g = torch.Generator(device="cuda").manual_seed(args.seed)

    def views(b):
        return [
            torch.randn(b, 128, 12 * 64, generator=g, device="cuda").to(torch.bfloat16)
            .reshape(b, 128, 12, 64).transpose(1, 2) for _ in range(3)
        ]

    q, k, v = views(bs)
    bias = make_attention_bias(torch.from_numpy(mask).cuda())
    q128, k128, v128 = views(128)
    bias128 = make_attention_bias(torch.from_numpy(np.tile(mask, (8, 1))).cuda())
    words = flash_mod.draw_seed_words(g)
    x = _bwd_inputs(g, q, k, v, bias, words, 0.1)
    n = 50
    # K3 before K2: it writes the delta K2 reads.
    launches = {
        "flash_fwd (rate 0.1)": lambda: flash_mod.flash_forward(q, k, v, bias, seed=words, rate=0.1),
        "flash_fwd (rate 0)": lambda: flash_mod.flash_forward(q, k, v, bias),
        "flash_fwd (rate 0, B=128)": lambda: flash_mod.flash_forward(q128, k128, v128, bias128),
        "flash_bwd_dq": lambda: flash_mod.flash_bwd_dq(x),
        "flash_bwd_dkdv": lambda: flash_mod.flash_bwd_dkdv(x),
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
        shape = "B=128" if "B=128" in label else f"B={bs}"
        print(f"{card}: {label} alone, {shape} bf16: {alone[label]:.4f} ms device per launch")
    print(json.dumps({"card": card, "mode": "kernels", "device_ms_per_launch": alone}))


def _bwd_inputs(g, q, k, v, bias, words, rate):
    """The backward's operands on the model's layout: K1's O and lse on
    the q/k/v views, and dO as a view of O's [B, L, H, D] storage."""
    out, lse = flash_mod.flash_forward(q, k, v, bias, seed=words, rate=rate)
    do = flash_mod.empty_out(q).copy_(torch.randn(q.shape, generator=g, device="cuda"))
    return flash_mod._BwdInputs(q, k, v, bias, words, out, lse, do, rate)


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


#: K1 variants for --mode k1: name -> (old, new) text edits of flash_fwd.cu.
_LB = "__launch_bounds__(kTcThreads, 4)"
_P = "exp2f((s[n][2 * i + e] - m_new) * kLog2e)"
K1_VARIANTS = {
    "as built": (),
    "no register cap": ((_LB, "__launch_bounds__(kTcThreads)"),),
    "cap for 5 CTAs an SM": ((_LB, "__launch_bounds__(kTcThreads, 5)"),),
    "cap for 6 CTAs an SM": ((_LB, "__launch_bounds__(kTcThreads, 6)"),),
    "expf": (
        ("exp2f((m[i] - m_new) * kLog2e)", "expf(m[i] - m_new)"),
        (_P, "expf(s[n][2 * i + e] - m_new)"),
    ),
    "exp2 argument as one FMA": ((_P, "exp2f(fmaf(s[n][2 * i + e], kLog2e, -m_new * kLog2e))"),),
}


def variant_dir(kind: str, source: str, name: str, edits) -> str:
    """A copy of csrc/ under build/<kind>/ with ``edits`` (old, new, count)
    applied to ``source``; raises if an edit no longer matches the source
    ``count`` times."""
    slug = re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-")
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), kind, slug, "csrc")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, root)
    path = os.path.join(root, source)
    with open(path) as f:
        src = f.read()
    for old, new, *count in edits:
        want = count[0] if count else 1
        if src.count(old) != want:
            raise SystemExit(f"chip_profile: variant {name!r}: {old!r} is not in {source} {want} time(s)")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def ptxas_report(csrc: str, source: str = "flash_fwd.cu") -> str:
    """Registers and spill bytes of each tensor-core kernel instantiation
    in ``source``."""
    out = subprocess.run(
        [_build.nvcc_path(), *(f for f in _build.NVCC_FLAGS if f != "-shared"), "-Xptxas", "-v",
         "-c", os.path.join(csrc, source), "-o", os.path.join(csrc, source + ".o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600,
    ).stdout.splitlines()
    found = []
    for i, line in enumerate(out):
        if "Compiling entry" in line and "tc_kernel" in line:
            rest = " ".join(out[i + 1 : i + 4])
            regs = re.search(r"Used (\d+) registers", rest)
            spill = re.search(r"(\d+) bytes spill stores", rest)
            kernel = re.search(r"(flash_(?:fwd|dq|dkdv)_tc_kernel)", line)
            found.append(f"{kernel.group(1) if kernel else '?'} {'dropout' if 'ILb1' in line else 'rate 0'}: "
                         f"{regs.group(1) if regs else '?'} regs, {spill.group(1) if spill else '?'} B spilled")
    return "; ".join(found)


def profile_k1(card: str, args) -> None:
    """K1 as built and each variant, alone, in turns."""
    g = torch.Generator(device="cuda").manual_seed(args.seed)

    def views(b):
        return [
            torch.randn(b, 128, 12 * 64, generator=g, device="cuda").to(torch.bfloat16)
            .reshape(b, 128, 12, 64).transpose(1, 2) for _ in range(3)
        ]

    shapes = []
    for b, rate in ((128, 0.0), (16, 0.1)):
        mask = (torch.rand(b, 128, generator=g, device="cuda") > 0.3).int()
        mask[:, 0] = 1
        words = flash_mod.draw_seed_words(g) if rate else None
        shapes.append((b, rate, *views(b), make_attention_bias(mask), words))
    dirs = {name: variant_dir("k1_variants", "flash_fwd.cu", name, edits) for name, edits in K1_VARIANTS.items()}
    built_src = _build.CSRC_DIR
    results: dict[str, list[float]] = {}
    order = list(K1_VARIANTS)
    try:
        for name in order + order[::-1]:
            _build.CSRC_DIR = dirs[name]
            _build._libs.clear()
            flash_mod._FNS.clear()
            line = []
            for b, rate, q, k, v, bias, words in shapes:
                out, _ = flash_mod.flash_forward(q, k, v, bias, seed=words, rate=rate)
                ref, _ = flash_mod.flash_attention_reference(q, k, v, bias, seed=words, rate=rate)
                err = (out.float() - ref.float()).abs().max().item()
                if err > 2e-2:
                    raise SystemExit(f"chip_profile: K1 variant {name!r} disagrees with the plain version: {err}")
                n = 50
                with profile(activities=[ProfilerActivity.CUDA]) as kprof:
                    for _ in range(n):
                        flash_mod.flash_forward(q, k, v, bias, seed=words, rate=rate)
                    torch.cuda.synchronize()
                us, count = 0.0, 0
                for key, (t, c) in device_times(kprof).items():
                    if "flash_fwd" in key:
                        us, count = us + t, count + c
                # The profiler may drop a kernel record now and then: the
                # mean is over the launches it recorded.
                if count == 0:
                    raise SystemExit(f"chip_profile: K1 variant {name!r}: no launch recorded")
                results.setdefault(f"{name} B={b} rate={rate}", []).append(us / count / 1e3)
                line.append(f"B={b} rate={rate} {us / count / 1e3:.4f} ms ({count}/{n} recorded)")
            words = torch.tensor([123, 456789], dtype=torch.int64, device="cuda")
            for live_tile in (0, 1):
                bad = _readout_mismatches(words, live_tile)
                if bad:
                    raise SystemExit(f"chip_profile: K1 variant {name!r}: read-out off at {bad} elements")
            print(f"{card}: K1 {name:26s} device per launch: {'; '.join(line)}; read-out exact", flush=True)
    finally:
        _build.CSRC_DIR = built_src
        _build._libs.clear()
        flash_mod._FNS.clear()
    for name in order:
        print(f"{card}: K1 {name:26s} ptxas: {ptxas_report(dirs[name])}", flush=True)
    # The yardstick: SDPA's kernels on the same views (device time a call).
    import torch.nn.functional as F

    sdpa = {}
    for b, rate, q, k, v, bias, _ in shapes:
        mask = bias.to(torch.bfloat16)
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=rate)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as kprof:
            for _ in range(50):
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=rate)
            torch.cuda.synchronize()
        sdpa[f"B={b} rate={rate}"] = sum(t for t, _ in device_times(kprof).values()) / 50 / 1e3
        print(f"{card}: SDPA on the same views, B={b} rate={rate}: {sdpa[f'B={b} rate={rate}']:.4f} ms device per call (all its kernels)", flush=True)
    print(json.dumps({"card": card, "mode": "k1", "device_ms_per_launch": results, "sdpa_device_ms_per_call": sdpa}))


#: K2/K3 variants for --mode bwd: name -> (old, new[, count]) text edits
#: of flash_bwd.cu, each undoing one design choice of the bf16 kernels.
_FRESH = "float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};"
_ADD = "#pragma unroll\n  for (int e = 0; e < 4; ++e) acc[e] += step[e];"
_ROW_DELTA = "const float dlt_row = row_delta(dob, a.sdo.r, ob, a.so.r, drow, Lq, lane & 1);"
_HALVES = "#pragma unroll 1\n    for (int half = 0; half < 2; ++half) {"
BWD_VARIANTS = {
    "as built": (),
    "y and ds as one bf16 each": (
        ("constexpr int kYTerms = 2;", "constexpr int kYTerms = 1;"),
        ("constexpr int kDsTerms = 3;", "constexpr int kDsTerms = 1;"),
    ),
    "y as one bf16": (("constexpr int kYTerms = 2;", "constexpr int kYTerms = 1;"),),
    "ds as a hi/lo pair": (("constexpr int kDsTerms = 3;", "constexpr int kDsTerms = 2;"),),
    "gradient sums in place": (
        (_FRESH, "float* t0 = acc[2 * np]; float* t1 = acc[2 * np + 1];"),
        (_ADD, "(void)acc;\n  (void)step;"),
    ),
    "halves unrolled": ((_HALVES, _HALVES.replace("unroll 1", "unroll"), 2),),
    "no register cap": (
        ("constexpr int kDqMinBlocks = 3;", "constexpr int kDqMinBlocks = 1;"),
        ("constexpr int kDkdvMinBlocks = 3;", "constexpr int kDkdvMinBlocks = 1;"),
    ),
    "cap for 4 CTAs an SM": (
        ("constexpr int kDqMinBlocks = 3;", "constexpr int kDqMinBlocks = 4;"),
        ("constexpr int kDkdvMinBlocks = 3;", "constexpr int kDkdvMinBlocks = 4;"),
    ),
    # K3 reads delta instead of computing it; the profile then runs the
    # plain version's eager rowsum(dO * O) before each K3 launch.
    "eager delta": ((_ROW_DELTA, "const float dlt_row = drow < Lq ? a.delta[(size_t)bh * Lq + drow] : 0.f;"),),
}


def _bwd_bad_elements(g, dev) -> tuple[int, float]:
    """Elements of dq, dk and dv outside the bf16 bound (atol 1e-5 + rtol
    8e-3) against the plain version, and the largest |diff| / bound, over
    chip_smoke's hardest cases: B=16 L=128 and B=2 L=200 with a fully
    masked batch row, rates 0 and 0.1, on the model's views."""
    bad, worst = 0, 0.0
    for b, l, rate in ((16, 128, 0.0), (16, 128, 0.1), (2, 200, 0.1)):
        mask = (torch.rand(b, l, generator=g, device=dev) > 0.3).int()
        mask[:, 0] = 1
        mask[-1] = 0
        bias = make_attention_bias(mask)
        q, k, v = (
            torch.randn(b, l, 12 * 64, generator=g, device=dev).to(torch.bfloat16)
            .reshape(b, l, 12, 64).transpose(1, 2) for _ in range(3)
        )
        words = flash_mod.draw_seed_words(g) if rate else None
        x = _bwd_inputs(g, q, k, v, bias, words, rate)
        got = flash_mod.flash_backward(q, k, v, bias, words, x.out, x.lse, x.do, rate=rate)
        want = flash_mod.flash_backward_reference(q, k, v, bias, words, x.out, x.lse, x.do, rate=rate)
        for a, w in zip(got[:3], want[:3]):
            bound = 1e-5 + 8e-3 * w.float().abs()
            ratio = (a.float() - w.float()).abs() / bound
            bad += int((ratio > 1).sum())
            worst = max(worst, ratio.max().item())
    return bad, worst


def profile_bwd(card: str, args) -> None:
    """K3 and K2 as built and each variant, alone, in turns; then SDPA's
    backward on the same views."""
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    b, l, rate = 16, 128, 0.1
    mask = (torch.rand(b, l, generator=g, device="cuda") > 0.3).int()
    mask[:, 0] = 1
    bias = make_attention_bias(mask)
    q, k, v = (
        torch.randn(b, l, 12 * 64, generator=g, device="cuda").to(torch.bfloat16)
        .reshape(b, l, 12, 64).transpose(1, 2) for _ in range(3)
    )
    words = flash_mod.draw_seed_words(g)
    dirs = {name: variant_dir("bwd_variants", "flash_bwd.cu", name, edits) for name, edits in BWD_VARIANTS.items()}
    built_src = _build.CSRC_DIR
    results: dict[str, list[float]] = {}
    accuracy: dict[str, tuple[int, float]] = {}
    order = list(BWD_VARIANTS)
    n = 50

    def alone(fn, frag: str, before=None) -> tuple[float, float, int]:
        """(device ms a launch of the kernel, of everything else, launches
        recorded) over n calls of ``before`` then ``fn``."""
        with profile(activities=[ProfilerActivity.CUDA]) as kprof:
            for _ in range(n):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        us, other, count = 0.0, 0.0, 0
        for key, (t, c) in device_times(kprof).items():
            if frag in key:
                us, count = us + t, count + c
            else:
                other += t
        if count == 0:
            raise SystemExit(f"chip_profile: no {frag} launch recorded")
        # The profiler may drop a kernel record now and then: the mean is
        # over the launches it recorded.
        return us / count / 1e3, other / n / 1e3, count

    try:
        for name in order + order[::-1]:
            _build.CSRC_DIR = dirs[name]
            _build._libs.clear()
            flash_mod._FNS.clear()
            x = _bwd_inputs(g, q, k, v, bias, words, rate)
            eager = name == "eager delta"

            def fill_delta():
                x.delta = flash_mod._delta(x.do, x.out)

            if name not in accuracy:
                if eager:  # flash_backward does not fill delta for this variant
                    accuracy[name] = (-1, float("nan"))
                else:
                    accuracy[name] = _bwd_bad_elements(torch.Generator(device="cuda").manual_seed(args.seed + 1), "cuda")
                    if name == "as built" and accuracy[name][0]:
                        raise SystemExit(f"chip_profile: K2/K3 as built break the bf16 bound at {accuracy[name][0]} elements")
            flash_mod.flash_bwd_dq(x)  # a first launch, and delta for K2
            flash_mod.flash_bwd_dkdv(x)
            torch.cuda.synchronize()
            t3, t_eager, c3 = alone(lambda: flash_mod.flash_bwd_dq(x), "flash_dq", fill_delta if eager else None)
            t2, _, c2 = alone(lambda: flash_mod.flash_bwd_dkdv(x), "flash_dkdv")
            results.setdefault(f"{name} K3", []).append(t3)
            results.setdefault(f"{name} K2", []).append(t2)
            extra = f" + eager delta {t_eager:.4f} ms" if eager else ""
            print(f"{card}: K2/K3 {name:26s} device per launch: K3 {t3:.4f} ms{extra} ({c3}/{n} recorded); K2 {t2:.4f} ms ({c2}/{n})", flush=True)
    finally:
        _build.CSRC_DIR = built_src
        _build._libs.clear()
        flash_mod._FNS.clear()
    for name in order:
        bad, worst = accuracy[name]
        acc = "not checked" if bad < 0 else f"{bad} elements outside the bf16 bound, worst |diff|/bound {worst:.3f}"
        print(f"{card}: K2/K3 {name:26s} accuracy: {acc}; ptxas: {ptxas_report(dirs[name], 'flash_bwd.cu')}", flush=True)
    # The yardstick: SDPA's backward kernels on the same views, dropout 0.1
    # (device time a call, every kernel of the backward).
    import torch.nn.functional as F

    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias.to(torch.bfloat16), dropout_p=rate)
    do = flash_mod.empty_out(q).copy_(torch.randn(q.shape, generator=g, device="cuda"))
    grad = lambda: torch.autograd.grad(o, (qs, ks, vs), do, retain_graph=True)  # noqa: E731
    grad()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as kprof:
        for _ in range(n):
            grad()
        torch.cuda.synchronize()
    per = device_times(kprof)
    sdpa = sum(t for t, _ in per.values()) / n / 1e3
    names = ", ".join(f"{key[:60]} x{c // n}" for key, (_, c) in sorted(per.items(), key=lambda kv: -kv[1][0])[:4])
    print(f"{card}: SDPA backward on the same views, B={b} rate={rate}: {sdpa:.4f} ms device per call (its kernels: {names})", flush=True)
    print(json.dumps({"card": card, "mode": "bwd", "device_ms_per_launch": results,
                      "bad_elements": {k: v[0] for k, v in accuracy.items()},
                      "sdpa_backward_device_ms_per_call": sdpa}))


def _readout_mismatches(words, live_tile: int) -> int:
    """The keep-mask read-out of chip_smoke.py (q = k = 0, one-hot v, the
    other 64-key tile masked) at rate 0.5 in bf16: elements where ``32·O``
    is not the keep bit."""
    b, h, l, d = 2, 3, 128, 64
    q = torch.zeros(b, h, l, d, dtype=torch.bfloat16, device="cuda")
    keys = torch.arange(l, device="cuda")
    v = (keys[:, None] % d == torch.arange(d, device="cuda")).to(torch.bfloat16).expand(b, h, l, d).contiguous()
    mask = torch.zeros(b, l, dtype=torch.int32, device="cuda")
    mask[:, live_tile * 64 : (live_tile + 1) * 64] = 1
    out, _ = flash_mod.flash_forward(q, q, v, make_attention_bias(mask), seed=words, rate=0.5)
    o = out.float().cpu()
    return sum(
        int((o[bi, hi] * 32 != flash_mod.keep_mask_reference(words, bi, hi, 0, live_tile * 64, l, d, 0.5)).sum())
        for bi in range(b) for hi in range(h)
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["serve", "train", "fold", "k1", "bwd"], default="serve")
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
    if args.mode == "k1":
        profile_k1(card, args)
        return 0
    if args.mode == "bwd":
        profile_bwd(card, args)
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
