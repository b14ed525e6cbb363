#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero before the last line is printed:

1. card   — the card's name and power limit (nvidia-smi) and torch's name;
2. build  — every CUDA kernel of the port, compiled from csrc/ (one nvcc
            per source, all started together);
3. kernel — the flash forward kernel (K1) held against its plain PyTorch
            version on the card at the serving shapes (B in 1/8/32/128,
            H=12, L=128, D=64, random key masks with fully masked rows,
            plus ragged lengths), in fp32 (atol 2e-5) and bf16 (atol 2e-2:
            p and O each take one bf16 rounding; lse compared in fp32);
            again on the layouts the model hands over (views of three
            [B, L, 768] projections, and the chunks of one fused
            [B, L, 2304] product) at the same bounds, with O stored as
            [B, L, H, D]; a misaligned or last-dim-strided input must
            raise and launch nothing. Then its time on the model's views
            beside its time on dense copies, the plain version's, SDPA's
            on the same views (a yardstick the port never calls) and the
            least time the card could take;
4. kernel-train — first the keep-mask read-out (q = k = 0, a one-hot v,
            one 64-key tile masked; B=2, H=3, L=128) in fp32 and bf16 at
            rates 0.1 and 0.5 with either key tile live: ``(O != 0)`` must
            equal keep_mask_reference bit for bit, and at rate 0.5
            ``32·O`` must equal it; and the same bits out of K2's dv and
            K3's dq (bwd_readout_inputs), compared exactly. Then at the
            training shapes (B=16, H=12, L=128, D=64, plus L in {40, 200},
            plus the model's split and fused views with dO in O's
            [B, L, H, D] layout; a fully masked row in all but one case):
            K1 with dropout at rate 0.1 against flash_attention_reference
            on the same seed words, and K3 + K2 through FlashAttention's
            backward against flash_backward_reference with dropout off
            and on, in fp32 (K1 atol 2e-5; gradients atol 1e-4, the JAX
            flash gradient bound) and bf16 (K1 atol 2e-2; gradients atol
            1e-5 + rtol 8e-3: both sides round one fp32 result to bf16,
            so they may differ by one bf16 ulp, at most 2^-7 relative);
            dbias atol 1e-3 (an fp32 sum over H·Lq terms in another
            order); flash_backward must copy no dO, return dq/dk/dv as
            [B, L, H, D] storage, and give the same bits twice. Then the
            times of K1 with dropout (on the model's views, and on dense
            copies), K3 and K2 at B=16 bf16 on the model's layout, each
            beside its plain version's, SDPA's (forward with dropout, and
            its backward alone: a yardstick the port never calls) and its
            bound;
5. path   — full-width DistilBERT-base (6 layers, dim 768, 12 heads,
            L=128, flash attention, bf16) with seeded random weights,
            written as a registry artifact and served by the port's
            ``infer-serve`` on the card; a few dozen concurrent text and
            features requests through the port's client. Every prob must
            be finite in [0, 1] and match the same weights through
            attention_impl="dot" on the card (bf16 atol 1e-2), and the
            kernel must have launched once per layer of every batch;
6. train  — ``local`` at full width (``--preset distilbert
            --attention-impl flash --synthetic 2400 --epochs 1``: 9 steps
            of bs16 with dropout on, then val and test evaluation) through
            the port's parser. K1 with dropout, K2 and K3 must launch once
            per layer of every step (and the backward copy no dO), K1 at
            rate 0 once per layer of every eval batch; every loss and the
            metrics CSV must be finite.
            Then 108 more steps (the epoch's 9 batches 12 times) time the
            steady training samples/s. Then one fp32 step
            with dropout off: gradients through flash against the dot path
            on the card (atol 1e-4 + rtol 1e-3); and 20 steps on one fixed
            batch with dropout off must bring the loss below its first
            value;
7. kernel-fold — the fold kernel K4 against its plain version on the
            card and against numpy's ``acc += float32(w) * x`` on the
            host, with no tolerance (``array_equal``): K in {1, 2, 8} over
            the word-embedding leaf (23,440,896 elements) and n in {1, 3,
            768, 32769}, scales 10^-4..10^4, subnormal inputs, repeated
            calls giving the same bits. Then the times at K=2 and K=8 on
            that leaf, beside the plain version's, ``torch.mv``'s (a
            yardstick the port never calls) and the bound, and the
            aggregator's host-to-device copies, kernel and copy back;
8. round    — one FedAvg round of full-width DistilBERT-base on loopback:
            the port's ``serve`` (2 clients, fold on the card) in a
            thread and two port ``client``s in threads (``--preset
            distilbert --attention-impl flash --synthetic 2400 --epochs 1
            --rounds 1``), all through the port's parser. K4 must launch
            once per parameter leaf (102); both clients must receive the
            same bytes, whose crc equals that of ``fold_reference`` over
            the two uploads as sent; K1 with dropout, K2 and K3 once per
            layer of every step of both clients; both aggregated metrics
            CSVs finite. Prints the round's time split;
9. the kernels' JSON line (K1 as its two instantiations, rate 0 at the
   serving shape and dropout at the training shape, then K2, K3 and K4),
   then the result line
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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.comm import (
    build_server as build_round_server,
    run_client,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.local import (
    run_local,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    wire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
    build_server,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.distilbert import (
    build_trainable_params,
    model_skeleton,
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
    ScoringClient,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
    loss_fn,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
BUCKETS = (1, 8, 32, 128)
H, L, D = 12, 128, 64
B_TRAIN = 16  # DataConfig.batch_size
STEADY_PASSES = 12  # passes over the epoch's 9 batches timed for samples/s
RATE = 0.1  # ModelConfig.attention_dropout
PORT = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch"
JAX_FLASH = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu/ops/flash_attention.py"
JAX_FOLD = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu/ops/fold.py"
EMBED_N = 30522 * 768  # the word-embedding leaf, DistilBERT-base's largest


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


def backward_bound(b: int, h: int, l: int, d: int, elsize: int, kernel: str) -> tuple[float, str]:
    """Least time (ms) for K2 ("dkdv") or K3 ("dq"), each input read once
    and each output written once: q, k, v, dO, lse, the key bias, and for
    K2 the delta K3 wrote, out dk, dv and the fp32 per-head dbias rows;
    for K3 also O, out dq and delta. 4 (K2) or 3 (K3) products of 2·L·L·D
    flops per (b, h) at the bf16 peak."""
    rows = b * h * l
    tile = rows * d * elsize
    nbytes = 4 * tile + rows * 4 + b * l * 4  # q, k, v, dO, lse, key bias
    if kernel == "dkdv":  # delta in; dk, dv and the dbias rows out
        nbytes += rows * 4 + 2 * tile + rows * 4
        flops = 4 * 2 * b * h * l * l * d
    else:  # O in; dq and delta out
        nbytes += 2 * tile + rows * 4
        flops = 3 * 2 * b * h * l * l * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def split_heads(t: torch.Tensor) -> torch.Tensor:
    """``[B, L, H*D] -> [B, H, L, D]``, a view: the model's ``split``."""
    b, l, _ = t.shape
    return t.reshape(b, l, H, D).transpose(1, 2)


def attention_inputs(g, b, l, dtype, fully_masked_row, layout="dense"):
    """q, k, v ``[b, H, l, D]`` and a key bias. ``layout``: "dense"
    (contiguous), "split" (views of three ``[b, l, H*D]`` projections, as
    the model's separate q/k/v hand them over) or "fused" (the chunks of
    one ``[b, l, 3*H*D]`` product, the model's ``fused_qkv``)."""
    if layout == "dense":
        q, k, v = (
            torch.randn(b, H, l, D, generator=g, device="cuda").to(dtype)
            for _ in range(3)
        )
    elif layout == "split":
        q, k, v = (
            split_heads(torch.randn(b, l, H * D, generator=g, device="cuda").to(dtype))
            for _ in range(3)
        )
    else:
        qkv = torch.randn(b, l, 3 * H * D, generator=g, device="cuda").to(dtype)
        q, k, v = (split_heads(t) for t in qkv.chunk(3, dim=-1))
    mask = (torch.rand(b, l, generator=g, device="cuda") > 0.3).to(torch.int32)
    mask[:, 0] = 1
    if fully_masked_row:
        mask[-1] = 0  # a bucket pad row: every key masked
    return q, k, v, make_attention_bias(mask)


#: The keep-mask read-out's shape (B, H, L): both 64-row query tiles, a
#: nonzero batch and head index, and both 64-key tiles are read.
READOUT = (2, 3, 128)
KEY_TILE = 64


def readout_inputs(dtype, live_tile: int, device="cuda"):
    """The keep-mask read-out: q = k = 0, ``v[key, d] = 1`` iff
    ``d == key % 64``, and every key outside the 64-key tile ``live_tile``
    masked by the bias. Every live key then scores 0 and gets p = 1 and
    l = 64, so ``O[b, h, q, d] = keep(b, h, q, 64·live_tile + d) · inv / 64``:
    O is nonzero exactly where the keep bit is set, and at rate 0.5
    ``32·O`` is the mask itself. A keep bit hashed at a wrong fragment
    coordinate moves O by ~0.009 at L=128, inside the bf16 bound of 2e-2,
    so only this read-out catches it."""
    b, h, l = READOUT
    q = torch.zeros(b, h, l, D, dtype=dtype, device=device)
    keys = torch.arange(l, device=device)
    v = (keys[:, None] % D == torch.arange(D, device=device)).to(dtype)
    v = v.expand(b, h, l, D).contiguous()
    mask = torch.zeros(b, l, dtype=torch.int32, device=device)
    mask[:, live_tile * KEY_TILE : (live_tile + 1) * KEY_TILE] = 1
    return q, q.clone(), v, make_attention_bias(mask)


def bwd_readout_inputs(dtype, live_tile: int, kernel: str, device="cuda"):
    """The backward's keep-mask read-out, ``(q, k, v, dO)`` at the
    read-out shape with no bias: q = 0, so every score is 0 and p = 1/L.

    K2 (``kernel="dkdv"``): k = 0, v = 1 and ``dO[q, d] = 1`` iff query q
    lies in the 64-query tile ``live_tile`` and ``d == q % 64``. Then
    ``dv[key, d] = y[64·live_tile + d, key] = keep · inv / L``: dv is
    nonzero exactly where the keep bit of (query 64·live_tile + d, key)
    is set.

    K3 (``kernel="dq"``): ``k[key, d] = 1`` iff key lies in the 64-key tile
    ``live_tile`` and ``d == key % 64``, v = 1 and ``dO[q, d] = 1`` iff
    ``d == q % 64``. Then dP = 1 everywhere, ``delta[q] = O[q, q % 64]`` is
    inv times the kept share f of row q, ``ds = p · inv · (keep - f)`` and
    ``dq[q, d] = scale · ds[q, 64·live_tile + d]``: dq is positive exactly
    where the bit is set and negative where it is not (every row keeps
    some keys and drops some)."""
    b, h, l = READOUT
    rows = torch.arange(l, device=device)
    one_hot = (rows[:, None] % D == torch.arange(D, device=device)).to(dtype)
    in_tile = ((rows // KEY_TILE) == live_tile).to(dtype)[:, None]
    zeros = torch.zeros(b, h, l, D, dtype=dtype, device=device)
    ones = torch.ones(b, h, l, D, dtype=dtype, device=device)
    if kernel == "dkdv":
        return zeros, zeros.clone(), ones, (one_hot * in_tile).expand(b, h, l, D).contiguous()
    k = (one_hot * in_tile).expand(b, h, l, D).contiguous()
    return zeros, k, ones, one_hot.expand(b, h, l, D).contiguous()


def bwd_readout(dtype, live_tile: int, kernel: str, words, rate: float, device="cuda") -> torch.Tensor:
    """K1, then K3 and K2, on :func:`bwd_readout_inputs`: dv (``"dkdv"``)
    or dq (``"dq"``)."""
    q, k, v, do = bwd_readout_inputs(dtype, live_tile, kernel, device)
    out, lse = flash_mod.flash_forward(q, k, v, seed=words, rate=rate)
    dq, _, dv, _ = flash_mod.flash_backward(q, k, v, None, words, out, lse, do, rate=rate)
    return dv if kernel == "dkdv" else dq


def bwd_readout_mismatches(grad: torch.Tensor, words, live_tile: int, rate: float, kernel: str) -> int:
    """Elements where :func:`bwd_readout`'s gradient disagrees with
    keep_mask_reference: for dv, ``dv != 0`` against the bits of (query
    64·live_tile + d, key); for dq, ``dq > 0`` against the bits of (query,
    key 64·live_tile + d), plus every dq that is exactly 0."""
    g = grad.float().cpu()
    l = g.shape[2]
    bad = 0
    for bi in range(g.shape[0]):
        for hi in range(g.shape[1]):
            if kernel == "dkdv":
                want = flash_mod.keep_mask_reference(words, bi, hi, live_tile * KEY_TILE, 0, KEY_TILE, l, rate)
                bad += int(((g[bi, hi] != 0).float().T != want).sum())
            else:
                want = flash_mod.keep_mask_reference(words, bi, hi, 0, live_tile * KEY_TILE, l, KEY_TILE, rate)
                bad += int(((g[bi, hi] > 0).float() != want).sum() + (g[bi, hi] == 0).sum())
    return bad


def readout_mismatches(out: torch.Tensor, words, live_tile: int, rate: float) -> int:
    """Elements where ``(O != 0)`` is not ``keep_mask_reference``'s bit
    for the live key tile, plus, at rate 0.5, where ``32·O`` is not it."""
    o = out.float().cpu()
    bad = 0
    for bi in range(o.shape[0]):
        for hi in range(o.shape[1]):
            want = flash_mod.keep_mask_reference(words, bi, hi, 0, live_tile * KEY_TILE, o.shape[2], KEY_TILE, rate)
            bad += int(((o[bi, hi] != 0).float() != want).sum())
            if rate == 0.5:
                bad += int((o[bi, hi] * 32 != want).sum())
    return bad


def kernel_phase(seed: int) -> dict:
    """Phase 3: K1 against its plain version on dense and strided
    layouts, its refusals, then its times."""
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
        # The layouts the model hands over: read through strides, no copy;
        # O is [B, L, H, D] storage.
        for layout in ("split", "fused"):
            for b, l in ((8, L), (BUCKETS[-1], L), (3, 40)):
                q, k, v, bias = attention_inputs(g, b, l, dtype, True, layout)
                check(not q.is_contiguous(), f"the {layout} layout gave dense q")
                out, lse = flash_mod.flash_forward(q, k, v, bias)
                torch.cuda.synchronize()
                ref, ref_lse = flash_mod.flash_attention_reference(q, k, v, bias)
                err = (out.float() - ref.float()).abs().max().item()
                lse_ok = bool(((lse - ref_lse).abs() <= 2e-5 + 2e-7 * ref_lse.abs()).all())
                layout_ok = out.shape == q.shape and out.transpose(1, 2).is_contiguous()
                print(f"K1 check {str(dtype):14s} B={b:3d} L={l:3d} {layout:5s} views max|O-ref|={err:.3e} (atol {atol}) O stored [B,L,H,D] {layout_ok}", flush=True)
                check(err <= atol and lse_ok, f"K1 on {layout} views disagrees: {err} > {atol} (lse ok {lse_ok}) at B={b} L={l} {dtype}")
                check(layout_ok, f"K1's O is not [B, L, H, D] storage: strides {out.stride()}")
                if dtype == torch.bfloat16 and l == L:
                    bf16_err = max(bf16_err, err)
    # What the kernel does not take raises, and launches nothing.
    base = torch.zeros(2, H, L, 2 * D, dtype=torch.bfloat16, device="cuda")
    before = flash_mod.FWD_LAUNCHES
    for what, bad in (("misaligned rows", base[..., 1 : D + 1]), ("a strided last dim", base[..., ::2])):
        try:
            flash_mod.flash_forward(bad, bad, bad)
        except ValueError as e:
            print(f"K1 refuses {what}: {e}", flush=True)
        else:
            fail(f"K1 took {what}")
    check(flash_mod.FWD_LAUNCHES == before, "a refused layout launched K1")
    times = {}
    for b in BUCKETS:
        q, k, v, bias = attention_inputs(g, b, L, torch.bfloat16, True, "split")
        qd, kd, vd = (t.contiguous() for t in (q, k, v))
        mask_bf16 = bias.to(torch.bfloat16)
        t_k = time_ms(lambda: flash_mod.flash_forward(q, k, v, bias))
        t_d = time_ms(lambda: flash_mod.flash_forward(qd, kd, vd, bias))
        t_p = time_ms(lambda: flash_mod.flash_attention_reference(q, k, v, bias))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask_bf16))
        bound, bound_by = attention_bound(b, H, L, D, 2)
        times[b] = (t_k, t_p, t_l, bound, bound_by)
        print(f"K1 time B={b:3d} bf16 kernel_ms={t_k:.4f} (the model's views) dense_ms={t_d:.4f} plain_ms={t_p:.4f} library_ms(SDPA, same views)={t_l:.4f} bound_us={bound * 1e3:.1f} ({bound_by})", flush=True)
    t_k, t_p, t_l, bound, bound_by = times[BUCKETS[-1]]
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": f"{PORT}/csrc/flash_fwd.cu",
        "replaces": f"{JAX_FLASH}:135",
        "launches": None,
        "max_abs_err": bf16_err,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": t_l,
    }


def max_excess(a: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> tuple[float, bool]:
    """(max |a - ref|, whether every element is within atol + rtol·|ref|)."""
    diff = (a.float() - ref.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * ref.float().abs()).all())


def train_kernel_phase(seed: int) -> tuple[dict, dict, dict]:
    """Phase 4: K1 with dropout, K2 and K3 against their plain versions
    at the training shapes, then their times. Returns the kernels-line
    entries of K1 with dropout, K2 and K3."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cases = [(B_TRAIN, L, True, "dense"), (B_TRAIN, L, False, "dense"), (3, 40, True, "dense"),
             (2, 200, True, "dense"), (B_TRAIN, L, True, "split"), (3, 40, True, "fused")]
    bounds = {torch.float32: (2e-5, 1e-4, 0.0), torch.bfloat16: (2e-2, 1e-5, 8e-3)}
    errs = {"fwd": 0.0, "dkdv": 0.0, "dq": 0.0}
    for dtype, (fwd_atol, atol, rtol) in bounds.items():
        # The keep-mask read-out: K1's dropout coordinates, bit for bit.
        for rate in (RATE, 0.5):
            for live_tile in (0, 1):
                words = torch.randint(0, 2**32, (2,), generator=g, device="cuda", dtype=torch.int64)
                out, _ = flash_mod.flash_forward(*readout_inputs(dtype, live_tile), seed=words, rate=rate)
                bad = readout_mismatches(out, words, live_tile, rate)
                print(f"K1 keep-mask read-out {str(dtype):14s} rate={rate} live key tile {live_tile}: {bad} of {out.numel()} elements differ from keep_mask_reference", flush=True)
                check(bad == 0, f"K1's dropout mask is off at {bad} elements ({dtype}, rate {rate}, key tile {live_tile})")
                # The same bits out of K2's dv and K3's dq.
                for kernel, what in (("dkdv", "K2 dv"), ("dq", "K3 dq")):
                    grad = bwd_readout(dtype, live_tile, kernel, words, rate)
                    bad = bwd_readout_mismatches(grad, words, live_tile, rate, kernel)
                    print(f"{what} keep-mask read-out {str(dtype):14s} rate={rate} live tile {live_tile}: {bad} of {grad.numel()} elements differ from keep_mask_reference", flush=True)
                    check(bad == 0, f"{what}'s dropout mask is off at {bad} elements ({dtype}, rate {rate}, tile {live_tile})")
        for b, l, masked_row, layout in cases:
            q, k, v, bias = attention_inputs(g, b, l, dtype, masked_row, layout)
            do = torch.randn(b, H, l, D, generator=g, device="cuda").to(dtype)
            if layout != "dense":  # the model's dO: a view of O's [B, L, H, D] storage
                do = flash_mod.empty_out(q).copy_(do)
            words = torch.randint(0, 2**32, (2,), generator=g, device="cuda", dtype=torch.int64)
            out, lse = flash_mod.flash_forward(q, k, v, bias, seed=words, rate=RATE)
            ref, ref_lse = flash_mod.flash_attention_reference(q, k, v, bias, seed=words, rate=RATE)
            err = (out.float() - ref.float()).abs().max().item()
            lse_ok = bool(((lse - ref_lse).abs() <= 2e-5 + 2e-7 * ref_lse.abs()).all())
            check(err <= fwd_atol and lse_ok, f"K1 with dropout disagrees: {err} > {fwd_atol} (lse ok {lse_ok}) at B={b} L={l} {dtype}")
            if dtype == torch.bfloat16 and l == L:
                errs["fwd"] = max(errs["fwd"], err)
            for rate in (0.0, RATE):
                seed_words = words if rate else None
                qg, kg, vg, bg = (t.detach().clone().requires_grad_(True) for t in (q, k, v, bias))
                before = (flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES)
                o = flash_mod.FlashAttention.apply(qg, kg, vg, bg, seed_words, rate)
                o.backward(do)
                torch.cuda.synchronize()
                check((flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES) == (before[0] + 1, before[1] + 1),
                      "FlashAttention's backward did not launch K2 and K3")
                _, lse_k = flash_mod.flash_forward(q, k, v, bias, seed=seed_words, rate=rate)
                want = flash_mod.flash_backward_reference(q, k, v, bias, seed_words, o.detach(), lse_k, do, rate=rate)
                line = []
                for name, got, ref_g in (("dq", qg.grad, want[0]), ("dk", kg.grad, want[1]), ("dv", vg.grad, want[2])):
                    check(got.dtype == dtype and bool(torch.isfinite(got.float()).all()), f"{name} not finite / wrong dtype at B={b} L={l} {dtype}")
                    e, ok = max_excess(got, ref_g, atol, rtol)
                    check(ok, f"{name} disagrees with its plain version: max {e} (atol {atol}, rtol {rtol}) at B={b} L={l} rate={rate} {dtype}")
                    line.append(f"{name} {e:.3e}")
                    if dtype == torch.bfloat16 and l == L:
                        key = "dq" if name == "dq" else "dkdv"
                        errs[key] = max(errs[key], e)
                e, ok = max_excess(bg.grad, want[3], 1e-3, 0.0)
                check(ok, f"dbias disagrees: {e} at B={b} L={l} rate={rate} {dtype}")
                # Straight through flash_backward: the gradients as
                # [B, L, H, D] storage, no copy of dO, the same bits again.
                copies = flash_mod.BWD_DO_COPIES
                got = flash_mod.flash_backward(q, k, v, bias, seed_words, o.detach(), lse_k, do, rate=rate)
                again = flash_mod.flash_backward(q, k, v, bias, seed_words, o.detach(), lse_k, do, rate=rate)
                torch.cuda.synchronize()
                check(flash_mod.BWD_DO_COPIES == copies, f"the backward copied dO ({layout}, strides {do.stride()})")
                check(all(t.transpose(1, 2).is_contiguous() for t in got[:3]),
                      f"dq/dk/dv are not [B, L, H, D] storage: strides {[t.stride() for t in got[:3]]}")
                check(all(torch.equal(a, w) for a, w in zip(got, again)), f"repeated backward calls differ at B={b} L={l} rate={rate} {dtype}")
                check(all(torch.equal(a, w) for a, w in zip(got[:3], (qg.grad, kg.grad, vg.grad))),
                      f"flash_backward and autograd disagree at B={b} L={l} rate={rate} {dtype}")
                print(f"K2/K3 check {str(dtype):14s} B={b:2d} L={l:3d} {layout:5s} rate={rate} max|grad-ref|: {' '.join(line)} dbias {e:.3e}; K1 drop max|O-ref|={err:.3e}", flush=True)

    # Times at the training shape, bf16, dropout on.
    q, k, v, bias = attention_inputs(g, B_TRAIN, L, torch.bfloat16, True)
    do = torch.randn(B_TRAIN, H, L, D, generator=g, device="cuda").to(torch.bfloat16)
    words = torch.randint(0, 2**32, (2,), generator=g, device="cuda", dtype=torch.int64)
    mask_bf16 = bias.to(torch.bfloat16)
    qv, kv, vv = (split_heads(t.transpose(1, 2).reshape(B_TRAIN, L, H * D)) for t in (q, k, v))
    # The backward on the model's layout: q/k/v views of [B, L, H*D]
    # projections, dO a view of O's [B, L, H, D] storage.
    out, lse = flash_mod.flash_forward(qv, kv, vv, bias, seed=words, rate=RATE)
    do = flash_mod.empty_out(qv).copy_(do)
    copies = flash_mod.BWD_DO_COPIES
    x = flash_mod._BwdInputs(qv, kv, vv, bias, words, out, lse, do, RATE)
    check(flash_mod.BWD_DO_COPIES == copies, "the backward copied the model's dO")
    ref_args = (qv, kv, vv, bias, words, out, lse, do)
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (qv, kv, vv))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask_bf16, dropout_p=RATE)
    t_lib_bwd = time_ms(lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do, retain_graph=True))
    fwd = {
        "name": "flash_fwd_dropout",
        "route": "cuda",
        "source": f"{PORT}/csrc/flash_fwd.cu",
        "replaces": f"{JAX_FLASH}:135",
        "launches": None,
        "max_abs_err": errs["fwd"],
        "ms": time_ms(lambda: flash_mod.flash_forward(qv, kv, vv, bias, seed=words, rate=RATE)),
        "plain_ms": time_ms(lambda: flash_mod.flash_attention_reference(qv, kv, vv, bias, seed=words, rate=RATE)),
    }
    t_dense = time_ms(lambda: flash_mod.flash_forward(q, k, v, bias, seed=words, rate=RATE))
    fwd["bound_ms"], fwd["bound_by"] = attention_bound(B_TRAIN, H, L, D, 2)
    fwd["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qv, kv, vv, attn_mask=mask_bf16, dropout_p=RATE))
    print(f"K1 dropout time B={B_TRAIN} bf16 rate={RATE} kernel_ms={fwd['ms']:.4f} (the model's views) dense_ms={t_dense:.4f} plain_ms={fwd['plain_ms']:.4f} library_ms(SDPA, same views)={fwd['library_ms']:.4f} bound_us={fwd['bound_ms'] * 1e3:.1f} ({fwd['bound_by']})", flush=True)
    rows = [fwd]
    # K3 first: it writes the delta K2 reads.
    for name, kernel, launch, plain in (
        ("flash_bwd_dq", "dq", lambda: flash_mod.flash_bwd_dq(x),
         lambda: flash_mod.flash_dq_reference(*ref_args, rate=RATE)),
        ("flash_bwd_dkdv", "dkdv", lambda: flash_mod.flash_bwd_dkdv(x),
         lambda: flash_mod.flash_dkdv_reference(*ref_args, rate=RATE)),
    ):
        t_k, t_p = time_ms(launch), time_ms(plain)
        bound, bound_by = backward_bound(B_TRAIN, H, L, D, 2, kernel)
        print(f"{name} time B={B_TRAIN} bf16 rate={RATE} kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms(SDPA backward, both halves)={t_lib_bwd:.4f} bound_us={bound * 1e3:.1f} ({bound_by})", flush=True)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"{PORT}/csrc/flash_bwd.cu",
            "replaces": f"{JAX_FLASH}:{196 if kernel == 'dkdv' else 261}",
            "launches": None,
            "max_abs_err": errs[kernel],
            "ms": t_k,
            "plain_ms": t_p,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": t_lib_bwd,
        })
    # The kernels line lists K2 before K3.
    return rows[0], rows[2], rows[1]


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
            flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
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
            check(flash_mod.FWD_DROPOUT_LAUNCHES == 0, "serving launched K1 with dropout")
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


def train_phase(seed: int, card: str) -> dict[str, int]:
    """Phase 6: ``local`` at full width on the card (``card``: its name and
    power limit, as nvidia-smi gives them). Returns each kernel's
    launches during it."""
    with tempfile.TemporaryDirectory() as out_dir:
        args = build_parser().parse_args(
            ["local", "--preset", "distilbert", "--attention-impl", "flash",
             "--synthetic", "2400", "--epochs", "1", "--seed", str(seed),
             "--output-dir", out_dir]
        )
        flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
        flash_mod.DKDV_LAUNCHES = flash_mod.DQ_LAUNCHES = flash_mod.BWD_DO_COPIES = 0
        res = run_local(args)
        torch.cuda.synchronize()
        launches = {
            "flash_fwd": flash_mod.FWD_LAUNCHES,
            "flash_fwd_dropout": flash_mod.FWD_DROPOUT_LAUNCHES,
            "flash_bwd_dkdv": flash_mod.DKDV_LAUNCHES,
            "flash_bwd_dq": flash_mod.DQ_LAUNCHES,
        }
        do_copies = flash_mod.BWD_DO_COPIES
        with open(res["metrics_csv"]) as f:
            header, values = f.read().strip().splitlines()
    cfg, state, trainer = res["config"], res["state"], res["trainer"]
    mcfg = cfg.model
    check(trainer.device.type == "cuda", f"trainer on {trainer.device}")
    check((mcfg.dim, mcfg.n_layers, mcfg.n_heads, mcfg.hidden_dim, mcfg.max_len) == (768, 6, 12, 3072, 128), f"not full width: {mcfg}")
    check(mcfg.compute_dtype == "bfloat16" and mcfg.attention_impl == "flash" and mcfg.attention_dropout == RATE, f"config {mcfg}")
    steps = state.step
    eval_batches = sum(-(-res[s]["n"] // cfg.data.eval_batch_size) for s in ("val", "test"))
    print(f"train: {steps} steps of bs{cfg.data.batch_size}, {eval_batches} eval batches, epoch losses {res['losses']}, launches {launches}, dO copies {do_copies}", flush=True)
    check(steps == 9, f"{steps} train steps, want 9 (2400 x 0.1 x 0.6 / 16)")
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == mcfg.n_layers * steps,
          f"K1-dropout/K2/K3 launches {launches} for {steps} steps")
    check(launches["flash_fwd"] == mcfg.n_layers * eval_batches, f"K1 (rate 0) launches {launches['flash_fwd']} for {eval_batches} eval batches")
    check(do_copies == 0, f"the backward copied dO {do_copies} times on the model's path")
    check(all(np.isfinite(res["losses"])), f"non-finite loss {res['losses']}")
    check(header == "Accuracy,Loss,Precision,Recall,F1-Score", f"metrics CSV header {header!r}")
    check(all(np.isfinite(float(v)) for v in values.split(",")), f"metrics CSV {values!r}")
    print(f"train: test metrics {header} = {values}", flush=True)

    # Steady-state rate: the epoch's batches 12 times again, after the fit.
    batches = list(trainer.epoch_batches(res["client"].train, 1, cfg.data.batch_size))
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    torch.cuda.synchronize()
    passes = []
    for _ in range(STEADY_PASSES):
        t0 = time.perf_counter()
        for b in batches:
            state, _ = trainer.train_step(state, b)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    n_steps = STEADY_PASSES * len(batches)
    dt = sum(passes)
    per_pass = [len(batches) * cfg.data.batch_size / p for p in passes]
    print(
        f"train: {card}: {n_steps * cfg.data.batch_size / dt:.1f} samples/s steady ({n_steps} steps of "
        f"bs{cfg.data.batch_size}, {dt / n_steps * 1e3:.3f} ms/step; per pass of {len(batches)} steps "
        f"min {min(per_pass):.1f} median {float(np.median(per_pass)):.1f} max {max(per_pass):.1f}); "
        f"the fit's first epoch {res['train_samples'] / res['train_seconds']:.1f} samples/s including its first step",
        flush=True,
    )

    # Parity on the card: one fp32 step, dropout off, flash against dot.
    batch = batches[0]
    ids, mask, labels = (torch.from_numpy(batch[k]).cuda() for k in ("input_ids", "attention_mask", "labels"))
    f32 = dataclasses.replace(mcfg, compute_dtype="float32", dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
    params = init_params(f32, torch.Generator().manual_seed(seed))
    grads = {}
    for impl in ("flash", "dot"):
        c = dataclasses.replace(f32, attention_impl=impl)
        leaves = build_trainable_params(c, params, torch.device("cuda"))
        logits = torch.func.functional_call(model_skeleton(c), leaves, (ids, mask))
        grads[impl] = dict(zip(leaves, torch.autograd.grad(loss_fn(logits, labels), list(leaves.values()))))
    worst, ok = 0.0, True
    for name, g_dot in grads["dot"].items():
        e, good = max_excess(grads["flash"][name], g_dot, 1e-4, 1e-3)
        worst, ok = max(worst, e), ok and good
    print(f"train: fp32 grads flash vs dot over {len(grads['dot'])} leaves: max|diff| {worst:.3e} (atol 1e-4 + rtol 1e-3)", flush=True)
    check(ok, f"flash gradients disagree with the dot path: {worst}")

    # Learning: 20 steps on one fixed batch, dropout off.
    no_drop = dataclasses.replace(mcfg, dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
    learner = Trainer(no_drop, TrainConfig(seed=seed), pad_id=trainer.pad_id, device="cuda")
    lstate = learner.init_state()
    losses = [float(learner.train_step(lstate, batch)[1]) for _ in range(20)]
    print(f"train: 20 steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"the loss did not fall: {losses}")
    return launches


def numpy_fold(leaves: list[np.ndarray], weights: np.ndarray) -> np.ndarray:
    """The JAX package's ``fold_naive`` on the host: ``acc += float32(w) * x``."""
    acc = np.zeros(leaves[0].shape, np.float32)
    for a, w in zip(leaves, weights):
        acc += np.float32(w) * a
    return acc


def fold_bound(k: int, n: int) -> tuple[float, str]:
    """Least time (ms) for one fold: K leaves read once, the result
    written once, fp32; 2·K·n fp32 operations are far below the card's
    rate, so bytes bound it."""
    return (k + 1) * n * 4 / HBM_BYTES_PER_S * 1e3, "bytes"


def fold_kernel_phase(seed: int, card: str) -> dict:
    """Phase 7: K4 bit-exact against its plain version and numpy, then its
    times on the word-embedding leaf. Returns its kernels-line entry."""
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    cases = [(k, EMBED_N, False) for k in (1, 2, 8)]
    cases += [(k, n, False) for k in (1, 2, 8) for n in (1, 3, 768, 32769)]
    cases += [(k, n, True) for k in (2, 8) for n in (4099, 32768)]
    for k, n, subnormal in cases:
        if subnormal:  # ±1e-40, subnormal in fp32
            x = (torch.randint(0, 2, (k, n), generator=g, device="cuda") * 2 - 1).float() * 1e-40
        else:
            scales = 10.0 ** torch.randint(-4, 5, (k, 1), generator=g, device="cuda").float()
            x = torch.randn(k, n, generator=g, device="cuda") * scales
        w = torch.rand(k, generator=g, device="cuda") + 0.05
        got = fold_mod.fold_stacked(x, w)
        torch.cuda.synchronize()
        plain = fold_mod.fold_reference(list(x), w)
        host = numpy_fold(list(x.cpu().numpy()), w.cpu().numpy())
        same = torch.equal(got, plain) and np.array_equal(got.cpu().numpy(), host)
        again = torch.equal(fold_mod.fold_stacked(x, w), got)
        if subnormal:
            check(bool(((host != 0) & (np.abs(host) < np.finfo(np.float32).tiny)).any()), "the subnormal case made no subnormal result")
        if n >= EMBED_N or n <= 3 or subnormal:
            print(f"K4 check K={k} n={n:9d}{' subnormal' if subnormal else ''}: array_equal plain {torch.equal(got, plain)} numpy {np.array_equal(got.cpu().numpy(), host)} repeat {again}", flush=True)
        check(same and again, f"K4 is not bit-exact at K={k} n={n} subnormal={subnormal}")
        del x, got, plain
    entry = None
    for k in (2, 8):
        x = torch.randn(k, EMBED_N, generator=g, device="cuda")
        w = torch.rand(k, generator=g, device="cuda") + 0.05
        xt = x.t()
        t_k = time_ms(lambda: fold_mod.fold_stacked(x, w))
        t_p = time_ms(lambda: fold_mod.fold_reference(list(x), w))
        t_l = time_ms(lambda: torch.mv(xt, w))
        bound, bound_by = fold_bound(k, EMBED_N)
        print(f"K4 time K={k} n={EMBED_N} fp32 {card}: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms(torch.mv)={t_l:.4f} bound_ms={bound:.4f} ({bound_by}); {(k + 1) * EMBED_N * 4 / (t_k * 1e-3) / 1e9:.1f} GB/s", flush=True)
        if k == 2:
            entry = {
                "name": "fold",
                "route": "cuda",
                "source": f"{PORT}/csrc/fold.cu",
                "replaces": f"{JAX_FOLD}:138",
                "launches": None,
                "max_abs_err": 0.0,
                "ms": t_k,
                "plain_ms": t_p,
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": t_l,
            }
        del x, xt
    # The aggregator's path on one leaf: host leaves in, host result out.
    leaves = [np.random.default_rng(seed + i).standard_normal(EMBED_N, dtype=np.float32) for i in range(2)]
    weights = [np.float32(0.5)] * 2
    times: dict = {}
    for _ in range(3):
        times.clear()
        t0 = time.perf_counter()
        out = fold_mod.fold_ordered(leaves, weights, device="cuda", times=times)
        wall = time.perf_counter() - t0
    check(np.array_equal(out, numpy_fold(leaves, weights)), "fold_ordered is not bit-exact on the embedding leaf")
    print(f"K4 fold_ordered K=2 n={EMBED_N} (host numpy in and out) {card}: wall {wall * 1e3:.2f} ms: H2D {times['h2d_ms']:.2f} ms, launch + kernel {times['kernel_ms']:.4f} ms, D2H {times['d2h_ms']:.2f} ms (CUDA events)", flush=True)
    return entry


def round_phase(seed: int, card: str) -> int:
    """Phase 8: one full-width FedAvg round on loopback, folded by K4 on
    the card. Returns K4's launches during it."""
    with tempfile.TemporaryDirectory() as out_dir:
        server = build_round_server(build_parser().parse_args(
            ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2",
             "--timeout", "600", "--device", "cuda"]
        ))
        check(server.device.type == "cuda", f"server folds on {server.device}")
        results: dict[int, dict] = {}
        errors: list[BaseException] = []

        def client(i: int) -> None:
            try:
                results[i] = run_client(build_parser().parse_args(
                    ["client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port),
                     "--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400",
                     "--epochs", "1", "--rounds", "1", "--seed", str(seed), "--timeout", "600",
                     "--output-dir", out_dir]
                ))
            except BaseException as e:  # re-raised below, after the join
                errors.append(e)

        fold_mod.FOLD_LAUNCHES = 0
        flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
        flash_mod.DKDV_LAUNCHES = flash_mod.DQ_LAUNCHES = flash_mod.BWD_DO_COPIES = 0
        t0 = time.perf_counter()
        with server:
            st = threading.Thread(target=server.serve, args=(1,))
            workers = [threading.Thread(target=client, args=(i,)) for i in range(2)]
            for t in (st, *workers):
                t.start()
            for t in (*workers, st):
                t.join(timeout=900)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = fold_mod.FOLD_LAUNCHES
        flash = (flash_mod.FWD_LAUNCHES, flash_mod.FWD_DROPOUT_LAUNCHES, flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES)
        check(not any(t.is_alive() for t in (st, *workers)), "round threads hung")
        if errors:
            raise errors[0]
        csvs = {}
        for i in range(2):
            for path in results[i]["metrics_csvs"]:
                with open(path) as f:
                    csvs[os.path.basename(path)] = f.read().strip().splitlines()
    check(sorted(csvs) == [f"client{i}_{p}_metrics.csv" for i in range(2) for p in ("aggregated", "local")],
          f"metrics CSVs {sorted(csvs)}")
    for name, (header, values) in csvs.items():
        check(header == "Accuracy,Loss,Precision,Recall,F1-Score", f"{name} header {header!r}")
        check(all(np.isfinite(float(v)) for v in values.split(",")), f"{name} {values!r}")
    uploads = [wire.flatten_params(results[i]["uploaded"]) for i in range(2)]
    aggs = [wire.flatten_params(results[i]["aggregate"]) for i in range(2)]
    n_leaves = len(uploads[0])
    n_params = sum(a.size for a in uploads[0].values())
    print(f"round: {n_leaves} leaves, {n_params} fp32 parameters ({n_params * 4 / 1e6:.2f} MB) per upload; K4 launches {launches}; flash launches (K1 rate 0, K1 dropout, K2, K3) {flash}", flush=True)
    check(n_leaves == 102 and launches == n_leaves, f"K4 launched {launches} times for {n_leaves} leaves (want one per leaf, 102)")
    check(aggs[0].keys() == aggs[1].keys() and all(np.array_equal(aggs[0][k], aggs[1][k]) for k in aggs[0]),
          "the two clients received different aggregates")
    w = np.ones(2, np.float64) / 2  # unweighted FedAvg: StreamAgg's weight math
    ref = {
        key: fold_mod.fold_reference([torch.from_numpy(u[key]) for u in uploads], [np.float32(x) for x in w]).numpy()
        for key in uploads[0]
    }
    crc, want = wire.flat_crc32(aggs[0]), wire.flat_crc32(ref)
    print(f"round: aggregate crc {crc:#010x}, fold_reference over the uploads {want:#010x}", flush=True)
    check(crc == want, "the round's aggregate differs from the plain fold of the uploads")
    steps = [results[i]["state"].step for i in range(2)]
    mcfg = results[0]["config"].model
    check(flash[1] == flash[2] == flash[3] == mcfg.n_layers * sum(steps),
          f"K1-dropout/K2/K3 launches {flash[1:]} for {steps} steps")
    check(flash_mod.BWD_DO_COPIES == 0, f"the clients' backward copied dO {flash_mod.BWD_DO_COPIES} times")
    eval_batches = sum(2 * -(-results[i]["local"]["n"] // results[i]["config"].data.eval_batch_size) for i in range(2))
    check(flash[0] == mcfg.n_layers * eval_batches, f"K1 (rate 0) launches {flash[0]} for {eval_batches} eval batches")
    stats = server.last_fold_stats
    check(stats["fold_engine"] == "cuda", f"fold engine {stats['fold_engine']}")
    for i in range(2):
        s, x = results[i]["seconds"], results[i]["exchange"]
        print(
            f"round: client {i}: set-up {s['setup']:.3f} s, train {s['train']:.3f} s ({steps[i]} steps), eval {s['eval_local']:.3f} s, "
            f"host_params {s['host_params']:.3f} s, upload {x['upload_s']:.3f} s ({x['upload_bytes'] / 1e6:.1f} MB), "
            f"wait for the reply {x['reply_wait_s']:.3f} s ({x['reply_bytes'] / 1e6:.1f} MB), "
            f"re-evaluation {s['eval_aggregated']:.3f} s, adopt {s['adopt']:.3f} s",
            flush=True,
        )
    ph = server.phase_seconds
    print(
        f"round: server {card}: wait {ph['wait']:.3f} s, agg {ph['agg']:.3f} s (fold {stats['fold_s']:.3f} s = "
        f"H2D {stats['fold_h2d_ms']:.2f} ms, launch + kernel {stats['fold_kernel_ms']:.3f} ms, D2H {stats['fold_d2h_ms']:.2f} ms "
        f"by CUDA events, over {launches} leaves), reply {ph['reply']:.3f} s; round wall {wall:.3f} s",
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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device_name = torch.cuda.get_device_name(0)
    print(f"torch: {device_name}, {torch.cuda.device_count()} card(s), torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase("build")
    t0 = time.monotonic()
    built = _build.build()
    print(f"built {sorted(built) or 'nothing (cached)'} in {time.monotonic() - t0:.1f} s", flush=True)

    phase("kernel")
    k1 = kernel_phase(seed)

    phase("kernel-train")
    k1_drop, k2, k3 = train_kernel_phase(seed)

    phase("path")
    serve_launches = path_phase(seed, device_name)

    phase("train")
    train_launches = train_phase(seed, card)
    k1["launches"] = serve_launches + train_launches["flash_fwd"]
    for row in (k1_drop, k2, k3):
        row["launches"] = train_launches[row["name"]]
    print(f"launches: flash_fwd {serve_launches} (serving) + {train_launches['flash_fwd']} (evaluation)", flush=True)

    phase("kernel-fold")
    k4 = fold_kernel_phase(seed, card)

    phase("round")
    k4["launches"] = round_phase(seed, card)

    print(json.dumps({"kernels": [k1, k1_drop, k2, k3, k4]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
