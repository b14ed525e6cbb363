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
            added to the port's registry and promoted to serving through
            its ``registry`` verb, and served by the port's
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
            metrics CSV must be finite. ``--checkpoint-dir`` saves the
            state once (params and Adam moments): its seconds and bytes.
            Then 108 more steps (the epoch's 9 batches 12 times) time the
            steady training samples/s. Then one fp32 step
            with dropout off: gradients through flash against the dot path
            on the card (atol 1e-4 + rtol 1e-3); and 20 steps on one fixed
            batch with dropout off must bring the loss below its first
            value;
   lifecycle — at full width on the card: (a) 4 steps, save, warm start
            into a fresh trainer, 5 more steps, dropout on, against 9
            uninterrupted steps: losses and params within the trajectory
            bound (atol 2e-6 / rtol 1e-5), printed whether bit-equal, with
            the save's and the restore's seconds; (b) ``predict`` on 512
            synthetic flows from phase 6's checkpoint, and again from the
            resumed state's: probs bit-equal to ``Trainer.evaluate`` on the
            restored state, flows/s, K1 once per layer of every batch;
            (c) ``infer-serve --checkpoint-dir`` while the resumed state is
            finalized as a new step, and ``infer-serve --registry-dir``
            while it is promoted as a second artifact: replies after the
            swap name the new round, their probs within bf16's bound (atol
            1e-2) of ``predict`` on the new weights, which must differ
            from the old ones by more than 10 x that bound on some served
            text, so a stale serve fails; the seconds from the swap to the
            first reply the new model scored;
7. kernel-fold — the fold kernel K4 against its plain version on the
            card and against numpy's ``acc += float32(w) * x`` on the
            host, with no tolerance (``array_equal``): K in {1, 2, 8} over
            the word-embedding leaf (23,440,896 elements) and n in {1, 3,
            768, 32769}, scales 10^-4..10^4, subnormal inputs, repeated
            calls giving the same bits. Then the times at K=2 and K=8 on
            that leaf, beside the plain version's, ``torch.mv``'s (a
            yardstick the port never calls) and the bound, and the
            aggregator's host-to-device copies, kernel and copy back;
   federated — the ``federated`` verb at full width (DistilBERT-base,
            flash, bf16, dropout on, Adam 2e-5, bs16) with 4 clients on
            1600 synthetic flows cut by ``--partition quantity`` into
            shards of 644 / 386 / 414 / 156 rows (the shortest idles
            through each epoch's tail), 2 epochs a round, ``--weighted``,
            with ``--checkpoint-dir`` and ``--registry-dir``: round 1 as one
            invocation, round 2 as a second that resumes from its
            checkpoint. Checks: K1 with dropout, K2 and K3 once per layer
            of every client-step that ran, K1 at rate 0 once per layer of
            every eval client-batch; after each aggregation every client
            row bit-equal to row 0 and row 0 within atol 1e-6 of the fp64
            weighted mean of the rows before it; a client idling through a
            gated step keeps its params, moments and Adam count bit for
            bit; ``predict`` on round 2's checkpoint bit-equal to
            ``evaluate_clients`` row 0; ``infer-serve --checkpoint-dir``
            started on round 1 swaps to round 2 when the resumed run
            finalizes it, its replies within bf16's bound of round 2's
            ``predict``, which must differ from round 1's by more than 10 x
            that bound on some served text; one registry artifact a round
            with ``extra`` ``{"tier": "mesh", "clients": 4}``. Prints each
            round's seconds by phase, samples/s over all clients and the
            peak device memory;
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
9. rounds   — the streamed round over 3 rounds at full width (phase 8's
            clients with ``--rounds 3``; the stream offer rides the
            reply, so round 1 is dense and rounds 2-3 stream), in two
            invocations of ``serve`` + two ``client``s, fold on the card:
            (a) FEDTPU_SECRET set, the default 4 MB chunks, ``--strategy
            fedprox:mu=0.01`` and ``--prox-mu 0.01`` on both clients:
            round 1 dense and rounds 2-3 streamed per client by the
            server's record, every reply carrying the nonce and the
            fedprox stamp, each round's aggregate crc equal to
            ``fold_reference`` over the uploads as sent; (b) ``--reply-dtype
            bf16 --strategy fedopt:opt=adam,lr=0.1``, client 0 ``--wire-dtype
            int8`` (int8c streams from round 2, bf16 streamed replies),
            client 1 ``--compression topk:0.01 --no-stream-upload`` (sparse
            deltas from round 2; its dense fp32 replies keep its base
            exact): the mean bit-equal to ``fold_reference`` over the
            uploads as decoded (int8c dequantized, base + densified top-k,
            replayed with the client's error feedback), each int8c value
            within half its chunk's step (plus two fp32 ulps), top-k keeping
            ``max(1, round(0.01·n))`` entries a leaf, the bf16 reply within
            2^-8 relative of the server's global, and that global equal to
            ``ServerOptimizer`` run on the card over the same means. Both:
            K4 once per leaf a round (102) on ``cuda``; K1 with dropout, K2
            and K3 once per layer of every step; K1 at rate 0 once per layer
            of every eval batch; no dO copy. Prints a line per round with
            the card: bytes and seconds of each upload and reply, the
            fold's early and late bytes and seconds, K4's launches and
            time, the server's phases and the round's wall;
10. the kernels' JSON line (K1 as its two instantiations, rate 0 at the
   serving shape and dropout at the training shape, then K2, K3 and K4;
   K1's rate-0 launches count phase 5, phase 6's evaluation, the
   lifecycle's predict and reload serving, the federated phase's
   evaluations, predicts and serving, and the rounds phase's
   evaluations; K1 with dropout, K2 and K3 count phase 6, the federated
   phase and the rounds phase; K4 phases 8 and 9),
   then the result line
   ``{"ok": true, "device": {...}}``.

Needs CUDA: without a card (or without the repository beside it) it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import csv
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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.federated import (
    run_federated,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.local import (
    run_local,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.predict import (
    run_predict,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    wire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.quant import (
    QUANT_CHUNK_ELEMS,
    dequantize_int8c,
    quantize_int8c,
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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.cicids import (
    frame_texts,
    load_flow_csv,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
    TokenizedSplit,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.synthetic import (
    make_synthetic_flows,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    init_params,
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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel.fedavg import (
    ServerOptimizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry import (
    ModelRegistry,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
    ScoreEngine,
    ScoringClient,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
    STATE_FILE,
    Checkpointer,
    maybe_warm_start,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
    loss_fn,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.federated import (
    FederatedTrainer,
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
# The federated phase: 1600 synthetic flows cut by the quantity skew into
# 4 disjoint shards of 644 / 386 / 414 / 156 rows (train 386 / 231 / 248 /
# 93: 25 / 15 / 16 / 6 steps of bs16 an epoch), so the shortest client
# idles through the tail of every epoch. Two epochs a round: after one,
# round 1's model is still at chance and scores too like round 2's for the
# stale-weights guard to tell them apart with room to spare.
FED_CLIENTS = 4
FED_ARGS = ["--synthetic", "1600", "--num-clients", str(FED_CLIENTS), "--partition", "quantity",
            "--dirichlet-alpha", "2.0", "--data-fraction", "0.25", "--epochs", "2", "--weighted"]
# The rounds phase: the round phase's clients over 3 rounds, so the stream
# offer (one reply behind) is taken from round 2 on.
ROUNDS = 3
ROUND_CLIENT_ARGS = ["--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400",
                     "--epochs", "1", "--rounds", str(ROUNDS), "--timeout", "600"]


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


def publish(root: str, params: dict, round_id: int, cfg: ModelConfig) -> str:
    """Add ``params`` to the port's registry at ``root`` and promote them
    to serving through the ``registry`` verb; returns the artifact id."""
    aid = ModelRegistry(root).add(params, round_index=round_id, model_config=cfg)
    args = build_parser().parse_args(["registry", "promote", "--registry-dir", root, "--artifact", aid, "--to", "serving"])
    check(args.fn(args) == 0, f"registry promote {aid} failed")
    return aid


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
        publish(reg, params, 1, cfg)
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


def train_phase(seed: int, card: str, ckpt_dir: str) -> tuple[dict[str, int], dict]:
    """Phase 6: ``local`` at full width on the card (``card``: its name and
    power limit, as nvidia-smi gives them), saving its state to
    ``ckpt_dir``. Returns each kernel's launches during it and what
    ``run_local`` returned."""
    with tempfile.TemporaryDirectory() as out_dir:
        args = build_parser().parse_args(
            ["local", "--preset", "distilbert", "--attention-impl", "flash",
             "--synthetic", "2400", "--epochs", "1", "--seed", str(seed),
             "--output-dir", out_dir, "--checkpoint-dir", ckpt_dir]
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
    check(os.listdir(ckpt_dir) == [str(steps)], f"checkpoint steps {os.listdir(ckpt_dir)}, want [{steps}]")
    nbytes = os.path.getsize(os.path.join(ckpt_dir, str(steps), STATE_FILE))
    print(f"train: {card}: saved step {steps} (params + Adam moments) in {res['save_seconds']:.3f} s, {nbytes / 1e6:.1f} MB", flush=True)

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
    return launches, res


def resume_check(seed: int, card: str, res: dict, ckpt_dir: str):
    """Lifecycle (a): 4 steps, save, warm start into a fresh ``Trainer``,
    5 more steps, dropout on, against 9 uninterrupted steps. Returns the
    resumed state (its weights are not phase 6's: another seed)."""
    cfg, tok_pad = res["config"], res["trainer"].pad_id
    train_cfg = dataclasses.replace(cfg.train, seed=seed + 1)
    trainer = Trainer(cfg.model, train_cfg, pad_id=tok_pad, device="cuda")
    batches = list(trainer.epoch_batches(res["client"].train, 0, cfg.data.batch_size))
    check(len(batches) == 9, f"{len(batches)} batches, want 9")
    flash_mod.FWD_DROPOUT_LAUNCHES = flash_mod.DKDV_LAUNCHES = flash_mod.DQ_LAUNCHES = 0
    whole = trainer.init_state()
    whole_losses = [trainer.train_step(whole, b)[1] for b in batches]
    part = trainer.init_state()
    losses = [trainer.train_step(part, b)[1] for b in batches[:4]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Checkpointer(ckpt_dir) as ckpt:
        ckpt.save(part.step, part)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(ckpt_dir, str(part.step), STATE_FILE))
    fresh = Trainer(cfg.model, train_cfg, pad_id=tok_pad, device="cuda")
    template = fresh.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed, step = maybe_warm_start(ckpt_dir, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(resumed is not None and step == 4 and resumed.step == 4, f"warm start gave step {step}")
    check(resumed.generator.device.type == "cuda", "the restored generator is not the card's")
    losses += [fresh.train_step(resumed, b)[1] for b in batches[4:]]
    torch.cuda.synchronize()
    launches = (flash_mod.FWD_DROPOUT_LAUNCHES, flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES)
    check(launches == (cfg.model.n_layers * 18,) * 3, f"K1-dropout/K2/K3 launches {launches} for 18 steps")
    got, want = torch.stack(losses).cpu().numpy(), torch.stack(whole_losses).cpu().numpy()
    loss_bits = np.array_equal(got, want)
    worst, ok, bits = 0.0, bool(np.allclose(got, want, atol=2e-6, rtol=1e-5)), loss_bits
    for n, t in whole.params.items():
        e, good = max_excess(resumed.params[n].detach(), t.detach(), 2e-6, 1e-5)
        worst, ok = max(worst, e), ok and good
        bits = bits and torch.equal(resumed.params[n], t)
    print(
        f"lifecycle: {card}: resume check, 4 steps + save ({save_s:.3f} s, {nbytes / 1e6:.1f} MB) + warm start "
        f"({restore_s:.3f} s) + 5 steps vs 9 steps, dropout {cfg.model.attention_dropout}: losses bit-equal {loss_bits}, "
        f"max|param diff| {worst:.3e} (atol 2e-6 + rtol 1e-5), everything bit-equal {bits}",
        flush=True,
    )
    check(ok, f"resumed training left the uninterrupted trajectory: max {worst}, losses {got} vs {want}")
    return resumed


def write_flows_csv(path: str, n: int, seed: int) -> None:
    """``n`` synthetic CICIDS2017 flows as a CSV with a Label column."""
    frame = make_synthetic_flows(n, seed=seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(frame))
        for i in range(n):
            w.writerow([frame[c][i] for c in frame])


def predict_check(card: str, csv_path: str, ckpt_dir: str, out: str) -> tuple[np.ndarray, int]:
    """Lifecycle (b): ``predict`` from the latest step of ``ckpt_dir``;
    its probs must equal ``Trainer.evaluate`` on the restored state bit
    for bit. Returns the probs and K1's launches during ``predict``."""
    flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
    pred = run_predict(build_parser().parse_args(
        ["predict", "--csv", csv_path, "--checkpoint-dir", ckpt_dir, "--output", out]
    ))
    torch.cuda.synchronize()
    launches = flash_mod.FWD_LAUNCHES
    check(flash_mod.FWD_DROPOUT_LAUNCHES == 0, "predict launched K1 with dropout")
    trainer, probs = pred["trainer"], pred["probs"]
    mcfg = trainer.model_cfg
    check(trainer.device.type == "cuda" and mcfg.attention_impl == "flash" and mcfg.dim == 768, f"predict ran {mcfg} on {trainer.device}")
    n = len(probs)
    batches = -(-n // 16)
    check(launches == mcfg.n_layers * batches, f"K1 launched {launches} times for {batches} predict batches")
    with Checkpointer(ckpt_dir) as ckpt:
        state = ckpt.restore(trainer.init_state())
    tok = default_tokenizer()
    enc = tok.batch_encode(frame_texts(load_flow_csv(csv_path)), max_len=mcfg.max_len)
    split = TokenizedSplit(enc["input_ids"], enc["attention_mask"], np.zeros(n, np.int32))
    want = trainer.evaluate(state.params, split, batch_size=16)["probs"]
    same = np.array_equal(probs, want)
    with open(out) as f:
        rows = f.read().strip().splitlines()
    print(
        f"lifecycle: {card}: predict {n} flows in {pred['seconds']:.3f} s = {n / pred['seconds']:.1f} flows/s "
        f"(tokenized rows in, probs out; K1 launches {launches}); probs bit-equal to Trainer.evaluate on the "
        f"restored state: {same}; {int(pred['predictions'].sum())} flagged",
        flush=True,
    )
    check(same, f"predict's probs differ from evaluate's: max {np.abs(probs - want).max()}")
    check(len(rows) == n + 1 and rows[0] == "prob_attack,prediction,label_name", "predictions CSV malformed")
    check(bool(np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all()), "predict probs not finite in [0, 1]")
    return probs, launches


def score_texts(port: int, texts: list[str], threads: int = 8) -> list[dict]:
    """Score ``texts`` through the port's client on ``threads`` connections."""
    replies: dict[int, dict] = {}
    errors: list[BaseException] = []

    def drive(rows):
        try:
            with ScoringClient("127.0.0.1", port, timeout=120) as c:
                for i in rows:
                    replies[i] = c.score(text=texts[i])
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    workers = [threading.Thread(target=drive, args=(range(t, len(texts), threads),)) for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    check(not any(w.is_alive() for w in workers), "client threads hung")
    if errors:
        raise errors[0]
    return [replies[i] for i in range(len(texts))]


def reload_check(card: str, what: str, argv: list[str], swap, texts: list[str], want: np.ndarray, old_round: int, new_round: int) -> int:
    """Lifecycle (c): ``infer-serve`` with ``argv`` serves ``old_round``;
    ``swap()`` finalizes a step or promotes an artifact; replies must then
    name ``new_round`` with probs within bf16's bound of ``want``
    (``predict`` on the new weights). Returns K1's launches while
    serving, after the warmup."""
    server = build_server(build_parser().parse_args(
        ["infer-serve", *argv, "--host", "127.0.0.1", "--port", "0", "--max-wait-ms", "5", "--reload-poll", "0.05"]
    ))
    check(server.engine.device.type == "cuda", f"engine on {server.engine.device}")
    with server:
        flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
        batches0 = server.stats()["batches"]
        before = score_texts(server.port, texts)
        check({r["round"] for r in before} == {old_round}, f"{what}: replies before the swap name rounds {sorted({r['round'] for r in before})}")
        swap()
        t_swap = time.perf_counter()
        with ScoringClient("127.0.0.1", server.port, timeout=120) as c:
            while True:
                r = c.score(text=texts[0])
                if r["round"] == new_round:
                    break
                check(time.perf_counter() - t_swap < 60, f"{what}: no reply from round {new_round} within 60 s")
        first_s = time.perf_counter() - t_swap
        after = score_texts(server.port, texts)
        stats = server.stats()
        launches = flash_mod.FWD_LAUNCHES
        check(flash_mod.FWD_DROPOUT_LAUNCHES == 0, "serving launched K1 with dropout")
    probs = np.array([r["prob"] for r in after])
    diff = float(np.abs(probs - want).max())
    batches = stats["batches"] - batches0
    print(
        f"lifecycle: {card}: {what}: {stats['reloads']} reload; first reply from round {new_round} "
        f"{first_s:.3f} s after the swap; {len(after)} replies after it, max|prob - predict| {diff:.3e} "
        f"(bf16 atol 1e-2); K1 launches {launches} for {batches} batches",
        flush=True,
    )
    check(stats["reloads"] == 1 and {r["round"] for r in after} == {new_round}, f"{what}: replies after the swap name rounds {sorted({r['round'] for r in after})}")
    check(diff <= 1e-2, f"{what}: served probs differ from predict's by {diff}")
    n_layers = server.engine.model_cfg.n_layers
    check(launches == n_layers * batches, f"{what}: K1 launched {launches} times for {batches} batches")
    return launches


def lifecycle_phase(seed: int, card: str, res: dict, ckpt_dir: str, work: str) -> int:
    """Resume, predict and both hot reloads at full width on the card.
    Returns K1's rate-0 launches on these paths."""
    resumed = resume_check(seed, card, res, os.path.join(work, "resume"))
    csv_path = os.path.join(work, "flows.csv")
    write_flows_csv(csv_path, 512, seed)
    probs_old, k1_predict = predict_check(card, csv_path, ckpt_dir, os.path.join(work, "pred_old.csv"))
    step = int(os.listdir(ckpt_dir)[0])
    model_cfg = res["trainer"].model_cfg
    # The new weights: the resumed state, as a checkpoint step and an artifact.
    new_dir = os.path.join(work, "new")
    with Checkpointer(new_dir) as ckpt:
        ckpt.save(step + 1, resumed, meta={"kind": "local", "config": res["config"].to_dict()})
    probs_new, k1 = predict_check(card, csv_path, new_dir, os.path.join(work, "pred_new.csv"))
    k1_predict += k1
    texts = frame_texts(load_flow_csv(csv_path))[:48]
    # Stale weights must fail the served-probs check (atol 1e-2): on some
    # served text the old and new weights must differ by far more.
    gap = float(np.abs(probs_new[:48] - probs_old[:48]).max())
    print(f"lifecycle: max|prob_new - prob_old| over the {len(texts)} served texts {gap:.3e} (must exceed 10 x 1e-2)", flush=True)
    check(gap > 10 * 1e-2, f"the new weights score too like the old ones to tell a stale serve: {gap}")

    def finalize():  # a new step appears in the served directory
        os.rename(os.path.join(new_dir, str(step + 1)), os.path.join(ckpt_dir, str(step + 1)))

    k1_serve = reload_check(card, "infer-serve --checkpoint-dir", ["--checkpoint-dir", ckpt_dir], finalize,
                            texts, probs_new[:48], step, step + 1)
    root = os.path.join(work, "registry")
    with Checkpointer(ckpt_dir) as ckpt:
        publish(root, ckpt.restore_params(step=step), 1, model_cfg)
    new_aid = ModelRegistry(root).add(resumed.params, round_index=2, model_config=model_cfg)

    def promote():
        args = build_parser().parse_args(["registry", "promote", "--registry-dir", root, "--artifact", new_aid, "--to", "serving"])
        check(args.fn(args) == 0, "registry promote failed")

    k1_serve += reload_check(card, "infer-serve --registry-dir", ["--registry-dir", root], promote,
                             texts, probs_new[:48], 1, 2)
    print(f"lifecycle: K1 (rate 0) launches: predict {k1_predict}, serving around the reloads {k1_serve}", flush=True)
    return k1_predict + k1_serve


def counts_zero() -> None:
    flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
    flash_mod.DKDV_LAUNCHES = flash_mod.DQ_LAUNCHES = flash_mod.BWD_DO_COPIES = 0


def counts_read() -> dict[str, int]:
    torch.cuda.synchronize()
    return {
        "flash_fwd": flash_mod.FWD_LAUNCHES,
        "flash_fwd_dropout": flash_mod.FWD_DROPOUT_LAUNCHES,
        "flash_bwd_dkdv": flash_mod.DKDV_LAUNCHES,
        "flash_bwd_dq": flash_mod.DQ_LAUNCHES,
    }


class FedWatch:
    """Wraps the trainer's round boundary and lockstep step while the
    federated phase runs: before each aggregation it copies the stacked
    params on the card, after it checks that every client row equals row
    0 and keeps row 0; at the first step where a client's batch is all
    padding it copies that client's params and moments and checks them
    after the step. The copies stay on the card (a few ms inside the
    timed aggregate); the fp64 comparison runs after the invocation."""

    def __init__(self):
        self.aggs: list[tuple] = []
        self.gated: tuple | None = None
        self._orig = (FederatedTrainer.round_aggregate, FederatedTrainer.train_step)

    def __enter__(self):
        agg, step = self._orig
        watch = self

        def round_aggregate(trainer, state, **kw):
            pre = {n: p.detach().clone() for n, p in state.params.items()}
            out = agg(trainer, state, **kw)
            rows_equal = all(torch.equal(p[c], p[0]) for p in out.params.values() for c in range(1, p.shape[0]))
            watch.aggs.append((pre, {n: p[0].detach().clone() for n, p in out.params.items()}, kw.get("weights"), rows_equal))
            return out

        def train_step(trainer, state, batch, anchor=None):
            idle = [c for c in range(trainer.C) if "valid" in batch and not batch["valid"][c].any()]
            if not idle or watch.gated is not None:
                return step(trainer, state, batch, anchor)
            c = idle[0]
            opt = state.opt_state
            before = [{n: t[c].detach().clone() for n, t in d.items()} for d in (state.params, opt.mu, opt.nu)]
            count = opt.count[c]
            out = step(trainer, state, batch, anchor)
            same = all(
                torch.equal(now[n][c], t)
                for now, was in zip((state.params, opt.mu, opt.nu), before)
                for n, t in was.items()
            ) and opt.count[c] == count
            watch.gated = (c, state.step, same)
            return out

        FederatedTrainer.round_aggregate, FederatedTrainer.train_step = round_aggregate, train_step
        return self

    def __exit__(self, *exc):
        FederatedTrainer.round_aggregate, FederatedTrainer.train_step = self._orig

    def check_aggregates(self, card: str) -> None:
        """Every aggregation this invocation made: rows bit-equal, and row
        0 within atol 1e-6 of the fp64 weighted mean of the copies."""
        for pre, post0, weights, rows_equal in self.aggs:
            check(rows_equal, "after the aggregation some client row differs from row 0")
            w = np.ones(FED_CLIENTS) if weights is None else np.asarray(weights, np.float64)
            w = w / w.sum()
            worst = 0.0
            for n, x in pre.items():
                mean = np.tensordot(w, x.cpu().numpy().astype(np.float64), axes=1)
                worst = max(worst, float(np.abs(post0[n].cpu().numpy() - mean).max()))
            print(f"federated: {card}: aggregate: every row bit-equal to row 0: {rows_equal}; max|row 0 - fp64 weighted mean| {worst:.3e} (atol 1e-6)", flush=True)
            check(worst <= 1e-6, f"the aggregate is {worst} off the fp64 weighted mean")
        self.aggs.clear()


def eval_client_batches(prepared) -> int:
    """Client-batches one evaluation over ``prepared`` runs: each client's
    slices that hold a valid row (the stacked eval skips all-padding
    ones)."""
    bs, valid = prepared.batch_size, prepared.valid
    return int(sum(valid[:, i : i + bs].any(axis=1).sum() for i in range(0, valid.shape[1], bs)))


def federated_invocation(seed: int, card: str, rounds: int, ckpt_dir: str, reg_dir: str, out_dir: str) -> tuple[dict, dict[str, int]]:
    """One ``federated`` run at full width through the parser, with the
    launch counts and the checks of :class:`FedWatch`. Returns what
    ``run_federated`` returned and the launches of this run."""
    args = build_parser().parse_args(
        ["federated", "--preset", "distilbert", "--attention-impl", "flash", *FED_ARGS,
         "--rounds", str(rounds), "--seed", str(seed), "--checkpoint-dir", ckpt_dir,
         "--registry-dir", reg_dir, "--output-dir", out_dir]
    )
    torch.cuda.reset_peak_memory_stats()
    with FedWatch() as watch:
        counts_zero()
        t0 = time.perf_counter()
        res = run_federated(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts_read()
        do_copies = flash_mod.BWD_DO_COPIES
    peak = torch.cuda.max_memory_allocated()
    cfg, trainer = res["config"], res["trainer"]
    mcfg = cfg.model
    check(trainer.device.type == "cuda", f"federated trainer on {trainer.device}")
    check((mcfg.dim, mcfg.n_layers, mcfg.n_heads, mcfg.hidden_dim, mcfg.max_len) == (768, 6, 12, 3072, 128), f"not full width: {mcfg}")
    check(mcfg.compute_dtype == "bfloat16" and mcfg.attention_impl == "flash" and mcfg.attention_dropout == RATE, f"config {mcfg}")
    n_rows = [int(n) for n in res["stacked_train"].n_rows]
    bs = cfg.data.batch_size
    ran = len(res["history"])
    client_steps = ran * cfg.train.epochs_per_round * sum(-(-n // bs) for n in n_rows)
    prepare = trainer.prepare_eval
    val_cb = eval_client_batches(prepare([c.val for c in res["clients"]]))
    test_cb = eval_client_batches(prepare([c.test for c in res["clients"]]))
    eval_cb = ran * 2 * (val_cb + test_cb) + test_cb  # local + aggregated val/test a round, then the final test
    print(
        f"federated: {card}: rounds {res['start_round'] + 1}..{cfg.fed.rounds} of {FED_CLIENTS} clients, train rows {n_rows} "
        f"(val {[len(c.val) for c in res['clients']]}, test {[len(c.test) for c in res['clients']]}); "
        f"{client_steps} client-steps, {eval_cb} eval client-batches; launches {launches}, dO copies {do_copies}; "
        f"wall {wall:.3f} s; torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB",
        flush=True,
    )
    check(max(n_rows) >= 2 * min(n_rows) and -(-min(n_rows) // bs) < -(-max(n_rows) // bs),
          f"client rows {n_rows}: want a 2x spread and an idle tail")
    for row in ("flash_fwd_dropout", "flash_bwd_dkdv", "flash_bwd_dq"):
        check(launches[row] == mcfg.n_layers * client_steps, f"{row} launched {launches[row]} times for {client_steps} client-steps")
    check(launches["flash_fwd"] == mcfg.n_layers * eval_cb, f"K1 (rate 0) launched {launches['flash_fwd']} times for {eval_cb} eval client-batches")
    check(do_copies == 0, f"the backward copied dO {do_copies} times")
    samples = cfg.train.epochs_per_round * sum(n_rows)  # every real row once an epoch
    for h in res["history"]:
        s, r = h.seconds, h.round + 1
        check(np.isfinite(h.epoch_losses).all(), f"round {r}: non-finite loss {h.epoch_losses}")
        print(
            f"federated: {card}: round {r}: fit {s['fit']:.3f} s ({samples / s['fit']:.1f} samples/s over all "
            f"clients, {samples} samples), local eval {s['local_eval']:.3f} s, aggregate {s['aggregate']:.3f} s, "
            f"aggregated eval {s['aggregated_eval']:.3f} s, save {s['save']:.3f} s; epoch losses {np.round(h.epoch_losses, 4).tolist()}; "
            f"aggregated test acc {[round(m['Accuracy'], 2) for m in h.aggregated_metrics]}",
            flush=True,
        )
    watch.check_aggregates(card)
    check(len(res["artifacts"]) == ran, f"{len(res['artifacts'])} registry artifacts for {ran} rounds")
    if ran:
        check(watch.gated is not None, "no lockstep step gated an idle client")
        c, step, same = watch.gated
        print(f"federated: client {c} idled through step {step}: params, moments and count unchanged {same}", flush=True)
        check(same, f"client {c}'s state changed on a step it idled through")
    for path in res["metrics_csvs"]:
        with open(path) as f:
            header, values = f.read().strip().splitlines()
        check(header == "Accuracy,Loss,Precision,Recall,F1-Score", f"{path} header {header!r}")
        check(all(np.isfinite(float(v)) for v in values.split(",")), f"{path} {values!r}")
    return res, launches


def federated_phase(seed: int, card: str, work: str) -> dict[str, int]:
    """The ``federated`` verb at full width, 4 clients, ragged: round 1 as
    one invocation, round 2 as a second that resumes from its checkpoint,
    with ``infer-serve --checkpoint-dir`` serving round 1 and swapping to
    round 2 when the resumed run finalizes it. Returns each kernel's
    launches on these paths."""
    ckpt_dir, reg_dir, out_dir = (os.path.join(work, d) for d in ("fed_ckpt", "fed_registry", "fed_out"))
    csv_path = os.path.join(work, "fed_flows.csv")
    write_flows_csv(csv_path, 256, seed + 3)
    texts = frame_texts(load_flow_csv(csv_path))[:48]
    total = {k: 0 for k in ("flash_fwd", "flash_fwd_dropout", "flash_bwd_dkdv", "flash_bwd_dq")}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    res1, launches = federated_invocation(seed, card, 1, ckpt_dir, reg_dir, out_dir)
    add(launches)
    check(sorted(os.listdir(ckpt_dir)) == ["1"], f"checkpoint rounds {os.listdir(ckpt_dir)}")
    counts_zero()
    probs1 = run_predict(build_parser().parse_args(
        ["predict", "--csv", csv_path, "--checkpoint-dir", ckpt_dir, "--output", os.path.join(work, "fed_p1.csv")]
    ))["probs"]
    add(counts_read())
    del res1
    server = build_server(build_parser().parse_args(
        ["infer-serve", "--checkpoint-dir", ckpt_dir, "--host", "127.0.0.1", "--port", "0",
         "--max-wait-ms", "5", "--reload-poll", "0.05"]
    ))
    check(server.engine.device.type == "cuda", f"engine on {server.engine.device}")
    with server:
        counts_zero()
        before = score_texts(server.port, texts)
        add(counts_read())
        check({r["round"] for r in before} == {1}, f"replies before the resume name rounds {sorted({r['round'] for r in before})}")
        res2, launches = federated_invocation(seed, card, 2, ckpt_dir, reg_dir, out_dir)
        add(launches)
        check(res2["start_round"] == 1 and len(res2["history"]) == 1, f"the second invocation started at round {res2['start_round']}")
        t_fin = time.perf_counter()
        counts_zero()
        with ScoringClient("127.0.0.1", server.port, timeout=120) as c:
            while c.score(text=texts[0])["round"] != 2:
                check(time.perf_counter() - t_fin < 60, "no reply from round 2 within 60 s of the resumed run's end")
        first_s = time.perf_counter() - t_fin
        after = score_texts(server.port, texts)
        add(counts_read())
        stats = server.stats()
    check(stats["reloads"] == 1 and {r["round"] for r in after} == {2}, f"replies after the swap name rounds {sorted({r['round'] for r in after})}")
    counts_zero()
    pred2 = run_predict(build_parser().parse_args(
        ["predict", "--csv", csv_path, "--checkpoint-dir", ckpt_dir, "--output", os.path.join(work, "fed_p2.csv")]
    ))
    add(counts_read())
    probs2 = pred2["probs"]
    check(pred2["model_config"].dim == 768 and pred2["trainer"].device.type == "cuda", "predict did not run the full-width model on the card")

    # predict on round 2 against the trainer's own stacked evaluation.
    tok = default_tokenizer()
    frame = load_flow_csv(csv_path)
    enc = tok.batch_encode(frame_texts(frame), max_len=res2["config"].model.max_len)
    split = TokenizedSplit(enc["input_ids"], enc["attention_mask"], np.zeros(len(probs2), np.int32))
    rows = res2["trainer"].evaluate_clients(res2["state"].params, [split] * FED_CLIENTS, collect_probs=True)
    same = np.array_equal(probs2, rows[0]["probs"])
    print(f"federated: {card}: predict on round 2 ({len(probs2)} flows) bit-equal to evaluate_clients row 0: {same}", flush=True)
    check(same, f"predict differs from evaluate_clients row 0 by {np.abs(probs2 - rows[0]['probs']).max()}")

    gap = float(np.abs(probs2[:48] - probs1[:48]).max())
    served = np.array([r["prob"] for r in after])
    diff = float(np.abs(served - probs2[:48]).max())
    print(
        f"federated: {card}: infer-serve --checkpoint-dir: first reply from round 2 {first_s:.3f} s "
        f"after the resumed run returned (it swapped while the run's final evaluation ran); max|served - predict| {diff:.3e} (bf16 atol 1e-2); "
        f"max|prob_round2 - prob_round1| over the {len(texts)} served texts {gap:.3e} (must exceed 10 x 1e-2)",
        flush=True,
    )
    check(diff <= 1e-2, f"served probs differ from round 2's predict by {diff}")
    check(gap > 10 * 1e-2, f"round 2 scores too like round 1 to tell a stale serve: {gap}")

    reg = ModelRegistry(reg_dir)
    manifests = sorted((reg.manifest(a) for a in os.listdir(os.path.join(reg_dir, "artifacts")) if not a.startswith(".")), key=lambda m: m["round"])
    print(f"federated: registry: {[(m['round'], m['id'], m.get('extra')) for m in manifests]}", flush=True)
    check([m["round"] for m in manifests] == [1, 2], f"registry rounds {[m['round'] for m in manifests]}")
    check(all(m.get("extra") == {"tier": "mesh", "clients": FED_CLIENTS} for m in manifests), "registry extra")
    del res2, rows
    print(f"federated: launches on these paths {total}", flush=True)
    return total


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


def rounds_invocation(seed: int, card: str, name: str, serve_flags: list[str], client_flags: list[list[str]],
                      secret: str | None = None) -> tuple[list[dict], dict[int, dict]]:
    """One ``serve`` + two ``client``s over ROUNDS rounds on loopback, all
    through the port's parser, the fold on the card. Returns the server's
    per-round record (the previous global, the folded mean, the new global,
    what arrived, fold stats, K4 launches, the round's seconds) and each
    client's ``run_client`` result."""
    old_secret = os.environ.pop("FEDTPU_SECRET", None)
    if secret is not None:
        os.environ["FEDTPU_SECRET"] = secret
    records: list[dict] = []
    results: dict[int, dict] = {}
    errors: list[BaseException] = []
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            server = build_round_server(build_parser().parse_args(
                ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--timeout", "600",
                 "--device", "cuda", *serve_flags]
            ))
            check(server.device.type == "cuda", f"server folds on {server.device}")

            def serve() -> None:
                try:
                    for _ in range(ROUNDS):
                        prev, k4, t0 = server._last_agg, fold_mod.FOLD_LAUNCHES, time.perf_counter()
                        ph0 = dict(server.phase_seconds)
                        agg = server.serve_round()
                        records.append({
                            "prev": prev, "mean": server.last_mean, "global": agg,
                            "uploads": dict(server.last_uploads), "fold": dict(server.last_fold_stats),
                            "k4": fold_mod.FOLD_LAUNCHES - k4, "wall": time.perf_counter() - t0,
                            "phases": {k: server.phase_seconds[k] - ph0[k] for k in ph0},
                        })
                except BaseException as e:  # re-raised below, after the join
                    errors.append(e)

            def client(i: int) -> None:
                try:
                    results[i] = run_client(build_parser().parse_args(
                        ["client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port),
                         *ROUND_CLIENT_ARGS, "--seed", str(seed), "--output-dir", out_dir, *client_flags[i]]
                    ))
                except BaseException as e:  # re-raised below, after the join
                    errors.append(e)

            with server:
                threads = [threading.Thread(target=serve)] + [threading.Thread(target=client, args=(i,)) for i in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
            check(not any(t.is_alive() for t in threads), f"rounds ({name}) threads hung")
    finally:
        os.environ.pop("FEDTPU_SECRET", None)
        if old_secret is not None:
            os.environ["FEDTPU_SECRET"] = old_secret
    if errors:
        raise errors[0]
    check(len(records) == ROUNDS and all(len(results[i]["rounds"]) == ROUNDS for i in range(2)),
          f"rounds ({name}): {len(records)} server rounds, clients {[len(results[i]['rounds']) for i in range(2)]}")
    for r, rec in enumerate(records):
        fold = rec["fold"]
        check(fold["fold_engine"] == "cuda", f"rounds ({name}) round {r + 1} folded on {fold['fold_engine']}")
        check(rec["k4"] == 102, f"rounds ({name}) round {r + 1}: K4 launched {rec['k4']} times (want one per leaf, 102)")
        for i in range(2):
            x = results[i]["rounds"][r]["exchange"]
            sec = results[i]["rounds"][r]["seconds"]
            up = rec["uploads"][i]
            print(
                f"rounds ({name}) round {r + 1} {card}: client {i}: upload {x['upload_shape']} {x['wire_dtype']} "
                f"{x['upload_bytes'] / 1e6:.2f} MB in {x['upload_s']:.3f} s (server saw {up['shape']} {up['wire_dtype']} "
                f"{up['bytes'] / 1e6:.2f} MB), reply {x['reply_shape']} {x['reply_bytes'] / 1e6:.2f} MB "
                f"{x['reply_wait_s']:.3f} s after the upload; train {sec['train']:.3f} s, eval {sec['eval_local']:.3f} s, "
                f"exchange {sec['exchange']:.3f} s (next round's prefetch {sec.get('prefetch', 0.0):.3f} s under it), "
                f"re-evaluation {sec['eval_aggregated']:.3f} s, adopt {sec['adopt']:.3f} s",
                flush=True,
            )
        ph = rec["phases"]
        print(
            f"rounds ({name}) round {r + 1} {card}: fold early {fold['early_bytes'] / 1e6:.1f} MB in "
            f"{fold['early_s']:.3f} s, late {fold['late_bytes'] / 1e6:.1f} MB in {fold['late_s']:.3f} s "
            f"(overlap {fold['overlap_frac']:.3f}); K4 {rec['k4']} launches, launch + kernel "
            f"{fold['fold_kernel_ms']:.3f} ms, H2D {fold['fold_h2d_ms']:.2f} ms, D2H {fold['fold_d2h_ms']:.2f} ms "
            f"(CUDA events); server wait {ph['wait']:.3f} s, agg {ph['agg']:.3f} s, reply {ph['reply']:.3f} s; "
            f"round wall {rec['wall']:.3f} s",
            flush=True,
        )
    return records, results


def plain_mean(decoded: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """fold_reference over the uploads as the server decoded them
    (unweighted, ascending client id), on the host."""
    w = [np.float32(x) for x in np.ones(len(decoded), np.float64) / len(decoded)]
    return {
        key: fold_mod.fold_reference([torch.from_numpy(np.ascontiguousarray(d[key])) for d in decoded], w).numpy()
        for key in decoded[0]
    }


def check_int8c_step(got: np.ndarray, x: np.ndarray, what: str) -> float:
    """int8c: each value within half its chunk's scale (max|chunk| / 127);
    returns the largest error as a fraction of that half-step."""
    flat = np.ascontiguousarray(x, np.float32).reshape(-1)
    n = flat.size
    pad = -n % QUANT_CHUNK_ELEMS
    chunks = np.pad(np.abs(flat), (0, pad)).reshape(-1, QUANT_CHUNK_ELEMS)
    half = np.repeat(chunks.max(axis=1) / np.float32(127.0) / 2, QUANT_CHUNK_ELEMS)[:n]
    err = np.abs(np.asarray(got, np.float32).reshape(-1) - flat)
    ratio = float((err / np.maximum(half, np.float32(1e-30))).max())
    # A value on a half-step tie lands half a step away; the division by
    # the fp32 scale and the dequantizing product add an ulp or two.
    slack = 2 * np.spacing(np.abs(flat)) + half * np.float32(1e-5)
    check(bool((err <= half + slack).all()), f"{what}: int8c error beyond half a step ({ratio:.6f})")
    return ratio


def rounds_phase(seed: int, card: str) -> dict[str, int]:
    """Phase 9: several rounds of the streamed round at full width, in two
    invocations: (a) the JAX package's default shape made authenticated
    (FEDTPU_SECRET, 4 MB stream chunks, FedProx on the server and both
    clients); (b) the lossy wires (int8c streams, a bf16 streamed reply,
    top-k sparse deltas, FedAdam on the server). Returns the phase's
    launches of each kernel."""
    counts_zero()
    fold_mod.FOLD_LAUNCHES = 0
    t0 = time.perf_counter()
    # (a) ------------------------------------------------------------------
    recs, res = rounds_invocation(
        seed, card, "a", ["--strategy", "fedprox:mu=0.01"], [["--prox-mu", "0.01"]] * 2,
        secret=f"smoke-{seed}-shared-secret",
    )
    for r, rec in enumerate(recs):
        shapes = [rec["uploads"][i]["shape"] for i in range(2)]
        check(shapes == (["dense"] * 2 if r == 0 else ["stream"] * 2), f"rounds (a) round {r + 1} arrived as {shapes}")
        uploads = [wire.flatten_params(res[i]["rounds"][r]["uploaded"]) for i in range(2)]
        crc, want = wire.flat_crc32(rec["mean"]), wire.flat_crc32(plain_mean(uploads))
        print(f"rounds (a) round {r + 1}: aggregate crc {crc:#010x}, fold_reference over the uploads {want:#010x}", flush=True)
        check(crc == want, f"rounds (a) round {r + 1}: the aggregate differs from the plain fold of the uploads")
        check(wire.flat_crc32(rec["global"]) == crc, "fedprox changed the server's global")
        for i in range(2):
            meta = res[i]["rounds"][r]["exchange"]["meta"]
            check(meta["strategy"] == {"name": "fedprox", "params": {"mu": 0.01}} and "nonce" in meta,
                  f"rounds (a) client {i} round {r + 1} reply meta {sorted(meta)}")
            got = wire.flatten_params(res[i]["rounds"][r]["aggregate"])
            check(wire.flat_crc32(got) == crc, f"rounds (a) client {i} received another aggregate in round {r + 1}")
    check(all(res[i]["config"].train.prox_mu == 0.01 for i in range(2)), "the clients do not train with FedProx")
    a_steps = sum(res[i]["state"].step for i in range(2))
    a_evals = sum(2 * -(-res[i]["local"]["n"] // res[i]["config"].data.eval_batch_size) for i in range(2)) * ROUNDS
    # (b) ------------------------------------------------------------------
    recs_b, res_b = rounds_invocation(
        seed + 1, card, "b", ["--reply-dtype", "bf16", "--strategy", "fedopt:opt=adam,lr=0.1"],
        [["--wire-dtype", "int8"], ["--compression", "topk:0.01", "--no-stream-upload"]],
    )
    opt = ServerOptimizer("adam", 0.1)
    opt_state = None
    residual = None
    int8c_worst = bf16_worst = 0.0
    for r, rec in enumerate(recs_b):
        arrived = [(rec["uploads"][i]["shape"], rec["uploads"][i]["wire_dtype"]) for i in range(2)]
        want_arrived = [("dense", "fp32") if r == 0 else ("stream", "int8"), ("dense", "fp32")]
        check(arrived == want_arrived, f"rounds (b) round {r + 1} arrived as {arrived}")
        x0 = wire.flatten_params(res_b[0]["rounds"][r]["uploaded"])
        x1 = wire.flatten_params(res_b[1]["rounds"][r]["uploaded"])
        if r == 0:
            d0, d1 = x0, x1
        else:
            d0 = {k: dequantize_int8c(quantize_int8c(v), v.shape) for k, v in x0.items()}
            for k in x0:
                int8c_worst = max(int8c_worst, check_int8c_step(d0[k], x0[k], f"rounds (b) round {r + 1} {k}"))
            # Client 1's sparse delta, replayed: its base is the previous
            # global (its exact fp32 reply), its error feedback the residual.
            base = recs_b[r - 1]["global"]
            delta = {k: x1[k] - base[k] + (residual[k] if residual else np.float32(0)) for k in base}
            dense = {}
            for k, v in delta.items():
                payload = wire.sparsify_topk(v, 0.01)
                kept = int(np.frombuffer(payload[:4], np.uint32)[0])
                check(kept == max(1, round(0.01 * v.size)), f"top-k kept {kept} of {v.size} entries of {k}")
                dense[k] = wire.densify_topk(payload, v.shape)
            residual = {k: delta[k] - dense[k] for k in delta}
            d1 = {k: base[k] + dense[k] for k in base}
        crc, want = wire.flat_crc32(rec["mean"]), wire.flat_crc32(plain_mean([d0, d1]))
        print(f"rounds (b) round {r + 1}: mean crc {crc:#010x}, fold_reference over the decoded uploads {want:#010x}", flush=True)
        check(crc == want, f"rounds (b) round {r + 1}: the mean differs from the plain fold of the decoded uploads")
        # The post-strategy global: ServerOptimizer on the card, same mean.
        if rec["prev"] is None:
            ref = rec["mean"]
        else:
            keys = sorted(rec["mean"])
            prev = {k: torch.tensor(rec["prev"][k], device="cuda") for k in keys}
            grad = {k: prev[k] - torch.tensor(rec["mean"][k], device="cuda") for k in keys}
            opt_state = opt.init(prev) if opt_state is None else opt_state
            updates, opt_state = opt.update(grad, opt_state)
            ref = {k: (prev[k] + updates[k]).cpu().numpy() for k in keys}
        check(all(np.array_equal(rec["global"][k], ref[k]) for k in ref),
              f"rounds (b) round {r + 1}: the server's FedAdam global differs from ServerOptimizer on the card")
        g = rec["global"]
        got0 = wire.flatten_params(res_b[0]["rounds"][r]["aggregate"])
        got1 = wire.flatten_params(res_b[1]["rounds"][r]["aggregate"])
        check(wire.flat_crc32(got1) == wire.flat_crc32(g), f"rounds (b) round {r + 1}: client 1's dense reply is not exact")
        for k in g:
            err = np.abs(got0[k] - g[k])
            bound = np.abs(g[k]) * np.float32(2.0**-8)
            check(bool((err <= bound).all()), f"rounds (b) round {r + 1} {k}: bf16 reply beyond 2^-8 relative")
            nz = g[k] != 0
            if nz.any():
                bf16_worst = max(bf16_worst, float((err[nz] / np.abs(g[k][nz])).max()))
        ups = [res_b[i]["rounds"][r]["exchange"]["upload_bytes"] for i in range(2)]
        print(f"rounds (b) round {r + 1}: upload bytes {ups[0] / 1e6:.3f} MB ({'int8c' if r else 'fp32'}) and "
              f"{ups[1] / 1e6:.3f} MB ({'top-k 0.01' if r else 'fp32'})", flush=True)
    check(res_b[1]["rounds"][-1]["exchange"]["upload_bytes"] < 0.1 * res_b[1]["rounds"][0]["exchange"]["upload_bytes"],
          "client 1's sparse uploads are not sparse")
    print(f"rounds (b): worst int8c error {int8c_worst:.4f} of half a chunk step; worst bf16 reply error "
          f"{bf16_worst:.3e} relative (bound 2^-8 = {2.0**-8:.3e})", flush=True)
    b_steps = sum(res_b[i]["state"].step for i in range(2))
    b_evals = sum(2 * -(-res_b[i]["local"]["n"] // res_b[i]["config"].data.eval_batch_size) for i in range(2)) * ROUNDS
    launches = counts_read()
    launches["fold"] = fold_mod.FOLD_LAUNCHES
    n_layers = res[0]["config"].model.n_layers
    steps = a_steps + b_steps
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == n_layers * steps,
          f"rounds: K1-dropout/K2/K3 launches {launches} for {steps} steps")
    check(launches["flash_fwd"] == n_layers * (a_evals + b_evals), f"rounds: K1 (rate 0) launches {launches['flash_fwd']} for {a_evals + b_evals} eval batches")
    check(flash_mod.BWD_DO_COPIES == 0, f"the clients' backward copied dO {flash_mod.BWD_DO_COPIES} times")
    check(launches["fold"] == 2 * ROUNDS * 102, f"rounds: K4 launched {launches['fold']} times")
    print(f"rounds: launches {launches}; {steps} client steps; phase {time.perf_counter() - t0:.1f} s", flush=True)
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

    with tempfile.TemporaryDirectory() as work:
        ckpt_dir = os.path.join(work, "ckpt")
        phase("train")
        train_launches, res = train_phase(seed, card, ckpt_dir)
        phase("lifecycle")
        life_launches = lifecycle_phase(seed, card, res, ckpt_dir, work)
        del res
        phase("federated")
        fed_launches = federated_phase(seed, card, work)
    k1["launches"] = serve_launches + train_launches["flash_fwd"] + life_launches + fed_launches["flash_fwd"]
    for row in (k1_drop, k2, k3):
        row["launches"] = train_launches[row["name"]] + fed_launches[row["name"]]
    print(
        f"launches: flash_fwd {serve_launches} (serving) + {train_launches['flash_fwd']} (evaluation) + {life_launches} "
        f"(predict, reload serving) + {fed_launches['flash_fwd']} (federated evaluation, predict, serving); "
        f"K1 dropout / K2 / K3 {train_launches['flash_fwd_dropout']} (local) + {fed_launches['flash_fwd_dropout']} (federated)",
        flush=True,
    )

    phase("kernel-fold")
    k4 = fold_kernel_phase(seed, card)

    phase("round")
    k4["launches"] = round_phase(seed, card)

    phase("rounds")
    rounds_launches = rounds_phase(seed, card)
    k4["launches"] += rounds_launches["fold"]
    for row in (k1, k1_drop, k2, k3):
        row["launches"] += rounds_launches[row["name"]]

    print(json.dumps({"kernels": [k1, k1_drop, k2, k3, k4]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
