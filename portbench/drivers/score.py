"""Scoring traffic: the scorer thread's call under a full queue.

Set-up builds a ``ScoreEngine`` as ``infer-serve`` builds it (the default
bucket ladder) over the benchmark's weights, tokenizes a pool of flows,
and warms the one bucket the traffic uses. The window calls
``ScoreEngine.score`` back to back on full buckets whose rows cycle
through the pool; each call's wall time runs from the call until its
probabilities are back on the host.

Correctness: every answer of the window against the plain reference's
(the cell's family, ``reference/<name>.py``) per-class probabilities of
its pool row (a row's answer does not depend on the rows beside it): the
widest gap over all of them, and how far the program's P(class 1)
decorrelates from the reference's across them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pbcore import flows
from pbcore.harness import PORT, Check, Outcome, Run, device_name, free, memory_peak, sync
from pbcore.tracing import percentile
from pbcore.weights import make_weights
from reference import compare
from reference import model as ref_model


class Cycle:
    """Full buckets of pool rows, wrapping around the pool."""

    def __init__(self, ids: np.ndarray, mask: np.ndarray, bucket: int):
        self.ids, self.mask, self.bucket = ids, mask, bucket
        self.start = 0

    def next(self) -> tuple[int, np.ndarray, np.ndarray]:
        idx = (self.start + np.arange(self.bucket)) % len(self.ids)
        out = (self.start, self.ids[idx], self.mask[idx])
        self.start = int((self.start + self.bucket) % len(self.ids))
        return out


def build(run: Run):
    from importlib import import_module

    config = import_module(PORT + ".config")
    serving = import_module(PORT + ".serving")
    t = run.cell.traffic
    cfg = run.cell.model_fields()
    run.mark("imports")
    model_cfg = run.cell.port_config(config)
    ids, mask, _ = flows.flow_pool(t, cfg, run.sub("flows"))
    run.mark("pool")
    w0 = make_weights(run.cell.family, cfg, run.sub("weights"), run.device)
    engine = serving.ScoreEngine(model_cfg, w0, pad_id=0, device=run.device)
    run.mark("weights and engine")
    return engine, ids, mask


def window(run: Run, engine, cycle: Cycle, seconds: float, answers: list, latencies: list, traced: bool = False) -> int:
    """Score full buckets back to back for ``seconds``; returns the calls."""
    tracer = run.tracer if traced else None
    calls = 0
    deadline = time.perf_counter() + seconds
    while True:
        if tracer is not None:
            with tracer.range("fetch"):
                start, ids, mask = cycle.next()
            t0 = time.perf_counter()
            with tracer.range("score"):
                _, class_probs, _, _ = engine.score(ids, mask)
            t1 = time.perf_counter()
            with tracer.range("record"):
                answers.append((start, class_probs))
        else:
            start, ids, mask = cycle.next()
            t0 = time.perf_counter()
            _, class_probs, _, _ = engine.score(ids, mask)
            t1 = time.perf_counter()
            answers.append((start, class_probs))
        latencies.append(t1 - t0)
        calls += 1
        if t1 >= deadline:
            return calls


def reference_probs(run: Run, ids: np.ndarray, mask: np.ndarray, prec=ref_model.Precision()) -> np.ndarray:
    cfg = run.cell.model_fields()
    w0 = make_weights(run.cell.family, cfg, run.sub("weights"), run.device)
    dev = run.device
    out = run.cell.family.class_probs(w0, cfg, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                                      run.cell.traffic["bucket"], prec)
    return out.cpu().numpy()


def answer_gaps(answers: list, ref: np.ndarray, bucket: int) -> tuple[dict[str, float], int]:
    """The numbers compared over every answer, and the calls whose answer
    is missing rows."""
    worst, short = 0.0, 0
    n = len(ref)
    got, want_all = [], []
    for start, probs in answers:
        want = ref[(start + np.arange(bucket)) % n]
        if probs.shape != want.shape:
            short += 1
            continue
        worst = max(worst, compare.prob_gap(probs, want))
        got.append(probs[:, 1])
        want_all.append(want[:, 1])
    decor = compare.decorrelation(np.concatenate(got), np.concatenate(want_all)) if got else float("inf")
    return {"prob_gap": worst if got else float("inf"), "prob_decorrelation": decor}, short


def run(run: Run) -> Outcome:
    t = run.cell.traffic
    bucket = t["bucket"]
    engine, ids, mask = build(run)
    cycle = Cycle(ids, mask, bucket)
    for _ in range(t["warm_calls"]):
        engine.score(*cycle.next()[1:])
    sync(run.device)
    setup_s = run.mark("warm calls")
    shapes = len(engine.ledger.compile_counts("serving.probs"))

    # The window: untraced calls, then with --trace 1 its last
    # trace_seconds under the profiler (per-layer numbers only).
    answers: list = []
    latencies: list[float] = []
    t_open = time.perf_counter()
    plain = run.seconds - t["trace_seconds"] if run.tracer.enabled else run.seconds
    plain_calls = window(run, engine, cycle, plain, answers, latencies)
    traced_calls = 0
    if run.tracer.enabled:
        sync(run.device)
        t_plain = time.perf_counter()
        with run.tracer.window(lambda: sync(run.device)):
            traced_calls = window(run, engine, cycle, t_open + run.seconds - t_plain, answers, latencies, traced=True)
    sync(run.device)
    t_close = time.perf_counter()

    peak = memory_peak(run.device)
    new_shapes = len(engine.ledger.compile_counts("serving.probs")) - shapes
    del engine
    free(run.device)
    t_ref = time.perf_counter()
    ref = reference_probs(run, ids, mask)
    gaps, short = answer_gaps(answers, ref, bucket)
    checks = [Check(k, gaps[k], limit) for k, limit in run.cell.limits.items()]

    timeline = run.tracer.timeline
    if timeline is not None:
        cfg = run.cell.model_fields()
        timeline.extra.update(
            mode="score", reference=run.cell.family_name, bench=run.cell.bench, cfg=cfg,
            batch=bucket, seq_len=cfg["max_len"], traced_steps=traced_calls,
            plain_steps=plain_calls, plain_s=t_plain - t_open,
            device_name=device_name(run.device),
        )
    calls = len(answers)
    return Outcome(
        metrics={
            "score_flows_per_s": calls * bucket / (t_close - t_open),
            "score_batch_p95_ms": percentile(latencies, 95.0) * 1e3,
            "setup_s": setup_s,
        },
        attempted=calls, failed=short, memory_peak_bytes=peak, checks=checks, timeline=timeline,
        notes={"window_s": t_close - t_open, "reference_s": time.perf_counter() - t_ref, "calls": calls,
               "new_shapes_in_window": new_shapes},
    )
