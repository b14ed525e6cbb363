"""Training traffic: the client's local phase, paced by the card.

Set-up builds one ``Trainer`` and its state from the benchmark's weights
and drives it through its first steps with the window's own call and
feed (``Trainer.train_step`` over ``Trainer.epoch_batches``); the same
object then runs the window, epoch after reshuffled epoch, with no sync
per step. The window closes on a ``torch.cuda.synchronize()``.

Correctness: the losses of the ``checked_steps`` first steps, each leaf's
first gradient (from Adam's first moment after one step) and each leaf's
change after them, against the plain reference's (the cell's family,
``reference/<name>.py``) from the same weights, rows and dropout seed.
The rows the feed handed over must be distinct rows of the pool.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pbcore import flows
from pbcore.harness import PORT, Check, Outcome, Run, device_name, free, memory_peak, sync
from pbcore.weights import make_weights
from reference import compare
from reference import model as ref_model


def opt_params(run: Run) -> dict:
    t = run.cell.traffic
    return {"learning_rate": t["learning_rate"], "b1": t["b1"], "b2": t["b2"], "eps": t["eps"]}


class Feed:
    """Epoch after epoch of the trainer's shuffled batches."""

    def __init__(self, trainer, split, batch: int):
        self.trainer, self.split, self.batch = trainer, split, batch
        self.epoch = 0
        self.it = trainer.epoch_batches(split, 0, batch)

    def next(self) -> dict:
        for _ in range(2):
            b = next(self.it, None)
            if b is not None:
                return b
            self.epoch += 1
            self.it = self.trainer.epoch_batches(self.split, self.epoch, self.batch)
        raise RuntimeError("the feed yields no batch")


def _norms(tensors: dict, scale: float = 1.0) -> dict[str, float]:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].double()) for n in names]) * scale
    return dict(zip(names, vals.tolist()))


def build(run: Run):
    """Set-up up to the window: the program's trainer and state after the
    checked steps, its readings, the rows those steps trained on, and the
    feed positioned after them."""
    from importlib import import_module

    config = import_module(PORT + ".config")
    pipeline = import_module(PORT + ".data.pipeline")
    engine = import_module(PORT + ".train.engine")

    t = run.cell.traffic
    cfg = run.cell.model_fields()
    run.mark("imports")
    model_cfg = run.cell.port_config(config)
    ids, mask, labels = flows.flow_pool(t, cfg, run.sub("flows"))
    split = pipeline.TokenizedSplit(ids, mask, labels)
    run.mark("pool")
    w0 = make_weights(run.cell.family, cfg, run.sub("weights"), run.device)
    opt = opt_params(run)
    trainer = engine.Trainer(
        model_cfg,
        config.TrainConfig(learning_rate=opt["learning_rate"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                           seed=run.sub("shuffle"), log_every=0),
        pad_id=0, drop_remainder=True, device=run.device,
    )
    state = trainer.init_state(params=w0)
    state.generator.manual_seed(run.sub("dropout"))
    run.mark("weights and state")
    feed = Feed(trainer, split, t["batch"])
    losses, rows, grad_norms = [], [], None
    for step in range(t["checked_steps"]):
        batch = feed.next()
        rows.append(batch)
        state, loss = trainer.train_step(state, batch)
        losses.append(loss)
        if step == 0:
            grad_norms = _norms(state.opt_state.mu, 1.0 / (1.0 - opt["b1"]))
    change = _norms({n: state.params[n].detach() - w0[n] for n in w0})
    readings = ref_model.TrainReadings([float(x) for x in losses], grad_norms, change)
    run.mark("checked steps")
    return trainer, state, feed, readings, rows, (ids, mask, labels)


def distinct_rows(rows: list[dict], ids: np.ndarray) -> int:
    """How many of the checked rows are not distinct rows of the pool."""
    index = {r.tobytes(): i for i, r in enumerate(ids)}
    seen = [index.get(np.ascontiguousarray(r).tobytes()) for b in rows for r in b["input_ids"]]
    found = [i for i in seen if i is not None]
    return (len(seen) - len(found)) + (len(found) - len(set(found)))


def reference(run: Run, rows: list[dict], prec=ref_model.Precision(), half_batch: bool = False):
    """The reference's readings over the checked rows, from the same
    weights and dropout seed."""
    cfg = run.cell.model_fields()
    w0 = make_weights(run.cell.family, cfg, run.sub("weights"), run.device)
    dev = run.device
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(b[k])).to(dev) for k in ("input_ids", "attention_mask", "labels"))
               for b in rows]
    return run.cell.family.train_steps(w0, cfg, batches, run.sub("dropout"), opt_params(run), prec, half_batch)


def run(run: Run) -> Outcome:
    t = run.cell.traffic
    tracer = run.tracer
    trainer, state, feed, prog, rows, (ids, _, _) = build(run)
    for _ in range(t["warm_steps"]):
        state, _ = trainer.train_step(state, feed.next())
    sync(run.device)
    setup_s = run.mark("warm steps")
    shapes = _train_shapes()

    # The window: untraced steps, then with --trace 1 its last
    # trace_seconds under the profiler (per-layer numbers only).
    steps = samples = traced_steps = 0
    t_open = time.perf_counter()
    deadline = t_open + run.seconds
    plain_until = deadline - t["trace_seconds"] if tracer.enabled else deadline
    per_second = [0]
    while True:
        batch = feed.next()
        state, _ = trainer.train_step(state, batch)
        steps += 1
        samples += len(batch["labels"])
        now = time.perf_counter()
        if now - t_open >= len(per_second):
            per_second.append(0)
        per_second[-1] += 1
        if now >= plain_until:
            break
    plain_steps = steps
    if tracer.enabled:
        sync(run.device)
        t_plain = time.perf_counter()
        with tracer.window(lambda: sync(run.device)):
            while True:
                with tracer.range("fetch"):
                    batch = feed.next()
                with tracer.range("train_step"):
                    state, _ = trainer.train_step(state, batch)
                steps += 1
                traced_steps += 1
                samples += len(batch["labels"])
                if time.perf_counter() >= deadline:
                    break
    sync(run.device)
    t_close = time.perf_counter()

    peak = memory_peak(run.device)
    new_shapes = len(_train_shapes()) - len(shapes)
    del trainer, state, feed
    free(run.device)
    t_ref = time.perf_counter()
    ref = reference(run, rows)
    gaps = compare.train_gaps(prog, ref)
    limits = run.cell.limits
    checks = [Check(k, gaps[k], limit) for k, limit in limits.items()]
    checks.append(Check("rows_not_distinct", float(distinct_rows(rows, ids)), 0.0))

    timeline = tracer.timeline
    if timeline is not None:
        cfg = run.cell.model_fields()
        timeline.extra.update(
            mode="train", reference=run.cell.family_name, bench=run.cell.bench, cfg=cfg,
            batch=t["batch"], seq_len=cfg["max_len"], traced_steps=traced_steps,
            plain_steps=plain_steps, plain_s=t_plain - t_open, device_name=device_name(run.device),
        )
    return Outcome(
        metrics={"train_samples_per_s": samples / (t_close - t_open), "setup_s": setup_s},
        attempted=steps, failed=0, memory_peak_bytes=peak, checks=checks, timeline=timeline,
        notes={"window_s": t_close - t_open, "reference_s": time.perf_counter() - t_ref,
               "new_shapes_in_window": new_shapes, "steps_by_second": per_second,
               "losses": prog.losses, "ref_losses": ref.losses},
    )


def _train_shapes() -> dict:
    """The batch shapes the program's dispatch ledger has seen at its
    train step (a new one in the window would be a first dispatch there)."""
    from importlib import import_module

    return import_module(PORT + ".obs.profile").default_ledger().compile_counts("engine.train_step")
