"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at the tiny size in fp32, with one fault planted in the
program:

* training: a step that returns its state unchanged; the loss over half
  of the batch; the loss altered where it is produced; one leaf moved
  double;
* scoring: half of the bucket's answers left out; answers that never
  move from the first call's (a state that is not updated); one answer
  altered where it is produced.

The limits are the full-size cells': a scoring run is held to those of
every cell of its traffic mix. One chip has no exchange between chips to
leave out. A sound run passes, so each failure is the fault's.
"""

from __future__ import annotations

import json
import time
from importlib import import_module

import numpy as np
import pytest
import torch

import run as harness
from conftest import PORT, ROOT
from pbcore.bench import load_cell

engine = import_module(PORT + ".train.engine")
serving = import_module(PORT + ".serving")


def _run(tiny_root, cell: str):
    root, twins = tiny_root
    c, outcome = harness.run_cell(twins[cell], 2**31 + 99, 0.5, False, torch.device("cpu"), time.perf_counter(), root)
    return outcome


def _unchanged(monkeypatch):
    monkeypatch.setattr(engine.Trainer, "_update", lambda self, state, names, grads: None)


def _half_batch(monkeypatch):
    def loss(self, logits, ids, mask, labels):
        n = len(labels) // 2
        return engine.loss_fn(logits[:n], labels[:n])

    monkeypatch.setattr(engine.Trainer, "_loss", loss)


def _altered_loss(monkeypatch):
    step = engine.Trainer.train_step

    def train_step(self, state, batch, anchor=None):
        state, loss = step(self, state, batch, anchor)
        return state, loss * 1.02

    monkeypatch.setattr(engine.Trainer, "train_step", train_step)


def test_a_sound_training_run_is_correct(tiny_root):
    assert _run(tiny_root, "distilbert.client-b128").correct


def _one_leaf_double(monkeypatch):
    apply = engine.Trainer._apply

    def doubled(self, state, names, grads):
        leaf = names[len(names) // 2]
        before = state.params[leaf].detach().clone()
        out = apply(self, state, names, grads)
        with torch.no_grad():
            state.params[leaf].add_(state.params[leaf] - before)
        return out

    monkeypatch.setattr(engine.Trainer, "_apply", doubled)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_loss, _one_leaf_double])
def test_a_broken_training_step_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    outcome = _run(tiny_root, "distilbert.client-b128")
    assert not outcome.correct, [(c.name, c.value, c.limit) for c in outcome.checks]


def _score_wrapper(monkeypatch, change):
    score = serving.ScoreEngine.score
    calls = []

    def wrapped(self, ids, mask):
        probs, class_probs, bucket, rid = score(self, ids, mask)
        calls.append(class_probs)
        return change(probs, class_probs, bucket, rid, calls)

    monkeypatch.setattr(serving.ScoreEngine, "score", wrapped)


def _half_left_out(probs, class_probs, bucket, rid, calls):
    n = len(probs) // 2
    return probs[:n], class_probs[:n], bucket, rid


def _never_updated(probs, class_probs, bucket, rid, calls):
    return probs, calls[0], bucket, rid


def _one_altered(probs, class_probs, bucket, rid, calls):
    if len(calls) == 7:
        class_probs = class_probs.copy()
        class_probs[3] = class_probs[3, ::-1]
    return probs, class_probs, bucket, rid


#: The limits of every scoring cell (all of the traffic ``score-b128``).
SCORE_LIMITS = [load_cell(w["name"], ROOT).limits for w in json.load(open(f"{ROOT}/BENCHMARK.json"))["workloads"]
                if w["traffic"] == "score-b128"]


def _correct_under(outcome, limits: dict) -> bool:
    return outcome.failed == 0 and bool(outcome.checks) and all(c.value <= limits[c.name] for c in outcome.checks)


def test_a_sound_scoring_run_is_correct(tiny_root):
    outcome = _run(tiny_root, "distilbert.score-b128")
    assert outcome.correct and all(_correct_under(outcome, limits) for limits in SCORE_LIMITS)


@pytest.mark.parametrize("change", [_half_left_out, _never_updated, _one_altered])
def test_a_broken_scorer_is_not_correct(tiny_root, monkeypatch, change):
    _score_wrapper(monkeypatch, change)
    outcome = _run(tiny_root, "distilbert.score-b128")
    assert not outcome.correct, ([(c.name, c.value, c.limit) for c in outcome.checks], outcome.failed)
    assert not any(_correct_under(outcome, limits) for limits in SCORE_LIMITS)
    assert np.isfinite(outcome.metrics["score_flows_per_s"])
