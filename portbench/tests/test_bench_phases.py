"""The host-time readers of the program's phase records: the window's
untraced part picked from synthetic records on a timeline written by hand,
nothing for another mode, a wrapped log or a program that keeps no
records; then tiny traced runs on the CPU, whose records share the
profiler's clock with the harness's ranges."""

from __future__ import annotations

import math
import time
from importlib import import_module

import pytest
import torch

import run as harness
from conftest import PORT
from pbcore import phases
from pbcore.bench import reader
from pbcore.tracing import timeline_from_spans

profile = import_module(PORT + ".obs.profile")
REAL_RECORDS = phases.records

TRAIN = ("place", "forward", "backward", "optimizer")
SCORE = ("prep", "dispatch", "wait")
T0_US = 100e6  # the traced window opens here, on the profiler's clock
TRAIN_READERS = ("step_host_ms.train", "forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train")
SCORE_READERS = ("score_prep_ms.score", "score_dispatch_ms.score", "score_wait_ms.score")


def _rec(site, names, seq, start_ns, durs_ms):
    ends, t = [], start_ns
    for d in durs_ms:
        t += int(d * 1e6)
        ends.append(t)
    return profile.PhaseRecord(site, seq, 1, start_ns, tuple(ends), names)


def _records(site, names, plain: list[tuple], before: int = 3, traced: int = 2) -> list:
    """``before`` set-up records (checked and warm steps) of 1 s a phase,
    then the plain ones, back to back up to the window, then ``traced``
    of 2 s a phase inside it."""
    out, seq = [], 0
    t = int(T0_US * 1e3) - int(sum(sum(p) for p in plain) * 1e6) - 1_000_000_000 * before * len(names)
    for _ in range(before):
        out.append(_rec(site, names, seq, t, [1000.0] * len(names)))
        t, seq = out[-1].end_ns, seq + 1
    t = int(T0_US * 1e3) - int(sum(sum(p) for p in plain) * 1e6)
    for p in plain:
        out.append(_rec(site, names, seq, t, p))
        t, seq = out[-1].end_ns, seq + 1
    assert t <= T0_US * 1e3
    t = int(T0_US * 1e3) + 1000
    for _ in range(traced):
        out.append(_rec(site, names, seq, t, [2000.0] * len(names)))
        t, seq = out[-1].end_ns, seq + 1
    return out


def _timeline(mode: str, plain_steps: int):
    host = [("portbench.window", T0_US, T0_US + 2e6)]
    extra = dict(mode=mode, traced_steps=2, plain_steps=plain_steps, plain_s=1.0, device_name="cpu")
    return timeline_from_spans([], host, extra)


PLAIN_TRAIN = [(1.0, 10.0, 5.0, 2.0), (1.0, 12.0, 6.0, 3.0), (2.0, 11.0, 7.0, 4.0), (1.0, 30.0, 5.0, 9.0),
               (1.0, 9.0, 4.0, 2.0)]
PLAIN_SCORE = [(0.2, 2.0, 3.0), (0.3, 2.5, 4.0), (0.4, 1.5, 3.5)]


@pytest.fixture
def fake(monkeypatch):
    recs = {
        "engine.train_step": _records("engine.train_step", TRAIN, PLAIN_TRAIN),
        "serving.score": _records("serving.score", SCORE, PLAIN_SCORE),
    }
    monkeypatch.setattr(phases, "records", lambda site: list(recs[site]))
    return recs


def test_readers_take_the_untraced_part(fake):
    tl = _timeline("train", len(PLAIN_TRAIN))
    assert [r.seq for r in phases.untraced(tl, "train")] == [3, 4, 5, 6, 7]
    assert reader("step_host_ms.train").read(tl) == pytest.approx(22.0)  # calls 18, 22, 24, 45, 16
    assert reader("forward_host_ms.train").read(tl) == pytest.approx(11.0)
    assert reader("backward_host_ms.train").read(tl) == pytest.approx(5.0)
    assert reader("optimizer_host_ms.train").read(tl) == pytest.approx(3.0)
    tl = _timeline("score", len(PLAIN_SCORE))
    assert reader("score_prep_ms.score").read(tl) == pytest.approx(0.3)
    assert reader("score_dispatch_ms.score").read(tl) == pytest.approx(2.0)
    assert reader("score_wait_ms.score").read(tl) == pytest.approx(3.5)


def test_fewer_plain_steps_take_the_last_ones(fake):
    tl = _timeline("train", 2)
    assert [r.seq for r in phases.untraced(tl, "train")] == [6, 7]
    assert reader("step_host_ms.train").read(tl) == pytest.approx((45.0 + 16.0) / 2)


def test_nothing_for_another_mode_a_wrapped_log_or_no_records(fake, monkeypatch):
    for name in TRAIN_READERS:
        assert reader(name).read(_timeline("score", 3)) is None
        assert reader(name).read(None) is None
    for name in SCORE_READERS:
        assert reader(name).read(_timeline("train", 5)) is None
    # A log that dropped its oldest records holds fewer than plain_steps before the window.
    fake["engine.train_step"][:] = fake["engine.train_step"][5:]
    assert reader("step_host_ms.train").read(_timeline("train", 5)) is None
    assert reader("step_host_ms.train").read(_timeline("train", 3)) is not None
    # A program without phase records (an earlier commit) reads nothing and raises nothing.
    monkeypatch.setattr(phases, "records", REAL_RECORDS)
    monkeypatch.delattr(profile, "phase_records")
    assert phases.records("engine.train_step") is None
    assert all(reader(n).read(_timeline("train", 5)) is None for n in TRAIN_READERS)


@pytest.mark.parametrize("cell", ["distilbert.client-b128", "distilbert.score-b128"])
def test_a_traced_cpu_run_reads_its_records_on_the_profiler_s_clock(tiny_root, cell):
    root, twins = tiny_root
    c, outcome = harness.run_cell(twins[cell], 2**31 + 5, 1.5, True, torch.device("cpu"), time.perf_counter(), root)
    line = harness.result_line(c, outcome, True, {})
    tl = outcome.timeline
    mode = tl.extra["mode"]
    mine, other = (TRAIN_READERS, SCORE_READERS) if mode == "train" else (SCORE_READERS, TRAIN_READERS)
    got = {n: line["metrics"][n]["value"] for n in mine}
    assert all(math.isfinite(v) and v > 0 for v in got.values()) and not set(other) & set(line["metrics"])
    if mode == "train":  # a phase is part of each call, so its median is at most the call's
        assert all(got[n] <= got["step_host_ms.train"] for n in TRAIN_READERS)
    # The traced window's records, one inside each of the harness's call ranges.
    site, rng = (("engine.train_step", "portbench.train_step") if mode == "train"
                 else ("serving.score", "portbench.score"))
    recs = [r for r in profile.phase_records(site) if tl.t0 * 1e3 <= r.start_ns <= tl.t1 * 1e3]
    ranges = [(s, e) for n, s, e in tl.host if n == rng]
    assert len(recs) == tl.extra["traced_steps"] == len(ranges)
    slack_us = 50.0
    for r, (s, e) in zip(recs, ranges):
        assert s - slack_us <= r.start_ns * 1e-3 and r.end_ns * 1e-3 <= e + slack_us
