"""The port's control plane held against the JAX package's.

* Drift arithmetic (``psi``, ``ks_distance``, ``psi_contributions``,
  ``cadence_interval_s``, ``drift_cohort_fraction``) on seeded numpy
  histograms: the port's numbers equal JAX's exactly (both are numpy
  float64), and so do their refusals.
* ``DriftMonitor`` on one serving metrics-JSONL stream, malformed lines
  included, gives the same verdict sequence; ``ErrorRateMonitor`` and
  ``SloActuator`` the same lifecycle.
* Controller campaigns: the cases of the JAX package's controller tests
  (unattended rounds, a corrupted candidate blocked, a drift verdict
  triggering the next round, round-engine and eval errors surviving,
  the clock fallback, adaptive cadence, SLO actuation, the drift-scaled
  cohort), each run by the port ``Controller`` over the port
  ``AggregationServer`` and by the JAX pair, with each package's library
  clients uploading the same seeded params. The ``controller_state.jsonl``
  events (time fields aside), artifact ids and registry states are
  equal; a campaign one package began, the other resumes.
* The gate on a real model: ``Trainer.evaluate`` of the aggregate in both
  packages, within the evaluate bounds of ``test_torch_train.py``
  (Accuracy/Precision/Recall/F1 rtol 1e-6, Loss rtol 1e-5, probs atol
  1e-5), the eval histogram equal.
* ``registry.add(eval_hist=, parent=)`` writes the JAX manifest byte for
  byte; ``serve_round(round_index=)`` stamps the replies as the JAX
  server does.
* The ``controller`` verb parses every JAX flag to the JAX value, refuses
  the flags of the unported paths, and runs a campaign on the CPU.
"""

import dataclasses
import importlib
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    build_parser as jax_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)

torch.set_num_threads(1)

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"


def _ns(pkg: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    comm, control = m("comm"), m("control")
    port = pkg == PORT_PKG

    def server(**kw):
        return comm.AggregationServer(**kw, **({"device": "cpu"} if port else {}))

    return SimpleNamespace(
        port=port,
        control=control,
        drift=m("control.drift"),
        Controller=control.Controller,
        DriftMonitor=control.DriftMonitor,
        ErrorRateMonitor=control.ErrorRateMonitor,
        SloActuator=control.SloActuator,
        ControlConfig=m("config").ControlConfig,
        ModelRegistry=m("registry").ModelRegistry,
        registry_store=m("registry.store"),
        Server=server,
        FederatedClient=comm.FederatedClient,
        WireError=m("comm.wire").WireError,
        Tracer=m("obs").Tracer,
        load_spans=m("obs").load_spans,
        fedeval=m("train.fedeval"),
    )


JAX = _ns(JAX_PKG)
PORT = _ns(PORT_PKG)
PORT_OBS = importlib.import_module(PORT_PKG + ".obs")


def _both(fn, tmp_path):
    """``fn`` run with the JAX package, then with the port, each in its
    own directory; returns (jax result, port result)."""
    out = []
    for name, ns in (("jax", JAX), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        out.append(fn(ns, d))
    return tuple(out)


# ---------------------------------------------------------- drift arithmetic
def _hist_pairs():
    rng = np.random.default_rng(0)
    pairs = [
        ([100, 50, 10, 5, 5, 5, 5, 10, 50, 100], [0, 0, 0, 0, 170, 170, 0, 0, 0, 0]),
        ([100, 100, 100, 100], [100, 100, 40, 160]),
        ([500, 0, 0, 0, 0, 0, 0, 0, 0, 500], [16, 0, 0, 0, 32, 32, 0, 0, 0, 16]),
        ([10, 10], [99, 0]),
    ]
    for bins in (2, 4, 10, 10, 32, 64):
        e = rng.integers(0, 400, bins)
        e[rng.integers(0, bins)] += 1  # never massless
        o = rng.integers(0, 400, bins)
        o[rng.integers(0, bins)] += 1
        pairs.append((e.tolist(), o.tolist()))
    return pairs


HIST_PAIRS = _hist_pairs()


def _call(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("i", range(len(HIST_PAIRS)))
@pytest.mark.parametrize("fn", ["psi", "ks_distance", "psi_contributions"])
def test_distances_equal_jax(fn, i):
    e, o = HIST_PAIRS[i]
    kw = {"top_k": 4} if fn == "psi_contributions" else {}
    want = _call(getattr(JAX.drift, fn), e, o, **kw)
    got = _call(getattr(PORT.drift, fn), e, o, **kw)
    assert want[0] == "ok" and got == want


@pytest.mark.parametrize(
    "e,o",
    [([10, 10], [1, 2, 3]), ([0] * 10, [1] * 10), ([1], [1]), ([-1, 3], [1, 1])],
    ids=["bins", "massless", "one-bin", "negative"],
)
def test_distance_refusals_equal_jax(e, o):
    for fn in ("psi", "ks_distance", "psi_contributions"):
        want = _call(getattr(JAX.drift, fn), e, o)
        assert want[0] == "ValueError" and _call(getattr(PORT.drift, fn), e, o) == want


DRIFTS = [0.0, 0.1, 0.25, 0.3, 0.375, 0.5, 0.74, 9.99]
CADENCE_KW = [
    dict(threshold=0.25, min_s=5.0, max_s=65.0),
    dict(threshold=0.25, min_s=5.0, max_s=None),
    dict(threshold=0.25, min_s=10.0, max_s=3.0),
    dict(threshold=7.0, min_s=1.0, max_s=30.0, urgency_span=3.0),
    dict(threshold=0.25, min_s=1.0, max_s=30.0, urgency_span=0.5),
]
COHORT_KW = [
    dict(threshold=0.25, min_frac=0.5, max_frac=1.0),
    dict(threshold=0.25, min_frac=0.8, max_frac=0.8),
    dict(threshold=0.25, min_frac=0.25, max_frac=0.5),
    dict(threshold=0.25, min_frac=-1.0, max_frac=2.0, urgency_span=1.0),
]


@pytest.mark.parametrize("k", range(len(CADENCE_KW)))
def test_cadence_interval_equals_jax(k):
    kw = CADENCE_KW[k]
    got = [PORT.drift.cadence_interval_s(d, **kw) for d in DRIFTS]
    assert got == [JAX.drift.cadence_interval_s(d, **kw) for d in DRIFTS]
    if k == 0:  # the JAX test's pins
        assert got[2] == 65.0 and got[5] == 5.0 and got[-1] == 5.0
        assert got[4] == pytest.approx(35.0) and got[1] == 65.0


@pytest.mark.parametrize("k", range(len(COHORT_KW)))
def test_drift_cohort_fraction_equals_jax(k):
    kw = COHORT_KW[k]
    got = [PORT.drift.drift_cohort_fraction(d, **kw) for d in DRIFTS]
    assert got == [JAX.drift.drift_cohort_fraction(d, **kw) for d in DRIFTS]
    if k == 0:
        assert got[2] == pytest.approx(0.5) and got[5] == pytest.approx(1.0)
        assert got[4] == pytest.approx(0.75) and got[1] == pytest.approx(0.5)


def test_reference_histogram_and_eval_gate_equal_jax():
    rng = np.random.default_rng(3)
    probs = np.concatenate([rng.uniform(0, 1, 500), [0.0, 0.1, 0.5, 0.9, 1.0]])
    for bins in (2, 10, 64):
        np.testing.assert_array_equal(
            PORT.fedeval.reference_histogram(probs, bins=bins),
            JAX.fedeval.reference_histogram(probs, bins=bins),
        )
    cases = [
        ({"Accuracy": 0.9}, None, {}),
        ({"Accuracy": 0.7}, {"Accuracy": 0.8}, {}),
        ({"Accuracy": 0.75}, {"Accuracy": 0.8}, {"min_delta": 0.1}),
        ({"Accuracy": float("nan")}, None, {}),
        ({}, {"Accuracy": 0.5}, {}),
        ({"F1-Score": 0.5}, {"F1-Score": float("nan")}, {"metric": "F1-Score"}),
    ]
    for cand, inc, kw in cases:
        assert PORT.fedeval.eval_gate(cand, inc, **kw) == JAX.fedeval.eval_gate(cand, inc, **kw)


# ------------------------------------------------------------ drift monitor
def _serve_batch(hist) -> str:
    return json.dumps({"phase": "serve_batch", "score_hist": hist})


#: One serving metrics-JSONL stream in appends: clean and shifted
#: batches, foreign phases, negative counts, a wrong bin count, torn
#: tails completed later, a non-list histogram.
STREAM = [
    [_serve_batch([16, 0, 0, 0, 0, 0, 0, 0, 0, 16]), json.dumps({"phase": "serve_summary"})],
    [_serve_batch([-1, 300, 0, 0, 0, 0, 0, 0, 0, 0]), _serve_batch([8, 0, 0, 0, 0, 0, 0, 0, 0, 8])],
    [_serve_batch([0, 0, 0, 0, 32, 32, 0, 0, 0, 0]), '{"phase": "serve_batch", "score_hi'],
    ['st": [16, 0, 0, 0, 0, 0, 0, 0, 0, 16]}', _serve_batch([1, 2, 3])],
    ["not json", _serve_batch("oops"), _serve_batch([40, 0, 0, 0, 0, 0, 0, 0, 0, 40])],
    [_serve_batch([0, 0, 0, 100, 100, 100, 100, 0, 0, 0])],
    [_serve_batch([50, 0, 0, 0, 0, 0, 0, 0, 0, 50]) for _ in range(8)],
    [_serve_batch([0, 0, 0, 0, 0, 0, 0, 0, 0, 200])],
]


@pytest.mark.parametrize("method", ["psi", "ks"])
def test_drift_monitor_verdict_sequence_equals_jax(method, tmp_path):
    def run(ns, d):
        path = str(d / "metrics.jsonl")
        dm = ns.DriftMonitor(
            path, reference=[500, 0, 0, 0, 0, 0, 0, 0, 0, 500], threshold=0.25,
            min_scores=64, method=method, window_scores=128,
        )
        out = [dm.poll()]  # the file does not exist yet
        for chunk in STREAM:
            with open(path, "a") as f:
                f.write("\n".join(chunk) + ("" if chunk[-1].endswith("score_hi") else "\n"))
            out.append((dm.poll(), dm.observed_scores))
        dm.set_reference([5, 5, 5, 5, 5, 5, 5, 5, 5, 5])  # a promotion: the tail skips to the end
        with open(path, "a") as f:
            f.write(_serve_batch([0, 0, 0, 0, 0, 0, 0, 0, 0, 64]) + "\n")
        out.append((dm.poll(), dm.observed_scores))
        return out

    want, got = _both(run, tmp_path)
    assert got == want
    assert sum(v is not None for v, _ in want[1:]) >= 2  # the stream fires


@pytest.mark.parametrize(
    "case", ["fires_on_shift", "needs_min_scores", "tails_serving_jsonl", "malformed_counts", "top_bins"]
)
def test_drift_monitor_cases_equal_jax(case, tmp_path):
    """The JAX package's DriftMonitor tests, each run on both packages."""

    def run(ns, d):
        out = []
        if case == "fires_on_shift":
            dm = ns.DriftMonitor(reference=[400, 200, 50, 20, 10, 10, 20, 50, 200, 400], threshold=0.25, min_scores=200)
            dm.observe([40, 20, 5, 2, 1, 1, 2, 5, 20, 40])
            out.append(dm.check())
            dm.observe([200, 100, 25, 10, 5, 5, 10, 25, 100, 200])
            out.append(dm.check())
            dm.reset_window()
            dm.observe([0, 0, 0, 150, 150, 150, 150, 0, 0, 0])
            v = dm.check()
            assert v["drift"] >= 0.25 and v["scores"] == 600 and dm.observed_scores == 0
            out.append(v)
        elif case == "needs_min_scores":
            dm = ns.DriftMonitor(reference=[10, 10], threshold=0.1, min_scores=100)
            dm.observe([99, 0])
            out.append(dm.check())
            dm.observe([99, 0])
            out.append(dm.check())
            assert out == [None, out[1]] and out[1] is not None
        elif case == "tails_serving_jsonl":
            path = str(d / "metrics.jsonl")
            dm = ns.DriftMonitor(path, reference=[500, 0, 0, 0, 0, 0, 0, 0, 0, 500], threshold=0.25, min_scores=64)
            out.append(dm.poll())
            with open(path, "w") as f:
                f.write(_serve_batch([16, 0, 0, 0, 0, 0, 0, 0, 0, 16]) + "\n")
                f.write(json.dumps({"phase": "serve_summary"}) + "\n")
            out.append((dm.poll(), dm.observed_scores))
            with open(path, "a") as f:
                f.write(_serve_batch([0, 0, 0, 0, 32, 32, 0, 0, 0, 0]) + "\n")
                f.write('{"phase": "serve_batch", "score_hi')
            out.append((dm.poll(), dm.observed_scores))
            with open(path, "a") as f:
                f.write('st": [16, 0, 0, 0, 0, 0, 0, 0, 0, 16]}\n')
            out.append((dm.poll(), dm.observed_scores))
            assert out[1] == (None, 32) and out[2][0] is not None and out[3] == (None, 32)
        elif case == "malformed_counts":
            path = str(d / "metrics.jsonl")
            dm = ns.DriftMonitor(path, reference=[10, 10], threshold=0.1, min_scores=8)
            with open(path, "w") as f:
                f.write(_serve_batch([-1, 300]) + "\n" + _serve_batch([8, 0]) + "\n")
            v = dm.poll()
            assert v is not None and v["scores"] == 8
            out.append(v)
        else:
            mon = ns.DriftMonitor(reference=[100, 100, 100, 100], threshold=0.05, min_scores=100)
            mon.observe([10, 10, 10, 370])
            v = mon.check()
            assert v["top_bins"][0]["bin"] == 3
            assert v["top_bins"][0]["observed_frac"] > v["top_bins"][0]["expected_frac"]
            out.append(v)
        return out

    want, got = _both(run, tmp_path)
    assert got == want


def test_psi_contributions_decompose_psi_exactly():
    ref, obs = [100, 100, 100, 100], [100, 100, 40, 160]
    terms = PORT.drift.psi_contributions(ref, obs, top_k=4)
    assert terms == JAX.drift.psi_contributions(ref, obs, top_k=4)
    assert sum(t["psi"] for t in terms) == pytest.approx(PORT.drift.psi(ref, obs), abs=1e-5)
    assert {t["bin"] for t in terms[:2]} == {2, 3}
    assert PORT.drift.psi_contributions(ref, ref) == []


def test_error_rate_monitor_lifecycle_equals_jax(tmp_path):
    def run(ns, d):
        em = ns.ErrorRateMonitor(reference_error=0.02, margin=0.05, min_joined=64)
        out = []
        for wrong, total in ((1, 32), (1, 32), (10, 64)):
            em.observe(wrong, total)
            out.append(em.check())
        assert out[2]["scores"] == 128 and em.observed_joined == 0
        em.observe_verdict({"n": 64, "error": 0.5})
        out.append(em.check())
        cold = ns.ErrorRateMonitor(margin=0.05, min_joined=8)
        cold.observe(8, 8)
        out.append((cold.has_reference, cold.check()))
        out.append(_call(em.observe, 5, 3))
        out.append(_call(ns.ErrorRateMonitor, margin=0.0))
        out.append(_call(ns.ErrorRateMonitor, min_joined=0))
        out.append(_call(em.set_reference, 1.5))
        return out

    want, got = _both(run, tmp_path)
    assert got == want and want[2]["method"] == "error_rate"


def test_slo_actuator_tightens_until_clear_equals_jax(tmp_path):
    def run(ns, d):
        alerts = str(d / "alerts.jsonl")
        act = ns.SloActuator(alerts, factor=0.5)
        out = [act.poll(), act.effective_deadline(20.0), act.effective_deadline(None)]

        def emit(event, slo="round-duration", instance="server:1"):
            with open(alerts, "a") as f:
                f.write(json.dumps({"schema": "fedtpu-alert-v1", "event": event, "slo": slo,
                                    "instance": instance, "severity": "page"}) + "\n")

        emit("fire")
        out += [act.poll(), act.effective_deadline(20.0), act.effective_deadline(None)]
        emit("fire", slo="scoring-queue-p99")
        emit("clear")
        with open(alerts, "a") as f:
            f.write("not json\n")
        out += [act.poll(), act.effective_deadline(20.0)]
        emit("fire", instance="a")
        emit("fire", instance="b")
        emit("clear", instance="a")
        out.append(act.poll())
        emit("clear", instance="b")
        out.append(act.poll())
        out.append(_call(ns.SloActuator, alerts, factor=0.0))
        return out

    want, got = _both(run, tmp_path)
    assert got == want
    assert want[:6] == [False, 20.0, None, True, 10.0, None] and want[8:10] == [True, False]


def test_control_config_validation_equals_jax():
    bad = [
        dict(slo_deadline_factor=0.0), dict(max_artifacts=0), dict(drift_method="l2"),
        dict(drift_threshold=0.0), dict(drift_min_scores=0), dict(score_bins=65),
        dict(min_interval_s=-1.0), dict(min_interval_s=5.0, max_interval_s=1.0),
        dict(cohort_min_frac=0.0), dict(cohort_max_frac=1.5), dict(cohort_min_frac=0.8, cohort_max_frac=0.5),
    ]
    for kw in bad:
        assert _call(PORT.ControlConfig, **kw) == _call(JAX.ControlConfig, **kw), kw
    assert dataclasses.asdict(PORT.ControlConfig()) == dataclasses.asdict(JAX.ControlConfig())


# --------------------------------------------------------------- campaigns
_TIME_FIELDS = ("ts", "round_wall_s", "promotion_latency_s")


def _events(path) -> list[dict]:
    """The state file's records, time fields aside."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(ln).items() if k not in _TIME_FIELDS} for ln in f]


def _registry_state(registry) -> dict:
    serving = registry.serving_info()
    return {
        "serving": serving["artifact"] if serving else None,
        "artifacts": sorted(
            (m["id"], m["state"], m["round"], m["parent"], m["eval_hist"], sorted(m["metrics"].items()))
            for m in registry.list()
        ),
    }


def _summary(ctl) -> dict:
    s = ctl.summary()
    for k in ("round_wall_s", "cycle_wall_s", "promotion_latency_ms_mean"):
        s.pop(k)
    return s


def _mean_eval(params):
    """The JAX tests' synthetic held-out eval: 'accuracy' tracks the mean
    weight, probs from a fixed seed feed the reference histogram."""
    mean = float(np.asarray(params["w"], np.float64).mean())
    rng = np.random.default_rng(7)
    return {"Accuracy": mean if np.isfinite(mean) else float("nan"), "probs": rng.uniform(0, 1, 128)}


def _clients(ns, port, uploads, rounds, errors, seen):
    """Two library clients in threads: ``uploads(r, cid, cur)`` is what
    client ``cid`` sends in round ``r`` (``cur`` the last aggregate)."""

    def loop(cid):
        try:
            fc = ns.FederatedClient("127.0.0.1", port, client_id=cid, timeout=60)
            cur = None
            for r in range(rounds):
                cur = fc.exchange(uploads(r, cid, cur))
                seen.append((cid, fc.last_trace[1]))
        except Exception as e:  # re-raised by the caller's assert
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(c,), daemon=True) for c in range(2)]
    for t in threads:
        t.start()
    return threads


def _campaign_unattended(ns, d):
    registry = ns.ModelRegistry(str(d / "reg"))
    state = str(d / "state.jsonl")
    errors, seen = [], []
    with ns.Server(port=0, num_clients=2, timeout=30) as server:
        ctl = ns.Controller(server, registry, _mean_eval, control=ns.ControlConfig(round_deadline_s=20.0),
                            state_path=state)

        def uploads(r, cid, cur):
            base = np.zeros(16, np.float32) if cur is None else cur["w"]
            return {"w": base + np.float32(0.1 * (r + 1))}

        threads = _clients(ns, server.port, uploads, 2, errors, seen)
        stats = ctl.run(max_rounds=2)
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors
    assert stats.rounds_completed == 2 and stats.promotions == 2 and stats.gate_rejections == 0
    serving = registry.serving_manifest()
    assert serving["round"] == 1 and serving["eval_hist"] is not None
    with ns.Server(port=0, num_clients=2, timeout=5) as server2:
        resumed = ns.Controller(server2, registry, _mean_eval, state_path=state)
    assert resumed._next_round == 2 and resumed.stats.promotions == 2
    return _events(state), _registry_state(registry), _summary(ctl), _summary(resumed), sorted(seen)


def _campaign_corrupted(ns, d):
    registry = ns.ModelRegistry(str(d / "reg"))
    state = str(d / "state.jsonl")
    errors, seen = [], []
    with ns.Server(port=0, num_clients=2, timeout=30) as server:
        ctl = ns.Controller(server, registry, _mean_eval, control=ns.ControlConfig(round_deadline_s=20.0),
                            state_path=state)

        def uploads(r, cid, cur):
            return {"w": np.full(16, 0.5 if r == 0 else np.nan, np.float32)}

        threads = _clients(ns, server.port, uploads, 2, errors, seen)
        stats = ctl.run(max_rounds=2)
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors
    assert stats.promotions == 1 and stats.gate_rejections == 1
    good = registry.serving_info()["artifact"]
    rej = [e for e in _events(state) if e["event"] == "gate_rejected"]
    assert len(rej) == 1 and rej[0]["incumbent"] == good and "not finite" in rej[0]["reason"]
    return _events(state), _registry_state(registry), _summary(ctl), sorted(seen)


def _campaign_drift(ns, d):
    registry = ns.ModelRegistry(str(d / "reg"))
    state = str(d / "state.jsonl")
    dm = ns.DriftMonitor(threshold=0.25, min_scores=64)
    tracer = ns.Tracer(str(d / "ctl.jsonl"), proc="controller")
    errors, seen = [], []
    with ns.Server(port=0, num_clients=2, timeout=30) as server:
        ctl = ns.Controller(server, registry, _mean_eval, control=ns.ControlConfig(round_deadline_s=20.0),
                            state_path=state, drift_monitor=dm, drift_poll_s=0.05, tracer=tracer)

        def uploads(r, cid, cur):
            return {"w": np.full(16, 0.5, np.float32) if cur is None else cur["w"] + np.float32(0.1)}

        threads = _clients(ns, server.port, uploads, 2, errors, seen)
        run_t = threading.Thread(target=lambda: ctl.run(max_rounds=2), daemon=True)
        run_t.start()
        deadline = time.monotonic() + 30
        while registry.serving_info() is None:
            assert time.monotonic() < deadline, "bootstrap round never promoted"
            time.sleep(0.05)
        time.sleep(0.3)  # the controller enters its drift wait
        assert ctl.stats.rounds_completed == 1
        shifted = np.zeros(10, np.int64)
        shifted[4:6] = 64
        dm.observe(shifted)
        run_t.join(timeout=30)
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors
    assert ctl.stats.drift_triggers == 1
    second = [e for e in _events(state) if e["event"] == "promoted" and e["round"] == 1]
    assert second and second[0]["trigger"] == "drift"
    spans = [
        {k: s.get(k) for k in ("span", "round", "artifact", "passed", "drift", "method", "scores", "top_bins")}
        for s in ns.load_spans([str(d / "ctl.jsonl")])
    ]
    return _events(state), _registry_state(registry), _summary(ctl), spans, sorted(seen)


def _campaign_round_errors(ns, d):
    class FlakyServer:
        dp_clip = 0.0

        def __init__(self):
            self.calls = 0

        def serve_round(self, *, deadline=None, round_index=None):
            self.calls += 1
            if self.calls == 1:
                raise ns.WireError("model 1 key set differs from model 0")
            return {"w": np.full(8, 0.5, np.float32)}

    registry = ns.ModelRegistry(str(d / "reg"))
    ctl = ns.Controller(FlakyServer(), registry, _mean_eval, state_path=str(d / "state.jsonl"))
    stats = ctl.run(max_rounds=2)
    assert stats.rounds_failed == 1 and stats.rounds_completed == 1
    return _events(d / "state.jsonl"), _registry_state(registry), _summary(ctl)


def _campaign_eval_errors(ns, d):
    calls = [0]

    def flaky_eval(params):
        calls[0] += 1
        if calls[0] == 1:
            raise TypeError("foreign architecture: missing encoder scope")
        return _mean_eval(params)

    class Srv:
        dp_clip = 0.0

        def __init__(self):
            self.n = 0

        def serve_round(self, *, deadline=None, round_index=None):
            self.n += 1
            return {"w": np.full(8, float(self.n), np.float32)}

    registry = ns.ModelRegistry(str(d / "reg"))
    state = str(d / "state.jsonl")
    ctl = ns.Controller(Srv(), registry, flaky_eval, state_path=state)
    stats = ctl.run(max_rounds=2)
    assert stats.rounds_completed == 2 and stats.promotions == 1
    assert [e["event"] for e in _events(state)] == ["cycle_error", "promoted"]
    resumed = ns.Controller(Srv(), registry, flaky_eval, state_path=state)
    assert resumed.stats.rounds_attempted == 2 and resumed.stats.rounds_completed == 2
    return _events(state), _registry_state(registry), _summary(ctl), _summary(resumed)


def _campaign_clock_fallback(ns, d):
    registry = ns.ModelRegistry(str(d / "reg"))
    a = registry.add({"w": np.zeros(8, np.float32)}, round_index=0)
    registry.promote(a, to="serving")

    class OneShotServer:
        dp_clip = 0.0

        def serve_round(self, *, deadline=None, round_index=None):
            return {"w": np.full(8, 0.5, np.float32)}

    dm = ns.DriftMonitor(threshold=0.25, min_scores=8)
    ctl = ns.Controller(OneShotServer(), registry, _mean_eval, state_path=str(d / "state.jsonl"),
                        drift_monitor=dm, drift_poll_s=0.05)
    assert not dm.has_reference
    stats = ctl.run(max_rounds=1)
    assert stats.rounds_completed == 1 and dm.has_reference
    return _events(d / "state.jsonl"), _registry_state(registry), _summary(ctl)


def _campaign_adaptive_cadence(ns, d):
    registry = ns.ModelRegistry(str(d / "reg"))
    a = registry.add({"w": np.zeros(4, np.float32)}, round_index=0)
    registry.promote(a, to="serving")

    class Srv:
        dp_clip = 0.0

        def serve_round(self, *, deadline=None, round_index=None):
            return {"w": np.full(4, 0.5, np.float32)}

    dm = ns.DriftMonitor(reference=[100, 0, 0, 0, 0, 0, 0, 0, 0, 100], threshold=7.0, min_scores=8)
    tracer = ns.Tracer(str(d / "ctl.jsonl"), proc="controller")
    ctl = ns.Controller(
        Srv(), registry, lambda p: {"Accuracy": 0.9},
        control=ns.ControlConfig(adaptive_cadence=True, min_interval_s=1.0, max_interval_s=30.0),
        state_path=str(d / "state.jsonl"), drift_monitor=dm, drift_poll_s=0.01, tracer=tracer,
    )
    dm.observe([0, 0, 0, 40, 40, 0, 0, 0, 0, 120])
    stop = threading.Event()
    assert ctl._wait_for_trigger(stop) == "drift"
    chosen = ctl._interval_override
    assert 1.0 < chosen <= 30.0
    dm.observe([0, 0, 0, 0, 500, 500, 0, 0, 0, 0])
    assert ctl._wait_for_trigger(stop) == "drift"
    assert ctl._interval_override == 1.0
    spans = [
        {k: v for k, v in s.items() if k not in ("ts", "run_id", "dur_s")}
        for s in ns.load_spans([str(d / "ctl.jsonl")])
    ]
    return _events(d / "state.jsonl"), chosen, spans


def _campaign_slo_actuation(ns, d):
    alerts = str(d / "alerts.jsonl")

    def emit(event):
        with open(alerts, "a") as f:
            f.write(json.dumps({"event": event, "slo": "round-duration", "instance": "server:1"}) + "\n")

    seen = []

    class Srv:
        dp_clip = 0.0

        def __init__(self):
            self.n = 0

        def serve_round(self, *, deadline=None, round_index=None):
            seen.append((deadline, round_index))
            self.n += 1
            return {"w": np.full(4, float(self.n), np.float32)}

    registry = ns.ModelRegistry(str(d / "reg"))
    ctl = ns.Controller(
        Srv(), registry, lambda p: {"Accuracy": float(np.asarray(p["w"]).mean())},
        control=ns.ControlConfig(round_deadline_s=40.0, slo_deadline_factor=0.25),
        state_path=str(d / "state.jsonl"), slo_actuator=ns.SloActuator(alerts, factor=0.25),
    )
    ctl.run_cycle()
    emit("fire")
    out = ctl.run_cycle()
    assert out.get("slo_tightened") is True
    emit("clear")
    ctl.run_cycle()
    assert [s[0] for s in seen] == [40.0, 10.0, 40.0]
    return _events(d / "state.jsonl"), seen, _registry_state(registry)


def _campaign_drift_cohort(ns, d):
    class StubRoundServer:
        dp_clip = 0.0

        def __init__(self, min_clients=4):
            self.min_clients = min_clients
            self.seen_quorums = []
            self.n = 0

        def serve_round(self, *, deadline=None, round_index=None):
            self.seen_quorums.append(self.min_clients)
            self.n += 1
            return {"w": np.full(8, float(self.n), np.float32)}

    registry = ns.ModelRegistry(str(d / "reg"))
    state = str(d / "state.jsonl")
    dm = ns.DriftMonitor(threshold=0.25, min_scores=64)
    server = StubRoundServer(min_clients=4)
    ctl = ns.Controller(
        server, registry, _mean_eval,
        control=ns.ControlConfig(drift_cohort=True, cohort_min_frac=0.25, cohort_max_frac=0.5,
                                 round_deadline_s=20.0),
        state_path=state, drift_monitor=dm, drift_poll_s=0.05,
    )
    run_t = threading.Thread(target=lambda: ctl.run(max_rounds=2), daemon=True)
    run_t.start()
    deadline = time.monotonic() + 20
    while registry.serving_info() is None:
        assert time.monotonic() < deadline, "bootstrap round never promoted"
        time.sleep(0.05)
    time.sleep(0.3)
    shifted = np.zeros(10, np.int64)
    shifted[4:6] = 64
    dm.observe(shifted)
    run_t.join(timeout=30)
    assert not run_t.is_alive()
    assert server.seen_quorums == [4, 2] and server.min_clients == 4
    trig = [e for e in _events(state) if e["event"] == "drift_trigger"]
    assert trig and trig[-1]["cohort_target"] == 2
    return _events(state), _registry_state(registry), server.seen_quorums


def _campaign_sentinel_link(ns, d):
    """The sentinel's verdicts-JSONL poking a corrective round."""
    registry = ns.ModelRegistry(str(d / "reg"))
    verdicts = str(d / "verdicts.jsonl")
    with open(verdicts, "w") as f:  # history: never a fresh trigger
        f.write(json.dumps({"schema": "fedtpu-sentinel-verdict-v1", "drift": 0.9, "method": "error_rate"}) + "\n")

    class Srv:
        dp_clip = 0.0

        def __init__(self):
            self.n = 0

        def serve_round(self, *, deadline=None, round_index=None):
            self.n += 1
            return {"w": np.full(4, float(self.n), np.float32)}

    dm = ns.DriftMonitor(threshold=0.25, min_scores=64)
    ctl = ns.Controller(Srv(), registry, _mean_eval, state_path=str(d / "state.jsonl"), drift_monitor=dm,
                        drift_poll_s=0.02, sentinel_link=ns.drift.SentinelLink(verdicts))
    assert ctl.run_cycle("bootstrap")["event"] == "promoted"
    stop = threading.Event()
    timer = threading.Timer(0.3, stop.set)
    timer.start()
    assert ctl._wait_for_trigger(stop) is None  # the old verdict is history
    timer.cancel()
    with open(verdicts, "a") as f:
        f.write(json.dumps({"schema": "fedtpu-sentinel-verdict-v1", "drift": 0.2, "method": "error_rate",
                            "threshold": 0.05, "scores": 80, "error": 0.25, "reference_error": 0.05}) + "\n")
    assert ctl._wait_for_trigger(threading.Event()) == "drift"
    ctl.run_cycle("drift")
    return _events(d / "state.jsonl"), _registry_state(registry), _summary(ctl)


CAMPAIGNS = {
    "unattended_rounds": _campaign_unattended,
    "corrupted_candidate_blocked": _campaign_corrupted,
    "drift_triggers_next_round": _campaign_drift,
    "round_engine_errors_survive": _campaign_round_errors,
    "eval_errors_survive": _campaign_eval_errors,
    "clock_fallback": _campaign_clock_fallback,
    "adaptive_cadence": _campaign_adaptive_cadence,
    "slo_actuation": _campaign_slo_actuation,
    "drift_scaled_cohort": _campaign_drift_cohort,
    "sentinel_link_trigger": _campaign_sentinel_link,
}


@pytest.mark.parametrize("case", sorted(CAMPAIGNS))
def test_campaign_equals_jax(case, tmp_path):
    want, got = _both(CAMPAIGNS[case], tmp_path)
    assert got == want


@pytest.mark.parametrize("first", ["jax", "port"])
def test_campaign_resumes_across_packages(first, tmp_path):
    """One package runs round 0 live; the other resumes the campaign from
    the same registry and state file, numbers its round 1 (the replies
    say so), and both tallies replay."""
    a, b = (JAX, PORT) if first == "jax" else (PORT, JAX)
    reg_dir, state = str(tmp_path / "reg"), str(tmp_path / "state.jsonl")

    replies = []
    for k, ns in enumerate((a, b)):

        def uploads(r, cid, cur, k=k):
            return {"w": np.full(16, 0.25 * (cid + 1) + k, np.float32)}

        errors, seen = [], []
        registry = ns.ModelRegistry(reg_dir)
        with ns.Server(port=0, num_clients=2, timeout=30) as server:
            ctl = ns.Controller(server, registry, _mean_eval, control=ns.ControlConfig(round_deadline_s=20.0),
                                state_path=state)
            threads = _clients(ns, server.port, uploads, 1, errors, seen)
            ctl.run(max_rounds=1)
            for t in threads:
                t.join(timeout=30)
        assert not errors, errors
        replies.append(sorted(seen))
        summary = _summary(ctl)
    assert replies == [[(0, 0), (1, 0)], [(0, 1), (1, 1)]]
    assert summary["rounds_completed"] == 2 and summary["promotions"] == 2
    events = _events(state)
    assert [(e["event"], e["round"]) for e in events] == [("promoted", 0), ("promoted", 1)]
    for ns in (JAX, PORT):
        with ns.Server(port=0, num_clients=2, timeout=5) as server:
            resumed = ns.Controller(server, ns.ModelRegistry(reg_dir), _mean_eval, state_path=state)
        assert resumed._next_round == 2 and _summary(resumed) == {**summary, "rounds_attempted": 2}
    serving = JAX.ModelRegistry(reg_dir).serving_manifest()
    assert serving["round"] == 1 and serving["parent"] == events[0]["artifact"]
    assert PORT.ModelRegistry(reg_dir).serving_manifest() == serving


def test_unported_gates_raise(tmp_path):
    registry = PORT.ModelRegistry(str(tmp_path / "reg"))

    class Srv:
        dp_clip = 0.0

    for kw in (dict(shadow_gate=object()), dict(label_gate=object()),
               dict(error_monitor=PORT.ErrorRateMonitor(reference_error=0.1))):
        with pytest.raises(NotImplementedError, match="14b"):
            PORT.Controller(Srv(), registry, _mean_eval, **kw)


def test_central_dp_server_refused_like_jax(tmp_path):
    class DpServer:
        dp_clip = 1.0

    for ns in (JAX, PORT):
        with pytest.raises(ValueError, match="central-DP"):
            ns.Controller(DpServer(), ns.ModelRegistry(str(tmp_path / "reg")), _mean_eval)


# ------------------------------------------------------ the gate on a model
def test_gate_on_a_model_within_evaluate_bounds(tmp_path):
    """Both controllers gate a round of two tiny models through their own
    ``Trainer.evaluate`` of the aggregate: the metrics within the
    evaluate bounds, the eval histogram and the artifact id equal."""
    import jax

    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
        config as jcfg,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data.pipeline import (
        TokenizedSplit as JaxSplit,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
        DDoSClassifier,
        init_params,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train.engine import (
        Trainer as JaxTrainer,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
        config as pcfg,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
        TokenizedSplit,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
        Trainer,
    )

    pmodel = pcfg.ModelConfig.tiny()
    jmodel = jcfg.ModelConfig(**dataclasses.asdict(pmodel))
    base = jax.tree_util.tree_map(np.asarray, init_params(DDoSClassifier(jmodel), jmodel, jax.random.key(3)))
    rng = np.random.default_rng(4)
    n = 37
    ids = rng.integers(5, pmodel.vocab_size, (n, pmodel.max_len)).astype(np.int32)
    ids[:, 0] = 2
    lengths = rng.integers(pmodel.max_len // 3, pmodel.max_len + 1, n)
    mask = (np.arange(pmodel.max_len)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    labels = rng.integers(0, 2, n).astype(np.int32)
    jt = JaxTrainer(jmodel, jcfg.TrainConfig())
    pt = Trainer(pmodel, pcfg.TrainConfig(), device="cpu")
    evals = {
        "jax": lambda p: jt.evaluate(p, JaxSplit(ids, mask, labels), batch_size=8),
        "port": lambda p: pt.evaluate(p, TokenizedSplit(ids, mask, labels), batch_size=8),
    }

    def uploads(r, cid, cur):
        noise = np.random.default_rng(10 + cid)
        return jax.tree_util.tree_map(
            lambda x: (x + noise.normal(0, 0.02, x.shape)).astype(np.float32), base
        )

    def run(ns, d):
        registry = ns.ModelRegistry(str(d / "reg"))
        errors, seen = [], []
        gate = {}

        def eval_fn(params):
            gate.update(evals["port" if ns.port else "jax"](params))
            return gate

        with ns.Server(port=0, num_clients=2, timeout=60) as server:
            ctl = ns.Controller(server, registry, eval_fn, state_path=str(d / "state.jsonl"),
                                model_config=pmodel if ns.port else jmodel)
            threads = _clients(ns, server.port, uploads, 1, errors, seen)
            ctl.run(max_rounds=1)
            for t in threads:
                t.join(timeout=60)
        assert not errors, errors
        return registry.serving_manifest(), gate

    (jm, jgate), (pm, pgate) = _both(run, tmp_path)
    assert pm["id"] == jm["id"] and pm["eval_hist"] == jm["eval_hist"]
    assert pm["model_config"] == jm["model_config"] and sum(pm["eval_hist"]) == n
    for key in ("Accuracy", "Precision", "Recall", "F1-Score"):
        np.testing.assert_allclose(pm["metrics"][key], jm["metrics"][key], rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(pm["metrics"]["Loss"], jm["metrics"]["Loss"], rtol=1e-5)
    np.testing.assert_allclose(pgate["probs"], jgate["probs"], atol=1e-5)
    assert pm["eval_hist"] == PORT.fedeval.reference_histogram(pgate["probs"]).tolist()
    assert set(pm["metrics"]) == set(jm["metrics"])


# ------------------------------------------------- registry and round engine
def test_registry_add_manifest_byte_equal_to_jax(tmp_path, monkeypatch):
    """``add(eval_hist=, parent=)`` writes the JAX manifest byte for byte
    (the clock pinned in both), so either controller resumes a campaign
    the other wrote; the content address is the same."""
    import detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.config as jcfg

    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
        config as pcfg,
    )

    rng = np.random.default_rng(5)
    params = {"a/kernel": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    hist = np.array([3, 0, 5, 1, 0, 0, 2, 9, 0, 4], np.int64)
    for ns in (JAX, PORT):
        monkeypatch.setattr(ns.registry_store.time, "time", lambda: 1234.5)
    out = {}
    for name, ns, mc in (("jax", JAX, jcfg.ModelConfig.tiny()), ("port", PORT, pcfg.ModelConfig.tiny())):
        reg = ns.ModelRegistry(str(tmp_path / name))
        parent = reg.add({"b": np.zeros(4, np.float32)}, round_index=0)
        aid = reg.add(params, round_index=3, metrics={"Accuracy": 0.5, "probs": [1.0]}, eval_hist=hist,
                      model_config=mc, parent=parent)
        with open(tmp_path / name / "artifacts" / aid / "manifest.json", "rb") as f:
            out[name] = (aid, f.read())
    assert out["port"] == out["jax"]
    assert json.loads(out["port"][1])["eval_hist"] == hist.tolist()


@pytest.mark.parametrize("round_index", [None, 0, 7])
def test_serve_round_index_stamps_replies_like_jax(round_index, tmp_path):
    def run(ns, d):
        errors, seen = [], []
        with ns.Server(port=0, num_clients=2, timeout=30) as server:
            threads = _clients(ns, server.port, lambda r, c, cur: {"w": np.full(4, c, np.float32)}, 2, errors, seen)
            traces = []
            for k in range(2):
                ri = None if round_index is None else round_index + 3 * k
                server.serve_round(round_index=ri)
                traces.append(server.last_trace[1])
            for t in threads:
                t.join(timeout=30)
        assert not errors, errors
        return traces, sorted(seen)

    want, got = _both(run, tmp_path)
    assert got == want
    assert want[0] == ([0, 1] if round_index is None else [round_index, round_index + 3])


# --------------------------------------------------------------- the verb
#: (flag, value, dest) of every JAX ``controller`` flag the port keeps.
CONTROLLER_FLAGS = [
    ("--host", "127.0.0.1", "host"), ("--port", "9", "port"), ("--num-clients", "3", "num_clients"),
    ("--min-clients", "1", "min_clients"), ("--timeout", "12.5", "timeout"), ("--rounds", "4", "rounds"),
    ("--state-jsonl", "s.jsonl", "state_jsonl"), ("--gate-metric", "F1-Score", "gate_metric"),
    ("--gate-min-delta", "0.01", "gate_min_delta"), ("--interval", "2", "interval"),
    ("--max-interval", "30", "max_interval"), ("--drift-jsonl", "m.jsonl", "drift_jsonl"),
    ("--drift-threshold", "0.3", "drift_threshold"), ("--drift-min-scores", "64", "drift_min_scores"),
    ("--drift-method", "ks", "drift_method"), ("--round-deadline", "20", "round_deadline"),
    ("--metrics-port", "9100", "metrics_port"), ("--stream-chunk-mb", "2", "stream_chunk_mb"),
    ("--max-artifacts", "5", "max_artifacts"), ("--adaptive-cadence", None, "adaptive_cadence"),
    ("--sentinel-jsonl", "v.jsonl", "sentinel_jsonl"), ("--drift-cohort", None, "drift_cohort"),
    ("--cohort-min-frac", "0.25", "cohort_min_frac"), ("--cohort-max-frac", "0.75", "cohort_max_frac"),
    ("--slo-alerts-jsonl", "a.jsonl", "slo_alerts_jsonl"), ("--slo-deadline-factor", "0.3", "slo_deadline_factor"),
    ("--flight-dir", "fl", "flight_dir"), ("--trace-jsonl", "t.jsonl", "trace_jsonl"),
    ("--synthetic", "300", "synthetic"), ("--preset", "distilbert", "preset"), ("--seed", "3", "seed"),
]


@pytest.mark.parametrize("flag,value,dest", CONTROLLER_FLAGS, ids=[f[0] for f in CONTROLLER_FLAGS])
def test_controller_flag_parses_to_the_jax_value(flag, value, dest):
    given = [flag] if value is None else [flag, value]
    for argv in (["controller", "--registry-dir", "r", *given], ["controller", "--registry-dir", "r"]):
        port = getattr(build_parser().parse_args(argv), dest)
        want = getattr(jax_parser().parse_args(argv), dest)
        assert port == want and type(port) is type(want), (argv, port, want)


#: The JAX controller's flags of paths not ported: secure aggregation
#: (ROADMAP item 11) and the shadow, label and error-drift gates (14b).
UNPORTED_FLAGS = [
    ["--secure-agg"], ["--shadow-gate"], ["--shadow-min-pairs", "8"], ["--shadow-timeout", "5"],
    ["--shadow-max-flip-rate", "0.1"], ["--shadow-psi-threshold", "0.2"], ["--label-gate"],
    ["--label-journal", "j.jsonl"], ["--label-min-joined", "8"], ["--label-coverage-floor", "0.1"],
    ["--label-max-regression", "0.1"], ["--error-drift"],
]


@pytest.mark.parametrize("flag", UNPORTED_FLAGS, ids=[f[0] for f in UNPORTED_FLAGS])
def test_controller_refuses_the_unported_flags(flag, capsys):
    argv = ["controller", "--registry-dir", "r", *flag]
    jax_parser().parse_args(argv)  # the JAX verb has them
    with pytest.raises(SystemExit):
        build_parser().parse_args(argv)
    assert "unrecognized arguments" in capsys.readouterr().err


def test_controller_verb_runs_a_campaign_on_the_cpu(tmp_path):
    """``controller --device cpu`` with two port ``client``s for two
    rounds: round 0 bootstraps, round 1 is gated; the gate's metrics are
    ``Trainer.evaluate`` of the same aggregate on the pooled validation
    rows, and the manifest's histogram is theirs."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.comm import (
        run_client,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.control import (
        build_controller,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.fedeval import (
        reference_histogram,
    )

    reg = str(tmp_path / "reg")
    run = build_controller(build_parser().parse_args([
        "controller", "--device", "cpu", "--synthetic", "300", "--host", "127.0.0.1", "--port", "0",
        "--rounds", "2", "--registry-dir", reg, "--timeout", "120", "--trace-jsonl", str(tmp_path / "ctl.jsonl"),
    ]))
    assert run.trainer.device.type == "cpu" and run.server.device.type == "cpu"
    res, errors = {}, []

    def client(i):
        try:
            res[i] = run_client(build_parser().parse_args([
                "client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(run.server.port),
                "--device", "cpu", "--synthetic", "300", "--epochs", "1", "--rounds", "2", "--timeout", "120",
                "--output-dir", str(tmp_path / "out"),
            ]))
        except BaseException as e:  # re-raised by the assert below
            errors.append(e)

    try:
        with run.server:
            threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            stats = run.controller.run(max_rounds=2)
            for t in threads:
                t.join(timeout=120)
    finally:
        PORT_OBS.set_global_tracer(None)
    assert not errors, errors
    assert stats.rounds_completed == 2
    events = _events(os.path.join(reg, "controller_state.jsonl"))
    assert [(e["event"], e["round"], e["trigger"]) for e in events[:1]] == [("promoted", 0, "bootstrap")]
    assert events[1]["event"] in ("promoted", "gate_rejected") and events[1]["round"] == 1
    registry = PORT.ModelRegistry(reg)
    last = registry.manifest(events[1]["artifact"])
    params = registry.load_params(last["id"])
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
        wire,
    )

    m = run.trainer.evaluate(wire.unflatten_params(params), run.val, batch_size=16)
    assert last["eval_hist"] == reference_histogram(m["probs"]).tolist()
    for key in ("Accuracy", "Loss", "F1-Score"):
        assert last["metrics"][key] == m[key]
    # Each client's second reply is round 1's aggregate: the artifact.
    for i in range(2):
        got = res[i]["rounds"][-1]["aggregate"]
        assert all(np.array_equal(v, params[k]) for k, v in wire.flatten_params(got).items())
    names = {s["span"] for s in PORT.load_spans([str(tmp_path / "ctl.jsonl")])}
    assert {"eval-gate", "round", "agg"} <= names
