"""The port's delayed ground-truth plane held against the JAX package's.

* Every case of ``tests/test_labels.py`` runs once with the JAX
  package's modules and once with the port's: the journal's
  last-writer-wins, duplicates, conflicts, late arrivals and watermark,
  its bit-identical replay, the supervised verdict arithmetic, the join
  and its coverage, the fail-closed gate on primary pairs only, the
  error-rate monitor, the ranked comparator, the recorded arrival trace
  through a port server, and the live campaign whose promotion verdict
  the delayed labels flip (each package's own ``AggregationServer``; the
  two runs' aggregates are equal). The JAX test module's ``labels``,
  ``shadow``, ``control``, ``registry``, ``serving``, ``comm`` and ``obs``
  imports are re-bound to the port, and its ``ControlConfig``,
  ``ExperimentConfig`` and ``LabelsConfig`` are the port's. The K-class
  metrics and dataset cases use no module of this plane; they run
  against the JAX package's ``ops`` and ``data`` both times.
* Evidence written by one package and ruled on by the other: a journal
  and a pairs file (with its status snapshot) from either package give
  equal label-gate and shadow-gate verdicts in both, equal to
  ``evaluate_supervised`` and ``evaluate_status`` recomputed from the
  files.
"""

import importlib

import numpy as np
import pytest

from test_torch_router import marked_cases, module_fixtures, rebind_gates, run_both  # noqa: F401
from test_torch_secure import JAX_PKG, PORT_PKG

LABELS = rebind_gates(
    "test_labels",
    ("labels", "shadow", "control", "registry", "serving", "comm", "obs"),
    overrides=("ControlConfig", "ExperimentConfig", "LabelsConfig"),
    port_extra=(("engine = ScoreEngine(", "engine = CpuScoreEngine("),),
)


@pytest.mark.parametrize("name,kwargs", marked_cases(LABELS[0]))
def test_labels_case_held_against_jax(name, kwargs, tmp_path, module_fixtures, monkeypatch, capsys):  # noqa: F811
    run_both(LABELS, name, kwargs, tmp_path, module_fixtures, monkeypatch=monkeypatch, capsys=capsys)


def _plane(pkg):
    return (
        importlib.import_module(pkg + ".labels"),
        importlib.import_module(pkg + ".shadow"),
    )


#: Flows, their truth and each side's probability: the candidate is
#: wrong on every 5th flow the incumbent gets right.
N = 96
TRUTH = [int(i % 3 == 0) for i in range(N)]
SERVING = [0.9 if t else 0.1 for t in TRUTH]
CANDIDATE = [(0.2 if t else 0.8) if i % 5 == 0 else p for i, (t, p) in enumerate(zip(TRUTH, SERVING))]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_evidence_written_by_one_package_ruled_by_the_other(writer, tmp_path):
    jlabels, jshadow = _plane(JAX_PKG)
    plabels, pshadow = _plane(PORT_PKG)
    wl, ws = (jlabels, jshadow) if writer == "jax" else (plabels, pshadow)
    root, aid = str(tmp_path / "reg"), "c0ffee00c0ffee00"
    compare = ws.ShadowCompare(
        pairs_jsonl=ws.pairs_path(root, aid), status_path=ws.status_path(root, aid), status_every=1
    )
    for i in range(N):
        compare.register_rid(i + 1, f"r{i}")
        sides = [(compare.note_serving, SERVING[i]), (compare.note_shadow, CANDIDATE[i])]
        for note, prob in sides[:: -1 if i % 2 else 1]:  # either side first
            note(i + 1, prob)
    store = wl.LabelStore(wl.journal_path(root))
    for i in range(0, N, 2):  # half the flows labelled, one conflict, one duplicate
        store.ingest(f"r{i}", TRUTH[i], ts=float(i))
    store.ingest("r0", 1 - TRUTH[0], ts=-1.0)  # older conflicting label: counted, loses
    store.ingest("r2", TRUTH[2], ts=5.0)
    store.advance_watermark(float(N))

    verdicts, statuses, shadow_verdicts = {}, {}, {}
    for name, (lab, sha) in (("jax", (jlabels, jshadow)), ("port", (plabels, pshadow))):
        replay = lab.LabelStore(lab.journal_path(root))
        replay.load()
        statuses[name] = {k: v for k, v in replay.status().items() if k != "path"}
        gate = lab.LabelGate(root, min_joined=16, coverage_floor=0.25, max_regression=0.0)
        verdicts[name] = gate.evaluate(aid)
        shadow_verdicts[name] = sha.ShadowGate(root, min_pairs=N, timeout_s=1.0, poll_s=0.01).wait(aid)
    assert statuses["port"] == statuses["jax"]
    assert statuses["jax"]["conflicts"] == 1 and statuses["jax"]["duplicates"] == 1
    assert verdicts["port"] == verdicts["jax"]
    assert shadow_verdicts["port"] == shadow_verdicts["jax"]
    ok, verdict = verdicts["jax"]
    # The candidate's extra errors regress it: the gate refuses.
    assert not ok and "supervised regression" in verdict["reason"] and verdict["joined"] == N // 2
    # The verdicts are the pure functions over the files themselves.
    records = [r for r in jlabels.join.read_pair_records(jshadow.pairs_path(root, aid)) if not r.get("cand")]
    report = plabels.join_records(records, store.labels_map())
    assert plabels.evaluate_supervised(report, min_joined=16, coverage_floor=0.25, max_regression=0.0) == (
        ok, verdict["reason"]
    )
    status = pshadow.read_status(root, aid)
    want = jshadow.evaluate_status(status, min_pairs=N, max_flip_rate=0.02, psi_threshold=0.25)
    assert shadow_verdicts["port"][:1] == want[:1] and shadow_verdicts["port"][1]["reason"] == want[1]
    assert status["pairs"] == N and status["flips"] == sum(1 for i in range(N) if i % 5 == 0)
