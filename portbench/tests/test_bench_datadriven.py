"""A later change adds a configuration, a cell and a per-layer metric by
adding files and entries alone: no file of the harness is edited."""

from __future__ import annotations

import hashlib
import json
import os
import time

import torch

import run as harness
from conftest import make_tiny_root


def _digests(bench: str) -> dict[str, str]:
    out = {}
    for dirpath, _, files in os.walk(bench):
        for f in files:
            if "__pycache__" not in dirpath:
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, bench)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_throwaway_cell_needs_only_new_files(tmp_path):
    root = str(tmp_path)
    make_tiny_root(root)
    bench = os.path.join(root, "portbench")
    before = _digests(bench)

    # A new configuration, traffic mix, cell and metric: files of their own.
    cfg = json.load(open(os.path.join(bench, "configs", "tiny.json")))
    cfg.update(n_layers=3, dim=48, n_heads=3, hidden_dim=96)
    json.dump(cfg, open(os.path.join(bench, "configs", "tiny-wide.json"), "w"))
    traffic = json.load(open(os.path.join(bench, "traffic", "tiny-score-b128.json")))
    traffic.update(bucket=8, rows=100)
    json.dump(traffic, open(os.path.join(bench, "traffic", "score-b8.json"), "w"))
    json.dump({"limits": {"prob_gap": 0.05}}, open(os.path.join(bench, "workloads", "wide.score-b8.json"), "w"))
    with open(os.path.join(bench, "metrics", "calls.score.py"), "w") as f:
        f.write("def read(tl):\n    return None if tl is None else float(tl.extra['traced_steps'])\n")

    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "tiny-wide", "source": "test", "file": "portbench/configs/tiny-wide.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "wide.score-b8", "config": "tiny-wide", "traffic": "score-b8", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m.get("workloads") and "distilbert.score-b128" in m["workloads"]:
            m["workloads"].append("wide.score-b8")
    spec["per_layer"].append({"name": "calls.score", "unit": "calls", "better": "higher", "source": "host_clock",
                              "layer": "scoring engine", "moves": "score_flows_per_s", "workloads": ["wide.score-b8"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell, outcome = harness.run_cell("wide.score-b8", 5, 0.8, True, torch.device("cpu"), time.perf_counter(), root)
    line = harness.result_line(cell, outcome, True, {})
    assert outcome.correct and line["metrics"]["calls.score"]["value"] >= 1
    assert list(line)[-1] == "checks"
    cell, outcome = harness.run_cell("wide.score-b8", 5, 0.3, False, torch.device("cpu"), time.perf_counter(), root)
    line = harness.result_line(cell, outcome, False, {})
    assert set(line["metrics"]) == {"score_flows_per_s", "score_batch_p95_ms", "setup_s"}

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
