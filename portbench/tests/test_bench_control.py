"""The control and the faults, read as ``portbench/calibrate.py`` reads
them, at a size the CPU holds.

The control is the plain reference computed a precision below the
configuration's bf16 (activations and every product's operands in
float8), put in the program's place. On the card it is read at each
cell's own size, where the limits were set from it; here at DistilBERT's
block cut to 256 wide, 4 layers, L=64, where float8's error already
stands several times clear of bf16's on the number that catches it. The
faults fail the full-size cells' limits at this size too.
"""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

import calibrate
from conftest import make_tiny_root
from pbcore.bench import driver, load_cell
from pbcore.harness import Run
from pbcore.tracing import Tracer

MID = dict(vocab_size=30522, max_len=64, max_position_embeddings=128, dim=256, n_layers=4, n_heads=4, hidden_dim=1024)


@pytest.fixture(scope="module")
def mid_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mid"))
    twins = make_tiny_root(root)
    bench = os.path.join(root, "portbench")
    cfg_path = os.path.join(bench, "configs", "tiny.json")
    cfg = json.load(open(cfg_path))
    cfg.update(MID)
    json.dump(cfg, open(cfg_path, "w"))
    for name in ("tiny-client-b128", "tiny-score-b128"):
        p = os.path.join(bench, "traffic", f"{name}.json")
        t = json.load(open(p))
        t["rows"] = 512
        t["batch" if "batch" in t else "bucket"] = 32
        json.dump(t, open(p, "w"))
    return root, twins


@pytest.mark.parametrize("cell,steady", [("distilbert.client-b128", "loss1_gap"), ("distilbert.score-b128", "prob_gap")])
def test_control_reads_well_above_the_program(mid_root, cell, steady):
    root, twins = mid_root
    c = load_cell(twins[cell], root)
    drv = driver(c)
    run = Run(cell=c, seed=2**31 + 21, seconds=1.0, tracer=Tracer(False), device=torch.device("cpu"),
              t_start=time.perf_counter())
    fn = calibrate.train_readings if c.traffic["mode"] == "train" else calibrate.score_readings
    got = {r["kind"]: r for r in fn(drv, run, True)}
    # The number that catches the control on the card reads it several
    # times above the program here too.
    assert got["control"][steady] >= 3 * got["program"][steady], (got["control"], got["program"])
    # Each fault fails the limits of every cell of the traffic mix.
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    mix = [load_cell(w["name"], root).limits for w in spec["workloads"] if w["traffic"] == c.traffic_name[len("tiny-"):]]
    assert c.limits in mix
    for fault in ("half_batch", "unchanged", "wrong_rows"):
        for limits in mix:
            if fault in got:
                assert any(got[fault][k] > limit for k, limit in limits.items()), (fault, got[fault], limits)
