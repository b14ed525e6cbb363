"""Fixtures of the benchmark's CPU tests.

Run from the repository root: ``python -m pytest portbench/tests -q``.
The harness has no package: ``portbench/`` goes on the path, as it is for
``python3 portbench/run.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
PORT = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch"
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: The small model the CPU runs: DistilBERT's block at toy widths.
TINY = dict(vocab_size=256, max_len=32, max_position_embeddings=64, dim=32, n_layers=2, n_heads=2, hidden_dim=64)


def _tiny_name(cell: str) -> str:
    return "tiny." + cell.split(".", 1)[1]


def make_tiny_root(dest: str, compute_dtype: str = "bfloat16") -> dict:
    """A checkout at ``dest``: ``portbench/`` copied, the port linked,
    and a ``BENCHMARK.json`` whose every cell has a tiny twin (config
    ``tiny``, traffic cut to a few hundred rows and a batch of 16).
    Returns the twins' names by the cells they copy (one cell of each
    traffic mix)."""
    shutil.copytree(BENCH, os.path.join(dest, "portbench"), ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, PORT), os.path.join(dest, PORT))
    bench = os.path.join(dest, "portbench")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(bench, "configs", "distilbert-base.json")))
    cfg.update(TINY, compute_dtype=compute_dtype)
    json.dump(cfg, open(os.path.join(bench, "configs", "tiny.json"), "w"))
    spec["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    twins = {}
    for w in list(spec["workloads"]):
        traffic = "tiny-" + w["traffic"]
        if traffic in {t["traffic"] for t in spec["workloads"]}:
            continue  # one twin per traffic mix
        name = _tiny_name(w["name"])
        twins[w["name"]] = name
        spec["workloads"].append(dict(w, name=name, config="tiny", traffic=traffic))
        shutil.copy(os.path.join(bench, "workloads", f"{w['name']}.json"),
                    os.path.join(bench, "workloads", f"{name}.json"))
        t = json.load(open(os.path.join(bench, "traffic", f"{w['traffic']}.json")))
        t.update(rows=320, trace_seconds=0.5)
        t["batch" if "batch" in t else "bucket"] = 16
        json.dump(t, open(os.path.join(bench, "traffic", f"{traffic}.json"), "w"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += sorted({twins[x] for x in m["workloads"] if x in twins})
    json.dump(spec, open(os.path.join(dest, "BENCHMARK.json"), "w"))
    return twins


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A tiny checkout computing in fp32: the program then meets the
    reference to rounding, so a planted fault is all a reading shows."""
    dest = str(tmp_path_factory.mktemp("checkout"))
    return dest, make_tiny_root(dest, compute_dtype="float32")
