"""A run loads nothing of JAX, nor the JAX package the port came from.

The names are compared by their top-level part, whole: the port's own
name begins with the JAX package's, and a prefix test would flag it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import BENCH, PORT, make_tiny_root
from pbcore.bench import JAX_PACKAGE, forbidden_loaded


def test_top_level_names_are_compared_whole():
    assert PORT.startswith(JAX_PACKAGE)
    assert forbidden_loaded({PORT: 1, PORT + ".train.engine": 1, "jaxtyping": 1, "flaxen": 1}) == []
    assert forbidden_loaded({"jax.numpy": 1, "optax": 1}) == ["jax", "optax"]
    assert forbidden_loaded({JAX_PACKAGE + ".config": 1, "orbax.checkpoint": 1}) == sorted([JAX_PACKAGE, "orbax"])
    assert forbidden_loaded({"jaxlib": 1, "flax.linen": 1}) == ["flax", "jaxlib"]


SCRIPT = r"""
import json, sys, time
root, bench = sys.argv[1], sys.argv[2]
sys.path[:0] = [bench, root]
import torch
import run as harness
from pbcore.bench import forbidden_loaded, load_cell, reader
spec = json.load(open(root + "/BENCHMARK.json"))
for name in json.loads(sys.argv[3]):
    cell, outcome = harness.run_cell(name, 2**31 + 3, 0.3, True, torch.device("cpu"), time.perf_counter(), root)
    harness.result_line(cell, outcome, True, {})
for m in spec["per_layer"]:
    reader(m["name"])
print(json.dumps(forbidden_loaded()))
"""


def test_a_run_of_each_driver_loads_no_jax(tmp_path):
    root = str(tmp_path)
    twins = make_tiny_root(root)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, root, os.path.join(root, "portbench"), json.dumps(sorted(set(twins.values())))],
        capture_output=True, text=True, timeout=300, env=env, cwd=root,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_harness_sources_import_nothing_of_jax():
    import ast

    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                assert forbidden_loaded({n: 1 for n in names}) == [], (f, names)
