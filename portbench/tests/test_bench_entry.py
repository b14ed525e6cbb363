"""``portbench/run.py`` as the driver starts it."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT


def _run(cwd: str, *args: str, timeout: float = 600) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def _result(stdout: str):
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def test_without_a_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = _run(ROOT, "--workload", "distilbert.score-b128", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode == 3 and _result(out.stdout) is None


def test_the_benchmark_s_files_alone_give_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _run(str(tmp_path), "--workload", "distilbert.score-b128", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and _result(out.stdout) is None


def test_bad_arguments_and_unknown_cells_give_no_result():
    out = _run(ROOT, "--workload", "no.such-cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and _result(out.stdout) is None
    out = _run(ROOT, "--workload", "distilbert.score-b128", "--seed", "x", "--seconds", "1")
    assert out.returncode == 2 and _result(out.stdout) is None


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_scoring_run_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _run(ROOT, "--workload", "distilbert.score-b128", "--seed", str(2**31 + 11), "--seconds", "3",
               "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = _result(out.stdout)
    assert line["correct"] and line["device"]["platform"] == "gpu" and list(line)[-1] == "checks"
    tail = out.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])  # each number beside its limit, last
    assert all(t.startswith("check ") and " limit " in t for t in tail)
    if trace == "1":
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "k1_roofline.score" in line["metrics"] and line["breakdown"]["device_ops"]
