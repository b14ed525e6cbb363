"""The benchmark harness's own CPU tests (``portbench/tests``) in the
tier-1 lane: run in a subprocess, so its ``conftest.py`` and this
directory's stay apart."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_portbench_cpu_suite_passes():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "portbench/tests", "-q", "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
