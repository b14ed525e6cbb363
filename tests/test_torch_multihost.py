"""Multi-process federation in the port (parallel/multihost.py) held
against the JAX package's ``tests/test_multihost.py``.

The single-process degenerate paths run inline, as the JAX cases do. The
real thing, two OS processes each owning one client and joined by
``torch.distributed`` over gloo on the CPU, runs through the port's CLI:
the fast lane holds one such run against the one-process ``federated``
run of the same config (the aggregate within the JAX tests' params bound,
the metrics CSVs equal, both processes logging the same round lines);
the JAX package's other two-process cases (``--stream``, checkpoint
resume, DP-FedAvg, FedOpt) keep its ``slow`` mark. Every spawned group
gets a fresh coordinator port, a rendezvous timeout and a per-process
time limit.
"""

import importlib
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

mh = importlib.import_module(PORT_PKG + ".parallel.multihost")
pmesh = importlib.import_module(PORT_PKG + ".parallel.mesh")


def test_initialize_noop_single_process(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert mh.initialize() is False
    assert mh.initialize(num_processes=1) is False
    assert mh.process_count() == 1 and mh.process_index() == 0 and mh.backend() is None
    with pytest.raises(ValueError, match="together"):
        mh.initialize(coordinator_address="127.0.0.1:1")
    with pytest.raises(ValueError, match="HOST:PORT"):
        mh.initialize("localhost", 2, 0)
    with pytest.raises(ValueError, match="outside"):
        mh.initialize("127.0.0.1:1", 2, 2)


def test_single_process_mesh_and_slice():
    mesh = mh.make_global_mesh(4, 2, device="cpu")
    assert mesh.devices.shape == (4, 2)
    assert mh.local_client_slice(mesh) == slice(0, 4)


def test_single_process_seq_mesh_and_slice():
    """The 3-axis layout (single-process degenerate) and the client slice
    on a 3-axis mesh."""
    mesh = mh.make_global_seq_mesh(2, 2, 2, device="cpu")
    assert mesh.devices.shape == (2, 2, 2)
    assert mesh.axis_names == ("clients", "data", "seq")
    assert mh.local_client_slice(mesh) == slice(0, 2)


def test_single_process_global_batch_is_identity():
    local = {"x": np.arange(4 * 6 * 2, dtype=np.int32).reshape(4, 6, 2)}
    out = mh.global_batch(local, 4)
    np.testing.assert_array_equal(out["x"], local["x"])
    t = torch.ones(4, 3)
    assert mh.global_rows(t, 4) is t
    with pytest.raises(ValueError, match="rows for 5 clients"):
        mh.global_rows(t, 5)
    arr = mh.global_array_from_replicated(np.ones((4, 3), np.float32))
    assert arr.shape == (4, 3)
    np.testing.assert_array_equal(mh.allgather_hosts(7), np.array([7], np.int64))
    assert mh.all_gather_objects({"a": 1}) == [{"a": 1}]


def test_backend_choice_from_the_rank_device_map():
    assert mh.choose_backend(["h|cpu", "h|cpu"])[0] == "gloo"
    backend, why = mh.choose_backend(["h|cuda:0", "h|cuda:0"])
    assert backend == "gloo" and "NCCL goes unexercised" in why
    assert mh.choose_backend(["h|cuda:0", "h|cuda:1"]) == ("nccl", "every process has a card of its own")
    assert mh.choose_backend(["a|cuda:0", "b|cuda:0"])[0] == "nccl"  # two hosts, a card each


_WORKER = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import main
pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
extra = sys.argv[4:]
multi = [] if pid < 0 else ["--coordinator", f"127.0.0.1:{{port}}", "--num-processes", "2", "--process-id", str(pid)]
rc = main([
    "federated", "--device", "cpu", *multi,
    "--num-clients", "2", "--data-parallel", "2",
    "--rounds", "1", "--epochs", "1",
    "--synthetic", "320", "--data-fraction", "0.5", "--partition", "disjoint",
    "--batch-size", "8", "--max-len", "32",
    "--output-dir", out,
    *extra,
])
print(f"proc {{pid}} rc {{rc}}", flush=True)
sys.exit(rc)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, out, extra=(), pids=(0, 1)):
    """Run the worker as ``pids`` (-1: one process, no coordinator), all
    at once, each within 300 s; returns their outputs."""
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(port), str(out), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path),
        )
        for i in pids
    ]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (p, o) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o[-3000:]}"
    return outputs


def _lines(o: str, tag: str) -> list[str]:
    """Log lines carrying ``tag``, their timestamp prefix stripped."""
    return [re.sub(r"^\S+ \S+ INFO ", "", ln) for ln in o.splitlines() if tag in ln]


def _csv_row(path) -> np.ndarray:
    with open(path) as f:
        return np.array(f.read().splitlines()[1].split(","), float)


def test_two_process_federated_matches_one_process(tmp_path):
    """``federated --coordinator`` as two gloo processes on the CPU, one
    client each, against the one-process run: the aggregate within atol
    2e-6 / rtol 1e-5, every metrics CSV's Accuracy, Precision, Recall and
    F1 equal and Loss within rtol 1e-5, both processes logging the same
    round lines, the backend's choice logged."""
    out1, out2 = tmp_path / "one", tmp_path / "two"
    reg1, reg2 = tmp_path / "reg1", tmp_path / "reg2"
    (one,) = _launch(tmp_path, out1, ("--registry-dir", str(reg1)), pids=(-1,))
    outputs = _launch(tmp_path, out2, ("--registry-dir", str(reg2)))
    assert "backend gloo (processes run on the CPU)" in outputs[0] and "owns clients [1, 2)" in outputs[1]
    rounds = [_lines(o, "Round 1 client") for o in (one, *outputs)]
    assert rounds[0] and rounds[0] == rounds[1] == rounds[2]
    for c in range(2):
        for phase in ("local", "aggregated"):
            a, b = _csv_row(out1 / f"client{c}_{phase}_metrics.csv"), _csv_row(out2 / f"client{c}_{phase}_metrics.csv")
            np.testing.assert_array_equal(a[[0, 2, 3, 4]], b[[0, 2, 3, 4]])
            np.testing.assert_allclose(a[1], b[1], rtol=1e-5)
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry import (
        ModelRegistry,
    )

    r1, r2 = ModelRegistry(str(reg1)), ModelRegistry(str(reg2))
    p1, p2 = r1.load_params(r1.list()[-1]["id"]), r2.load_params(r2.list()[-1]["id"])
    assert p1.keys() == p2.keys()
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], atol=2e-6, rtol=1e-5, err_msg=k)
    assert len(r2.list()) == 1  # process 0 alone publishes


@pytest.mark.slow
def test_two_process_stream_matches_in_memory(tmp_path):
    """--stream under two processes: each streams only its own client's
    tokens; the reports byte-identical to the in-memory two-process run."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
        write_synthetic_csv,
    )

    csv = tmp_path / "flows.csv"
    write_synthetic_csv(str(csv), n_rows=400, seed=13)
    common = ("--csv", str(csv), "--partition", "disjoint")
    out_mem, out_stream = tmp_path / "out_mem", tmp_path / "out_stream"
    _launch(tmp_path, out_mem, common)
    _launch(tmp_path, out_stream, common + ("--stream",))
    for c in range(2):
        for kind in ("local", "aggregated"):
            a = (out_mem / f"client{c}_{kind}_metrics.csv").read_bytes()
            b = (out_stream / f"client{c}_{kind}_metrics.csv").read_bytes()
            assert a == b, (c, kind, a, b)


@pytest.mark.slow
def test_two_process_checkpoint_resume(tmp_path):
    """Round 1 saves each process's clients; a fresh launch resumes from
    the round both hold instead of retraining it."""
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    _launch(tmp_path, out, ("--checkpoint-dir", str(ckpt)))
    assert sorted(os.listdir(ckpt)) == ["process-0", "process-1"]
    out2 = tmp_path / "out2"
    outputs = _launch(tmp_path, out2, ("--checkpoint-dir", str(ckpt)))
    for o in outputs:
        assert "resumed from round 1" in o, o[-2000:]
    assert (out2 / "client0_aggregated_metrics.csv").exists()
    assert not (out2 / "client0_local_metrics.csv").exists()


@pytest.mark.slow
def test_two_process_dp_fedavg(tmp_path):
    """DP-FedAvg across two processes: the noise seed is agreed (process
    0's draw), so both processes report the same DP and round lines."""
    outputs = _launch(tmp_path, tmp_path / "out", ("--dp-clip", "5.0", "--dp-noise-multiplier", "0.05"))
    dp0, dp1 = (_lines(o, "[DP]") for o in outputs)
    assert dp0 and dp0 == dp1
    agg = [_lines(o, "Round 1 client") for o in outputs]
    assert agg[0] and agg[0] == agg[1]


@pytest.mark.slow
def test_two_process_server_opt(tmp_path):
    """FedOpt across two processes: the server optimizer's state is the
    same on both, so their round lines agree."""
    outputs = _launch(tmp_path, tmp_path / "out", ("--server-opt", "momentum", "--server-lr", "1.0"))
    agg = [_lines(o, "Round 1 client") for o in outputs]
    assert agg[0] and agg[0] == agg[1]
