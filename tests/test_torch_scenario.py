"""The port's ``scenario`` harness held against the JAX package's.

* Every case of ``tests/test_scenario.py`` (a lazy, a slow, an
  intermittent, a stale and a flaky-net client, the auth and streamed
  cell, the dirichlet cell's weighted mean, the matrix and its reports, a
  failed round reported as a contract violation, the dead-relay cell
  re-homing bit-exact) runs once with the JAX package's modules and once
  with the port's (``test_torch_secure.rebind``; the port's cells fold on
  the CPU), asserting the JAX test's checks; the two runs' server rounds
  are equal.
* A cell's record (``cell_record``: contributors, drops, crcs, manifest,
  notes) is the JAX cell's once the time fields are stripped (and the
  notes sorted), and the
  ``scenario`` verb's JSON lines equal the JAX verb's likewise.
* A ``--train`` cell trains ``ModelConfig.tiny()`` (its default ``dot``
  attention) on the CPU and keeps the contract; its accuracy is on the
  ``fedtpu_round_accuracy`` gauge.
"""

import importlib
import json

import pytest

from test_torch_secure import JAX_PKG, PORT_PKG, cases, rebind, run_both

JAX_SCEN = importlib.import_module("test_scenario")
PORT_SCEN = rebind(
    "test_scenario", subpackages=("faults",), port_extra=(("    return ScenarioConfig(**kw)", '    return ScenarioConfig(device="cpu", **kw)'),)
)


@pytest.mark.parametrize("name,kwargs", cases(JAX_SCEN))
def test_scenario_case_held_against_jax(name, kwargs, tmp_path, monkeypatch):
    run_both(JAX_SCEN, PORT_SCEN, name, kwargs, tmp_path, monkeypatch)


#: Wall-clock fields of a cell record (and of its rounds).
TIME_FIELDS = ("straggler_wait_s", "round_wall_s")


def _strip(rec: dict) -> dict:
    """The record without its time fields; its notes sorted (client
    threads append theirs in completion order)."""
    rec = json.loads(json.dumps(rec))
    for r in rec["rounds"]:
        for k in TIME_FIELDS:
            r.pop(k, None)
    rec["notes"] = sorted(rec["notes"])
    return rec


@pytest.mark.parametrize("persona,partition", [("lazy", "dirichlet"), ("intermittent", "iid")])
def test_cell_record_equals_the_jax_cell(persona, partition, tmp_path):
    got = {}
    for pkg, extra in ((JAX_PKG, {}), (PORT_PKG, {"device": "cpu"})):
        scen = importlib.import_module(pkg + ".faults.scenario")
        cfg = scen.ScenarioConfig(num_clients=3, rounds=2, personas=(persona,), partitions=(partition,),
                                  payload_kb=16, deadline_s=5.0, **extra)
        spec = scen.CellSpec(name=f"{persona}|{partition}", personas=(persona, "honest", "honest"), partition=partition)
        res = scen.run_cell(spec, cfg, str(tmp_path / pkg[-5:]))
        assert scen.contract_violations([res]) == []
        got[pkg] = _strip(scen.cell_record(res))
    assert got[PORT_PKG] == got[JAX_PKG]
    assert all(r["bitexact"] for r in got[PORT_PKG]["rounds"])


def test_scenario_verb_json_equals_the_jax_verb(tmp_path, capsys):
    """``scenario --json`` over one persona, the auth cell and the
    dead-relay cell: exit 0 and the JAX verb's records, time aside."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        main as jax_main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        main,
    )

    argv = ["scenario", "--personas", "lazy", "--partitions", "iid", "--clients", "4", "--rounds", "1",
            "--payload-kb", "16", "--deadline", "4", "--json"]
    out = {}
    for name, fn, extra in (("jax", jax_main, []), ("port", main, ["--device", "cpu"])):
        capsys.readouterr()
        assert fn(argv + ["--out-dir", str(tmp_path / name)] + extra) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
        out[name] = [_strip(json.loads(ln)) for ln in lines]
    assert [r["cell"] for r in out["port"]] == ["lazy|iid", "lazy|iid|auth", "dead-relay|iid"]
    assert out["port"] == out["jax"]


def test_train_cell_keeps_the_contract_on_the_cpu(tmp_path):
    scen = importlib.import_module(PORT_PKG + ".faults.scenario")
    obs_metrics = importlib.import_module(PORT_PKG + ".obs.metrics")
    cfg = scen.ScenarioConfig(num_clients=3, rounds=2, personas=("lazy",), partitions=("iid",), train=True,
                              deadline_s=20.0, data_rows=96, device="cpu")
    spec = scen.CellSpec(name="lazy|iid|train", personas=("lazy", "honest", "honest"), partition="iid")
    res = scen.run_cell(spec, cfg, str(tmp_path))
    assert scen.contract_violations([res]) == [], res.notes
    assert 0.0 <= res.accuracy <= 100.0
    text = obs_metrics.default_registry().render()
    assert 'fedtpu_round_accuracy{cell="lazy|iid|train",strategy="fedavg"}' in text
