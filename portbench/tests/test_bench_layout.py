"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric loads by name from its own file, within the
contract's limits on names, units and keys."""

from __future__ import annotations

import dataclasses
import json
import os
import re

import pytest

from conftest import BENCH, PORT, ROOT
from pbcore import bench

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [r for c in SPEC["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]] + [
            m["layer"] for m in SPEC["per_layer"]] + [c["source"] for c in SPEC["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in SPEC[kind]]
        assert len(got) == len(set(got))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = bench.load_cell(cell)
    assert c.name == cell and c.limits and c.traffic["mode"] in ("train", "score")
    assert bench.driver(c).run
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m.moves in names  # the metric it moves is reported in the cell


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert bench.reader(metric).read(None) is None  # nothing to read -> nothing


def test_every_config_is_used_and_its_fields_are_the_port_s():
    from importlib import import_module

    config = import_module(PORT + ".config")
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"].startswith("portbench/")
        data = json.load(open(os.path.join(ROOT, c["file"])))
        cls = getattr(config, data.get("port_config", bench.DEFAULT_PORT_CONFIG))
        model = {k: v for k, v in data.items() if k not in bench.CONFIG_DOC_KEYS}
        assert set(model) <= {f.name for f in dataclasses.fields(cls)}
        cls(**model)  # validates
        assert set(c["reduced"]) <= set(data) and c["source"] == data["source"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_builds_the_model_config_it_always_built(cell):
    from importlib import import_module

    config = import_module(PORT + ".config")
    c = bench.load_cell(cell)
    built = c.port_config(config)
    assert type(built) is config.ModelConfig and built == config.ModelConfig(**c.model_fields())


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_every_configuration_s_family_loads_with_the_interface(config):
    from math import prod

    from pbcore.weights import KINDS

    data = json.load(open(os.path.join(ROOT, next(c["file"] for c in SPEC["configs"] if c["name"] == config))))
    fam = bench.load_family(data.get("reference", bench.DEFAULT_FAMILY))
    assert all(callable(getattr(fam, f)) for f in bench.FAMILY_INTERFACE)
    cfg = {k: v for k, v in data.items() if k not in bench.CONFIG_DOC_KEYS}
    shapes = fam.leaf_shapes(cfg)
    assert shapes and {fam.leaf_kind(k) for k in shapes} <= set(KINDS)
    assert 0 < fam.n_trainable(cfg) <= sum(prod(s) for s in shapes.values())
    assert fam.forward_flops(cfg, 2, cfg["max_len"]) == 2 * fam.forward_flops(cfg, 1, cfg["max_len"]) > 0
    launch = fam.attention_launch(cfg, 128, cfg["max_len"])
    if launch is not None:
        b, h, h_kv, l, d, causal = launch
        assert (b, l) == (128, cfg["max_len"]) and h % h_kv == 0 and d > 0 and isinstance(causal, bool)


def test_a_family_module_without_the_interface_is_refused(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "half.py").write_text("def leaf_shapes(cfg):\n    return {}\n")
    with pytest.raises(ImportError, match="lacks leaf_kind"):
        bench.load_family("half", str(tmp_path))
    with pytest.raises(ImportError, match="no family module"):
        bench.load_family("absent", str(tmp_path))


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_no_package_marker_at_the_top():
    # The repository's static checker walks root directories that hold an
    # __init__.py; the harness stays out of it.
    assert not os.path.exists(os.path.join(BENCH, "__init__.py"))
