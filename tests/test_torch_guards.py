"""Boundaries of the PyTorch port.

* The port and chip_smoke.py import with JAX, flax, optax, orbax,
  ml_dtypes, pandas, matplotlib, safetensors, transformers and the JAX
  package blocked (the card's
  machine has none of them), and no file of theirs imports any of them;
  the port's strategies and int8c codec import only numpy, torch and the
  port itself.
* Entry points run on the card unless the caller asks for the CPU: with
  no CUDA they raise instead of falling back.
* The static checker still resolves its path-suffix rules inside the JAX
  package (the port's name sorts after it), the obs vocabulary's
  ``obs/trace.py`` among them; a directory rule also covers the port's
  copy of that directory (``strategies/``), which passes it; the port's
  only checker pragmas are the reasoned ones on its copies of the wire
  magics (every copied magic carries one) and on its registrations of the
  JAX package's metric families, in the modules that register twins.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.analysis import (
    determinism_rules,
    wire_rules,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.analysis.core import (
    Project,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"
#: Neither is on the card's machine either: the port reads and writes
#: safetensors and HF checkpoints itself (models/safetensors.py, models/hf_convert.py).
BLOCKED = (
    "jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "pandas", "matplotlib",
    "safetensors", "transformers", JAX_PKG,
)
#: The frame magics the port's wire copies from the JAX package.
PORT_MAGICS = {
    "SCRQ", "SCRP", "SCRJ", "SCAU", "SCST", "SCSR", "SCRL", "SCRD", "FTPW", "NONC", "STRH", "STRC", "STRT",
    "DPAD", "DPID", "DPCO", "DPSK", "RNDX", "DHPK", "DHKS", "RVLQ", "RVLA", "SHRS", "SHST", "UMRQ", "UMRS",
}


def _port_files():
    out = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO_ROOT, PORT_PKG)):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_and_chip_smoke_import_without_jax():
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it raises ImportError
sys.path.insert(0, {REPO_ROOT!r})
import {PORT_PKG} as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None)
print(len(names), leaked)
print(" ".join(names))
"""
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    counts, imported = res.stdout.splitlines()
    n, leaked = counts.split(" ", 1)
    assert int(n) >= 20 and leaked.strip() == "[]", res.stdout
    # The federated round's and the single-process federation's modules
    # are among them.
    for mod in (
        "ops.fold", "comm.wire", "comm.quant", "comm.framing", "comm.stream_agg", "comm.server",
        "comm.client", "cli.comm", "strategies", "strategies.core",
        "data.partition", "train.batches", "train.fedsteps", "train.fedeval", "train.federated",
        "parallel.fedavg", "cli.federated", "data.datasets", "data.native_tokenizer", "utils.native",
        "serving.client", "serving.protocol", "serving.server",
        "models.safetensors", "models.hf_convert", "train.distill", "cli.distill", "comm.native",
        "parallel.dp", "data.streaming", "control", "control.drift", "control.controller", "obs.slo",
        "obs.fleet", "obs.sentinel", "comm.secure", "comm.shamir", "comm.relay", "faults", "faults.proxy",
        "faults.personas", "faults.deadrelay", "faults.scenario", "cli.scenario",
        "router", "router.core", "router.fleet", "shadow", "shadow.compare", "shadow.mirror", "shadow.gate",
        "labels", "labels.store", "labels.join", "cli.router", "cli.shadow", "cli.labels",
        "parallel.mesh", "parallel.multihost", "train.client_mesh", "utils.logging", "cli.__main__",
    ):
        assert f"{PORT_PKG}.{mod}" in imported.split(), mod


def test_no_port_file_imports_jax_or_the_jax_package():
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in BLOCKED, f"{path}: imports {mod}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
        ModelConfig,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.device import (
        resolve_device,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
        init_params,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
        ScoreEngine,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScoreEngine(cfg, params)  # the default device is the card
    assert resolve_device("cpu").type == "cpu"
    assert ScoreEngine(cfg, params, device="cpu").device.type == "cpu"
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )

    args = build_parser().parse_args(
        ["infer-serve", "--registry-dir", str(tmp_path)]
    )
    assert args.device == "cuda"


def test_checker_suffixes_resolve_inside_the_jax_package():
    project = Project(REPO_ROOT)
    assert any(m.rel.startswith(PORT_PKG + "/") for m in project.modules)
    for suffix in (*determinism_rules.SCOPE, *wire_rules.WIRE_LAYER_RELS):
        if suffix.endswith("/"):
            selected = project.select([suffix])
            assert any(m.rel.startswith(f"{JAX_PKG}/{suffix}") for m in selected), suffix
            for m in selected:
                # A directory rule covers the port's copy of the directory
                # too (strategies/), and nothing else of the port.
                assert m.rel.startswith((JAX_PKG + "/", f"{PORT_PKG}/{suffix}")), (suffix, m.rel)
        else:
            m = project.module(suffix)
            assert m is not None and m.rel.startswith(JAX_PKG + "/"), suffix
    # The span vocabulary is read from the JAX package's obs/trace.py,
    # though the port has its own copy of the file.
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.analysis import (
        obs_rules,
    )

    assert os.path.isfile(os.path.join(REPO_ROOT, PORT_PKG, obs_rules.TRACE_REL))
    assert project.module(obs_rules.TRACE_REL).rel == f"{JAX_PKG}/{obs_rules.TRACE_REL}"


#: The port modules that register the JAX package's metric families.
METRIC_TWIN_MODULES = (
    "comm/client.py", "comm/relay.py", "comm/server.py", "control/controller.py", "faults/scenario.py",
    "labels/store.py", "obs/fleet.py", "obs/profile.py", "obs/sentinel.py", "router/core.py",
    "serving/server.py", "shadow/compare.py", "shadow/mirror.py", "train/client_mesh.py",
)


def test_only_pragmas_are_the_wire_magic_copies():
    seen, twins = [], []
    for path in _port_files():
        rel = os.path.relpath(path, REPO_ROOT)
        with open(path) as f:
            for line in f:
                if "fedtpu: allow(obs-metric-once): the JAX package's " in line:
                    twins.append(rel)
                    assert line.lstrip().startswith("# fedtpu: allow(obs-metric-once): "), line
                elif "fedtpu: allow(" in line:
                    seen.append(rel)
                    assert "fedtpu: allow(wire-magic-coverage): " in line, line
                    assert line.split("= b\"")[1][:4].isupper(), line
    assert sorted(set(seen)) == [
        f"{PORT_PKG}/comm/framing.py",
        f"{PORT_PKG}/comm/wire.py",
    ]
    # The metric-family pragmas sit in the twin modules only, each naming
    # the JAX module that registers the same family.
    assert sorted(set(twins)) == [f"{PORT_PKG}/{m}" for m in METRIC_TWIN_MODULES]
    for path in _port_files():
        rel = os.path.relpath(path, REPO_ROOT)
        with open(path) as f:
            text = f.read()
        if rel in twins:
            module = rel.split("/", 1)[1]
            assert text.count(f"the JAX package's {module} family") == text.count("allow(obs-metric-once)"), rel
    # Every magic the port's wire copies carries the reasoned pragma.
    with open(os.path.join(REPO_ROOT, PORT_PKG, "comm", "wire.py")) as f:
        lines = [ln for ln in f if ln.startswith(tuple("ABCDEFGHIJKLMNOPQRSTUVWXYZ")) and '= b"' in ln]
    magics = {ln.split('= b"')[1][:4]: ln for ln in lines if ln.split('= b"')[1][4] == '"'}
    assert set(magics) == PORT_MAGICS
    for magic, ln in magics.items():
        assert "# fedtpu: allow(wire-magic-coverage): the JAX package's" in ln, magic


def test_strategies_and_quant_import_only_numpy_torch_and_the_port():
    root = os.path.join(REPO_ROOT, PORT_PKG)
    paths = [os.path.join(root, "comm", "quant.py")] + [
        os.path.join(root, "strategies", f) for f in sorted(os.listdir(os.path.join(root, "strategies")))
        if f.endswith(".py")
    ]
    assert len(paths) == 3
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in ("__future__", "typing", "numpy", "torch"), (path, mod)
    # The determinism rule covers the port's strategies/ and finds nothing.
    project = Project(REPO_ROOT)
    assert {m.rel for m in project.select(determinism_rules.SCOPE)} >= {
        f"{PORT_PKG}/strategies/core.py", f"{PORT_PKG}/strategies/__init__.py"
    }
    findings = determinism_rules.check_determinism(project)
    assert [f.render() for f in findings if f.path.startswith(PORT_PKG)] == []


def test_round_entry_points_raise_without_cuda(monkeypatch):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
        AggregationServer,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.fold import (
        fold_ordered,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AggregationServer(port=0)  # the default fold device is the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fold_ordered([np.ones(3, np.float32)], [1.0], device="cuda")
    with AggregationServer(port=0, device="cpu") as server:
        assert server.device.type == "cpu"
    parser = build_parser()
    assert parser.parse_args(["serve"]).device == "cuda"
    assert parser.parse_args(["client", "--client-id", "0"]).device == "cuda"
    assert parser.parse_args(["federated"]).device == "cuda"


def test_the_guards_left_are_the_unported_paths():
    """The one ``raise NotImplementedError`` left in the port is the
    abstract strategy's ``apply``: ring attention (the model) and the
    config's sequence-parallel axis (``mesh.seq > 1``) are ported, and the
    controller takes its shadow, label and error-rate gates. The server
    folds secure, relay and re-homed uploads, so it keeps no table of
    unported upload modes, and the CLI reads the identity keys instead of
    refusing them. The config drops no JAX section, ``MeshConfig(seq=2)``
    validates as the JAX package's, and ``--seq-parallel`` parses on
    ``federated`` and ``client`` to the JAX package's values."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        comm as cli_comm,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
        server,
    )

    found = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc.func if isinstance(node.exc, ast.Call) else node.exc
                if getattr(exc, "id", None) == "NotImplementedError":
                    found.append(os.path.relpath(path, REPO_ROOT).split("/", 1)[-1])
    assert sorted(found) == ["strategies/core.py"]
    assert not hasattr(server, "_UNPORTED_UPLOAD_MODES")
    assert not hasattr(cli_comm, "_refuse_identity_keys")
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
        config as pcfg,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )

    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
        config as jcfg,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        build_parser as jax_parser,
    )

    assert not hasattr(pcfg, "_JAX_ONLY_SECTIONS")
    assert dataclasses.asdict(pcfg.MeshConfig(seq=2)) == dataclasses.asdict(jcfg.MeshConfig(seq=2))
    for argv in (["federated"], ["client", "--client-id", "0"]):
        argv = [*argv, "--seq-parallel", "2"]
        assert build_parser().parse_args(argv).seq_parallel == jax_parser().parse_args(argv).seq_parallel == 2


def test_chip_smoke_defines_each_top_level_name_once():
    """A second ``def`` (or constant) of a name silently replaces the
    first for every phase that calls it: each top-level name of
    chip_smoke.py is bound once."""
    with open(os.path.join(REPO_ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    assert len(names) > 100
    assert sorted(n for n in set(names) if names.count(n) > 1) == []
