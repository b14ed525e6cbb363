"""Boundaries of the PyTorch port.

* The port and chip_smoke.py import with JAX, flax, optax, orbax,
  ml_dtypes, pandas, matplotlib and the JAX package blocked (the card's
  machine has none of them), and no file of theirs imports any of them;
  the port's strategies and int8c codec import only numpy, torch and the
  port itself.
* Entry points run on the card unless the caller asks for the CPU: with
  no CUDA they raise instead of falling back.
* The static checker still resolves its path-suffix rules inside the JAX
  package (the port's name sorts after it); a directory rule also covers
  the port's copy of that directory (``strategies/``), which passes it;
  the port's only checker pragmas are the reasoned ones on its copies of
  the wire magics, and every copied magic carries one.
"""

import ast
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
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "pandas", "matplotlib", JAX_PKG)
#: The frame magics the port's wire copies from the JAX package.
PORT_MAGICS = {"SCRQ", "SCRP", "SCRJ", "FTPW", "NONC", "STRH", "STRC", "STRT"}


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
        "parallel.fedavg", "cli.federated",
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


def test_only_pragmas_are_the_wire_magic_copies():
    seen = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO_ROOT)
        with open(path) as f:
            for line in f:
                if "fedtpu: allow(" in line:
                    seen.append(rel)
                    assert "fedtpu: allow(wire-magic-coverage): " in line, line
                    assert line.split("= b\"")[1][:4].isupper(), line
    assert sorted(set(seen)) == [
        f"{PORT_PKG}/comm/framing.py",
        f"{PORT_PKG}/comm/wire.py",
    ]
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
