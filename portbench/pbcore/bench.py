"""What a run reads from the benchmark's files, found by name.

``BENCHMARK.json`` names each cell's configuration, traffic mix and
metrics; the files under ``portbench/`` hold them, one file each:

* ``configs/<config>.json`` (the path is the configuration's ``file``):
  the model as run, in the field names of the class in the port's
  ``config`` module that its ``"port_config"`` key names (``ModelConfig``
  without the key), beside its published source; its ``"reference"`` key
  names its family;
* ``reference/<family>.py``: a model family's plain reference, its
  leaves and its work counts (``FAMILY_INTERFACE``); ``distilbert`` for
  a configuration without the key;
* ``traffic/<traffic>.json``: the mix's parameters, and the ``mode``
  that names the driver under ``drivers/`` which runs it;
* ``workloads/<cell>.json``: the cell's limits on the numbers compared
  with the reference;
* ``metrics/<name>.py``: one reader per per-layer metric.

A later change adds a cell, a configuration, a model family or a metric
by adding files and entries; no file here needs an edit for it.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

#: Top-level module names a run may not load: JAX, its libraries, and the
#: JAX package the port was made from. Compared whole, since the port's
#: own name begins with the JAX package's.
JAX_PACKAGE = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", JAX_PACKAGE)

#: Keys of a configuration file that document it and are not model fields.
CONFIG_DOC_KEYS = ("source", "published", "assumed", "type_vocab_size", "reference", "port_config")

#: The family of a configuration that names none.
DEFAULT_FAMILY = "distilbert"

#: The port's config class of a configuration that names none.
DEFAULT_PORT_CONFIG = "ModelConfig"

#: What a family module under ``reference/`` provides:
#:
#: * ``leaf_shapes(cfg)``: ``{state-dict key: shape}`` of every leaf;
#: * ``leaf_kind(key)``: ``"normal"``, ``"zero"`` or ``"one"``;
#: * ``train_steps(w0, cfg, batches, drop_seed, opt, prec, half_batch)``:
#:   the reference's ``TrainReadings`` (``reference/model.py``);
#: * ``class_probs(w, cfg, ids, mask, block, prec)``: per-class
#:   probabilities of every row;
#: * ``forward_flops(cfg, batch, seq_len)``: matmul FLOPs of a forward;
#: * ``n_trainable(cfg)``: the elements the optimizer updates;
#: * ``attention_launch(cfg, batch, seq_len)``: K1-K3's launch shape
#:   ``(b, h, h_kv, l, d, causal)``, or None where none runs.
FAMILY_INTERFACE = ("leaf_shapes", "leaf_kind", "train_steps", "class_probs", "forward_flops", "n_trainable",
                    "attention_launch")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in ``modules`` (``sys.modules`` by default) that a
    run may not load."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN_MODULES))


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def load_module(path: str, name: str) -> ModuleType:
    """A Python file loaded by its path (the harness has no package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def load_family(name: str, bench: str = BENCH_DIR) -> ModuleType:
    """The family module ``<bench>/reference/<name>.py``, checked for the
    interface."""
    path = os.path.join(bench, "reference", f"{name}.py")
    if not os.path.isfile(path):
        raise ImportError(f"no family module {path}")
    module = load_module(path, "portbench_family_" + name.replace(".", "_").replace("-", "_"))
    missing = [f for f in FAMILY_INTERFACE if not callable(getattr(module, f, None))]
    if missing:
        raise ImportError(f"family {name!r} lacks {', '.join(missing)}")
    return module


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: list[str] | None
    layer: str | None = None
    moves: str | None = None
    bound: float | None = None


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    bench: str  # the portbench/ directory the cell's files are in
    chips: int
    config_name: str
    config_file: str  # as BENCHMARK.json names it
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list[Metric] = field(default_factory=list)
    per_layer: list[Metric] = field(default_factory=list)

    def model_fields(self) -> dict:
        """The configuration's fields as run (no documentation keys)."""
        return {k: v for k, v in self.config.items() if k not in CONFIG_DOC_KEYS}

    @property
    def port_config_name(self) -> str:
        return self.config.get("port_config", DEFAULT_PORT_CONFIG)

    def port_config(self, config_module: ModuleType):
        """The port's config object of this configuration: the class
        ``port_config_name`` of ``config_module`` over ``model_fields()``."""
        name = self.port_config_name
        cls = getattr(config_module, name, None)
        if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
            raise ValueError(f"{self.config_file}: the port's config module has no dataclass {name!r}")
        fields = self.model_fields()
        unknown = sorted(set(fields) - {f.name for f in dataclasses.fields(cls)})
        if unknown:
            raise ValueError(f"{self.config_file}: keys {unknown} are not fields of the port's {name}")
        return cls(**fields)

    @property
    def family_name(self) -> str:
        return self.config.get("reference", DEFAULT_FAMILY)

    @property
    def family(self) -> ModuleType:
        """The configuration's family module (``reference/<name>.py``)."""
        return load_family(self.family_name, self.bench)


def _metrics(entries: list[dict], cell: str) -> list[Metric]:
    fields = {f.name for f in dataclasses.fields(Metric)}
    out = []
    for e in entries:
        wl = e.get("workloads")
        if wl is None or cell in wl:
            out.append(Metric(**{k: e.get(k) for k in fields}))
    return out


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` and its files."""
    spec = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = os.path.join(root, "portbench")
    return Cell(
        name=name,
        bench=bench,
        chips=int(w["chips"]),
        config_name=w["config"],
        config_file=configs[w["config"]]["file"],
        config=read_json(os.path.join(root, configs[w["config"]]["file"])),
        traffic_name=w["traffic"],
        traffic=read_json(os.path.join(bench, "traffic", f"{w['traffic']}.json")),
        limits=read_json(os.path.join(bench, "workloads", f"{name}.json"))["limits"],
        end_to_end=_metrics(spec["end_to_end"], name),
        per_layer=_metrics(spec["per_layer"], name),
    )


def driver(cell: Cell) -> ModuleType:
    """The driver that runs the cell's traffic: ``drivers/<mode>.py``."""
    mode = cell.traffic["mode"]
    return load_module(os.path.join(cell.bench, "drivers", f"{mode}.py"), f"portbench_driver_{mode}")


def reader(name: str, bench: str = BENCH_DIR) -> ModuleType:
    """The reader of one per-layer metric: ``metrics/<name>.py``."""
    return load_module(os.path.join(bench, "metrics", f"{name}.py"), "portbench_metric_" + name.replace(".", "_"))
