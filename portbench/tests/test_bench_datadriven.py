"""A later change adds a configuration, a cell, a per-layer metric or a
model family by adding files and entries alone: no file of the harness
is edited."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import run as harness
from conftest import PORT, make_tiny_root
from pbcore import flows, roofline
from pbcore.bench import driver, load_cell, reader
from pbcore.harness import Run
from pbcore.tracing import Tracer, timeline_from_spans
from pbcore.weights import make_weights


def _digests(bench: str) -> dict[str, str]:
    out = {}
    for dirpath, _, files in os.walk(bench):
        for f in files:
            if "__pycache__" not in dirpath:
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, bench)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_throwaway_cell_needs_only_new_files(tmp_path):
    root = str(tmp_path)
    make_tiny_root(root)
    bench = os.path.join(root, "portbench")
    before = _digests(bench)

    # A new configuration, traffic mix, cell and metric: files of their own.
    cfg = json.load(open(os.path.join(bench, "configs", "tiny.json")))
    cfg.update(n_layers=3, dim=48, n_heads=3, hidden_dim=96)
    json.dump(cfg, open(os.path.join(bench, "configs", "tiny-wide.json"), "w"))
    traffic = json.load(open(os.path.join(bench, "traffic", "tiny-score-b128.json")))
    traffic.update(bucket=8, rows=100)
    json.dump(traffic, open(os.path.join(bench, "traffic", "score-b8.json"), "w"))
    json.dump({"limits": {"prob_gap": 0.05}}, open(os.path.join(bench, "workloads", "wide.score-b8.json"), "w"))
    with open(os.path.join(bench, "metrics", "calls.score.py"), "w") as f:
        f.write("def read(tl):\n    return None if tl is None else float(tl.extra['traced_steps'])\n")

    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "tiny-wide", "source": "test", "file": "portbench/configs/tiny-wide.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "wide.score-b8", "config": "tiny-wide", "traffic": "score-b8", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m.get("workloads") and "distilbert.score-b128" in m["workloads"]:
            m["workloads"].append("wide.score-b8")
    spec["per_layer"].append({"name": "calls.score", "unit": "calls", "better": "higher", "source": "host_clock",
                              "layer": "scoring engine", "moves": "score_flows_per_s", "workloads": ["wide.score-b8"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell, outcome = harness.run_cell("wide.score-b8", 5, 0.8, True, torch.device("cpu"), time.perf_counter(), root)
    line = harness.result_line(cell, outcome, True, {})
    assert outcome.correct and line["metrics"]["calls.score"]["value"] >= 1
    assert list(line)[-1] == "checks"
    cell, outcome = harness.run_cell("wide.score-b8", 5, 0.3, False, torch.device("cpu"), time.perf_counter(), root)
    line = harness.result_line(cell, outcome, False, {})
    assert set(line["metrics"]) == {"score_flows_per_s", "score_batch_p95_ms", "setup_s"}

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


#: A throwaway second family: a decoder whose configuration gives its
#: key/value heads and whether it is causal, leaves of its own names,
#: RMSNorm, SiLU and a head on the last real token.
DECODER = """
import math

import torch
import torch.nn.functional as F

from reference.model import Precision, adam_steps, softmax_rows


def leaf_shapes(cfg):
    D, H, Fw = cfg["dim"], cfg["n_heads"], cfg["hidden_dim"]
    kv = cfg["n_kv_heads"] * (D // H)
    shapes = {"tok.table": (cfg["vocab_size"], D)}
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."
        shapes.update({p + "norm.scale": (D,), p + "wq": (D, D), p + "wk": (kv, D), p + "wv": (kv, D),
                       p + "wo": (D, D), p + "up": (Fw, D), p + "down": (D, Fw)})
    shapes.update({"final.scale": (D,), "head.w": (cfg["n_classes"], D), "head.b": (cfg["n_classes"],)})
    return shapes


def leaf_kind(name):
    return "one" if name.endswith(".scale") else "zero" if name == "head.b" else "normal"


def _rms(x, g):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * g


def forward(w, cfg, ids, mask, drop=None, prec=Precision()):
    B, L = ids.shape
    D, H, G = cfg["dim"], cfg["n_heads"], cfg["n_kv_heads"]
    d = D // H
    keep = mask.bool()[:, None, None, :]
    if cfg["causal"]:
        keep = keep & torch.tril(torch.ones(L, L, dtype=torch.bool, device=ids.device))[None, None]
    x = w["tok.table"][ids.long()]
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."
        h = _rms(x, w[p + "norm.scale"])
        q = (h @ w[p + "wq"].T).reshape(B, L, H, d).transpose(1, 2)
        k, v = ((h @ w[p + n].T).reshape(B, L, G, d).transpose(1, 2).repeat_interleave(H // G, 1) for n in ("wk", "wv"))
        s = (q @ k.transpose(-1, -2) / math.sqrt(d)).masked_fill(~keep, -1e9)
        x = x + (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, L, D) @ w[p + "wo"].T
        x = x + F.silu(_rms(x, w[p + "norm.scale"]) @ w[p + "up"].T) @ w[p + "down"].T
    last = _rms(x[torch.arange(B), mask.long().sum(1) - 1], w["final.scale"])
    return last @ w["head.w"].T + w["head.b"]


def class_probs(w, cfg, ids, mask, block, prec=Precision()):
    return softmax_rows(lambda i, m, pr: forward(w, cfg, i, m, prec=pr), ids, mask, block, prec)


def train_steps(w0, cfg, batches, drop_seed, opt, prec=Precision(), half_batch=False):
    return adam_steps(lambda p, i, m, dr, pr: forward(p, cfg, i, m, dr, pr), w0, batches, drop_seed, opt, prec,
                      half_batch)


def forward_flops(cfg, batch, seq_len):
    L, D, Fw, H = seq_len, cfg["dim"], cfg["hidden_dim"], cfg["n_heads"]
    kv = cfg["n_kv_heads"] * (D // H)
    scores = L * (L + 1) // 2 if cfg["causal"] else L * L
    per_layer = 4 * L * D * D + 4 * L * D * kv + 2 * 2 * H * scores * (D // H) + 4 * L * D * Fw
    return float(batch) * (cfg["n_layers"] * per_layer + 2 * D * cfg["n_classes"])


def n_trainable(cfg):
    return sum(math.prod(s) for s in leaf_shapes(cfg).values())


def attention_launch(cfg, batch, seq_len):
    return batch, cfg["n_heads"], cfg["n_kv_heads"], seq_len, cfg["dim"] // cfg["n_heads"], cfg["causal"]
"""


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """The throwaway family's config class in the port, beside ModelConfig."""

    vocab_size: int
    max_len: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    hidden_dim: int
    n_classes: int
    initializer_range: float
    causal: bool


#: The decoder's configuration: fields of its own class, not ModelConfig's.
DECODER_CONFIG = dict(source="test", reference="decoder_gqa", port_config="DecoderConfig", vocab_size=256,
                      max_len=32, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=64, n_classes=2,
                      initializer_range=0.02, causal=True)


def _add_cells(root: str, config: str, data: dict, cells: dict[str, str]) -> None:
    """A configuration file ``config`` holding ``data``, and each cell of
    ``cells`` as a copy of the twin it names on that configuration."""
    bench = os.path.join(root, "portbench")
    json.dump(data, open(os.path.join(bench, "configs", f"{config}.json"), "w"))
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": config, "source": "test", "file": f"portbench/configs/{config}.json",
                            "reduced": [], "why": "test"})
    for cell, twin in cells.items():
        w = next(x for x in spec["workloads"] if x["name"] == twin)
        spec["workloads"].append(dict(w, name=cell, config=config))
        json.dump(json.load(open(os.path.join(bench, "workloads", f"{twin}.json"))),
                  open(os.path.join(bench, "workloads", f"{cell}.json"), "w"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if twin in m.get("workloads", []):
                m["workloads"].append(cell)
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))


def test_a_second_family_needs_only_new_files(tmp_path, monkeypatch):
    root = str(tmp_path)
    twins = make_tiny_root(root, compute_dtype="float32")
    bench = os.path.join(root, "portbench")
    before = _digests(bench)

    # The family, a configuration naming it and its config class, two
    # cells and list entries.
    with open(os.path.join(bench, "reference", "decoder_gqa.py"), "w") as f:
        f.write(DECODER)
    score_twin, train_twin = twins["distilbert.score-b128"], twins["distilbert.client-b128"]
    _add_cells(root, "tiny-decoder", DECODER_CONFIG, {"dec.score-b16": score_twin, "dec.client-b16": train_twin})
    config = import_module(PORT + ".config")
    monkeypatch.setattr(config, "DecoderConfig", DecoderConfig, raising=False)

    cell = load_cell("dec.score-b16", root)
    fam = cell.family
    assert cell.family_name == "decoder_gqa" and cell.port_config_name == "DecoderConfig"
    assert not {"reference", "port_config"} & set(cell.model_fields())
    assert {"n_kv_heads", "causal"} <= set(cell.model_fields()) - {f.name for f in dataclasses.fields(config.ModelConfig)}
    w = make_weights(fam, cell.model_fields(), 3, "cpu")
    assert list(w) == list(fam.leaf_shapes(cell.model_fields())) and "blocks.0.wk" in w
    assert w["blocks.0.wk"].shape == (16, 32) and torch.equal(w["final.scale"], torch.ones(32))

    # The port runs one block today: its own reference, in fp32, stands in
    # for the program, so a sound run of the new family's cell is correct.
    # It reads the model from the config object the driver hands it.
    serving = import_module(PORT + ".serving")

    class StandIn:
        def __init__(self, mc, w0, pad_id=0, device=None):
            assert isinstance(mc, DecoderConfig)
            self.cfg, self.w, self.ledger = dataclasses.asdict(mc), w0, SimpleNamespace(compile_counts=lambda site: {})

        def score(self, ids, mask):
            p = fam.class_probs(self.w, self.cfg, torch.from_numpy(ids), torch.from_numpy(mask), len(ids))
            return p[:, 1].numpy(), p.numpy(), len(ids), 0

    monkeypatch.setattr(serving, "ScoreEngine", StandIn)
    c, outcome = harness.run_cell("dec.score-b16", 7, 0.6, True, torch.device("cpu"), time.perf_counter(), root)
    assert outcome.correct and outcome.attempted >= 1, [(k.name, k.value, k.limit) for k in outcome.checks]
    assert outcome.timeline.extra["reference"] == "decoder_gqa"
    line = harness.result_line(c, outcome, False, {})
    assert set(line["metrics"]) == {"score_flows_per_s", "score_batch_p95_ms", "setup_s"}

    # The readers count the family's work: a causal launch over 2 KV heads.
    tl = timeline_from_spans(
        [("void flash_fwd_tc_kernel<false>(...)", 10.0, 60.0, False)], [("portbench.window", 0.0, 100.0)],
        dict(outcome.timeline.extra, plain_steps=10, plain_s=0.5, traced_steps=1,
             device_name="NVIDIA H100 80GB HBM3"))
    b, l = 16, DECODER_CONFIG["max_len"]
    assert reader("k1_roofline.score", bench).read(tl) == pytest.approx(
        100 * roofline.attention_bound(b, 4, l, 8, kv_heads=2, causal=True) / 50e-6)
    assert reader("mfu.score", bench).read(tl) == pytest.approx(
        100 * fam.forward_flops(cell.model_fields(), b, l) * 10 / (0.5 * 989e12))

    # Training: the driver's build hands the trainer the named class, and
    # its reference steps through the family.
    tc = load_cell("dec.client-b16", root)
    run = Run(cell=tc, seed=11, seconds=0.1, tracer=Tracer(False), device=torch.device("cpu"), t_start=0.0)
    engine = import_module(PORT + ".train.engine")
    handed = []

    class Reached(Exception):
        pass

    class TrainerStandIn:
        def __init__(self, mc, tc_, **kw):
            assert isinstance(mc, DecoderConfig)
            handed.append(mc)
            raise Reached

    monkeypatch.setattr(engine, "Trainer", TrainerStandIn)
    with pytest.raises(Reached):
        driver(tc).build(run)
    assert handed == [DecoderConfig(**tc.model_fields())]
    ids, mask, labels = flows.flow_pool(tc.traffic, tc.model_fields(), run.sub("flows"))
    rows = [{"input_ids": ids[i:i + 16], "attention_mask": mask[i:i + 16], "labels": labels[i:i + 16]}
            for i in range(0, 48, 16)]
    ref = driver(tc).reference(run, rows)
    assert set(ref.change_norms) == set(w) and len(ref.losses) == 3 and np.isfinite(ref.losses).all()
    assert ref.change_norms["blocks.1.wk"] > 0

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("mode", ["score", "train"])
@pytest.mark.parametrize("fault", ["a key the class lacks", "a class the module lacks"])
def test_a_configuration_its_class_cannot_take_fails_before_the_weights(tmp_path, monkeypatch, mode, fault):
    from pbcore import weights

    root = str(tmp_path)
    twins = make_tiny_root(root, compute_dtype="float32")
    data = json.load(open(os.path.join(root, "portbench", "configs", "tiny.json")))
    if fault == "a key the class lacks":
        data["n_kv_heads"], named = 1, "n_kv_heads"
    else:
        data["port_config"], named = "NoSuchConfig", "NoSuchConfig"
    twin = twins["distilbert.score-b128" if mode == "score" else "distilbert.client-b128"]
    _add_cells(root, "tiny-odd", data, {"odd.cell": twin})

    def drawn(*args, **kwargs):
        raise AssertionError("the pool or the weights were drawn before the config was built")

    monkeypatch.setattr(weights, "make_weights", drawn)
    monkeypatch.setattr(flows, "flow_pool", drawn)
    cell = load_cell("odd.cell", root)
    run = Run(cell=cell, seed=5, seconds=0.1, tracer=Tracer(False), device=torch.device("cpu"), t_start=0.0)
    with pytest.raises(ValueError, match=named) as err:
        driver(cell).build(run)
    assert "portbench/configs/tiny-odd.json" in str(err.value)
