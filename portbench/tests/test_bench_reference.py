"""The plain reference against the port on the CPU, at the tiny size."""

from __future__ import annotations

import dataclasses
from importlib import import_module

import numpy as np
import pytest
import torch

from conftest import PORT, make_tiny_root
from pbcore import flows
from pbcore.weights import make_weights
from reference import compare
from reference import distilbert as family
from reference import model as ref

config = import_module(PORT + ".config")
engine = import_module(PORT + ".train.engine")


def _tiny(**kw) -> dict:
    mc = config.ModelConfig.tiny(**kw)
    return {f.name: getattr(mc, f.name) for f in dataclasses.fields(mc)}


def _batch(cfg: dict, n: int = 8, seed: int = 3):
    t = {"rows": n, "ddos_fraction": 0.5, "inf_fraction": 0.01, "nan_fraction": 0.01}
    ids, mask, labels = flows.flow_pool(t, cfg, seed)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


OPT = {"learning_rate": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8}


def test_forward_loss_and_adam_step_match_the_port():
    cfg = _tiny(attention_impl="dot", dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
    w = make_weights(family, cfg, 11, "cpu")
    trainer = engine.Trainer(config.ModelConfig(**cfg), config.TrainConfig(learning_rate=OPT["learning_rate"]),
                             device="cpu")
    state = trainer.init_state(params=w)
    b = _batch(cfg)
    ids, mask, labels = (torch.from_numpy(b[k]) for k in ("input_ids", "attention_mask", "labels"))
    with torch.no_grad():
        got = trainer._logits(state.params, ids, mask)
    want = family.forward(w, cfg, ids, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    state, loss = trainer.train_step(state, b)
    r = family.train_steps(w, cfg, [(ids, mask, labels)], 0, OPT)
    assert abs(float(loss) - r.losses[0]) < 1e-6
    for n in compare.moving_leaves(r.grad_norms):  # a key bias moves by round-off alone
        step = torch.linalg.vector_norm((state.params[n].detach() - w[n]).double()).item()
        assert abs(step - r.change_norms[n]) <= 1e-4 * max(r.change_norms[n], 1e-6), n


def test_class_probs_match_the_port_s_scorer():
    serving = import_module(PORT + ".serving")
    cfg = _tiny(attention_impl="flash")
    w = make_weights(family, cfg, 5, "cpu")
    b = _batch(cfg, 16)
    eng = serving.ScoreEngine(config.ModelConfig(**cfg), w, device="cpu")
    _, got, _, _ = eng.score(b["input_ids"], b["attention_mask"])
    want = family.class_probs(w, cfg, torch.from_numpy(b["input_ids"]), torch.from_numpy(b["attention_mask"]), 8)
    assert compare.prob_gap(got, want.numpy()) < 1e-6


def test_attention_keep_matches_the_port_s_mask():
    fa = import_module(PORT + ".ops.flash_attention")
    words = torch.tensor([0xDEADBEEF, 12345], dtype=torch.int64)
    got = ref.attention_keep(words, (2, 3, 16, 16), 0.1)
    for b in range(2):
        for h in range(3):
            want = fa.keep_mask_reference(words, b, h, 0, 0, 16, 16, 0.1).bool()
            assert torch.equal(got[b, h], want)


def test_training_steps_with_dropout_replay_the_program(tmp_path):
    """fp32 on the CPU, flash path with dropout on: the harness's readings
    of the program and of the reference agree to rounding, so the
    reference draws the program's masks."""
    import run as harness

    root = str(tmp_path)
    twins = make_tiny_root(root, compute_dtype="float32")
    cell = twins["distilbert.client-b128"]
    from pbcore.bench import driver, load_cell
    from pbcore.harness import Run
    from pbcore.tracing import Tracer

    assert harness  # the entry module imports cleanly
    c = load_cell(cell, root)
    drv = driver(c)
    run = Run(cell=c, seed=2**31 + 7, seconds=0.1, tracer=Tracer(False), device=torch.device("cpu"), t_start=0.0)
    _, _, _, prog, rows, (ids, _, _) = drv.build(run)
    gaps = compare.train_gaps(prog, drv.reference(run, rows))
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps
    assert drv.distinct_rows(rows, ids) == 0
    # Another dropout seed moves the reference off the program.
    other = Run(cell=c, seed=run.seed + 1, seconds=0.1, tracer=Tracer(False), device=torch.device("cpu"), t_start=0.0)
    far = compare.train_gaps(prog, drv.reference(other, rows))
    assert far["loss_gap"] > 100 * max(gaps["loss_gap"], 1e-7)


def test_weights_are_seeded_and_on_the_device():
    cfg = _tiny()
    a, b = make_weights(family, cfg, 1, "cpu"), make_weights(family, cfg, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = make_weights(family, cfg, 2, "cpu")
    assert not torch.equal(a["classifier.weight"], c["classifier.weight"])
    assert all(v.dtype == torch.float32 for v in a.values())
    assert np.allclose(a["encoder.layer_0.sa_ln.weight"].numpy(), 1.0)


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_control_rounds_to_float8(dtype):
    x = torch.linspace(-3, 3, 1001)
    y = ref._round8(x, dtype)
    mantissa = {torch.float8_e4m3fn: 3, torch.float8_e5m2: 2}[dtype]
    rel = 2.0 ** -(mantissa + 1)  # half an ulp, relative to the value
    assert ((y - x).abs() <= rel * x.abs() * 1.0001 + 1e-6).all() and (y != x).any()


#: sha256 over each leaf's key, shape and fp32 bytes, in the order
#: ``make_weights`` returns them, from seed 12345 on the CPU: the weights
#: the parent commit drew for the two real configurations, before the
#: leaves moved into the family module.
PARENT_WEIGHTS = {
    "distilbert-base": "68e382348e9027ed2b46248bc48259b9e24e6dbeb644f41a80c23845b42873f9",
    "bert-large": "9ed4b1472c6ac3cf430e1fe8898995c8ddb9275d97f4eb93dd2a4da430751211",
}


@pytest.mark.parametrize("name", sorted(PARENT_WEIGHTS))
def test_the_real_configurations_draw_the_parent_s_weights(name):
    import hashlib

    from conftest import BENCH
    from pbcore import bench

    data = bench.read_json(f"{BENCH}/configs/{name}.json")
    cfg = {k: v for k, v in data.items() if k not in bench.CONFIG_DOC_KEYS}
    w = make_weights(bench.load_family(data.get("reference", bench.DEFAULT_FAMILY)), cfg, 12345, "cpu")
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy())
    assert h.hexdigest() == PARENT_WEIGHTS[name]
