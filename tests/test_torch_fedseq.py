"""The port's sequence-parallel federated trainer (parallel/fedseq.py,
train/seqfed.py) held against the JAX package's, on CPU slots.

The cases of ``tests/test_fedseq.py`` re-bound to the port, the JAX side
on the eight virtual CPU devices as that file runs it:

* the stacked dense loss on a 2 x 2 x 2 mesh against the JAX fedseq loss
  and the unsplit per-client dot loss (atol 2e-5), its gradients against
  the unsplit ones (atol 5e-4), and one lockstep step against per-client
  Adam on the unsplit program, then FedAvg (atol 1e-5);
* dropout off, the same weights and batches: ``FedSeqTrainer`` at data 2
  x seq 2 against the JAX ``FedSeqTrainer`` through a dense fit, a ragged
  fit (gated idle client, each client's own warmup step), the stacked
  evaluation with probs and a weighted aggregate (losses atol 2e-4,
  params atol 1e-5, metrics atol 1e-4, Loss 1e-3: the JAX tests' bounds);
* dropout on: the port's own loss trajectory at seq 2 and 4 and at data 2
  x seq 2 within 2e-4 of seq 1, and not the dropout-off one; remat on
  bit-equal to remat off;
* FedProx on the 3-axis path against the dense trainer (losses 2e-4,
  drift rtol 0.02, a strong mu bounding the drift), head-scope
  personalization freezing the encoder bit for bit, the fedseq eval
  counts against the two-axis trainer's;
* the refusals (``max_len % seq``, ``batch % data``, ``fsdp + seq``)
  word for word the JAX package's;
* the ``federated --seq-parallel 2`` CLI against the JAX CLI (dropout
  off, the same init): the metrics CSVs within the metric bounds; its
  checkpoint resumed bit-equal; a DP-FedAvg round at noise 0.

The JAX package's packed fedseq step (its single-device speed path) has
no port counterpart, so ``test_packed_fedseq_matches_stacked`` has none.
"""

import csv
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"

jcfg = importlib.import_module(JAX_PKG + ".config")
jmodel = importlib.import_module(JAX_PKG + ".models.distilbert")
jfedseq = importlib.import_module(JAX_PKG + ".parallel.fedseq")
jfedavg = importlib.import_module(JAX_PKG + ".parallel.fedavg")
jseqfed = importlib.import_module(JAX_PKG + ".train.seqfed")
jpipe = importlib.import_module(JAX_PKG + ".data.pipeline")
pcfg = importlib.import_module(PORT_PKG + ".config")
pfedseq = importlib.import_module(PORT_PKG + ".parallel.fedseq")
pseqfed = importlib.import_module(PORT_PKG + ".train.seqfed")
pfederated = importlib.import_module(PORT_PKG + ".train.federated")
ppipe = importlib.import_module(PORT_PKG + ".data.pipeline")
pconvert = importlib.import_module(PORT_PKG + ".models.convert")

torch.set_num_threads(1)

C, B, L = 2, 4, 64
ML = 16
NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
DROP = dict(dropout=0.1, attention_dropout=0.1, head_dropout=0.3)
METRICS = ("Accuracy", "Precision", "Recall", "F1-Score")


def _exp_cfg(mod, seq, *, dropout=True, clients=2, data=1, **fed_kw):
    return mod.ExperimentConfig(
        model=mod.ModelConfig.tiny(max_len=ML, max_position_embeddings=ML, **(DROP if dropout else NO_DROP)),
        data=mod.DataConfig(max_len=ML, batch_size=8, eval_batch_size=8),
        train=mod.TrainConfig(learning_rate=1e-3, epochs_per_round=1, seed=0),
        fed=mod.FedConfig(num_clients=clients, rounds=1, **fed_kw),
        mesh=mod.MeshConfig(clients=clients, data=data, seq=seq),
    )


def _dense_arrays(n=32, clients=2, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(1, 200, (clients, n, ML)).astype(np.int32),
        np.ones((clients, n, ML), np.int32),
        rng.integers(0, 2, (clients, n)).astype(np.int32),
    )


def _flat(params) -> dict:
    return pconvert.flatten_tree(pconvert.params_to_jax(params, stacked=True))


def _flat_jax(params) -> dict:
    return pconvert.flatten_tree(jax.tree.map(np.asarray, params))


def _assert_params(got: dict, want: dict, atol: float, msg=""):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=f"{msg} {k}")


# ------------------------------------------------- the stacked program
def _stack_setup():
    # Dropout off: the JAX stacked loss and step run deterministic.
    base = jcfg.ModelConfig.tiny(max_len=L, max_position_embeddings=L, **NO_DROP)
    tree = jmodel.init_params(jmodel.DDoSClassifier(base), base, jax.random.key(0))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, base.vocab_size, (C, B, L)).astype(np.int32)
    mask = (rng.random((C, B, L)) > 0.3).astype(np.int32)
    mask[:, :, 0] = 1
    labels = rng.integers(0, 2, (C, B)).astype(np.int32)
    cfg = pcfg.ExperimentConfig(
        model=pcfg.ModelConfig(**dataclasses.asdict(base)),
        data=pcfg.DataConfig(max_len=L, batch_size=B),
        train=pcfg.TrainConfig(learning_rate=1e-3),
        fed=pcfg.FedConfig(num_clients=C),
        mesh=pcfg.MeshConfig(clients=C, data=2, seq=2),
    )
    trainer = pseqfed.FedSeqTrainer(cfg, device="cpu")
    state = trainer.init_state(params=pconvert.params_from_jax(jax.tree.map(np.asarray, tree)))
    return base, tree, ids, mask, labels, trainer, state


@pytest.fixture(scope="module")
def stack_setup():
    return _stack_setup()


def _stacked_losses(trainer, stacked, ids, mask, labels) -> torch.Tensor:
    """``[C]`` dense fedseq losses of the stack, each client over its own
    slots (the trainer's client hooks, as its lockstep step runs them)."""
    ids, mask, labels = (torch.from_numpy(a).long() for a in (ids, mask, labels))
    return torch.stack([
        pfedseq.dense_loss(trainer._client_logits({n: t[c] for n, t in stacked.items()}, c, ids[c], mask[c]),
                           labels[c], trainer.mesh.shape["data"])
        for c in range(int(labels.shape[0]))
    ])


def _solo_loss(base, p, ids, mask, labels):
    lg = jmodel.DDoSClassifier(base).apply({"params": p}, ids, mask, True)
    return optax.softmax_cross_entropy_with_integer_labels(lg, labels).mean()


def test_fedseq_loss_matches_jax_and_unsharded(stack_setup, eight_devices):
    base, tree, ids, mask, labels, trainer, state = stack_setup
    assert trainer.mesh.devices.shape == (2, 2, 2)
    mesh3 = JaxMesh(np.array(eight_devices[:8]).reshape(2, 2, 2), ("clients", "data", "seq"))
    ring = base.replace(attention_impl="ring", ring_axis="seq")
    jl = np.asarray(jax.jit(jfedseq.make_fedseq_loss(jmodel.DDoSClassifier(ring), mesh3))(
        jfedavg.stack_params(tree, C), jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels)))
    solo = np.array([float(jax.jit(lambda i, m, y: _solo_loss(base, tree, i, m, y))(ids[c], mask[c], labels[c]))
                     for c in range(C)])
    with torch.no_grad():
        got = _stacked_losses(trainer, state.params, ids, mask, labels).numpy()
    np.testing.assert_allclose(got, jl, atol=2e-5)
    np.testing.assert_allclose(got, solo, atol=2e-5)


def test_fedseq_grads_match_unsharded(stack_setup):
    base, tree, ids, mask, labels, trainer, state = stack_setup
    loss = _stacked_losses(trainer, state.params, ids, mask, labels)
    names = [n for n, t in state.params.items() if t.requires_grad]
    grads = dict(zip(names, torch.autograd.grad(loss.sum(), [state.params[n] for n in names])))
    got = _flat(grads)
    solo_grad = jax.jit(jax.grad(lambda p, i, m, y: _solo_loss(base, p, i, m, y)))
    for c in range(C):
        want = _flat_jax(solo_grad(tree, ids[c], mask[c], labels[c]))
        _assert_params({k: v[c] for k, v in got.items()}, want, 5e-4, f"client {c}")


def test_fedseq_train_step_and_fedavg(eight_devices):
    base, tree, ids, mask, labels, trainer, state = _stack_setup()
    losses, has = trainer.train_step(state, {"input_ids": ids, "attention_mask": mask, "labels": labels})
    assert tuple(losses.shape) == (C,) and has.tolist() == [1.0, 1.0] and state.step == 1
    opt = optax.adam(1e-3)

    @jax.jit
    def manual_step(i, m, y):
        g = jax.grad(lambda p: _solo_loss(base, p, i, m, y))(tree)
        u, _ = opt.update(g, opt.init(tree), tree)
        return optax.apply_updates(tree, u)

    manual = [_flat_jax(manual_step(ids[c], mask[c], labels[c])) for c in range(C)]
    got = _flat(state.params)
    for c in range(C):
        _assert_params({k: v[c] for k, v in got.items()}, manual[c], 1e-5, f"client {c}")
    state = trainer.aggregate(state)
    agg = _flat(state.params)
    for k, v in agg.items():
        np.testing.assert_allclose(v[0], v[1], atol=1e-6, err_msg=k)
        np.testing.assert_allclose(v[0], 0.5 * (manual[0][k] + manual[1][k]), atol=1e-5, err_msg=k)


# ------------------------------------------- the trainer against JAX's
def _both_trainers(seq, data, **kw):
    jt = jseqfed.FedSeqTrainer(_exp_cfg(jcfg, seq, dropout=False, data=data, **kw))
    jstate = jt.init_state()
    single = jax.tree.map(lambda x: np.asarray(x)[0], jstate.params)
    pt = pseqfed.FedSeqTrainer(_exp_cfg(pcfg, seq, dropout=False, data=data, **kw), device="cpu")
    return pt, pt.init_state(params=pconvert.params_from_jax(single)), jt, jstate


def test_fedseq_trainer_dense_ragged_eval_match_jax(eight_devices):
    pt, ps, jt, js = _both_trainers(2, 2)
    dense = _dense_arrays()
    js, jl = jt.fit_local(js, jpipe.TokenizedSplit(*dense))
    ps, pl = pt.fit_local(ps, ppipe.TokenizedSplit(*dense))
    np.testing.assert_allclose(pl, np.asarray(jl), atol=2e-4)
    _assert_params(_flat(ps.params), _flat_jax(js.params), 1e-5, "dense")

    rng = np.random.default_rng(3)

    def split(n):
        return (rng.integers(1, 200, (n, ML)).astype(np.int32), np.ones((n, ML), np.int32),
                rng.integers(0, 2, n).astype(np.int32))

    train = [split(20), split(9)]
    js, jrl = jt.fit_local(js, jpipe.stack_clients_ragged([jpipe.TokenizedSplit(*a) for a in train]))
    ps, prl = pt.fit_local(ps, ppipe.stack_clients_ragged([ppipe.TokenizedSplit(*a) for a in train]))
    np.testing.assert_allclose(prl, np.asarray(jrl), atol=2e-4)
    _assert_params(_flat(ps.params), _flat_jax(js.params), 1e-5, "ragged")
    assert ps.opt_state.count == [4 + 3, 4 + 2]  # each client's own steps: 4 dense, then ceil(n / 8)

    evals = [split(16), split(13)]
    jm = jt.evaluate_clients(js.params, prepared=jt.prepare_eval([jpipe.TokenizedSplit(*a) for a in evals]),
                             collect_probs=True)
    pm = pt.evaluate_clients(ps.params, prepared=pt.prepare_eval([ppipe.TokenizedSplit(*a) for a in evals]),
                             collect_probs=True)
    for c, (a, b) in enumerate(zip(pm, jm)):
        for k in METRICS:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=f"client {c} {k}")
        np.testing.assert_allclose(a["Loss"], b["Loss"], atol=1e-3)
        assert a["probs"].shape == (len(evals[c][2]),)
        np.testing.assert_allclose(a["probs"], np.asarray(b["probs"]), atol=1e-5)

    weights = np.array([20.0, 9.0])
    js = jt.aggregate(js, weights=weights)
    ps = pt.aggregate(ps, weights=weights)
    got = _flat(ps.params)
    _assert_params(got, _flat_jax(js.params), 1e-5, "aggregate")
    assert all(np.array_equal(v[0], v[1]) for v in got.values())


# ------------------------------------------------- dropout on, the port
def _port_losses(seq, *, data=1, dropout=True, epochs=2, remat=False):
    cfg = _exp_cfg(pcfg, seq, dropout=dropout, data=data)
    if remat:
        cfg = dataclasses.replace(cfg, model=cfg.model.replace(remat=True))
    tr = pseqfed.FedSeqTrainer(cfg, device="cpu")
    state, losses = tr.fit_local(tr.init_state(), ppipe.TokenizedSplit(*_dense_arrays()), epochs=epochs)
    return losses, state


def test_fedseq_dropout_invariant_to_seq_shard_count():
    l1, _ = _port_losses(1)
    for seq, data in ((2, 1), (4, 1), (2, 2)):
        np.testing.assert_allclose(_port_losses(seq, data=data)[0], l1, atol=2e-4, err_msg=f"{data}x{seq}")
    l_det, _ = _port_losses(2, dropout=False)
    assert not np.allclose(l_det, l1, atol=1e-5)


def test_fedseq_remat_is_bit_equal():
    (la, sa), (lb, sb) = _port_losses(2, epochs=1), _port_losses(2, epochs=1, remat=True)
    np.testing.assert_array_equal(la, lb)
    assert all(torch.equal(sa.params[n], sb.params[n]) for n in sa.params)


def test_fedseq_fedprox_matches_dense_trainer_and_bounds_drift():
    dense = ppipe.TokenizedSplit(*_dense_arrays())

    def run(cls, seq, mu):
        cfg = _exp_cfg(pcfg, seq, dropout=False, prox_mu=mu)
        tr = cls(cfg, device="cpu")
        state = tr.init_state(seed=0)
        start = {n: t.detach().clone() for n, t in state.params.items()}
        state, losses = tr.fit_local(state, dense, epochs=2)
        return losses, sum(float(((state.params[n].detach() - start[n]) ** 2).sum()) for n in start)

    l3, drift3 = run(pseqfed.FedSeqTrainer, 2, 5.0)
    l2, drift2 = run(pfederated.FederatedTrainer, 1, 5.0)
    np.testing.assert_allclose(l3, l2, atol=2e-4)
    np.testing.assert_allclose(drift3, drift2, rtol=0.02)
    _, free = run(pseqfed.FedSeqTrainer, 2, 0.0)
    assert drift3 < free * 0.8, (drift3, free)


def test_fedseq_personalize_head_freezes_encoder():
    cfg = _exp_cfg(pcfg, 2, dropout=False, personalize_epochs=1, personalize_scope="head")
    tr = pseqfed.FedSeqTrainer(cfg, device="cpu")
    dense = ppipe.TokenizedSplit(*_dense_arrays())
    state, _ = tr.fit_local(tr.init_state(seed=0), dense, epochs=1)
    state = tr.aggregate(state)
    pstate, plosses = tr.personalize(state, dense)
    assert np.isfinite(plosses).all()
    for n, t in state.params.items():
        if n.startswith("encoder."):
            assert torch.equal(t, pstate.params[n]), n
    assert any(not torch.allclose(state.params[n], pstate.params[n]) for n in state.params if n.startswith("classifier."))


def test_fedseq_eval_counts_match_two_axis_trainer():
    cfg3 = _exp_cfg(pcfg, 2, dropout=False, data=2)
    tr3 = pseqfed.FedSeqTrainer(cfg3, device="cpu")
    state = tr3.init_state()
    rng = np.random.default_rng(7)
    evals = [ppipe.TokenizedSplit(rng.integers(1, 200, (13, ML)).astype(np.int32), np.ones((13, ML), np.int32),
                                  rng.integers(0, 2, 13).astype(np.int32)) for _ in range(2)]
    m3 = tr3.evaluate_clients(state.params, splits=evals)
    tr2 = pfederated.FederatedTrainer(dataclasses.replace(cfg3, mesh=dataclasses.replace(cfg3.mesh, seq=1)), device="cpu")
    m2 = tr2.evaluate_clients(tr2.init_state().params, splits=evals)
    for a, b in zip(m3, m2):
        for k in METRICS:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=k)
        np.testing.assert_allclose(a["Loss"], b["Loss"], atol=1e-3)


def test_fedseq_refusals_match_jax(eight_devices):
    msgs = []
    for mod, make in ((jcfg, lambda c: jseqfed.FedSeqTrainer(c)), (pcfg, lambda c: pseqfed.FedSeqTrainer(c, device="cpu"))):
        got = []
        cfg = _exp_cfg(mod, 3)  # 16 % 3
        with pytest.raises(ValueError) as e:
            make(cfg)
        got.append(str(e.value))
        tr = make(_exp_cfg(mod, 2, data=2))
        arrays = _dense_arrays()
        split = (jpipe if mod is jcfg else ppipe).TokenizedSplit(*arrays)
        with pytest.raises(ValueError) as e:
            tr.fit_local(tr.init_state(), split, batch_size=5)
        got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            mod.MeshConfig(clients=1, data=2, seq=2, fsdp=True)
        got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    assert msgs[1][0] == "model.max_len=16 must divide into mesh.seq=3 equal sequence chunks"
    assert msgs[1][1] == "batch_size=5 must divide over the data axis (2)"


def test_fedseq_state_and_mesh_helpers():
    mesh = pfedseq.make_seq_mesh(2, 2, 2, device="cpu")
    assert mesh.axis_names == ("clients", "data", "seq") and mesh.devices.shape == (2, 2, 2)
    ctxs = pfedseq.client_contexts(mesh, 4, range(4))
    assert [c.data for c in ctxs] == [2] * 4 and [c.seq for c in ctxs] == [2] * 4
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)}
    stacked, opt = pfedseq.init_fedseq_state(params, 3, device="cpu")
    assert stacked["w"].shape == (3, 2, 3) and torch.equal(stacked["w"][2], params["w"])
    assert opt.count == [0, 0, 0] and torch.equal(opt.mu["w"], torch.zeros(3, 2, 3))
    tr = pseqfed.FedSeqTrainer(_exp_cfg(pcfg, 2, clients=4), device="cpu")
    assert tr.mesh.devices.shape == (4, 1, 2)  # 8 CPU slots: one client a row
    tr = pseqfed.FedSeqTrainer(_exp_cfg(pcfg, 4, clients=4, data=2), device="cpu")
    assert tr.mesh.devices.shape == (1, 2, 4)  # rows fitted to the slots
    assert tr._trace_attrs() == {"path": "fedseq", "clients": 4, "seq": 4, "ring_chunk": 4}
    with pytest.raises(ValueError, match="mesh 4x4x4 needs 64 devices, have 8"):  # the JAX message
        pseqfed.FedSeqTrainer(_exp_cfg(pcfg, 4, clients=4, data=4), device="cpu")


# ------------------------------------------------------------- the CLI
def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], {k: float(v) for k, v in zip(rows[0], rows[1])}


def test_federated_seq_parallel_cli_matches_jax_and_resumes(tmp_path, monkeypatch):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        main as jax_main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models import (
        presets as jpresets,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
        presets as ppresets,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
        Checkpointer,
    )

    monkeypatch.setitem(ppresets.PRESETS, "tiny", lambda **kw: pcfg.ModelConfig.tiny(**NO_DROP, **kw))
    monkeypatch.setitem(jpresets.PRESETS, "tiny", lambda **kw: jcfg.ModelConfig.tiny(**NO_DROP, **kw))

    def port_init(cfg, generator):
        jm = jcfg.ModelConfig(**dataclasses.asdict(cfg))
        tree = jmodel.init_params(jmodel.DDoSClassifier(jm), jm, jax.random.key(0, impl="rbg"))
        return pconvert.params_from_jax(jax.tree.map(np.asarray, tree))

    monkeypatch.setattr(pfederated, "init_params", port_init)
    argv = ["federated", "--preset", "tiny", "--synthetic", "600", "--num-clients", "2", "--rounds", "2",
            "--epochs", "1", "--seq-parallel", "2"]
    assert jax_main(argv + ["--output-dir", str(tmp_path / "jax")]) == 0
    ck = tmp_path / "ck"
    assert main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "port"), "--checkpoint-dir", str(ck)]) == 0
    for c in range(2):
        for phase in ("local", "aggregated"):
            name = f"client{c}_{phase}_metrics.csv"
            cols, got = _read_csv(tmp_path / "port" / name)
            jcols, want = _read_csv(tmp_path / "jax" / name)
            assert cols == jcols == ["Accuracy", "Loss", "Precision", "Recall", "F1-Score"]
            for key in METRICS:
                np.testing.assert_allclose(got[key], want[key], atol=1e-4, err_msg=f"{name} {key}")
            np.testing.assert_allclose(got["Loss"], want["Loss"], atol=1e-3, err_msg=name)
    # The checkpoint of round 1, resumed for round 2, ends where the
    # uninterrupted run ended, bit for bit.
    with Checkpointer(str(ck)) as ckpt:
        final = ckpt.restore_params(step=2)
        assert ckpt.latest_step() == 2
    import shutil

    ck1 = tmp_path / "ck1"
    shutil.copytree(ck, ck1)
    shutil.rmtree(ck1 / "2")
    assert main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "resumed"), "--checkpoint-dir", str(ck1)]) == 0
    with Checkpointer(str(ck1)) as ckpt:
        again = ckpt.restore_params(step=2)
    assert final.keys() == again.keys() and all(torch.equal(torch.as_tensor(final[k]), torch.as_tensor(again[k]))
                                                for k in final)
    # DP-FedAvg at noise 0 through the sequence-parallel trainer.
    assert main(argv[:-4] + ["--rounds", "1", "--epochs", "1", "--seq-parallel", "2", "--device", "cpu",
                             "--dp-clip", "100.0", "--dp-noise-multiplier", "0.0",
                             "--output-dir", str(tmp_path / "dp")]) == 0
    assert (tmp_path / "dp" / "client1_aggregated_metrics.csv").exists()
