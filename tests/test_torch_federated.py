"""The port's single-process federated trainer held against the JAX
package's ``FederatedTrainer`` (one CPU device), on the CPU.

Both start from the same weights (the JAX init, through the stacked
converter; host copies, because the JAX steps donate their state), with
dropout off, on the same batches:

* ``weighted_mean``/``fedavg`` uniform, weighted and masked (atol 1e-7,
  tests/test_fedavg.py's bound), and steps of each FedOpt server
  optimizer against optax (atol 1e-7);
* the FedOpt round boundary on identical inputs (FedAvgM, FedAdam,
  FedYogi at server_lr 1), atol 2e-6;
* a ragged fit of 3 clients, one idling through most lockstep steps, and
  a dense fit: per-client epoch losses at rtol 1e-5, params at atol 2e-6
  / rtol 1e-5 (tests/test_torch_client.py's bounds); the idling client's
  params, moments and Adam count unchanged across its gated steps;
* ``run`` over 2 rounds: weighted; unweighted with an empty client;
  participation 0.5 (fixed); FedProx mu 0.1; FedAdam. After each round
  the aggregate at atol 2e-6 / rtol 1e-5; each round's metrics at rtol
  1e-6 (Accuracy, Precision, Recall, F1) and 1e-5 (Loss); the final
  probs at atol 1e-5 (tests/test_torch_train.py's bounds);
* ``eval_gate`` and ``reference_histogram`` exactly;
* the ``federated`` CLI end to end against the JAX CLI (same weights,
  dropout off): the reference CSV schema and values within the metric
  bounds; the unported flags refused by argparse.

Two comparisons are conditioned by the algorithm, not the port. The
attention key bias has a gradient of exactly 0 in exact arithmetic (a
constant q·b_k per query row leaves softmax unchanged), so each package
computes rounding noise there, with its own signs; Adam divides that
noise by its magnitude, and FedProx's pull toward the round start then
feeds the noise's own step back in (about mu·lr/eps = 200× a step) until
it saturates at lr a step. Under FedProx those leaves are therefore held
to that saturation bound, not the trajectory bound, while every other
leaf and every output (metrics, probs) stays at the full bound. FedAdam
steps each element by about server_lr·g/(|g| + 1e-8): a pseudo-gradient
of rounding noise becomes a full step with the noise's sign, and one
within a few decades of eps multiplies upstream fp32 differences by
server_lr·eps/(|g| + eps)². A whole-model run therefore turns 1-ulp
differences into O(server_lr) ones in either package. Its run is held
with the encoder frozen (``trainable="head"``: the frozen leaves'
pseudo-gradient is exactly 0 under a power-of-two uniform mean), at
server_lr 1e-3; its round boundary is held at the default server_lr 1
on identical inputs.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    pipeline as jpipeline,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models import (
    presets as jpresets,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.parallel.fedavg import (
    fedavg as jax_fedavg,
    weighted_mean as jax_weighted_mean,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.parallel.mesh import (
    make_mesh,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train import (
    fedeval as jfedeval,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train.federated import (
    FederatedTrainer as JaxFederatedTrainer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
    main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    pipeline as ppipeline,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    flatten_tree,
    params_from_jax,
    params_to_jax,
    presets as ppresets,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel import (
    ServerOptimizer,
    fedavg,
    stack_params,
    weighted_mean,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    fedeval as pfedeval,
    federated as pfederated,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.batches import (
    federated_batches_ragged,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.federated import (
    FederatedTrainer,
)

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
METRICS = ("Accuracy", "Precision", "Recall", "F1-Score")
KEY_BIAS = "attn/k/bias"


def _configs(fed_kw, *, train_kw=None, bs=4):
    model = pcfg.ModelConfig.tiny(**NO_DROP)
    data = dict(max_len=model.max_len, batch_size=bs, eval_batch_size=bs)
    train = dict(epochs_per_round=1, **(train_kw or {}))
    port = pcfg.ExperimentConfig(
        model=model, data=pcfg.DataConfig(**data), train=pcfg.TrainConfig(**train), fed=pcfg.FedConfig(**fed_kw)
    )
    jax_cfg = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(**dataclasses.asdict(model)),
        data=jcfg.DataConfig(**data),
        train=jcfg.TrainConfig(**train),
        fed=jcfg.FedConfig(**fed_kw),
        mesh=jcfg.MeshConfig(clients=1),
    )
    return port, jax_cfg


def _trainers(fed_kw, **kw):
    """(port trainer, port state, JAX trainer, JAX state) from one init."""
    port_cfg, jax_cfg = _configs(fed_kw, **kw)
    jt = JaxFederatedTrainer(jax_cfg, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    jstate = jt.init_state()
    single = jax.tree.map(lambda x: np.asarray(x)[0], jstate.params)
    pt = FederatedTrainer(port_cfg, device="cpu")
    return pt, pt.init_state(params=params_from_jax(single)), jt, jstate


def _split(rng, n, L=32, vocab=256):
    ids = rng.integers(5, vocab, (n, L)).astype(np.int32)
    ids[:, 0] = 2
    mask = (np.arange(L)[None, :] < rng.integers(L // 3, L + 1, n)[:, None]).astype(np.int32)
    return ids * mask, mask, rng.integers(0, 2, n).astype(np.int32)


def _data(sizes, eval_sizes, seed=0):
    rng = np.random.default_rng(seed)
    train = [_split(rng, n) for n in sizes]
    evals = [_split(rng, n) for n in eval_sizes]
    return train, evals


def _port_splits(arrays):
    return [ppipeline.TokenizedSplit(*a) for a in arrays]


def _jax_splits(arrays):
    return [jpipeline.TokenizedSplit(*a) for a in arrays]


def _flat_port(params):
    return flatten_tree(params_to_jax(params, stacked=True))


def _flat_jax(params):
    return flatten_tree(jax.tree.map(np.asarray, params))


def _assert_params_close(port_params, jax_flat, *, prox_lr_steps=None, msg=""):
    got = _flat_port(port_params)
    assert got.keys() == jax_flat.keys()
    for name, want in jax_flat.items():
        if prox_lr_steps is not None and name.endswith(KEY_BIAS):
            # Rounding-noise leaf under FedProx (module docstring): bounded
            # by the saturated step, lr a step, in both packages.
            assert np.abs(got[name]).max() <= prox_lr_steps * 1.01, (msg, name)
            assert np.abs(want).max() <= prox_lr_steps * 1.01, (msg, name)
            continue
        np.testing.assert_allclose(got[name], want, atol=2e-6, rtol=1e-5, err_msg=f"{msg} {name}")


def _assert_metrics_close(got, want, msg=""):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["confusion_matrix"], w["confusion_matrix"], err_msg=f"{msg} client {c}")
        for key in METRICS:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=f"{msg} client {c} {key}")
        np.testing.assert_allclose(g["Loss"], w["Loss"], rtol=1e-5, err_msg=f"{msg} client {c} Loss")


# ------------------------------------------------------------ the mean
MEANS = {
    "uniform": (None, None),
    "weighted": (np.array([13.0, 6.0, 3.0]), None),
    "masked": (None, np.array([1.0, 0.0, 1.0])),
    "weighted_masked": (np.array([13.0, 6.0, 3.0]), np.array([0.0, 1.0, 1.0])),
}


@pytest.mark.parametrize("case", sorted(MEANS))
def test_weighted_mean_and_fedavg_match_jax(case):
    weights, mask = MEANS[case]
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(3, 7, 5)).astype(np.float32), "b": rng.normal(size=(3, 11)).astype(np.float32)}
    w = None if weights is None else jnp.asarray(weights)
    m = None if mask is None else jnp.asarray(mask)
    want_mean = jax.jit(jax_weighted_mean)({k: jnp.asarray(v) for k, v in tree.items()}, w, m)
    want_avg = jax.jit(jax_fedavg)({k: jnp.asarray(v) for k, v in tree.items()}, w, m)
    stacked = {k: torch.tensor(v) for k, v in tree.items()}
    got_mean = weighted_mean(stacked, weights, mask)
    for k in tree:
        np.testing.assert_allclose(got_mean[k].numpy(), np.asarray(want_mean[k]), atol=1e-7, err_msg=k)
    out = fedavg(stacked, weights, mask)
    assert out is stacked  # in place
    for k in tree:
        np.testing.assert_allclose(stacked[k].numpy(), np.asarray(want_avg[k]), atol=1e-7, err_msg=k)
        # Every row holds the mean, in its own storage (no shared view).
        assert all(torch.equal(stacked[k][c], stacked[k][0]) for c in range(3))
    stacked["a"][1].add_(1.0)
    assert not torch.equal(stacked["a"][0], stacked["a"][1])


def test_stack_params_copies_rows():
    single = {"w": torch.arange(6.0).reshape(2, 3)}
    stacked = stack_params(single, 3)
    assert stacked["w"].shape == (3, 2, 3) and all(torch.equal(stacked["w"][c], single["w"]) for c in range(3))
    stacked["w"][0].zero_()
    assert torch.equal(stacked["w"][1], single["w"])


@pytest.mark.parametrize("kind", ["momentum", "adam", "yogi"])
def test_server_optimizer_steps_match_optax(kind):
    tx = {"momentum": optax.sgd(0.7, momentum=0.9), "adam": optax.adam(0.7), "yogi": optax.yogi(0.7)}[kind]
    ours = ServerOptimizer(kind, 0.7, 0.9)
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    jstate = tx.init({k: jnp.asarray(v) for k, v in params.items()})
    pstate = ours.init({k: torch.tensor(v) for k, v in params.items()})
    for step in range(3):
        g = {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-6, 1)).astype(np.float32) for k, v in params.items()}
        jup, jstate = jax.jit(tx.update)({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        pup, pstate = ours.update({k: torch.tensor(v) for k, v in g.items()}, pstate)
        for k in params:
            np.testing.assert_allclose(pup[k].numpy(), np.asarray(jup[k]), atol=1e-7, err_msg=f"{kind} step {step} {k}")
    assert ServerOptimizer("adam", 1.0).eps == 1e-8 and ServerOptimizer("yogi", 1.0).eps == 1e-3


@pytest.mark.parametrize("server_opt", ["momentum", "adam", "yogi"])
def test_fedopt_round_boundary_matches_jax(server_opt):
    """Two FedOpt round boundaries at the default server_lr on identical
    inputs: rows that differ (the clients' local results) against an
    anchor of identical rows, weighted and masked. Every client moves
    each element the same way by 0.1 to 0.2, so the pseudo-gradient is
    at least 0.1 everywhere. FedAdam's second step moves an element by
    about server_lr·δg/|g| for an error δg in the mean, and an fp32 mean
    of params near 1 is off by an ulp or so, which |g| ≥ 0.1 keeps
    inside the bound (module docstring)."""
    pt, pstate, jt, jstate = _trainers(dict(num_clients=3, server_opt=server_opt, min_client_fraction=0.5))
    rng = np.random.default_rng(3)
    weights, mask = np.array([13.0, 6.0, 3.0]), np.array([1.0, 0.0, 1.0])

    def local_result(x):
        sign = rng.choice([-1.0, 1.0], size=x.shape[1:])
        step = sign * (1.0 + rng.random(size=x.shape)) * 0.1
        return (x + step).astype(np.float32)

    for r in range(2):
        anchor_j = jax.tree.map(np.asarray, jstate.params)
        local = jax.tree.map(local_result, anchor_j)
        jstate = jstate._replace(params=jax.tree.map(jnp.asarray, local))
        pstate.params = {n: t.requires_grad_(True) for n, t in params_from_jax(local, stacked=True).items()}
        anchor_p = {n: t.detach().clone() for n, t in params_from_jax(anchor_j, stacked=True).items()}
        jstate = jt.aggregate(jstate, weights=weights, client_mask=mask, anchor=jax.tree.map(jnp.asarray, anchor_j))
        pstate = pt.aggregate(pstate, weights=weights, client_mask=mask, anchor=anchor_p)
        want = _flat_jax(jstate.params)
        for name, w in want.items():
            np.testing.assert_allclose(_flat_port(pstate.params)[name], w, atol=2e-6, err_msg=f"round {r} {name}")
        assert all(torch.equal(t[c], t[0]) for t in pstate.params.values() for c in range(3))


# ------------------------------------------------------------ local fits
@pytest.fixture(scope="module")
def ragged_fit():
    train, _ = _data((13, 6, 3), (2, 2, 2))
    pt, pstate, jt, jstate = _trainers(dict(num_clients=3))
    jstate, jl = jt.fit_local(jstate, jpipeline.stack_clients_ragged(_jax_splits(train)), epochs=2)
    return pt, pstate, train, jstate, jl


def test_ragged_fit_matches_jax(ragged_fit):
    pt, pstate, train, jstate, jlosses = ragged_fit
    stacked = ppipeline.stack_clients_ragged(_port_splits(train))
    pstate, plosses = pt.fit_local(pstate, stacked, epochs=2)
    assert plosses.shape == jlosses.shape == (2, 3)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    _assert_params_close(pstate.params, _flat_jax(jstate.params))
    # One Adam count per client: its own steps (ceil(n/4) an epoch).
    assert pstate.opt_state.count == [8, 4, 2]
    np.testing.assert_array_equal(np.asarray(jstate.opt_state[0][0].count), [8, 4, 2])
    assert pstate.step == int(jstate.step) == 8


def test_an_idle_client_keeps_its_state_through_gated_steps(ragged_fit):
    pt, pstate, train, _, _ = ragged_fit
    pstate = pt.init_state(params={n: t[0] for n, t in pstate.params.items()})
    stacked = ppipeline.stack_clients_ragged(_port_splits(train))
    gated = 0
    for batch in federated_batches_ragged(stacked, 4, seed=0, epoch=0):
        before = (
            {n: t[2].detach().clone() for n, t in pstate.params.items()},
            {n: t[2].clone() for n, t in pstate.opt_state.mu.items()},
            {n: t[2].clone() for n, t in pstate.opt_state.nu.items()},
            pstate.opt_state.count[2],
        )
        losses, has = pt.train_step(pstate, batch)
        if batch["valid"][2].sum() == 0:
            gated += 1
            assert has[2] == 0 and float(losses[2]) == 0.0
            assert all(torch.equal(pstate.params[n][2], t) for n, t in before[0].items())
            assert all(torch.equal(pstate.opt_state.mu[n][2], t) for n, t in before[1].items())
            assert all(torch.equal(pstate.opt_state.nu[n][2], t) for n, t in before[2].items())
            assert pstate.opt_state.count[2] == before[3]
        else:
            assert has[2] == 1 and pstate.opt_state.count[2] == before[3] + 1
    assert gated == 3  # ceil(13/4) = 4 lockstep steps, client 2 takes 1


def test_dense_fit_matches_jax():
    train, _ = _data((12, 9, 10), (2, 2, 2), seed=4)
    pt, pstate, jt, jstate = _trainers(dict(num_clients=3), train_kw=dict(warmup_steps=3))
    jstate, jl = jt.fit_local(jstate, jpipeline.stack_clients(_jax_splits(train)), epochs=2)
    pstate, pl = pt.fit_local(pstate, ppipeline.stack_clients(_port_splits(train)), epochs=2)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params_close(pstate.params, _flat_jax(jstate.params))
    assert pstate.opt_state.count == [4, 4, 4] and pstate.step == 4
    with pytest.raises(ValueError, match="zero batches"):
        pt.fit_local(pstate, ppipeline.stack_clients(_port_splits(_data((3, 3), (1, 1))[0])), epochs=1)


# ------------------------------------------------------------ whole runs
RUNS = {
    "weighted": (dict(num_clients=3, weighted=True), {}, (13, 6, 3)),
    "unweighted_empty_client": (dict(num_clients=3, weighted=False, min_client_fraction=0.5), {}, (13, 6, 0)),
    "participation_fixed": (
        dict(num_clients=3, participation=0.5, participation_mode="fixed", min_client_fraction=0.5), {}, (13, 6, 3)
    ),
    "fedprox": (dict(num_clients=3, prox_mu=0.1), {}, (13, 6, 3)),
    "fedadam": (
        dict(num_clients=2, weighted=False, server_opt="adam", server_lr=1e-3), dict(trainable="head"), (13, 6)
    ),
}


def _capture(trainer, into, to_host):
    """Record the aggregate ``round_aggregate`` returns, each round."""
    inner = trainer.round_aggregate

    def wrapped(state, **kw):
        out = inner(state, **kw)
        into.append(to_host(out.params))
        return out

    trainer.round_aggregate = wrapped


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_matches_jax(case):
    fed_kw, train_kw, sizes = RUNS[case]
    train, evals = _data(sizes, (6, 3, 5)[: len(sizes)], seed=5)
    pt, pstate, jt, jstate = _trainers(dict(fed_kw, rounds=2), train_kw=train_kw)
    start = _flat_jax(jstate.params)
    jaggs, paggs = [], []
    _capture(jt, jaggs, _flat_jax)
    _capture(pt, paggs, lambda p: {n: t.detach().clone() for n, t in p.items()})
    jstate, jhist = jt.run(jstate, jpipeline.stack_clients_ragged(_jax_splits(train)), _jax_splits(evals))
    pstate, phist = pt.run(pstate, ppipeline.stack_clients_ragged(_port_splits(train)), _port_splits(evals))
    assert len(jaggs) == len(paggs) == len(jhist) == len(phist) == 2
    lr_steps = 2e-5 * 2 * -(-max(sizes) // 4)  # saturated FedProx steps, lr each
    for r in range(2):
        np.testing.assert_allclose(phist[r].epoch_losses, jhist[r].epoch_losses, rtol=1e-5, err_msg=f"round {r}")
        _assert_params_close(paggs[r], jaggs[r], prox_lr_steps=lr_steps if case == "fedprox" else None, msg=f"round {r}")
        _assert_metrics_close(phist[r].local_metrics, jhist[r].local_metrics, f"round {r} local")
        _assert_metrics_close(phist[r].aggregated_metrics, jhist[r].aggregated_metrics, f"round {r} aggregated")
    for t in pstate.params.values():
        assert all(torch.equal(t[c], t[0]) for c in range(t.shape[0]))
    pfinal = pt.evaluate_clients(pstate.params, _port_splits(evals), collect_probs=True)
    jfinal = jt.evaluate_clients(jstate.params, _jax_splits(evals), collect_probs=True)
    for p, j in zip(pfinal, jfinal):
        np.testing.assert_allclose(p["probs"], j["probs"], atol=1e-5)
        np.testing.assert_array_equal(p["labels"], j["labels"])
    got = _flat_port(pstate.params)
    if case == "unweighted_empty_client":
        assert pstate.opt_state.count[2] == 0  # the empty client never stepped
    if case == "fedadam":
        for name, s in start.items():
            if not name.startswith("classifier/"):
                np.testing.assert_array_equal(got[name], s, err_msg=name)  # frozen, exact mean
        assert pstate.server_opt["count"] == 2
    if case == "participation_fixed":
        masks = [pt.participation_mask(r) for r in range(2)]
        for r, m in enumerate(masks):
            np.testing.assert_array_equal(m, jt.participation_mask(r))
            assert m.sum() == 2


def test_poisson_participation_and_the_zero_weight_guard():
    pt = FederatedTrainer(
        _configs(dict(num_clients=6, participation=0.3, participation_mode="poisson", min_client_fraction=0.3))[0],
        device="cpu",
    )
    _, jax_cfg = _configs(dict(num_clients=6, participation=0.3, participation_mode="poisson", min_client_fraction=0.3))
    jt = JaxFederatedTrainer(jax_cfg, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    draws = [pt.participation_mask(r) for r in range(12)]
    for r, m in enumerate(draws):
        np.testing.assert_array_equal(m, jt.participation_mask(r))
    state = pt.init_state()
    before = {n: t.detach().clone() for n, t in state.params.items()}
    empty = next(r for r, m in enumerate(draws) if m.sum() == 0)
    pt.round_aggregate(state, round_index=empty)  # an empty cohort: a no-op round
    assert all(torch.equal(state.params[n], t) for n, t in before.items())
    with pytest.raises(ValueError, match="weight sum is zero"):
        pt.aggregate(state, weights=np.array([1.0, 0, 0, 0, 0, 0]), client_mask=np.array([0.0, 1, 1, 1, 1, 1]),
                     enforce_min_fraction=False)
    with pytest.raises(RuntimeError, match="survived"):
        pt.aggregate(state, client_mask=np.zeros(6))


# ------------------------------------------------------------ control hooks
def test_eval_gate_and_reference_histogram_match_jax():
    cases = [
        ({"Accuracy": 90.0}, None, {}),
        ({"Accuracy": 90.0}, {"Accuracy": 91.0}, {}),
        ({"Accuracy": 90.0}, {"Accuracy": 91.0}, dict(min_delta=2.0)),
        ({"Accuracy": float("nan")}, {"Accuracy": 1.0}, {}),
        ({}, {"Accuracy": 1.0}, {}),
        ({"F1-Score": 0.5}, {"F1-Score": float("nan")}, dict(metric="F1-Score")),
        ({"F1-Score": 0.5}, {}, dict(metric="F1-Score")),
        ({"Accuracy": "x"}, None, {}),
    ]
    for cand, inc, kw in cases:
        assert pfedeval.eval_gate(cand, inc, **kw) == jfedeval.eval_gate(cand, inc, **kw), (cand, inc, kw)
    rng = np.random.default_rng(6)
    for probs in (rng.random(500), np.array([0.0, 1.0, 0.5, -0.2, 1.7]), np.zeros(0)):
        for bins in (10, 7):
            got = pfedeval.reference_histogram(probs, bins=bins)
            want = jfedeval.reference_histogram(probs, bins=bins)
            assert got.dtype == want.dtype == np.int64
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the CLI
def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return list(rows[0]), {k: float(v) for k, v in rows[0].items()}


def test_federated_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """``federated --preset tiny --synthetic 600 --num-clients 2 --rounds
    2`` in both packages, dropout off in both presets and the port
    started from the JAX CLI's init (seed 0): the same CSVs."""
    monkeypatch.setitem(ppresets.PRESETS, "tiny", lambda **kw: pcfg.ModelConfig.tiny(**NO_DROP, **kw))
    monkeypatch.setitem(jpresets.PRESETS, "tiny", lambda **kw: jcfg.ModelConfig.tiny(**NO_DROP, **kw))
    jax_init = {}

    def port_init(cfg, generator):
        jm = jcfg.ModelConfig(**dataclasses.asdict(cfg))
        tree = jax_init_params(JaxClassifier(jm), jm, jax.random.key(0, impl="rbg"))
        jax_init["tree"] = jax.tree.map(np.asarray, tree)
        return params_from_jax(jax_init["tree"])

    monkeypatch.setattr(pfederated, "init_params", port_init)
    argv = ["federated", "--preset", "tiny", "--synthetic", "600", "--num-clients", "2", "--rounds", "2", "--epochs", "1"]
    assert jax_main(argv + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "port")]) == 0
    for c in range(2):
        for phase in ("local", "aggregated"):
            name = f"client{c}_{phase}_metrics.csv"
            cols, got = _read_csv(tmp_path / "port" / name)
            jcols, want = _read_csv(tmp_path / "jax" / name)
            assert cols == jcols == ["Accuracy", "Loss", "Precision", "Recall", "F1-Score"]
            for key in METRICS:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=f"{name} {key}")
            np.testing.assert_allclose(got["Loss"], want["Loss"], rtol=1e-5, err_msg=name)


@pytest.mark.parametrize(
    "flag",
    [
        ["--data-parallel", "2"], ["--seq-parallel", "2"], ["--personalize-epochs", "1"],
        ["--personalize-scope", "head"], ["--dp-clip", "1.0"], ["--dp-noise-multiplier", "1.0"],
        ["--coordinator", "localhost:1"], ["--num-processes", "2"], ["--process-id", "0"],
        ["--stream"], ["--source", "x.csv"], ["--metrics-jsonl", "m.jsonl"], ["--profile-dir", "p"],
    ],
)
def test_unported_federated_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit):
        build_parser().parse_args(["federated", *flag])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_federated_flags_resolve_and_personalize_raises():
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
        resolve_config,
    )

    args = build_parser().parse_args([
        "federated", "--num-clients", "4", "--rounds", "3", "--unweighted", "--partition", "dirichlet",
        "--dirichlet-alpha", "0.2", "--prox-mu", "0.01", "--participation", "0.5",
        "--participation-mode", "poisson", "--server-opt", "yogi", "--server-lr", "0.1",
        "--server-momentum", "0.5",
    ])
    assert args.device == "cuda"
    cfg = resolve_config(args, vocab_size=256)
    assert cfg.fed == pcfg.FedConfig(
        num_clients=4, rounds=3, weighted=False, prox_mu=0.01, participation=0.5,
        participation_mode="poisson", min_client_fraction=0.5, server_opt="yogi",
        server_lr=0.1, server_momentum=0.5,
    )
    # One flag feeds whichever tier runs, as in the JAX package: the TCP
    # client's local phase reads TrainConfig.prox_mu.
    assert cfg.train.prox_mu == 0.01
    assert (cfg.data.partition, cfg.data.dirichlet_alpha) == ("dirichlet", 0.2)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["federated", "--weighted", "--unweighted"])
    trainer = FederatedTrainer(_configs(dict(num_clients=2))[0], device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        trainer.personalize(trainer.init_state(), None)


def test_federated_without_cuda_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    args = build_parser().parse_args(["federated", "--synthetic", "300", "--output-dir", str(out)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        args.fn(args)
    assert not os.path.exists(out)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedTrainer(_configs(dict(num_clients=2))[0])
