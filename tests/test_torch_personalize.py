"""Personalization in the port (``FederatedTrainer.personalize`` and the
``federated`` verb's third phase) held against the JAX package's, on the
CPU (after tests/test_personalize.py), dropout off, from the same weights:

* scope ``full`` and ``head`` on the same aggregate: epoch losses at rtol
  1e-5 and params at atol 2e-6 / rtol 1e-5 (the trajectory bound of
  tests/test_torch_federated.py);
* the caller's aggregate state (params, counts, dropout generators) is
  left as it was; ``head`` keeps every encoder leaf bit-equal;
* the scope override in both directions (``head`` on a
  ``trainable="all"`` config, ``full`` on a ``trainable="head"`` one);
* the CLI's ``client{c}_personalized_metrics.csv`` against the JAX CLI's,
  at the metric bounds.
"""

import dataclasses

import jax
import numpy as np
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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    pipeline as ppipeline,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    params_from_jax,
    presets as ppresets,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    federated as pfederated,
)
from test_torch_federated import (
    METRICS,
    NO_DROP,
    _assert_params_close,
    _data,
    _flat_jax,
    _jax_splits,
    _port_splits,
    _read_csv,
    _trainers,
)

torch.set_num_threads(1)


def _aggregated(fed_kw, train_kw=None):
    """Port and JAX trainers after one ragged local epoch and FedAvg."""
    train, _ = _data((13, 6, 3), (2, 2, 2), seed=8)
    pt, pstate, jt, jstate = _trainers(fed_kw, train_kw=train_kw)
    jstack = jpipeline.stack_clients_ragged(_jax_splits(train))
    pstack = ppipeline.stack_clients_ragged(_port_splits(train))
    jstate, _ = jt.fit_local(jstate, jstack)
    jstate = jt.aggregate(jstate)
    pstate, _ = pt.fit_local(pstate, pstack)
    pstate = pt.aggregate(pstate)
    return pt, pstate, pstack, jt, jstate, jstack


@pytest.mark.parametrize("scope", ["full", "head"])
def test_personalize_matches_jax(scope):
    fed_kw = dict(num_clients=3, personalize_epochs=2, personalize_scope=scope)
    pt, pstate, pstack, jt, jstate, jstack = _aggregated(fed_kw)
    _assert_params_close(pstate.params, _flat_jax(jstate.params), msg="aggregate")
    before = {n: t.detach().clone() for n, t in pstate.params.items()}
    gen_states = [g.get_state() for g in pstate.generators]
    counts, step = list(pstate.opt_state.count), pstate.step
    jpers, jl = jt.personalize(jstate, jstack)
    ppers, pl = pt.personalize(pstate, pstack)
    assert pl.shape == jl.shape == (2, 3)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params_close(ppers.params, _flat_jax(jpers.params), msg=scope)
    # A side branch: the aggregate state is untouched, and replicas diverge.
    assert all(torch.equal(pstate.params[n], t) for n, t in before.items())
    assert all(torch.equal(g.get_state(), s) for g, s in zip(pstate.generators, gen_states))
    assert pstate.opt_state.count == counts and pstate.step == step
    head = ppers.params["classifier.weight"]
    assert not torch.equal(head[0], head[1])
    encoder = [n for n in ppers.params if not n.startswith("classifier.")]
    if scope == "head":
        # FedPer: every encoder leaf bit-equal to the aggregate's.
        assert all(torch.equal(ppers.params[n], before[n]) for n in encoder)
        assert not any(ppers.params[n].requires_grad for n in encoder)
    else:
        assert any(not torch.equal(ppers.params[n], before[n]) for n in encoder)


@pytest.mark.parametrize("base_trainable,scope", [("head", "full"), ("all", "head")])
def test_scope_override_in_both_directions(base_trainable, scope):
    fed_kw = dict(num_clients=3, personalize_epochs=1, personalize_scope=scope)
    pt, pstate, pstack, jt, jstate, jstack = _aggregated(fed_kw, dict(trainable=base_trainable))
    before = {n: t.detach().clone() for n, t in pstate.params.items()}
    ppers, _ = pt.personalize(pstate, pstack)
    jpers, _ = jt.personalize(jstate, jstack)
    _assert_params_close(ppers.params, _flat_jax(jpers.params), msg=f"{base_trainable}->{scope}")
    encoder_moved = any(not torch.equal(ppers.params[n], before[n]) for n in before if not n.startswith("classifier."))
    assert encoder_moved == (scope == "full")
    assert pt.cfg.train.trainable == base_trainable  # the caller's trainer keeps its config


def test_personalize_refuses_bad_arguments():
    pt, pstate, _, _ = _trainers(dict(num_clients=2))
    with pytest.raises(ValueError, match="epochs > 0"):
        pt.personalize(pstate, None)
    with pytest.raises(ValueError, match="full|head"):
        pt.personalize(pstate, None, epochs=1, scope="encoder")


def test_cli_personalized_csv_matches_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setitem(ppresets.PRESETS, "tiny", lambda **kw: pcfg.ModelConfig.tiny(**NO_DROP, **kw))
    monkeypatch.setitem(jpresets.PRESETS, "tiny", lambda **kw: jcfg.ModelConfig.tiny(**NO_DROP, **kw))

    def port_init(cfg, generator):
        jm = jcfg.ModelConfig(**dataclasses.asdict(cfg))
        tree = jax_init_params(JaxClassifier(jm), jm, jax.random.key(0, impl="rbg"))
        return params_from_jax(jax.tree.map(np.asarray, tree))

    monkeypatch.setattr(pfederated, "init_params", port_init)
    argv = [
        "federated", "--preset", "tiny", "--synthetic", "300", "--num-clients", "2", "--rounds", "1",
        "--epochs", "1", "--batch-size", "8", "--personalize-epochs", "1", "--personalize-scope", "head",
    ]
    assert jax_main(argv + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "port")]) == 0
    for c in range(2):
        for phase in ("local", "aggregated", "personalized"):
            name = f"client{c}_{phase}_metrics.csv"
            cols, got = _read_csv(tmp_path / "port" / name)
            jcols, want = _read_csv(tmp_path / "jax" / name)
            assert cols == jcols
            for key in METRICS:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=f"{name} {key}")
            np.testing.assert_allclose(got["Loss"], want["Loss"], rtol=1e-5, err_msg=name)
