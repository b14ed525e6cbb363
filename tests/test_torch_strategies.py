"""The port's server strategies held against ``strategies/core.py`` of the
JAX package, on the CPU.

* every strategy over the same sequence of folded means: FedAvg, FedProx
  and HeadBoost exactly; Momentum and FedOpt (adam, yogi) at atol 1e-7,
  the bound of tests/test_strategies.py (the port steps the server
  optimizer in torch where the JAX package runs optax);
* the spec parser accepts and refuses the same specs;
* ``--strategy-state-file`` restores across the packages: a JAX server's
  file resumes a port server's optimizer trajectory, and the reverse.
"""

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    strategies as jstrat,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    AggregationServer as JaxServer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    strategies as pstrat,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    AggregationServer,
)

SPECS = [
    ("fedavg", 0.0),
    ("fedprox:mu=0.1", 0.0),
    ("headboost:gamma=2.0,match=classifier", 0.0),
    ("momentum", 1e-7),
    ("momentum:lr=0.5,momentum=0.8", 1e-7),
    ("fedopt", 1e-7),
    ("fedopt:opt=yogi,lr=0.05", 1e-7),
]


def _means(rng, rounds=4):
    keys = {"classifier/kernel": (16, 2), "encoder/layer_0/kernel": (16, 16), "encoder/bias": (16,)}
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in keys.items()}
    out = []
    for _ in range(rounds):
        base = {k: (v + rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in base.items()}
        out.append(dict(base))
    return out


@pytest.mark.parametrize("spec,atol", SPECS)
def test_strategy_matches_jax_round_by_round(spec, atol):
    means = _means(np.random.default_rng(1))
    p, j = pstrat.make_strategy(spec, device="cpu"), jstrat.make_strategy(spec)
    assert p.describe() == j.describe() and p.client_mu() == j.client_mu()
    p_prev = j_prev = None
    for r, mean in enumerate(means):
        p_prev = p.apply(p_prev, mean, round_no=r)
        j_prev = j.apply(j_prev, mean, round_no=r)
        assert sorted(p_prev) == sorted(j_prev)
        for k in j_prev:
            assert p_prev[k].dtype == np.float32
            if atol == 0.0:
                np.testing.assert_array_equal(p_prev[k], j_prev[k])
            else:
                np.testing.assert_allclose(p_prev[k], np.asarray(j_prev[k]), atol=atol, rtol=0)
    if atol:
        # The optimizer state exports in the JAX package's leaf order.
        pe, je = p.export_state(), j.export_state()
        assert [np.shape(a) for a in pe] == [np.shape(a) for a in je]
        assert [np.asarray(a).dtype for a in pe] == [np.asarray(a).dtype for a in je]
        for a, b in zip(pe, je):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_first_round_and_shape_change_adopt_the_mean():
    mean = _means(np.random.default_rng(2), rounds=1)[0]
    for spec, _ in SPECS:
        s = pstrat.make_strategy(spec, device="cpu")
        assert s.apply(None, mean) is mean
        other = {"x": np.zeros(3, np.float32)}
        s.apply(mean, mean)
        assert s.apply(mean, other) is other


@pytest.mark.parametrize(
    "spec",
    ["fedavg", " fedprox ", "fedprox:mu=0.5", "fedopt:opt=yogi,lr=0.05", "momentum:lr=1,momentum=0",
     "headboost:match=head", "fedopt:lr=1e-3"],
)
def test_spec_parser_accepts_what_jax_accepts(spec):
    assert pstrat.parse_strategy(spec) == jstrat.parse_strategy(spec)
    assert pstrat.make_strategy(spec, device="cpu").describe() == jstrat.make_strategy(spec).describe()


@pytest.mark.parametrize(
    "spec",
    ["nope", "fedprox:mu=0", "fedprox:mu", "fedprox:=1", "fedopt:opt=sgd", "fedopt:lr=-1",
     "momentum:momentum=1.0", "headboost:gamma=0", "headboost:match=", "fedavg:x=1", "fedprox:mu=1,,"],
)
def test_spec_parser_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jstrat.make_strategy(spec)
    with pytest.raises(ValueError):
        pstrat.make_strategy(spec, device="cpu")


def _drive(server, means):
    """Run the server's finalize-time strategy over ``means`` as rounds
    would: apply, keep the global, persist."""
    for mean in means:
        agg = server.strategy.apply(server._last_agg, mean, round_no=server._round_counter)
        server._last_agg, server._last_agg_round = agg, server._round_counter
        server._round_counter += 1
        server._persist_strategy_state()
    return server._last_agg


@pytest.mark.parametrize("spec", ["fedopt:opt=adam,lr=0.1", "momentum:lr=0.5", "fedopt:opt=yogi,lr=0.05"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_strategy_state_file_restores_across_packages(tmp_path, spec, writer):
    means = _means(np.random.default_rng(3), rounds=5)
    path = str(tmp_path / "state.npz")
    cls_w, kw_w = (JaxServer, {}) if writer == "jax" else (AggregationServer, {"device": "cpu"})
    cls_r, kw_r = (AggregationServer, {"device": "cpu"}) if writer == "jax" else (JaxServer, {})
    with cls_w(port=0, strategy=spec, strategy_state_path=path, **kw_w) as a:
        _drive(a, means[:3])
    with cls_r(port=0, strategy=spec, strategy_state_path=path, **kw_r) as b:
        assert b._last_agg_round == 2 and b._round_counter == 3
        resumed = _drive(b, means[3:])
    # The uninterrupted trajectory, in the JAX package.
    with JaxServer(port=0, strategy=spec) as c:
        want = _drive(c, means)
    for k in want:
        np.testing.assert_allclose(resumed[k], np.asarray(want[k]), atol=1e-6, rtol=0)
    # A file of another strategy is ignored: the reader starts fresh.
    with AggregationServer(port=0, strategy="fedavg", strategy_state_path=path, device="cpu") as d:
        assert d._last_agg is None and d._round_counter == 0


def test_set_strategy_swaps_between_rounds_with_fresh_state():
    means = _means(np.random.default_rng(4), rounds=3)
    with AggregationServer(port=0, strategy="fedopt", device="cpu") as server, JaxServer(port=0, strategy="fedopt") as jserver:
        for s in (server, jserver):
            _drive(s, means[:2])
            assert s.strategy.export_state() is not None
            assert s.set_strategy("momentum:lr=0.5") is s.strategy
            assert s.strategy.describe() == {"name": "momentum", "params": {"lr": 0.5, "momentum": 0.9}}
            assert s.strategy.export_state() is None  # fresh optimizer memory
            with pytest.raises(ValueError):
                s.set_strategy("nope")
        got, want = _drive(server, means[2:]), _drive(jserver, means[2:])
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-7, rtol=0)
