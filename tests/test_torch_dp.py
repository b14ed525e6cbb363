"""DP-FedAvg in the port (``parallel/dp.py`` and the federated trainer's
DP round boundary) held against the JAX package's, on the CPU (after
tests/test_dp.py).

* ``client_update_norms``, the per-client clip scaling and masked clients
  against JAX's at rtol 1e-5 (tests/test_dp.py's bound); noise 0 against
  JAX's ``dp_fedavg`` at atol 1e-5;
* the noise on the port alone: JAX's threefry stream cannot be
  reproduced, so its std is held to ``noise · clip / n`` within 5% (the
  JAX test's bound), rows identical, survivors' n under a mask, and a
  generator determines it;
* ``sgm_rdp``, ``dp_epsilon`` and ``dp_epsilon_both`` EQUAL to JAX's over a
  grid of (rounds, sigma, q), and JAX's pinned values;
* FedConfig's DP validation and sampling rate as JAX's;
* a ``FederatedTrainer`` run with DP at noise 0 (clip active) against the
  JAX trainer: the aggregate after each round at the trajectory bound,
  metrics at the metric bounds (tests/test_torch_federated.py's);
* the empty-Poisson no-op, ragged fleets included, and fresh noise
  entropy unless ``dp_seed`` pins it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    pipeline as jpipeline,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.parallel import (
    dp as jdp,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    pipeline as ppipeline,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel import (
    dp as pdp,
)
from test_torch_federated import (
    _assert_metrics_close,
    _assert_params_close,
    _capture,
    _data,
    _flat_jax,
    _jax_splits,
    _port_splits,
    _trainers,
)

torch.set_num_threads(1)


def _stack(C, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "w": (scale * rng.normal(size=(C, 4, 3))).astype(np.float32),
        "b": (scale * rng.normal(size=(C, 3))).astype(np.float32),
    }


def _anchor_like(stacked, seed=1):
    rng = np.random.default_rng(seed)
    return {k: np.broadcast_to(rng.normal(size=v.shape[1:]).astype(np.float32)[None], v.shape).copy() for k, v in stacked.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _port_dp(stacked, anchor, mask=None, *, clip, noise=0.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    out, norms = pdp.dp_fedavg(_t(stacked), _t(anchor), g, mask, clip=clip, noise_multiplier=noise)
    return {k: v.numpy() for k, v in out.items()}, norms.numpy()


def _jax_dp(stacked, anchor, mask=None, *, clip, noise=0.0):
    m = None if mask is None else jnp.asarray(mask, jnp.float32)
    out, norms = jdp.dp_fedavg(_j(stacked), _j(anchor), jax.random.key(0), m, clip=clip, noise_multiplier=noise)
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(norms)


def test_update_norms_match_jax():
    stacked = _stack(3, seed=2)
    anchor = _anchor_like(stacked, seed=3)
    got = pdp.client_update_norms(_t(stacked), _t(anchor)).numpy()
    want = np.asarray(jdp.client_update_norms(_j(stacked), _j(anchor)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for c in range(3):
        sq = sum(np.sum((stacked[k][c] - anchor[k][c]) ** 2) for k in stacked)
        np.testing.assert_allclose(got[c], math.sqrt(sq), rtol=1e-5)


@pytest.mark.parametrize("case", ["huge_clip", "all_clipped", "masked", "masked_clipped"])
def test_noiseless_dp_fedavg_matches_jax(case):
    """Noise 0: the single-model aggregate equals every row of JAX's."""
    scale = 50.0 if "clipped" in case else 1.0
    stacked = _stack(4, seed=4, scale=scale)
    anchor = _anchor_like(stacked, seed=5)
    mask = np.array([1.0, 0.0, 1.0, 1.0]) if "masked" in case else None
    clip = 1e9 if case in ("huge_clip", "masked") else 1.0
    got, gn = _port_dp(stacked, anchor, mask, clip=clip)
    want, wn = _jax_dp(stacked, anchor, mask, clip=clip)
    np.testing.assert_allclose(gn, wn, rtol=1e-5)
    for k in stacked:
        for c in range(4):
            np.testing.assert_allclose(got[k], want[k][c], atol=1e-5, err_msg=f"{case} {k}")
    if "clipped" in case:
        agg_sq = sum(np.sum((got[k] - anchor[k][0]) ** 2) for k in got)
        assert math.sqrt(agg_sq) <= clip + 1e-5


def test_per_client_clip_scaling_exact():
    anchor = {"w": np.zeros((2, 8), np.float32)}
    small = np.full(8, 0.1, np.float32)
    big = np.full(8, 10.0, np.float32)
    stacked = {"w": np.stack([small, big])}
    got, norms = _port_dp(stacked, anchor, clip=1.0)
    want, _ = _jax_dp(stacked, anchor, clip=1.0)
    big_norm = float(np.linalg.norm(big))
    expected = (small + big * (1.0 / big_norm)) / 2
    np.testing.assert_allclose(got["w"], expected, rtol=1e-5)
    np.testing.assert_allclose(got["w"], want["w"][1], rtol=1e-5)
    np.testing.assert_allclose(norms, [np.linalg.norm(small), big_norm], rtol=1e-5)


def test_noise_is_calibrated_and_generator_determined():
    C, D = 4, 20000
    zeros = {"w": np.zeros((C, D), np.float32)}
    clip, mult = 2.0, 1.5
    a, _ = _port_dp(zeros, zeros, clip=clip, noise=mult, seed=3)
    b, _ = _port_dp(zeros, zeros, clip=clip, noise=mult, seed=3)
    c, _ = _port_dp(zeros, zeros, clip=clip, noise=mult, seed=99)
    np.testing.assert_array_equal(a["w"], b["w"])
    assert not np.array_equal(a["w"], c["w"])
    expected = mult * clip / C
    assert abs(a["w"].std() - expected) / expected < 0.05
    # The JAX package's noise at the same scale.
    jn, _ = _jax_dp(zeros, zeros, clip=clip, noise=mult)
    assert abs(jn["w"][0].std() - expected) / expected < 0.05
    # Survivors set n: a mask of 2 of 4 doubles the std.
    noisy, _ = _port_dp(zeros, zeros, np.array([1.0, 0.0, 1.0, 0.0]), clip=1.0, noise=1.0)
    assert abs(noisy["w"].std() - 0.5) / 0.5 < 0.05
    with pytest.raises(ValueError, match="generator"):
        pdp.dp_fedavg(_t(zeros), _t(zeros), None, None, clip=1.0, noise_multiplier=1.0)


# --------------------------------------------------------------- accountant
GRID = [(r, s, q) for r in (1, 10, 100) for s in (0.5, 1.1, 4.0) for q in (1.0, 0.25, 0.01)]


@pytest.mark.parametrize("rounds,sigma,q", GRID)
def test_accountant_equals_jax(rounds, sigma, q):
    assert pdp.dp_epsilon(rounds, sigma, 1e-5, sampling_rate=q) == jdp.dp_epsilon(rounds, sigma, 1e-5, sampling_rate=q)
    assert pdp.dp_epsilon_both(rounds, sigma, 1e-5, sampling_rate=q) == jdp.dp_epsilon_both(
        rounds, sigma, 1e-5, sampling_rate=q
    )
    for alpha in (2, 3, 17, 511):
        assert pdp.sgm_rdp(alpha, q, sigma) == jdp.sgm_rdp(alpha, q, sigma)


def test_accountant_edges_and_pinned_values():
    assert pdp.DEFAULT_RDP_ORDERS == jdp.DEFAULT_RDP_ORDERS
    assert pdp.dp_epsilon(0, 1.0, 1e-5) == 0.0
    assert pdp.dp_epsilon(5, 0.0, 1e-5) == math.inf
    for bad, match in (((1, 1.0, 0.0), "delta"), ((-1, 1.0, 1e-5), "rounds")):
        with pytest.raises(ValueError, match=match):
            pdp.dp_epsilon(*bad)
    with pytest.raises(ValueError, match="sampling_rate"):
        pdp.dp_epsilon(10, 1.0, 1e-5, sampling_rate=0.0)
    with pytest.raises(ValueError, match="integer order"):
        pdp.sgm_rdp(1, 0.1, 1.0)
    e_zeroed, e_replace = pdp.dp_epsilon_both(10, 1.0, 1e-5, sampling_rate=0.25)
    assert abs(e_zeroed - 7.914871206627728) < 1e-9
    assert abs(e_replace - 26.21441811260802) < 1e-9
    f_zeroed, f_replace = pdp.dp_epsilon_both(3, 2.0, 1e-5)
    assert abs(f_zeroed - 4.530759175449132) < 1e-9
    assert abs(f_replace - 9.811759094632224) < 1e-9


# ------------------------------------------------------------ config
def test_fed_config_dp_validation_and_sampling_rate_match_jax():
    for bad, match in ((dict(dp_noise_multiplier=1.0), "dp_clip"), (dict(dp_clip=1.0, weighted=True), "uniform mean")):
        for cls in (pcfg.FedConfig, jcfg.FedConfig):
            with pytest.raises(ValueError, match=match):
                cls(**bad)
    dp_kw = dict(dp_clip=1.0, dp_noise_multiplier=1.0)
    for kw in (
        dict(num_clients=4, participation=0.3, min_client_fraction=0.25, **dp_kw),
        dict(num_clients=4, participation=0.26, min_client_fraction=0.25),
        dict(num_clients=4, participation=0.26, min_client_fraction=0.25, participation_mode="fixed", **dp_kw),
        dict(num_clients=4, participation=0.3, min_client_fraction=0.25, participation_mode="poisson"),
        dict(num_clients=4, **dp_kw),
        dict(num_clients=4, dp_clip=0.5, dp_seed=3, personalize_epochs=2, personalize_scope="head"),
    ):
        p, j = pcfg.FedConfig(**kw), jcfg.FedConfig(**kw)
        assert p.resolve_participation_mode() == j.resolve_participation_mode()
        assert p.dp_sampling_rate() == j.dp_sampling_rate()
        assert p.resolve_weighted() == j.resolve_weighted() and p.dp_enabled() == j.dp_enabled()
    assert pcfg.FedConfig(num_clients=4, participation=0.3, min_client_fraction=0.25, **dp_kw).dp_sampling_rate() == (0.3, True)


# ------------------------------------------------------------ the trainer
@pytest.mark.parametrize("case", ["clip_active", "huge_clip_empty_client"])
def test_trainer_dp_run_at_noise_0_matches_jax(case, caplog):
    """Two rounds of local training and DP aggregation; the clip binds in
    the first case (the log's clipped count says so)."""
    clip, sizes = (0.004, (13, 6, 3)) if case == "clip_active" else (1e6, (13, 6, 0))
    fed_kw = dict(num_clients=3, rounds=2, dp_clip=clip, dp_noise_multiplier=0.0, min_client_fraction=0.5)
    train, evals = _data(sizes, (6, 3, 5), seed=5)
    pt, pstate, jt, jstate = _trainers(fed_kw)
    jaggs, paggs = [], []
    _capture(jt, jaggs, _flat_jax)
    _capture(pt, paggs, lambda p: {n: t.detach().clone() for n, t in p.items()})
    jstate, jhist = jt.run(jstate, jpipeline.stack_clients_ragged(_jax_splits(train)), _jax_splits(evals))
    with caplog.at_level("INFO", logger="detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch"):
        pstate, phist = pt.run(pstate, ppipeline.stack_clients_ragged(_port_splits(train)), _port_splits(evals))
    clipped = [int(m.split(";")[1].split("/")[0]) for m in caplog.messages if m.startswith("[DP] round")]
    assert len(clipped) == 2 and (min(clipped) > 0) == (case == "clip_active"), caplog.messages
    for r in range(2):
        np.testing.assert_allclose(phist[r].epoch_losses, jhist[r].epoch_losses, rtol=1e-5)
        _assert_params_close(paggs[r], jaggs[r], msg=f"round {r}")
        _assert_metrics_close(phist[r].aggregated_metrics, jhist[r].aggregated_metrics, f"round {r}")
    for t in pstate.params.values():
        assert all(torch.equal(t[c], t[0]) for c in range(3))


def test_trainer_dp_requires_anchor_and_refuses_weights():
    pt, pstate, _, _ = _trainers(dict(num_clients=2, dp_clip=1.0))
    assert pt.round_anchor(pstate) is not None
    with pytest.raises(ValueError, match="round_anchor"):
        pt.aggregate(pstate)
    with pytest.raises(ValueError, match="uniform mean"):
        pt.aggregate(pstate, weights=np.ones(2), anchor=pt.round_anchor(pstate))
    plain, pstate, _, _ = _trainers(dict(num_clients=2))
    assert plain.round_anchor(pstate) is None


def test_trainer_dp_noise_is_fresh_entropy_unless_pinned():
    def agg_leaf(fed_kw):
        pt, pstate, _, _ = _trainers(dict(num_clients=2, dp_clip=1.0, dp_noise_multiplier=1.0, **fed_kw))
        anchor = pt.round_anchor(pstate)
        pstate = pt.aggregate(pstate, anchor=anchor, round_index=0)
        return next(iter(pstate.params.values()))[0].detach().clone()

    assert not torch.equal(agg_leaf({}), agg_leaf({}))
    assert torch.equal(agg_leaf({"dp_seed": 7}), agg_leaf({"dp_seed": 7}))
    # Rounds draw independent streams from one seed.
    g0, g1 = pdp.round_generator(7, 0, torch.device("cpu")), pdp.round_generator(7, 1, torch.device("cpu"))
    assert not torch.equal(torch.randn(8, generator=g0), torch.randn(8, generator=g1))


def test_poisson_masks_match_jax_and_empty_cohort_is_noop():
    fed_kw = dict(
        num_clients=2, rounds=3, participation=0.05, min_client_fraction=0.05, dp_clip=0.5,
        dp_noise_multiplier=0.3, dp_seed=0,
    )
    pt, pstate, jt, _ = _trainers(fed_kw)
    assert pt.cfg.fed.resolve_participation_mode() == "poisson"
    for r in range(50):
        np.testing.assert_array_equal(pt.participation_mask(r), jt.participation_mask(r))
    assert any(pt.participation_mask(r).sum() == 0 for r in range(3))
    train, evals = _data((8, 8), (3, 3), seed=6)
    pstate, history = pt.run(pstate, ppipeline.stack_clients_ragged(_port_splits(train)), _port_splits(evals))
    assert len(history) == 3
    assert all(np.isfinite(t.detach().numpy()).all() for t in pstate.params.values())


def test_poisson_ragged_empty_effective_cohort_is_noop():
    pt, pstate, jt, jstate = _trainers(
        dict(num_clients=2, participation=0.4, min_client_fraction=0.4, participation_mode="poisson")
    )
    r = next(r for r in range(1000) if float(pt.participation_mask(r).sum()) == 1.0)
    draw = pt.participation_mask(r)
    before = {n: t.detach().clone() for n, t in pstate.params.items()}
    out = pt.round_aggregate(pstate, round_index=r, base_mask=1.0 - draw)
    assert out is pstate and all(torch.equal(out.params[n], t) for n, t in before.items())
    assert jt.round_aggregate(jstate, round_index=r, base_mask=1.0 - draw) is jstate
    # An all-empty fleet is no sampling event: the survivor check aborts.
    with pytest.raises(RuntimeError, match="survived"):
        pt.round_aggregate(pstate, round_index=r, base_mask=np.zeros(2))
