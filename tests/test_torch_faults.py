"""The port's fault harness held against the JAX package's.

* Every TCP case of ``tests/test_faults.py`` (a mid-upload crash, a
  corrupted stream, a silent client shed at the deadline, the duplicate
  connect probe, a reset then a retry, a throttled straggler, the dial
  backoff, a stress of concurrent clients), driven through the ported
  ``FaultProxy``, runs once with the JAX package's modules and once with
  the port's (``test_torch_secure.rebind``); each run asserts the JAX
  test's checks and the two runs' server rounds are equal.
* The proxy's plans, the personas' per-connection draws and the dead-relay
  kill threshold are the JAX package's for every seed.
* ``FederatedTrainer.run(fault_mask_fn=)`` held against the JAX trainer
  on the CPU, as ``tests/test_torch_federated.py`` holds ``run``: a
  dropped client is left out of the masked mean (each round's aggregate
  within that file's bounds), a round below ``min_client_fraction``
  raises, and a client dropped in round 0 rejoins in round 1.
"""

import importlib
import random

import numpy as np
import pytest
import torch

from test_torch_federated import (
    _assert_metrics_close,
    _assert_params_close,
    _capture,
    _data,
    _flat_jax,
    _jax_splits,
    _port_splits,
    _trainers,
    jpipeline,
    ppipeline,
)
from test_torch_secure import JAX_PKG, PORT_PKG, cases, rebind, run_both

JAX_FAULTS = importlib.import_module("test_faults")
PORT_FAULTS = rebind("test_faults", subpackages=("comm", "faults"))

TCP_CASES = (
    "test_server_survives_mid_upload_crash",
    "test_server_rejects_corrupted_stream_and_serves_survivor",
    "test_silent_client_excluded_at_deadline",
    "test_duplicate_connect_probe_race_is_harmless",
    "test_reset_mid_upload_then_retry_converges",
    "test_throttled_upload_is_a_straggler_not_a_dropout",
    "test_backoff_first_probe_is_reference_compatible",
    "test_backoff_schedule_deterministic_per_seed",
    "test_many_concurrent_clients_stress",
)


@pytest.mark.parametrize("name,kwargs", cases(JAX_FAULTS, TCP_CASES))
def test_fault_case_held_against_jax(name, kwargs, tmp_path, monkeypatch):
    run_both(JAX_FAULTS, PORT_FAULTS, name, kwargs, tmp_path, monkeypatch)


# ------------------------------------------------------- seeded plans
def _pkg(name):
    return (importlib.import_module(f"{JAX_PKG}.faults.{name}"), importlib.import_module(f"{PORT_PKG}.faults.{name}"))


@pytest.mark.parametrize("persona", ["honest", "lazy", "slow", "intermittent", "stale", "flaky-net"])
def test_persona_plans_draw_the_jax_faults(persona):
    """For every persona and seed, connection i's fault spec, the skipped
    rounds and the scaled work are the JAX package's."""
    jp, pp = _pkg("personas")
    jper, pper = jp.get_persona(persona), pp.get_persona(persona)
    assert vars(jper) == vars(pper) and pp.PERSONA_NAMES == jp.PERSONA_NAMES
    for seed in (0, 1, 7):
        jplan, pplan = jp.persona_plan(jper), pp.persona_plan(pper)
        jproxy = importlib.import_module(f"{JAX_PKG}.faults.proxy")
        for i in range(12):
            import zlib

            key = zlib.crc32(repr(((seed, 3), i)).encode("utf-8"))
            js, ps = jplan(i, random.Random(key)), pplan(i, random.Random(key))
            assert vars(js) == vars(ps) and js.faulty() == ps.faulty()
            assert isinstance(js, jproxy.FaultSpec)
        assert [jper.skips_round(r) for r in range(6)] == [pper.skips_round(r) for r in range(6)]
        assert [jper.scaled(u) for u in (1, 3, 8)] == [pper.scaled(u) for u in (1, 3, 8)]


def test_dead_relay_threshold_and_proxy_keying_match_jax():
    """The kill threshold and a static plan's per-connection spec, for
    several seeds, are the JAX package's."""
    jd, pd = _pkg("deadrelay")
    jx, px = _pkg("proxy")

    class _Relay:
        port = 1
        relay_id = 0

        def close(self):
            pass

    for seed in (0, 3, 42):
        jf, pf = jd.DeadRelayFault(_Relay(), seed=seed), pd.DeadRelayFault(_Relay(), seed=seed)
        try:
            assert jf.kill_after_bytes == pf.kill_after_bytes
        finally:
            jf.close()
            pf.close()
        plan = lambda i, rng: jx.FaultSpec(reset_after_bytes=rng.randrange(10, 99))  # noqa: E731
        pplan = lambda i, rng: px.FaultSpec(reset_after_bytes=rng.randrange(10, 99))  # noqa: E731
        with jx.FaultProxy("127.0.0.1", 1, plan=plan, seed=seed) as jp, px.FaultProxy(
            "127.0.0.1", 1, plan=pplan, seed=seed
        ) as pp:
            assert [vars(jp._spec_for(i)) for i in range(8)] == [vars(pp._spec_for(i)) for i in range(8)]


# ------------------------------------------- FederatedTrainer fault masks
FAULTS = np.array([1.0, 1.0, 0.0, 1.0])


def _run_both(fed_kw, fault_mask_fn, sizes=(9, 6, 7, 5)):
    train, evals = _data(sizes, (5, 4, 6, 3), seed=9)
    pt, pstate, jt, jstate = _trainers(dict(fed_kw, rounds=2))
    jaggs, paggs = [], []
    _capture(jt, jaggs, _flat_jax)
    _capture(pt, paggs, lambda p: {n: t.detach().clone() for n, t in p.items()})
    jstate, jhist = jt.run(
        jstate, jpipeline.stack_clients_ragged(_jax_splits(train)), _jax_splits(evals), fault_mask_fn=fault_mask_fn
    )
    pstate, phist = pt.run(
        pstate, ppipeline.stack_clients_ragged(_port_splits(train)), _port_splits(evals), fault_mask_fn=fault_mask_fn
    )
    return pt, pstate, phist, paggs, jhist, jaggs


@pytest.mark.parametrize("weighted", [False, True])
def test_run_with_fault_mask_matches_jax(weighted):
    """A client dropped in round 0 is left out of that round's masked mean
    and rejoins in round 1 (it adopted the round-0 aggregate with the
    rest), as in the JAX trainer."""
    _, pstate, phist, paggs, jhist, jaggs = _run_both(
        dict(num_clients=4, weighted=weighted, min_client_fraction=0.5),
        lambda r: FAULTS if r == 0 else None,
    )
    assert len(paggs) == len(jaggs) == len(phist) == len(jhist) == 2
    for r in range(2):
        _assert_params_close(paggs[r], jaggs[r], msg=f"round {r}")
        _assert_metrics_close(phist[r].aggregated_metrics, jhist[r].aggregated_metrics, f"round {r} aggregated")
    for t in pstate.params.values():
        assert all(torch.equal(t[c], t[0]) for c in range(t.shape[0]))
        assert torch.isfinite(t).all()


def test_fault_mask_below_quorum_fails_the_round():
    """Faults that leave fewer than ``min_client_fraction`` of the clients
    fail the round in both trainers."""
    with pytest.raises(RuntimeError, match="survived the round") as port_err:
        _run_both(dict(num_clients=4, min_client_fraction=0.75), lambda r: np.array([1.0, 0.0, 0.0, 1.0]))
    assert "survived the round" in str(port_err.value)
    pt, pstate, jt, jstate = _trainers(dict(num_clients=4, min_client_fraction=0.75, rounds=1))
    mask = np.array([1.0, 0.0, 0.0, 1.0])
    with pytest.raises(RuntimeError, match="survived the round"):
        jt.aggregate(jstate, client_mask=mask)
    with pytest.raises(RuntimeError, match="survived the round"):
        pt.aggregate(pstate, client_mask=mask)
    with pytest.raises(RuntimeError, match="survived the round"):
        pt.round_aggregate(pstate, round_index=0, faults=mask)
