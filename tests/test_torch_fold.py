"""The port's ordered fold (K4's plain version) and StreamAgg held against
the JAX package's, on the CPU.

* ``fold_ordered(device="cpu")`` and ``fold_reference`` are ``array_equal``
  to JAX ``fold_naive`` and ``fold_blocked`` on the property inputs of
  tests/test_wire_efficiency.py (K 1-8, sizes straddling the 32768-element
  block, scales 10^-4..10^4) and on subnormal inputs: the fold's contract
  is bit-exactness, so there is no tolerance.
* The port's ``StreamAgg`` gives one crc over shuffled arrival orders, equal
  to JAX ``aggregate_flat``'s, and the port's ``aggregate_flat`` equals
  JAX's bit for bit.
* Without CUDA, folding on the card raises; nothing falls back to the
  plain version, and a StreamAgg on the card fails its round loudly.
"""

import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    server as jserver,
    wire as jwire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops import (
    fold as jfold,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    server as pserver,
    wire as pwire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.stream_agg import (
    StreamAgg,
    StreamAggPoisoned,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    fold as pfold,
)

torch.set_num_threads(1)


def _property_cases(seed: int, n_cases: int = 6):
    """(leaves, weights) as tests/test_wire_efficiency.py draws them."""
    rng = np.random.default_rng(seed)
    for _ in range(n_cases):
        k = int(rng.integers(1, 9))
        n = int(rng.integers(1, 3 * jfold.FOLD_BLOCK_ELEMS))
        shape = (n,) if n % 2 else (2, n // 2)
        leaves = [
            (rng.normal(size=shape) * 10.0 ** rng.integers(-4, 5)).astype(np.float32)
            for _ in range(k)
        ]
        weights = [np.float32(w) for w in rng.random(k) + 0.05]
        yield leaves, weights


def _subnormal_case():
    rng = np.random.default_rng(11)
    # Leaves of ±1e-40 (subnormal in fp32) and normal values whose
    # products with the weights fall below 2^-126.
    leaves = [
        (rng.choice([-1.0, 1.0], size=4099) * 1e-40).astype(np.float32),
        (rng.normal(size=4099) * 1e-38).astype(np.float32),
        (rng.normal(size=4099) * 1e-3).astype(np.float32),
    ]
    weights = [np.float32(0.3), np.float32(0.6), np.float32(1e-36)]
    return leaves, weights


def _assert_matches_jax(leaves, weights):
    shape = leaves[0].shape
    flat = [a.reshape(-1) for a in leaves]
    want = jfold.fold_naive(flat, weights).reshape(shape)
    np.testing.assert_array_equal(jfold.fold_blocked(flat, weights).reshape(shape), want)
    got = pfold.fold_ordered(leaves, weights, device="cpu")
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    ref = pfold.fold_reference([torch.from_numpy(a) for a in leaves], weights)
    np.testing.assert_array_equal(ref.numpy(), want)
    stacked = pfold.fold_stacked(
        torch.from_numpy(np.stack(flat)), torch.tensor(np.asarray(weights, np.float32))
    )
    np.testing.assert_array_equal(stacked.numpy().reshape(shape), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_is_bit_exact_with_jax_on_property_inputs(seed):
    for leaves, weights in _property_cases(seed):
        _assert_matches_jax(leaves, weights)


def test_fold_keeps_subnormals_bit_exact():
    leaves, weights = _subnormal_case()
    want = jfold.fold_naive(leaves, weights)
    tiny = np.finfo(np.float32).tiny
    assert np.any((want != 0) & (np.abs(want) < tiny)), "the case must produce subnormal results"
    _assert_matches_jax(leaves, weights)


def test_fold_on_cpu_launches_no_kernel():
    before = pfold.FOLD_LAUNCHES
    leaves, weights = _subnormal_case()
    pfold.fold_ordered(leaves, weights, device="cpu")
    pfold.fold_stacked(torch.zeros(2, 5), torch.ones(2))
    assert pfold.FOLD_LAUNCHES == before
    assert pfold.engine_name("cpu") == "reference"
    assert pfold.engine_name("cuda") == "cuda"


def test_fold_on_the_card_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    leaves, weights = _subnormal_case()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pfold.fold_ordered(leaves, weights, device="cuda")
    # A StreamAgg folding on the card fails its round with the reason
    # attached; it never demotes to the plain version.
    st = StreamAgg(device="cuda")
    for cid in (0, 1):
        st.register(cid, keys=("w",), n_samples=1.0)
        st.add_dense(cid, {"w": leaves[cid]})
    with pytest.raises(StreamAggPoisoned, match="fold of 'w' failed"):
        st.finalize([0, 1], None)


def test_fold_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="at least one leaf"):
        pfold.fold_ordered([], [], device="cpu")
    with pytest.raises(ValueError, match="differ in size"):
        pfold.fold_ordered([np.zeros(3, np.float32), np.zeros(4, np.float32)], [1, 1], device="cpu")
    with pytest.raises(ValueError, match="fp32"):
        pfold.fold_stacked(torch.zeros(2, 3, dtype=torch.float64), torch.ones(2))
    with pytest.raises(ValueError, match="want x"):
        pfold.fold_stacked(torch.zeros(2, 3), torch.ones(3))


@pytest.mark.parametrize("weighted", [False, True])
def test_streamagg_one_crc_over_arrival_orders_equal_to_jax(weighted):
    rng = np.random.default_rng(5)
    n = 8
    keys = [f"w{i}" for i in range(3)]
    models = [
        {k: rng.normal(size=(64, 33)).astype(np.float32) for k in keys}
        for _ in range(n)
    ]
    weights = [float(w) for w in rng.integers(1, 9, size=n)] if weighted else None

    def crc(order, freeze_first):
        st = StreamAgg(device="cpu")
        for cid in order:
            st.register(cid, keys=keys, n_samples=weights[cid] if weights else 1.0)
        if freeze_first:  # fold as each key completes
            st.freeze(list(range(n)), weights)
        for cid in order:
            st.add_dense(cid, models[cid])
        out = st.finalize(list(range(n)), weights)
        stats = st.stats()
        assert stats["fold_engine"] == "reference" and stats["late_bytes"] + stats["early_bytes"] > 0
        return pwire.flat_crc32(out)

    orders = [list(range(n))]
    for _ in range(3):
        o = list(range(n))
        rng.shuffle(o)
        orders.append(o)
    crcs = {crc(o, freeze) for o in orders for freeze in (False, True)}
    want = jserver.aggregate_flat(models, weights)
    assert crcs == {jwire.flat_crc32(want)}
    got = pserver.aggregate_flat(models, weights)
    for key in keys:
        np.testing.assert_array_equal(got[key], want[key])


def test_streamagg_drop_and_duplicate_semantics():
    rng = np.random.default_rng(6)
    models = [{"w": rng.normal(size=7).astype(np.float32)} for _ in range(3)]
    st = StreamAgg(device="cpu")
    for cid in range(3):
        st.register(cid, keys=("w",), n_samples=1.0)
        st.add_dense(cid, models[cid])
    # Before any fold a dropped client leaves the survivors' exact mean.
    assert st.drop_client(2)
    got = st.finalize([0, 1], None)
    np.testing.assert_array_equal(got["w"], jserver.aggregate_flat(models[:2])["w"])
    assert sorted(st.client_stats()) == [0, 1]
    # After a fold consumed a client, its death poisons the round.
    st = StreamAgg(device="cpu")
    for cid in range(2):
        st.register(cid, keys=("w",), n_samples=1.0)
    st.freeze([0, 1], None)
    for cid in range(2):
        st.add_dense(cid, models[cid])
    assert not st.drop_client(1)
    with pytest.raises(StreamAggPoisoned, match="client 1 dropped"):
        st.finalize([0, 1], None)
