"""The port's fold tree (relays, re-homing, degraded rounds) held against
the JAX package's.

* Every relay and re-home case of ``tests/test_fleet.py`` (the depth-2
  tree and the depth-3 replay bit-exact against ``aggregate_tree``, the sparse upward
  hop, the live 64-client tree, fold-order determinism, ``reply_via``
  refused under DP and secure aggregation, re-homing on a dial budget
  spent and on a mid-exchange death, the adoptive parent's refusal after
  folds, the re-homed assignment's replay, the subtree deadline, the
  prompt relay close, overlapping subtree claims, the counters and the
  parser) runs once with the JAX package's modules and once with the
  port's (``test_torch_secure.rebind``: every port server, relay and
  StreamAgg folds on the CPU). Each run asserts the JAX test's checks,
  and the two runs' server rounds are equal. The cases the JAX package
  marks slow run here unmarked, their 128-client fleets cut to 32 in
  both packages' copies (the two-killed-relays case keeps its 16 relays
  at two clients each). The live depth-3 round is not held against the
  JAX package: its own copy of it fails on the CPU (each mid relay
  forwards its leaf relays' ids, which are local to it, so the root sees
  clients 0 and 1 in both subtrees and fails the round as double-counted;
  the clients then wait out their timeout). The port's relays forward
  the client ids their subtree covers, and the JAX case, re-bound to the
  port, passes: crc-exact against the depth-3 ``aggregate_tree`` replay.
* Mixed trees: port relays under a JAX root and JAX relays under a port
  root, crc-equal to ``aggregate_tree``.
"""

import importlib
import threading

import numpy as np
import pytest

from test_torch_secure import JAX_PKG, PORT_ON_CPU, cases, jcomm, jwire, pcomm, rebind, run_both

#: The slow cases' fleets, cut to size in both packages' copies.
SMALLER = (
    ("rng, 128, 16, leaf_shape=(32,), chunk=128", "rng, 32, 8, leaf_shape=(32,), chunk=128"),
    ("for c in range(128)} == {", "for c in range(32)} == {"),
    ("n_clients, n_relays, per = 128, 16, 8", "n_clients, n_relays, per = 32, 16, 2"),
)
SUBS = ("comm", "faults", "cli", "obs")
#: The port's names for the JAX internals the cases poke: the meta keys
#: (``wire.META_*``) and a round's completed-upload set (``_Round.done``).
PORT_NAMES = (
    ("wire.REHOME_META_KEY", "wire.META_REHOMED"),
    ("wire.SUBTREE_IDS_META_KEY", "wire.META_SUBTREE_IDS"),
    ("0 in rnd.models", "0 in rnd.done"),
)
JAX_FLEET = rebind("test_fleet", subpackages=(), extra=SMALLER)
PORT_FLEET = rebind("test_fleet", subpackages=SUBS, extra=SMALLER, port_extra=PORT_NAMES)

RELAY_CASES = (
    "test_relay_depth2_bit_exact_vs_tree_replay",
    "test_relay_sparse_delta_base_tracks_root",
    "test_fleet_64_clients_depth2_live",
    "test_fold_order_determinism_64_contributors",
    "test_aggregate_tree_validates_groups",
    "test_aggregate_tree_nested_depth3_replay",
    "test_reply_via_refused_under_dp_and_secure",
    "test_relay_cli_parser_wiring",
    "test_fleet_128_clients_depth2_live",
    "test_rehome_on_dial_exhausted_converges_in_round",
    "test_rehome_on_mid_exchange_death_converges_in_round",
    "test_rehome_duplicate_after_fold_refused_on_adoptive_parent",
    "test_fold_order_determinism_rehomed_assignment",
    "test_subtree_deadline_sheds_locally_while_root_stays_green",
    "test_relay_close_aborts_parent_exchange_promptly",
    "test_root_refuses_overlapping_subtree_claims",
    "test_rehome_config_and_parser_wiring",
    "test_rehome_counters_on_default_registry",
    "test_fleet_128_clients_two_relays_killed",
)


@pytest.mark.parametrize("name,kwargs", cases(JAX_FLEET, RELAY_CASES))
def test_relay_case_held_against_jax(name, kwargs, tmp_path, monkeypatch):
    run_both(JAX_FLEET, PORT_FLEET, name, kwargs, tmp_path, monkeypatch)


def test_port_relay_depth3_live_bit_exact_vs_nested_replay():
    """``tests/test_fleet.py``'s live depth-3 round (8 clients under 4 leaf
    relays under 2 mid relays under a weighted root), re-bound to the
    port: every client and the root hold the nested replay's bits; and a
    mid relay's contributor record names the clients it covers."""
    PORT_FLEET.test_relay_depth3_live_bit_exact_vs_nested_replay(np.random.default_rng(0))


def test_relay_forwards_the_clients_its_subtree_covers():
    """A relay's upward contributor record expands each contributor that
    is itself a relay into that relay's own record (relay ids are local
    to their parent); plain clients stand for themselves."""
    seen = {}

    class Parent:
        last_exchange: dict = {}
        last_trace = (None, None)

        def exchange(self, agg, *, n_samples, meta):
            seen.update(meta)
            return agg

        def abort(self):
            pass

    relay = pcomm.RelayAggregator("127.0.0.1", 0, parent_host="127.0.0.1", parent_port=1, relay_id=0,
                                  num_clients=3, timeout=5, device="cpu")
    try:
        relay.parent = Parent()
        relay._forward({"w": np.zeros(2, np.float32)},
                       {"ids": [0, 1, 5], "n_samples": {0: 1, 1: 2, 5: 1}, "subtree_ids": {0: [2, 3], 1: [4]}})
    finally:
        relay.close()
    assert seen[pcomm.wire.META_SUBTREE_IDS] == [2, 3, 4, 5]


# ------------------------------------------------------------ mixed trees
def _tree(root_cls, relay_classes, client_classes, models, n_samples, per):
    """A depth-2 tree on loopback: ``root_cls`` serving ``len(relay_classes)``
    relays, ``per`` clients under each. Returns (root aggregate, replies,
    the root's recorded assignment)."""
    n_relays = len(relay_classes)
    root_out = {}
    with root_cls(port=0, num_clients=n_relays, weighted=True, timeout=30) as root:
        relays = [
            cls("127.0.0.1", 0, parent_host="127.0.0.1", parent_port=root.port, relay_id=r, num_clients=per, timeout=30)
            for r, cls in enumerate(relay_classes)
        ]
        try:
            rt = threading.Thread(target=lambda: root_out.__setitem__("agg", root.serve_round()), daemon=True)
            rt.start()
            for rel in relays:
                threading.Thread(target=rel.serve, args=(1,), daemon=True).start()
            replies = {}

            def go(cid):
                fc = client_classes[cid]("127.0.0.1", relays[cid // per].port, client_id=cid, timeout=30)
                replies[cid] = fc.exchange(models[cid], n_samples=n_samples[cid])

            ths = [threading.Thread(target=go, args=(c,), daemon=True) for c in range(len(models))]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=60)
            rt.join(timeout=60)
        finally:
            for rel in relays:
                rel.close()
        return root_out["agg"], replies, root.last_assignment


@pytest.mark.parametrize(
    "root,relays,clients",
    [
        ("jax", ("port", "port"), ("port", "jax", "port", "jax")),
        ("port", ("jax", "jax"), ("jax", "port", "jax", "port")),
        ("port", ("port", "jax"), ("port", "port", "jax", "jax")),
    ],
)
def test_mixed_tree_is_crc_equal_to_aggregate_tree(root, relays, clients):
    rng = np.random.default_rng(5)
    models = [{f"w{i}": rng.normal(size=(7, 3)).astype(np.float32) for i in range(3)} for _ in range(4)]
    n_samples = [3, 5, 2, 7]
    cls = {
        "jax": {"root": jcomm.AggregationServer, "relay": jcomm.RelayAggregator, "client": jcomm.FederatedClient},
        "port": {"root": PORT_ON_CPU["AggregationServer"], "relay": PORT_ON_CPU["RelayAggregator"],
                 "client": pcomm.FederatedClient},
    }
    agg, replies, assignment = _tree(
        cls[root]["root"], [cls[k]["relay"] for k in relays], [cls[k]["client"] for k in clients],
        models, n_samples, per=2,
    )
    assert assignment["groups"] == [[0, 1], [2, 3]]
    want = pcomm.aggregate_tree(models, [float(n) for n in n_samples], assignment["groups"])
    jwant = jcomm.aggregate_tree(models, [float(n) for n in n_samples], assignment["groups"])
    assert jwire.flat_crc32(want) == jwire.flat_crc32(jwant)
    assert jwire.flat_crc32({k: np.asarray(v, np.float32) for k, v in agg.items()}) == jwire.flat_crc32(want)
    assert {jwire.flat_crc32(pcomm.flatten_params(r)) for r in replies.values()} == {jwire.flat_crc32(want)}


def test_port_aggregate_tree_is_the_jax_replay():
    """``aggregate_tree`` at depths 1-3, with and without weights: the
    same bits as the JAX package's."""
    rng = np.random.default_rng(11)
    models = [{"a": rng.normal(size=(5,)).astype(np.float32), "b": rng.normal(size=(2, 2)).astype(np.float32)}
              for _ in range(6)]
    weights = [1.0, 4.0, 2.0, 3.0, 5.0, 1.5]
    jrelay = importlib.import_module(JAX_PKG + ".comm.relay")
    for groups in ([0, 1, 2], [[0, 1], [2, 3, 4], [5]], [[[0, 1], [2]], [[3, 4], [5]]]):
        for w in (None, weights):
            assert jwire.flat_crc32(pcomm.aggregate_tree(models, w, groups)) == jwire.flat_crc32(
                jrelay.aggregate_tree(models, w, groups)
            )
    with pytest.raises(ValueError):
        pcomm.aggregate_tree(models, None, [])
