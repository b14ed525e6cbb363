"""The port's sharded scorer (``ScoreEngine(mesh=)``) held against its
replicated engine and against the JAX package's sharded engine, on CPU
slots; the cases of ``tests/test_serving_fsdp.py`` (81-154):

* probabilities bit-identical to the replicated engine's at the bucket
  edges (n == 1, a full largest bucket, a padded mid-size), per-class
  softmax included, and within the serving bound (atol 2e-5) of the JAX
  sharded engine on the same weights;
* per-slot static bytes <= 0.6 of the replicated engine's;
* pad rows inert (three rows score the same bits alone as in a full
  batch);
* a batch past the largest bucket raises;
* a swap lands on the same layout and reuses every warm dispatch (no
  recompile event, the ``serving.gather`` site noted once);
* a sharded ``FleetReplica`` survives a rolling reload behind
  ``ServingFleet`` without a recompile.
"""

import importlib

import numpy as np
import pytest
import torch

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"

pcfg = importlib.import_module(PORT_PKG + ".config")
pmesh = importlib.import_module(PORT_PKG + ".parallel.mesh")
pserving = importlib.import_module(PORT_PKG + ".serving")
pconvert = importlib.import_module(PORT_PKG + ".models.convert")
pdata = importlib.import_module(PORT_PKG + ".data")

torch.set_num_threads(1)

BUCKETS = (1, 4, 8)
TEXTS = [
    f"Destination port is {p}. Flow duration is {d} microseconds. Total forward packets are {n}."
    for p, d, n in [(80, 100, 3), (443, 2500, 9), (8080, 7, 1)]
]


@pytest.fixture(scope="module")
def setup(eight_devices):
    """The JAX test's set-up: a tiny model's JAX init, carried to the
    port; a two-slot mesh in each package."""
    import jax

    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.config import (
        ModelConfig as JaxModelConfig,
        TrainConfig as JaxTrainConfig,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train.engine import (
        Trainer as JaxTrainer,
    )

    tok = pdata.default_tokenizer()
    jmodel = JaxModelConfig.tiny(vocab_size=len(tok.vocab))
    jparams = jax.tree.map(np.asarray, JaxTrainer(jmodel, JaxTrainConfig(), pad_id=tok.pad_id).init_state(seed=0).params)
    model_cfg = pcfg.ModelConfig.tiny(vocab_size=len(tok.vocab))
    params = pconvert.params_from_jax(jparams)
    return tok, model_cfg, params, pmesh.make_host_mesh(2, device="cpu"), jmodel, jparams, eight_devices


@pytest.fixture(scope="module")
def engines(setup):
    tok, model_cfg, params, mesh, *_ = setup
    rep = pserving.ScoreEngine(model_cfg, params, pad_id=tok.pad_id, buckets=BUCKETS, round_id=1, device="cpu")
    shard = pserving.ScoreEngine(model_cfg, params, pad_id=tok.pad_id, buckets=BUCKETS, round_id=1, mesh=mesh)
    return rep, shard


def _ragged_batch(model_cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    L = model_cfg.max_len
    ids = rng.integers(1, model_cfg.vocab_size, size=(n, L), dtype=np.int32)
    mask = np.ones_like(ids)
    mask[:, L // 2:] = 0
    return ids, mask


def test_sharded_probs_bit_identical_to_replicated_and_near_jax(engines, setup):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.parallel.mesh import (
        make_host_mesh as jax_host_mesh,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.serving import (
        ScoreEngine as JaxScoreEngine,
    )

    tok, model_cfg, _params, _mesh, jmodel, jparams, eight = setup
    rep, shard = engines
    jshard = JaxScoreEngine(jmodel, jparams, pad_id=tok.pad_id, buckets=BUCKETS, round_id=1,
                            mesh=jax_host_mesh(2, devices=eight[:2]))
    assert shard.device.type == "cpu" and shard.n_shards == 2
    for n in (1, BUCKETS[-1], 5):
        ids, mask = _ragged_batch(model_cfg, n, seed=n)
        p0, cp0, b0, r0 = rep.score(ids, mask)
        p1, cp1, b1, r1 = shard.score(ids, mask)
        assert b0 == b1 and r0 == r1 == 1
        np.testing.assert_array_equal(p0, p1)
        np.testing.assert_array_equal(cp0, cp1)
        pj, cpj, bj, _ = jshard.score(ids, mask)
        assert bj == b1
        np.testing.assert_allclose(p1, pj, atol=2e-5)
        np.testing.assert_allclose(cp1, cpj, atol=2e-5)


def test_sharded_static_bytes_are_split_per_slot(engines):
    rep, shard = engines
    rep_bytes = pmesh.device_tree_bytes(rep.snapshot()[0])
    shard_bytes = pmesh.device_tree_bytes(shard.snapshot()[0])
    assert rep_bytes > 0 and shard_bytes / rep_bytes <= 0.6
    assert all(isinstance(v, pmesh.ShardedLeaf) for v in shard.snapshot()[0].values())


def test_sharded_pad_rows_do_not_perturb_probs(engines, setup):
    _tok, model_cfg, *_ = setup
    _rep, shard = engines
    ids, mask = _ragged_batch(model_cfg, 8, seed=3)
    alone, cp_alone, _, _ = shard.score(ids[:3], mask[:3])
    full, cp_full, _, _ = shard.score(ids, mask)
    np.testing.assert_array_equal(alone, full[:3])
    np.testing.assert_array_equal(cp_alone, cp_full[:3])


def test_sharded_bucket_overflow_raises(engines, setup):
    _tok, model_cfg, *_ = setup
    _rep, shard = engines
    ids, mask = _ragged_batch(model_cfg, BUCKETS[-1] + 1)
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        shard.score(ids, mask)


def test_sharded_swap_reuses_warm_programs(setup):
    tok, model_cfg, params, mesh, *_ = setup
    eng = pserving.ScoreEngine(model_cfg, params, pad_id=tok.pad_id, buckets=BUCKETS, mesh=mesh)
    eng.warmup()
    new_params = {k: v + np.float32(1e-3) for k, v in params.items()}
    eng.swap(new_params, round_id=2)
    ref = pserving.ScoreEngine(model_cfg, new_params, pad_id=tok.pad_id, buckets=BUCKETS, device="cpu")
    for n in (1, 3, 8):
        ids, mask = _ragged_batch(model_cfg, n, seed=n)
        got, _, _, rid = eng.score(ids, mask)
        assert rid == 2
        np.testing.assert_array_equal(got, ref.score(ids, mask)[0])
    assert eng.ledger.recompiles() == []
    assert all(v == 1 for v in eng.compile_counts.values())
    assert eng.ledger.compile_counts("serving.gather") == {("gather",): 1}
    with pytest.raises(KeyError, match="differ"):
        eng.swap({k: v for k, v in list(params.items())[1:]}, round_id=3)


def test_sharded_replica_rolling_reload_keeps_warm(setup):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.router.fleet import (
        FleetReplica,
        ServingFleet,
    )

    tok, model_cfg, params, mesh, *_ = setup
    rep = FleetReplica(
        0, model_cfg, params, tok, round_id=1, buckets=(1, 4), gather_window_s=0.002, mesh=mesh
    ).start()
    assert rep.engine.mesh is mesh
    fleet = ServingFleet([rep], probe_interval_s=0.2).start()
    try:
        rep.engine.warmup()
        with pserving.ScoringClient("127.0.0.1", fleet.port) as cli:
            assert cli.score(text=TEXTS[0])["round"] == 1
            new_params = {k: v + np.float32(1e-3) for k, v in params.items()}
            sweep = fleet.rolling_reload(new_params, round_id=2)
            assert [s["replica"] for s in sweep["replicas"]] == [0]
            assert cli.score(text=TEXTS[1])["round"] == 2
        assert rep.engine.ledger.recompiles() == []
    finally:
        fleet.close()


def test_infer_serve_fsdp_flags(tmp_path):
    """``infer-serve --data-parallel N --fsdp`` builds the sharded engine
    over CPU slots; the refusals are the JAX CLI's."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
        build_server,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
        init_params,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry import (
        ModelRegistry,
    )

    tok = pdata.default_tokenizer()
    cfg = pcfg.ModelConfig.tiny(vocab_size=len(tok.vocab))
    reg = ModelRegistry(str(tmp_path / "reg"))
    aid = reg.add(init_params(cfg, torch.Generator().manual_seed(0)), round_index=1, model_config=cfg)
    reg.promote(aid, to="serving")
    base = ["infer-serve", "--registry-dir", str(tmp_path / "reg"), "--port", "0", "--device", "cpu"]
    server = build_server(build_parser().parse_args([*base, "--data-parallel", "2", "--fsdp"]))
    assert server.engine.n_shards == 2 and server.engine.mesh.slots() == [torch.device("cpu")] * 2
    for bad, msg in ((["--data-parallel", "1", "--fsdp"], "N >= 2"), (["--fsdp"], "N >= 2"),
                     (["--data-parallel", "2"], "fleet --replicas N"), (["--data-parallel", "9", "--fsdp"], "needs 9 local")):
        with pytest.raises(SystemExit, match=msg):
            build_server(build_parser().parse_args([*base, *bad]))
