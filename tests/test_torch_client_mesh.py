"""The meshed TCP client (``client --data-parallel N [--fsdp]``) held
against the JAX package's and the single-device client, on CPU slots.

Mirrors ``tests/test_client_mesh.py`` and ``tests/test_mesh_fsdp.py``
with dropout off (the two packages' dropout streams differ, and the
port's slots draw their own streams):

* ``make_client_trainer`` dispatches as the JAX one does;
* ``MeshTrainer`` on 2 and 4 slots against the port's one-device
  ``Trainer`` and against the JAX ``MeshTrainer`` on the 8-device host
  mesh (same weights carried across, same batches): losses rtol 1e-5,
  params atol 2e-6 / rtol 1e-5, the JAX tests' bounds
  (``test_client_mesh.py:131-137``, ``test_mesh_fsdp.py:169-175``);
* ``FsdpMeshTrainer``: per-slot static bytes <= 0.6 of the replicated
  mesh's and kept by a step; the same trajectory bounds against the
  replicated mesh; host gather -> adopt -> host gather byte- and
  crc-exact (``test_client_mesh.py:140``); reply leaves scattered onto
  their shards; a checkpoint round trip bit-exact;
* a live TCP round where the client runs ``--data-parallel 2 --fsdp
  --device cpu`` against the single-device round (two rounds, the second
  reply streamed into the sink), and a mixed secure-agg + central-DP
  round (``test_client_mesh.py:186-237``).
"""

import csv
import dataclasses
import importlib
import json
import os
import threading

import numpy as np
import pytest
import torch

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"

jcfg = importlib.import_module(JAX_PKG + ".config")
pcfg = importlib.import_module(PORT_PKG + ".config")
pmesh = importlib.import_module(PORT_PKG + ".parallel.mesh")
pcm = importlib.import_module(PORT_PKG + ".train.client_mesh")
pengine = importlib.import_module(PORT_PKG + ".train.engine")
pconvert = importlib.import_module(PORT_PKG + ".models.convert")
pwire = importlib.import_module(PORT_PKG + ".comm.wire")
pdata = importlib.import_module(PORT_PKG + ".data")
ppipe = importlib.import_module(PORT_PKG + ".data.pipeline")

torch.set_num_threads(1)

L = 32
NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
CPU = torch.device("cpu")


def _cfg(mod, tok, *, data=1, fsdp=False, clients=1):
    model = mod.ModelConfig.tiny(vocab_size=len(tok.vocab), max_len=L, max_position_embeddings=2 * L, **NO_DROP)
    return mod.ExperimentConfig(
        model=model,
        data=mod.DataConfig(max_len=L, batch_size=8, data_fraction=0.3),
        train=mod.TrainConfig(prng_impl="threefry2x32", epochs_per_round=1, learning_rate=1e-3, log_every=0),
        fed=mod.FedConfig(num_clients=clients),
        mesh=mod.MeshConfig(clients=clients, data=data, fsdp=fsdp),
    )


@pytest.fixture(scope="module")
def tok():
    return pdata.default_tokenizer()


@pytest.fixture(scope="module")
def client_data(tok):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.cicids import (
        make_all_client_splits,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.synthetic import (
        make_synthetic,
    )

    cfg = _cfg(pcfg, tok)
    splits = make_all_client_splits(make_synthetic("cicids2017", 400, seed=42), 1, cfg.data)
    return ppipe.tokenize_client(splits[0], tok, max_len=L)


def _slots(n):
    return pmesh.make_host_mesh(n, device="cpu")


def _assert_params_close(got: dict, want: dict):
    got, want = pwire.flatten_params(got), pwire.flatten_params(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-6, rtol=1e-5, err_msg=k)


def _assert_metrics_equal(got: dict, want: dict):
    for k in ("Accuracy", "Precision", "Recall", "F1-Score"):
        assert got[k] == want[k], (k, got[k], want[k])
    np.testing.assert_allclose(got["Loss"], want["Loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["confusion_matrix"], want["confusion_matrix"])


def test_make_client_trainer_dispatch(tok):
    cfg = _cfg(pcfg, tok)
    assert type(pcm.make_client_trainer(cfg, device="cpu")) is pengine.Trainer
    t = pcm.make_client_trainer(_cfg(pcfg, tok, data=2), device="cpu")
    assert type(t) is pcm.MeshTrainer and t.mesh.shape["data"] == 2 and t.slots == [CPU, CPU]
    t = pcm.make_client_trainer(_cfg(pcfg, tok, data=2, fsdp=True), device="cpu")
    assert isinstance(t, pcm.FsdpMeshTrainer) and t.n_shards == 2
    with pytest.raises(ValueError, match="batch_size"):
        pcm.make_client_trainer(_cfg(pcfg, tok, data=3), device="cpu")  # 8 % 3 != 0
    with pytest.raises(ValueError, match="devices"):
        pcm.make_client_trainer(dataclasses.replace(_cfg(pcfg, tok, data=2), mesh=pcfg.MeshConfig(clients=1, data=16),
                                                    data=pcfg.DataConfig(max_len=L, batch_size=16)), device="cpu")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cls_name", ["MeshTrainer", "FsdpMeshTrainer"])
def test_meshed_trajectory_matches_one_device_and_jax(tok, client_data, eight_devices, n, cls_name):
    """The meshed trainer on n CPU slots against the port's one-device
    Trainer (fit + evaluate over the split, the JAX test's comparison),
    FSDP also against the replicated mesh, and, step by step, against the
    JAX trainer of the same name on a host mesh of the 8 devices with the
    same weights and batches."""
    import jax
    import jax.numpy as jnp

    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.parallel.mesh import (
        make_host_mesh as jax_host_mesh,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train import (
        client_mesh as jcm,
    )

    cfg = _cfg(pcfg, tok)
    jc = _cfg(jcfg, tok)
    plain = pengine.Trainer(cfg.model, cfg.train, pad_id=tok.pad_id, device="cpu")
    s0, _ = plain.fit(plain.init_state(), client_data.train, batch_size=8)
    meshed = getattr(pcm, cls_name)(cfg.model, cfg.train, mesh=_slots(n), pad_id=tok.pad_id)
    sn, _ = meshed.fit(meshed.init_state(), client_data.train, batch_size=8)
    _assert_metrics_equal(meshed.evaluate_state(sn, client_data.test), plain.evaluate_state(s0, client_data.test))
    _assert_params_close(meshed.host_params(sn), plain.host_params(s0))
    if cls_name == "FsdpMeshTrainer":  # and against the replicated mesh
        rep = pcm.MeshTrainer(cfg.model, cfg.train, mesh=_slots(n), pad_id=tok.pad_id)
        sr, _ = rep.fit(rep.init_state(), client_data.train, batch_size=8)
        _assert_metrics_equal(meshed.evaluate_state(sn, client_data.test), rep.evaluate_state(sr, client_data.test))
        _assert_params_close(meshed.host_params(sn), rep.host_params(sr))

    # Against the JAX package's meshed trainer, from the JAX init.
    jt = getattr(jcm, cls_name)(jc.model, jc.train, mesh=jax_host_mesh(n, devices=eight_devices[:n]), pad_id=tok.pad_id)
    jstate = jt.init_state(seed=3)
    # Host copies: the JAX step donates its state's buffers.
    jparams = jax.tree.map(np.asarray, jt.host_params(jstate))
    pstate = meshed.init_state(params=pconvert.params_from_jax(jparams))
    batches = list(ppipe.batch_iterator(client_data.train, 8, shuffle=True, seed=6))[:5]
    for i, batch in enumerate(batches):
        jstate, jloss = jt.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, ploss = meshed.train_step(pstate, batch)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5, err_msg=f"step {i}")
    _assert_params_close(meshed.host_params(pstate), jax.tree.map(np.asarray, jt.host_params(jstate)))


def test_fsdp_static_state_shards_at_rest(tok):
    cfg = _cfg(pcfg, tok)
    rep = pcm.MeshTrainer(cfg.model, cfg.train, mesh=_slots(2), pad_id=tok.pad_id)
    fsdp = pcm.FsdpMeshTrainer(cfg.model, cfg.train, mesh=_slots(2), pad_id=tok.pad_id)
    sr, sf = rep.init_state(), fsdp.init_state()
    rep_bytes = pmesh.device_tree_bytes((sr.params, sr.opt_state))
    fsdp_bytes = pmesh.device_tree_bytes((sf.params, sf.opt_state))
    assert fsdp_bytes / rep_bytes <= 0.6, (fsdp_bytes, rep_bytes)
    assert all(isinstance(v, pmesh.ShardedLeaf) for v in sf.params.values())
    assert any(v.dim is not None for v in sf.params.values())
    rng = np.random.default_rng(0)
    batch = {
        "input_ids": rng.integers(0, cfg.model.vocab_size, (8, L)).astype(np.int32),
        "attention_mask": np.ones((8, L), np.int32),
        "labels": rng.integers(0, 2, 8).astype(np.int32),
    }
    sf2, _ = fsdp.train_step(sf, batch)
    assert pmesh.device_tree_bytes((sf2.params, sf2.opt_state)) == fsdp_bytes
    # The per-slot gauge (the JAX package's fedtpu_fsdp_static_state_bytes).
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.obs.metrics import (
        default_registry,
    )

    line = [ln for ln in default_registry().render().splitlines() if ln.startswith("fedtpu_fsdp_static_state_bytes ")]
    assert len(line) == 1 and float(line[0].split()[1]) == float(fsdp_bytes)


@pytest.mark.parametrize("cls_name", ["MeshTrainer", "FsdpMeshTrainer"])
def test_gather_scatter_is_byte_exact(tok, cls_name):
    """init -> gather and adopt-aggregate -> gather round trips are
    byte- and crc-exact, so masking and noising see the flat vector a
    single-device client would produce."""
    cfg = _cfg(pcfg, tok)
    plain = pengine.Trainer(cfg.model, cfg.train, pad_id=tok.pad_id, device="cpu")
    meshed = getattr(pcm, cls_name)(cfg.model, cfg.train, mesh=_slots(2), pad_id=tok.pad_id)
    p0 = pwire.flatten_params(plain.host_params(plain.init_state()))
    pm = pwire.flatten_params(meshed.host_params(meshed.init_state()))
    for k in p0:
        np.testing.assert_array_equal(p0[k], pm[k])
    rng = np.random.default_rng(7)
    agg = pwire.unflatten_params({k: (v + rng.normal(0, 0.01, v.shape)).astype(v.dtype) for k, v in p0.items()})
    state = meshed.adopt_aggregate(meshed.init_state(), agg)
    back = meshed.host_params(state)
    lazy = meshed.host_params(state, lazy=True)
    assert pwire.flat_crc32(pwire.flatten_params(agg)) == pwire.flat_crc32(pwire.flatten_params(back))
    assert pwire.flat_crc32(pwire.flatten_params(lazy)) == pwire.flat_crc32(pwire.flatten_params(back))
    assert state.step == 0
    # Leaves the reply sink placed adopt to the same bytes.
    sunk = pwire.unflatten_params({k: meshed.reply_leaf_sink(k, v) for k, v in pwire.flatten_params(agg).items()})
    again = meshed.host_params(meshed.adopt_aggregate(meshed.init_state(), sunk))
    assert pwire.flat_crc32(pwire.flatten_params(again)) == pwire.flat_crc32(pwire.flatten_params(agg))
    m_host = meshed.evaluate(agg, _tiny_split(cfg), batch_size=8)
    m_sunk = meshed.evaluate(sunk, _tiny_split(cfg), batch_size=8)
    assert m_host["Loss"] == m_sunk["Loss"]


def _tiny_split(cfg):
    rng = np.random.default_rng(1)
    ids = rng.integers(5, cfg.model.vocab_size, (12, L)).astype(np.int32)
    return ppipe.TokenizedSplit(ids, np.ones_like(ids), rng.integers(0, 2, 12).astype(np.int32))


def test_fsdp_reply_leaf_sink_scatters_onto_shards(tok):
    cfg = _cfg(pcfg, tok)
    fsdp = pcm.FsdpMeshTrainer(cfg.model, cfg.train, mesh=_slots(2), pad_id=tok.pad_id)
    arr = np.arange(32, dtype=np.float32).reshape(8, 4)
    placed = fsdp.reply_leaf_sink("encoder/x/kernel", arr)  # a kernel: the port's [out, in]
    assert isinstance(placed, pmesh.ShardedLeaf) and placed.dim == 1 and tuple(placed.shape) == (4, 8)
    np.testing.assert_array_equal(placed.gather("cpu").numpy(), arr.T)
    small = np.arange(3, dtype=np.float32)
    placed_small = fsdp.reply_leaf_sink("encoder/x/bias", small)
    assert placed_small.dim is None
    np.testing.assert_array_equal(placed_small.gather("cpu").numpy(), small)
    assert fsdp.leaf_sharding((8, 4))[0] == 0 and fsdp.leaf_sharding((3,))[0] is None


def test_fsdp_checkpoint_round_trip_bit_exact(tok, client_data, tmp_path):
    """shard -> save -> restore -> shard: the restore template is the FSDP
    init_state, so leaves land back on their shards; params and moments
    leaf-bit-exact."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
        Checkpointer,
        maybe_warm_start,
    )

    cfg = _cfg(pcfg, tok)
    fsdp = pcm.FsdpMeshTrainer(cfg.model, cfg.train, mesh=_slots(2), pad_id=tok.pad_id)
    state, _ = fsdp.fit(fsdp.init_state(), client_data.train, batch_size=8)
    with Checkpointer(str(tmp_path / "ck")) as ckpt:
        ckpt.save(1, state)
    restored, step = maybe_warm_start(str(tmp_path / "ck"), fsdp.init_state())
    assert step == 1 and restored.step == state.step
    for group in ("params",):
        for n, leaf in getattr(restored, group).items():
            assert isinstance(leaf, pmesh.ShardedLeaf) and leaf.dim == state.params[n].dim
    for a, b in ((state.params, restored.params), (state.opt_state.mu, restored.opt_state.mu),
                 (state.opt_state.nu, restored.opt_state.nu)):
        for n in a:
            assert torch.equal(a[n].gather("cpu"), b[n].gather("cpu")), n
    # A sharded state saves the file a one-device state saves: the plain
    # trainer restores it.
    plain = pengine.Trainer(cfg.model, cfg.train, pad_id=tok.pad_id, device="cpu")
    p, _ = maybe_warm_start(str(tmp_path / "ck"), plain.init_state())
    assert all(torch.equal(p.params[n], state.params[n].gather("cpu")) for n in p.params)


# ------------------------------------------------------------- live rounds
def _write_cfg(tmp_path, cfg, name):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f)
    return path


def _read_metrics_csv(path):
    with open(path) as f:
        return dict(next(iter(csv.DictReader(f))))


def _serve(server, rounds, errs):
    def _go():
        try:
            server.serve(rounds=rounds)
        except Exception as e:  # surfaced by the asserting main thread
            errs.append(e)

    t = threading.Thread(target=_go, daemon=True)
    t.start()
    return t


def test_fsdp_client_tcp_rounds_match_single_device(tok, tmp_path):
    """Live server + ``client --data-parallel 2 --fsdp --device cpu`` for
    two rounds (the second reply streams onto the shards) against the
    single-device client on the same config and data: local and
    aggregated metrics equal (Loss rtol 1e-5), the JAX test's check."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.comm import (
        run_client,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
        AggregationServer,
    )

    cfg_path = _write_cfg(tmp_path, _cfg(jcfg, tok), "cfg.json")  # a JAX-written config
    outs, runs = {}, {}
    for name, extra in (("single", []), ("fsdp", ["--data-parallel", "2", "--fsdp"])):
        out = str(tmp_path / name)
        outs[name] = out
        errs: list = []
        with AggregationServer(port=0, num_clients=1, timeout=60, device="cpu") as server:
            st = _serve(server, 2, errs)
            runs[name] = run_client(build_parser().parse_args([
                "client", "--client-id", "0", "--host", "127.0.0.1", "--port", str(server.port), "--config", cfg_path,
                "--synthetic", "400", "--output-dir", out, "--timeout", "60", "--rounds", "2", "--device", "cpu",
                *extra,
            ]))
            st.join(timeout=60)
        assert not errs, errs
    fsdp = runs["fsdp"]
    assert isinstance(fsdp["trainer"], pcm.FsdpMeshTrainer)
    assert fsdp["rounds"][-1]["exchange"]["reply_shape"] == "stream"
    sunk = pwire.flatten_params(fsdp["rounds"][-1]["aggregate"], leaf_fn=lambda x: x)
    assert {type(v) for v in sunk.values()} == {pmesh.ShardedLeaf}
    for phase in ("local", "aggregated"):
        a = _read_metrics_csv(os.path.join(outs["single"], f"client0_{phase}_metrics.csv"))
        b = _read_metrics_csv(os.path.join(outs["fsdp"], f"client0_{phase}_metrics.csv"))
        assert set(a) == set(b)
        for k in a:
            if k == "Loss":
                np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5, err_msg=(phase, k))
            else:
                assert a[k] == b[k], (phase, k, a[k], b[k])


@pytest.mark.parametrize("extra", [["--data-parallel", "2"], ["--data-parallel", "2", "--fsdp"]])
def test_meshed_client_composes_with_secure_agg_and_dp(tok, tmp_path, monkeypatch, extra):
    """--secure-agg + --dp with a mixed fleet: client 0 single-device,
    client 1 meshed, one live secure DP round. The server rejects a round
    whose clients upload different DP bases, so completion proves the
    meshed client's host gather is byte-identical to the single-device
    client's."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
        AggregationServer,
    )

    monkeypatch.delenv("FEDTPU_SECRET", raising=False)
    monkeypatch.delenv("FEDTPU_CLIENT_SECRET", raising=False)
    cfg_path = _write_cfg(tmp_path, _cfg(pcfg, tok, clients=2), "cfg2.json")
    out = str(tmp_path / "compose")
    errs: list = []
    results: dict = {}
    with AggregationServer(port=0, num_clients=2, timeout=90, secure_agg=True, dp_clip=1.0,
                           dp_noise_multiplier=0.05, device="cpu") as server:
        st = _serve(server, 1, errs)
        base = ["--host", "127.0.0.1", "--port", str(server.port), "--config", cfg_path, "--synthetic", "400",
                "--output-dir", out, "--timeout", "90", "--secure-agg", "--dp", "--device", "cpu"]

        def _meshed():
            try:
                results["meshed"] = main(["client", "--client-id", "1", *extra, *base])
            except BaseException as e:  # surfaced below
                results["meshed"] = e

        c1 = threading.Thread(target=_meshed, daemon=True)
        c1.start()
        results["single"] = main(["client", "--client-id", "0", *base])
        c1.join(timeout=120)
        st.join(timeout=60)
    assert results["single"] == 0 and results["meshed"] == 0, results
    assert not errs, errs
    for c in (0, 1):
        assert os.path.exists(os.path.join(out, f"client{c}_aggregated_metrics.csv"))
