"""The port's TCP client slice held against the JAX package's, on the CPU.

* ``params_from_jax(host_params(state))`` returns the state bit for bit,
  and ``host_params`` is the JAX layout (the JAX init's keys and shapes);
* after ``adopt_aggregate`` of the same weights, a train step matches the
  JAX ``Trainer``'s at tests/test_torch_train.py's trajectory bounds (loss
  rtol 1e-5; params atol 2e-6 / rtol 1e-5), the step counter continuing
  (the warmup factor reads it);
* ``fit(epoch_offset=)`` draws the JAX batch order (same bounds);
* the port's ``client`` verb against a JAX ``serve``, and the port's
  ``serve`` verb against a JAX ``client``, each exit 0 with local and
  aggregated metrics CSVs.

Dropout is off where trajectories are compared: the two packages draw
dropout from different generators (tests/test_torch_dropout.py holds the
masks).
"""

import csv
import dataclasses
import math
import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    AggregationServer as JaxServer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data.pipeline import (
    TokenizedSplit as JaxSplit,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train import (
    engine as jengine,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
    TokenizedSplit,
    batch_iterator,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    flatten_tree,
    params_from_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
)

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
REFERENCE_COLUMNS = ["Accuracy", "Loss", "Precision", "Recall", "F1-Score"]


def _cfgs():
    port = pcfg.ModelConfig.tiny(**NO_DROP)
    return port, jcfg.ModelConfig(**dataclasses.asdict(port))


def _split(cfg, n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
    ids[:, 0] = 2  # [CLS]
    lengths = rng.integers(cfg.max_len // 3, cfg.max_len + 1, n)
    mask = (np.arange(cfg.max_len)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    return TokenizedSplit(ids, mask, labels)


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _assert_params_close(port_tree, jax_tree):
    got, want = flatten_tree(port_tree), flatten_tree(jax_tree)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=2e-6, rtol=1e-5, err_msg=name)


def test_host_params_round_trips_and_is_the_jax_layout():
    port_cfg, jax_cfg = _cfgs()
    trainer = Trainer(port_cfg, pcfg.TrainConfig(seed=1), device="cpu")
    state = trainer.init_state()
    host = trainer.host_params(state)
    want = flatten_tree(jax_init_params(JaxClassifier(jax_cfg), jax_cfg, jax.random.key(0)))
    got = flatten_tree(host)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())
    back = params_from_jax(host)
    assert back.keys() == state.params.keys()
    for name, t in state.params.items():
        assert torch.equal(back[name], t.detach())
    # Host copies: training on after the upload leaves them untouched.
    before = {k: v.copy() for k, v in got.items()}
    batch = next(batch_iterator(_split(port_cfg, 8, seed=2), 8, shuffle=False, seed=0))
    trainer.train_step(state, batch)
    for k, v in flatten_tree(host).items():
        np.testing.assert_array_equal(v, before[k])


def test_adopt_aggregate_then_a_step_matches_jax():
    port_cfg, jax_cfg = _cfgs()
    kw = dict(learning_rate=1e-3, seed=3, warmup_steps=4)
    jt = jengine.Trainer(jax_cfg, jcfg.TrainConfig(**kw))
    pt = Trainer(port_cfg, pcfg.TrainConfig(**kw), device="cpu")
    init = _host(jax_init_params(JaxClassifier(jax_cfg), jax_cfg, jax.random.key(4)))
    aggregate = _host(jax_init_params(JaxClassifier(jax_cfg), jax_cfg, jax.random.key(5)))
    batches = list(batch_iterator(_split(port_cfg, 24, seed=6), 8, shuffle=True, seed=7))
    jstate = jt.init_state(params=jax.tree.map(jnp.asarray, init))
    pstate = pt.init_state(params=params_from_jax(init))
    for batch in batches[:2]:
        jstate, _ = jt.train_step(jstate, batch)
        pstate, _ = pt.train_step(pstate, batch)
    jstate = jt.adopt_aggregate(jstate, jax.tree.map(jnp.asarray, aggregate))
    pstate = pt.adopt_aggregate(pstate, aggregate)
    assert pstate.step == int(jstate.step) == 2
    assert pstate.opt_state.count == 0
    assert all(float(m.abs().max()) == 0.0 for m in pstate.opt_state.mu.values())
    _assert_params_close(pt.host_params(pstate), jt.host_params(jstate))
    jstate, jloss = jt.train_step(jstate, batches[2])
    pstate, ploss = pt.train_step(pstate, batches[2])
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    assert pstate.step == int(jstate.step) == 3
    _assert_params_close(pt.host_params(pstate), jt.host_params(jstate))


def test_fit_epoch_offset_draws_the_jax_batch_order():
    port_cfg, jax_cfg = _cfgs()
    kw = dict(learning_rate=1e-3, seed=8, epochs_per_round=1, log_every=0)
    jt = jengine.Trainer(jax_cfg, jcfg.TrainConfig(**kw))
    pt = Trainer(port_cfg, pcfg.TrainConfig(**kw), device="cpu")
    init = _host(jax_init_params(JaxClassifier(jax_cfg), jax_cfg, jax.random.key(9)))
    split = _split(port_cfg, 24, seed=10)
    jsplit = JaxSplit(split.input_ids, split.attention_mask, split.labels)
    jstate, jlosses = jt.fit(jt.init_state(params=jax.tree.map(jnp.asarray, init)), jsplit, batch_size=8, epoch_offset=2)
    pstate, plosses = pt.fit(pt.init_state(params=params_from_jax(init)), split, batch_size=8, epoch_offset=2)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    _assert_params_close(pt.host_params(pstate), jt.host_params(jstate))
    # The offset is what moved the order: epoch 0 draws other batches.
    def order(epoch):
        return [b["input_ids"].tolist() for b in pt.epoch_batches(split, epoch, 8)]

    assert order(0) != order(2)


def _assert_reports(out, client_id):
    for phase in ("local", "aggregated"):
        with open(os.path.join(out, f"client{client_id}_{phase}_metrics.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 1 and list(rows[0]) == REFERENCE_COLUMNS
        assert all(math.isfinite(float(v)) for v in rows[0].values())


def test_port_client_verb_against_a_jax_server(tmp_path):
    out = str(tmp_path / "out")
    errs: list = []
    with JaxServer(port=0, num_clients=1, timeout=60, stream_chunk_bytes=0) as server:
        def serve():
            try:
                server.serve_round(deadline=60.0)
            except BaseException as e:  # checked below
                errs.append(e)

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        rc = main([
            "client", "--client-id", "0", "--port", str(server.port), "--host", "127.0.0.1",
            "--preset", "tiny", "--synthetic", "300", "--epochs", "1", "--device", "cpu",
            "--output-dir", out, "--timeout", "60",
        ])
        t.join(timeout=60)
    assert rc == 0 and not errs and not t.is_alive()
    _assert_reports(out, 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_port_serve_verb_against_a_jax_client(tmp_path):
    out = str(tmp_path / "out")
    port = _free_port()
    rcs: list = []
    t = threading.Thread(
        target=lambda: rcs.append(main([
            "serve", "--host", "127.0.0.1", "--port", str(port), "--num-clients", "1",
            "--timeout", "120", "--device", "cpu",
        ])),
        daemon=True,
    )
    t.start()
    rc = jax_main([
        "client", "--client-id", "0", "--port", str(port), "--host", "127.0.0.1",
        "--synthetic", "300", "--epochs", "1", "--output-dir", out, "--timeout", "120",
    ])
    t.join(timeout=120)
    assert rc == 0 and rcs == [0] and not t.is_alive()
    _assert_reports(out, 0)


def test_port_client_saves_twice_a_round_and_warm_starts(tmp_path):
    """``client --checkpoint-dir``: a save after local training and one
    after adopting the aggregate (meta ``aggregated``), numbered past the
    directory's latest step; a re-launch warm-starts from the latest."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.comm import (
        build_server,
        run_client,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
        Checkpointer,
    )

    ckpt_dir = str(tmp_path / "ck")

    def launch(rounds):
        server = build_server(build_parser().parse_args(
            ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "1", "--timeout", "60", "--device", "cpu"]
        ))
        with server:
            t = threading.Thread(target=server.serve, args=(rounds,), daemon=True)
            t.start()
            res = run_client(build_parser().parse_args([
                "client", "--client-id", "0", "--host", "127.0.0.1", "--port", str(server.port),
                "--preset", "tiny", "--synthetic", "300", "--epochs", "1", "--rounds", str(rounds),
                "--device", "cpu", "--timeout", "60", "--output-dir", str(tmp_path / "out"),
                "--checkpoint-dir", ckpt_dir,
            ]))
            t.join(timeout=60)
        assert not t.is_alive()
        return res

    first = launch(2)
    assert first["warm_step"] is None and first["saved_steps"] == [1, 2, 3, 4]
    assert first["seconds"]["save"] >= 0
    assert sorted(os.listdir(ckpt_dir), key=int) == ["2", "3", "4"]  # max_to_keep 3
    with Checkpointer(ckpt_dir) as ckpt:
        metas = {s: ckpt.restore_meta(step=s) for s in (2, 3, 4)}
        last = ckpt.restore(first["trainer"].init_state())
    assert [metas[s].get("aggregated", False) for s in (2, 3, 4)] == [True, False, True]
    assert all(m["kind"] == "local" and m["client_id"] == 0 for m in metas.values())
    # The last save is the adopted aggregate: a fresh Adam, the step going on.
    assert last.opt_state.count == 0 and last.step == first["state"].step
    for n, t in first["state"].params.items():
        assert torch.equal(last.params[n].detach(), t.detach())
    second = launch(1)
    assert second["warm_step"] == 4 and second["saved_steps"] == [5, 6]
    steps_per_epoch = first["state"].step // 2
    assert second["state"].step == first["state"].step + steps_per_epoch


def test_lazy_host_params_gather_on_first_read():
    """``host_params(lazy=True)``: the JAX layout's shapes before any
    gather, the same bits as the eager copies once read, one cached host
    copy per leaf that later training does not touch."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.convert import (
        HostLeaf,
    )

    port_cfg, _ = _cfgs()
    trainer = Trainer(port_cfg, pcfg.TrainConfig(seed=2), device="cpu")
    state = trainer.init_state()
    eager = flatten_tree(trainer.host_params(state))
    lazy = flatten_tree(trainer.host_params(state, lazy=True))
    assert lazy.keys() == eager.keys()
    assert all(isinstance(v, HostLeaf) for v in lazy.values())
    assert {k: v.shape for k, v in lazy.items()} == {k: v.shape for k, v in eager.items()}
    for k, v in lazy.items():
        got = np.asarray(v)
        assert got is np.asarray(v) and got.dtype == np.float32
        np.testing.assert_array_equal(got, eager[k])
        assert not np.shares_memory(np.array(v, copy=True), got)
    batch = next(batch_iterator(_split(port_cfg, 8, seed=3), 8, shuffle=False, seed=0))
    trainer.train_step(state, batch)
    for k, v in lazy.items():
        np.testing.assert_array_equal(np.asarray(v), eager[k])
