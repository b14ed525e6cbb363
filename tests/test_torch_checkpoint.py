"""The port's checkpoint and warm start held against the JAX package's,
on the CPU.

* tests/test_checkpoint.py's cases on the port: the full-state round trip
  (params, moments, count, step and the dropout generator), the meta,
  ``max_to_keep``, warm start absent / present / incompatible, and an
  empty directory that raises;
* resume ≡ uninterrupted: k steps, save, warm start into a fresh
  trainer, n − k steps give the same bits as n steps, dropout on;
* the port's k steps + save + warm start + (n − k) steps against the JAX
  ``Trainer``'s n uninterrupted steps, dropout off, at
  tests/test_torch_train.py's trajectory bounds (loss rtol 1e-5, params
  atol 2e-6 / rtol 1e-5);
* the generator rule across device types: a state saved with a
  generator of another device type restores its params, moments and
  step, and the trainer's freshly seeded generator, with a warning;
* the federated state: a ``FedState`` round trip (stacked params and
  moments, per-client counts and generators, the server optimizer), and
  ``federated`` run as 1 + 1 rounds with a warm start giving the bits of
  2 uninterrupted rounds, dropout on.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    flatten_tree,
    params_from_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    checkpoint as ckpt_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
    Checkpointer,
    latest_finalized_step,
    maybe_warm_start,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
)

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)


def _trainer(**model_kw):
    return Trainer(pcfg.ModelConfig.tiny(**model_kw), pcfg.TrainConfig(seed=3), device="cpu")


def _batches(cfg, n, seed=0, bs=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(5, cfg.vocab_size, (bs, cfg.max_len)).astype(np.int32)
        ids[:, 0] = 2
        lengths = rng.integers(cfg.max_len // 3, cfg.max_len + 1, bs)
        mask = (np.arange(cfg.max_len)[None, :] < lengths[:, None]).astype(np.int32)
        ids[mask == 0] = 0
        out.append({"input_ids": ids, "attention_mask": mask, "labels": rng.integers(0, 2, bs).astype(np.int32)})
    return out


def _assert_state_equal(a, b):
    assert a.params.keys() == b.params.keys()
    for n in a.params:
        assert torch.equal(a.params[n].detach(), b.params[n].detach()), n
    assert a.opt_state.count == b.opt_state.count
    for x, y in ((a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu)):
        assert x.keys() == y.keys() and all(torch.equal(x[n], y[n]) for n in x)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_single_client_roundtrip(tmp_path):
    trainer = _trainer()
    state = trainer.init_state(seed=0)
    batch = _batches(trainer.model_cfg, 1)[0]
    for _ in range(3):
        state, _ = trainer.train_step(state, batch)
    with Checkpointer(str(tmp_path / "ckpt")) as ckpt:
        ckpt.save(state.step, state, meta={"round": 1})
        ckpt.wait()
        restored = ckpt.restore(trainer.init_state(seed=0))
        assert ckpt.restore_meta() == {"round": 1}
        assert ckpt.latest_step() == 3
    _assert_state_equal(restored, state)
    assert all(p.requires_grad for p in restored.params.values())
    # Finished steps only: a tmp directory is not a step.
    os.makedirs(tmp_path / "ckpt" / "9.tmp-1")
    assert latest_finalized_step(str(tmp_path / "ckpt")) == 3
    # The meta records the leaf shapes in a fixed order.
    with open(tmp_path / "ckpt" / "3" / "meta.json") as f:
        shapes = json.load(f)["_leaf_shapes"]
    assert shapes[0] == list(next(iter(state.params.values())).shape) and shapes[-2:] == [[], []]
    # Resumed training continues identically to uninterrupted training.
    _, loss_a = trainer.train_step(state, batch)
    _, loss_b = trainer.train_step(restored, batch)
    assert float(loss_a) == float(loss_b)


def test_max_to_keep_garbage_collects(tmp_path):
    trainer = _trainer()
    state = trainer.init_state(seed=0)
    with Checkpointer(str(tmp_path / "gc"), max_to_keep=2) as ckpt:
        for step in range(4):
            ckpt.save(step, state)
        assert ckpt.latest_step() == 3
        assert sorted(os.listdir(tmp_path / "gc")) == ["2", "3"]
        restored = ckpt.restore(trainer.init_state(seed=0), step=3)
        with pytest.raises(FileNotFoundError):
            ckpt.restore(trainer.init_state(seed=0), step=0)  # collected
        # A step that exists is never overwritten.
        ckpt.save(3, trainer.init_state(seed=5))
        _assert_state_equal(ckpt.restore(trainer.init_state(seed=0), step=3), restored)
    _assert_state_equal(restored, state)


def test_warm_start_absent_and_present(tmp_path):
    trainer = _trainer()
    template = trainer.init_state(seed=0)
    state, step = maybe_warm_start(str(tmp_path / "nope"), template)
    assert state is None and step is None
    assert not os.path.exists(tmp_path / "nope")  # not created
    os.makedirs(tmp_path / "empty")
    assert maybe_warm_start(str(tmp_path / "empty"), template) == (None, None)

    trained, _ = trainer.train_step(trainer.init_state(seed=0), _batches(trainer.model_cfg, 1)[0])
    with Checkpointer(str(tmp_path / "warm")) as ckpt:
        ckpt.save(7, trained)
    state, step = maybe_warm_start(str(tmp_path / "warm"), template)
    assert step == 7
    _assert_state_equal(state, trained)


@pytest.mark.parametrize("change", ["vocab", "swap_tables", "trainable", "corrupt", "no_leaf_shapes"])
def test_warm_start_incompatible_checkpoint_degrades_to_fresh(tmp_path, change, caplog):
    """A checkpoint saved under another shape, another set of trained
    leaves, one that does not load, or one whose meta lacks the leaf
    shapes every save records warm-starts as (None, None)."""
    old = Trainer(pcfg.ModelConfig.tiny(vocab_size=100, max_position_embeddings=140), pcfg.TrainConfig(seed=3), device="cpu")
    with Checkpointer(str(tmp_path / "old")) as ckpt:
        ckpt.save(4, old.init_state(seed=0))
    if change == "vocab":
        new_cfg, train_cfg = pcfg.ModelConfig.tiny(vocab_size=140, max_position_embeddings=140), pcfg.TrainConfig(seed=3)
    elif change == "swap_tables":  # the same multiset of shapes, swapped
        new_cfg, train_cfg = pcfg.ModelConfig.tiny(vocab_size=140, max_position_embeddings=100), pcfg.TrainConfig(seed=3)
    elif change == "trainable":
        new_cfg, train_cfg = old.model_cfg, pcfg.TrainConfig(seed=3, trainable="head")
    elif change == "corrupt":
        new_cfg, train_cfg = old.model_cfg, pcfg.TrainConfig(seed=3)
        with open(tmp_path / "old" / "4" / "state.pt", "wb") as f:
            f.write(b"not a checkpoint")
    else:
        new_cfg, train_cfg = old.model_cfg, pcfg.TrainConfig(seed=3)
        with open(tmp_path / "old" / "4" / "meta.json", "w") as f:
            json.dump({"kind": "local"}, f)
    template = Trainer(new_cfg, train_cfg, device="cpu").init_state(seed=0)
    with caplog.at_level(logging.WARNING):
        restored, step = maybe_warm_start(str(tmp_path / "old"), template)
    assert restored is None and step is None
    assert "starting fresh" in caplog.text


def test_restore_empty_dir_raises(tmp_path):
    trainer = _trainer()
    with Checkpointer(str(tmp_path / "empty")) as ckpt:
        with pytest.raises(FileNotFoundError):
            ckpt.restore(trainer.init_state(seed=0))
        with pytest.raises(FileNotFoundError):
            ckpt.restore_params()
        assert not ckpt.saved_compatible(trainer.init_state(seed=0))


def test_restore_params_reads_params_only(tmp_path):
    trainer = _trainer()
    state, _ = trainer.train_step(trainer.init_state(seed=0), _batches(trainer.model_cfg, 1)[0])
    with Checkpointer(str(tmp_path / "p")) as ckpt:
        ckpt.save(1, state)
        params = ckpt.restore_params()
    assert params.keys() == state.params.keys()
    for n, t in params.items():
        assert not t.requires_grad and torch.equal(t, state.params[n].detach())
        assert t.data_ptr() != state.params[n].data_ptr()


@pytest.mark.parametrize("attention_impl", ["dot", "flash"])
def test_resume_equals_uninterrupted_bit_for_bit_with_dropout(tmp_path, attention_impl):
    cfg = pcfg.ModelConfig.tiny(attention_impl=attention_impl)
    assert cfg.dropout > 0 and cfg.attention_dropout > 0
    train_cfg = pcfg.TrainConfig(seed=4, learning_rate=1e-3, warmup_steps=3)
    batches = _batches(cfg, 9, seed=1)
    t = Trainer(cfg, train_cfg, device="cpu")
    whole = t.init_state()
    whole_losses = [float(t.train_step(whole, b)[1]) for b in batches]
    first = t.init_state()
    losses = [float(t.train_step(first, b)[1]) for b in batches[:4]]
    with Checkpointer(str(tmp_path / "r")) as ckpt:
        ckpt.save(first.step, first)
    fresh = Trainer(cfg, train_cfg, device="cpu")
    resumed, step = maybe_warm_start(str(tmp_path / "r"), fresh.init_state())
    assert step == 4 and resumed.step == 4
    losses += [float(fresh.train_step(resumed, b)[1]) for b in batches[4:]]
    assert losses == whole_losses
    _assert_state_equal(resumed, whole)


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def test_resume_matches_the_jax_uninterrupted_trajectory(tmp_path):
    port_cfg = pcfg.ModelConfig.tiny(**NO_DROP)
    jax_cfg = jcfg.ModelConfig(**dataclasses.asdict(port_cfg))
    kw = dict(learning_rate=1e-3, seed=6, warmup_steps=3, max_grad_norm=1.0)
    init = _host(jax_init_params(JaxClassifier(jax_cfg), jax_cfg, jax.random.key(2)))
    batches = _batches(port_cfg, 7, seed=3)
    jt = jengine.Trainer(jax_cfg, jcfg.TrainConfig(**kw))
    jstate = jt.init_state(params=jax.tree.map(jnp.asarray, init))
    jlosses = []
    for b in batches:
        jstate, loss = jt.train_step(jstate, b)
        jlosses.append(float(loss))
    pt = Trainer(port_cfg, pcfg.TrainConfig(**kw), device="cpu")
    pstate = pt.init_state(params=params_from_jax(init))
    plosses = [float(pt.train_step(pstate, b)[1]) for b in batches[:3]]
    with Checkpointer(str(tmp_path / "j")) as ckpt:
        ckpt.save(pstate.step, pstate, meta={"kind": "local"})
    pt2 = Trainer(port_cfg, pcfg.TrainConfig(**kw), device="cpu")
    pstate, step = maybe_warm_start(str(tmp_path / "j"), pt2.init_state())
    assert step == 3
    plosses += [float(pt2.train_step(pstate, b)[1]) for b in batches[3:]]
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    assert pstate.step == int(jstate.step) == 7
    got, want = flatten_tree(pt2.host_params(pstate)), flatten_tree(jt.host_params(jstate))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=2e-6, rtol=1e-5, err_msg=name)


def test_generator_from_another_device_type_reseeds_with_a_warning(tmp_path, caplog):
    """The CUDA generator's 16-byte state cannot load into a CPU one (and
    the reverse): params, moments and step restore; the generator is the
    trainer's freshly seeded one."""
    trainer = _trainer()
    state, _ = trainer.train_step(trainer.init_state(seed=0), _batches(trainer.model_cfg, 1)[0])
    with Checkpointer(str(tmp_path / "g")) as ckpt:
        ckpt.save(1, state)
    # A card's checkpoint, as the card writes it: device type "cuda" and
    # Philox's seed + offset.
    path = tmp_path / "g" / "1" / "state.pt"
    payload = torch.load(path, weights_only=True)
    payload["generator"] = {"device_type": "cuda", "state": torch.zeros(16, dtype=torch.uint8)}
    torch.save(payload, path)
    template = trainer.init_state(seed=0)
    with caplog.at_level(logging.WARNING):
        restored, step = maybe_warm_start(str(tmp_path / "g"), template)
    assert step == 1 and "dropout stream restarts" in caplog.text
    assert torch.equal(restored.generator.get_state(), template.generator.get_state())
    assert restored.generator is not template.generator
    for n in state.params:
        assert torch.equal(restored.params[n].detach(), state.params[n].detach())
    assert restored.opt_state.count == 1 and restored.step == 1
    # The same device type restores the stream exactly.
    caplog.clear()
    g = ckpt_mod._generator({"device_type": "cpu", "state": state.generator.get_state()}, template.generator)
    assert "dropout stream restarts" not in caplog.text
    assert torch.equal(g.get_state(), state.generator.get_state())


# ------------------------------------------------------------ federated
def _fed_trainer(C=3, **fed_kw):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.federated import (
        FederatedTrainer,
    )

    m = pcfg.ModelConfig.tiny()
    cfg = pcfg.ExperimentConfig(
        model=m, data=pcfg.DataConfig(max_len=m.max_len, batch_size=4), fed=pcfg.FedConfig(num_clients=C, **fed_kw)
    )
    return FederatedTrainer(cfg, device="cpu")


def _assert_fed_state_equal(a, b):
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu)):
        assert x.keys() == y.keys() and all(torch.equal(x[n].detach(), y[n].detach()) for n in x)
    assert a.opt_state.count == b.opt_state.count and a.step == b.step
    assert len(a.generators) == len(b.generators)
    assert all(torch.equal(g.get_state(), h.get_state()) for g, h in zip(a.generators, b.generators))
    assert (a.server_opt is None) == (b.server_opt is None)
    if a.server_opt is not None:
        assert a.server_opt.keys() == b.server_opt.keys()
        for k, v in a.server_opt.items():
            if isinstance(v, dict):
                assert all(torch.equal(v[n], b.server_opt[k][n]) for n in v), k
            else:
                assert v == b.server_opt[k], k


def test_fed_state_roundtrip(tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
        TokenizedSplit,
        stack_clients_ragged,
    )

    trainer = _fed_trainer(server_opt="adam")
    state = trainer.init_state(seed=1)
    cfg = trainer.cfg.model
    splits = []
    for n, b in zip((9, 5, 2), _batches(cfg, 3, seed=2, bs=9)):
        splits.append(TokenizedSplit(b["input_ids"][:n], b["attention_mask"][:n], b["labels"][:n]))
    anchor = trainer.round_anchor(state)
    state, _ = trainer.fit_local(state, stack_clients_ragged(splits), epochs=1)
    state = trainer.round_aggregate(state, round_index=0, weights=np.array([9.0, 5.0, 2.0]), anchor=anchor)
    assert state.opt_state.count == [3, 2, 1] and state.server_opt["count"] == 1
    with Checkpointer(str(tmp_path / "f")) as ckpt:
        ckpt.save(1, state, meta={"round": 1, "kind": "federated"})
        restored = ckpt.restore(trainer.init_state(seed=9))
        assert ckpt.restore_meta() == {"round": 1, "kind": "federated"}
        row = ckpt.restore_params(client=1)
    _assert_fed_state_equal(restored, state)
    assert all(p.requires_grad for p in restored.params.values())
    assert all(torch.equal(row[n], t[1].detach()) for n, t in state.params.items())
    # Another client count or server optimizer is another layout: fresh.
    for other in (_fed_trainer(C=2, server_opt="adam"), _fed_trainer(server_opt="none")):
        assert maybe_warm_start(str(tmp_path / "f"), other.init_state()) == (None, None)
    state2, step = maybe_warm_start(str(tmp_path / "f"), trainer.init_state(seed=9))
    assert step == 1
    _assert_fed_state_equal(state2, state)


def test_federated_resume_equals_uninterrupted_bit_for_bit_with_dropout(tmp_path):
    """``federated --rounds 1`` then ``--rounds 2`` on one checkpoint
    directory: the state and the CSVs of ``--rounds 2`` in one go."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.federated import (
        run_federated,
    )

    def run(rounds, tag):
        return run_federated(build_parser().parse_args([
            "federated", "--device", "cpu", "--preset", "tiny", "--attention-impl", "flash",
            "--synthetic", "500", "--num-clients", "3", "--partition", "quantity", "--rounds", str(rounds),
            "--epochs", "1", "--server-opt", "momentum", "--seed", "5",
            "--checkpoint-dir", str(tmp_path / tag / "ck"), "--output-dir", str(tmp_path / tag / "out"),
        ]))

    whole = run(2, "whole")
    assert whole["config"].model.dropout > 0 and whole["start_round"] == 0
    first = run(1, "split")
    assert sorted(os.listdir(tmp_path / "split" / "ck")) == ["1"]
    resumed = run(2, "split")
    assert resumed["start_round"] == 1 and len(resumed["history"]) == 1
    assert sorted(os.listdir(tmp_path / "split" / "ck")) == ["1", "2"]
    _assert_fed_state_equal(resumed["state"], whole["state"])
    np.testing.assert_array_equal(resumed["history"][0].epoch_losses, whole["history"][1].epoch_losses)
    for name in os.listdir(tmp_path / "whole" / "out"):
        with open(tmp_path / "whole" / "out" / name) as f, open(tmp_path / "split" / "out" / name) as g:
            assert f.read() == g.read(), name
    assert first["state"].step < resumed["state"].step
    with Checkpointer(str(tmp_path / "split" / "ck")) as ckpt:
        meta = ckpt.restore_meta(step=2)
    assert meta["round"] == 2 and meta["kind"] == "federated"
    assert pcfg.ExperimentConfig.from_dict(meta["config"]) == resumed["config"]
    # A finished run relaunched trains nothing and reports the aggregate.
    again = run(2, "split")
    assert again["history"] == [] and all(p.endswith("_aggregated_metrics.csv") for p in again["metrics_csvs"])
