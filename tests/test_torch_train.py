"""The port's training slice held against the JAX package's, on the CPU.

(a) Whole-model gradients of the loss, port vs ``jax.grad(loss_fn)``, at
    the JAX model-parity bound atol 2e-5 / rtol 1e-4 (tests/test_model.py).
(b) The port ``Trainer`` vs the JAX ``Trainer`` from one init over 5 steps
    on the same batches: per-step losses at rtol 1e-5 and params after the
    last step at atol 2e-6 / rtol 1e-5 (tests/test_client_mesh.py's
    trajectory bounds), for Adam, AdamW + clip + warmup, and head-only.
(c) Metrics of the same params: the confusion matrix exactly,
    Accuracy/Precision/Recall/F1 at rtol 1e-6, Loss at rtol 1e-5, probs at
    atol 1e-5.
(d) Data: flows, client splits, texts (NaN/inf rows included) and token
    arrays equal the JAX package's, array for array and string for string.

Dropout is off in (a)-(c): the two packages draw dropout from different
generators (tests/test_torch_dropout.py holds the masks). The JAX flash
runs in Pallas interpret mode, as its own tests run it off-TPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    cicids as jcicids,
    default_tokenizer as jax_tokenizer,
    synthetic as jsynthetic,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data.datasets import (
    get_dataset,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data.pipeline import (
    TokenizedSplit as JaxSplit,
    tokenize_split as jax_tokenize_split,
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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    cicids as pcicids,
    default_tokenizer as port_tokenizer,
    synthetic as psynthetic,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
    TokenizedSplit,
    batch_iterator,
    tokenize_split,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    flatten_tree,
    params_from_jax,
    params_to_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.distilbert import (
    build_trainable_params,
    model_skeleton,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
    loss_fn,
)

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)


def _cfgs(impl="dot", **kw):
    port = pcfg.ModelConfig.tiny(attention_impl=impl, **NO_DROP, **kw)
    return port, jcfg.ModelConfig(**dataclasses.asdict(port))


def _jax_params(jax_model_cfg, seed=0):
    return jax_init_params(JaxClassifier(jax_model_cfg), jax_model_cfg, jax.random.key(seed))


def _split(cfg, n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
    ids[:, 0] = 2  # [CLS]
    lengths = rng.integers(cfg.max_len // 3, cfg.max_len + 1, n)
    mask = (np.arange(cfg.max_len)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    return TokenizedSplit(ids, mask, labels)


def _flat_port(params: dict) -> dict:
    return flatten_tree(params_to_jax(params))


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_model_gradients_match_jax(impl):
    port_cfg, jax_cfg = _cfgs(impl)
    jparams = _jax_params(jax_cfg, seed=1)
    split = _split(port_cfg, 6, seed=2)
    batch = {"input_ids": split.input_ids, "attention_mask": split.attention_mask, "labels": split.labels}
    jgrads = jax.grad(
        lambda p: jengine.loss_fn(JaxClassifier(jax_cfg), p, batch, jax.random.key(0))
    )(jparams)
    leaves = build_trainable_params(port_cfg, params_from_jax(jparams), torch.device("cpu"))
    logits = torch.func.functional_call(
        model_skeleton(port_cfg), leaves,
        (torch.from_numpy(split.input_ids), torch.from_numpy(split.attention_mask)),
    )
    grads = torch.autograd.grad(loss_fn(logits, torch.from_numpy(split.labels)), list(leaves.values()))
    got = _flat_port(dict(zip(leaves, grads)))
    want = flatten_tree(jgrads)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=2e-5, rtol=1e-4, err_msg=name)


TRAJECTORIES = {
    "adam": {},
    "adamw_clip_warmup": dict(weight_decay=0.01, max_grad_norm=0.05, warmup_steps=3),
    "head": dict(trainable="head"),
}


@pytest.mark.parametrize("setting", sorted(TRAJECTORIES))
def test_trainer_trajectory_matches_jax(setting):
    port_cfg, jax_cfg = _cfgs("dot")
    kw = dict(TRAJECTORIES[setting], learning_rate=1e-3, seed=3)
    port_train, jax_train = pcfg.TrainConfig(**kw), jcfg.TrainConfig(**kw)
    # Host copies: the JAX train step donates (deletes) its state's buffers.
    jparams = jax.tree.map(np.asarray, _jax_params(jax_cfg, seed=4))
    jt = jengine.Trainer(jax_cfg, jax_train)
    pt = Trainer(port_cfg, port_train, device="cpu")
    jstate = jt.init_state(params=jax.tree.map(jnp.asarray, jparams))
    pstate = pt.init_state(params=params_from_jax(jparams))
    split = _split(port_cfg, 40, seed=5)
    jsplit = JaxSplit(split.input_ids, split.attention_mask, split.labels)
    batches = list(batch_iterator(split, 8, shuffle=True, seed=6))
    assert len(batches) == 5
    if setting == "adamw_clip_warmup":
        # The clip must act: the first gradient's norm is above the bound.
        g0 = jax.grad(lambda p: jengine.loss_fn(jt.model, p, batches[0], jax.random.key(0)))(
            jax.tree.map(jnp.asarray, jparams)
        )
        assert float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree.leaves(g0)))) > 0.05
    for i, batch in enumerate(batches):
        jstate, jloss = jt.train_step(jstate, batch)
        pstate, ploss = pt.train_step(pstate, batch)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5, err_msg=f"step {i}")
    assert pstate.step == int(jstate.step) == 5
    got, want = _flat_port(pstate.params), flatten_tree(jt.host_params(jstate))
    start = flatten_tree(jparams)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-6, rtol=1e-5, err_msg=name)
        if setting == "head" and not name.startswith("classifier/"):
            np.testing.assert_array_equal(got[name], start[name])  # frozen
    assert not np.array_equal(got["classifier/kernel"], start["classifier/kernel"])
    if setting == "head":
        assert set(pstate.opt_state.mu) == {"classifier.weight", "classifier.bias"}
    # The metrics of the trained params agree too.
    jm = jt.evaluate(jstate.params, jsplit, batch_size=8)
    pm = pt.evaluate(pstate.params, split, batch_size=8)
    np.testing.assert_array_equal(pm["confusion_matrix"], jm["confusion_matrix"])
    np.testing.assert_allclose(pm["Loss"], jm["Loss"], rtol=1e-5)


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_evaluate_matches_jax_metrics(impl):
    port_cfg, jax_cfg = _cfgs(impl)
    jparams = _jax_params(jax_cfg, seed=7)
    split = _split(port_cfg, 37, seed=8)  # 37 rows: the last batch has pad rows
    jm = jengine.Trainer(jax_cfg, jcfg.TrainConfig()).evaluate(
        jparams, JaxSplit(split.input_ids, split.attention_mask, split.labels), batch_size=8
    )
    pt = Trainer(port_cfg, pcfg.TrainConfig(), device="cpu")
    pm = pt.evaluate(pt.init_state(params=params_from_jax(jparams)).params, split, batch_size=8)
    np.testing.assert_array_equal(pm["confusion_matrix"], jm["confusion_matrix"])
    assert pm["n"] == jm["n"] == 37
    for key in ("Accuracy", "Precision", "Recall", "F1-Score"):
        np.testing.assert_allclose(pm[key], jm[key], rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(pm["Loss"], jm["Loss"], rtol=1e-5)
    np.testing.assert_allclose(pm["probs"], jm["probs"], atol=1e-5)
    np.testing.assert_array_equal(pm["labels"], jm["labels"])


def _assert_frames_equal(port_frame, df):
    assert list(port_frame) == list(df.columns)
    for name in df.columns:
        want = df[name].to_numpy()
        got = port_frame[name]
        if want.dtype.kind == "f":
            assert got.dtype == np.float64, name
            np.testing.assert_array_equal(got, want, err_msg=name)  # NaN == NaN here
        elif want.dtype.kind in "iu":
            assert got.dtype == np.int64, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert [str(x) for x in got] == [str(x) for x in want], name


def _assert_splits_equal(port_splits, jax_splits, port_tok, jax_tok, max_len=128):
    for ps, js in zip(port_splits, jax_splits, strict=True):
        assert ps.client_id == js.client_id
        for part in ("train", "val", "test"):
            p, j = getattr(ps, part), getattr(js, part)
            assert p.texts == j.texts, (ps.client_id, part)
            np.testing.assert_array_equal(p.labels, j.labels)
            pt, jt = tokenize_split(p, port_tok, max_len), jax_tokenize_split(j, jax_tok, max_len)
            for field in ("input_ids", "attention_mask", "labels"):
                np.testing.assert_array_equal(getattr(pt, field), getattr(jt, field), err_msg=field)


def test_synthetic_flows_and_client_splits_match_jax():
    """The CLI's --synthetic path: flows from seed_base 42, client seeds 42
    and 43, no imputation (NaN/inf reach the texts as the JAX template
    writes them)."""
    df = jsynthetic.make_synthetic_flows(2400, seed=42)
    frame = psynthetic.make_synthetic_flows(2400, seed=42)
    _assert_frames_equal(frame, df)
    port_splits = pcicids.make_all_client_splits(frame, 2, pcfg.DataConfig())
    jax_splits = jcicids.make_all_client_splits(df, 2, jcfg.DataConfig())
    assert [len(s.train) for s in port_splits] == [144, 144]
    texts = [t for s in port_splits for t in s.train.texts + s.val.texts + s.test.texts]
    assert any("is nan." in t or "is nan. " in t for t in texts)
    assert any("is inf." in t or "is inf. " in t for t in texts)
    _assert_splits_equal(port_splits, jax_splits, port_tokenizer(), jax_tokenizer())


def test_load_flow_csv_matches_jax(synthetic_csv):
    """A CSV the JAX package wrote: ±inf -> NaN -> column mean, as pandas."""
    df = jcicids.load_flow_csv(synthetic_csv)
    frame = pcicids.load_flow_csv(synthetic_csv)
    _assert_frames_equal(frame, df)
    assert not any(np.isnan(c).any() for c in frame.values() if c.dtype == np.float64)
    assert pcicids.frame_texts(frame) == get_dataset("cicids2017").render_texts(df)
    cfg_p = pcfg.DataConfig(data_fraction=0.3)
    cfg_j = jcfg.DataConfig(data_fraction=0.3)
    _assert_splits_equal(
        pcicids.make_all_client_splits(frame, 2, cfg_p),
        jcicids.make_all_client_splits(df, 2, cfg_j),
        port_tokenizer(), jax_tokenizer(),
    )


def test_unported_config_paths_raise():
    with pytest.raises(NotImplementedError, match="accumulation"):
        pcfg.TrainConfig(grad_accum_steps=2)
    with pytest.raises(NotImplementedError, match="cicids2017 only"):
        pcfg.DataConfig(dataset="unswnb15")
    with pytest.raises(ValueError, match="unknown partition"):
        pcfg.DataConfig(partition="bogus")
    # Every field of the JAX configs exists in the port's.
    for port_cls, jax_cls in ((pcfg.TrainConfig, jcfg.TrainConfig), (pcfg.DataConfig, jcfg.DataConfig), (pcfg.FedConfig, jcfg.FedConfig)):
        assert {f.name for f in dataclasses.fields(port_cls)} == {f.name for f in dataclasses.fields(jax_cls)}
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
