"""The port's remat and gradient accumulation held against the JAX
package's, on the CPU.

(a) Remat: the port's remat model against the JAX ``nn.remat`` model on
    the same weights with dropout off, logits at atol 1e-6
    (tests/test_model.py) and gradients at the model-parity bound atol
    2e-5 / rtol 1e-4; and the port with remat against the port without,
    dropout ON from one generator seed: the same loss, gradients at atol
    1e-6 / rtol 1e-5, the same dropout masks and K1 seed words (the
    recompute redraws exactly the forward's) and the same generator state
    after the step, on the dot path and the flash path's plain version.
(b) Accumulation: the port ``Trainer`` against the JAX ``Trainer``
    (``optax.MultiSteps``) at k = 2 and 3 over 6-9 micro steps: losses at
    rtol 1e-5, params at the trajectory bound atol 2e-6 / rtol 1e-5, and
    Adam's count, the micro-step counter and ``step`` equal; a checkpoint
    saved mid-window resumes bit for bit; ``local --remat --config``
    drives both through the parser; the federated trainer refuses it.
"""

import dataclasses
import json

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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.local import (
    run_local,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
    TokenizedSplit,
    batch_iterator,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    flatten_tree,
    params_from_jax,
    params_to_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.distilbert import (
    build_trainable_params,
    init_params,
    model_skeleton,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
    Checkpointer,
    maybe_warm_start,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
    loss_fn,
)

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)


def _split(cfg, n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
    ids[:, 0] = 2
    lengths = rng.integers(cfg.max_len // 3, cfg.max_len + 1, n)
    mask = (np.arange(cfg.max_len)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return TokenizedSplit(ids, mask, rng.integers(0, cfg.n_classes, n).astype(np.int32))


def _tensors(split):
    return torch.from_numpy(split.input_ids), torch.from_numpy(split.attention_mask), torch.from_numpy(split.labels)


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_remat_matches_jax_remat(impl):
    port_cfg = pcfg.ModelConfig.tiny(attention_impl=impl, remat=True, **NO_DROP)
    jax_cfg = jcfg.ModelConfig(**dataclasses.asdict(port_cfg))
    jparams = jax_init_params(JaxClassifier(jax_cfg), jax_cfg, jax.random.key(1))
    split = _split(port_cfg, 6, seed=2)
    batch = {"input_ids": split.input_ids, "attention_mask": split.attention_mask, "labels": split.labels}
    jlogits = JaxClassifier(jax_cfg).apply({"params": jparams}, split.input_ids, split.attention_mask, True)
    jgrads = jax.grad(lambda p: jengine.loss_fn(JaxClassifier(jax_cfg), p, batch, jax.random.key(0)))(jparams)
    leaves = build_trainable_params(port_cfg, params_from_jax(jparams), torch.device("cpu"))
    ids, mask, labels = _tensors(split)
    logits = torch.func.functional_call(model_skeleton(port_cfg), leaves, (ids, mask))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-6)
    grads = torch.autograd.grad(loss_fn(logits, labels), list(leaves.values()))
    got, want = flatten_tree(params_to_jax(dict(zip(leaves, grads)))), flatten_tree(jgrads)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=2e-5, rtol=1e-4, err_msg=name)


def _recording(monkeypatch):
    """Every random draw of a step, in order: torch.rand (dropout masks)
    and torch.randint (K1's seed words)."""
    draws = []
    for name in ("rand", "randint"):
        orig = getattr(torch, name)

        def rec(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            draws.append(out.clone())
            return out

        monkeypatch.setattr(torch, name, rec)
    return draws


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_remat_keeps_the_function_with_dropout(impl, monkeypatch):
    cfg = pcfg.ModelConfig.tiny(attention_impl=impl, n_layers=3, dropout=0.2, attention_dropout=0.3, head_dropout=0.3)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    ids, mask, labels = _tensors(_split(cfg, 5, seed=3))
    draws = _recording(monkeypatch)
    runs = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = build_trainable_params(c, params, torch.device("cpu"))
        g = torch.Generator().manual_seed(11)
        del draws[:]
        logits = torch.func.functional_call(model_skeleton(c), leaves, (ids, mask), {"deterministic": False, "generator": g})
        loss = loss_fn(logits, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        runs[remat] = (loss.detach(), grads, g.get_state(), list(draws))
    (loss0, grads0, state0, draws0), (loss1, grads1, state1, draws1) = runs[False], runs[True]
    assert torch.equal(loss0, loss1)
    for a, b in zip(grads0, grads1, strict=True):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-5)
    assert torch.equal(state0, state1)  # the stream stands where it would without remat
    # Draws: embeddings, 3 per layer (attention weights or K1's seed
    # words, attention output, FFN output), the head; remat recomputes
    # the layers in reverse and redraws exactly the forward's.
    per = 3
    n = 2 + per * cfg.n_layers
    assert len(draws0) == n and len(draws1) == n + per * cfg.n_layers
    for a, b in zip(draws0, draws1[:n]):
        assert torch.equal(a, b)
    for j, layer in enumerate(reversed(range(cfg.n_layers))):
        fwd = draws0[1 + per * layer: 1 + per * (layer + 1)]
        again = draws1[n + per * j: n + per * (j + 1)]
        assert all(torch.equal(a, b) for a, b in zip(fwd, again, strict=True)), layer
    if impl == "flash":
        words = [d for d in draws0 if d.dtype == torch.int64]
        assert len(words) == cfg.n_layers and all(w.shape == (2,) for w in words)


# ----------------------------------------------------------- accumulation
ACCUM = {
    "k2_adam": (dict(grad_accum_steps=2), 6),
    "k3_adam": (dict(grad_accum_steps=3), 9),
    "k3_clip_warmup_adamw": (dict(grad_accum_steps=3, max_grad_norm=0.05, warmup_steps=4, weight_decay=0.01), 9),
    "k2_head": (dict(grad_accum_steps=2, trainable="head"), 6),
}


def _jax_counts(opt_state) -> dict[str, int]:
    """MultiSteps' mini_step and gradient_step, and the inner Adam's count."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        name = getattr(path[-1], "name", None)
        if name in ("count", "mini_step", "gradient_step"):
            assert name not in out, path
            out[name] = int(leaf)
    return out


@pytest.mark.parametrize("setting", sorted(ACCUM))
def test_accumulation_trajectory_matches_jax(setting):
    kw, n_steps = ACCUM[setting]
    k = kw["grad_accum_steps"]
    port_cfg = pcfg.ModelConfig.tiny(**NO_DROP)
    jax_cfg = jcfg.ModelConfig(**dataclasses.asdict(port_cfg))
    train = dict(kw, learning_rate=1e-3, seed=3)
    jparams = jax.tree.map(np.asarray, jax_init_params(JaxClassifier(jax_cfg), jax_cfg, jax.random.key(4)))
    jt = jengine.Trainer(jax_cfg, jcfg.TrainConfig(**train))
    pt = Trainer(port_cfg, pcfg.TrainConfig(**train), device="cpu")
    jstate = jt.init_state(params=jax.tree.map(jnp.asarray, jparams))
    pstate = pt.init_state(params=params_from_jax(jparams))
    batches = list(batch_iterator(_split(port_cfg, 8 * n_steps, seed=5), 8, shuffle=True, seed=6))
    assert len(batches) == n_steps
    for i, batch in enumerate(batches):
        jstate, jloss = jt.train_step(jstate, batch)
        pstate, ploss = pt.train_step(pstate, batch)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5, err_msg=f"step {i}")
        counts = _jax_counts(jstate.opt_state)
        assert pstate.opt_state.count == counts["count"] == counts["gradient_step"] == (i + 1) // k, i
        assert pstate.mini_step == counts["mini_step"] == (i + 1) % k, i
    assert pstate.step == int(jstate.step) == n_steps
    got, want = flatten_tree(params_to_jax(pstate.params)), flatten_tree(jt.host_params(jstate))
    start = flatten_tree(jparams)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-6, rtol=1e-5, err_msg=name)
        if "head" in setting and not name.startswith("classifier/"):
            np.testing.assert_array_equal(got[name], start[name])
    assert not np.array_equal(got["classifier/kernel"], start["classifier/kernel"])


def test_accumulation_applies_nothing_between_emits():
    cfg = pcfg.ModelConfig.tiny(**NO_DROP)
    pt = Trainer(cfg, pcfg.TrainConfig(grad_accum_steps=3, learning_rate=1e-3), device="cpu")
    state = pt.init_state()
    start = {n: t.detach().clone() for n, t in state.params.items()}
    batches = list(batch_iterator(_split(cfg, 24, seed=7), 8, shuffle=False))
    for b in batches[:2]:
        state, _ = pt.train_step(state, b)
        assert all(torch.equal(state.params[n], t) for n, t in start.items())
    assert state.opt_state.count == 0 and state.mini_step == 2
    assert any(bool(a.abs().sum() > 0) for a in state.acc.values())
    state, _ = pt.train_step(state, batches[2])
    assert state.opt_state.count == 1 and state.mini_step == 0 and state.step == 3
    assert all(bool((a == 0).all()) for a in state.acc.values())
    assert not all(torch.equal(state.params[n], t) for n, t in start.items())


def test_checkpoint_mid_accumulation_resumes_exactly(tmp_path):
    cfg = pcfg.ModelConfig.tiny()  # dropout on: the generator is saved too
    tcfg = pcfg.TrainConfig(grad_accum_steps=3, learning_rate=1e-3, seed=2)
    batches = list(batch_iterator(_split(cfg, 72, seed=8), 8, shuffle=True, seed=9))
    whole_t = Trainer(cfg, tcfg, device="cpu")
    whole = whole_t.init_state()
    whole_losses = [float(whole_t.train_step(whole, b)[1]) for b in batches]
    part_t = Trainer(cfg, tcfg, device="cpu")
    part = part_t.init_state()
    losses = [float(part_t.train_step(part, b)[1]) for b in batches[:4]]
    assert part.mini_step == 1
    with Checkpointer(str(tmp_path)) as ckpt:
        ckpt.save(part.step, part)
    fresh = Trainer(cfg, tcfg, device="cpu")
    resumed, step = maybe_warm_start(str(tmp_path), fresh.init_state())
    assert step == 4 and resumed.mini_step == 1 and resumed.opt_state.count == 1
    assert all(torch.equal(resumed.acc[n], part.acc[n]) for n in part.acc)
    losses += [float(fresh.train_step(resumed, b)[1]) for b in batches[4:]]
    assert losses == whole_losses
    assert resumed.opt_state.count == whole.opt_state.count == 3
    for n, t in whole.params.items():
        assert torch.equal(resumed.params[n], t), n
    # Without accumulation the template differs: a fresh start, as JAX's
    # MultiSteps state does not restore into a plain Adam template.
    plain = Trainer(cfg, pcfg.TrainConfig(seed=2), device="cpu")
    assert maybe_warm_start(str(tmp_path), plain.init_state()) == (None, None)


def test_local_remat_and_config_accumulation_through_the_parser(tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
        resolve_config,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.tokenizer import (
        default_tokenizer,
    )

    cfg_path = tmp_path / "cfg.json"
    args = build_parser().parse_args(["export-config", "--preset", "tiny"])
    d = resolve_config(args, vocab_size=len(default_tokenizer())).to_dict()
    d["train"]["grad_accum_steps"] = 3
    cfg_path.write_text(json.dumps(d))
    args = build_parser().parse_args([
        "local", "--device", "cpu", "--config", str(cfg_path), "--remat", "--synthetic", "600",
        "--epochs", "1", "--batch-size", "8", "--output-dir", str(tmp_path / "out"),
    ])
    res = run_local(args)
    state = res["state"]
    assert res["config"].model.remat and res["config"].train.grad_accum_steps == 3
    # 600 flows x 0.1 x 0.6 = 36 train rows: 4 steps of bs8, one emit.
    assert (state.step, state.opt_state.count, state.mini_step) == (4, 1, 1)
    assert np.isfinite(res["losses"]).all()


def test_federated_refuses_accumulation(tmp_path):
    """(Named for the refusal it replaced.) A config with
    grad_accum_steps=2 runs the federated verb."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.federated import (
        run_federated,
    )

    d = pcfg.ExperimentConfig(
        model=pcfg.ModelConfig.tiny(), data=pcfg.DataConfig(max_len=32), train=pcfg.TrainConfig(grad_accum_steps=2)
    ).to_dict()
    (tmp_path / "cfg.json").write_text(json.dumps(d))
    args = build_parser().parse_args([
        "federated", "--device", "cpu", "--config", str(tmp_path / "cfg.json"), "--synthetic", "300",
        "--output-dir", str(tmp_path / "out"),
    ])
    # Ported: the --config written for `local` runs on `federated`, each
    # client accumulating its own window (tests/test_torch_fed_accum.py
    # holds the stacked step against JAX's).
    res = run_federated(args)
    assert res["config"].train.grad_accum_steps == 2
    opt = res["state"].opt_state
    assert opt.acc is not None and len(opt.mini_step) == 2
    assert all(np.isfinite(r.epoch_losses).all() for r in res["history"])
