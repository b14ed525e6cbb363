"""Hot reload in the port's ``infer-serve``, on the CPU.

* ``--checkpoint-dir``: a live server swaps to a newly finished step;
  replies after the swap name the new round and their probs equal
  ``predict``'s on the new weights at the model-parity bound (atol 2e-5,
  tests/test_torch_model.py: the two batch the rows differently);
* ``--registry-dir``: a live server swaps on a promotion, whether the
  port's or the JAX package's registry promoted; a rollback swaps back;
* an architecture change is refused and the old model keeps serving;
* a federated checkpoint: a server started on round 1 swaps to round 2
  when a resumed ``federated`` run finalizes it, and serves its global
  model.
"""

import dataclasses
import logging
import os
import time

import jax
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    write_synthetic_csv,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.registry import (
    ModelRegistry as JaxRegistry,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.predict import (
    run_predict,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
    build_server,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    default_tokenizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.cicids import (
    frame_texts,
    load_flow_csv,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    init_params,
    params_to_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry import (
    ModelRegistry,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
    ScoringClient,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving.reload import (
    checkpoint_restorer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
    Checkpointer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
)

torch.set_num_threads(1)

VOCAB = len(default_tokenizer().vocab)
CFG = pcfg.ModelConfig.tiny(vocab_size=VOCAB, attention_impl="flash")


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    path = tmp_path_factory.mktemp("reload") / "flows.csv"
    write_synthetic_csv(str(path), n_rows=12, seed=4)
    return str(path), frame_texts(load_flow_csv(str(path)))


def _save(ckpt_dir, step, seed, model_cfg=CFG, **meta):
    cfg = pcfg.ExperimentConfig(model=model_cfg, data=pcfg.DataConfig(max_len=model_cfg.max_len))
    state = Trainer(model_cfg, cfg.train, device="cpu").init_state(seed=seed)
    with Checkpointer(ckpt_dir) as ckpt:
        ckpt.save(step, state, meta={"kind": "local", "config": cfg.to_dict(), **meta})


def _serve_args(*extra):
    return build_parser().parse_args([
        "infer-serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--reload-poll", "0.02", "--max-wait-ms", "1", *extra,
    ])


def _score_all(server, texts):
    with ScoringClient("127.0.0.1", server.port) as c:
        return [c.score(text=t) for t in texts]


def _wait_reloads(server, n, timeout=30.0):
    t0 = time.monotonic()
    while server.stats()["reloads"] < n and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    return server.stats()["reloads"]


def _wait_log(caplog, text, timeout=30.0):
    """Wait until the scorer thread has logged ``text`` (a refusal)."""
    t0 = time.monotonic()
    while text not in caplog.text and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    return text in caplog.text


def _predict(flows_csv, ckpt_dir, out):
    return run_predict(build_parser().parse_args([
        "predict", "--device", "cpu", "--csv", flows_csv, "--checkpoint-dir", ckpt_dir, "--output", out,
    ]))["probs"]


def test_checkpoint_watcher_swaps_on_a_new_step(flows, tmp_path):
    csv_path, texts = flows
    ckpt_dir = str(tmp_path / "ck")
    _save(ckpt_dir, 4, seed=1)
    before = _predict(csv_path, ckpt_dir, str(tmp_path / "p4.csv"))
    with build_server(_serve_args("--checkpoint-dir", ckpt_dir)) as server:
        old = _score_all(server, texts)
        assert {r["round"] for r in old} == {4}
        np.testing.assert_allclose([r["prob"] for r in old], before, atol=2e-5)
        _save(ckpt_dir, 7, seed=2, round=3)  # a federated-style meta round wins over the step
        assert _wait_reloads(server, 1) == 1
        new = _score_all(server, texts)
        stats = server.stats()
    after = _predict(csv_path, ckpt_dir, str(tmp_path / "p7.csv"))
    assert {r["round"] for r in new} == {3} and stats["round"] == 3
    np.testing.assert_allclose([r["prob"] for r in new], after, atol=2e-5)
    assert np.abs(after - before).max() > 1e-3  # the weights did change


def test_checkpoint_watcher_refuses_another_architecture(flows, tmp_path, caplog):
    csv_path, texts = flows
    ckpt_dir = str(tmp_path / "ck")
    _save(ckpt_dir, 1, seed=1)
    with caplog.at_level(logging.WARNING), build_server(_serve_args("--checkpoint-dir", ckpt_dir)) as server:
        first = _score_all(server, texts)
        _save(ckpt_dir, 2, seed=2, model_cfg=dataclasses.replace(CFG, dim=48))
        assert _wait_log(caplog, "step 2 declares a different architecture")
        again = _score_all(server, texts)
        stats = server.stats()
    assert stats["reloads"] == 0 and {r["round"] for r in again} == {1}
    assert [r["prob"] for r in again] == [r["prob"] for r in first]


@pytest.mark.parametrize("promoter", ["port", "jax"])
def test_registry_watcher_swaps_on_a_promotion(flows, tmp_path, promoter):
    csv_path, texts = flows
    root = str(tmp_path / "registry")
    port_reg = ModelRegistry(root)
    reg = port_reg if promoter == "port" else JaxRegistry(root)
    p1 = init_params(CFG, torch.Generator().manual_seed(1))
    p2 = init_params(CFG, torch.Generator().manual_seed(2))
    a1 = port_reg.add(p1, round_index=1, model_config=CFG)
    # The second artifact comes from the promoting package's own add.
    a2 = port_reg.add(p2, round_index=2, model_config=CFG) if promoter == "port" else reg.add(
        jax.tree.map(np.asarray, params_to_jax(p2)), round_index=2, model_config=CFG
    )
    reg.promote(a1, to="serving")
    # predict's view of the second artifact's weights, through a checkpoint.
    ckpt_dir = str(tmp_path / "ck2")
    cfg = pcfg.ExperimentConfig(model=CFG, data=pcfg.DataConfig(max_len=CFG.max_len))
    state = Trainer(CFG, cfg.train, device="cpu").init_state(params=p2)
    with Checkpointer(ckpt_dir) as ckpt:
        ckpt.save(1, state, meta={"kind": "local", "config": cfg.to_dict()})
    want = _predict(csv_path, ckpt_dir, str(tmp_path / "p.csv"))
    with build_server(_serve_args("--registry-dir", root)) as server:
        assert {r["round"] for r in _score_all(server, texts)} == {1}
        reg.promote(a2, to="serving")
        assert _wait_reloads(server, 1) == 1
        new = _score_all(server, texts)
        reg.rollback()
        assert _wait_reloads(server, 2) == 2
        back = _score_all(server, texts)
    assert {r["round"] for r in new} == {2}
    np.testing.assert_allclose([r["prob"] for r in new], want, atol=2e-5)
    assert {r["round"] for r in back} == {1}


def test_registry_watcher_refuses_another_architecture(flows, tmp_path, caplog):
    _, texts = flows
    root = str(tmp_path / "registry")
    reg = ModelRegistry(root)
    a1 = reg.add(init_params(CFG, torch.Generator().manual_seed(1)), round_index=1, model_config=CFG)
    wide = dataclasses.replace(CFG, dim=48)
    a2 = reg.add(init_params(wide, torch.Generator().manual_seed(2)), round_index=2, model_config=wide)
    # No recorded config: the param tree itself is the claim.
    a3 = reg.add(init_params(wide, torch.Generator().manual_seed(3)), round_index=3)
    reg.promote(a1, to="serving")
    with caplog.at_level(logging.WARNING), build_server(_serve_args("--registry-dir", root)) as server:
        first = _score_all(server, texts)
        for aid in (a2, a3):
            reg.promote(aid, to="serving")
            assert _wait_log(caplog, f"serving artifact {aid}")
            again = _score_all(server, texts)
            assert {r["round"] for r in again} == {1}
            assert [r["prob"] for r in again] == [r["prob"] for r in first]
        assert server.stats()["reloads"] == 0
        # A compatible artifact promoted after the refusals is adopted.
        a4 = reg.add(init_params(CFG, torch.Generator().manual_seed(4)), round_index=4, model_config=CFG)
        reg.promote(a4, to="serving")
        assert _wait_reloads(server, 1) == 1
        assert {r["round"] for r in _score_all(server, texts)} == {4}


def test_infer_serve_takes_one_weight_source(tmp_path):
    with pytest.raises(SystemExit, match="pass one"):
        build_server(_serve_args("--registry-dir", str(tmp_path / "r"), "--checkpoint-dir", str(tmp_path / "c")))
    with pytest.raises(SystemExit, match="trained weights"):
        build_server(_serve_args())
    os.makedirs(tmp_path / "empty")
    with pytest.raises(SystemExit, match="no checkpoint found"):
        build_server(_serve_args("--checkpoint-dir", str(tmp_path / "empty")))


def test_infer_serve_never_creates_a_mistyped_directory(tmp_path):
    with pytest.raises(SystemExit, match="does not exist"):
        build_server(_serve_args("--checkpoint-dir", str(tmp_path / "typo-ck")))
    with pytest.raises(SystemExit, match="no serving artifact"):
        build_server(_serve_args("--registry-dir", str(tmp_path / "typo-reg")))
    assert os.listdir(tmp_path) == []


def test_checkpoint_restorer_restores_the_step_it_is_given(tmp_path):
    """A step finished after the watcher's scan is not what it adopts:
    the weights, the round and the step returned are the asked step's."""
    ckpt_dir = str(tmp_path / "ck")
    _save(ckpt_dir, 4, seed=1)
    _save(ckpt_dir, 8, seed=2, round=5)
    restore = checkpoint_restorer(ckpt_dir, CFG, device="cpu")
    cfg4, p4, round4, step4 = restore(4)
    _, p8, round8, step8 = restore(None)
    assert (round4, step4, round8, step8) == (4, 4, 5, 8) and cfg4 == CFG
    with Checkpointer(ckpt_dir) as ckpt:
        for step, got in ((4, p4), (8, p8)):
            want = ckpt.restore_params(step=step)
            assert all(torch.equal(got[n], want[n]) for n in want)
    assert not torch.equal(p4["classifier.weight"], p8["classifier.weight"])



def test_checkpoint_watcher_swaps_on_a_new_federated_round(flows, tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.federated import (
        run_federated,
    )

    csv_path, texts = flows
    ckpt_dir = str(tmp_path / "fed")

    def federated(rounds):
        return run_federated(build_parser().parse_args([
            "federated", "--device", "cpu", "--preset", "tiny", "--synthetic", "400", "--num-clients", "2",
            "--rounds", str(rounds), "--epochs", "1", "--learning-rate", "1e-3",
            "--checkpoint-dir", ckpt_dir, "--output-dir", str(tmp_path / "out"),
        ]))

    federated(1)
    before = _predict(csv_path, ckpt_dir, str(tmp_path / "p1.csv"))
    with build_server(_serve_args("--checkpoint-dir", ckpt_dir)) as server:
        old = _score_all(server, texts)
        assert {r["round"] for r in old} == {1}
        np.testing.assert_allclose([r["prob"] for r in old], before, atol=2e-5)
        res = federated(2)  # resumes round 1's state and finalizes round 2
        assert res["start_round"] == 1
        assert _wait_reloads(server, 1) == 1
        new = _score_all(server, texts)
    after = _predict(csv_path, ckpt_dir, str(tmp_path / "p2.csv"))
    assert {r["round"] for r in new} == {2}
    np.testing.assert_allclose([r["prob"] for r in new], after, atol=2e-5)
    assert np.abs(after - before).max() > 1e-3  # round 2's weights differ
