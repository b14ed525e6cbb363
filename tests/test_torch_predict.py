"""The port's ``predict`` held against the JAX package's, on the CPU.

The same weights go to both: the JAX side as an orbax checkpoint of a JAX
``TrainState``, the port side as its own checkpoint of the same params.
Both ``predict`` runs read one synthetic flow CSV; ``prob_attack`` agrees
at the model-parity bound (atol 2e-5 / rtol 1e-4,
tests/test_torch_model.py), ``prediction`` and ``label_name`` wherever
the prob is more than 2e-5 from the threshold. Then the error cases of
tests/test_predict.py on the port, and a federated checkpoint: its
global model (client 0's row) scores, and ``predict``'s probs equal
``FederatedTrainer.evaluate_clients`` row 0 on the same flows.
"""

import csv
import dataclasses
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    write_synthetic_csv,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train import (
    engine as jengine,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train.checkpoint import (
    Checkpointer as JaxCheckpointer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
    main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.predict import (
    run_predict,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    default_tokenizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    params_from_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
    Checkpointer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
)

torch.set_num_threads(1)

VOCAB = len(default_tokenizer().vocab)


@pytest.fixture(scope="module")
def flows_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("predict") / "flows.csv"
    write_synthetic_csv(str(path), n_rows=96, seed=21)
    return str(path)


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert rows and list(rows[0]) == ["prob_attack", "prediction", "label_name"]
    return (
        np.array([float(r["prob_attack"]) for r in rows]),
        np.array([int(r["prediction"]) for r in rows]),
        [r["label_name"] for r in rows],
    )


def _train_jax(impl, tmp):
    """A few JAX train steps from a seeded init; returns the config dicts
    and the host params, and leaves the JAX state in an orbax checkpoint."""
    model = jcfg.ModelConfig.tiny(vocab_size=VOCAB, attention_impl=impl, dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
    exp = jcfg.ExperimentConfig(model=model, data=jcfg.DataConfig(max_len=model.max_len))
    jt = jengine.Trainer(model, jcfg.TrainConfig(learning_rate=3e-3, seed=2))
    state = jt.init_state(params=jax_init_params(JaxClassifier(model), model, jax.random.key(8)))
    rng = np.random.default_rng(9)
    for _ in range(3):
        ids = rng.integers(5, VOCAB, (8, model.max_len)).astype(np.int32)
        batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": rng.integers(0, 2, 8).astype(np.int32)}
        state, _ = jt.train_step(state, batch)
    host = jax.tree.map(lambda x: np.array(x, copy=True), jt.host_params(state))
    with JaxCheckpointer(os.path.join(tmp, "jax_ckpt")) as ckpt:
        ckpt.save(int(state.step), state, meta={"client_id": 0, "kind": "local", "config": exp.to_dict()})
        ckpt.wait()
    return exp, host


def _port_checkpoint(exp, host, path):
    model = pcfg.ModelConfig(**dataclasses.asdict(exp.model))
    cfg = pcfg.ExperimentConfig(model=model, data=pcfg.DataConfig(max_len=model.max_len))
    trainer = Trainer(model, cfg.train, device="cpu")
    state = trainer.init_state(params=params_from_jax(host))
    state.step = 3
    with Checkpointer(path) as ckpt:
        ckpt.save(3, state, meta={"client_id": 0, "kind": "local", "config": cfg.to_dict()})


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_predict_csv_matches_jax_predict(flows_csv, tmp_path, impl):
    exp, host = _train_jax(impl, str(tmp_path))
    _port_checkpoint(exp, host, str(tmp_path / "port_ckpt"))
    jout, pout = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jax_args = ["predict", "--csv", flows_csv, "--checkpoint-dir", str(tmp_path / "jax_ckpt"), "--output", jout]
    assert jax_main(jax_args) == 0
    # A threshold inside the probs' range, so both classes are predicted.
    threshold = f"{np.median(_read(jout)[0]):.6f}"
    assert jax_main([*jax_args, "--threshold", threshold]) == 0
    # The preset on the command line is not the checkpoint's: the recorded
    # config wins, as in the JAX package.
    res = run_predict(build_parser().parse_args([
        "predict", "--device", "cpu", "--csv", flows_csv, "--preset", "distilbert",
        "--checkpoint-dir", str(tmp_path / "port_ckpt"), "--output", pout, "--threshold", threshold,
    ]))
    assert res["model_config"].attention_impl == impl and res["model_config"].dim == 32
    jp, jpred, jname = _read(jout)
    pp, ppred, pname = _read(pout)
    assert len(pp) == len(jp) == 96
    np.testing.assert_allclose(pp, jp, atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(pp.astype(np.float32), res["probs"])  # the CSV holds the probs as scored
    far = np.abs(jp - float(threshold)) > 2e-5
    assert far.sum() > 48 and 0 < jpred[far].sum() < far.sum()
    np.testing.assert_array_equal(ppred[far], jpred[far])
    assert [n for n, f in zip(pname, far) if f] == [n for n, f in zip(jname, far) if f]
    assert set(pname) <= {"DDoS", "BENIGN"}
    assert res["labels"] is not None and len(res["labels"]) == 96


def test_predict_unlabeled_csv_and_threshold(flows_csv, tmp_path):
    exp, host = _train_jax("dot", str(tmp_path))
    _port_checkpoint(exp, host, str(tmp_path / "ck"))
    unlabeled = str(tmp_path / "unlabeled.csv")
    pd.read_csv(flows_csv).drop(columns=["Label"]).to_csv(unlabeled, index=False)
    for threshold, flagged in (("1.01", 0), ("0.0", 96)):
        out = str(tmp_path / f"u{threshold}.csv")
        assert main(["predict", "--device", "cpu", "--csv", unlabeled, "--checkpoint-dir", str(tmp_path / "ck"),
                     "--output", out, "--threshold", threshold]) == 0
        probs, preds, _ = _read(out)
        assert len(probs) == 96 and preds.sum() == flagged
        assert ((probs >= 0) & (probs <= 1)).all()


def test_predict_requires_weights(flows_csv, tmp_path):
    with pytest.raises(SystemExit, match="trained weights"):
        main(["predict", "--device", "cpu", "--csv", flows_csv, "--output", str(tmp_path / "p.csv")])
    with pytest.raises(SystemExit, match="--csv"):
        main(["predict", "--device", "cpu", "--checkpoint-dir", str(tmp_path)])


def test_predict_missing_checkpoint_errors(flows_csv, tmp_path):
    empty = str(tmp_path / "nothing")
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="no checkpoint found"):
        main(["predict", "--device", "cpu", "--csv", flows_csv, "--checkpoint-dir", empty,
              "--output", str(tmp_path / "x.csv")])


def test_predict_nonexistent_checkpoint_dir_not_created(flows_csv, tmp_path):
    bogus = str(tmp_path / "no" / "such" / "run")
    with pytest.raises(SystemExit, match="does not exist"):
        main(["predict", "--device", "cpu", "--csv", flows_csv, "--checkpoint-dir", bogus,
              "--output", str(tmp_path / "x.csv")])
    assert not os.path.exists(bogus)


def test_predict_rejects_training_data_flags(flows_csv, tmp_path):
    with pytest.raises(SystemExit, match="training-data option"):
        main(["predict", "--device", "cpu", "--csv", flows_csv, "--synthetic", "100",
              "--checkpoint-dir", str(tmp_path), "--output", str(tmp_path / "x.csv")])


def test_predict_reads_a_federated_checkpoint(flows_csv, tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.federated import (
        run_federated,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.cicids import (
        frame_labels,
        frame_texts,
        load_flow_csv,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
        TokenizedSplit,
    )

    ckpt_dir = str(tmp_path / "fed")
    res = run_federated(build_parser().parse_args([
        "federated", "--device", "cpu", "--preset", "tiny", "--attention-impl", "flash", "--synthetic", "400",
        "--num-clients", "3", "--partition", "dirichlet", "--rounds", "2", "--epochs", "1",
        "--checkpoint-dir", ckpt_dir, "--output-dir", str(tmp_path / "out"),
    ]))
    pred = run_predict(build_parser().parse_args(
        ["predict", "--device", "cpu", "--csv", flows_csv, "--checkpoint-dir", ckpt_dir, "--output", str(tmp_path / "p.csv")]
    ))
    assert pred["model_config"] == res["config"].model
    frame = load_flow_csv(flows_csv)
    tok = default_tokenizer()
    enc = tok.batch_encode(frame_texts(frame), max_len=res["config"].model.max_len)
    split = TokenizedSplit(enc["input_ids"], enc["attention_mask"], frame_labels(frame, res["config"].data))
    trainer = res["trainer"]
    rows = trainer.evaluate_clients(res["state"].params, [split] * 3, collect_probs=True)
    np.testing.assert_array_equal(pred["probs"], rows[0]["probs"])
    assert all(np.array_equal(r["probs"], rows[0]["probs"]) for r in rows)  # every row holds the aggregate


def test_predict_refuses_a_checkpoint_of_another_shape(flows_csv, tmp_path):
    """Without a recorded config the preset is the claim, and a shape
    mismatch raises rather than scoring."""
    trainer = Trainer(pcfg.ModelConfig.tiny(vocab_size=VOCAB, dim=48, n_heads=2), pcfg.TrainConfig(), device="cpu")
    with Checkpointer(str(tmp_path / "c")) as ckpt:
        ckpt.save(1, trainer.init_state())
    with pytest.raises(SystemExit, match="does not match"):
        main(["predict", "--device", "cpu", "--csv", flows_csv, "--checkpoint-dir", str(tmp_path / "c"),
              "--output", str(tmp_path / "x.csv")])


def test_predict_without_cuda_raises(flows_csv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = build_parser().parse_args(["predict", "--csv", flows_csv, "--checkpoint-dir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        args.fn(args)
