"""The port's knowledge distillation held against the JAX package's, on
the CPU.

* ``distillation_loss`` on the same logits at rtol 1e-6
  (tests/test_distill.py's bound);
* ``init_student_from_teacher`` bit for bit at strides 1 and 2 and a
  non-divisible depth (5 -> 2), the student sharing no storage with the
  teacher;
* ``DistillTrainer`` from one teacher and one student init, dropout off:
  per-step KD losses at rtol 1e-5 and params at the trajectory bound atol
  2e-6 / rtol 1e-5, the teacher bit-identical after distillation;
* the ``distill`` verb end to end on the CPU for each teacher source (a
  fresh teacher, ``--teacher-checkpoint``, ``--pth`` + ``--hf-dir``),
  each error path with the JAX verb's SystemExit, and ``distill --pth
  --hf-dir`` in both packages with dropout off through ``--config``:
  ``student_metrics.csv`` at Accuracy/Precision/Recall/F1 rtol 1e-6 and
  Loss rtol 1e-5.
"""

import csv
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data.tokenizer import (
    build_domain_vocab,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train import (
    distill as jdistill,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.distill import (
    run_distill,
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
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    distill as pdistill,
)

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)


def _cfgs(n_layers, **kw):
    port = pcfg.ModelConfig.tiny(n_layers=n_layers, **NO_DROP, **kw)
    return port, jcfg.ModelConfig(**dataclasses.asdict(port))


def _jax_params(cfg, seed):
    return jax.tree.map(np.asarray, jax_init_params(JaxClassifier(cfg), cfg, jax.random.key(seed)))


def _split(cfg, n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
    ids[:, 0] = 2
    lengths = rng.integers(cfg.max_len // 3, cfg.max_len + 1, n)
    mask = (np.arange(cfg.max_len)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return TokenizedSplit(ids, mask, rng.integers(0, cfg.n_classes, n).astype(np.int32))


@pytest.mark.parametrize("temperature,alpha", [(2.0, 0.5), (1.0, 1.0), (4.0, 0.0), (0.5, 0.3)])
def test_distillation_loss_matches_jax(temperature, alpha):
    rng = np.random.default_rng(0)
    s = rng.normal(size=(9, 2)).astype(np.float32) * 3
    t = rng.normal(size=(9, 2)).astype(np.float32) * 3
    y = rng.integers(0, 2, 9).astype(np.int32)
    want = jdistill.distillation_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(y), temperature=temperature, alpha=alpha)
    got = pdistill.distillation_loss(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(y), temperature=temperature, alpha=alpha)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("teacher_layers,student_layers,stride", [(2, 2, 1), (4, 2, 2), (5, 2, 2)])
def test_init_student_from_teacher_matches_jax(teacher_layers, student_layers, stride):
    tp, tj = _cfgs(teacher_layers)
    sp, sj = _cfgs(student_layers)
    jteacher, jstudent = _jax_params(tj, 1), _jax_params(sj, 2)
    want = jdistill.init_student_from_teacher(jstudent, jteacher, stride=stride)
    pteacher = build_trainable_params(tp, params_from_jax(jteacher), torch.device("cpu"))
    pstudent = params_from_jax(jstudent)
    got = pdistill.init_student_from_teacher(pstudent, pteacher, stride=stride)
    ref = params_from_jax(want)
    assert got.keys() == ref.keys()
    for n, t in ref.items():
        assert torch.equal(got[n], t), n
        assert not got[n].requires_grad
    teacher_ptrs = {t.untyped_storage().data_ptr() for t in pteacher.values()}
    assert not teacher_ptrs & {t.untyped_storage().data_ptr() for t in got.values()}
    with pytest.raises(ValueError, match="but teacher has"):
        pdistill.init_student_from_teacher(pstudent, pteacher, stride=teacher_layers)
    wide = params_from_jax(_jax_params(jcfg.ModelConfig(**dataclasses.asdict(pcfg.ModelConfig.tiny(dim=16, n_layers=1))), 3))
    with pytest.raises(ValueError, match="depth-only distillation"):
        pdistill.init_student_from_teacher(wide, pteacher, stride=1)


@pytest.mark.parametrize("setting", ["kd", "kd_clip_warmup"])
def test_distill_trainer_matches_jax(setting):
    kw = dict(learning_rate=1e-3, seed=3)
    if setting == "kd_clip_warmup":
        kw.update(max_grad_norm=0.05, warmup_steps=3)
    tp, tj = _cfgs(4)
    sp, sj = _cfgs(2)
    dcfg = dict(temperature=3.0, alpha=0.7)
    jteacher = _jax_params(tj, 5)
    jt = jdistill.DistillTrainer(sj, tj, jcfg.TrainConfig(**kw), jcfg.DistillConfig(**dcfg))
    pt = pdistill.DistillTrainer(sp, tp, pcfg.TrainConfig(**kw), pcfg.DistillConfig(**dcfg), device="cpu")
    pteacher = build_trainable_params(tp, params_from_jax(jteacher), torch.device("cpu"))
    before = {n: t.detach().clone() for n, t in pteacher.items()}
    jstate = jt.init_student_state(jax.tree.map(jnp.asarray, jteacher))
    pstate = pt.init_student_state(pteacher)
    got, want = flatten_tree(params_to_jax(pstate.params)), flatten_tree(jax.tree.map(np.asarray, jstate.params))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    batches = list(batch_iterator(_split(sp, 48, seed=6), 8, shuffle=True, seed=7))
    for i, batch in enumerate(batches):
        jstate, jloss = jt.distill_step(jstate, jax.tree.map(jnp.asarray, jteacher), batch)
        pstate, ploss = pt.distill_step(pstate, pteacher, batch)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5, err_msg=f"step {i}")
    assert pstate.step == int(jstate.step) == len(batches)
    got, want = flatten_tree(params_to_jax(pstate.params)), flatten_tree(jax.tree.map(np.asarray, jstate.params))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-6, rtol=1e-5, err_msg=name)
    for n, t in before.items():
        assert torch.equal(pteacher[n], t), n  # the teacher is never trained
    # The epoch loop rides Trainer.fit: the same mean loss as the steps.
    state2 = pt.init_student_state(pteacher)
    state2, losses = pt.distill(state2, pteacher, _split(sp, 48, seed=6), batch_size=8, epochs=1)
    assert len(losses) == 1 and np.isfinite(losses[0])


# ------------------------------------------------------------------- CLI
VOCAB, DIM = 160, 32


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    root = tmp_path_factory.mktemp("distill_hf")
    torch.manual_seed(0)
    model = transformers.DistilBertModel(transformers.DistilBertConfig(
        vocab_size=VOCAB, dim=DIM, n_layers=2, n_heads=2, hidden_dim=64, max_position_embeddings=64,
    ))
    path = str(root / "hf")
    model.save_pretrained(path)
    vocab = build_domain_vocab()[:VOCAB]
    vocab += [f"[unused{i}]" for i in range(VOCAB - len(vocab))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    g = torch.Generator().manual_seed(1)
    sd = {f"distilbert.{k}": v for k, v in model.state_dict().items()}
    sd["classifier.weight"] = torch.randn(2, DIM, generator=g)
    sd["classifier.bias"] = torch.zeros(2)
    pth = str(root / "client1_model.pth")
    torch.save(sd, pth)
    return {"hf": path, "pth": pth, "root": str(root)}


BASE = ["--synthetic", "300", "--epochs", "1", "--batch-size", "8", "--learning-rate", "1e-3"]


def _port(argv, out):
    return run_distill(build_parser().parse_args(["distill", "--device", "cpu", *BASE, "--output-dir", out, *argv]))


def _metrics(path):
    with open(path) as f:
        return next(csv.DictReader(f))


def test_distill_fresh_teacher_end_to_end(tmp_path):
    res = _port(["--checkpoint-dir", str(tmp_path / "ckpt")], str(tmp_path / "out"))
    assert res["teacher_config"].n_layers == 4 and res["config"].model.n_layers == 2
    assert res["teacher_losses"] and np.isfinite(res["losses"]).all()
    # Student layer i starts as teacher layer 2i (embeddings and head as
    # they are).
    for n, t in res["initial"].items():
        src = re.sub(r"layer_(\d+)", lambda m: f"layer_{2 * int(m.group(1))}", n)
        assert torch.equal(t, res["teacher_params"][src]), n
    for path in res["metrics_csvs"]:
        assert set(_metrics(path)) == {"Accuracy", "Loss", "Precision", "Recall", "F1-Score"}
    # The checkpoint records the STUDENT's architecture; predict reads it.
    meta = json.load(open(os.path.join(tmp_path / "ckpt", str(res["state"].step), "meta.json")))
    assert meta["distilled"] and meta["config"]["model"]["n_layers"] == 2


def test_distill_from_teacher_checkpoint(tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.local import (
        run_local,
    )

    ckpt = str(tmp_path / "teacher")
    run_local(build_parser().parse_args(["local", "--device", "cpu", *BASE, "--output-dir", str(tmp_path / "t"), "--checkpoint-dir", ckpt]))
    res = _port(["--teacher-checkpoint", ckpt, "--student-layers", "1"], str(tmp_path / "out"))
    assert res["teacher_losses"] is None and res["teacher_config"].n_layers == 2
    # stride 2 -> the 1-layer student is teacher layer 0.
    assert torch.equal(res["initial"]["encoder.layer_0.lin1.weight"], res["teacher_params"]["encoder.layer_0.lin1.weight"])


def test_distill_pth_hf_dir_matches_jax(hf_dir, tmp_path):
    """Dropout off through --config: the JAX verb and the port's write the
    same student metrics."""
    cfg = {"model": {**dataclasses.asdict(pcfg.ModelConfig.tiny(dim=DIM, vocab_size=VOCAB)), **NO_DROP},
           "data": {"max_len": 32}, "train": {"learning_rate": 1e-3, "epochs_per_round": 1, "seed": 2}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    argv = ["--config", str(cfg_path), "--hf-dir", hf_dir["hf"], "--pth", hf_dir["pth"], "--student-layers", "1",
            "--synthetic", "300", "--batch-size", "8", "--max-len", "32"]
    jout, pout = str(tmp_path / "j"), str(tmp_path / "p")
    assert jax_main(["distill", *argv, "--output-dir", jout]) == 0
    run_distill(build_parser().parse_args(["distill", "--device", "cpu", *argv, "--output-dir", pout]))
    for who in ("teacher", "student"):
        j, p = _metrics(os.path.join(jout, f"{who}_metrics.csv")), _metrics(os.path.join(pout, f"{who}_metrics.csv"))
        for key in ("Accuracy", "Precision", "Recall", "F1-Score"):
            np.testing.assert_allclose(float(p[key]), float(j[key]), rtol=1e-6, err_msg=f"{who} {key}")
        np.testing.assert_allclose(float(p["Loss"]), float(j["Loss"]), rtol=1e-5, err_msg=f"{who} Loss")


def _jax_exit(argv, out):
    with pytest.raises(SystemExit) as e:
        jax_main(["distill", *BASE, "--output-dir", out, *argv])
    return str(e.value)


def _port_exit(argv, out):
    with pytest.raises(SystemExit) as e:
        _port(argv, out)
    return str(e.value)


@pytest.mark.parametrize("case", ["both_sources", "pth_teacher_layers", "student_zero", "shallow_teacher", "missing_checkpoint"])
def test_distill_errors_match_jax(hf_dir, tmp_path, case):
    argv = {
        "both_sources": ["--teacher-checkpoint", str(tmp_path), "--pth", hf_dir["pth"], "--hf-dir", hf_dir["hf"]],
        "pth_teacher_layers": ["--pth", hf_dir["pth"], "--hf-dir", hf_dir["hf"], "--teacher-layers", "4"],
        "student_zero": ["--student-layers", "0"],
        "shallow_teacher": ["--teacher-layers", "1"],
        "missing_checkpoint": ["--teacher-checkpoint", str(tmp_path / "nowhere")],
    }[case]
    want = _jax_exit(argv, str(tmp_path / "j"))
    assert _port_exit(argv, str(tmp_path / "p")) == want


@pytest.mark.parametrize("case", ["shallow", "narrow"])
def test_distill_teacher_checkpoint_checks_match_jax(tmp_path, case):
    """A teacher checkpoint shallower or narrower than the student: each
    package's own checkpoint of the same config, the same SystemExit."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.local import (
        run_local,
    )

    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.tokenizer import (
        default_tokenizer,
    )

    shape = {"n_layers": 1} if case == "shallow" else {"dim": 16}
    model = dataclasses.asdict(pcfg.ModelConfig.tiny(vocab_size=len(default_tokenizer()), **shape))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"model": model, "data": {"max_len": 32}}))
    jck, pck = str(tmp_path / "jck"), str(tmp_path / "pck")
    common = ["--config", str(cfg_path), *BASE]
    assert jax_main(["local", *common, "--output-dir", str(tmp_path / "jl"), "--checkpoint-dir", jck]) == 0
    run_local(build_parser().parse_args(["local", "--device", "cpu", *common, "--output-dir", str(tmp_path / "pl"), "--checkpoint-dir", pck]))
    want = _jax_exit(["--teacher-checkpoint", jck], str(tmp_path / "j"))
    assert _port_exit(["--teacher-checkpoint", pck], str(tmp_path / "p")) == want
    assert ("shallower" if case == "shallow" else "depth-only") in want


def test_new_entry_points_run_on_the_card_unless_told(monkeypatch, tmp_path):
    """distill and export-hf default to the card and raise without one
    (before any work), as every port entry point does."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.predict import (
        run_export_hf,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = build_parser().parse_args(["distill", *BASE, "--output-dir", str(tmp_path / "d")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_distill(args)
    args = build_parser().parse_args(["export-hf", "--checkpoint-dir", str(tmp_path), "--out", str(tmp_path / "o")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_export_hf(args)
    assert not os.path.exists(tmp_path / "d") and not os.path.exists(tmp_path / "o")
