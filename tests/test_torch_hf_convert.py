"""The port's pretrained start and HF export held against the JAX
package's, on the CPU.

* ``load_hf_dir`` (``model.safetensors`` through the port's own reader,
  and ``pytorch_model.bin``) equals ``params_from_jax`` of the JAX
  ``load_hf_dir`` bit for bit, the fresh head included, and
  ``config_from_hf_dir`` gives the same fields; the HF directories are
  written by ``transformers``' ``save_pretrained`` from a random init (no
  download).
* A reference-style ``.pth``, a headless one, a ``pre_classifier``
  checkpoint, a vocabulary mismatch, ``--pth`` without ``--hf-dir`` and
  the gelu precedence give the JAX package's result or its SystemExit.
* The port's safetensors writer gives ``safetensors.numpy``'s bytes, and
  its reader reads what ``transformers`` wrote.
* ``export-hf --pth --hf-dir``: the JAX export's ``config.json``,
  ``vocab.txt`` and ``model.safetensors`` byte for byte, read back
  exactly by ``safetensors.numpy`` and ``transformers``; from a training
  checkpoint the export reads back as the checkpoint's own weights (the
  port writes every tensor C-ordered, as the format says).
* ``predict --hf-dir --pth`` in both packages: probabilities at atol 1e-5
  (tests/test_torch_train.py's bound), and ``infer-serve --hf-dir --pth``
  scores as ``predict`` does.
"""

import csv
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    _resolve_with_pretrained as jax_resolve,
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    write_synthetic_csv,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data.tokenizer import (
    build_domain_vocab,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models import (
    hf_convert as jhf,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
    _resolve_with_pretrained as port_resolve,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.predict import (
    run_export_hf,
    run_predict,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    hf_convert as phf,
    params_from_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    safetensors as pst,
)

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

torch.set_num_threads(1)

DIM, LAYERS, HEADS, FFN, VOCAB = 48, 2, 4, 96, 160


def _write_vocab(path, n=VOCAB):
    vocab = build_domain_vocab()[:n]
    vocab += [f"[unused{i}]" for i in range(n - len(vocab))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")


def _hf_model(seed=0):
    torch.manual_seed(seed)
    cfg = transformers.DistilBertConfig(
        vocab_size=VOCAB, dim=DIM, n_layers=LAYERS, n_heads=HEADS, hidden_dim=FFN,
        max_position_embeddings=128,
    )
    return transformers.DistilBertModel(cfg)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """A bare encoder saved as model.safetensors and as pytorch_model.bin,
    a reference-style .pth (``distilbert.*`` + a trained ``classifier.*``)
    and a headless one."""
    root = tmp_path_factory.mktemp("hf")
    model = _hf_model()
    st_dir, bin_dir = str(root / "st"), str(root / "bin")
    model.save_pretrained(st_dir)
    model.save_pretrained(bin_dir, safe_serialization=False)
    for d in (st_dir, bin_dir):
        _write_vocab(d)
    assert os.path.exists(os.path.join(bin_dir, "pytorch_model.bin"))
    g = torch.Generator().manual_seed(3)
    sd = {f"distilbert.{k}": v for k, v in model.state_dict().items()}
    sd["classifier.weight"] = torch.randn(2, DIM, generator=g) * 0.5
    sd["classifier.bias"] = torch.randn(2, generator=g) * 0.1
    pth = str(root / "client1_model.pth")
    torch.save(sd, pth)
    headless = str(root / "headless.pth")
    torch.save({k: v for k, v in sd.items() if not k.startswith("classifier.")}, headless)
    return {"st": st_dir, "bin": bin_dir, "pth": pth, "headless": headless, "root": str(root)}


def _assert_params_equal(port, jax_tree):
    want = params_from_jax(jax_tree)
    assert port.keys() == want.keys()
    for name, t in want.items():
        assert port[name].dtype == torch.float32
        assert torch.equal(port[name], t), name


# ------------------------------------------------------------ conversion
@pytest.mark.parametrize("layout", ["st", "bin"])
def test_load_hf_dir_matches_jax_bit_for_bit(hf_dirs, layout):
    path = hf_dirs[layout]
    pcfg = phf.config_from_hf_dir(path)
    jcfg = jhf.config_from_hf_dir(path)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    port, _ = phf.load_hf_dir(path, head_rng=np.random.default_rng(7))
    jtree, _ = jhf.load_hf_dir(path, head_rng=np.random.default_rng(7))
    _assert_params_equal(port, jtree)
    assert not phf.hf_dir_has_head(path) and not jhf.hf_dir_has_head(path)
    # The encoder is the checkpoint's, exactly.
    hf = transformers.DistilBertModel.from_pretrained(path).state_dict()
    assert torch.equal(port["encoder.layer_1.attn.o.weight"], hf["transformer.layer.1.attention.out_lin.weight"])


def test_reference_pth_matches_jax(hf_dirs):
    pcfg = phf.config_from_hf_dir(hf_dirs["st"])
    port = phf.load_reference_pth(hf_dirs["pth"], pcfg)
    jtree = jhf.load_reference_pth(hf_dirs["pth"], jhf.config_from_hf_dir(hf_dirs["st"]))
    _assert_params_equal(port, jtree)
    sd = torch.load(hf_dirs["pth"], weights_only=True)
    assert torch.equal(port["classifier.weight"], sd["classifier.weight"])
    # The inverse gives the reference's key space back, bit for bit.
    back = phf.port_to_hf(port, pcfg)
    assert back.keys() == {k for k in sd if "position_ids" not in k}
    for k, v in back.items():
        assert v.flags["C_CONTIGUOUS"] and np.array_equal(v, sd[k].numpy()), k


def test_refusals_match_jax(hf_dirs, tmp_path):
    cfg = phf.config_from_hf_dir(hf_dirs["st"])
    jcfg = jhf.config_from_hf_dir(hf_dirs["st"])
    with pytest.raises(ValueError) as pe:
        phf.load_reference_pth(hf_dirs["headless"], cfg)
    with pytest.raises(ValueError) as je:
        jhf.load_reference_pth(hf_dirs["headless"], jcfg)
    assert str(pe.value) == str(je.value)
    sd = dict(torch.load(hf_dirs["pth"], weights_only=True))
    sd["pre_classifier.weight"] = torch.zeros(DIM, DIM)
    sd["pre_classifier.bias"] = torch.zeros(DIM)
    with pytest.raises(ValueError) as pe:
        phf.hf_to_port(sd, cfg)
    with pytest.raises(ValueError) as je:
        jhf.hf_to_flax(sd, jcfg)
    assert str(pe.value) == str(je.value) and "pre_classifier" in str(pe.value)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        phf.load_hf_dir(str(empty), cfg)


def _both(argv):
    """The two packages' ``_resolve_with_pretrained`` on one argv (each
    parsed by its own package's parser), or their SystemExits."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli.parser import (
        build_parser as jax_parser,
    )

    out = []
    for parser, resolve in ((jax_parser(), jax_resolve), (build_parser(), port_resolve)):
        try:
            out.append(resolve(parser.parse_args(argv)))
        except SystemExit as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("case", ["pth_alone", "headless", "vocab"])
def test_cli_errors_match_jax(hf_dirs, tmp_path, case):
    if case == "pth_alone":
        argv = ["local", "--pth", hf_dirs["pth"]]
    elif case == "headless":
        argv = ["local", "--hf-dir", hf_dirs["st"], "--pth", hf_dirs["headless"]]
    else:
        bad = tmp_path / "bad"
        shutil.copytree(hf_dirs["st"], bad)
        with open(bad / "vocab.txt", "a") as f:
            f.write("extratoken\n")
        argv = ["local", "--hf-dir", str(bad)]
    jax_out, port_out = _both(argv)
    assert isinstance(jax_out, str) and jax_out == port_out


def _config_file(path, **model):
    with open(path, "w") as f:
        json.dump({"model": {**dataclasses.asdict(phf.ModelConfig.tiny()), **model}, "data": {"max_len": 32}}, f)
    return str(path)


@pytest.mark.parametrize("case", ["checkpoint_tanh", "flag", "file_names_gelu", "file_without_gelu", "max_len"])
def test_gelu_precedence_and_max_len_match_jax(hf_dirs, tmp_path, case):
    tanh_dir = tmp_path / "tanh"
    shutil.copytree(hf_dirs["st"], tanh_dir)
    cfg_json = json.loads((tanh_dir / "config.json").read_text())
    (tanh_dir / "config.json").write_text(json.dumps({**cfg_json, "activation": "gelu_new"}))
    argv = ["local", "--hf-dir", str(tanh_dir), "--seed", "4"]
    want_gelu = {"checkpoint_tanh": "tanh", "flag": "exact", "file_names_gelu": "exact", "file_without_gelu": "tanh", "max_len": "tanh"}[case]
    if case == "flag":
        argv += ["--gelu", "exact"]
    elif case == "file_names_gelu":
        argv += ["--config", _config_file(tmp_path / "c.json", gelu="exact")]
    elif case == "file_without_gelu":
        model = dataclasses.asdict(phf.ModelConfig.tiny())
        del model["gelu"]
        (tmp_path / "c.json").write_text(json.dumps({"model": model, "data": {"max_len": 32}}))
        argv += ["--config", str(tmp_path / "c.json")]
    elif case == "max_len":
        argv += ["--max-len", "96"]  # past the tiny preset's table, within the checkpoint's
    (jtok, jcfg, jparams), (ptok, pcfg, pparams) = _both(argv)
    assert pcfg.model.gelu == jcfg.model.gelu == want_gelu
    assert dataclasses.asdict(pcfg.model) == dataclasses.asdict(jcfg.model)
    assert dataclasses.asdict(pcfg.data) == dataclasses.asdict(jcfg.data)
    assert pcfg.model.max_len == (96 if case == "max_len" else 128)
    assert ptok.vocab == jtok.vocab
    _assert_params_equal(pparams, jparams)  # the fresh head from --seed 4, in both


# ----------------------------------------------------------- safetensors
def test_safetensors_writer_is_byte_equal_and_reader_reads_transformers(hf_dirs):
    rng = np.random.default_rng(0)
    tensors = {
        "b.weight": rng.normal(size=(3, 5)).astype(np.float32),
        "a.bias": rng.normal(size=5).astype(np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "ids": np.arange(7, dtype=np.int64),
        "half": rng.normal(size=3).astype(np.float16),
        "bytes": np.arange(3, dtype=np.uint8),
    }
    for metadata in (None, {"format": "pt"}):
        assert pst.save(tensors, metadata) == safetensors_numpy.save(tensors, metadata=metadata)
    path = os.path.join(hf_dirs["st"], "model.safetensors")
    header, start = pst.read_header(path)
    assert header["__metadata__"] == {"format": "pt"} and start % 8 == 0
    got, want = pst.load_file(path), safetensors_numpy.load_file(path)
    assert got.keys() == want.keys() and set(pst.tensor_names(path)) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# ------------------------------------------------------------- export-hf
def test_export_hf_matches_jax_export(hf_dirs, tmp_path):
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_main(["export-hf", "--hf-dir", hf_dirs["st"], "--pth", hf_dirs["pth"], "--out", jout]) == 0
    res = run_export_hf(build_parser().parse_args(
        ["export-hf", "--device", "cpu", "--hf-dir", hf_dirs["st"], "--pth", hf_dirs["pth"], "--out", pout]
    ))
    assert sorted(os.listdir(pout)) == ["config.json", "model.safetensors", "vocab.txt"]
    for name in ("config.json", "vocab.txt"):
        with open(os.path.join(jout, name), "rb") as a, open(os.path.join(pout, name), "rb") as b:
            assert a.read() == b.read(), name
    port_bytes = open(os.path.join(pout, "model.safetensors"), "rb").read()
    with open(os.path.join(jout, "model.safetensors"), "rb") as f:
        assert f.read() == port_bytes
    # Read back: the reference's tensors exactly, by safetensors and by
    # transformers.
    sd = torch.load(hf_dirs["pth"], weights_only=True)
    back = safetensors_numpy.load_file(os.path.join(pout, "model.safetensors"))
    assert back.keys() == res["tensors"].keys()
    for k, v in back.items():
        assert np.array_equal(v, sd[k].numpy()), k
    hf = transformers.DistilBertModel.from_pretrained(pout).state_dict()
    for k, v in hf.items():
        if f"distilbert.{k}" in sd:
            assert torch.equal(v, sd[f"distilbert.{k}"]), k
    # And --hf-dir reads the export back with its trained head.
    assert phf.hf_dir_has_head(pout)
    port, _ = phf.load_hf_dir(pout)
    _assert_params_equal(port, jhf.load_reference_pth(hf_dirs["pth"], jhf.config_from_hf_dir(hf_dirs["st"])))


def test_export_hf_of_a_checkpoint_round_trips(hf_dirs, tmp_path):
    """local --hf-dir --checkpoint-dir, export-hf of that checkpoint, then
    --hf-dir of the export: the checkpoint's weights, bit for bit, and
    predict from either gives the same bits."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.local import (
        run_local,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
        Checkpointer,
    )

    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "hf")
    res = run_local(build_parser().parse_args([
        "local", "--device", "cpu", "--hf-dir", hf_dirs["st"], "--synthetic", "300", "--epochs", "1",
        "--batch-size", "8", "--output-dir", str(tmp_path / "o"), "--checkpoint-dir", ckpt,
    ]))
    assert res["state"].step > 0
    run_export_hf(build_parser().parse_args(
        ["export-hf", "--device", "cpu", "--checkpoint-dir", ckpt, "--hf-dir", hf_dirs["st"], "--out", out]
    ))
    saved = Checkpointer(ckpt).restore_params()
    back, cfg = phf.load_hf_dir(out)
    assert back.keys() == saved.keys()
    for n, t in saved.items():
        assert torch.equal(back[n], t), n
    assert cfg.gelu == res["config"].model.gelu


def test_export_hf_refusals(hf_dirs, tmp_path):
    args = build_parser().parse_args(["export-hf", "--device", "cpu", "--hf-dir", hf_dirs["st"], "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="export-hf needs trained weights"):
        run_export_hf(args)
    args = build_parser().parse_args([
        "export-hf", "--device", "cpu", "--hf-dir", hf_dirs["st"], "--pth", hf_dirs["pth"],
        "--checkpoint-dir", str(tmp_path), "--out", str(tmp_path / "o"),
    ])
    with pytest.raises(SystemExit, match="both weight sources"):
        run_export_hf(args)


# --------------------------------------------------------------- predict
def _probs(path):
    with open(path) as f:
        return np.array([float(r["prob_attack"]) for r in csv.DictReader(f)])


@pytest.fixture(scope="module")
def flows_csv(hf_dirs):
    path = os.path.join(hf_dirs["root"], "flows.csv")
    write_synthetic_csv(path, n_rows=40, seed=5)
    return path


def test_predict_hf_dir_pth_matches_jax(hf_dirs, flows_csv, tmp_path):
    jout, pout = str(tmp_path / "j.csv"), str(tmp_path / "p.csv")
    common = ["--csv", flows_csv, "--hf-dir", hf_dirs["st"], "--pth", hf_dirs["pth"]]
    assert jax_main(["predict", *common, "--output", jout]) == 0
    res = run_predict(build_parser().parse_args(["predict", "--device", "cpu", *common, "--output", pout]))
    np.testing.assert_allclose(_probs(pout), _probs(jout), atol=1e-5)
    np.testing.assert_allclose(res["probs"], _probs(jout), atol=1e-5)
    assert len(res["probs"]) == 40


def test_predict_refuses_a_bare_encoder_as_jax(hf_dirs, flows_csv, tmp_path):
    msgs = []
    with pytest.raises(SystemExit) as e:
        jax_main(["predict", "--csv", flows_csv, "--hf-dir", hf_dirs["st"], "--output", str(tmp_path / "j")])
    msgs.append(str(e.value))
    with pytest.raises(SystemExit) as e:
        run_predict(build_parser().parse_args(
            ["predict", "--device", "cpu", "--csv", flows_csv, "--hf-dir", hf_dirs["st"], "--output", str(tmp_path / "p")]
        ))
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "bare encoder" in msgs[0]


def test_infer_serve_hf_dir_pth_scores_as_predict(hf_dirs, flows_csv, tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
        build_server,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.cicids import (
        frame_texts,
        load_flow_csv,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
        ScoringClient,
    )

    pred = run_predict(build_parser().parse_args([
        "predict", "--device", "cpu", "--csv", flows_csv, "--hf-dir", hf_dirs["st"], "--pth", hf_dirs["pth"],
        "--output", str(tmp_path / "p.csv"),
    ]))
    server = build_server(build_parser().parse_args([
        "infer-serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
        "--hf-dir", hf_dirs["st"], "--pth", hf_dirs["pth"],
    ]))
    texts = frame_texts(load_flow_csv(flows_csv))[:8]
    with server:
        client = ScoringClient("127.0.0.1", server.port)
        try:
            replies = [client.score(text=t) for t in texts]
        finally:
            client.close()
    got = np.array([r["prob"] for r in replies])
    np.testing.assert_allclose(got, pred["probs"][:8], atol=1e-5)
    assert server.engine.model_cfg.dim == DIM and len(server.tok.vocab) == VOCAB
