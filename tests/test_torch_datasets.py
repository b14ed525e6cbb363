"""The port's dataset registry held against the JAX package's, on the CPU.

(a) Each of the four specs renders byte-equal texts and gives equal
    binary and class labels to the JAX spec on a CSV the JAX package
    wrote, each package reading it with its own loader (UNSW-NB15's
    string columns and a multi-class Label included).
(b) Schema detection agrees on the three schemas and on real
    CICIDS2017-style label vocabularies.
(c) The port's generators give the JAX generators' rows, column by
    column, for two seeds.
(d) A two-source mixed corpus gives the same texts, labels and
    provenance, and the same client splits.
(e) ``local --dataset unswnb15`` and ``local --source`` match the JAX
    ``local`` from the same weights (dropout off in both presets): the
    metrics CSVs within the bounds tests/test_torch_federated.py holds
    the ``federated`` CSVs to (rtol 1e-6, Loss rtol 1e-5), and the
    per-epoch losses within tests/test_torch_train.py's trajectory bound
    (rtol 1e-5).
"""

import csv
import dataclasses

import jax
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    cicids as jcicids,
    datasets as jdatasets,
    synthetic as jsynthetic,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models import (
    presets as jpresets,
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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    cicids as pcicids,
    datasets as pdatasets,
    synthetic as psynthetic,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    params_from_jax,
    presets as ppresets,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    engine as pengine,
)

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
METRICS = ("Accuracy", "Precision", "Recall", "F1-Score")
#: Each spec, and the generator whose schema and label vocabulary it reads.
SPECS = {
    "cicids2017": "cicids2017",
    "cicddos2019": "cicddos2019",
    "unswnb15": "unswnb15",
    "cicddos2019-mc": "cicddos2019",
}


def _assert_frames_equal(port_frame, df):
    assert list(port_frame) == list(df.columns)
    for name in df.columns:
        want = df[name].to_numpy()
        got = port_frame[name]
        if want.dtype.kind in "fiu":
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)  # NaN == NaN here
        else:
            assert [str(x) for x in got] == [str(x) for x in want], name


def test_registry_matches_jax():
    assert list(pdatasets.DATASETS) == list(jdatasets.DATASETS)
    for name, spec in pdatasets.DATASETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jdatasets.DATASETS[name])
        assert spec.n_classes == jdatasets.DATASETS[name].n_classes
        assert spec.feature_columns == jdatasets.DATASETS[name].feature_columns
    with pytest.raises(ValueError, match="unknown dataset 'nope'"):
        pdatasets.get_dataset("nope")
    for arg in ("unswnb15=a.csv", "b.csv", "cicddos2019=dir/x=y.csv"):
        assert pdatasets.parse_source_arg(arg) == jdatasets.parse_source_arg(arg)
    with pytest.raises(ValueError, match="unknown dataset"):
        pdatasets.parse_source_arg("nope=a.csv")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_texts_and_labels_match_jax(name, tmp_path):
    path = str(tmp_path / "flows.csv")
    jsynthetic.write_synthetic_csv(path, dataset=SPECS[name], n_rows=120, seed=5)
    df = jcicids.load_flow_csv(path)
    frame = pcicids.load_flow_csv(path)
    _assert_frames_equal(frame, df)
    spec, jspec = pdatasets.get_dataset(name), jdatasets.get_dataset(name)
    texts = spec.render_texts(frame)
    assert texts == jspec.render_texts(df)
    assert all(t.isascii() for t in texts)
    binary = spec.binary_labels(frame)
    np.testing.assert_array_equal(binary, jspec.binary_labels(df))
    assert binary.dtype == np.int32 and 0 < binary.sum() < len(binary)
    labels = spec.labels(frame)
    np.testing.assert_array_equal(labels, jspec.labels(df))
    if spec.label_kind == "multiclass":
        np.testing.assert_array_equal(spec.class_labels(frame), jspec.class_labels(df))
        assert set(labels.tolist()) == set(range(spec.n_classes))
        np.testing.assert_array_equal(labels != 0, binary.astype(bool))
    else:
        with pytest.raises(ValueError, match="not a multiclass spec"):
            spec.class_labels(frame)
    # The client-split path labels through the configured spec, as the
    # JAX package's does.
    np.testing.assert_array_equal(
        pcicids.frame_labels(frame, pcfg.DataConfig(dataset=name)),
        jcicids._spec_labels(df, jcfg.DataConfig(dataset=name)),
    )
    corpus, jcorpus = pdatasets.corpus_from_frame(frame, spec, 3), jdatasets.corpus_from_frame(df, jspec, 3)
    assert corpus.texts == jcorpus.texts and corpus.source_names == jcorpus.source_names
    np.testing.assert_array_equal(corpus.labels, jcorpus.labels)
    np.testing.assert_array_equal(corpus.source, jcorpus.source)


def test_spec_refusals_match_jax():
    frame = psynthetic.make_synthetic("cicids2017", 20, seed=1)
    df = jsynthetic.make_synthetic("cicids2017", 20, seed=1)
    with pytest.raises(KeyError, match="missing template columns"):
        pdatasets.UNSWNB15.render_texts(frame)
    with pytest.raises(KeyError, match="no label column 'label'"):
        pdatasets.UNSWNB15.binary_labels(frame)
    df["Label"] = ["Nope"] * 20
    frame["Label"] = np.array(["Nope"] * 20, dtype=object)
    with pytest.raises(ValueError, match=r"labels \['Nope'\] not in the declared"):
        pdatasets.CICDDOS2019_MC.class_labels(frame)
    with pytest.raises(ValueError, match=r"labels \['Nope'\] not in the declared"):
        jdatasets.CICDDOS2019_MC.class_labels(df)


LABEL_VOCABS = {
    "cicids2017-real": ["BENIGN", "PortScan", "Bot", "DoS Hulk", "DDoS", "Web Attack \x96 Brute Force"],
    "cicids2017-benign": ["BENIGN"],
    "ddos2019-drdos": ["BENIGN", "DrDoS_SNMP"],
    "ddos2019-syn": ["BENIGN", "Syn", "UDP-lag"],
    "ddos2019-webddos": ["WebDDoS", "BENIGN"],
}


@pytest.mark.parametrize("vocab", sorted(LABEL_VOCABS))
def test_detect_dataset_matches_jax_on_label_vocabularies(vocab):
    values = LABEL_VOCABS[vocab] * 3
    frame = psynthetic.make_synthetic_flows(len(values), seed=2)
    df = jsynthetic.make_synthetic_flows(len(values), seed=2)
    frame["Label"] = np.array(values, dtype=object)
    df["Label"] = values
    got, want = pdatasets.detect_dataset(frame), jdatasets.detect_dataset(df)
    assert got.name == want.name
    assert got.name == ("cicddos2019" if vocab.startswith("ddos2019") else "cicids2017")


@pytest.mark.parametrize("schema", ["cicids2017", "cicddos2019", "unswnb15"])
def test_detect_dataset_matches_jax_on_schemas(schema):
    frame = psynthetic.make_synthetic(schema, 40, seed=3)
    df = jsynthetic.make_synthetic(schema, 40, seed=3)
    assert pdatasets.detect_dataset(frame).name == jdatasets.detect_dataset(df).name == schema
    del frame["Label" if schema != "unswnb15" else "dur"]
    with pytest.raises(ValueError, match="cannot detect dataset"):
        pdatasets.detect_dataset(frame)


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("dataset", ["cicids2017", "cicddos2019", "unswnb15"])
def test_generators_match_jax(dataset, seed):
    frame = psynthetic.make_synthetic(dataset, 300, seed=seed)
    df = jsynthetic.make_synthetic(dataset, 300, seed=seed)
    _assert_frames_equal(frame, df)
    with pytest.raises(ValueError, match="no synthetic generator"):
        psynthetic.make_synthetic("cicddos2019-mc", 10)
    assert psynthetic.DDOS2019_ATTACKS == jsynthetic.DDOS2019_ATTACKS


@pytest.fixture(scope="module")
def two_sources(tmp_path_factory):
    """A UNSW-NB15 CSV and a CIC-DDoS2019 CSV the JAX package wrote."""
    d = tmp_path_factory.mktemp("sources")
    unsw, ddos = str(d / "unsw.csv"), str(d / "ddos.csv")
    jsynthetic.write_synthetic_csv(unsw, dataset="unswnb15", n_rows=300, seed=7)
    jsynthetic.write_synthetic_csv(ddos, dataset="cicddos2019", n_rows=300, seed=8)
    return unsw, ddos


@pytest.mark.parametrize("partition", ["sample", "disjoint"])
def test_mixed_corpus_and_its_splits_match_jax(two_sources, partition):
    unsw, ddos = two_sources
    entries = [("unswnb15", unsw), (None, ddos)]  # the second one sniffed
    corpus, jcorpus = pdatasets.load_mixed_corpus(entries), jdatasets.load_mixed_corpus(entries)
    assert corpus.source_names == jcorpus.source_names == ("unswnb15", "cicddos2019")
    assert corpus.texts == jcorpus.texts and len(corpus) == 600
    np.testing.assert_array_equal(corpus.labels, jcorpus.labels)
    np.testing.assert_array_equal(corpus.source, jcorpus.source)
    assert np.bincount(corpus.source).tolist() == [300, 300]
    kw = dict(partition=partition, data_fraction=0.3)
    got = pcicids.make_all_client_splits_from_corpus(corpus, 3, pcfg.DataConfig(**kw))
    want = jcicids.make_all_client_splits_from_corpus(jcorpus, 3, jcfg.DataConfig(**kw))
    for g, w in zip(got, want, strict=True):
        for part in ("train", "val", "test"):
            assert getattr(g, part).texts == getattr(w, part).texts
            np.testing.assert_array_equal(getattr(g, part).labels, getattr(w, part).labels)
    # A client's shard spans both sources.
    assert any(t.startswith("Protocol is") for t in got[0].train.texts)
    assert any(t.startswith("Destination port is") for t in got[0].train.texts)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return list(rows[0]), {k: float(v) for k, v in rows[0].items()}


@pytest.fixture
def same_init(monkeypatch):
    """Dropout off in both presets; the port's Trainer starts from the
    JAX Trainer's init for the same seed (the JAX key and PRNG impl)."""
    monkeypatch.setitem(ppresets.PRESETS, "tiny", lambda **kw: pcfg.ModelConfig.tiny(**NO_DROP, **kw))
    monkeypatch.setitem(jpresets.PRESETS, "tiny", lambda **kw: jcfg.ModelConfig.tiny(**NO_DROP, **kw))

    def port_init(cfg, generator):
        jm = jcfg.ModelConfig(**dataclasses.asdict(cfg))
        key = jax.random.key(jcfg.TrainConfig().seed, impl=jcfg.TrainConfig().prng_impl)
        tree = jax_init_params(JaxClassifier(jm), jm, key)
        return params_from_jax(jax.tree.map(np.asarray, tree))

    monkeypatch.setattr(pengine, "init_params", port_init)
    jax_losses = []
    fit = jengine.Trainer.fit

    def jax_fit(self, *a, **kw):
        state, losses = fit(self, *a, **kw)
        jax_losses.append([float(x) for x in losses])
        return state, losses

    monkeypatch.setattr(jengine.Trainer, "fit", jax_fit)
    return jax_losses


@pytest.mark.parametrize("data", ["dataset", "source"])
def test_local_on_new_schemas_matches_the_jax_cli(data, two_sources, tmp_path, same_init):
    unsw, ddos = two_sources
    flags = {
        "dataset": ["--dataset", "unswnb15", "--synthetic", "600"],
        "source": ["--source", f"unswnb15={unsw}", "--source", ddos, "--data-fraction", "0.3"],
    }[data]
    argv = ["local", "--preset", "tiny", "--epochs", "2", *flags]
    assert jax_main(argv + ["--output-dir", str(tmp_path / "jax")]) == 0
    res = run_local(build_parser().parse_args(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "port")]))
    assert res["config"].data.dataset == ("unswnb15" if data == "dataset" else "cicids2017")
    (jax_losses,) = same_init
    assert len(jax_losses) == 2
    np.testing.assert_allclose(res["losses"], jax_losses, rtol=1e-5)
    cols, got = _read_csv(tmp_path / "port" / "client0_local_metrics.csv")
    jcols, want = _read_csv(tmp_path / "jax" / "client0_local_metrics.csv")
    assert cols == jcols == ["Accuracy", "Loss", "Precision", "Recall", "F1-Score"]
    for key in METRICS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(got["Loss"], want["Loss"], rtol=1e-5)


def test_data_flags_are_refused_where_the_jax_cli_refuses_them(tmp_path, two_sources):
    unsw, _ = two_sources
    args = build_parser().parse_args(
        ["local", "--device", "cpu", "--csv", unsw, "--source", unsw, "--output-dir", str(tmp_path)]
    )
    with pytest.raises(SystemExit, match="mutually exclusive"):
        run_local(args)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["local", "--dataset", "nope"])
    args = build_parser().parse_args(["local", "--device", "cpu", "--source", "nope=x.csv"])
    with pytest.raises(SystemExit, match="unknown dataset"):
        run_local(args)
    args = build_parser().parse_args(
        ["local", "--device", "cpu", "--dataset", "cicddos2019-mc", "--synthetic", "60"]
    )
    with pytest.raises(SystemExit, match="no synthetic generator"):
        run_local(args)
    for verb in (["local"], ["federated"], ["client", "--client-id", "0"], ["predict"]):
        args = build_parser().parse_args([*verb, "--dataset", "unswnb15", "--source", "a.csv", "--source", "b.csv"])
        assert args.dataset == "unswnb15" and args.source == ["a.csv", "b.csv"]
