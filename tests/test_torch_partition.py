"""The port's federated data path held against the JAX package's, on the
CPU, array for array:

* ``partition_indices`` for every index-based scheme over several seeds,
  client counts and alphas, its infeasible cases, and the manifest;
* ``make_all_client_splits`` under every scheme (texts, labels, the
  manifest file);
* ``stack_clients``, ``stack_clients_ragged`` and ``stack_eval_splits``;
* both lockstep batch iterators over several seeds and epochs (rows,
  ``valid``, ``warmup_step``), and the ragged one's refusal of a short
  span;
* ``FedConfig``: the JAX fields, defaults, validation and methods, the
  options the port has not reached (DP, personalization, relays and
  lossy wires) raising ``NotImplementedError``, and ``from_dict`` reading
  a config the JAX package wrote.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    cicids as jcicids,
    partition as jpartition,
    pipeline as jpipeline,
    synthetic as jsynthetic,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train import (
    batches as jbatches,
    fedeval as jfedeval,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    cicids as pcicids,
    partition as ppartition,
    pipeline as ppipeline,
    synthetic as psynthetic,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    batches as pbatches,
    fedeval as pfedeval,
)

SCHEMES = ("disjoint", "dirichlet", "quantity")


@pytest.fixture(scope="module")
def flows():
    """The same synthetic flows in both packages' frame types."""
    return psynthetic.make_synthetic_flows(1200, seed=42), jsynthetic.make_synthetic_flows(1200, seed=42)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("seed", [0, 42, 7])
@pytest.mark.parametrize("num_clients,alpha", [(2, 0.5), (4, 0.1), (5, 2.0)])
def test_partition_indices_match_jax(scheme, seed, num_clients, alpha):
    labels = np.random.default_rng(seed + 1).integers(0, 2, 997).astype(np.int32)
    kw = dict(partition=scheme, seed_base=seed, dirichlet_alpha=alpha, data_fraction=0.15)
    got = ppartition.partition_indices(labels, num_clients, pcfg.DataConfig(**kw))
    want = jpartition.partition_indices(labels, num_clients, jcfg.DataConfig(**kw))
    assert len(got) == len(want) == num_clients
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if scheme != "dirichlet":  # disjoint and quantity never overlap
        flat = np.concatenate(got)
        assert len(np.unique(flat)) == len(flat)
    man = ppartition.partition_manifest([labels[i] for i in got], cfg=pcfg.DataConfig(**kw), total_rows=len(labels))
    assert man == jpartition.partition_manifest([labels[i] for i in want], cfg=jcfg.DataConfig(**kw), total_rows=len(labels))


@pytest.mark.parametrize("scheme", ["disjoint", "quantity"])
def test_infeasible_partitions_raise_as_in_jax(scheme):
    labels = np.zeros(10, np.int32)
    for mod, cfg in ((ppartition, pcfg), (jpartition, jcfg)):
        with pytest.raises(ValueError, match="infeasible"):
            mod.partition_indices(labels, 4, cfg.DataConfig(partition=scheme, data_fraction=0.5))


@pytest.mark.parametrize("scheme", ("sample", *SCHEMES))
def test_client_splits_and_manifest_match_jax(flows, scheme, tmp_path):
    frame, df = flows
    kw = dict(partition=scheme, dirichlet_alpha=0.3, data_fraction=0.2)
    paths = [str(tmp_path / "port.json"), str(tmp_path / "jax.json")]
    got = pcicids.make_all_client_splits(frame, 4, pcfg.DataConfig(**kw), manifest_path=paths[0])
    want = jcicids.make_all_client_splits(df, 4, jcfg.DataConfig(**kw), manifest_path=paths[1])
    for g, w in zip(got, want, strict=True):
        assert g.client_id == w.client_id
        for part in ("train", "val", "test"):
            assert getattr(g, part).texts == getattr(w, part).texts, (g.client_id, part)
            np.testing.assert_array_equal(getattr(g, part).labels, getattr(w, part).labels)
    with open(paths[0]) as f, open(paths[1]) as h:
        assert json.load(f) == json.load(h)
    # The single-client path takes the same rows.
    one = pcicids.make_client_splits(frame, 2, 4, pcfg.DataConfig(**kw))
    assert one.train.texts == got[2].train.texts


def _split(rng, n, L=12, vocab=50):
    ids = rng.integers(5, vocab, (n, L)).astype(np.int32)
    mask = (np.arange(L)[None, :] < rng.integers(3, L + 1, n)[:, None]).astype(np.int32)
    return ids * mask, mask, rng.integers(0, 2, n).astype(np.int32)


def _both(arrays):
    return ppipeline.TokenizedSplit(*arrays), jpipeline.TokenizedSplit(*arrays)


def _assert_split_equal(p, j):
    for field in ("input_ids", "attention_mask", "labels"):
        np.testing.assert_array_equal(getattr(p, field), getattr(j, field), err_msg=field)


@pytest.mark.parametrize("sizes", [(13, 6, 0), (16, 16, 16), (1, 40)])
def test_stacking_matches_jax(sizes):
    rng = np.random.default_rng(sum(sizes))
    pairs = [_both(_split(rng, n)) for n in sizes]
    ports, jaxs = [p for p, _ in pairs], [j for _, j in pairs]
    if min(sizes) > 0:
        _assert_split_equal(ppipeline.stack_clients(ports), jpipeline.stack_clients(jaxs))
    for target in (None, max(sizes) + 5):
        got = ppipeline.stack_clients_ragged(ports, pad_id=0, target_rows=target)
        want = jpipeline.stack_clients_ragged(jaxs, pad_id=0, target_rows=target)
        _assert_split_equal(got.split, want.split)
        np.testing.assert_array_equal(got.row_valid, want.row_valid)
        np.testing.assert_array_equal(got.n_rows, want.n_rows)
    with pytest.raises(ValueError, match="target_rows"):
        ppipeline.stack_clients_ragged(ports, target_rows=max(sizes) - 1)
    for bs, target in ((4, None), (8, 30)):
        gs, gv = pfedeval.stack_eval_splits(ports, bs, pad_id=0, target_rows=target)
        ws, wv = jfedeval.stack_eval_splits(jaxs, bs, pad_id=0, target_rows=target)
        _assert_split_equal(gs, ws)
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_batch_iterators_match_jax(seed):
    rng = np.random.default_rng(seed)
    pairs = [_both(_split(rng, n)) for n in (21, 9, 4)]
    ports, jaxs = [p for p, _ in pairs], [j for _, j in pairs]
    dense_p, dense_j = ppipeline.stack_clients(ports), jpipeline.stack_clients(jaxs)
    ragged_p = ppipeline.stack_clients_ragged(ports)
    ragged_j = jpipeline.stack_clients_ragged(jaxs)
    for epoch in (0, 2):
        for offset in (0, 5):
            kw = dict(seed=seed, epoch=epoch, client_offset=offset)
            got = list(pbatches.federated_batches(dense_p, 2, **kw))
            want = list(jbatches.federated_batches(dense_j, 2, **kw))
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            for n_batches in (None, 8):
                got = list(pbatches.federated_batches_ragged(ragged_p, 4, n_batches=n_batches, **kw))
                want = list(jbatches.federated_batches_ragged(ragged_j, 4, n_batches=n_batches, **kw))
                assert len(got) == len(want) == (n_batches or 6)
                for g, w in zip(got, want):
                    assert g.keys() == w.keys()
                    for k in g:
                        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            # Each client's rows are consumed once an epoch; pad rows are
            # index 0 with valid 0.
            got = list(pbatches.federated_batches_ragged(ragged_p, 4, **kw))
            valid = np.concatenate([b["valid"] for b in got], axis=1)
            np.testing.assert_array_equal(valid.sum(axis=1), [21, 9, 4])
    with pytest.raises(ValueError, match="lockstep span"):
        list(pbatches.federated_batches_ragged(ragged_p, 4, seed=0, epoch=0, n_batches=5))


FED_CASES = [
    {},
    dict(num_clients=5, participation=0.26, min_client_fraction=0.2),
    dict(num_clients=4, participation=0.5, participation_mode="poisson", min_client_fraction=0.5),
    dict(weighted=False, server_opt="yogi", server_lr=0.5, server_momentum=0.0),
    dict(weighted=True, prox_mu=0.1, reset_optimizer_each_round=False),
]


@pytest.mark.parametrize("kw", FED_CASES)
def test_fed_config_matches_jax(kw):
    got, want = pcfg.FedConfig(**kw), jcfg.FedConfig(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for method in (
        "server_opt_enabled", "resolve_weighted", "cohort_size",
        "effective_participation", "dp_enabled", "resolve_participation_mode",
    ):
        assert getattr(got, method)() == getattr(want, method)(), method


def test_fed_config_fields_and_validation_match_jax():
    assert {f.name for f in dataclasses.fields(pcfg.FedConfig)} == {f.name for f in dataclasses.fields(jcfg.FedConfig)}
    for bad in (
        dict(participation=0.0), dict(participation_mode="x"), dict(server_opt="sgd"),
        dict(server_lr=0.0), dict(server_momentum=1.0), dict(participation=0.5),
        dict(dp_noise_multiplier=1.0), dict(personalize_scope="x"), dict(wire_dtype="fp8"),
    ):
        for cls in (pcfg.FedConfig, jcfg.FedConfig):
            with pytest.raises(ValueError):
                cls(**bad)


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(dp_clip=1.0), "item 9"),
        (dict(dp_clip=1.0, dp_noise_multiplier=0.5), "item 9"),
        (dict(dp_seed=3), "item 9"),
        (dict(personalize_epochs=1), "item 16"),
        (dict(personalize_scope="head"), "item 16"),
        (dict(subtree_deadline_factor=0.25), "item 11"),
    ],
)
def test_unported_fed_options_raise(kw, item):
    jcfg.FedConfig(**kw)  # valid in the JAX package
    with pytest.raises(NotImplementedError, match=item):
        pcfg.FedConfig(**kw)


@pytest.mark.parametrize("wire_dtype", ["fp32", "bf16", "int8"])
def test_fed_config_wire_dtype_is_ported(wire_dtype):
    assert dataclasses.asdict(pcfg.FedConfig(wire_dtype=wire_dtype)) == dataclasses.asdict(
        jcfg.FedConfig(wire_dtype=wire_dtype)
    )


def test_from_dict_reads_a_config_the_jax_package_wrote():
    jax_cfg = jcfg.ExperimentConfig.for_clients(
        4,
        model=jcfg.ModelConfig.tiny(),
        data=jcfg.DataConfig(max_len=32, partition="dirichlet", dirichlet_alpha=0.2),
        fed=jcfg.FedConfig(num_clients=4, rounds=3, server_opt="adam", prox_mu=0.01),
        output_dir="runs/x",
    )
    d = json.loads(json.dumps(jax_cfg.to_dict()))
    got = pcfg.ExperimentConfig.from_dict(d)
    for section in ("model", "data", "train", "fed"):
        assert dataclasses.asdict(getattr(got, section)) == d[section], section
    assert got.output_dir == "runs/x"
    assert pcfg.ExperimentConfig.from_dict(got.to_dict()) == got
    with pytest.raises(ValueError, match="unknown config sections"):
        pcfg.ExperimentConfig.from_dict({**d, "bogus": {}})
    with pytest.raises(ValueError, match="unknown fed config keys"):
        pcfg.ExperimentConfig.from_dict({**d, "fed": {**d["fed"], "nope": 1}})


def test_manifest_is_written_for_non_iid_partitions_only(tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
        _load_clients,
        resolve_config,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
        default_tokenizer,
    )

    tok = default_tokenizer()
    for scheme, written in (("sample", False), ("quantity", True)):
        out = tmp_path / scheme
        args = build_parser().parse_args(
            ["federated", "--device", "cpu", "--synthetic", "300", "--partition", scheme,
             "--num-clients", "3", "--output-dir", str(out)]
        )
        cfg = resolve_config(args, vocab_size=len(tok.vocab))
        assert cfg.data.partition == scheme and cfg.fed.num_clients == 3
        clients = _load_clients(args, cfg, tok, 3)
        assert len(clients) == 3
        assert os.path.exists(out / "partition_manifest.json") is written
