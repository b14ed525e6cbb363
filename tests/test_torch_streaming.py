"""The port's two-pass streaming CSV reader (``data/streaming.py``, numpy
and the csv module, no pandas) held against the JAX package's (after
tests/test_streaming.py's six cases), on the CPU: the same CSV through
both streamed readers gives EQUAL splits and token arrays, and where the
JAX test holds the streamed arrays equal to the in-memory loader's, so
does this one (the port's own in-memory loader). ``--stream`` reaches the
verbs through ``_load_clients`` and, as in JAX, needs ``--csv``.
"""

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.config import (
    DataConfig as JaxDataConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    default_tokenizer as jax_default_tokenizer,
    make_synthetic_flows as jax_make_synthetic_flows,
    stream_client_tokens as jax_stream_client_tokens,
    stream_client_tokens_for as jax_stream_client_tokens_for,
    write_synthetic_csv,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    DataConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.cicids import (
    load_flow_csv,
    make_all_client_splits,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
    tokenize_client,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.streaming import (
    stream_client_tokens,
    stream_client_tokens_for,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.tokenizer import (
    default_tokenizer,
)

MAX_LEN = 48


@pytest.fixture(scope="module")
def toks():
    return default_tokenizer(), jax_default_tokenizer()


def _inmemory(path, cfg, num_clients, tok):
    splits = make_all_client_splits(load_flow_csv(path), num_clients, cfg)
    return [tokenize_client(s, tok, max_len=cfg.max_len) for s in splits]


def _both(path, num_clients, toks, chunk_rows, **data_kw):
    data_kw.setdefault("max_len", MAX_LEN)
    got = stream_client_tokens(path, DataConfig(**data_kw), num_clients, toks[0], chunk_rows=chunk_rows)
    want = jax_stream_client_tokens(path, JaxDataConfig(**data_kw), num_clients, toks[1], chunk_rows=chunk_rows)
    return got, want


def _assert_clients_equal(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert ca.client_id == cb.client_id
        for name in ("train", "val", "test"):
            sa, sb = getattr(ca, name), getattr(cb, name)
            np.testing.assert_array_equal(sa.labels, sb.labels, err_msg=name)
            np.testing.assert_array_equal(sa.input_ids, sb.input_ids, err_msg=name)
            np.testing.assert_array_equal(sa.attention_mask, sb.attention_mask, err_msg=name)


@pytest.mark.parametrize("partition", ["disjoint", "dirichlet", "quantity"])
def test_streaming_matches_jax_and_inmemory(tmp_path, toks, partition):
    path = str(tmp_path / f"{partition}.csv")
    write_synthetic_csv(path, n_rows=600, seed=5, inf_fraction=0.0, nan_fraction=0.0)
    got, want = _both(path, 2, toks, 97, partition=partition, data_fraction=0.3)
    _assert_clients_equal(got, want)
    cfg = DataConfig(partition=partition, data_fraction=0.3, max_len=MAX_LEN)
    _assert_clients_equal(got, _inmemory(path, cfg, 2, toks[0]))


def test_streaming_sample_partition_matches_jax(tmp_path, toks):
    path = str(tmp_path / "s.csv")
    write_synthetic_csv(path, n_rows=400, seed=6)
    got, want = _both(path, 3, toks, 111, partition="sample", data_fraction=0.25)
    _assert_clients_equal(got, want)
    for c in got:
        assert len(c.train) + len(c.val) + len(c.test) == 100


def test_streaming_imputes_with_global_means_as_jax(tmp_path, toks):
    """±inf/NaN rows: the means are sums of per-chunk sums, the JAX
    reader's, so the imputed texts and their tokens are equal."""
    path = str(tmp_path / "noisy.csv")
    write_synthetic_csv(path, n_rows=300, seed=7, inf_fraction=0.05, nan_fraction=0.05)
    got, want = _both(path, 2, toks, 64, partition="disjoint", data_fraction=0.5)
    _assert_clients_equal(got, want)
    for c in got:
        assert (c.train.input_ids[:, 0] == toks[0].cls_id).all()


def test_streaming_pins_whole_file_dtypes(tmp_path, toks):
    """One NaN in the last chunk floats the column whole-file ('443' is
    '443.0' everywhere); earlier NaN-free chunks render as the in-memory
    loader does."""
    df = jax_make_synthetic_flows(200, seed=9, inf_fraction=0.0, nan_fraction=0.0)
    df.loc[df.index[-1], "Destination Port"] = np.nan
    path = str(tmp_path / "late_nan.csv")
    df.to_csv(path, index=False)
    got, want = _both(path, 2, toks, 50, partition="disjoint", data_fraction=0.5)
    _assert_clients_equal(got, want)
    cfg = DataConfig(partition="disjoint", data_fraction=0.5, max_len=MAX_LEN)
    _assert_clients_equal(got, _inmemory(path, cfg, 2, toks[0]))


def test_streaming_unsw_schema(tmp_path, toks):
    path = str(tmp_path / "unsw.csv")
    write_synthetic_csv(path, dataset="unswnb15", n_rows=300, seed=8)
    got, want = _both(path, 2, toks, 50, dataset="unswnb15", partition="disjoint", data_fraction=0.5)
    _assert_clients_equal(got, want)
    cfg = DataConfig(dataset="unswnb15", partition="disjoint", data_fraction=0.5, max_len=MAX_LEN)
    _assert_clients_equal(got, _inmemory(path, cfg, 2, toks[0]))


def test_stream_subset_matches_full_run_and_jax(tmp_path, toks):
    path = str(tmp_path / "flows.csv")
    write_synthetic_csv(path, n_rows=400, seed=9)
    cfg = DataConfig(data_fraction=0.25, max_len=MAX_LEN, partition="disjoint")
    full = stream_client_tokens(path, cfg, 4, toks[0], chunk_rows=97)
    subset, sizes = stream_client_tokens_for(path, cfg, 4, toks[0], [1, 3], chunk_rows=97)
    jsubset, jsizes = jax_stream_client_tokens_for(
        path, JaxDataConfig(data_fraction=0.25, max_len=MAX_LEN, partition="disjoint"), 4, toks[1], [1, 3],
        chunk_rows=97,
    )
    assert sizes == jsizes and len(sizes) == 4
    _assert_clients_equal(subset, jsubset)
    _assert_clients_equal(subset, [full[1], full[3]])
    with pytest.raises(ValueError, match="client_ids"):
        stream_client_tokens_for(path, cfg, 4, toks[0], [4])


def test_stream_flag_reaches_the_loader_and_needs_csv(tmp_path, toks):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        build_parser as jax_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli.common import (
        _load_clients as jax_load_clients,
        resolve_config as jax_resolve_config,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
        _load_clients,
        resolve_config,
    )

    path = str(tmp_path / "flows.csv")
    write_synthetic_csv(path, n_rows=300, seed=4)
    for verb in ("local", "client", "federated", "distill"):
        argv = [verb, "--stream", "--csv", path, "--max-len", "32", "--partition", "disjoint"]
        if verb == "client":
            argv += ["--client-id", "1"]
        if verb in ("local", "distill"):
            argv.remove("--partition"), argv.remove("disjoint")
        args, jargs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
        cfg = resolve_config(args, vocab_size=len(toks[0].vocab))
        jcfg = jax_resolve_config(jargs, vocab_size=len(toks[1].vocab))
        _assert_clients_equal(_load_clients(args, cfg, toks[0], 2), jax_load_clients(jargs, jcfg, toks[1], 2))
        args.csv = None
        with pytest.raises(SystemExit, match="--stream needs --csv"):
            _load_clients(args, cfg, toks[0], 2)
