"""The frozen traffic generator against the port's data path."""

from __future__ import annotations

from importlib import import_module

import numpy as np
import pytest

from conftest import PORT
from pbcore import flows

synthetic = import_module(PORT + ".data.synthetic")
textualize = import_module(PORT + ".data.textualize")
tokenizer = import_module(PORT + ".data.tokenizer")


def test_rows_match_the_port_s_generator():
    ours = flows.make_synthetic_flows(500, seed=2**31 + 5)
    port = synthetic.make_synthetic_flows(500, seed=2**31 + 5)
    assert list(ours) == list(port)
    for k in port:
        if port[k].dtype.kind == "f":
            assert np.array_equal(ours[k], port[k], equal_nan=True), k
        else:
            assert np.array_equal(ours[k], port[k]), k


def test_sentences_and_vocab_match_the_port():
    frame = flows.make_synthetic_flows(64, seed=9)
    assert flows.render(frame) == textualize.render_template(frame, textualize.CICIDS_TEMPLATE)
    assert flows.reference_scale_vocab(30522) == tokenizer.build_reference_scale_vocab(30522)
    assert flows.domain_vocab() == tokenizer.build_domain_vocab()


@pytest.mark.parametrize("impute", [True, False])
def test_ids_match_the_port_s_tokenizer(impute):
    frame = flows.make_synthetic_flows(300, seed=17)
    if impute:
        frame = flows.impute(frame)
    texts = flows.render(frame)
    texts += ["Ünïcode  flow\twith odd spaces, (and) punct!", "x" * 150, ""]
    ids, mask = flows.WordPiece(flows.reference_scale_vocab(30522)).encode_batch(texts, 128)
    tok = tokenizer.WordPieceTokenizer(tokenizer.build_reference_scale_vocab(30522))
    want = tok.batch_encode_python(texts, 128)
    assert np.array_equal(ids, want["input_ids"]) and np.array_equal(mask, want["attention_mask"])


def test_fast_path_matches_the_character_path():
    wp = flows.WordPiece(flows.reference_scale_vocab(30522))
    for text in flows.render(flows.make_synthetic_flows(200, seed=4)) + ["A.b,c;D  e~f{g}|h\\i'j\"k", "inf nan"]:
        assert wp.words(text) == flows.basic_tokenize(text)


def test_impute_replaces_non_finite_values_by_the_column_mean():
    frame = {"x": np.array([1.0, np.inf, 3.0, np.nan]), "n": np.array([1, 2, 3, 4])}
    out = flows.impute(frame)
    assert np.array_equal(out["x"], [1.0, 2.0, 3.0, 2.0]) and out["n"] is frame["n"]
    assert np.isinf(frame["x"][1])  # the input is left as it was


def test_pool_is_seeded():
    t = {"rows": 50, "ddos_fraction": 0.5, "inf_fraction": 0.01, "nan_fraction": 0.01}
    cfg = {"vocab_size": 30522, "max_len": 128}
    a, b, c = flows.flow_pool(t, cfg, 7), flows.flow_pool(t, cfg, 7), flows.flow_pool(t, cfg, 8)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[2].sum() == 25 and (a[1].sum(1) > 60).all()  # real sentences, ragged under the mask
