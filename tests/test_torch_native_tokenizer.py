"""The port's native WordPiece encoder held against its Python path and
against the JAX package's tokenizer, on the CPU.

The native library is built by the port's own loader from
``native/wordpiece.cpp`` into ``build/torch_native/``; the ids of every
template's texts, at ``max_len`` 16 (truncating) and 128, are
array-equal three ways: native, the port's Python path, and the JAX
package's ``batch_encode``. A non-ASCII batch, a vocab the encoder cannot
hold and a missing compiler each leave the Python path in charge.
"""

import logging
import os

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    default_tokenizer as jax_default_tokenizer,
    synthetic as jsynthetic,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data.datasets import (
    get_dataset as jax_get_dataset,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    native_tokenizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.tokenizer import (
    WordPieceTokenizer,
    build_domain_vocab,
    default_tokenizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.utils import (
    native,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _texts(dataset):
    df = jsynthetic.make_synthetic(dataset, 64, seed=9)
    texts = jax_get_dataset(dataset).render_texts(df)
    # Edge cases: empty text, a long digit run (WordPiece continuations),
    # punctuation runs, an over-long word, an unknown word.
    return texts + ["", "9" * 40, "Port is 80!!! (x)", "a" * 101, "zzqx protocol"]


@pytest.mark.parametrize("max_len", [16, 128])
@pytest.mark.parametrize("dataset", ["cicids2017", "cicddos2019", "unswnb15"])
def test_native_ids_equal_python_and_jax(dataset, max_len):
    tok = default_tokenizer()
    texts = _texts(dataset)
    got = tok.batch_encode(texts, max_len=max_len)
    assert tok.native_active, native.build_error(native_tokenizer.SOURCE)
    py = tok.batch_encode_python(texts, max_len=max_len)
    jx = jax_default_tokenizer().batch_encode(texts, max_len=max_len)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == np.int32 and got[key].shape == (len(texts), max_len)
        np.testing.assert_array_equal(got[key], py[key], err_msg=key)
        np.testing.assert_array_equal(got[key], jx[key], err_msg=key)
    if max_len == 16:  # truncated: [CLS] + 14 pieces + [SEP] on a full row
        assert (got["attention_mask"].sum(1) == 16).any()
        assert (got["input_ids"][got["attention_mask"].sum(1) == 16, 15] == tok.sep_id).all()


def test_non_ascii_batches_take_the_python_path():
    tok = default_tokenizer()
    texts = ["Destination port is 80.", "Protocol is tcp. Service is café."]
    got = tok.batch_encode(texts, max_len=32)
    assert not tok.native_active
    want = jax_default_tokenizer().batch_encode(texts, max_len=32)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    tok.batch_encode(texts[:1], max_len=32)
    assert tok.native_active  # the next ASCII batch is native again


def test_vocabs_the_encoder_cannot_hold_stay_on_python():
    vocab = build_domain_vocab()
    for tok in (
        WordPieceTokenizer(vocab, max_input_chars_per_word=50),  # not the native cap
        WordPieceTokenizer({t: 2 * i for i, t in enumerate(vocab)}),  # ids not dense
    ):
        got = tok.batch_encode(["Destination port is 443."], max_len=16)
        assert not tok.native_active and tok._native is None
        np.testing.assert_array_equal(got["input_ids"], tok.batch_encode_python(["Destination port is 443."], 16)["input_ids"])


def test_library_builds_under_build_torch_native(monkeypatch):
    path = native.library_path(native_tokenizer.SOURCE)
    assert os.path.dirname(path) == os.path.join(REPO_ROOT, "build", "torch_native")
    assert os.path.basename(path).startswith("libwordpiece-") and path.endswith(".so")
    assert native.build_native(native_tokenizer.SOURCE) == path and os.path.isfile(path)
    assert native_tokenizer.lib() is not None and native.build_error(native_tokenizer.SOURCE) is None
    # The name hashes the flags too: other flags name another library.
    monkeypatch.setattr(native, "GXX_FLAGS", (*native.GXX_FLAGS, "-g"))
    assert native.library_path(native_tokenizer.SOURCE) != path


def test_a_failed_build_is_logged_and_the_python_path_serves(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(native, "_cache", {})
    monkeypatch.setattr(native, "_errors", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeBuildError, match="no C\\+\\+ compiler"):
        native.build_native(native_tokenizer.SOURCE)
    with caplog.at_level(logging.ERROR):
        tok = default_tokenizer()
        got = tok.batch_encode(["Destination port is 443."], max_len=16)
    assert not tok.native_active
    assert "no C++ compiler" in native.build_error(native_tokenizer.SOURCE)
    assert "no C++ compiler" in caplog.text
    want = jax_default_tokenizer().batch_encode(["Destination port is 443."], max_len=16)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    assert not os.path.exists(tmp_path / "empty")
