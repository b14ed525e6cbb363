"""The port's scoring service held against the JAX package's on the CPU.

Engine: same weights and rows through both ``ScoreEngine``s; buckets and
rounds equal, probabilities within the model-parity bound (atol 2e-5).
Wire: the codecs produce equal bytes, so the two packages' clients and
servers interoperate. Host path: template text and WordPiece ids equal.
End to end: a JAX registry promotes a tiny artifact, the port's
``infer-serve`` serves it, and both packages' clients are answered.
"""

import threading

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    default_tokenizer as jax_default_tokenizer,
    texts_from_dataframe,
    write_synthetic_csv,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.registry import (
    ModelRegistry as JaxRegistry,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.serving import (
    ScoreEngine as JaxEngine,
    ScoringClient as JaxClient,
    protocol as jax_protocol,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
    build_server,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    FLOW_TEXT_COLUMNS,
    default_tokenizer,
    flow_to_text,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    params_from_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
    ScoreEngine,
    ScoringClient,
    protocol,
)

torch.set_num_threads(1)

ATOL = 2e-5
VOCAB = len(default_tokenizer().vocab)


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """Synthetic CICIDS2017 rows: (frame, template texts, ids, mask)."""
    path = tmp_path_factory.mktemp("flows") / "flows.csv"
    write_synthetic_csv(str(path), n_rows=24, seed=3)
    df = pd.read_csv(path)
    texts = texts_from_dataframe(df)
    enc = jax_default_tokenizer().batch_encode(texts, max_len=32)
    return df, texts, enc["input_ids"], enc["attention_mask"]


@pytest.fixture(scope="module")
def tiny():
    """A tiny flash-attention classifier's JAX config and params."""
    kw = dict(vocab_size=VOCAB, attention_impl="flash")
    jcfg = JaxModelConfig.tiny(**kw)
    params = jax_init_params(JaxClassifier(jcfg), jcfg, jax.random.key(5))
    return jcfg, ModelConfig.tiny(**kw), params


def test_template_and_tokenizer_match_jax(flows):
    df, texts, ids, mask = flows
    tok = default_tokenizer()
    assert tok.vocab == jax_default_tokenizer().vocab
    for i, row in enumerate(df[list(FLOW_TEXT_COLUMNS)].to_dict("records")):
        assert flow_to_text(row) == texts[i]
    enc = tok.batch_encode(texts, max_len=32)
    assert np.array_equal(enc["input_ids"], ids)
    assert np.array_equal(enc["attention_mask"], mask)


def test_codecs_are_byte_equal_to_jax():
    for kw in (
        dict(text="Destination port is 80."),
        dict(features={"Destination Port": 443, "Flow Duration": 1.5}),
        dict(text="x", deadline_ms=12.5, trace="t-1"),
    ):
        assert protocol.build_request(7, **kw) == jax_protocol.build_request(7, **kw)
        frame = jax_protocol.build_request(7, **kw)
        assert protocol.parse_request(frame) == jax_protocol.parse_request(frame)
    for kw in (
        dict(prob=float(np.float32(0.73125)), threshold=0.5, round_id=3,
             batch_size=9, bucket=32, queue_ms=1.23456),
        dict(prob=0.1, threshold=0.5, round_id=0, batch_size=1, bucket=1,
             queue_ms=0.0, trace="abc", class_probs=[0.9, 0.05, 0.05]),
    ):
        assert protocol.build_reply(5, **kw) == jax_protocol.build_reply(5, **kw)
    assert protocol.build_reject(5, code=503, reason="full") == (
        jax_protocol.build_reject(5, code=503, reason="full")
    )


@pytest.mark.parametrize("n", [1, 3, 8, 9])
def test_engine_matches_jax(tiny, flows, n):
    jcfg, cfg, params = tiny
    _, _, ids, mask = flows
    ids, mask = ids[:n], mask[:n]
    want = JaxEngine(jcfg, params, pad_id=0, round_id=4).score(ids, mask)
    got = ScoreEngine(
        cfg, params_from_jax(params), pad_id=0, round_id=4, device="cpu"
    ).score(ids, mask)
    assert got[2:] == want[2:]  # bucket, round
    assert got[0].dtype == np.float32 and got[0].shape == (n,)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL)


def test_row_prob_is_bitwise_equal_in_every_bucket(tiny, flows):
    _, cfg, params = tiny
    _, _, ids, mask = flows
    engine = ScoreEngine(cfg, params_from_jax(params), device="cpu")
    seen = {}
    for n in (1, 3, 9, 24):  # buckets 1, 8, 32, 32
        probs, _, bucket, _ = engine.score(ids[:n], mask[:n])
        seen[(n, bucket)] = probs[0]
    first = next(iter(seen.values()))
    assert all(p.tobytes() == first.tobytes() for p in seen.values()), seen


def test_engine_swap_and_bucket_overflow(tiny, flows):
    _, cfg, params = tiny
    _, _, ids, mask = flows
    sd = params_from_jax(params)
    engine = ScoreEngine(cfg, sd, buckets=(1, 8), device="cpu")
    before = engine.score(ids[:2], mask[:2])[0]
    engine.swap({k: v * 0.5 for k, v in sd.items()}, round_id=9)
    probs, _, bucket, round_id = engine.score(ids[:2], mask[:2])
    assert (bucket, round_id) == (8, 9) and not np.array_equal(probs, before)
    with pytest.raises(ValueError, match="largest bucket"):
        engine.score(ids[:9], mask[:9])


def test_infer_serve_answers_jax_and_port_clients(tiny, flows, tmp_path):
    jcfg, _, params = tiny
    df, texts, ids, mask = flows
    registry = JaxRegistry(str(tmp_path / "registry"))
    aid = registry.add(params, round_index=6, model_config=jcfg)
    registry.promote(aid, to="serving")

    args = build_parser().parse_args(
        ["infer-serve", "--registry-dir", str(tmp_path / "registry"),
         "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--max-wait-ms", "20"]
    )
    want = JaxEngine(jcfg, params, pad_id=0).score(ids, mask)[0]
    records = df[list(FLOW_TEXT_COLUMNS)].to_dict("records")
    replies: dict[int, dict] = {}
    errors = []

    def drive(client_cls, rows, use_features):
        try:
            with client_cls("127.0.0.1", server.port) as c:
                for i in rows:
                    if use_features:
                        replies[i] = c.score(features=records[i])
                    else:
                        replies[i] = c.score(text=texts[i])
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    with build_server(args) as server:
        workers = [
            threading.Thread(target=drive, args=(JaxClient, range(0, 8), False)),
            threading.Thread(target=drive, args=(ScoringClient, range(8, 16), True)),
            threading.Thread(target=drive, args=(JaxClient, range(16, 24), True)),
        ]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        stats = server.stats()
    assert not errors, errors
    assert sorted(replies) == list(range(24))
    assert stats["scored"] == 24
    for i, r in replies.items():
        assert r["round"] == 6 and r["bucket"] in (1, 8, 32)
        assert r["prediction"] == int(r["prob"] >= 0.5)
        np.testing.assert_allclose(r["prob"], want[i], atol=ATOL)


def _registry(tmp_path, params, model_config, round_index=2):
    registry = JaxRegistry(str(tmp_path / "registry"))
    aid = registry.add(params, round_index=round_index, model_config=model_config)
    registry.promote(aid, to="serving")
    return str(tmp_path / "registry")


def _args(*extra):
    return build_parser().parse_args(
        ["infer-serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0", *extra]
    )


def test_infer_serve_refuses_bad_setups(tiny, tmp_path):
    jcfg, _, params = tiny
    with pytest.raises(SystemExit, match="no serving artifact"):
        build_server(_args("--registry-dir", str(tmp_path / "empty")))
    reg = _registry(tmp_path, params, jcfg)
    with pytest.raises(SystemExit, match="max-queue"):
        build_server(_args("--registry-dir", reg, "--max-queue", "4"))
    with pytest.raises(SystemExit, match="--buckets"):
        build_server(_args("--registry-dir", reg, "--buckets", "0,8"))
    other = JaxModelConfig.tiny(vocab_size=VOCAB + 1)
    params_other = jax_init_params(JaxClassifier(other), other, jax.random.key(1))
    reg2 = _registry(tmp_path / "b", params_other, other)
    with pytest.raises(SystemExit, match="vocab"):
        build_server(_args("--registry-dir", reg2))


def test_preset_and_flags_apply_without_a_manifest_config(tiny, tmp_path):
    """An artifact with no model_config takes --preset and --attention-impl."""
    _, _, params = tiny
    reg = _registry(tmp_path, params, None)
    server = build_server(
        _args("--registry-dir", reg, "--attention-impl", "flash", "--buckets", "1,8")
    )
    try:
        cfg = server.engine.model_cfg
        assert (cfg.dim, cfg.n_layers, cfg.attention_impl) == (32, 2, "flash")
        assert server.engine.buckets == (1, 8) and server.engine.round_id == 2
    finally:
        server.close()


def test_server_rejects_explicitly(tiny, tmp_path):
    """Bad features get a 400, an expired deadline a 504: never a hang."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
        ScoreRejected,
    )

    jcfg, _, params = tiny
    with build_server(_args("--registry-dir", _registry(tmp_path, params, jcfg))) as server:
        with ScoringClient("127.0.0.1", server.port) as c:
            with pytest.raises(ScoreRejected) as e:
                c.score(features={"Destination Port": 80})
            assert e.value.code == 400 and "template column" in e.value.reason
            with pytest.raises(ScoreRejected) as e:
                c.score(text="Destination port is 80.", deadline_ms=0.0)
            assert e.value.code == 504
            assert 0.0 <= c.score(text="Destination port is 80.")["prob"] <= 1.0
        stats = server.stats()
    assert stats["rejects"]["bad_request"] == 1 and stats["rejects"]["deadline"] == 1
    assert stats["scored"] == 1
