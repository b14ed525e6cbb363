"""The port's scoring control plane held against the JAX package's, on the CPU.

Codecs: the stats, reload and auth frames, ``frame_id`` and
``rewrite_id`` give the JAX package's bytes. Auth: a JAX client scores
against the port's ``infer-serve --auth`` and the port's clients against
a keyed JAX ``ScoringServer``; a missing or wrong key is dropped and
counted. Control: ``stats()`` has the JAX key set, and a reload frame
forces a registry poll long before ``--reload-poll``. Load: the port's
``run_load`` drives the port's and a JAX server in its four modes with
the JAX result keys, and the JAX ``run_load`` drives the port's server.
Schemas: a K=7 artifact's ``class_probs`` and UNSW-NB15 ``features``
replies match the JAX package's within the serving tests' atol 2e-5.
"""

import asyncio
import os
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    wire as jax_wire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    default_tokenizer as jax_default_tokenizer,
    synthetic as jsynthetic,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data.datasets import (
    get_dataset as jax_get_dataset,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.registry import (
    ModelRegistry as JaxRegistry,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.serving import (
    MicroBatcher as JaxBatcher,
    ScoreEngine as JaxEngine,
    ScoringClient as JaxClient,
    ScoringServer as JaxServer,
    fetch_stats as jax_fetch_stats,
    load_arrival_trace as jax_load_arrival_trace,
    protocol as jax_protocol,
    run_load as jax_run_load,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.serving.client import (
    probe_scores as jax_probe_scores,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
    build_server,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    framing,
    wire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.wire import (
    NONCE_LEN,
    NONCE_MAGIC,
    WireError,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    default_tokenizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.datasets import (
    get_dataset,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    params_from_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
    AsyncScoringClient,
    PipelinedScoringClient,
    ScoreEngine,
    ScoreRejected,
    ScoringClient,
    ScoringServer,
    fetch_stats,
    load_arrival_trace,
    protocol,
    run_load,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving.client import (
    answer_auth_challenge,
    probe_scores,
)

torch.set_num_threads(1)

ATOL = 2e-5
VOCAB = len(default_tokenizer().vocab)
KEY = b"scoring-secret"
TRACE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "arrival_bursty.trace")


def _jax_tiny(seed, **kw):
    cfg = JaxModelConfig.tiny(vocab_size=VOCAB, **kw)
    return cfg, jax_init_params(JaxClassifier(cfg), cfg, jax.random.key(seed))


@pytest.fixture(scope="module")
def tiny():
    return _jax_tiny(5)


@pytest.fixture(scope="module")
def flows():
    """CICIDS2017 texts and their raw feature records (JAX generator)."""
    df = jsynthetic.make_synthetic("cicids2017", 32, seed=3)
    texts = jax_get_dataset("cicids2017").render_texts(df)
    cols = list(jax_get_dataset("cicids2017").feature_columns)
    return texts, df[cols].to_dict("records")


def _registry(root, cfg, params, round_index=1):
    registry = JaxRegistry(str(root))
    registry.promote(registry.add(params, round_index=round_index, model_config=cfg), to="serving")
    return registry


def _serve(root, *extra):
    return build_server(build_parser().parse_args(
        ["infer-serve", "--registry-dir", str(root), "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--max-wait-ms", "5", *extra]
    ))


@pytest.fixture(scope="module")
def port_server(tiny, tmp_path_factory):
    cfg, params = tiny
    root = tmp_path_factory.mktemp("registry")
    _registry(root, cfg, params)
    with _serve(root) as server:
        yield server


@pytest.fixture(scope="module")
def jax_server(tiny):
    cfg, params = tiny
    engine = JaxEngine(cfg, params, pad_id=0, buckets=(1, 8, 32))
    batcher = JaxBatcher(max_batch=32, max_queue=256, gather_window_s=0.005)
    with JaxServer(engine, jax_default_tokenizer(), spec=jax_get_dataset("cicids2017"),
                   batcher=batcher, idle_tick_s=0.01) as server:
        yield server


# ------------------------------------------------------------------ codecs
def test_magics_and_domain_are_the_jax_packages():
    for name in ("SCORE_AUTH_MAGIC", "SCORE_AUTH_DOMAIN", "SCORE_STAT_MAGIC", "SCORE_STATR_MAGIC",
                 "SCORE_RELOAD_MAGIC", "SCORE_RELOADR_MAGIC"):
        assert getattr(wire, name) == getattr(jax_wire, name), name


def test_control_codecs_are_byte_equal_to_jax():
    stats = {"scored": 3, "rejects": {"auth": 1}, "p50_ms": 1.25, "replica": None, "batch_size_hist": {"1": 3}}
    pairs = [
        (protocol.build_stats_request(4), jax_protocol.build_stats_request(4)),
        (protocol.build_stats_reply(4, stats), jax_protocol.build_stats_reply(4, stats)),
        (protocol.build_reload_request(9), jax_protocol.build_reload_request(9)),
        (protocol.build_reload_reply(9, reloaded=True, round_id=3),
         jax_protocol.build_reload_reply(9, reloaded=True, round_id=3)),
        (protocol.build_auth_response(KEY, b"\x01" * 16), jax_protocol.build_auth_response(KEY, b"\x01" * 16)),
    ]
    for got, want in pairs:
        assert got == want
    frame = pairs[1][1]
    assert protocol.parse_stats_reply(frame) == jax_protocol.parse_stats_reply(frame)
    assert protocol.parse_stats_request(pairs[0][1]) == jax_protocol.parse_stats_request(pairs[0][1])
    assert protocol.parse_reload_request(pairs[2][1]) == jax_protocol.parse_reload_request(pairs[2][1])
    assert protocol.parse_reload_reply(pairs[3][1]) == jax_protocol.parse_reload_reply(pairs[3][1])
    for fn in ("is_stats_request", "is_stats_reply", "is_reload_request", "is_reload_reply", "is_request", "is_reject"):
        for frame, _ in pairs:
            assert getattr(protocol, fn)(frame) == getattr(jax_protocol, fn)(frame), fn
    assert protocol.check_auth_response(pairs[4][0], KEY, b"\x01" * 16)
    assert not protocol.check_auth_response(pairs[4][0], b"other", b"\x01" * 16)
    assert not protocol.check_auth_response(pairs[4][0], KEY, b"\x02" * 16)
    for bad in (b"SCST{\"id\":true}", b"SCST[1]", b"SCRD{\"id\":1}", b"SCSR{\"id\":1,\"stats\":3}"):
        for parse in (protocol.parse_stats_request, protocol.parse_reload_reply, protocol.parse_stats_reply):
            with pytest.raises(WireError):
                parse(bad)


ID_FRAMES = {
    "request": protocol.build_request(17, text="Destination port is 80."),
    "reply": protocol.build_reply(17, prob=0.25, threshold=0.5, round_id=2, batch_size=3, bucket=8, queue_ms=1.5),
    "reject": protocol.build_reject(17, code=503, reason="full"),
    "stats": protocol.build_stats_request(17),
    "stats-reply": protocol.build_stats_reply(17, {"scored": 1}),
    "reload": protocol.build_reload_request(17),
    "reload-reply": protocol.build_reload_reply(17, reloaded=False, round_id=1),
    "negative": protocol.build_reject(-4, code=400, reason="x"),
    "id-not-first": b'SCRP{"prob":0.5,"id":17,"prediction":1,"round":1,"batch_size":1}',
    "long-id": protocol.build_request(10**40, text="x"),
}


@pytest.mark.parametrize("name", sorted(ID_FRAMES))
def test_frame_id_and_rewrite_id_match_jax(name):
    frame = ID_FRAMES[name]
    assert protocol.frame_id(frame) == jax_protocol.frame_id(frame)
    for new_id in (0, 123456, -1):
        got = protocol.rewrite_id(frame, new_id)
        assert got == jax_protocol.rewrite_id(frame, new_id)
        assert protocol.frame_id(got) == new_id


def test_frame_id_refusals_match_jax():
    for bad in (b"NONC" + b"\0" * 16, b'SCRQ{"id":"7"}', b"SCRQ not json"):
        with pytest.raises(WireError):
            protocol.frame_id(bad)
        with pytest.raises(jax_wire.WireError):
            jax_protocol.frame_id(bad)


# -------------------------------------------------------------------- auth
def test_jax_client_against_port_infer_serve_auth(tiny, flows, tmp_path, monkeypatch):
    cfg, params = tiny
    texts, _ = flows
    _registry(tmp_path, cfg, params)
    monkeypatch.setenv("FEDTPU_SECRET", KEY.decode())
    want = JaxEngine(cfg, params, pad_id=0).score(
        *(jax_default_tokenizer().batch_encode(texts[:4], max_len=cfg.max_len)[k] for k in ("input_ids", "attention_mask"))
    )[0]
    with _serve(tmp_path, "--auth") as server:
        assert server.auth_key == KEY
        with JaxClient("127.0.0.1", server.port, auth_key=KEY) as c:
            got = [c.score(text=t)["prob"] for t in texts[:4]]
            assert c.stats()["scored"] == 4
        np.testing.assert_allclose(got, want, atol=ATOL)
        with JaxClient("127.0.0.1", server.port) as bare:
            with pytest.raises(jax_wire.WireError, match="auth"):
                bare.score(text=texts[0])
        with pytest.raises((ConnectionError, OSError, WireError)):
            with ScoringClient("127.0.0.1", server.port, auth_key=b"wrong", timeout=5) as thief:
                thief.score(text=texts[0])
        with ScoringClient("127.0.0.1", server.port, auth_key=KEY) as c:
            assert c.score(text=texts[0])["round"] == 1
            stats = c.stats()
    assert stats["rejects"]["auth"] == 2 and stats["rejects_total"] == 2
    assert stats["scored"] == 5


def test_port_clients_against_a_keyed_jax_server(tiny, flows):
    cfg, params = tiny
    texts, records = flows
    engine = JaxEngine(cfg, params, pad_id=0, buckets=(1, 8))
    with JaxServer(engine, jax_default_tokenizer(), spec=jax_get_dataset("cicids2017"),
                   batcher=JaxBatcher(max_batch=8, max_queue=64, gather_window_s=0.005),
                   idle_tick_s=0.01, auth_key=KEY) as server:
        with ScoringClient("127.0.0.1", server.port, auth_key=KEY) as c:
            sync = [c.score(text=t)["prob"] for t in texts[:4]]
            assert c.score(features=records[0])["prob"] == sync[0]
        with PipelinedScoringClient("127.0.0.1", server.port, auth_key=KEY) as c:
            futs = [c.submit(text=t) for t in texts[:4]]
            assert [f.result(timeout=30)["prob"] for f in futs] == sync
            assert c.stats(timeout=30)["scored"] == 9

        async def go():
            async with await AsyncScoringClient.connect("127.0.0.1", server.port, auth_key=KEY) as c:
                return await asyncio.gather(*(c.score(text=t) for t in texts[:4]))

        assert [r["prob"] for r in asyncio.run(go())] == sync
        with ScoringClient("127.0.0.1", server.port) as bare:
            with pytest.raises(WireError, match="requires authentication"):
                bare.score(text=texts[0])
        assert fetch_stats("127.0.0.1", server.port, auth_key=KEY)["rejects"]["auth"] == 1


# ----------------------------------------------------------------- control
def test_stats_have_the_jax_key_set(port_server, jax_server, flows):
    texts, _ = flows
    for server in (port_server, jax_server):
        run_load("127.0.0.1", server.port, texts, concurrency=4)
    got = fetch_stats("127.0.0.1", port_server.port)
    want = jax_fetch_stats("127.0.0.1", jax_server.port)
    assert list(got) == list(want)
    assert list(got) == list(port_server.stats())
    assert set(got["rejects"]) == set(want["rejects"])
    assert got["replica"] is None and len(got["score_hist"]) == 10
    assert sum(got["score_hist"]) == got["scored"] >= len(texts)
    assert sum(int(n) * c for n, c in got["batch_size_hist"].items()) == got["scored"]
    assert sum(got["batch_size_hist"].values()) == got["batches"]
    assert got["mean_batch"] == got["scored"] / got["batches"]


def test_reload_frame_forces_a_registry_poll(tiny, flows, tmp_path):
    cfg, params = tiny
    texts, _ = flows
    registry = _registry(tmp_path, cfg, params)
    _, new_params = _jax_tiny(6)
    with _serve(tmp_path, "--reload-poll", "3600") as server:
        with ScoringClient("127.0.0.1", server.port) as c:
            assert c.score(text=texts[0])["round"] == 1
            assert c.reload() == {"id": 2, "reloaded": False, "round": 1}
            registry.promote(registry.add(new_params, round_index=3, model_config=cfg), to="serving")
            reply = c.reload()
            assert reply["reloaded"] is True and reply["round"] == 3
            got = c.score(text=texts[0])
        with ScoringClient("127.0.0.1", server.port) as c:
            assert c.reload() == {"id": 1, "reloaded": False, "round": 3}
        stats = server.stats()
    assert got["round"] == 3
    enc = jax_default_tokenizer().batch_encode(texts[:1], max_len=cfg.max_len)
    want = JaxEngine(cfg, new_params, pad_id=0).score(enc["input_ids"], enc["attention_mask"])[0]
    np.testing.assert_allclose(got["prob"], want[0], atol=ATOL)
    assert stats["reloads"] == 1 and stats["reload_frames"] == 3 and stats["round"] == 3


def test_malformed_frames_get_a_400_or_a_drop(port_server):
    with socket.create_connection(("127.0.0.1", port_server.port), timeout=10) as s:
        framing.send_frame(s, b'SCRQ{"id":5,"text":3}', await_ack=False)
        body = protocol.parse_reject(bytes(framing.recv_frame(s, send_ack=False)))
        assert body["id"] == 5 and body["code"] == 400
        framing.send_frame(s, protocol.build_stats_request(6), await_ack=False)
        assert protocol.frame_id(bytes(framing.recv_frame(s, send_ack=False))) == 6
        framing.send_frame(s, b"JUNK", await_ack=False)
        with pytest.raises((ConnectionError, OSError)):
            framing.recv_frame(s, send_ack=False)


def test_a_server_without_a_spec_answers_features_with_400(tiny, flows):
    _, params = tiny
    texts, records = flows
    engine = ScoreEngine(ModelConfig.tiny(vocab_size=VOCAB), params_from_jax(params), device="cpu")
    with ScoringServer(engine, default_tokenizer()) as server:
        with ScoringClient("127.0.0.1", server.port) as c:
            with pytest.raises(ScoreRejected, match="text requests only") as e:
                c.score(features=records[0])
            assert e.value.code == 400
            assert 0.0 <= c.score(text=texts[0])["prob"] <= 1.0
        assert server.stats()["rejects"]["bad_request"] == 1


# -------------------------------------------------------------------- load
MODES = {
    "closed": dict(concurrency=3),
    "pipelined": dict(concurrency=2, pipeline=8),
    "target_qps": dict(concurrency=2, target_qps=400.0),
    "trace": dict(concurrency=2, arrival_trace="trace"),
}


@pytest.fixture(scope="module")
def jax_result_keys(port_server, flows):
    """The JAX run_load's result keys, from a run against the port."""
    texts, _ = flows
    res = jax_run_load("127.0.0.1", port_server.port, texts[:8], concurrency=2, pipeline=4)
    assert res["scored"] == 8 and res["rejected"] == 0
    return list(res)


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_load_modes(mode, server, port_server, jax_server, flows, jax_result_keys):
    texts, records = flows
    srv = port_server if server == "port" else jax_server
    kw = dict(MODES[mode])
    if kw.get("arrival_trace"):
        kw["arrival_trace"] = load_arrival_trace(TRACE)
    load = [t if i % 2 else records[i] for i, t in enumerate(texts)]  # half features
    before = fetch_stats("127.0.0.1", srv.port)["scored"]
    res = run_load("127.0.0.1", srv.port, load, requests=48, **kw)
    assert list(res) == jax_result_keys
    assert res["scored"] == 48 and res["rejected"] == 0 and len(res["batch_sizes"]) == 48
    assert fetch_stats("127.0.0.1", srv.port)["scored"] - before == 48
    assert res["flows_per_sec"] > 0 and res["p50_ms"] <= res["p95_ms"] <= res["p99_ms"]
    assert res["pipeline"] == {"closed": 1, "pipelined": 8}.get(mode, 32)
    assert res["target_qps"] == kw.get("target_qps")
    if mode == "trace":
        assert res["arrival_trace_len"] == len(kw["arrival_trace"]) and res["arrival_cycle_s"] > 0
        # 48 requests over a 24-gap cycle: two cycles, at least one pause.
        assert res["wall_s"] >= res["arrival_cycle_s"]
    else:
        assert res["arrival_trace_len"] is None and res["arrival_cycle_s"] is None


def test_run_load_refusals_match_jax():
    for kw in (dict(target_qps=0.0), dict(target_qps=5.0, arrival_trace=[0.1]), dict(arrival_trace=[]),
               dict(arrival_trace=[0.1, -1.0])):
        with pytest.raises(ValueError):
            run_load("127.0.0.1", 1, ["x"], **kw)
        with pytest.raises(ValueError):
            jax_run_load("127.0.0.1", 1, ["x"], **kw)
    assert load_arrival_trace(TRACE) == jax_load_arrival_trace(TRACE)


def test_jax_run_load_against_the_port_server(port_server, flows):
    texts, _ = flows
    before = port_server.stats()["scored"]
    for kw in (dict(concurrency=4), dict(concurrency=2, pipeline=16)):
        res = jax_run_load("127.0.0.1", port_server.port, texts, **kw)
        assert res["scored"] == len(texts) and res["rejected"] == 0
        assert max(res["batch_sizes"]) > 1  # coalesced
    assert port_server.stats()["scored"] - before == 2 * len(texts)


@pytest.mark.parametrize("deadline_ms", [None, 0.0])
def test_probe_scores_rows_match_jax(port_server, flows, deadline_ms):
    """One canary pass: a reply (or, past its deadline, the reject row)
    and a round-trip time per text, as the JAX probe gives them."""
    texts, _ = flows
    got = probe_scores("127.0.0.1", port_server.port, texts[:4], deadline_ms=deadline_ms)
    want = jax_probe_scores("127.0.0.1", port_server.port, texts[:4], deadline_ms=deadline_ms)
    assert len(got) == len(want) == 4
    for (g, dt), (w, _) in zip(got, want):
        assert set(g) == set(w) and dt > 0
        if deadline_ms is None:
            assert g["prob"] == w["prob"] and g["round"] == w["round"] == 1
        else:
            assert g["rejected"] is w["rejected"] is True and g["code"] == w["code"] == 504
            assert np.isnan(g["prob"]) and g["round"] is None


def test_async_client_pipelines_on_one_connection(port_server, flows):
    texts, records = flows
    with ScoringClient("127.0.0.1", port_server.port) as c:
        want = [c.score(text=t)["prob"] for t in texts]

    async def go():
        c = await AsyncScoringClient.connect("127.0.0.1", port_server.port)
        try:
            replies = await asyncio.gather(*(c.score(text=t) for t in texts))
            feat = await c.score(features=records[0])
            stats = await c.stats()
            with pytest.raises(ScoreRejected):
                await c.score(text=texts[0], deadline_ms=0.0)
        finally:
            await c.close()
        with pytest.raises(WireError, match="closed"):
            await c.score(text=texts[0])
        return replies, feat, stats

    replies, feat, stats = asyncio.run(go())
    assert [r["prob"] for r in replies] == want and feat["prob"] == want[0]
    assert max(r["batch_size"] for r in replies) > 1
    assert stats["scored"] >= len(texts)


def test_pipelined_client_matches_replies_by_id(port_server, flows):
    texts, _ = flows
    with ScoringClient("127.0.0.1", port_server.port) as c:
        want = [c.score(text=t)["prob"] for t in texts]
    results: dict[int, float] = {}
    with PipelinedScoringClient("127.0.0.1", port_server.port) as c:
        def submit(rows):
            for i in rows:
                results[i] = c.submit(text=texts[i])

        workers = [threading.Thread(target=submit, args=(range(t, len(texts), 4),)) for t in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        got = [results[i].result(timeout=30)["prob"] for i in range(len(texts))]
    assert got == want


# ----------------------------------------------------------------- schemas
def test_kclass_artifact_class_probs_match_jax(flows, tmp_path):
    texts, _ = flows
    cfg, params = _jax_tiny(8, n_classes=7)
    _registry(tmp_path, cfg, params)
    enc = jax_default_tokenizer().batch_encode(texts, max_len=cfg.max_len)
    want_p, want_cp = JaxEngine(cfg, params, pad_id=0).score(enc["input_ids"], enc["attention_mask"])[:2]
    with _serve(tmp_path, "--dataset", "cicddos2019-mc") as server:
        res = run_load("127.0.0.1", server.port, texts, concurrency=4)
        assert res["scored"] == len(texts)
        with ScoringClient("127.0.0.1", server.port) as c:
            replies = [c.score(text=t) for t in texts]
    for i, r in enumerate(replies):
        cp = np.asarray(r["class_probs"])
        assert cp.shape == (7,)
        assert abs(cp.sum() - 1.0) <= 1e-5
        np.testing.assert_allclose(r["prob"], 1.0 - cp[0], atol=1e-6)
        np.testing.assert_allclose(cp, want_cp[i], atol=ATOL)
        np.testing.assert_allclose(r["prob"], want_p[i], atol=ATOL)


def test_unsw_features_match_the_jax_server(tiny, tmp_path):
    cfg, params = tiny
    df = jsynthetic.make_synthetic("unswnb15", 24, seed=4)
    spec = get_dataset("unswnb15")
    records = df[list(spec.feature_columns)].to_dict("records")
    _registry(tmp_path, cfg, params)
    engine = JaxEngine(cfg, params, pad_id=0, buckets=(1, 8))
    with JaxServer(engine, jax_default_tokenizer(), spec=jax_get_dataset("unswnb15"),
                   batcher=JaxBatcher(max_batch=8, max_queue=64, gather_window_s=0.005),
                   idle_tick_s=0.01) as jserver, _serve(tmp_path, "--dataset", "unswnb15") as server:
        with JaxClient("127.0.0.1", jserver.port) as jc, ScoringClient("127.0.0.1", server.port) as c:
            for rec in records:
                got, want = c.score(features=rec), jc.score(features=rec)
                np.testing.assert_allclose(got["prob"], want["prob"], atol=ATOL)
                assert got["prediction"] == want["prediction"]
            cicids_rec = {col: 1 for col in get_dataset("cicids2017").feature_columns}
            for client in (c, jc):
                with pytest.raises(Exception, match="template column") as e:
                    client.score(features=cicids_rec)
                assert e.value.code == 400


def test_infer_serve_refusals(tiny, tmp_path, monkeypatch):
    cfg, params = tiny
    _registry(tmp_path, cfg, params)
    monkeypatch.delenv("FEDTPU_SECRET", raising=False)
    with pytest.raises(SystemExit, match="FEDTPU_SECRET"):
        _serve(tmp_path, "--auth")
    monkeypatch.setenv("FEDTPU_SECRET", "k")
    with pytest.raises(SystemExit, match="max-queue 64 is smaller than the largest bucket 128"):
        _serve(tmp_path, "--auth", "--max-queue", "64")
    with pytest.raises(SystemExit):
        build_parser().parse_args(["infer-serve", "--dataset", "nope"])
    args = build_parser().parse_args(["infer-serve", "--registry-dir", str(tmp_path)])
    assert (args.auth, args.dataset, args.device) == (False, None, "cuda")


def test_a_challenge_that_never_comes_is_named(port_server):
    with pytest.raises(WireError, match="no auth challenge|bad auth challenge"):
        ScoringClient("127.0.0.1", port_server.port, auth_key=KEY, timeout=0.5)
    # A well-formed challenge of the wrong length is refused too.
    a, b = socket.socketpair()
    try:
        framing.send_frame(b, NONCE_MAGIC + b"\0" * (NONCE_LEN - 1), await_ack=False)
        with pytest.raises(WireError, match="bad auth challenge"):
            answer_auth_challenge(a, KEY)
    finally:
        a.close()
        b.close()
