"""The port's streamed round held against the JAX package's, on the CPU.

* ``StreamAgg`` (leaves folded as every member's copy arrives) equals the
  barrier mean and the JAX ``StreamAgg`` BIT FOR BIT under shuffled
  arrival orders and freeze points (hypothesis), weighted or not;
* a fold set that changes after its first fold, or a member that dies
  after folds began, poisons the round; a duplicate is refused and the
  folded original stands; sparse deltas fold as ``base + delta``; a
  member admitted before any fold re-normalizes the weights;
* ``PipelinedSender`` sends in order and surfaces a dead socket;
* loopback rounds, 3 each, with the port's server (fold on ``cpu``) and
  with a JAX server at its default stream setting, each with a JAX and a
  port client: round 1 is dense, rounds 2 and 3 stream with an fp32, bf16
  or int8c wire, and the reply streams back. Every round's aggregate crc
  equals the plain fold of the uploads as the server decoded them, and
  the server's record shows the port client's uploads as streamed;
* a port server with ``--reply-dtype bf16`` and FedOpt, an int8c streaming
  client and a top-k sparse-delta client (port or JAX) that declines
  streams, so its replies stay exact fp32 and its deltas fold against the
  base: every round's mean equals the plain fold of the decoded uploads.
"""

import socket
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    AggregationServer as JaxServer,
    FederatedClient as JaxClient,
    aggregate_flat as jax_aggregate_flat,
    wire as jwire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm.stream_agg import (
    StreamAgg as JaxStreamAgg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    AggregationServer,
    FederatedClient,
    StreamAgg,
    StreamAggPoisoned,
    framing,
    wire as pwire,
)


def _models(rng, n_clients, keys, shape=(6, 5)):
    return [
        {k: (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 3)).astype(np.float32) for k in keys}
        for _ in range(n_clients)
    ]


@settings(max_examples=40, deadline=None)
@given(
    n_clients=st.integers(2, 4),
    n_keys=st.integers(1, 5),
    weighted=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
    data=st.data(),
)
def test_stream_agg_shuffled_arrivals_equal_the_barrier_bit_for_bit(n_clients, n_keys, weighted, seed, data):
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(n_keys)]
    models = _models(rng, n_clients, keys)
    weights = [float(w) for w in rng.integers(1, 50, n_clients)] if weighted else None
    arrivals = data.draw(st.permutations([(c, k) for c in range(n_clients) for k in keys]))
    freeze_at = data.draw(st.integers(0, len(arrivals)))
    port, jax_agg = StreamAgg(device="cpu"), JaxStreamAgg()
    for agg in (port, jax_agg):
        for c in range(n_clients):
            agg.register(c, keys=tuple(keys), n_samples=1.0 if weights is None else weights[c])
    ids = list(range(n_clients))
    for i, (c, k) in enumerate(arrivals):
        if i == freeze_at:
            port.freeze(ids, weights)
            jax_agg.freeze(ids, weights)
        port.add_leaf(c, k, models[c][k])
        jax_agg.add_leaf(c, k, models[c][k])
    got = port.finalize(ids, weights)
    want = jax_aggregate_flat(models, weights)
    assert list(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], jax_agg.finalize(ids, weights)[k])
    assert pwire.flat_crc32(got) == jwire.flat_crc32(want)
    if freeze_at < len(arrivals):
        # Eager folds freed per-leaf state: peak stays under N x model.
        model_bytes = sum(v.nbytes for v in models[0].values())
        assert port.peak_bytes < n_clients * model_bytes or n_keys == 1


def test_stream_agg_poisoning_rules():
    rng = np.random.default_rng(1)
    keys = ["a", "b"]
    models = _models(rng, 3, keys)

    def folded(n=2):
        agg = StreamAgg(device="cpu")
        for c in range(n):
            agg.register(c, keys=tuple(keys), n_samples=1.0)
            agg.add_leaf(c, "a", models[c]["a"])
        agg.freeze(list(range(n)), None)  # folds "a" at once
        return agg

    # A fold set that changes after its first fold poisons the round.
    agg = folded()
    agg.freeze([0], None)
    assert "fold set changed" in agg.poisoned
    with pytest.raises(StreamAggPoisoned):
        agg.finalize([0], None)
    # A member that dies after folds began poisons the round.
    agg = folded()
    assert not agg.drop_client(1)
    with pytest.raises(StreamAggPoisoned, match="dropped its upload"):
        agg.finalize([0, 1], None)
    assert agg.client_stats() == {0: {"weight": 1.0, "bytes": float(models[0]["a"].nbytes), "scale": 1.0}}
    # A duplicate after folds began is refused; the folded original stands.
    agg = folded()
    assert not agg.drop_client(1, poison=False)
    assert agg.poisoned is None
    for c in range(2):
        agg.add_leaf(c, "b", models[c]["b"])
    got = agg.finalize([0, 1], None)
    want = jax_aggregate_flat(models[:2])
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k])
    # Before any fold, a death re-freezes over the survivors; a new member
    # is admitted, after a fold it is refused.
    agg = StreamAgg(device="cpu")
    for c in range(3):
        agg.register(c, keys=tuple(keys), n_samples=1.0)
    agg.freeze([0, 1, 2], None)
    assert agg.drop_client(2) and agg.fold_ids is None
    agg.freeze([0, 1], None)
    assert agg.admit(2) and agg.fold_ids is None
    agg.register(2, keys=tuple(keys), n_samples=1.0)
    for c in range(3):
        agg.add_dense(c, models[c])
    got = agg.finalize([0, 1, 2], None)
    want = jax_aggregate_flat(models)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k])
    assert not folded().admit(2)


def test_stream_agg_sparse_deltas_fold_against_the_base():
    rng = np.random.default_rng(2)
    keys = ["a", "b", "c"]
    base = _models(rng, 1, keys)[0]
    delta = {k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32) for k, v in base.items()}
    dense = _models(rng, 1, keys)[0]
    outs = []
    for agg in (StreamAgg(device="cpu", base=base), JaxStreamAgg(base=base)):
        agg.register(0, keys=tuple(keys), n_samples=3.0, delta=True)
        agg.register(1, keys=tuple(keys), n_samples=1.0)
        agg.add_dense(1, dense)
        agg.freeze([0, 1], [3.0, 1.0])
        agg.add_dense(0, delta)
        outs.append(agg.finalize([0, 1], [3.0, 1.0]))
    absolute = {k: base[k] + delta[k] for k in keys}
    want = jax_aggregate_flat([absolute, dense], [3.0, 1.0])
    for k in keys:
        np.testing.assert_array_equal(outs[0][k], want[k])
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_pipelined_sender_keeps_order_and_surfaces_errors():
    a, b = socket.socketpair()
    payloads = [bytes([i]) * (1000 + i) for i in range(20)]
    got = []

    def reader():
        for _ in payloads:
            got.append(bytes(framing.recv_frame(b, send_ack=False)))

    t = threading.Thread(target=reader)
    t.start()
    sender = framing.PipelinedSender(a, depth=2)
    for p in payloads:
        sender.send(p)
    sender.close()
    t.join(timeout=30)
    assert not t.is_alive() and got == payloads
    b.close()
    sender = framing.PipelinedSender(a)
    with pytest.raises(OSError):
        for _ in range(1000):
            sender.send(b"x" * 100_000)
        sender.close()
    a.close()


# ------------------------------------------------------------- loopback
def _params(rng):
    return {
        "encoder": {
            "emb": {"embedding": rng.normal(size=(300, 20)).astype(np.float32)},
            "layer_0": {"kernel": rng.normal(size=(20, 20)).astype(np.float32) * 0.1},
            "bias": rng.normal(size=(20,)).astype(np.float32),
        },
        "classifier": {"kernel": rng.normal(size=(20, 2)).astype(np.float32)},
    }


def _upload(base, cid, r):
    return {k: v + np.float32(0.01 * (r + 1) * (cid + 1)) for k, v in pwire.flatten_params(base).items()}


def _decoded(flat, enc):
    """The upload as the server decodes it: the stream leaf codec's round trip."""
    out = {}
    for k, v in flat.items():
        t = {"key": k, "dtype": "float32", "shape": list(v.shape), "enc": enc}
        out[k] = jwire.decode_tensor_entry(t, jwire.encode_stream_leaf(v, enc))
    return out


def _run_fleet(serve_round, port, bases, kinds, wire_dtypes, rounds, weights):
    received = {c: [] for c in range(len(kinds))}
    shapes = {c: [] for c in range(len(kinds))}
    errors: list = []

    def loop(cid):
        cls = JaxClient if kinds[cid] == "jax" else FederatedClient
        try:
            client = cls("127.0.0.1", port, client_id=cid, timeout=30, wire_dtype=wire_dtypes[cid])
            for r in range(rounds):
                agg = client.exchange(_upload(bases[cid], cid, r), n_samples=weights[cid], max_retries=1)
                received[cid].append(pwire.flatten_params(agg))
                shapes[cid].append(
                    client.last_wire_dtype if kinds[cid] == "jax" else
                    (client.last_exchange["upload_shape"], client.last_exchange["wire_dtype"],
                     client.last_exchange["reply_shape"])
                )
        except BaseException as e:  # re-raised by the test thread
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(c,), daemon=True) for c in range(len(kinds))]
    for t in threads:
        t.start()
    aggs = [serve_round(r) for r in range(rounds)]
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return aggs, received, shapes


def _assert_rounds(aggs, received, bases, wire_dtypes, weights):
    for r, agg in enumerate(aggs):
        decoded = [
            _decoded(_upload(bases[c], c, r), pwire.WIRE_DTYPE_ENCS[wire_dtypes[c]] if r else "raw")
            for c in range(len(bases))
        ]
        want = jax_aggregate_flat(decoded, weights)
        assert pwire.flat_crc32(agg) == jwire.flat_crc32(want), f"round {r + 1}"
        for c in received:
            assert pwire.flat_crc32(received[c][r]) == jwire.flat_crc32(want), (r, c)


@pytest.mark.parametrize("wire_dtypes", [("fp32", "bf16"), ("int8", "fp32"), ("bf16", "int8")])
def test_port_server_streamed_rounds_with_a_jax_and_a_port_client(wire_dtypes):
    rng = np.random.default_rng(3)
    bases = [_params(rng), _params(rng)]
    weights = [10, 30]
    with AggregationServer(port=0, num_clients=2, weighted=True, timeout=30, device="cpu",
                           stream_chunk_bytes=4096) as server:
        records = []

        def serve_round(r):
            agg = server.serve_round(deadline=30.0)
            records.append(dict(server.last_uploads))
            return agg

        aggs, received, shapes = _run_fleet(serve_round, server.port, bases, ["jax", "port"], wire_dtypes, 3, weights)
    _assert_rounds(aggs, received, bases, wire_dtypes, weights)
    assert shapes[1] == [("dense", "fp32", "stream")] + [("stream", wire_dtypes[1], "stream")] * 2
    assert shapes[0] == ["fp32", wire_dtypes[0], wire_dtypes[0]]
    assert [{c: u["shape"] for c, u in rec.items()} for rec in records] == [
        {0: "dense", 1: "dense"}, {0: "stream", 1: "stream"}, {0: "stream", 1: "stream"}
    ]
    assert [rec[1]["wire_dtype"] for rec in records] == ["fp32", wire_dtypes[1], wire_dtypes[1]]
    fold = server.last_fold_stats
    assert fold["fold_engine"] == "reference" and fold["early_bytes"] + fold["late_bytes"] > 0


@pytest.mark.parametrize("wire_dtypes", [("bf16", "int8"), ("fp32", "fp32")])
def test_jax_server_streams_a_port_clients_upload_from_round_two(wire_dtypes):
    rng = np.random.default_rng(4)
    bases = [_params(rng), _params(rng)]
    weights = [5, 5]
    with JaxServer(port=0, num_clients=2, timeout=30) as server:
        assert server.stream_chunk_bytes == jwire.DEFAULT_STREAM_CHUNK
        aggs, received, shapes = _run_fleet(
            lambda r: server.serve_round(deadline=30.0), server.port, bases, ["jax", "port"], wire_dtypes, 3, weights
        )
        totals = dict(server.stream_totals)
    _assert_rounds(aggs, received, bases, wire_dtypes, None)
    # Both clients streamed rounds 2 and 3 (4 streams) after a dense round
    # 1 (2 fallbacks), and the port client says its uploads streamed.
    assert totals["stream_uploads"] == 4 and totals["stream_fallbacks"] == 2
    assert totals["stream_replies"] == 6
    assert shapes[1] == [("dense", "fp32", "stream")] + [("stream", wire_dtypes[1], "stream")] * 2


def test_port_server_lossy_streamed_reply_and_auth():
    """``--reply-dtype bf16`` under HMAC: the clients get the aggregate
    streamed in bf16 (each advertised it), the server keeps its fp32 mean."""
    rng = np.random.default_rng(5)
    bases = [_params(rng), _params(rng)]
    key = b"secret"
    with AggregationServer(port=0, num_clients=2, timeout=30, device="cpu", stream_chunk_bytes=4096,
                           reply_dtype="bf16", auth_key=key) as server:
        received, errors = {}, []

        def loop(cid):
            cls = JaxClient if cid == 0 else FederatedClient
            try:
                client = cls("127.0.0.1", server.port, client_id=cid, timeout=30, auth_key=key)
                received[cid] = [pwire.flatten_params(client.exchange(_upload(bases[cid], cid, r), max_retries=1))
                                 for r in range(2)]
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=loop, args=(c,), daemon=True) for c in range(2)]
        for t in threads:
            t.start()
        aggs = [server.serve_round(deadline=30.0) for _ in range(2)]
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors
    for r, agg in enumerate(aggs):
        want = jax_aggregate_flat([_upload(bases[c], c, r) for c in range(2)])
        assert pwire.flat_crc32(agg) == jwire.flat_crc32(want)
        lossy = _decoded(want, "bf16")
        for c in range(2):
            for k in want:
                np.testing.assert_array_equal(received[c][r][k], lossy[k])


@pytest.mark.parametrize("topk_kind", ["port", "jax"])
def test_port_server_mixes_int8c_streams_topk_deltas_a_lossy_reply_and_fedopt(topk_kind):
    """Client 0 streams int8c uploads and takes bf16 streamed replies;
    client 1 uploads top-k sparse deltas and, with streaming off, dense
    fp32 replies, so its base stays exact; the server runs FedOpt. Every
    round's mean equals the plain fold of the uploads as decoded (int8c
    dequantized; base + densified top-k), bit for bit."""
    rng = np.random.default_rng(6)
    start = pwire.flatten_params(_params(rng))
    with AggregationServer(port=0, num_clients=2, timeout=30, device="cpu", stream_chunk_bytes=4096,
                           reply_dtype="bf16", strategy="fedopt:opt=adam,lr=0.1") as server:
        clients = [
            FederatedClient("127.0.0.1", server.port, client_id=0, timeout=30, wire_dtype="int8"),
            (FederatedClient if topk_kind == "port" else JaxClient)(
                "127.0.0.1", server.port, client_id=1, timeout=30, compression="topk:0.01", stream=False
            ),
        ]
        sent = {0: [], 1: []}
        received = {0: [], 1: []}
        errors: list = []

        def loop(cid):
            try:
                cur = start
                for r in range(3):
                    up = {k: (v + rng_c[cid].normal(size=v.shape).astype(np.float32) * 0.05) for k, v in cur.items()}
                    sent[cid].append(up)
                    cur = pwire.flatten_params(clients[cid].exchange(pwire.unflatten_params(up), max_retries=1))
                    received[cid].append(cur)
            except BaseException as e:
                errors.append(e)

        rng_c = {0: np.random.default_rng(60), 1: np.random.default_rng(61)}
        threads = [threading.Thread(target=loop, args=(c,), daemon=True) for c in range(2)]
        for t in threads:
            t.start()
        means, globals_ = [], []
        for _ in range(3):
            globals_.append(server.serve_round(deadline=30.0))
            means.append(server.last_mean)
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors
    residual = None
    for r in range(3):
        a = sent[0][r] if r == 0 else _decoded(sent[0][r], "int8c")
        if r == 0:
            b = sent[1][0]
        else:
            base = globals_[r - 1]
            d = {k: sent[1][r][k] - base[k] + (residual[k] if residual else 0) for k in base}
            dense = {k: jwire.densify_topk(jwire.sparsify_topk(v, 0.01), v.shape) for k, v in d.items()}
            for k, v in dense.items():
                assert np.count_nonzero(v) <= max(1, round(0.01 * v.size))
            residual = {k: d[k] - dense[k] for k in d}
            b = {k: base[k] + dense[k] for k in base}
        want = jax_aggregate_flat([a, b])
        assert pwire.flat_crc32(means[r]) == jwire.flat_crc32(want), f"round {r + 1}"
        if r:
            assert pwire.flat_crc32(globals_[r]) != pwire.flat_crc32(means[r])  # FedOpt stepped
        exact, lossy = globals_[r], _decoded(globals_[r], "bf16")
        for k in exact:
            np.testing.assert_array_equal(received[1][r][k], exact[k])
            np.testing.assert_array_equal(received[0][r][k], lossy[k])
    upload_bytes = (
        [clients[1].last_exchange["upload_bytes"]] if topk_kind == "port" else [clients[1].last_upload_bytes]
    )
    assert upload_bytes[0] < 0.1 * sum(v.nbytes for v in start.values())  # round 3 went sparse


def _stream_frames(chunks, *, n_end=None, key=None, nonce=b"", direction="up"):
    frames = [pwire.encode_stream_chunk(i, c, auth_key=key, nonce=nonce, direction=direction) for i, c in enumerate(chunks)]
    return frames + [pwire.encode_stream_end(len(chunks) if n_end is None else n_end, auth_key=key, nonce=nonce,
                                             direction=direction)]


@pytest.mark.parametrize(
    "case,match",
    [
        ("ok", None),
        ("empty_chunk", "empty stream chunk"),
        ("overrun", "overruns"),
        ("reorder", "out of order"),
        ("trailer_count", "claims"),
        ("wrong_direction", "HMAC"),
    ],
)
def test_recv_stream_hands_over_leaves_and_refuses_malformed_streams(case, match):
    """The one receive loop of the streamed upload and reply: each leaf
    (zero-size ones included) is handed over when its last byte lands,
    across chunk boundaries; a malformed stream raises WireError, as the
    JAX package's server and client refuse it."""
    rng = np.random.default_rng(7)
    flat = {"a": np.zeros((0,), np.float32), "b": rng.normal(size=(300,)).astype(np.float32),
            "c": np.zeros((0, 3), np.float32), "d": rng.normal(size=(7, 5)).astype(np.float32)}
    tensors, n = pwire.plan_stream(flat, "int8c")
    payload = b"".join(pwire.encode_stream_leaf(flat[t["key"]], t["enc"]) for t in tensors)
    chunks = [payload[i : i + 100] for i in range(0, len(payload), 100)]
    key, nonce, direction = b"k", bytes(16), "up"
    frames = _stream_frames(chunks, key=key, nonce=nonce)
    if case == "empty_chunk":
        frames = _stream_frames([chunks[0], b""] + chunks[1:], key=key, nonce=nonce)
    elif case == "overrun":
        frames = _stream_frames(chunks[:-1] + [chunks[-1] + b"xyz"], key=key, nonce=nonce)
    elif case == "reorder":
        frames[0], frames[1] = frames[1], frames[0]
    elif case == "trailer_count":
        frames = _stream_frames(chunks, n_end=len(chunks) + 1, key=key, nonce=nonce)
    elif case == "wrong_direction":
        direction = "down"
    a, b = socket.socketpair()

    def writer():
        for f in frames:
            try:
                framing.send_frame(a, f, await_ack=f is frames[-1])
            except OSError:
                return

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    got = []
    try:
        if match is None:
            seq, nbytes = framing.recv_stream(b, tensors, n, lambda e, raw: got.append((e["key"], raw)),
                                              auth_key=key, nonce=nonce, direction=direction)
            assert seq == len(chunks) and nbytes == sum(len(f) for f in frames)
            assert [k for k, _ in got] == sorted(flat)
            for (k, raw), e in zip(got, tensors):
                np.testing.assert_array_equal(pwire.decode_tensor_entry(e, raw),
                                              jwire.decode_tensor_entry(e, raw))
        else:
            with pytest.raises(pwire.WireError, match=match):
                framing.recv_stream(b, tensors, n, lambda e, raw: got.append(e), auth_key=key, nonce=nonce,
                                    direction=direction)
    finally:
        b.close()
        t.join(timeout=10)
        a.close()
    assert not t.is_alive()
