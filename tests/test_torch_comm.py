"""The port's wire and TCP round held against the JAX package's, on the CPU.

* ``encode`` returns the JAX package's bytes for the same params and meta,
  each side's ``decode`` reads the other's bytes exactly, and
  ``flat_crc32`` agrees;
* what the port's server does not fold (secure aggregation, central DP,
  relay and re-homing uploads) raises ``ModeError``, and a sparse delta
  without a base ``WireError``;
* mixed rounds on loopback, bit for bit (crc-equal) with JAX
  ``aggregate_flat``: (a) a JAX server (dense, ``stream_chunk_bytes=0``)
  with a JAX and a port client; (b) the port's server on ``device="cpu"``
  with a JAX and a port client, unweighted and weighted;
* the port's round below quorum times out as the JAX one does
  (tests/test_comm.py::test_round_times_out_below_quorum).
"""

import threading

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    AggregationServer as JaxServer,
    FederatedClient as JaxClient,
    aggregate_flat as jax_aggregate_flat,
    wire as jwire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    AggregationServer,
    FederatedClient,
    ModeError,
    StreamAgg,
    WireError,
    wire as pwire,
)


def _params(rng, scale=1.0):
    return {
        "encoder": {
            "layer_0": {"kernel": rng.normal(size=(8, 8)).astype(np.float32) * scale},
            "bias": rng.normal(size=(8,)).astype(np.float32) * scale,
        },
        "classifier": {"kernel": rng.normal(size=(8, 2)).astype(np.float32) * scale},
    }


def _mixed_dtypes(rng):
    return {
        "a": {"w": rng.normal(size=(3, 5)).astype(np.float32)},
        "b": rng.integers(-9, 9, size=(4,)).astype(np.int32),
        "c": np.float32(2.5),
        "d": rng.normal(size=(2, 2)).astype(np.float64),
        "e": np.array([True, False]),
    }


@pytest.mark.parametrize("flat_input", [False, True])
def test_encode_is_byte_equal_to_jax(flat_input):
    rng = np.random.default_rng(1)
    p = _mixed_dtypes(rng)
    if flat_input:
        p = pwire.flatten_params(p)
    meta = {"client_id": 3, "n_samples": 100, "tag": "x"}
    assert pwire.encode(p, meta=meta) == jwire.encode(p, meta=meta)


def test_each_side_decodes_the_others_bytes():
    rng = np.random.default_rng(2)
    p = _mixed_dtypes(rng)
    meta = {"client_id": 1, "n_samples": 7}
    for blob, decode in ((jwire.encode(p, meta=meta), pwire.decode), (pwire.encode(p, meta=meta), jwire.decode)):
        tree, got_meta = decode(blob)
        assert got_meta == meta
        got, want = pwire.flatten_params(tree), jwire.flatten_params(p)
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    f32 = jwire.flatten_params(_params(rng))
    assert pwire.flat_crc32(f32) == jwire.flat_crc32(f32)
    assert pwire.unflatten_params(pwire.flatten_params(p)).keys() == p.keys()


def test_unported_modes_raise_mode_error():
    """The JAX modes the port's server once refused are folded now: an
    upload's relay record, re-home marker and strategy claim pass
    validation (a split-brain strategy claim is a WireError, as in the
    JAX server); a DP upload to a plain server fails the mode check; and
    a sparse delta without a base raises WireError (the JAX server's
    refusal: the client then resends dense)."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.server import (
        _Round,
    )

    rng = np.random.default_rng(3)
    flat = pwire.flatten_params(_params(rng))
    with AggregationServer(port=0, num_clients=1, timeout=5, device="cpu") as server:
        for key, value in (("subtree_ids", [0, 1]), ("rehomed", 1), ("strategy", {"name": "fedavg"})):
            assert server._validate_upload({"client_id": 0, key: value}, None) == 0
        rnd = _Round(expected=1)
        rnd.stream = StreamAgg(device="cpu")
        assert server._register_tree_meta(rnd, None, 0, {"subtree_ids": [3, 1]})
        assert rnd.subtree_ids == {0: [3, 1]}
        with pytest.raises(WireError, match="split-brain"):
            server._register_tree_meta(rnd, None, 0, {"strategy": {"name": "fedprox"}})
        assert server._validate_upload({"client_id": 4, "dp": False}, None) == 4
        # Central DP is ported: a DP upload to a plain server is a mode
        # mismatch (the JAX server's WireError), not an unported mode.
        assert server._validate_upload({"client_id": 0, "dp": True}, None) == 0
        with pytest.raises(WireError, match="central-DP mode mismatch"):
            server._validate_dp_meta({"client_id": 0, "dp": True}, is_delta=False)
        for meta in ({"delta": True, "base_agg_round": 0}, {"delta": True}):
            with pytest.raises(WireError, match="base is absent"):
                server._check_delta(flat, meta)
    # ModeError is not a WireError: the client does not retry it.
    assert not issubclass(ModeError, WireError)


def test_decode_rejects_corrupt_messages():
    blob = bytearray(pwire.encode(_params(np.random.default_rng(4))))
    with pytest.raises(WireError, match="magic"):
        pwire.decode(b"XXXX" + bytes(blob[4:]))
    blob[-1] ^= 0xFF
    with pytest.raises(WireError, match="CRC"):
        pwire.decode(bytes(blob))


def _run_clients(port, models, weights, kinds):
    """Exchange ``models[i]`` as client i (a JAX or port client per
    ``kinds``) in threads; returns {i: the received aggregate (flat)}."""
    results: dict = {}
    errors: list = []

    def run(i):
        cls = JaxClient if kinds[i] == "jax" else FederatedClient
        try:
            agg = cls("127.0.0.1", port, client_id=i, timeout=30).exchange(
                models[i], n_samples=weights[i], max_retries=2
            )
            results[i] = pwire.flatten_params(agg)
        except BaseException as e:  # re-raised by the test thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(models))]
    for t in threads:
        t.start()
    return threads, results, errors


def _assert_round(threads, results, errors, models, weights):
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    want = jax_aggregate_flat([jwire.flatten_params(m) for m in models], weights)
    crc = jwire.flat_crc32(want)
    for i in results:
        assert list(results[i]) == sorted(want)
        assert pwire.flat_crc32(results[i]) == crc
        for key in want:
            np.testing.assert_array_equal(results[i][key], want[key])
    assert sorted(results) == list(range(len(models)))


def test_jax_server_round_with_a_jax_and_a_port_client():
    rng = np.random.default_rng(5)
    models = [_params(rng), _params(rng, scale=3.0)]
    with JaxServer(port=0, num_clients=2, timeout=30, stream_chunk_bytes=0) as server:
        threads, results, errors = _run_clients(server.port, models, [1, 1], ["jax", "port"])
        agg = server.serve_round(deadline=30.0)
        _assert_round(threads, results, errors, models, None)
    assert jwire.flat_crc32(agg) == pwire.flat_crc32(results[1])


@pytest.mark.parametrize("weighted", [False, True])
def test_port_server_round_with_a_jax_and_a_port_client(weighted):
    rng = np.random.default_rng(6)
    models = [_params(rng), _params(rng, scale=1e-3), _params(rng, scale=1e3)]
    n_samples = [3, 10, 5]
    with AggregationServer(port=0, num_clients=3, weighted=weighted, timeout=30, device="cpu") as server:
        threads, results, errors = _run_clients(server.port, models, n_samples, ["jax", "port", "jax"])
        agg = server.serve_round(deadline=30.0)
        _assert_round(threads, results, errors, models, n_samples if weighted else None)
    assert pwire.flat_crc32(agg) == pwire.flat_crc32(results[0])
    stats = server.last_fold_stats
    assert stats["fold_engine"] == "reference" and stats["late_bytes"] > 0
    assert set(server.phase_seconds) == {"wait", "agg", "reply"}


def _lone_client(port, params, meta=None):
    """One client exchange in a thread; returns (thread, what it raised)."""
    raised: list = []

    def run():
        try:
            FederatedClient("127.0.0.1", port, client_id=0, timeout=5).exchange(
                params, meta=meta, max_retries=1
            )
        except BaseException as e:  # checked by the test thread
            raised.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, raised


def test_port_round_times_out_below_quorum():
    rng = np.random.default_rng(7)
    with AggregationServer(port=0, num_clients=2, timeout=5, device="cpu") as server:
        t, raised = _lone_client(server.port, _params(rng))
        with pytest.raises(RuntimeError, match="1/2 clients"):
            server.serve_round(deadline=2.0)
        t.join(timeout=30)
    assert not t.is_alive()
    assert len(raised) == 1 and isinstance(raised[0], ConnectionError)


def test_port_server_refuses_modes_it_does_not_fold():
    rng = np.random.default_rng(8)
    with AggregationServer(port=0, num_clients=1, timeout=5, device="cpu") as server:
        t, raised = _lone_client(server.port, _params(rng), meta={"delta": True})
        with pytest.raises(RuntimeError, match="0/1 clients"):
            server.serve_round(deadline=2.0)
        t.join(timeout=30)
    assert not t.is_alive()
    assert len(raised) == 1 and isinstance(raised[0], ConnectionError)


def test_cli_refuses_what_the_jax_cli_refuses(monkeypatch):
    """The combinations the JAX CLI refuses are refused here the same way
    (argparse, or ValueError from the server and the client), unported
    flags are unknown to argparse, and the per-client identity keys are
    honoured as the JAX CLI honours them."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        build_parser as jax_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.comm import (
        build_server,
        run_client,
    )

    for parser in (build_parser(), jax_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["serve", "--compression", "topk:0.1"])
        with pytest.raises(SystemExit):
            parser.parse_args(["client", "--client-id", "0", "--compression", "int4"])
    with pytest.raises(ValueError, match="reply_dtype"):
        build_server(build_parser().parse_args(
            ["serve", "--port", "0", "--reply-dtype", "bf16", "--compression", "int8", "--device", "cpu"]
        ))
    with pytest.raises(ValueError, match="reply_dtype"):
        JaxServer(port=0, reply_dtype="bf16", compression="int8")
    for cls in (FederatedClient, JaxClient):
        with pytest.raises(ValueError, match="wire_dtype"):
            cls("127.0.0.1", 1, client_id=0, wire_dtype="int8", compression="bf16")
    args = build_parser().parse_args(
        ["client", "--client-id", "0", "--wire-dtype", "int8", "--compression", "topk", "--device", "cpu"]
    )
    with pytest.raises(ValueError, match="wire_dtype"):
        run_client(args)
    for argv in (["serve", "--secure-agg"], ["client", "--client-id", "0", "--parent", "h:1"],
                 ["client", "--client-id", "0", "--secure-agg"], ["relay", "--relay-id", "0"], ["scenario"],
                 ["client", "--client-id", "0", "--data-parallel", "2", "--fsdp"]):
        build_parser().parse_args(argv)  # ported: valid in both packages
        jax_parser().parse_args(argv)
    for argv in (["client", "--client-id", "0", "--seq-parallel", "2"],):
        with pytest.raises(SystemExit):
            build_parser().parse_args(argv)
        jax_parser().parse_args(argv)  # valid in the JAX package
    # Central DP is ported: its flags parse, and the serve verb refuses
    # what the JAX one refuses (tests/test_torch_dp_tcp.py holds the rest).
    assert build_parser().parse_args(["serve", "--dp-clip", "1"]).dp_clip == 1.0
    assert build_parser().parse_args(["client", "--client-id", "0", "--dp"]).dp
    for bad, err in ((["--dp-participation", "0"], SystemExit), (["--dp-noise-multiplier", "1"], ValueError)):
        with pytest.raises(err):
            build_server(build_parser().parse_args(["serve", "--port", "0", "--device", "cpu", *bad]))
        jargs = jax_parser().parse_args(["serve", "--port", "0", *bad])
        with pytest.raises(err):
            jargs.fn(jargs)
    # The identity keys are read as the JAX CLI reads them: without the
    # group key both refuse them, a malformed registry exits.
    monkeypatch.delenv("FEDTPU_SECRET", raising=False)
    monkeypatch.setenv("FEDTPU_CLIENT_SECRETS", "0:a,1:b")
    with pytest.raises(ValueError, match="client_keys"):
        build_server(build_parser().parse_args(["serve", "--port", "0", "--device", "cpu"]))
    jargs = jax_parser().parse_args(["serve", "--port", "0"])
    with pytest.raises(ValueError, match="client_keys"):
        jargs.fn(jargs)
    monkeypatch.setenv("FEDTPU_CLIENT_SECRETS", "0:a,x:b")
    with pytest.raises(SystemExit, match="malformed"):
        build_server(build_parser().parse_args(["serve", "--port", "0", "--device", "cpu"]))
    monkeypatch.setenv("FEDTPU_SECRET", "group")
    monkeypatch.setenv("FEDTPU_CLIENT_SECRETS", "0:a,1:b")
    with build_server(build_parser().parse_args(["serve", "--port", "0", "--device", "cpu"])) as server:
        assert server.client_keys == {0: b"a", 1: b"b"}
    monkeypatch.delenv("FEDTPU_SECRET")
    monkeypatch.setenv("FEDTPU_CLIENT_SECRET", "a")
    with pytest.raises(ValueError, match="client_key"):
        run_client(build_parser().parse_args(["client", "--client-id", "0", "--device", "cpu"]))
