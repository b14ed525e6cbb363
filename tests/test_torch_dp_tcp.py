"""Central DP on the port's TCP tier, held against the JAX package's, on
the CPU (after tests/test_dp_tcp.py, every case, the two secure-agg ones
included).

* The port's server and client run each JAX case: the noiseless round is
  ``base + mean(clip(delta_i))`` (atol 1e-5, the JAX test's bound), the
  noise's std is within 10% of ``multiplier * clip / n``, a base
  mismatch fails the round, the server re-clips, the mode guards, the
  Poisson cohort (with and without the authenticated sit-out), the empty
  cohort's no-op, a non-sampled upload refused, the serve banner's
  epsilon, a plain client's diagnosis, the stranded client's composed
  resync (bit-exact), a base outside the window failing, zero-delta
  rounds, the fleet-wide missed reply, healing at full quorum, a stale
  client sitting out, the history across a restart, a corrupt history.
* Mixed rounds at noise 0: a port server with JAX clients and a JAX
  server with port clients agree with the all-port arithmetic, and the
  clients' bases are bit-equal; the handshake frames, the clipped upload
  frame and the reply meta are byte-equal between the packages.
* Secure aggregation with central DP: masked clipped deltas, the noiseless
  mean within the JAX test's atol 1e-5 of ``base + mean(delta)``, equal
  bit for bit across the packages in both directions; the serve banner
  states the honest-client-only clipping, word for word the JAX one.
"""

import logging
import socket
import struct
import threading

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    AggregationServer as JaxServer,
    FederatedClient as JaxClient,
    wire as jwire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    AggregationServer as PortServer,
    FederatedClient as PortClient,
    framing,
    wire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.client import (
    connect_with_retry,
)

flatten_params = wire.flatten_params


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _server(kind="port", **kw):
    if kind == "jax":
        return JaxServer(port=0, **kw)
    return PortServer(port=0, device="cpu", **kw)


def _client(kind, port, i, **kw):
    cls = JaxClient if kind == "jax" else PortClient
    return cls("127.0.0.1", port, client_id=i, **kw)


def _serve_one(server, results, deadline=20):
    def _go():
        try:
            results["agg"] = server.serve_round(deadline=deadline)
        except RuntimeError as e:
            results["agg"] = None
            results["err"] = e

    t = threading.Thread(target=_go)
    t.start()
    return t


def _run_clients(clients, params_list, bases, results, n_samples=1):
    def _go(i):
        results[i] = clients[i].exchange(params_list[i], n_samples=n_samples, round_base=bases[i])

    ts = [threading.Thread(target=_go, args=(i,)) for i in range(len(clients))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    return ts


def _clip(d, clip):
    n = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in d.values()))
    s = min(1.0, clip / n)
    return {k: v * np.float32(s) for k, v in d.items()}


def _step(rng, b, scale):
    return {k: b[k] + rng.normal(size=b[k].shape).astype(np.float32) * scale for k in b}


@pytest.mark.parametrize("server_kind,client_kinds", [
    ("port", ("port", "port")), ("port", ("jax", "jax")), ("jax", ("port", "port")), ("port", ("jax", "port")),
])
def test_plain_dp_round_is_clipped_mean_of_deltas(rng, server_kind, client_kinds):
    base = {"w": np.zeros((8, 4), np.float32), "b": np.zeros(4, np.float32)}
    small = {"w": rng.normal(size=(8, 4)).astype(np.float32) * 0.01, "b": rng.normal(size=4).astype(np.float32) * 0.01}
    big = {"w": rng.normal(size=(8, 4)).astype(np.float32) * 100.0, "b": rng.normal(size=4).astype(np.float32) * 100.0}
    clip = 1.0
    params = [{k: base[k] + small[k] for k in base}, {k: base[k] + big[k] for k in base}]
    results = {}
    with _server(server_kind, num_clients=2, timeout=20, dp_clip=clip, dp_noise_multiplier=0.0) as server:
        st = _serve_one(server, results)
        clients = [_client(client_kinds[i], server.port, i, timeout=20, dp=True) for i in range(2)]
        _run_clients(clients, params, [base, base], results)
        st.join(timeout=30)
    cs, cb = _clip(small, clip), _clip(big, clip)
    for key in base:
        want = base[key] + 0.5 * (cs[key] + cb[key])
        np.testing.assert_allclose(flatten_params(results[0])[key], want, atol=1e-5)
        np.testing.assert_array_equal(flatten_params(results[0])[key], flatten_params(results[1])[key])
    # The reply was a delta, never absolute weights.
    np.testing.assert_allclose(results["agg"]["w"], 0.5 * (cs["w"] + cb["w"]), atol=1e-5)


def test_dp_noise_is_calibrated(rng):
    base = {"w": np.zeros((200, 100), np.float32)}
    clip, mult = 2.0, 0.5
    results = {}
    with _server(num_clients=1, timeout=20, dp_clip=clip, dp_noise_multiplier=mult) as server:
        st = _serve_one(server, results)
        client = PortClient("127.0.0.1", server.port, client_id=0, timeout=20, dp=True)
        _run_clients([client], [dict(base)], [base], results)
        st.join(timeout=30)
    noise = flatten_params(results[0])["w"]
    sigma = mult * clip / 1
    assert abs(float(noise.std()) - sigma) < 0.1 * sigma
    assert abs(float(noise.mean())) < 4 * sigma / np.sqrt(noise.size)


def test_dp_base_mismatch_fails_the_round(rng):
    b0 = {"w": np.zeros((4, 4), np.float32)}
    b1 = {"w": np.ones((4, 4), np.float32)}
    params = [dict(b0), dict(b1)]
    errs = {}
    with _server(num_clients=2, timeout=10, dp_clip=1.0) as server:

        def _go(i, base):
            try:
                PortClient("127.0.0.1", server.port, client_id=i, timeout=10, dp=True).exchange(
                    params[i], round_base=base, max_retries=1
                )
            except (ConnectionError, wire.WireError) as e:
                errs[i] = e

        ts = [threading.Thread(target=_go, args=(i, b), daemon=True) for i, b in enumerate([b0, b1])]
        for t in ts:
            t.start()
        with pytest.raises(RuntimeError, match="base mismatch"):
            server.serve_round(deadline=8)
        for t in ts:
            t.join(timeout=15)
    assert set(errs) == {0, 1}


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_server_enforces_the_clip(rng, kind):
    """The raw DP handshake and the re-clip, against either server: the
    advert, the verdict and the reply's meta are the same bytes."""
    base_crc = wire.flat_crc32({"w": np.zeros(4, np.float32)})
    huge = {"w": np.full(4, 100.0, np.float32)}  # norm 200 >> clip 1
    results = {}
    with _server(kind, num_clients=1, timeout=10, dp_clip=1.0) as server:
        st = _serve_one(server, results, deadline=10)
        sock = connect_with_retry("127.0.0.1", server.port, timeout=10)
        try:
            sock.settimeout(10)
            adv = framing.recv_frame(sock)
            assert bytes(adv) == wire.DP_MAGIC + struct.pack("<ddd", 1.0, 0.0, 1.0)
            framing.send_frame(sock, wire.DPID_MAGIC + struct.pack("<q", 0))
            verdict = framing.recv_frame(sock)
            assert bytes(verdict) == wire.DPCOHORT_MAGIC + b"\x01"
            framing.send_frame(
                sock,
                wire.encode(huge, meta={"client_id": 0, "n_samples": 1, "dp": True, "dp_base_crc": base_crc}),
            )
            reply, meta = wire.decode(framing.recv_frame(sock))
        finally:
            sock.close()
        st.join(timeout=20)
    assert meta["dp_reply"] == "delta" and meta["dp_base_crc"] == base_crc and meta["round_clients"] == [0]
    got = np.asarray(reply["w"], np.float32)
    assert np.sqrt(float((got**2).sum())) == pytest.approx(1.0, rel=1e-5)
    np.testing.assert_array_equal(got, jwire.clip_flat(huge, 1.0)[0]["w"])


def test_dp_constructor_and_mode_guards():
    with pytest.raises(ValueError, match="dp_clip"):
        _server(num_clients=2, dp_noise_multiplier=1.0)
    with pytest.raises(ValueError, match="uniform mean"):
        _server(num_clients=2, weighted=True, dp_clip=1.0)
    with pytest.raises(ValueError, match="dp_participation"):
        _server(num_clients=2, dp_participation=0.5)
    with pytest.raises(ValueError, match="incompatible with central DP"):
        _server(num_clients=2, dp_clip=1.0, strategy="momentum")
    with pytest.raises(ValueError, match="topk"):
        PortClient("h", 1, client_id=0, dp=True, compression="topk")
    with pytest.raises(ValueError, match="round_base"):
        PortClient("h", 1, client_id=0, dp=True).exchange({"w": np.zeros(2, np.float32)})


def test_plain_client_rejected_by_dp_server(rng):
    params = {"w": np.ones(4, np.float32)}
    errs = {}
    with _server(num_clients=1, timeout=6, dp_clip=1.0) as server:

        def _go():
            try:
                PortClient("127.0.0.1", server.port, client_id=0, timeout=6).exchange(params, max_retries=1)
            except (ConnectionError, wire.WireError) as e:
                errs["c"] = e

        ct = threading.Thread(target=_go, daemon=True)
        ct.start()
        with pytest.raises(RuntimeError, match="clients"):
            server.serve_round(deadline=5)
        ct.join(timeout=15)
    assert "c" in errs


def test_dp_client_fails_fast_against_non_dp_server(rng):
    import time

    with _server(num_clients=1, timeout=5) as server:
        client = PortClient("127.0.0.1", server.port, client_id=0, timeout=5, dp=True)
        t0 = time.monotonic()
        with pytest.raises(wire.ModeError, match="DP advert"):
            client.exchange(
                {"w": np.zeros(2, np.float32)}, round_base={"w": np.zeros(2, np.float32)}, max_retries=5
            )
        assert time.monotonic() - t0 < 12.0


class _ScriptedRng:
    """Deterministic cohort draws; normal draws from a real generator."""

    def __init__(self, values, real):
        self._values = list(values)
        self._real = real

    def random(self):
        return self._values.pop(0) if self._values else self._real.random()

    def standard_normal(self, *a, **kw):
        return self._real.standard_normal(*a, **kw)


@pytest.mark.parametrize("auth,client_kinds", [
    (None, ("port", "port")), (b"dp-skip-auth", ("port", "port")), (b"dp-skip-auth", ("jax", "port")),
])
def test_poisson_cohort_mixed_round(rng, auth, client_kinds):
    base = {"w": np.zeros((6, 3), np.float32)}
    d0 = {"w": rng.normal(size=(6, 3)).astype(np.float32) * 0.01}
    params = [{"w": base["w"] + d0["w"]}, {"w": base["w"] + np.float32(7.0)}]
    results = {}
    with _server(
        num_clients=2, timeout=20, dp_clip=1.0, dp_participation=0.5, min_clients=1, auth_key=auth
    ) as server:
        server._dp_rng = _ScriptedRng([0.1, 0.9], np.random.default_rng(0))
        st = _serve_one(server, results)
        clients = [_client(client_kinds[i], server.port, i, timeout=20, dp=True, auth_key=auth) for i in range(2)]
        _run_clients(clients, params, [base, base], results)
        st.join(timeout=30)
    n = np.sqrt(float((d0["w"].astype(np.float64) ** 2).sum()))
    want = base["w"] + d0["w"] * np.float32(min(1.0, 1.0 / n))
    np.testing.assert_allclose(flatten_params(results[0])["w"], want, atol=1e-5)
    np.testing.assert_array_equal(flatten_params(results[0])["w"], flatten_params(results[1])["w"])
    assert float(np.abs(flatten_params(results[0])["w"]).max()) < 1.0


def test_poisson_empty_cohort_round_is_clean_noop(rng):
    base = {"w": np.ones((4, 2), np.float32)}
    params = [{"w": base["w"] + np.float32(0.5)}, {"w": base["w"] - np.float32(0.25)}]
    results = {}
    with _server(num_clients=2, timeout=20, dp_clip=1.0, dp_participation=0.5, min_clients=1) as server:
        server._dp_rng = _ScriptedRng([0.9, 0.9], np.random.default_rng(0))
        st = _serve_one(server, results)
        clients = [PortClient("127.0.0.1", server.port, client_id=i, timeout=20, dp=True) for i in range(2)]
        _run_clients(clients, params, [base, base], results)
        st.join(timeout=30)
    assert results["agg"] is None
    for i in range(2):
        np.testing.assert_array_equal(flatten_params(results[i])["w"], base["w"])


def test_upload_from_non_sampled_client_rejected(rng):
    base_crc = wire.flat_crc32({"w": np.zeros(2, np.float32)})
    results = {}
    with _server(num_clients=2, timeout=10, dp_clip=1.0, dp_participation=0.5, min_clients=1) as server:
        server._dp_rng = _ScriptedRng([0.9, 0.1], np.random.default_rng(0))
        st = _serve_one(server, results, deadline=6)
        sock = connect_with_retry("127.0.0.1", server.port, timeout=10)
        try:
            sock.settimeout(10)
            framing.recv_frame(sock)  # mode advert
            framing.send_frame(sock, wire.DPID_MAGIC + struct.pack("<q", 0))
            verdict = framing.recv_frame(sock)
            assert verdict[-1] == 0  # told to sit out
            with pytest.raises((ConnectionError, OSError)):
                framing.send_frame(
                    sock,
                    wire.encode(
                        {"w": np.zeros(2, np.float32)},
                        meta={"client_id": 0, "n_samples": 1, "dp": True, "dp_base_crc": base_crc},
                    ),
                )
                framing.recv_frame(sock)
        finally:
            sock.close()
        st.join(timeout=20)


def _capture_logs(fn, name):
    msgs: list[str] = []

    class _Cap(logging.Handler):
        def emit(self, record):
            msgs.append(record.getMessage())

    logger = logging.getLogger(name)
    h = _Cap()
    logger.addHandler(h)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        rc = fn()
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)
    return rc, [m for m in msgs if "[DP]" in m]


def test_dp_participation_banner_exact():
    """The serve banner equals the JAX serve banner, word for word, and
    its epsilon is the subsampled accountant's."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        main as jax_main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel.dp import (
        dp_epsilon,
    )

    argv = [
        "serve", "--port", "0", "--num-clients", "2", "--dp-clip", "0.5", "--dp-noise-multiplier", "1.0",
        "--dp-participation", "0.2", "--rounds", "1", "--timeout", "0.3",
    ]
    rc, banner = _capture_logs(lambda: main(argv + ["--device", "cpu"]), "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch")
    assert rc == 0 and banner
    assert "Poisson cohort sampling q=0.2 (accountant exact" in banner[0]
    assert "hidden cohort" in banner[0]
    eps_q = dp_epsilon(1, 1.0, 1e-5, sampling_rate=0.2)
    assert eps_q < dp_epsilon(1, 1.0, 1e-5)
    assert f"({eps_q:.3g}, 1e-05)-DP under zeroed-contribution" in banner[0]
    jrc, jbanner = _capture_logs(lambda: jax_main(argv), "fedtpu")
    assert jrc == 0 and jbanner == banner


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_plain_client_diagnoses_dp_server(rng, kind):
    with _server(kind, num_clients=2, timeout=10, dp_clip=1.0) as server:

        def _round():
            try:
                server.serve_round(deadline=12)
            except RuntimeError:
                pass

        st = threading.Thread(target=_round, daemon=True)
        st.start()
        plain = PortClient("127.0.0.1", server.port, client_id=0, timeout=10)
        with pytest.raises(wire.ModeError, match="--dp"):
            plain.exchange({"w": np.zeros(2, np.float32)}, max_retries=5)


@pytest.mark.parametrize("server_kind,client_kinds", [("port", ("port", "port")), ("jax", ("port", "jax"))])
def test_stranded_client_resyncs_via_composed_catchup_delta(rng, server_kind, client_kinds):
    base = {"w": np.zeros((6, 3), np.float32), "b": np.zeros(3, np.float32)}
    results = {}
    with _server(
        server_kind, num_clients=2, min_clients=1, timeout=20, dp_clip=1e6, dp_noise_multiplier=0.0
    ) as server:
        clients = [_client(client_kinds[i], server.port, i, timeout=20, dp=True) for i in range(2)]
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base, 0.01), _step(rng, base, 0.02)], [base, base], results)
        st.join(timeout=30)
        base1 = {k: np.asarray(v, np.float32) for k, v in flatten_params(results[0]).items()}
        np.testing.assert_array_equal(flatten_params(results[0])["w"], flatten_params(results[1])["w"])
        st = _serve_one(server, results, deadline=4)
        out1 = clients[1].exchange(_step(rng, base1, 0.015), round_base=base1)
        st.join(timeout=30)
        base2 = {k: np.asarray(v, np.float32) for k, v in flatten_params(out1).items()}
        assert not np.array_equal(base2["w"], base1["w"])
        st = _serve_one(server, results)
        params3 = [_step(rng, base1, 0.01), _step(rng, base2, 0.02)]
        _run_clients(clients, params3, [base1, base2], results)
        st.join(timeout=30)
        r0, r1 = flatten_params(results[0]), flatten_params(results[1])
        for key in r0:
            np.testing.assert_array_equal(r0[key], r1[key])
        d3 = {k: np.asarray(flatten_params(params3[1])[k], np.float32) - base2[k] for k in base2}
        for key in r1:
            np.testing.assert_allclose(r1[key], base2[key] + d3[key], atol=1e-4)
        base3 = {k: np.asarray(v, np.float32) for k, v in r0.items()}
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base3, 0.01), _step(rng, base3, 0.02)], [base3, base3], results)
        st.join(timeout=30)
        assert results["agg"] is not None
        np.testing.assert_array_equal(flatten_params(results[0])["w"], flatten_params(results[1])["w"])


def test_stale_base_outside_resync_window_still_fails(rng):
    base = {"w": np.zeros((4, 2), np.float32)}
    alien = {"w": np.ones((4, 2), np.float32) * 7}
    results = {}
    with _server(num_clients=2, timeout=20, dp_clip=1.0, dp_noise_multiplier=0.0) as server:
        st = _serve_one(server, results, deadline=6)
        clients = [PortClient("127.0.0.1", server.port, client_id=i, timeout=5, dp=True) for i in range(2)]
        bases = [base, alien]
        params = [{k: base[k] + 0.01 for k in base}, {k: alien[k] + 0.01 for k in alien}]
        errs = {}

        def _go(i):
            try:
                clients[i].exchange(params[i], round_base=bases[i], max_retries=1)
            except Exception as e:
                errs[i] = e

        ts = [threading.Thread(target=_go, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        st.join(timeout=30)
    assert results.get("agg") is None
    assert errs


def test_zero_delta_rounds_do_not_poison_resync_history(rng):
    base = {"w": np.ones((4, 2), np.float32)}
    results = {}
    with _server(num_clients=2, timeout=20, dp_clip=1.0, dp_noise_multiplier=0.0) as server:
        clients = [PortClient("127.0.0.1", server.port, client_id=i, timeout=20, dp=True) for i in range(2)]
        for _ in range(2):
            st = _serve_one(server, results)
            _run_clients(clients, [base, base], [base, base], results)
            st.join(timeout=30)
            for i in range(2):
                np.testing.assert_array_equal(flatten_params(results[i])["w"], base["w"])
        assert server._dp_history == []


def test_fleetwide_missed_reply_is_consensus_not_stale(rng):
    base = {"w": np.zeros((4, 2), np.float32)}
    results = {}
    with _server(num_clients=2, timeout=20, dp_clip=1e6, dp_noise_multiplier=0.0) as server:
        clients = [PortClient("127.0.0.1", server.port, client_id=i, timeout=20, dp=True) for i in range(2)]
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base, 0.01), _step(rng, base, 0.02)], [base, base], results)
        st.join(timeout=30)
        assert len(server._dp_history) == 1
        st = _serve_one(server, results)
        params2 = [_step(rng, base, 0.03), _step(rng, base, 0.04)]
        _run_clients(clients, params2, [base, base], results)
        st.join(timeout=30)
    r0, r1 = flatten_params(results[0]), flatten_params(results[1])
    np.testing.assert_array_equal(r0["w"], r1["w"])
    d = 0.5 * sum(np.asarray(flatten_params(p)["w"], np.float32) - base["w"] for p in params2)
    np.testing.assert_allclose(r0["w"], base["w"] + d, atol=1e-5)


def test_stale_client_heals_even_at_default_full_quorum(rng):
    base0 = {"w": np.zeros((4, 2), np.float32)}
    results = {}
    with _server(num_clients=2, timeout=20, dp_clip=1e6, dp_noise_multiplier=0.0) as server:
        clients = [PortClient("127.0.0.1", server.port, client_id=i, timeout=20, dp=True) for i in range(2)]
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base0, 0.01), _step(rng, base0, 0.02)], [base0, base0], results)
        st.join(timeout=30)
        base1 = {k: np.asarray(v, np.float32) for k, v in flatten_params(results[1]).items()}
        round_err, healed, c1_err = {}, {}, {}

        def _round2():
            try:
                server.serve_round(deadline=20)
            except RuntimeError as e:
                round_err["e"] = e

        st2 = threading.Thread(target=_round2)
        st2.start()

        def _c0():
            healed["base"] = clients[0].exchange(_step(rng, base0, 0.01), round_base=base0, max_retries=1)

        def _c1():
            try:
                clients[1].exchange(_step(rng, base1, 0.02), round_base=base1, max_retries=1)
            except ConnectionError as e:
                c1_err["e"] = e

        t0, t1 = threading.Thread(target=_c0), threading.Thread(target=_c1)
        t0.start(), t1.start()
        t0.join(timeout=30), t1.join(timeout=30)
        st2.join(timeout=30)
        assert "e" in round_err and "quorum" in str(round_err["e"])
        assert "e" in c1_err
        for k in base1:
            np.testing.assert_array_equal(flatten_params(healed["base"])[k], base1[k])
        st3 = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base1, 0.01), _step(rng, base1, 0.02)], [base1, base1], results)
        st3.join(timeout=30)
        assert results["agg"] is not None
        np.testing.assert_array_equal(flatten_params(results[0])["w"], flatten_params(results[1])["w"])


def test_stale_client_sitting_out_a_sampled_round_stays_resyncable(rng):
    class _FixedDraws:
        def __init__(self, seq):
            self.seq = list(seq)

        def random(self):
            return self.seq.pop(0)

        def standard_normal(self, shape, dtype=None):
            return np.zeros(shape, dtype or np.float64)

    base0 = {"w": np.zeros((4, 2), np.float32)}
    results = {}
    with _server(
        num_clients=2, min_clients=1, timeout=20, dp_clip=1e6, dp_noise_multiplier=0.0, dp_participation=0.5
    ) as server:
        server._dp_rng = _FixedDraws([0.1, 0.1, 0.9, 0.1, 0.1, 0.1])
        clients = [PortClient("127.0.0.1", server.port, client_id=i, timeout=20, dp=True) for i in range(2)]
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base0, 0.01), _step(rng, base0, 0.02)], [base0, base0], results)
        st.join(timeout=30)
        base1 = {k: np.asarray(v, np.float32) for k, v in flatten_params(results[1]).items()}
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base0, 0.01), _step(rng, base1, 0.02)], [base0, base1], results)
        st.join(timeout=30)
        for k in base0:
            np.testing.assert_array_equal(flatten_params(results[0])[k], base0[k])
        base2 = {k: np.asarray(v, np.float32) for k, v in flatten_params(results[1]).items()}
        assert not np.array_equal(base2["w"], base1["w"])
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base0, 0.01), _step(rng, base2, 0.02)], [base0, base2], results)
        st.join(timeout=30)
        np.testing.assert_array_equal(flatten_params(results[0])["w"], flatten_params(results[1])["w"])


@pytest.mark.parametrize("restart_kind", ["port", "jax"])
def test_dp_resync_history_survives_server_restart(rng, tmp_path, restart_kind):
    """The history file is the JAX package's layout: a port server's
    window reloads in a restarted port server and in a JAX one."""
    hist = str(tmp_path / "dp_history.npz")
    base = {"w": np.zeros((6, 3), np.float32), "b": np.zeros(3, np.float32)}

    def _srv(kind):
        return _server(
            kind, num_clients=2, min_clients=1, timeout=20, dp_clip=1e6, dp_noise_multiplier=0.0,
            dp_history_path=hist,
        )

    results = {}
    with _srv("port") as server:
        clients = [PortClient("127.0.0.1", server.port, client_id=i, timeout=20, dp=True) for i in range(2)]
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base, 0.01), _step(rng, base, 0.02)], [base, base], results)
        st.join(timeout=30)
        base1 = {k: np.asarray(v, np.float32) for k, v in flatten_params(results[0]).items()}
        st = _serve_one(server, results, deadline=4)
        out1 = clients[1].exchange(_step(rng, base1, 0.015), round_base=base1)
        st.join(timeout=30)
        base2 = {k: np.asarray(v, np.float32) for k, v in flatten_params(out1).items()}
        assert not np.array_equal(base2["w"], base1["w"])
    with _srv(restart_kind) as server:
        assert len(server._dp_history) == 2
        clients = [PortClient("127.0.0.1", server.port, client_id=i, timeout=20, dp=True) for i in range(2)]
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base1, 0.01), _step(rng, base2, 0.02)], [base1, base2], results)
        st.join(timeout=30)
        r0, r1 = flatten_params(results[0]), flatten_params(results[1])
        for key in r0:
            np.testing.assert_array_equal(r0[key], r1[key])
        base3 = {k: np.asarray(v, np.float32) for k, v in r0.items()}
        st = _serve_one(server, results)
        _run_clients(clients, [_step(rng, base3, 0.01), _step(rng, base3, 0.02)], [base3, base3], results)
        st.join(timeout=30)
        assert results["agg"] is not None
        np.testing.assert_array_equal(flatten_params(results[0])["w"], flatten_params(results[1])["w"])


def test_dp_history_corrupt_file_starts_empty(rng, tmp_path):
    import io

    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"not an npz at all")
    buf = io.BytesIO()
    np.savez(buf, a=np.zeros(64, np.float32))
    truncated = tmp_path / "truncated.npz"
    truncated.write_bytes(buf.getvalue()[: len(buf.getvalue()) // 2])
    for hist in (garbage, truncated):
        with _server(
            num_clients=2, min_clients=1, timeout=5, dp_clip=1.0, dp_noise_multiplier=0.0,
            dp_history_path=str(hist),
        ) as server:
            assert server._dp_history == []


def _fake_dp_server(frames: dict, *, sampled: bool, auth_key=None):
    """A one-connection server that runs the DP handshake by hand and
    records every frame the client sends; returns (port, thread)."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)

    def _go():
        conn, _ = lst.accept()
        conn.settimeout(10)
        try:
            if auth_key is not None:
                framing.send_frame(conn, wire.NONCE_MAGIC + bytes(range(wire.NONCE_LEN)))
            framing.send_frame(conn, wire.DP_MAGIC + struct.pack("<ddd", 1.0, 0.0, 0.5))
            frames["id"] = bytes(framing.recv_frame(conn))
            framing.send_frame(conn, wire.DPCOHORT_MAGIC + bytes([1 if sampled else 0]))
            frames["next"] = bytes(framing.recv_frame(conn))
        finally:
            conn.close()
            lst.close()

    t = threading.Thread(target=_go, daemon=True)
    t.start()
    return lst.getsockname()[1], t


@pytest.mark.parametrize("sampled,auth_key", [(True, None), (True, b"k"), (False, b"k")])
def test_client_frames_are_byte_equal_to_jax(rng, sampled, auth_key):
    """The id hello, the clipped upload frame (or the authenticated
    sit-out proof) the port's client sends are the JAX client's bytes."""
    base = {"w": np.zeros((5, 3), np.float32), "b": np.zeros(3, np.float32)}
    params = _step(rng, base, 3.0)
    got = {}
    for kind in ("jax", "port"):
        frames: dict = {}
        port, t = _fake_dp_server(frames, sampled=sampled, auth_key=auth_key)
        try:
            _client(kind, port, 1, timeout=5, dp=True, auth_key=auth_key).exchange(
                params, round_base=base, max_retries=1
            )
        except (ConnectionError, OSError, wire.WireError, jwire.WireError):
            pass  # the fake server hangs up after the frame it wanted
        t.join(timeout=15)
        got[kind] = frames
    assert got["port"] == got["jax"]
    assert got["port"]["id"] == wire.DPID_MAGIC + struct.pack("<q", 1)
    if sampled:
        up, meta = wire.decode(got["port"]["next"], auth_key=auth_key)
        assert meta["dp"] and meta["dp_base_crc"] == wire.flat_crc32(base)
        want = jwire.clip_flat({k: params[k] - base[k] for k in base}, 1.0)[0]
        for k in base:
            np.testing.assert_array_equal(flatten_params(up)[k], want[k])
    else:
        assert got["port"]["next"].startswith(wire.DPSKIP_MAGIC)


def test_wire_dp_constants_and_clip_equal_jax(rng):
    for name in ("DP_MAGIC", "DPID_MAGIC", "DPCOHORT_MAGIC", "DPSKIP_MAGIC", "DPSKIP_DOMAIN"):
        assert getattr(wire, name) == getattr(jwire, name), name
    flat = {"a": rng.normal(size=(7, 3)).astype(np.float32) * 5, "b": rng.normal(size=11).astype(np.float32)}
    assert wire.flat_l2_norm(flat) == jwire.flat_l2_norm(flat)
    for clip in (0.5, 1e6):
        got, want = wire.clip_flat(flat, clip), jwire.clip_flat(flat, clip)
        assert got[1:] == want[1:]
        for k in flat:
            np.testing.assert_array_equal(got[0][k], want[0][k])


@pytest.mark.parametrize("auth", [False, True])
@pytest.mark.parametrize("server_kind,client_kinds", [
    ("port", ("port", "port")), ("jax", ("port", "port")), ("port", ("jax", "jax")), ("jax", ("jax", "jax")),
])
def test_secure_dp_composition(rng, auth, server_kind, client_kinds):
    """--secure-agg + central DP: masked clipped-delta uploads, noise on
    the recovered sum; the noiseless mean matches the plain-DP math to
    the fixed-point tolerance, and every package mix lands on the same
    bits."""
    auth_key = b"dp-secure" if auth else None
    base = {"w": rng.normal(size=(6, 3)).astype(np.float32)}
    deltas = [{"w": rng.normal(size=(6, 3)).astype(np.float32) * 0.05} for _ in range(2)]
    params = [{"w": base["w"] + d["w"]} for d in deltas]
    results = {}
    with _server(server_kind, num_clients=2, timeout=20, secure_agg=True, dp_clip=10.0,
                 dp_noise_multiplier=0.0, auth_key=auth_key) as server:
        st = _serve_one(server, results)
        clients = [
            _client(kind, server.port, i, timeout=20, dp=True, secure_agg=True, num_clients=2, auth_key=auth_key)
            for i, kind in enumerate(client_kinds)
        ]
        _run_clients(clients, params, [base, base], results)
        st.join(timeout=30)
    want = base["w"] + 0.5 * (deltas[0]["w"] + deltas[1]["w"])
    got = flatten_params(results[0])["w"]
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got, flatten_params(results[1])["w"])
    _SECURE_DP_BITS.setdefault(auth, got)
    np.testing.assert_array_equal(got, _SECURE_DP_BITS[auth])


#: The first mix's result per auth mode: every other mix must equal it.
_SECURE_DP_BITS: dict = {}


def test_secure_dp_banner_states_honest_clipping():
    """The secure+DP serve banner says the guarantee is honest-client-only
    (masked uploads cannot be re-clipped server-side), word for word the
    JAX banner."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        main as jax_main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        main,
    )

    argv = [
        "serve", "--port", "0", "--num-clients", "2", "--secure-agg", "--dp-clip", "0.5",
        "--dp-noise-multiplier", "1.0", "--rounds", "1", "--timeout", "0.3",
    ]
    rc, banner = _capture_logs(lambda: main(argv + ["--device", "cpu"]), "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch")
    assert rc == 0 and banner
    assert "HONEST-CLIENT-ONLY" in banner[0]
    assert "cannot be re-clipped server-side" in banner[0]
    jrc, jbanner = _capture_logs(lambda: jax_main(argv), "fedtpu")
    assert jrc == 0 and jbanner == banner
