"""The port's obs layer held against the JAX package's (one port test per
test of ``tests/test_obs.py``, plus the twin guards):

* the metrics registry renders the same text and JSON after the same
  operations; ``/metrics`` answers 404 off its two paths;
* every metric family the port registers has a JAX twin with the same
  name, kind, label names and help string; ``SPAN_NAMES`` is equal;
* a MIXED traced round over loopback TCP, both ways round (the port's
  server with JAX clients, the JAX server with the port's clients): the
  span ids propagate across the wire, the timeline attributes each
  client's wall within 10%, and both packages' ``timeline_table`` and
  ``chrome_trace`` are byte-equal on the same span files;
* ``tail`` and its filters, and the flight bundle's layout (each
  package reads the other's bundles).

All host-side (sockets, JSONL, stdlib HTTP, a fold on the CPU).
"""

import ast
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    obs as jobs,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm.client import (
    FederatedClient as JaxClient,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm.server import (
    AggregationServer as JaxServer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    obs as pobs,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.client import (
    FederatedClient as PortClient,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.server import (
    AggregationServer as PortServer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.obs.trace import (
    SCHEMA,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"
N_CLIENTS = 2
LOCAL_SLEEP_S = 0.12  # simulated local training; dominates the round wall
#: The port server counters a round moves, read before and after it.
COUNTERS = (
    "fedtpu_server_rounds_total", "fedtpu_server_uploads_total",
    "fedtpu_server_wire_bytes_received_total", "fedtpu_server_wire_bytes_sent_total",
)


def _value(reg, name: str, labels: dict | None = None) -> float:
    fam = reg.snapshot()["families"].get(name)
    if fam is None:
        return 0.0
    return sum(s["value"] for s in fam["samples"] if labels is None or s["labels"] == labels)


def _run_round(trace_dir, *, server_cls, server_tracer, server_kw, client_cls, client_tracer):
    """One traced loopback round: a real server and N real clients, each
    writing its own span JSONL (the layout ``obs`` merges)."""
    server = server_cls(
        port=0, num_clients=N_CLIENTS, timeout=30,
        tracer=server_tracer(str(trace_dir / "server.jsonl"), proc="server"), **server_kw,
    )
    result: dict = {"clients": {}}

    def run_server():
        result["agg"] = server.serve_round()

    def run_client(cid: int):
        fc = client_cls(
            "127.0.0.1", server.port, client_id=cid, timeout=30,
            tracer=client_tracer(str(trace_dir / f"client{cid}.jsonl"), proc=f"client-{cid}"),
        )
        t0 = time.time()
        time.sleep(LOCAL_SLEEP_S)  # stand-in for the local training phase
        fc.note_local_phase(t0, time.time() - t0, client=cid)
        fc.exchange({"w": np.full(64, cid + 1.0, np.float32)}, n_samples=10)
        result["clients"][cid] = fc

    st = threading.Thread(target=run_server)
    cts = [threading.Thread(target=run_client, args=(c,)) for c in range(N_CLIENTS)]
    st.start()
    for t in cts:
        t.start()
    for t in cts:
        t.join(timeout=60)
    st.join(timeout=60)
    server.close()
    result["server"] = server
    return result


@pytest.fixture(scope="module", params=["port-server", "jax-server"])
def mixed_round(request, tmp_path_factory):
    """A round whose server comes from one package and whose clients come
    from the other."""
    trace_dir = tmp_path_factory.mktemp(f"obs-{request.param}")
    before = {n: _value(pobs.default_registry(), n) for n in COUNTERS}
    if request.param == "port-server":
        res = _run_round(
            trace_dir, server_cls=PortServer, server_tracer=pobs.Tracer, server_kw={"device": "cpu"},
            client_cls=JaxClient, client_tracer=jobs.Tracer,
        )
    else:
        res = _run_round(
            trace_dir, server_cls=JaxServer, server_tracer=jobs.Tracer, server_kw={},
            client_cls=PortClient, client_tracer=pobs.Tracer,
        )
    after = {n: _value(pobs.default_registry(), n) for n in COUNTERS}
    return {
        "kind": request.param, "dir": str(trace_dir),
        "spans": pobs.load_spans(trace_dir=str(trace_dir)),
        "moved": {n: after[n] - before[n] for n in COUNTERS}, **res,
    }


# ------------------------------------------------------- span propagation
def test_span_ids_propagate_across_the_wire(mixed_round):
    """Server and every client agree on the round's (trace, round)
    identity: the id crossed the wire in the reply meta, between the two
    packages."""
    spans = mixed_round["spans"]
    traced = [s for s in spans if s.get("trace")]
    trace_ids = {s["trace"] for s in traced}
    assert len(trace_ids) == 1
    (tid,) = trace_ids
    for fc in mixed_round["clients"].values():
        assert fc.last_trace == (tid, 0)
    procs = {s["proc"] for s in traced}
    assert procs == {"server", *(f"client-{c}" for c in range(N_CLIENTS))}
    by_proc = {p: {s["span"] for s in traced if s["proc"] == p} for p in procs}
    assert {"round", "agg", "wire-reply"} <= by_proc["server"]
    for c in range(N_CLIENTS):
        assert by_proc[f"client-{c}"] == {"client-local", "wire-upload", "wire-reply"}
    assert {s.get("round") for s in traced} == {0}
    assert all(s["schema"] == SCHEMA for s in spans)
    assert all(s.get("run_id") for s in spans)
    # The JAX loader reads the same files to the same records.
    assert jobs.load_spans(trace_dir=mixed_round["dir"]) == spans


@pytest.mark.parametrize("server_cls,client_cls", [(PortServer, JaxClient), (JaxServer, PortClient)])
def test_untraced_client_still_interoperates(server_cls, client_cls):
    """An untraced client learns the round identity all the same."""
    kw = {"device": "cpu"} if server_cls is PortServer else {}
    server = server_cls(port=0, num_clients=1, timeout=30, **kw)
    out = {}
    st = threading.Thread(target=lambda: out.update(agg=server.serve_round()))
    st.start()
    fc = client_cls("127.0.0.1", server.port, client_id=0, timeout=30)
    agg = fc.exchange({"w": np.ones(8, np.float32)})
    st.join(timeout=60)
    server.close()
    np.testing.assert_allclose(agg["w"], np.ones(8))
    trace_id, rnd = fc.last_trace
    assert isinstance(trace_id, str) and len(trace_id) == 16
    assert rnd == 0


# ------------------------------------------------------------- timeline
def test_timeline_attributes_round_wall(mixed_round):
    """compute + upload + wait + agg + reply reconstructs each client's
    measured round wall within 10%, the simulated local phase in compute."""
    summaries = pobs.round_summaries(mixed_round["spans"])
    assert len(summaries) == 1
    b = summaries[0]
    assert b["round"] == 0 and len(b["clients"]) == N_CLIENTS
    assert b["contributors"] == list(range(N_CLIENTS))
    for proc, row in b["clients"].items():
        err = abs(row["attributed_s"] - row["measured_s"]) / row["measured_s"]
        assert err < 0.10, (proc, row)
        assert row["compute_s"] == pytest.approx(LOCAL_SLEEP_S, rel=0.5)
    table = pobs.timeline_table(mixed_round["spans"])
    assert "compute" in table and "wait" in table and "slowest span" in table


def test_timeline_and_chrome_trace_byte_equal_to_jax(mixed_round, tmp_path):
    """Both packages' merge tools give the same bytes on the same files."""
    spans = pobs.load_spans(trace_dir=mixed_round["dir"])
    jspans = jobs.load_spans(trace_dir=mixed_round["dir"])
    assert pobs.timeline_table(spans) == jobs.timeline_table(jspans)
    assert pobs.timeline_table(spans, round_filter=0) == jobs.timeline_table(jspans, round_filter=0)
    assert json.dumps(pobs.round_summaries(spans)) == json.dumps(jobs.round_summaries(jspans))
    p = pobs.export_chrome_trace(spans, str(tmp_path / "port.json"))
    j = jobs.export_chrome_trace(jspans, str(tmp_path / "jax.json"))
    with open(p, "rb") as fp, open(j, "rb") as fj:
        assert fp.read() == fj.read()


def test_server_phase_seconds_accounting(mixed_round):
    phases = mixed_round["server"].phase_seconds
    assert set(phases) == {"wait", "agg", "reply"}
    assert phases["wait"] >= LOCAL_SLEEP_S
    assert phases["agg"] > 0 and phases["reply"] > 0
    assert phases["wait"] > phases["agg"]


# ---------------------------------------------------------- chrome export
def test_chrome_trace_export_roundtrips(mixed_round, tmp_path):
    path = pobs.export_chrome_trace(mixed_round["spans"], str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == len(mixed_round["spans"])
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
    names = {e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M" and e["name"] == "process_name"}
    assert names == {"server", *(f"client-{c}" for c in range(N_CLIENTS))}


def test_client_phase_spans_monotonic_non_overlapping(mixed_round):
    spans = mixed_round["spans"]
    for c in range(N_CLIENTS):
        mine = sorted((s for s in spans if s.get("proc") == f"client-{c}"), key=lambda s: s["ts"])
        assert [s["span"] for s in mine] == ["client-local", "wire-upload", "wire-reply"]
        for prev, nxt in zip(mine, mine[1:]):
            assert nxt["ts"] >= prev["ts"] + prev["dur_s"] - 2e-3


# ------------------------------------------------------------- /metrics
def _demo(reg) -> None:
    reg.counter("demo_rounds_total", help="rounds").inc(3)
    reg.gauge("demo_queue_depth").set(7)
    h = reg.histogram("demo_wait_seconds", buckets=(0.01, 0.1, 1.0))
    h.observe(0.05)
    h.observe(2.0)
    reg.counter("demo_rejects_total", labels={"kind": "deadline"}).inc()
    reg.gauge("demo_fraction", help="a float gauge").set(0.125)


def test_registry_rendering_equals_jax():
    """The same operations on both registries render the same text and
    the same JSON."""
    preg, jreg = pobs.MetricsRegistry(), jobs.MetricsRegistry()
    _demo(preg)
    _demo(jreg)
    assert preg.render() == jreg.render()
    assert preg.render_json() == jreg.render_json()
    assert preg.snapshot() == jreg.snapshot()


def test_prometheus_endpoint_scrapes_and_parses():
    reg = pobs.MetricsRegistry()
    _demo(reg)
    with pobs.MetricsServer(0, host="127.0.0.1", registry=reg) as srv:
        body = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read().decode()
    assert "# TYPE demo_rounds_total counter" in body
    assert "demo_rounds_total 3" in body and "demo_queue_depth 7" in body
    assert 'demo_rejects_total{kind="deadline"} 1' in body
    assert 'demo_wait_seconds_bucket{le="+Inf"} 2' in body and "demo_wait_seconds_count 2" in body
    for line in body.strip().splitlines():
        if not line.startswith("#"):
            name_part, value = line.rsplit(" ", 1)
            float(value)
            assert name_part.startswith("demo_")


def test_metrics_json_twin_endpoint_matches_text_rendering():
    reg = pobs.MetricsRegistry()
    _demo(reg)
    with pobs.MetricsServer(0, host="127.0.0.1", registry=reg) as srv:
        raw = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics.json", timeout=10)
        assert raw.headers["Content-Type"] == "application/json"
        doc = json.loads(raw.read())
    assert doc == json.loads(jobs.MetricsRegistry().render_json()) | {"families": doc["families"]}
    fams = doc["families"]
    (hs,) = fams["demo_wait_seconds"]["samples"]
    assert hs["buckets"] == [["0.01", 0], ["0.1", 1], ["1", 1], ["+Inf", 2]]
    assert hs["count"] == 2 and hs["sum"] == pytest.approx(2.05)
    (rej,) = fams["demo_rejects_total"]["samples"]
    assert rej["labels"] == {"kind": "deadline"} and rej["value"] == 1


def test_new_health_span_names_registered():
    """``SPAN_NAMES`` equals the JAX tuple (the static checker reads the
    JAX file), and the timeline renders unscoped health-plane spans."""
    assert pobs.SPAN_NAMES == jobs.SPAN_NAMES
    t_spans = [
        {"schema": SCHEMA, "proc": "obs-hub", "span": "slo-eval", "ts": 1.0, "dur_s": 0.002, "firing": 1, "up": 1},
        {"schema": SCHEMA, "proc": "server", "span": "postmortem-dump", "ts": 2.0, "dur_s": 0.01,
         "reason": "round-failure", "bundle": "b.json"},
        {"schema": SCHEMA, "proc": "controller", "span": "drift-trigger", "ts": 3.0, "dur_s": 0.0, "round": 1, "drift": 0.31},
        {"schema": SCHEMA, "proc": "server", "span": "round", "ts": 0.5, "dur_s": 1.0, "trace": "aa", "round": 1},
    ]
    table = pobs.timeline_table(t_spans)
    assert table == jobs.timeline_table(t_spans)
    assert "unscoped health-plane spans" in table and "reason=round-failure" in table


def test_http_404_off_path():
    with pobs.MetricsServer(0, host="127.0.0.1", registry=pobs.MetricsRegistry()) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=10)
        assert e.value.code == 404


def test_round_engine_feeds_default_registry(mixed_round):
    """The port server's counters land on the process registry (what
    ``serve --metrics-port`` exposes), and its byte counters equal the
    bytes the clients put on and took off the wire."""
    if mixed_round["kind"] != "port-server":
        # The port's clients register the JAX client's family.
        assert _value(pobs.default_registry(), "fedtpu_client_rehomes_total", {"reason": "dial-exhausted"}) == 0.0
        assert "fedtpu_client_rehomes_total" in pobs.default_registry().snapshot()["families"]
        return
    moved = mixed_round["moved"]
    clients = mixed_round["clients"].values()
    assert moved["fedtpu_server_rounds_total"] == 1
    assert moved["fedtpu_server_uploads_total"] == N_CLIENTS
    assert moved["fedtpu_server_wire_bytes_received_total"] == sum(fc.last_upload_bytes for fc in clients)
    with pobs.MetricsServer(0, host="127.0.0.1") as srv:
        body = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read().decode()
    for needle in (
        "fedtpu_server_rounds_total", "fedtpu_server_uploads_total",
        "fedtpu_server_wire_bytes_received_total", 'fedtpu_server_round_phase_seconds_total{phase="agg"}',
        'fedtpu_strategy_rounds_total{strategy="fedavg"}', "fedtpu_server_round_seconds_count",
    ):
        assert needle in body


def test_port_round_byte_counters_equal_the_wire():
    """The port's server counts the bytes the port's client records as
    sent and received."""
    server = PortServer(port=0, num_clients=1, timeout=30, device="cpu")
    before = {n: _value(pobs.default_registry(), n) for n in COUNTERS}
    st = threading.Thread(target=server.serve_round)
    st.start()
    fc = PortClient("127.0.0.1", server.port, client_id=0, timeout=30)
    fc.exchange({"w": np.ones(1000, np.float32)})
    st.join(timeout=60)
    server.close()
    ex = fc.last_exchange
    assert _value(pobs.default_registry(), COUNTERS[2]) - before[COUNTERS[2]] == ex["upload_bytes"]
    assert _value(pobs.default_registry(), COUNTERS[3]) - before[COUNTERS[3]] == ex["reply_bytes"]


# ------------------------------------------------- scoring-protocol trace
def test_scoring_protocol_trace_echo():
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
        protocol,
    )

    req = protocol.parse_request(protocol.build_request(7, text="flow", trace="abcd1234abcd1234"))
    assert req["trace"] == "abcd1234abcd1234"
    rep = protocol.parse_reply(protocol.build_reply(
        7, prob=0.25, threshold=0.5, round_id=3, batch_size=4, bucket=8, queue_ms=1.5, trace=req["trace"],
    ))
    assert rep["trace"] == "abcd1234abcd1234"
    assert "trace" not in protocol.parse_request(protocol.build_request(8, text="flow"))


# ------------------------------------------------------------------ CLI
def test_obs_cli_timeline_and_export(mixed_round, tmp_path, capsys):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli.parser import (
        main as jax_main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        main,
    )

    outs = {}
    for name, m in (("port", main), ("jax", jax_main)):
        capsys.readouterr()
        assert m(["obs", "timeline", "--trace-dir", mixed_round["dir"]]) == 0
        table = capsys.readouterr().out
        assert m(["obs", "timeline", "--trace-dir", mixed_round["dir"], "--json"]) == 0
        outs[name] = (table, capsys.readouterr().out)
        assert m(["obs", "export", "--trace-dir", mixed_round["dir"], "--out", str(tmp_path / f"{name}.json")]) == 0
    assert outs["port"] == outs["jax"]
    assert "round 0" in outs["port"][0] and json.loads(outs["port"][1])[0]["round"] == 0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_obs_cli_refuses_empty_inputs(tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        main,
    )

    with pytest.raises(SystemExit):
        main(["obs", "timeline", "--trace-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        main(["obs", "timeline"])


# ------------------------------------------------------------ grouping
def test_group_rounds_and_foreign_lines(tmp_path):
    p = tmp_path / "mixed.jsonl"
    t = pobs.Tracer(str(p), proc="x")
    t.record("round", t_start=1.0, dur_s=0.5, trace="aa", round=1)
    jobs.Tracer(str(p), proc="y").record("round", t_start=2.0, dur_s=0.5, trace="bb", round=2)
    with open(p, "a") as f:
        f.write(json.dumps({"phase": "serve_batch", "score_hist": [1]}) + "\n")
        f.write('{"truncated": \n')
    spans = pobs.load_spans([str(p)])
    assert len(spans) == 2 and spans == jobs.load_spans([str(p)])
    assert set(pobs.group_rounds(spans)) == {("aa", 1), ("bb", 2)}
    assert pobs.chrome_trace(spans) == jobs.chrome_trace(spans)


def test_wire_overlap_span_and_timeline_row(tmp_path):
    """A streamed round of the port's server writes a wire-overlap span
    (folds that ran during the wire phase); the port's clients' streamed
    wire-upload spans carry chunks and overlap; prefetch spans adopt the
    next round's identity."""
    trace_dir = tmp_path / "stream-spans"
    trace_dir.mkdir()
    server = PortServer(
        port=0, num_clients=2, timeout=30, stream_chunk_bytes=8192, device="cpu",
        tracer=pobs.Tracer(str(trace_dir / "server.jsonl"), proc="server"),
    )

    def run_server():
        server.serve_round()
        server.serve_round()

    def run_client(cid):
        fc = PortClient(
            "127.0.0.1", server.port, client_id=cid, timeout=30,
            tracer=pobs.Tracer(str(trace_dir / f"client{cid}.jsonl"), proc=f"client-{cid}"),
        )
        agg = fc.exchange({"w": np.full(40_000, cid + 1.0, np.float32)}, n_samples=1)
        fc.note_phase("batch-prefetch", time.time(), 0.01, client=cid)
        fc.exchange({k: v + 1.0 for k, v in agg.items()}, n_samples=1)

    st = threading.Thread(target=run_server)
    cts = [threading.Thread(target=run_client, args=(c,)) for c in range(2)]
    st.start()
    for t in cts:
        t.start()
    for t in cts:
        t.join(timeout=60)
    st.join(timeout=60)
    server.close()
    assert {u["shape"] for u in server.last_uploads.values()} == {"stream"}
    spans = pobs.load_spans(trace_dir=str(trace_dir))
    overlaps = [s for s in spans if s["span"] == "wire-overlap"]
    assert len(overlaps) == 1
    ov = overlaps[0]
    assert ov["round"] == 1 and ov["proc"] == "server"
    assert ov["folded_bytes"] > 0 and 0.0 < ov["overlap_frac"] <= 1.0 and ov["peak_agg_bytes"] > 0
    ups = [s for s in spans if s["span"] == "wire-upload" and s.get("round") == 1]
    assert len(ups) == 2 and all(u["chunks"] > 1 and u["overlap_s"] >= 0.0 for u in ups)
    pf = [s for s in spans if s["span"] == "batch-prefetch"]
    assert len(pf) == 2 and all(s.get("round") == 1 for s in pf)
    by_round = {b["round"]: b for b in pobs.round_summaries(spans)}
    assert by_round[1]["overlap_s"] > 0.0 and by_round[0]["overlap_s"] == 0.0
    table = pobs.timeline_table(spans)
    assert table == jobs.timeline_table(spans)
    assert "folded during the wire phase" in table and "batch-prefetch" in table


# --------------------------------------------------------- live tailing
def test_tail_spans_follows_appends_and_new_files(tmp_path):
    d = tmp_path / "tail"
    d.mkdir()
    pre = pobs.Tracer(str(d / "pre.jsonl"), proc="early")
    pre.record("round", t_start=1.0, dur_s=0.5, trace="aa", round=1)
    got: list[dict] = []
    stop_at = [2]

    def collect(**kw):
        for rec in pobs.tail_spans(trace_dir=str(d), poll_s=0.05, stop=lambda: len(got) >= stop_at[0], **kw):
            got.append(rec)

    t = threading.Thread(target=collect, daemon=True)
    t.start()
    time.sleep(0.2)
    pre.record("agg", t_start=2.0, dur_s=0.1, trace="aa", round=1)
    late = jobs.Tracer(str(d / "late.jsonl"), proc="late")  # appears mid-tail, JAX-written
    late.record("router-forward", t_start=3.0, dur_s=0.01, replica=0)
    with open(d / "pre.jsonl", "a") as f:
        f.write('{"not": "a span"}\n')
    t.join(timeout=10)
    assert not t.is_alive()
    assert {r["span"] for r in got} == {"agg", "router-forward"}
    got.clear()
    stop_at[0] = 3
    t = threading.Thread(target=collect, kwargs={"from_start": True}, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert {r["span"] for r in got} == {"round", "agg", "router-forward"}
    assert [r["span"] for r in got if r["proc"] == "early"] == ["round", "agg"]
    # The incremental line reader both packages' pollers share.
    off, lines = pobs.timeline.read_new_jsonl_lines(str(d / "pre.jsonl"), 0)
    assert (off, lines) == jobs.timeline.read_new_jsonl_lines(str(d / "pre.jsonl"), 0)


def test_obs_cli_tail_filters_and_format(tmp_path, capsys):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli.parser import (
        main as jax_main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        main,
    )

    d = tmp_path / "tailcli"
    d.mkdir()
    t = pobs.Tracer(str(d / "s.jsonl"), proc="server")
    t.record("round", t_start=1.0, dur_s=0.5, trace="aa", round=1)
    t.record("agg", t_start=2.0, dur_s=0.25, trace="aa", round=1)
    t.record("replica-drain", t_start=3.0, dur_s=0.1, round=2, replica=1)
    base = ["obs", "tail", "--trace-dir", str(d), "--from-start", "--max-seconds", "0.3", "--poll", "0.05"]
    for extra, n in (([], 3), (["--round", "2"], 1), (["--trace-id", "aa"], 2)):
        capsys.readouterr()
        assert main(base + extra) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
        assert jax_main(base + extra) == 0
        assert lines == [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
        assert len(lines) == n
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main(["obs", "tail", "--trace-dir", str(empty), "--max-seconds", "0.2", "--poll", "0.05"]) == 0
    assert capsys.readouterr().out.strip() == ""


# ------------------------------------------------------- flight recorder
def test_flight_bundle_layout_matches_jax(tmp_path):
    """The same ring and trigger give bundles of the same layout; each
    package lists and loads the other's."""
    bundles = {}
    for name, mod in (("port", pobs), ("jax", jobs)):
        d = tmp_path / name
        tracer = mod.Tracer(str(d / "spans.jsonl"), proc="server")
        rec = mod.FlightRecorder(str(d), proc="server", min_interval_s=60.0, config={"proc": "server"}, tracer=tracer)
        rec.note_span({"schema": SCHEMA, "span": "round", "ts": 1.0, "dur_s": 0.5})
        rec.note_alert({"event": "fire", "slo": "s"})
        rec.note_metrics({"families": {}}, now=5.0)
        path = rec.maybe_dump("round-failure", extra={"round": 3})
        assert rec.maybe_dump("round-failure") is None  # rate-limited
        assert os.path.basename(path) == "postmortem-server-0001-round-failure.json"
        bundles[name] = (d, json.loads(open(path).read()))
    (pd, pb), (jd, jb) = bundles["port"], bundles["jax"]
    strip = ("ts", "metrics_now")
    assert {k: v for k, v in pb.items() if k not in strip} == {k: v for k, v in jb.items() if k not in strip}
    assert set(pb) == set(jb)
    for d in (pd, jd):
        listed_p, listed_j = pobs.list_bundles(str(d)), jobs.list_bundles(str(d))
        assert [dict(r, path=None) for r in listed_p] == [dict(r, path=None) for r in listed_j]
        assert pobs.load_bundle(listed_p[0]["path"]) == jobs.load_bundle(listed_j[0]["path"])
    # The dump wrote its postmortem-dump span.
    assert [s["span"] for s in pobs.load_spans([str(pd / "spans.jsonl")])] == ["postmortem-dump"]


# ------------------------------------------------------- metric twins
def _registrations(path: str) -> dict[str, tuple]:
    """name -> (kind, help, label names) of every literal ``fedtpu_*``
    family a module registers."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = {}
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("counter", "gauge", "histogram") and node.args
            and isinstance(node.args[0], ast.Constant) and str(node.args[0].value).startswith("fedtpu_")
        ):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        help_text = kw["help"].value if "help" in kw else ""
        labels = tuple(sorted(k.value for k in kw["labels"].keys)) if "labels" in kw else ()
        out[node.args[0].value] = (node.func.attr, help_text, labels)
    return out


def test_metric_twins_match_jax_families():
    """Every family the port registers has a JAX twin of the same name,
    kind, label names and help string (the drift ``obs-metric-once``
    exists to stop, held here since each twin carries its pragma)."""
    jax_fams: dict[str, tuple] = {}
    for dirpath, _, files in os.walk(os.path.join(REPO_ROOT, JAX_PKG)):
        for f in files:
            if f.endswith(".py"):
                jax_fams.update(_registrations(os.path.join(dirpath, f)))
    port_fams: dict[str, tuple] = {}
    for dirpath, _, files in os.walk(os.path.join(REPO_ROOT, PORT_PKG)):
        for f in files:
            if f.endswith(".py"):
                port_fams.update(_registrations(os.path.join(dirpath, f)))
    assert len(port_fams) >= 25
    for name, fam in sorted(port_fams.items()):
        assert jax_fams.get(name) == fam, name
    # The step families are registered through a name table: equal too,
    # rendered on registries of each package.
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.obs import (
        profile as jprofile,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.obs import (
        profile as pprofile,
    )

    assert pprofile._STEP_FAMILIES == jprofile._STEP_FAMILIES
    preg, jreg = pobs.MetricsRegistry(), jobs.MetricsRegistry()
    for site in pprofile._STEP_FAMILIES:
        pprofile.StepProfiler(1, site=site, registry=preg)
        jprofile.StepProfiler(1, site=site, registry=jreg)
    assert preg.render() == jreg.render()


def test_registry_promote_spans_match_jax(tmp_path):
    """A registry given a tracer writes one ``promote`` span per
    promotion, pointer swap and rollback, with the JAX registry's keys
    and values."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.registry import (
        ModelRegistry as JaxRegistry,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry import (
        ModelRegistry as PortRegistry,
    )

    got = {}
    for name, reg_cls, mod in (("port", PortRegistry, pobs), ("jax", JaxRegistry, jobs)):
        path = tmp_path / f"{name}.jsonl"
        reg = reg_cls(str(tmp_path / name), tracer=mod.Tracer(str(path), proc="registry"))
        a = reg.add({"w": np.ones(3, np.float32)}, round_index=1)
        b = reg.add({"w": np.zeros(3, np.float32)}, round_index=2)
        reg.promote(a, to="serving")
        reg.promote(b, to="shadow")
        reg.promote(b)
        reg.rollback()
        got[name] = [{k: v for k, v in s.items() if k not in ("ts", "dur_s", "run_id")}
                     for s in pobs.load_spans([str(path)])]
    assert got["port"] == got["jax"]
    assert [(s["state"], s["round"]) for s in got["port"]] == [("serving", 1), ("shadow", 2), ("serving", 2), ("rollback", 1)]
