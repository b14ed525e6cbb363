"""The port's health plane held against the JAX package's.

* SLO burn rates and ``AlertManager`` event streams under injected
  clocks (the cases of ``tests/test_health.py`` and the four
  ``test_alert_cmd_*`` of ``tests/test_profile.py``): the port's events,
  states, alert lines and flight bundles equal JAX's.
* The scrape hub over a live fleet whose daemons are a JAX
  ``MetricsServer`` and a port one (plus a dead target): the port hub's
  snapshots, snapshot file and screen equal the JAX hub's, clocks and
  scrape lags aside; the hub's event tail and ``parse_target`` likewise.
* ``obs health|watch`` on the port's command line answer as the JAX
  verb does (exit codes 0 and 1, ``fedtpu-health-v1``, the screen).
* The families the new port modules register are the JAX twins: name,
  kind, labels, help and buckets.
"""

import ast
import importlib
import json
import os
import re
import socket
import subprocess
from types import SimpleNamespace

import pytest

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ns(pkg: str) -> SimpleNamespace:
    obs = importlib.import_module(f"{pkg}.obs")
    return SimpleNamespace(
        obs=obs, slo=importlib.import_module(f"{pkg}.obs.slo"), fleet=importlib.import_module(f"{pkg}.obs.fleet"),
        cli_obs=importlib.import_module(f"{pkg}.cli.obs"), main=importlib.import_module(f"{pkg}.cli").main,
        build_parser=importlib.import_module(f"{pkg}.cli").build_parser,
        drift=importlib.import_module(f"{pkg}.control.drift"),
    )


JAX, PORT = _ns(JAX_PKG), _ns(PORT_PKG)


def _both(fn, tmp_path):
    out = []
    for name, ns in (("jax", JAX), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        out.append(fn(ns, d))
    return tuple(out)


def _latency_families(good: int, bad: int) -> dict:
    total = good + bad
    return {"fedtpu_server_round_seconds": {"type": "histogram", "help": "", "samples": [{
        "labels": {}, "buckets": [["0.1", 0], ["0.5", good], ["5", total], ["+Inf", total]], "sum": 1.0,
        "count": total,
    }]}}


def _ratio_families(bad: int, total: int) -> dict:
    return {
        "fedtpu_server_stream_fallbacks_total": {"type": "counter", "help": "", "samples": [{"labels": {}, "value": bad}]},
        "fedtpu_server_uploads_total": {"type": "counter", "help": "", "samples": [{"labels": {}, "value": total}]},
    }


def _slo(ns, **kw):
    base = dict(name="round-duration", metric="fedtpu_server_round_seconds", kind="latency", le=0.5, objective=0.9,
                windows=((120.0, 6.0), (30.0, 6.0)))
    return ns.slo.SLO(**{**base, **kw})


def _err(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no error")


# ------------------------------------------------- burn-rate state machine
def s_fires_and_clears(ns, d):
    sink = d / "alerts.jsonl"
    am = ns.slo.AlertManager((_slo(ns),), sink_path=str(sink))
    out = []
    for good, bad, now in ((5, 0, 0.0), (5, 4, 10.0), (5, 5, 20.0), (20, 5, 60.0)):
        am.ingest(_latency_families(good=good, bad=bad), now=now)
        out.append(am.evaluate(now=now))
    assert [[e["event"] for e in ev] for ev in out] == [[], ["fire"], [], ["clear"]]
    assert out[1][0]["severity"] == "page" and all(v >= 6.0 for v in out[1][0]["burn"].values())
    assert am.fired_total == 1 and am.cleared_total == 1
    lines = [json.loads(ln) for ln in sink.read_text().splitlines()]
    assert [r["event"] for r in lines] == ["fire", "clear"] and all(r["schema"] == "fedtpu-alert-v1" for r in lines)
    return out, lines, am.states()


def s_needs_every_window(ns, d):
    am = ns.slo.AlertManager((_slo(ns),))
    for good, bad, now in ((0, 0, 0.0), (0, 4, 10.0), (50, 4, 90.0)):
        am.ingest(_latency_families(good=good, bad=bad), now=now)
    ev = am.evaluate(now=90.0)
    assert ev == [] and am.states()[0]["firing"] is False
    return am.states()


def s_ratio_and_no_traffic(ns, d):
    slo = ns.slo.SLO(name="stream-fallback-ratio", metric="fedtpu_server_stream_fallbacks_total", kind="ratio",
                     total="fedtpu_server_uploads_total", objective=0.9, windows=((120.0, 2.0), (30.0, 2.0)),
                     severity="ticket")
    am = ns.slo.AlertManager((slo,))
    out = []
    for bad, total, now in ((0, 10, 0.0), (8, 20, 10.0), (8, 20, 60.0)):
        am.ingest(_ratio_families(bad=bad, total=total), now=now)
        out.append(am.evaluate(now=now))
    assert [[e["event"] for e in ev] for ev in out] == [[], ["fire"], ["clear"]]
    assert out[1][0]["severity"] == "ticket"
    return out


def s_counter_reset(ns, d):
    am = ns.slo.AlertManager((_slo(ns),))
    out = []
    for good, bad, now in ((50, 5, 0.0), (1, 0, 10.0), (5, 0, 20.0)):
        am.ingest(_latency_families(good=good, bad=bad), now=now)
        out.append(am.evaluate(now=now))
    assert out[1:] == [[], []] and am.states()[0]["firing"] is False
    return out, am.states()


def s_page_fire_trips_recorder(ns, d):
    rec = ns.obs.FlightRecorder(str(d / "flight"), proc="hub", min_interval_s=0.0)
    am = ns.slo.AlertManager((_slo(ns),), recorder=rec)
    am.ingest(_latency_families(good=0, bad=0), now=0.0)
    am.ingest(_latency_families(good=0, bad=4), now=10.0)
    ev = am.evaluate(now=10.0)
    bundles = ns.obs.list_bundles(str(d / "flight"))
    assert len(bundles) == 1 and bundles[0]["reason"] == "slo-page"
    b = ns.obs.load_bundle(bundles[0]["path"])
    assert any(a["event"] == "fire" for a in b["alerts"])
    return ev, b["alerts"], b["extra"], b["reason"]


def s_slo_validation_and_spec(ns, d):
    slo = _slo(ns)
    errs = [
        _err(ns.slo.SLO, name="x", metric="m", kind="latency"),
        _err(ns.slo.SLO, name="x", metric="m", kind="ratio"),
        _err(ns.slo.SLO, name="x", metric="m", le=1.0, objective=1.0),
        _err(ns.slo.SLO, name="x", metric="m", le=1.0, windows=()),
        _err(ns.slo.SLO, name="x", metric="m", le=1.0, windows=((0.0, 1.0),)),
        _err(ns.slo.SLO, name="x", metric="m", le=1.0, severity="sms"),
        _err(ns.slo.SLO, name="x", metric="m", kind="p99", le=1.0),
        _err(ns.slo.AlertManager, (slo, slo)),
        _err(ns.slo.slos_from_spec, [{"name": "a", "metric": "m", "le": 1.0, "typo": 1}]),
    ]
    spec = [{"name": "a", "metric": "fedtpu_server_round_seconds", "le": 1.0, "windows": [[60.0, 2.0], [10.0, 2.0]],
             "labels": [["tier", "serve"]]}]
    (got,) = ns.slo.slos_from_spec(spec)
    assert got.windows == ((60.0, 2.0), (10.0, 2.0)) and got.shortest_window == (10.0, 2.0)
    assert ns.slo.extract_bad_total(got, {}) is None
    assert ns.slo.extract_bad_total(slo, _latency_families(3, 2)) == (2.0, 5.0)
    return errs, repr(got), [repr(s) for s in ns.slo.default_slos()], got.budget


def _fire_once(am, t0=0.0):
    am.ingest(_latency_families(good=5, bad=0), now=t0)
    am.evaluate(now=t0)
    am.ingest(_latency_families(good=5, bad=4), now=t0 + 10.0)
    return am.evaluate(now=t0 + 10.0)


def s_alert_cmd_runs_on_page_fire(ns, d):
    import time

    out = d / "paged.jsonl"
    am = ns.slo.AlertManager((_slo(ns),), alert_cmd=f"cat >> {out}", alert_cmd_interval_s=0.0)
    events = _fire_once(am)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not (out.exists() and out.read_text().strip()):
        time.sleep(0.02)
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["event"] == "fire" and rec["slo"] == "round-duration" and am.notified_total == 1
    return events, rec


def s_alert_cmd_rate_limited(ns, d):
    slo2 = _slo(ns, name="round-duration-strict", objective=0.95)
    am = ns.slo.AlertManager((_slo(ns), slo2), alert_cmd="true", alert_cmd_interval_s=300.0)
    events = _fire_once(am)
    assert [e["event"] for e in events] == ["fire", "fire"]
    assert (am.fired_total, am.notified_total, am.notify_suppressed_total) == (2, 1, 1)
    return events


def s_alert_cmd_oserror(ns, d):
    real = subprocess.Popen

    def boom(*a, **kw):
        raise OSError("no shell for you")

    subprocess.Popen = boom
    try:
        am = ns.slo.AlertManager((_slo(ns),), alert_cmd="whatever", alert_cmd_interval_s=0.0)
        events = _fire_once(am)
    finally:
        subprocess.Popen = real
    assert [e["event"] for e in events] == ["fire"] and am.notified_total == 0
    return events


def s_alert_cmd_ignores_non_page(ns, d):
    am = ns.slo.AlertManager((_slo(ns, name="t", severity="ticket"),), alert_cmd="false", alert_cmd_interval_s=0.0)
    events = _fire_once(am)
    assert [e["event"] for e in events] == ["fire"]
    assert am.notified_total == 0 and am.notify_suppressed_total == 0
    return events


SLO_CASES = {name[2:]: fn for name, fn in sorted(globals().items()) if name.startswith("s_")}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_case_equals_jax(case, tmp_path):
    want, got = _both(SLO_CASES[case], tmp_path)
    assert got == want


# --------------------------------------------------------------- live fleet
@pytest.fixture(scope="module")
def live_fleet():
    """A JAX daemon (the FL server's families) and a port daemon (the
    router's), each on a private registry of its own package, plus a port
    nothing listens on."""
    jreg = JAX.obs.MetricsRegistry()
    jreg.counter("fedtpu_server_rounds_total").inc(3)
    jreg.counter("fedtpu_server_uploads_total").inc(6)
    jreg.histogram("fedtpu_server_round_seconds", buckets=(0.1, 0.5, 5.0)).observe(0.2)
    preg = PORT.obs.MetricsRegistry()
    preg.counter("fedtpu_router_forwarded_total").inc(100)
    preg.counter("fedtpu_router_ejects_total", labels={"replica": "0"}).inc(1)
    preg.gauge("fedtpu_router_inflight", labels={"replica": "0"}).set(2)
    preg.gauge("fedtpu_router_inflight", labels={"replica": "1"}).set(1)
    preg.counter("fedtpu_controller_promotions_total").inc(2)
    srv_j = JAX.obs.MetricsServer(0, host="127.0.0.1", registry=jreg).start()
    srv_p = PORT.obs.MetricsServer(0, host="127.0.0.1", registry=preg).start()
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead = probe.getsockname()[1]
    probe.close()
    yield {"jax_reg": jreg, "port_reg": preg, "jax": srv_j, "port": srv_p, "dead": dead}
    srv_j.close()
    srv_p.close()


def _clean_snapshot(snap: dict) -> dict:
    snap = json.loads(json.dumps(snap))
    snap.pop("ts", None)
    snap.pop("scrape_lag_ms", None)
    for t in snap["targets"]:
        t.pop("scrape_lag_ms")
        t["error"] = bool(t["error"])
    return snap


def _clean_screen(text: str) -> str:
    text = re.sub(r"\d\d:\d\d:\d\d", "T", text)
    text = re.sub(r"\s+\d+ms\s", " Xms ", text)
    return re.sub(r"(ok|DOWN) {1,}(-|Xms)", r"\1", text)


def _targets(ns, fleet, *, dead=True, events=None):
    out = [
        ns.fleet.Target("serve", "127.0.0.1", fleet["jax"].port, events_jsonl=events),
        ns.fleet.Target("route", "127.0.0.1", fleet["port"].port),
    ]
    if dead:
        out.append(ns.fleet.Target("relay", "127.0.0.1", fleet["dead"]))
    return out


def test_hub_over_a_mixed_fleet_renders_what_the_jax_hub_renders(live_fleet, tmp_path):
    """Both hubs poll the JAX and the port daemon (and a dead one) in turn,
    with the same injected clocks: the snapshots, the snapshot files and
    the screens agree; the counters moved between polls show as cadence."""
    hubs = {
        name: ns.fleet.ScrapeHub(_targets(ns, live_fleet), slos=(_slo(ns),),
                                 snapshot_jsonl=str(tmp_path / f"{name}.jsonl"), scrape_timeout_s=1.0)
        for name, ns in (("jax", JAX), ("port", PORT))
    }
    snaps = {name: [] for name in hubs}
    for now in (0.0, 60.0):
        if now:
            live_fleet["jax_reg"].counter("fedtpu_server_rounds_total").inc(3)
            live_fleet["port_reg"].counter("fedtpu_router_forwarded_total").inc(30)
        for name, hub in hubs.items():
            snaps[name].append(hub.poll(now=now))
    for a, b in zip(snaps["port"], snaps["jax"]):
        assert _clean_snapshot(a) == _clean_snapshot(b)
    rows = {(t["tier"]): t for t in snaps["port"][1]["targets"]}
    assert rows["serve"]["up"] and rows["route"]["up"] and not rows["relay"]["up"]
    assert rows["serve"]["cadence"]["fedtpu_server_rounds_total"] == pytest.approx(0.05)
    assert rows["route"]["summary"]["gauges"]["fedtpu_router_inflight"] == {"replica=0": 2.0, "replica=1": 1.0}
    screens = {name: _clean_screen(hub.render_status(snaps[name][1])) for name, hub in hubs.items()}
    assert screens["port"] == screens["jax"]
    assert "DOWN" in screens["port"] and "rounds/min" in screens["port"] and "promoted 2" in screens["port"]
    files = {name: [_clean_snapshot(json.loads(ln)) for ln in open(tmp_path / f"{name}.jsonl")] for name in hubs}
    assert files["port"] == files["jax"] and len(files["port"]) == 2
    assert PORT.fleet.health_verdict(snaps["port"][1])["healthy"] is False
    assert _clean_screen(hubs["port"].render_status(None)) == _clean_screen(hubs["jax"].render_status(None))


def test_hub_slo_fire_over_live_scrapes_equals_jax(live_fleet, tmp_path):
    """Burn alerts fire from scraped deltas, one ``slo-eval`` span a poll,
    the alert events riding the snapshot: the same in both hubs."""
    hubs = {
        name: ns.fleet.ScrapeHub(
            _targets(ns, live_fleet, dead=False), slos=(_slo(ns),), alerts_jsonl=str(tmp_path / f"{name}-alerts.jsonl"),
            tracer=ns.obs.Tracer(str(tmp_path / f"{name}-hub.jsonl"), proc="obs-hub"),
        )
        for name, ns in (("jax", JAX), ("port", PORT))
    }
    snaps = {name: [hub.poll(now=0.0)] for name, hub in hubs.items()}
    h = live_fleet["jax_reg"].histogram("fedtpu_server_round_seconds", buckets=(0.1, 0.5, 5.0))
    for _ in range(4):
        h.observe(2.0)
    for name, hub in hubs.items():
        snaps[name].append(hub.poll(now=10.0))
    assert [_clean_snapshot(s) for s in snaps["port"]] == [_clean_snapshot(s) for s in snaps["jax"]]
    assert [e["event"] for e in snaps["port"][1]["events"]] == ["fire"]
    spans = {}
    for name, ns in (("jax", JAX), ("port", PORT)):
        evals = [s for s in ns.obs.load_spans([str(tmp_path / f"{name}-hub.jsonl")]) if s["span"] == "slo-eval"]
        spans[name] = [{k: s[k] for k in ("targets", "up", "firing")} for s in evals]
    assert spans["port"] == spans["jax"] == [{"targets": 2, "up": 2, "firing": 0}, {"targets": 2, "up": 2, "firing": 1}]
    alerts = {n: open(tmp_path / f"{n}-alerts.jsonl").read() for n in hubs}
    assert alerts["port"] == alerts["jax"]


def test_hub_tails_events_jsonl_equals_jax(live_fleet, tmp_path):
    events = tmp_path / "ctl.jsonl"
    t = JAX.obs.Tracer(str(events), proc="controller")
    t.record("drift-trigger", t_start=1.0, dur_s=0.0, round=4, drift=0.31, method="psi",
             top_bins=[{"bin": 9, "psi": 0.25}])
    t.record("postmortem-dump", t_start=2.0, dur_s=0.01, reason="round-failure", bundle="b.json", spans=12)
    t.record("round", t_start=3.0, dur_s=1.2, trace="aa", round=4, failed=True)

    def run(ns, d):
        hub = ns.fleet.ScrapeHub(_targets(ns, live_fleet, dead=False, events=str(events)), slos=(_slo(ns),))
        snap = hub.poll(now=0.0)
        row = snap["targets"][0]
        assert row["last_drift"]["drift"] == 0.31 and row["postmortems"] == 1 and row["last_round_failed"] is True
        screen = hub.render_status(snap)
        assert "drift psi=0.31" in screen and "LAST ROUND FAILED" in screen
        return _clean_snapshot(snap), _clean_screen(screen), _clean_screen(hub.render_status(None))

    want, got = _both(run, tmp_path)
    assert got == want


@pytest.mark.parametrize(
    "spec", ["serve=127.0.0.1:9100", "route=10.0.0.2:9102,events=/var/log/r.jsonl", "controller=[::1]:9",
             "serve", "serve=127.0.0.1", "serve=h:x", "s=h:1,foo=bar", "s=h:1,events="],
)
def test_parse_target_equals_jax(spec):
    def parse(ns):
        try:
            t = ns.fleet.parse_target(spec)
        except ValueError as e:
            return str(e)
        return (t.tier, t.host, t.port, t.events_jsonl, t.instance, t.key, t.url)

    assert parse(PORT) == parse(JAX)


def test_hub_refusals_equal_jax():
    for ns_pair in ((JAX, PORT),):
        got = []
        for ns in ns_pair:
            tgt = ns.fleet.Target("serve", "127.0.0.1", 1)
            got.append([_err(ns.fleet.ScrapeHub, []), _err(ns.fleet.ScrapeHub, [tgt, tgt])])
        assert got[1] == got[0]


def test_summarize_families_equals_jax(live_fleet):
    import urllib.request

    for srv in (live_fleet["jax"], live_fleet["port"]):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics.json", timeout=5) as r:
            fams = json.loads(r.read())["families"]
        assert PORT.fleet.summarize_families(fams) == JAX.fleet.summarize_families(fams)


# ------------------------------------------------------------------ the CLI
def _health(ns, argv, capsys):
    capsys.readouterr()
    rc = ns.main(argv)
    return rc, capsys.readouterr().out


def test_obs_health_cli_equals_jax(live_fleet, capsys, tmp_path):
    ok = ["obs", "health", "--interval", "0.05", "--target", f"serve=127.0.0.1:{live_fleet['jax'].port}",
          "--target", f"route=127.0.0.1:{live_fleet['port'].port}"]
    down = ["obs", "health", "--interval", "0.05", "--target", f"serve=127.0.0.1:{live_fleet['jax'].port}",
            "--target", f"relay=127.0.0.1:{live_fleet['dead']}"]
    js = ["obs", "health", "--json", "--interval", "0.05", "--target", f"serve=127.0.0.1:{live_fleet['port'].port}"]
    out = {}
    for name, ns in (("jax", JAX), ("port", PORT)):
        rc_ok, screen = _health(ns, ok, capsys)
        rc_down, _ = _health(ns, down, capsys)
        rc_js, doc = _health(ns, js, capsys)
        doc = json.loads(doc)
        doc.pop("ts")
        doc.pop("scrape_lag_ms")
        out[name] = (rc_ok, _clean_screen(screen), rc_down, rc_js, doc)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0 and out["port"][2] == 1 and out["port"][3] == 0
    assert out["port"][4]["schema"] == "fedtpu-health-v1" and out["port"][4]["healthy"] is True
    assert "2/2 targets up" in out["port"][1]
    # --flight-dir arms the hub's own recorder.
    args = PORT.build_parser().parse_args([*js, "--flight-dir", str(tmp_path / "hub-flight")])
    hub = PORT.cli_obs.build_hub(args)
    assert hub.alerts._recorder is not None and hub.alerts._recorder.proc == "obs-hub"
    for argv in (["obs", "health"], ["obs", "health", "--target", "not-a-target"]):
        msgs = []
        for ns in (JAX, PORT):
            with pytest.raises(SystemExit) as e:
                ns.main(argv)
            msgs.append(str(e.value).replace("fedtpu obs", "obs"))
        assert msgs[1] == msgs[0]


def test_obs_health_slo_file_alerts_and_alert_cmd(live_fleet, capsys, tmp_path):
    """An --slo objective that the traffic between the two polls breaches:
    exit 1, one fire on --alerts-jsonl, one --alert-cmd run, and the
    ``fedtpu-alert-v1`` line the JAX verb writes."""
    import threading
    import time

    slo = [{"name": "round-duration", "metric": "fedtpu_server_round_seconds", "le": 0.5, "objective": 0.9,
            "windows": [[120.0, 2.0], [30.0, 2.0]]}]
    (tmp_path / "slo.json").write_text(json.dumps(slo))
    out = {}
    for name, ns in (("jax", JAX), ("port", PORT)):
        alerts, paged = tmp_path / f"{name}-alerts.jsonl", tmp_path / f"{name}-paged.jsonl"
        h = live_fleet["jax_reg"].histogram("fedtpu_server_round_seconds", buckets=(0.1, 0.5, 5.0))
        threading.Timer(0.2, lambda h=h: [h.observe(2.0) for _ in range(4)]).start()
        rc, text = _health(ns, [
            "obs", "health", "--interval", "0.6", "--slo", str(tmp_path / "slo.json"),
            "--target", f"serve=127.0.0.1:{live_fleet['jax'].port}", "--alerts-jsonl", str(alerts),
            "--alert-cmd", f"cat >> {paged}", "--alert-interval", "0",
        ], capsys)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not (paged.exists() and paged.read_text().strip()):
            time.sleep(0.02)
        lines = [json.loads(ln) for ln in alerts.read_text().splitlines()]
        pages = [json.loads(ln) for ln in paged.read_text().splitlines()]
        assert pages == lines
        out[name] = (rc, [(e["event"], e["slo"], e["severity"], e["bad"]) for e in lines], "FIRING" in text)
    assert out["port"] == out["jax"] == (1, [("fire", "round-duration", "page", {"120s": 4.0, "30s": 4.0})], True)


def test_obs_watch_cli_refreshes(live_fleet, capsys):
    rc, out = _health(PORT, ["obs", "watch", "--target", f"serve=127.0.0.1:{live_fleet['port'].port}",
                             "--interval", "0.05", "--max-seconds", "0.2"], capsys)
    assert rc == 0 and out.count("fedtpu fleet health") >= 2


# ---------------------------------------------------------------- obs flags
#: (flag, value, dest) of every JAX flag of obs health|watch|sentinel.
FLEET_FLAGS = [
    ("--target", "serve=h:1", "target"), ("--slo", "slo.json", "slo"), ("--alerts-jsonl", "a.jsonl", "alerts_jsonl"),
    ("--snapshot-jsonl", "s.jsonl", "snapshot_jsonl"), ("--snapshot-max-mb", "1.5", "snapshot_max_mb"),
    ("--watch", None, "watch"), ("--interval", "0.5", "interval"), ("--scrape-timeout", "3", "scrape_timeout"),
    ("--trace-jsonl", "t.jsonl", "trace_jsonl"), ("--flight-dir", "fl", "flight_dir"),
    ("--alert-cmd", "true", "alert_cmd"), ("--alert-interval", "0", "alert_interval"),
    ("--canaries", "c.jsonl", "canaries"), ("--canary-preset", "unswnb15", "canary_preset"),
    ("--serve", "h:1", "serve"), ("--registry-dir", "r", "registry_dir"), ("--scored-jsonl", "s.jsonl", "scored_jsonl"),
    ("--labels-journal", "j.jsonl", "labels_journal"), ("--reference-error", "0.05", "reference_error"),
    ("--error-margin", "0.1", "error_margin"), ("--error-min-joined", "32", "error_min_joined"),
    ("--verdicts-jsonl", "v.jsonl", "verdicts_jsonl"), ("--ring-jsonl", "ring.jsonl", "ring_jsonl"),
    ("--ring-records", "64", "ring_records"), ("--ring-stride", "2", "ring_stride"), ("--baseline-n", "4", "baseline_n"),
    ("--window-n", "4", "window_n"), ("--regression-ratio", "2.0", "regression_ratio"),
    ("--trend-field", "x:down", "trend_field"), ("--max-seconds", "1", "max_seconds"), ("--json", None, "json"),
]


@pytest.mark.parametrize("action", ["health", "watch", "sentinel"])
@pytest.mark.parametrize("flag,value,dest", FLEET_FLAGS, ids=[f[0] for f in FLEET_FLAGS])
def test_fleet_flag_parses_to_the_jax_value(action, flag, value, dest):
    given = [flag] if value is None else [flag, value]
    for argv in (["obs", action, *given], ["obs", action]):
        port = getattr(PORT.build_parser().parse_args(argv), dest)
        want = getattr(JAX.build_parser().parse_args(argv), dest)
        assert port == want and type(port) is type(want), (argv, port, want)


# ------------------------------------------------------------- metric twins
NEW_TWIN_MODULES = ("control/controller.py", "obs/fleet.py", "obs/sentinel.py")


def _families(path: str) -> dict:
    """name -> (kind, help, labels, buckets) of every literal ``fedtpu_*``
    family the module registers."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("counter", "gauge", "histogram") and node.args
                and isinstance(node.args[0], ast.Constant) and str(node.args[0].value).startswith("fedtpu_")):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
            out[node.args[0].value] = (node.func.attr, kw.get("help"), kw.get("labels"), kw.get("buckets"))
    return out


TWINS = [(m, n) for m in NEW_TWIN_MODULES for n in sorted(_families(os.path.join(REPO_ROOT, PORT_PKG, m)))]


def test_new_twin_modules_register_the_jax_sets():
    for m in NEW_TWIN_MODULES:
        assert set(_families(os.path.join(REPO_ROOT, PORT_PKG, m))) == set(_families(os.path.join(REPO_ROOT, JAX_PKG, m)))
    assert len(TWINS) == 6 + 4 + 9


@pytest.mark.parametrize("module,name", TWINS, ids=[n for _, n in TWINS])
def test_new_family_equals_its_jax_twin(module, name):
    port = _families(os.path.join(REPO_ROOT, PORT_PKG, module))[name]
    assert port == _families(os.path.join(REPO_ROOT, JAX_PKG, module))[name]
    with open(os.path.join(REPO_ROOT, PORT_PKG, module)) as f:
        text = f.read()
    assert text.count(f"the JAX package's {module} family") == len(_families(os.path.join(REPO_ROOT, PORT_PKG, module)))
