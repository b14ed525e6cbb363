"""The port's sentinel plane held against the JAX package's: every case of
``tests/test_sentinel.py`` (the canary fixture and prober, the journal
tail, the retention ring, snapshot rotation, the health verdict, the
controller's ``SentinelLink``, the composed sentinel, custom trend
fields) run by both packages on the same inputs and clocks. Each case
keeps the JAX test's own asserts, and what the two packages return —
verdicts, incidents, ring rows, reports, journaled lines — is equal.
Then ``JournalTail`` over a journal the JAX ``LabelStore`` wrote, and
``obs sentinel`` end to end through the port's scorer on the CPU.
"""

import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "canary_flows.jsonl")


def _ns(pkg: str) -> SimpleNamespace:
    s = importlib.import_module(f"{pkg}.obs.sentinel")
    f = importlib.import_module(f"{pkg}.obs.fleet")
    d = importlib.import_module(f"{pkg}.control.drift")
    return SimpleNamespace(
        s=s, fleet=f, ErrorRateMonitor=d.ErrorRateMonitor, SentinelLink=d.SentinelLink,
        ModelRegistry=importlib.import_module(f"{pkg}.registry").ModelRegistry,
        SPAN_NAMES=importlib.import_module(f"{pkg}.obs.trace").SPAN_NAMES,
    )


JAX, PORT = _ns(JAX_PKG), _ns(PORT_PKG)


def _raises(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def _registry_with_promotion(ns, root, *, round_index=1, seed=0):
    reg = ns.ModelRegistry(str(root))
    rng = np.random.default_rng(seed)
    aid = reg.add({"w": rng.normal(size=(4,)).astype(np.float32)}, round_index=round_index)
    reg.promote(aid, to="serving")
    return reg, aid


def _fake_probe(prob_by_id, round_id, *, latency_s=0.002):
    def fn(host, port, texts, **kw):
        return [
            ({"id": i + 1, "prob": prob_by_id[i], "prediction": int(prob_by_id[i] >= 0.5), "round": round_id},
             latency_s)
            for i in range(len(texts))
        ]

    return fn


def _write_lines(path, recs):
    with open(path, "a") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _flows(ns, preset=None):
    return [(f.id, f.preset, f.label, f.text, f.class_label) for f in ns.s.load_canary_flows(FIXTURE, preset=preset)]


# ------------------------------------------------------------------- fixture
def c_fixture_loads_and_validates(ns, d):
    flows = ns.s.load_canary_flows(FIXTURE)
    assert len(flows) >= 10 and len({f.id for f in flows}) == len(flows)
    presets = {f.preset for f in flows}
    assert presets == {"cicids2017", "cicddos2019", "unswnb15", "cicddos2019-mc"}
    for p in presets:
        labels = {f.label for f in flows if f.preset == p}
        assert 0 in labels and any(v > 0 for v in labels), p
    return _flows(ns)


def c_fixture_mc_preset_is_k_class(ns, d):
    flows = ns.s.load_canary_flows(FIXTURE, preset="cicddos2019-mc")
    assert {f.class_label for f in flows} >= {"BENIGN", "Syn"} and max(f.label for f in flows) > 1
    assert all(f.class_label == "BENIGN" for f in flows if f.label == 0)
    return _flows(ns, "cicddos2019-mc")


def c_fixture_texts_match_templates(ns, d):
    for f in ns.s.load_canary_flows(FIXTURE):
        assert f.text.startswith("Protocol is " if f.preset == "unswnb15" else "Destination port is ")
        assert f.text.endswith(".")
    return True


def c_fixture_preset_filter_unknown_fails(ns, d):
    msg = _raises(ns.s.load_canary_flows, FIXTURE, preset="nope")
    assert "no canaries for preset" in msg
    return msg


def c_fixture_foreign_and_torn_lines_fail(ns, d):
    p = d / "c.jsonl"
    p.write_text('{"schema": "other-v1", "id": "x"}\n')
    m1 = _raises(ns.s.load_canary_flows, str(p))
    p.write_text('{"schema": "' + ns.s.CANARY_SCHEMA + '", "id":\n')
    m2 = _raises(ns.s.load_canary_flows, str(p))
    assert ns.s.CANARY_SCHEMA in m1 and "not JSON" in m2
    return m1.replace(str(d), ""), m2.replace(str(d), "")


def c_fixture_duplicate_id_and_bad_label(ns, d):
    rec = {"schema": ns.s.CANARY_SCHEMA, "id": "a", "preset": "p", "label": 1, "text": "t"}
    p = d / "c.jsonl"
    p.write_text(json.dumps(rec) + "\n" + json.dumps(rec) + "\n")
    m1 = _raises(ns.s.load_canary_flows, str(p))
    p.write_text(json.dumps(dict(rec, label=-1)) + "\n")
    m2 = _raises(ns.s.load_canary_flows, str(p))
    assert "duplicate" in m1 and "label" in m2
    return m1.replace(str(d), ""), m2.replace(str(d), "")


def c_fixture_missing_field(ns, d):
    p = d / "c.jsonl"
    p.write_text(json.dumps({"schema": ns.s.CANARY_SCHEMA, "id": "a", "preset": "p", "label": 0}) + "\n")
    msg = _raises(ns.s.load_canary_flows, str(p))
    assert "text" in msg
    return msg.replace(str(d), "")


# -------------------------------------------------------------------- prober
def c_prober_clean_pass(ns, d):
    reg, _ = _registry_with_promotion(ns, d / "reg")
    flows = ns.s.load_canary_flows(FIXTURE, preset="cicids2017")
    prober = ns.s.CanaryProber(flows, "127.0.0.1", 1, registry=reg,
                               probe_fn=_fake_probe([0.1, 0.2, 0.9, 0.8], round_id=1))
    out = []
    for _ in range(3):
        r = prober.probe(now=1000.0)
        assert r["incidents"] == [] and r["mismatches"] == 0 and r["flips"] == 0
        assert r["probes"] == len(flows) and r["latency_p99_ms"] == 2.0
        out.append(r)
    assert r["wrong_label"] == 0
    return out


def c_prober_flip_without_promotion(ns, d):
    reg, _ = _registry_with_promotion(ns, d / "reg")
    flows = ns.s.load_canary_flows(FIXTURE, preset="unswnb15")
    probs = [0.1, 0.9]
    prober = ns.s.CanaryProber(flows, "127.0.0.1", 1, registry=reg, probe_fn=_fake_probe(probs, round_id=1))
    r0 = prober.probe(now=0.0)
    probs[0] = 0.1000001
    r = prober.probe(now=1.0)
    assert r0["flips"] == 0 and r["flips"] == 1
    assert r["incidents"][0]["kind"] == "score-flip" and r["incidents"][0]["canary"] == flows[0].id
    return r0, r


def c_prober_promotion_rekeys(ns, d):
    reg, _ = _registry_with_promotion(ns, d / "reg", round_index=1)
    flows = ns.s.load_canary_flows(FIXTURE, preset="unswnb15")
    prober = ns.s.CanaryProber(flows, "127.0.0.1", 1, registry=reg, probe_fn=_fake_probe([0.1, 0.9], round_id=1))
    r0 = prober.probe(now=0.0)
    rng = np.random.default_rng(7)
    aid2 = reg.add({"w": rng.normal(size=(4,)).astype(np.float32)}, round_index=2)
    reg.promote(aid2, to="serving")
    prober._probe_fn = _fake_probe([0.4, 0.6], round_id=2)
    r = prober.probe(now=1.0)
    assert r0["incidents"] == [] and r["flips"] == 0 and r["mismatches"] == 0 and r["incidents"] == []
    return r0, r


def c_prober_stale_pointer(ns, d):
    reg, _ = _registry_with_promotion(ns, d / "reg", round_index=1)
    flows = ns.s.load_canary_flows(FIXTURE, preset="unswnb15")
    prober = ns.s.CanaryProber(flows, "127.0.0.1", 1, registry=reg, probe_fn=_fake_probe([0.1, 0.9], round_id=1))
    r0 = prober.probe(now=0.0)
    rng = np.random.default_rng(8)
    aid2 = reg.add({"w": rng.normal(size=(4,)).astype(np.float32)}, round_index=2)
    reg.promote(aid2, to="serving")
    r = prober.probe(now=1.0)
    assert r0["mismatches"] == 0 and r["mismatches"] == len(flows)
    assert all(i["kind"] == "pointer-mismatch" and i["reply_round"] == 1 and i["expected_round"] == 2
               for i in r["incidents"])
    return r0, r


def c_prober_down_tier(ns, d):
    flows = ns.s.load_canary_flows(FIXTURE, preset="unswnb15")

    def boom(*a, **k):
        raise ConnectionRefusedError("down")

    r = ns.s.CanaryProber(flows, "127.0.0.1", 1, probe_fn=boom).probe(now=0.0)
    assert r["failures"] == len(flows) and r["incidents"][0]["kind"] == "probe-failure"
    return r


def c_prober_rejected_reply(ns, d):
    flows = ns.s.load_canary_flows(FIXTURE, preset="unswnb15")

    def fn(host, port, texts, **kw):
        return [({"rejected": True, "code": 2, "reason": "deadline", "prob": float("nan"), "prediction": 0,
                  "round": None}, 0.001) for _ in texts]

    prober = ns.s.CanaryProber(flows, "127.0.0.1", 1, probe_fn=fn)
    for _ in range(2):
        r = prober.probe(now=0.0)
    assert r["flips"] == 0 and r["failures"] == len(flows)
    return r


def c_span_names_registered(ns, d):
    assert {"canary-probe", "sentinel-eval", "regression-fire"} <= set(ns.SPAN_NAMES)
    return sorted(ns.SPAN_NAMES)


# -------------------------------------------------------------- journal tail
def _tail(ns, d, **kw):
    scored, journal = str(d / "scored.jsonl"), str(d / "journal.jsonl")
    open(scored, "w").close()
    open(journal, "w").close()
    monitor = ns.ErrorRateMonitor(reference_error=0.05, margin=0.1, min_joined=8)
    return ns.s.JournalTail(scored, journal, monitor=monitor, **kw), scored, journal


def c_tail_joins_both_orders(ns, d):
    tail, scored, journal = _tail(ns, d)
    _write_lines(scored, [{"schema": "fedtpu-scored-v1", "rid": "a", "prob": 0.9}])
    _write_lines(journal, [{"schema": "fedtpu-label-v1", "rid": "a", "label": 1, "ts": 1.0},
                           {"schema": "fedtpu-label-v1", "rid": "b", "label": 0, "ts": 2.0}])
    st1 = tail.poll(now=10.0)
    _write_lines(scored, [{"schema": "fedtpu-scored-v1", "rid": "b", "prob": 0.2}])
    st2 = tail.poll(now=11.0)
    assert st1["joined"] == 1 and st1["unmatched_labels"] == 1
    assert st2["joined"] == 2 and st2["unmatched_labels"] == 0 and st2["window_error"] == 0.0
    return st1, st2


def c_tail_watermark_monotone(ns, d):
    tail, _, journal = _tail(ns, d)
    _write_lines(journal, [{"schema": "fedtpu-label-v1", "watermark": 5.0},
                           {"schema": "fedtpu-label-v1", "watermark": 3.0}])
    st = tail.poll(now=0.0)
    assert st["watermark"] == 5.0
    return st


def _all_wrong(scored, journal, n=10):
    _write_lines(scored, [{"schema": "fedtpu-scored-v1", "rid": f"r{i}", "prob": 0.9} for i in range(n)])
    _write_lines(journal, [{"schema": "fedtpu-label-v1", "rid": f"r{i}", "label": 0, "ts": float(i)}
                           for i in range(n)])


def c_tail_drift_fires_and_journals(ns, d):
    verdicts = str(d / "verdicts.jsonl")
    tail, scored, journal = _tail(ns, d, verdicts_jsonl=verdicts)
    _all_wrong(scored, journal)
    st = tail.poll(now=100.0)
    assert st["verdict"]["schema"] == ns.s.VERDICT_SCHEMA and st["verdict"]["method"] == "error_rate"
    assert st["fires"] == 1
    lines = [json.loads(ln) for ln in open(verdicts).read().splitlines()]
    assert len(lines) == 1 and lines[0]["error"] == 1.0
    st2 = tail.poll(now=101.0)
    assert st2["verdict"] is None
    return st, st2, lines


def c_tail_clean_never_fires(ns, d):
    tail, scored, journal = _tail(ns, d)
    _write_lines(scored, [{"schema": "fedtpu-scored-v1", "rid": f"r{i}", "prob": 0.9} for i in range(20)])
    _write_lines(journal, [{"schema": "fedtpu-label-v1", "rid": f"r{i}", "label": 1, "ts": float(i)}
                           for i in range(20)])
    st = tail.poll(now=0.0)
    assert st["verdict"] is None and st["joined"] == 20
    return st


# ------------------------------------------------------------ retention ring
def c_ring_stride_and_bound(ns, d):
    ring = ns.s.RetentionRing(str(d / "ring.jsonl"), max_records=8, stride=3, baseline_n=2, window_n=2)
    for i in range(60):
        ring.note({"latency_p99_ms": float(i)}, now=float(i))
    recs = ring.records
    assert len(recs) == 8 and all(r["schema"] == ns.s.RING_SCHEMA for r in recs)
    assert all(r["ts"] % 3 == 0 for r in recs)
    return recs, open(d / "ring.jsonl").read()


def c_ring_disk_compaction(ns, d):
    path = str(d / "ring.jsonl")
    ring = ns.s.RetentionRing(path, max_records=4, stride=1, baseline_n=2, window_n=2)
    for i in range(40):
        ring.note({"latency_p99_ms": 1.0}, now=float(i))
    text = open(path).read()
    assert len(text.splitlines()) <= 8 and not [p for p in os.listdir(d) if ".tmp." in p]
    return text


def c_ring_restart_resumes_baseline(ns, d):
    path = str(d / "ring.jsonl")
    ring = ns.s.RetentionRing(path, max_records=16, baseline_n=3, window_n=2)
    for i in range(5):
        ring.note({"latency_p99_ms": 10.0}, now=float(i))
    ring2 = ns.s.RetentionRing(path, max_records=16, baseline_n=3, window_n=2)
    assert ring.baseline_pinned and ring2.baseline_pinned and len(ring2.records) == 5
    return ring2.records


def c_ring_trend_once_per_excursion(ns, d):
    ring = ns.s.RetentionRing(max_records=64, baseline_n=4, window_n=4)
    out = []
    for lo, hi, v in ((0, 8, 10.0), (8, 12, 100.0), (12, 12, None), (12, 20, 10.0), (20, 24, 100.0)):
        for i in range(lo, hi):
            ring.note({"latency_p99_ms": v}, now=float(i))
        out.append(ring.trend())
    assert [len(x) for x in out] == [0, 1, 0, 0, 1]
    assert out[1][0]["field"] == "latency_p99_ms" and out[1][0]["baseline"] == 10.0 and out[1][0]["now"] == 100.0
    return out


def c_ring_cadence_regresses_down(ns, d):
    ring = ns.s.RetentionRing(max_records=64, baseline_n=3, window_n=3)
    for i in range(9):
        ring.note({"round_cadence": 2.0 if i < 6 else 0.1}, now=float(i))
    fired = ring.trend()
    assert [f["field"] for f in fired] == ["round_cadence"] and fired[0]["direction"] == "down"
    return fired


def c_ring_no_baseline_no_verdict(ns, d):
    ring = ns.s.RetentionRing(max_records=16, baseline_n=8, window_n=4)
    for i in range(5):
        ring.note({"latency_p99_ms": 500.0}, now=float(i))
    assert ring.trend() == []
    return ring.records


def c_ring_always_slow_never_regresses(ns, d):
    ring = ns.s.RetentionRing(max_records=64, baseline_n=4, window_n=4)
    for i in range(40):
        ring.note({"latency_p99_ms": 400.0}, now=float(i))
    assert ring.trend() == []
    return ring.records


def c_ring_bad_config(ns, d):
    m1 = _raises(ns.s.RetentionRing, max_records=2, baseline_n=8, window_n=4)
    m2 = _raises(ns.s.RetentionRing, max_records=16, stride=0)
    assert "max_records" in m1 and "stride" in m2
    return m1, m2


# --------------------------------------------------- hub rotation + verdict
def _dead_target(ns):
    return ns.fleet.Target(tier="serve", host="127.0.0.1", port=1)


def _snap_lines(path):
    """The snapshot records without their clocks and error texts."""
    out = []
    for line in open(path).read().splitlines():
        rec = json.loads(line)
        rec.pop("ts")
        rec.pop("scrape_lag_ms")
        for t in rec["targets"]:
            t.pop("scrape_lag_ms")
            t["error"] = bool(t["error"])
        out.append(rec)
    return out


def c_snapshot_bounded_roll(ns, d):
    path = str(d / "snap.jsonl")
    hub = ns.fleet.ScrapeHub([_dead_target(ns)], snapshot_jsonl=path, snapshot_max_mb=0.001, scrape_timeout_s=0.05)
    for i in range(8):
        hub.poll(now=float(i))
    assert os.path.exists(path + ".1") and os.path.getsize(path) <= 2 * 1024 * 1024
    for p in (path, path + ".1"):
        assert all(json.loads(ln)["schema"] == "fedtpu-fleet-v1" for ln in open(p).read().splitlines())
    return len(_snap_lines(path)), len(_snap_lines(path + ".1"))


def c_snapshot_unbounded_default(ns, d):
    path = str(d / "snap.jsonl")
    hub = ns.fleet.ScrapeHub([_dead_target(ns)], snapshot_jsonl=path, scrape_timeout_s=0.05)
    hub.poll(now=0.0)
    hub.poll(now=1.0)
    assert not os.path.exists(path + ".1")
    return _snap_lines(path)


def c_snapshot_bad_cap(ns, d):
    msg = _raises(ns.fleet.ScrapeHub, [_dead_target(ns)], snapshot_jsonl="x.jsonl", snapshot_max_mb=0.0)
    assert "snapshot_max_mb" in msg
    return msg


def c_verdict_mirrors_snapshot(ns, d):
    hub = ns.fleet.ScrapeHub([_dead_target(ns)], scrape_timeout_s=0.05)
    v = ns.fleet.health_verdict(hub.poll(now=0.0))
    assert v["schema"] == ns.fleet.HEALTH_SCHEMA and v["healthy"] is False
    assert v["targets"] == 1 and v["targets_up"] == 0 and v["targets_down"][0]["tier"] == "serve"
    json.dumps(v)
    v.pop("ts")
    v.pop("scrape_lag_ms")
    v["targets_down"][0]["error"] = bool(v["targets_down"][0]["error"])
    return v


def c_verdict_healthy_shape(ns, d):
    v = ns.fleet.health_verdict({
        "ts": 1.0, "targets": [{"tier": "serve", "instance": "h:1", "up": True, "error": None}],
        "slo": [{"slo": "x", "instance": "h:1", "firing": False, "severity": "page", "burn": {}}],
        "scrape_lag_ms": 1.5,
    })
    assert v["healthy"] is True and v["slo_total"] == 1 and v["notable"] == []
    return v


# -------------------------------------------------------------- sentinel link
def c_link_skips_preexisting(ns, d):
    path = str(d / "verdicts.jsonl")
    old = {"schema": ns.s.VERDICT_SCHEMA, "drift": 0.5, "method": "error_rate", "scores": 64}
    _write_lines(path, [old])
    link = ns.SentinelLink(path)
    out = [link.poll()]
    _write_lines(path, [dict(old, drift=0.7)])
    out += [link.poll(), link.poll()]
    assert out[0] is None and out[1]["drift"] == 0.7 and out[2] is None
    return out


def c_link_missing_file_then_created(ns, d):
    path = str(d / "nope.jsonl")
    link = ns.SentinelLink(path)
    out = [link.poll()]
    _write_lines(path, [{"schema": ns.s.VERDICT_SCHEMA, "drift": 0.1, "method": "error_rate"}])
    out.append(link.poll())
    assert out[0] is None and out[1]["drift"] == 0.1
    return out


def c_link_foreign_and_torn_skipped(ns, d):
    path = str(d / "verdicts.jsonl")
    open(path, "w").close()
    link = ns.SentinelLink(path)
    with open(path, "a") as f:
        f.write('{"schema": "other"}\nnot json\n')
        f.write(json.dumps({"schema": ns.s.VERDICT_SCHEMA, "drift": 0.3, "method": "error_rate"}) + "\n")
        f.write('{"torn')
    got = link.poll()
    assert got["drift"] == 0.3 and link.seen == 1
    return got, link.seen


def c_link_latest_wins(ns, d):
    path = str(d / "verdicts.jsonl")
    open(path, "w").close()
    link = ns.SentinelLink(path)
    _write_lines(path, [{"schema": ns.s.VERDICT_SCHEMA, "drift": x, "method": "error_rate"} for x in (0.1, 0.2, 0.3)])
    got = link.poll()
    assert got["drift"] == 0.3
    return got, link.seen


# ---------------------------------------------------------------- composition
def c_tick_report_and_counters(ns, d):
    flows = ns.s.load_canary_flows(FIXTURE, preset="unswnb15")
    probs = [0.1, 0.9]
    prober = ns.s.CanaryProber(flows, "127.0.0.1", 1, probe_fn=_fake_probe(probs, round_id=None))
    ring = ns.s.RetentionRing(max_records=16, baseline_n=2, window_n=2)
    s = ns.s.Sentinel(prober=prober, ring=ring, alerts_jsonl=str(d / "alerts.jsonl"))
    r1 = s.tick(now=0.0)
    probs[1] = 0.90001
    r2 = s.tick(now=1.0)
    assert r1["schema"] == ns.s.SENTINEL_SCHEMA and r1["tick"] == 1 and r1["counters"]["canary_flips"] == 0
    assert r2["counters"]["canary_flips"] == 1
    return r1, r2, s.render_status(r2).split("\n", 1)[1]


def c_regression_fire_alert(ns, d):
    flows = ns.s.load_canary_flows(FIXTURE, preset="unswnb15")
    lat = [0.002]

    def fn(host, port, texts, **kw):
        return [({"prob": 0.5, "prediction": 1, "round": None}, lat[0]) for _ in texts]

    alerts = str(d / "alerts.jsonl")
    s = ns.s.Sentinel(prober=ns.s.CanaryProber(flows, "127.0.0.1", 1, probe_fn=fn),
                      ring=ns.s.RetentionRing(max_records=32, baseline_n=3, window_n=3), alerts_jsonl=alerts)
    reports = [s.tick(now=float(i)) for i in range(6)]
    lat[0] = 0.2
    reports += [s.tick(now=float(i)) for i in range(6, 10)]
    assert sum(len(r["regressions"]) for r in reports) == 1 and s.regression_fires == 1
    evs = [json.loads(ln) for ln in open(alerts).read().splitlines()]
    assert evs[0]["slo"] == "sentinel-regression" and evs[0]["severity"] == "page"
    assert evs[0]["evidence"]["field"] == "latency_p99_ms"
    return reports, evs


def c_needs_one_rung(ns, d):
    msg = _raises(ns.s.Sentinel)
    assert "at least one rung" in msg
    return msg


def c_drift_rung_feeds_counters(ns, d):
    verdicts = str(d / "verdicts.jsonl")
    tail, scored, journal = _tail(ns, d, verdicts_jsonl=verdicts)
    s = ns.s.Sentinel(tail=tail, ring=None, alerts_jsonl=None)
    _all_wrong(scored, journal)
    r = s.tick(now=0.0)
    assert r["drift"]["verdict"] is not None and r["counters"]["drift_fires"] == 1
    assert os.path.getsize(verdicts) > 0
    return r, open(verdicts).read()


# -------------------------------------------------------- custom trend fields
def c_parse_trend_field_spec(ns, d):
    p = ns.s.parse_trend_field_spec
    out = [p("my_counter"), p("fedtpu_server_stream_fallbacks_total:down")]
    assert out == [("my_counter", (1.5, 0.0, "up")), ("fedtpu_server_stream_fallbacks_total", (1.5, 0.0, "down"))]
    out += [_raises(p, ":up"), _raises(p, "x:sideways")]
    return out


def c_custom_field_rides_cadence(ns, d):
    name, entry = ns.s.parse_trend_field_spec("fedtpu_server_stream_fallbacks_total")
    ring = ns.s.RetentionRing(max_records=32, baseline_n=3, window_n=3,
                              trend_fields={**ns.s.DEFAULT_TREND_FIELDS, name: entry})
    rate = [1.0]

    class FakeHub:
        def poll(self, *, now):
            return {"targets": [{"up": True, "cadence": {name: rate[0] / 2}}, {"up": True, "cadence": {name: rate[0]}},
                                {"up": True, "cadence": {}}], "slo": []}

    s = ns.s.Sentinel(ring=ring, hub=FakeHub(), alerts_jsonl=str(d / "alerts.jsonl"))
    reports = [s.tick(now=float(i)) for i in range(6)]
    assert all(r["regressions"] == [] for r in reports)
    rate[0] = 100.0
    fired = []
    for i in range(6, 10):
        fired += s.tick(now=float(i))["regressions"]
    assert [f["field"] for f in fired] == [name] and fired[0]["direction"] == "up"
    assert fired[0]["baseline"] == 1.0 and fired[0]["now"] > 1.5
    return fired, ring.records


CASES = {name[2:]: fn for name, fn in sorted(globals().items()) if name.startswith("c_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sentinel_case_equals_jax(case, tmp_path):
    out = []
    for name, ns in (("jax", JAX), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        out.append(CASES[case](ns, d))
    assert out[1] == out[0]


def test_sentinel_cases_cover_the_jax_module():
    """One case here for each test of ``tests/test_sentinel.py``."""
    assert len(CASES) == 41


# --------------------------------------------------- a JAX-written journal
def test_journal_tail_over_a_jax_label_store_journal(tmp_path):
    """The JAX ``LabelStore`` writes the ground-truth journal (labels,
    duplicates, a watermark); the scored rows arrive in three bursts. Both
    packages' tails give the same statuses and verdicts, and journal the
    same verdict lines."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.labels.store import (
        LabelStore,
    )

    journal = str(tmp_path / "journal.jsonl")
    store = LabelStore(journal)
    rng = np.random.default_rng(11)
    labels = rng.integers(0, 2, 90)
    probs = np.where(rng.uniform(size=90) < 0.7, labels * 0.8 + 0.1, 0.9 - labels * 0.8)  # ~30% wrong
    bursts = [range(0, 30), range(30, 60), range(60, 90)]
    for i in range(75):  # the last 15 labels are still in flight
        store.ingest(f"r{i}", int(labels[i]), ts=float(i))
    store.ingest("r3", int(labels[3]), ts=3.0)  # a duplicate
    store.advance_watermark(74.0)
    out = {}
    for name, ns in (("jax", JAX), ("port", PORT)):
        scored = str(tmp_path / f"{name}-scored.jsonl")
        open(scored, "w").close()
        tail = ns.s.JournalTail(
            scored, journal, monitor=ns.ErrorRateMonitor(reference_error=0.05, margin=0.1, min_joined=16),
            verdicts_jsonl=str(tmp_path / f"{name}-verdicts.jsonl"),
        )
        out[name] = []
        for k, burst in enumerate(bursts):
            _write_lines(scored, [{"schema": "fedtpu-scored-v1", "rid": f"r{i}", "prob": float(probs[i])}
                                  for i in burst if i % 3 != 2 or k == 2])
            out[name].append(tail.poll(now=float(k)))
        with open(tmp_path / f"{name}-verdicts.jsonl") as f:
            out[name].append(f.read())
    assert out["port"] == out["jax"]
    assert any(st["verdict"] for st in out["port"][:-1])


# ------------------------------------------ obs sentinel through the scorer
def test_obs_sentinel_cli_through_the_port_scorer(tmp_path, capsys):
    """``obs sentinel --json`` ticks through a live port ``infer-serve``
    (tiny model on the CPU, registry-served): no incident at a fixed
    artifact across ticks, a promotion re-keys without an incident, and
    the canary latency histogram counts canaries x ticks."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
        obs as pobs,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
        main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
        build_server,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
        ModelConfig,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
        default_tokenizer,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
        init_params,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving.client import (
        ScoringClient,
    )

    tok = default_tokenizer()
    cfg = ModelConfig.tiny(vocab_size=len(tok.vocab))
    reg_dir = str(tmp_path / "reg")
    reg = PORT.ModelRegistry(reg_dir)
    a = reg.add(init_params(cfg, torch.Generator().manual_seed(0)), round_index=1, model_config=cfg)
    reg.promote(a, to="serving")
    server = build_server(build_parser().parse_args(
        ["infer-serve", "--registry-dir", reg_dir, "--host", "127.0.0.1", "--port", "0", "--device", "cpu",
         "--reload-poll", "3600"]
    ))
    hist = "fedtpu_canary_latency_seconds"

    def count():
        fam = pobs.default_registry().snapshot()["families"].get(hist)
        return fam["samples"][0]["count"] if fam else 0

    n0 = count()
    argv = ["obs", "sentinel", "--json", "--canaries", FIXTURE, "--canary-preset", "cicids2017",
            "--serve", f"127.0.0.1:{server.port}", "--registry-dir", reg_dir,
            "--ring-jsonl", str(tmp_path / "ring.jsonl")]
    reports = []
    with server:
        for tick in range(4):
            if tick == 2:  # a promotion between ticks: the scorer follows it
                b = reg.add(init_params(cfg, torch.Generator().manual_seed(1)), round_index=2, model_config=cfg)
                reg.promote(b, to="serving")
                with ScoringClient("127.0.0.1", server.port) as c:
                    assert c.reload()["round"] == 2
            capsys.readouterr()
            rc = main(argv)
            reports.append((rc, json.loads(capsys.readouterr().out)))
    n_flows = len(PORT.s.load_canary_flows(FIXTURE, preset="cicids2017"))
    for rc, rep in reports:
        assert rc == 0 and rep["canary"]["incidents"] == [] and rep["canary"]["probes"] == n_flows
    assert [rep["canary"]["expected_round"] for _, rep in reports] == [1, 1, 2, 2]
    assert count() - n0 == n_flows * 4
    ring_rows = [json.loads(ln) for ln in open(tmp_path / "ring.jsonl")]
    assert len(ring_rows) == 4 and all(r["schema"] == "fedtpu-ring-v1" for r in ring_rows)


def test_obs_sentinel_cli_refusals_equal_jax(tmp_path, capsys):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        main as jax_main,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        main,
    )

    cases = [
        ["obs", "sentinel"],
        ["obs", "sentinel", "--canaries", FIXTURE],
        ["obs", "sentinel", "--scored-jsonl", "s.jsonl"],
        ["obs", "sentinel", "--scored-jsonl", "s.jsonl", "--labels-journal", "j.jsonl"],
        ["obs", "sentinel", "--canaries", FIXTURE, "--serve", "h:1", "--regression-ratio", "1.0"],
        ["obs", "sentinel", "--canaries", FIXTURE, "--serve", "h:1", "--trend-field", "x:sideways"],
    ]
    for argv in cases:
        msgs = []
        for m in (jax_main, main):
            with pytest.raises(SystemExit) as e:
                m(argv)
            msgs.append(str(e.value).replace("fedtpu obs", "obs"))
        assert msgs[1] == msgs[0], argv
