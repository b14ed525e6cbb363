"""``obs`` — timelines, Chrome export, live tailing, fleet health, the
sentinel, postmortems and the device profile (the port of the JAX
package's ``cli/obs.py``).

Every tier appends spans to its own events-JSONL (``--trace-jsonl``);
this command merges them on the shared (trace, round) identity and
answers "where did round N's wall-clock go". The span, alert, snapshot
and report formats are the JAX package's, so a directory holding both
packages' files merges into one timeline, and one hub scrapes daemons of
both.

    obs timeline --trace-dir runs/obs
    obs timeline --trace server.jsonl --trace client0.jsonl --json
    obs export --trace-dir runs/obs --out trace.json
        # load trace.json in chrome://tracing or ui.perfetto.dev
    obs tail --trace-dir runs/obs --round 3
        # live follow mode: one line per span as processes append them
    obs health --target controller=127.0.0.1:9100 \\
               --target infer-serve=127.0.0.1:9101
        # two spaced scrapes of every daemon's /metrics.json + the SLO
        # burn-rate verdicts (--slo FILE, --alerts-jsonl, --alert-cmd,
        # --snapshot-jsonl); exit 1 when a target is down or an SLO fires
    obs watch --target ... --interval 2
        # the live-refresh twin (`health --watch` is the same loop)
    obs sentinel --canaries tests/data/canary_flows.jsonl \\
                 --serve 127.0.0.1:12380 --registry-dir runs/reg \\
                 --ring-jsonl runs/ring.jsonl
        # canary probes through the live scorer (pointer, bit-stability,
        # latency), journal-tailing supervised drift (--scored-jsonl,
        # --labels-journal, --reference-error, --verdicts-jsonl) and the
        # retention ring's regression verdicts (--json = one tick)
    obs postmortem --flight-dir runs/flight [--bundle NAME]
        # list flight-recorder bundles / inspect one (--json full dump)
    obs profile --preset distilbert --steps 12 [--capture DIR]
        # the device performance plane on the card: dispatch ledger by
        # site, recompile flags, fenced host/dispatch/device step split,
        # memory watermarks, analytic-vs-counted FLOPs cross-check
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..obs import (
    FlightRecorder,
    ScrapeHub,
    Tracer,
    default_slos,
    export_chrome_trace,
    health_verdict,
    list_bundles,
    load_bundle,
    load_spans,
    parse_target,
    round_summaries,
    slos_from_spec,
    tail_spans,
    timeline_table,
)


def _tail_line(rec: dict) -> str:
    """One human-readable line per span (the tail format): local time,
    proc, span, duration, identity, then every extra attribute."""
    ts = time.strftime("%H:%M:%S", time.localtime(rec["ts"]))
    head = (
        f"{ts} {str(rec.get('proc', '?')):<12} {rec['span']:<15} "
        f"{rec['dur_s'] * 1e3:9.1f}ms"
    )
    ident = []
    if rec.get("trace") is not None:
        ident.append(f"trace={rec['trace']}")
    if rec.get("round") is not None:
        ident.append(f"round={rec['round']}")
    skip = {"schema", "run_id", "proc", "span", "ts", "dur_s", "trace", "round"}
    attrs = [f"{k}={rec[k]}" for k in rec if k not in skip]
    return " ".join([head] + ident + attrs)


def _cmd_tail(args, paths, trace_dir) -> int:
    """Live follow mode over the events-JSONL set. An empty or missing
    input is not an error: tailing a directory that processes will write
    into shortly is the point."""
    trace_filter = getattr(args, "trace_id", None)
    round_filter = getattr(args, "round", None)
    max_seconds = getattr(args, "max_seconds", None)
    deadline = (
        time.monotonic() + float(max_seconds)
        if max_seconds is not None
        else None
    )
    stop = (
        (lambda: time.monotonic() >= deadline)
        if deadline is not None
        else None
    )
    try:
        for rec in tail_spans(
            paths,
            trace_dir=trace_dir,
            poll_s=getattr(args, "poll", None) or 0.5,
            from_start=getattr(args, "from_start", False),
            stop=stop,
        ):
            if trace_filter is not None and rec.get("trace") != trace_filter:
                continue
            if round_filter is not None and rec.get("round") != round_filter:
                continue
            print(_tail_line(rec), flush=True)
    except KeyboardInterrupt:
        pass
    return 0


def build_hub(args) -> ScrapeHub:
    specs = getattr(args, "target", None) or []
    if not specs:
        raise SystemExit(
            "obs health/watch needs at least one "
            "--target TIER=HOST:PORT[,events=PATH] (the daemon's "
            "--metrics-port endpoint; /metrics.json is served there)"
        )
    try:
        targets = [parse_target(s) for s in specs]
    except ValueError as e:
        raise SystemExit(str(e)) from None
    slos = None
    slo_path = getattr(args, "slo", None)
    if slo_path:
        with open(slo_path) as f:
            spec = json.load(f)
        try:
            slos = slos_from_spec(spec)
        except (TypeError, ValueError) as e:
            raise SystemExit(f"--slo {slo_path}: {e}") from None
    else:
        slos = default_slos()
    tracer = None
    if getattr(args, "trace_jsonl", None):
        tracer = Tracer(args.trace_jsonl, proc="obs-hub")
    recorder = None
    if getattr(args, "flight_dir", None):
        # The hub is where SLO evaluation actually happens, so the hub
        # is where a page-severity fire can dump a postmortem — the
        # daemons' own recorders live in other processes and never
        # learn of the page.
        recorder = FlightRecorder(
            args.flight_dir, proc="obs-hub", tracer=tracer
        )
    alert_interval = getattr(args, "alert_interval", None)
    try:
        return ScrapeHub(
            targets,
            slos=slos,
            alerts_jsonl=getattr(args, "alerts_jsonl", None),
            snapshot_jsonl=getattr(args, "snapshot_jsonl", None),
            snapshot_max_mb=getattr(args, "snapshot_max_mb", None),
            scrape_timeout_s=getattr(args, "scrape_timeout", None) or 2.0,
            tracer=tracer,
            recorder=recorder,
            alert_cmd=getattr(args, "alert_cmd", None),
            # is-None, not falsy-or: an explicit --alert-interval 0
            # means "spawn on every page fire", not the 30 s default.
            alert_cmd_interval_s=(
                30.0 if alert_interval is None else alert_interval
            ),
        )
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _cmd_health(args) -> int:
    """One scrape pass (or the --watch loop) + the fleet status screen."""
    hub = build_hub(args)
    if getattr(args, "watch", False) or args.action == "watch":
        hub.watch(
            interval_s=getattr(args, "interval", None) or 2.0,
            max_seconds=getattr(args, "max_seconds", None),
        )
        return 0
    # TWO spaced polls, not one: burn rates and round cadence are
    # DELTAS of cumulative counters — a single scrape has no baseline,
    # so a one-shot pass could never report a firing SLO and the
    # cron-able exit code would only ever detect down targets.
    hub.poll()
    time.sleep(getattr(args, "interval", None) or 2.0)
    snapshot = hub.poll()
    if getattr(args, "json", False):
        # The schema-versioned VERDICT (fedtpu-health-v1), not the raw
        # snapshot: cron/CI consumers parse one stable judgement shape;
        # the raw per-poll records live in --snapshot-jsonl.
        json.dump(health_verdict(snapshot), sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(hub.render_status(snapshot))
    firing = sum(1 for s in snapshot["slo"] if s["firing"])
    down = sum(1 for t in snapshot["targets"] if not t["up"])
    # Exit code is the health verdict (cron-able): 0 healthy, 1 not.
    return 1 if (firing or down) else 0


def _cmd_postmortem(args) -> int:
    """List/inspect flight-recorder bundles."""
    flight_dir = getattr(args, "flight_dir", None)
    if not flight_dir:
        raise SystemExit("obs postmortem needs --flight-dir DIR")
    bundle_name = getattr(args, "bundle", None)
    if bundle_name:
        path = (
            bundle_name
            if os.path.sep in bundle_name
            else os.path.join(flight_dir, bundle_name)
        )
        b = load_bundle(path)
        if b is None:
            raise SystemExit(f"no readable postmortem bundle at {path}")
        if getattr(args, "json", False):
            json.dump(b, sys.stdout, indent=2)
            sys.stdout.write("\n")
            return 0
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(b["ts"]))
        print(f"bundle   {path}")
        print(f"proc     {b['proc']}")
        print(f"reason   {b['reason']}  ({ts})")
        if b.get("extra"):
            print(f"context  {json.dumps(b['extra'])}")
        alerts = b.get("alerts") or []
        print(f"alerts   {len(alerts)}")
        for a in alerts[-5:]:
            print(
                f"  {a.get('event')} {a.get('slo')} on "
                f"{a.get('instance')} burn={a.get('burn')}"
            )
        spans = b.get("spans") or []
        print(f"spans    {len(spans)} (newest last)")
        for s in spans[-10:]:
            print("  " + _tail_line(s))
        return 0
    bundles = list_bundles(flight_dir)
    if getattr(args, "json", False):
        json.dump(bundles, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0
    if not bundles:
        print(f"(no postmortem bundles under {flight_dir})")
        return 0
    for b in bundles:
        ts = time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime(b["ts"] or 0)
        )
        print(
            f"{ts}  {b['proc']:<12} {b['reason']:<16} "
            f"{b['spans']:>4} span(s) {b['alerts']:>3} alert(s)  "
            f"{b['name']}"
        )
    return 0


def _cmd_profile(args) -> int:
    """Run the device performance plane end to end on real train steps
    (obs/profile.py run_profile_session) and render the report. Exit 1
    when a recompile was flagged or the FLOPs ratio broke tolerance —
    the "device plane healthy" verdict."""
    from ..config import TrainConfig
    from ..device import resolve_device
    from ..models.presets import PRESETS
    from ..obs.profile import render_profile_report, run_profile_session

    device = resolve_device(getattr(args, "device", None))
    preset = getattr(args, "preset", None) or "tiny"
    if preset not in PRESETS:
        raise SystemExit(f"unknown --preset {preset!r} ({'|'.join(PRESETS)})")
    # `is None` checks, not `or`: an explicit `--stride 0` is the
    # documented fence-nothing value and must reach the session as 0.
    steps = getattr(args, "steps", None)
    batch_size = getattr(args, "batch_size", None)
    stride = getattr(args, "stride", None)
    report = run_profile_session(
        # The port's main path: the card's flash kernels (their plain
        # versions on the CPU).
        PRESETS[preset](attention_impl="flash"),
        TrainConfig(),
        steps=12 if steps is None else steps,
        batch_size=8 if batch_size is None else batch_size,
        stride=1 if stride is None else stride,
        capture_dir=getattr(args, "capture", None),
        device=device,
    )
    if getattr(args, "json", False):
        json.dump(report, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_profile_report(report))
    broken = bool(report["recompiles"]) or not report["flops_ratio_ok"]
    srv = report.get("serving")
    if srv is not None and srv["recompiles"]:
        broken = True
    return 1 if broken else 0


def build_sentinel(args):
    """The sentinel daemon the ``obs sentinel`` flags describe
    (obs/sentinel.py): canary probes, journal-tailing supervised drift,
    long-horizon ring. Any rung may be absent; at least one must be
    configured."""
    from ..control.drift import ErrorRateMonitor
    from ..obs.sentinel import (
        CanaryProber,
        JournalTail,
        RetentionRing,
        Sentinel,
        load_canary_flows,
        parse_trend_field_spec,
    )

    tracer = None
    if getattr(args, "trace_jsonl", None):
        tracer = Tracer(args.trace_jsonl, proc="sentinel")
    recorder = None
    if getattr(args, "flight_dir", None):
        recorder = FlightRecorder(
            args.flight_dir, proc="sentinel", tracer=tracer
        )
    prober = None
    if getattr(args, "canaries", None):
        serve = getattr(args, "serve", None)
        if not serve or ":" not in serve:
            raise SystemExit(
                "sentinel --canaries needs --serve HOST:PORT (the "
                "scoring endpoint the probes dial)"
            )
        host, _, port_s = serve.rpartition(":")
        try:
            flows = load_canary_flows(
                args.canaries, preset=getattr(args, "canary_preset", None)
            )
        except (OSError, ValueError) as e:
            raise SystemExit(f"--canaries {args.canaries}: {e}") from None
        registry = None
        if getattr(args, "registry_dir", None):
            from ..registry import ModelRegistry

            registry = ModelRegistry(args.registry_dir)
        prober = CanaryProber(
            flows,
            host,
            int(port_s),
            registry=registry,
            tracer=tracer,
            recorder=recorder,
        )
    tail = None
    scored = getattr(args, "scored_jsonl", None)
    journal = getattr(args, "labels_journal", None)
    if scored or journal:
        if not (scored and journal):
            raise SystemExit(
                "sentinel journal tailing needs BOTH --scored-jsonl and "
                "--labels-journal (the join has two sides)"
            )
        ref = getattr(args, "reference_error", None)
        if ref is None:
            raise SystemExit(
                "sentinel journal tailing needs --reference-error (the "
                "promoted model's error the continuous monitor compares "
                "against — the registry manifest's eval error)"
            )
        monitor = ErrorRateMonitor(
            reference_error=ref,
            margin=getattr(args, "error_margin", None) or 0.05,
            min_joined=getattr(args, "error_min_joined", None) or 64,
        )
        tail = JournalTail(
            scored,
            journal,
            monitor=monitor,
            verdicts_jsonl=getattr(args, "verdicts_jsonl", None),
            tracer=tracer,
        )
    ring = RetentionRing(
        getattr(args, "ring_jsonl", None),
        max_records=getattr(args, "ring_records", None) or 512,
        stride=getattr(args, "ring_stride", None) or 1,
        baseline_n=getattr(args, "baseline_n", None) or 8,
        window_n=getattr(args, "window_n", None) or 8,
    )
    # Per-deployment trend fields (--trend-field NAME[:direction]): merge
    # BEFORE the --regression-ratio rewrite, so a custom ratio applies to
    # the custom fields exactly as it does to the stock ones.
    for spec in getattr(args, "trend_field", None) or ():
        try:
            name, entry = parse_trend_field_spec(spec)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        ring.trend_fields[name] = entry
    ratio = getattr(args, "regression_ratio", None)
    if ratio is not None:
        if ratio <= 1.0:
            raise SystemExit(
                f"--regression-ratio {ratio} must be > 1 (it multiplies "
                "the baseline mean)"
            )
        ring.trend_fields = {
            f: (float(ratio), floor, direction)
            for f, (_, floor, direction) in ring.trend_fields.items()
        }
    hub = None
    if getattr(args, "target", None):
        hub = build_hub(args)
    if prober is None and tail is None:
        raise SystemExit(
            "obs sentinel needs at least one rung: --canaries + "
            "--serve (canary probes) and/or --scored-jsonl + "
            "--labels-journal + --reference-error (supervised drift); "
            "the retention ring rides whichever signals exist"
        )
    return Sentinel(
        prober=prober,
        tail=tail,
        ring=ring,
        hub=hub,
        alerts_jsonl=getattr(args, "alerts_jsonl", None),
        tracer=tracer,
        recorder=recorder,
    )


def _cmd_sentinel(args) -> int:
    """Run the sentinel: ``--json`` runs ONE tick and prints the
    machine-readable report (exit 1 when the tick surfaced any
    incident); default is the watch loop."""
    sentinel = build_sentinel(args)
    if getattr(args, "json", False):
        report = sentinel.tick()
        json.dump(report, sys.stdout, indent=2)
        sys.stdout.write("\n")
        c = report["counters"]
        bad = (
            c["canary_flips"] + c["drift_fires"] + c["regression_fires"]
        ) or (report["canary"] or {}).get("failures", 0)
        return 1 if bad else 0
    sentinel.watch(
        interval_s=getattr(args, "interval", None) or 5.0,
        max_seconds=getattr(args, "max_seconds", None),
    )
    return 0


def cmd_obs(args) -> int:
    if args.action in ("health", "watch"):
        return _cmd_health(args)
    if args.action == "sentinel":
        return _cmd_sentinel(args)
    if args.action == "postmortem":
        return _cmd_postmortem(args)
    if args.action == "profile":
        return _cmd_profile(args)
    paths = list(getattr(args, "trace", None) or [])
    trace_dir = getattr(args, "trace_dir", None)
    if not paths and not trace_dir:
        raise SystemExit(
            "obs needs span inputs: --trace-dir DIR (merges every "
            "*.jsonl) and/or --trace FILE (repeatable)"
        )
    if args.action == "tail":
        return _cmd_tail(args, paths, trace_dir)
    spans = load_spans(paths, trace_dir=trace_dir)
    if not spans:
        raise SystemExit(
            "no obs spans found (are these files written by --trace-jsonl "
            "/ obs.trace.Tracer? metrics-JSONL streams are a different "
            "schema)"
        )
    if args.action == "export":
        out = getattr(args, "out", None)
        if not out:
            raise SystemExit("obs export needs --out <chrome_trace.json>")
        path = export_chrome_trace(spans, out)
        print(
            f"wrote {path} ({len(spans)} spans; load in chrome://tracing "
            "or ui.perfetto.dev)"
        )
        return 0
    if args.action == "timeline":
        round_filter = getattr(args, "round", None)
        if getattr(args, "json", False):
            rounds = round_summaries(spans)
            if round_filter is not None:
                rounds = [r for r in rounds if r["round"] == round_filter]
            json.dump(rounds, sys.stdout, indent=2)
            sys.stdout.write("\n")
        else:
            sys.stdout.write(
                timeline_table(spans, round_filter=round_filter)
            )
        return 0
    raise SystemExit(f"unknown obs action {args.action!r}")
