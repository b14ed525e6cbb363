"""``obs`` — timelines, Chrome export, live tailing, postmortems and the
device profile (the port of the JAX package's ``cli/obs.py``, without the
fleet read side: ``health``, ``watch`` and ``sentinel`` are not ported).

Every tier appends spans to its own events-JSONL (``--trace-jsonl``);
this command merges them on the shared (trace, round) identity and
answers "where did round N's wall-clock go". The span format is the JAX
package's, so a directory holding both packages' files merges into one
timeline.

    obs timeline --trace-dir runs/obs
    obs timeline --trace server.jsonl --trace client0.jsonl --json
    obs export --trace-dir runs/obs --out trace.json
        # load trace.json in chrome://tracing or ui.perfetto.dev
    obs tail --trace-dir runs/obs --round 3
        # live follow mode: one line per span as processes append them
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
    export_chrome_trace,
    list_bundles,
    load_bundle,
    load_spans,
    round_summaries,
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


def cmd_obs(args) -> int:
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
