"""Merge per-process span JSONLs into per-round timelines + Chrome traces
(the port's copy of the JAX package's ``obs/timeline.py``: the same spans
give the same table and the same Chrome trace, byte for byte).

The analysis half of the obs subsystem (the write half is obs/trace.py):
load every process's events-JSONL, group spans on the shared
(trace, round) identity the server stamped across the wire, and answer
the question the uncorrelated metrics streams could not — *where did
round N's wall-clock go?*

Per-round attribution model (client-centric, from the spans each side
actually measured)::

    compute  the client's ``client-local`` span
    upload   its ``wire-upload`` send
    wait     straggler wait: the client's reply-recv window minus the
             server's measured agg + reply time (clamped at 0 — the
             residual is time spent blocked on OTHER clients)
    agg      the server's ``agg`` span (shared by every client row)
    reply    the server's ``wire-reply`` fan-out span

``compute + upload + wait + agg + reply`` reconstructs each client's
measured round wall (first-span start to last-span end) up to clamp
error and inter-span gaps — the tests pin the 10% bound.

The Chrome export emits trace-event-format "X" (complete) events —
``json.load``-able, loadable in ``chrome://tracing`` / Perfetto — one
pid per process (``proc``), one tid per span name so nested server spans
(round ⊃ agg ⊃ wire-reply) render as lanes instead of overlapping.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Iterable

from .trace import SCHEMA


def load_spans(
    paths: Iterable[str] | None = None, *, trace_dir: str | None = None
) -> list[dict]:
    """Read span records from explicit JSONL paths and/or every
    ``*.jsonl`` under ``trace_dir``. Foreign or truncated lines (a
    crashed writer's partial tail, a concatenated metrics stream) are
    skipped, not fatal — merge tools must survive dirty inputs."""
    files: list[str] = list(paths or [])
    if trace_dir:
        files.extend(sorted(glob.glob(os.path.join(trace_dir, "*.jsonl"))))
    spans: list[dict] = []
    for path in files:
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict) or rec.get("schema") != SCHEMA:
                continue
            if "span" not in rec or "ts" not in rec or "dur_s" not in rec:
                continue
            spans.append(rec)
    spans.sort(key=lambda r: r["ts"])
    return spans


def read_new_jsonl_lines(
    path: str, offset: int
) -> tuple[int, list[bytes]]:
    """Incremental complete-line tail of one JSONL file: read from
    ``offset``, return ``(new_offset, complete line bytes)``. The one
    copy of the byte-offset resume pattern the drift monitor
    (control/drift.py) and the scrape hub's events tail (obs/fleet.py)
    both poll with: a missing file is empty (not an error), truncation/
    rotation restarts at 0, and a partially-flushed trailing line waits
    for the next poll (writers append whole lines atomically)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return offset, []
    if size < offset:
        offset = 0  # file truncated/rotated: start over
    if size == offset:
        return offset, []
    with open(path, "rb") as f:
        f.seek(offset)
        chunk = f.read(size - offset)
    end = chunk.rfind(b"\n")
    if end < 0:
        return offset, []
    return offset + end + 1, chunk[: end + 1].splitlines()


def tail_spans(
    paths: Iterable[str] | None = None,
    *,
    trace_dir: str | None = None,
    poll_s: float = 0.5,
    from_start: bool = False,
    stop=None,
):
    """Follow-mode span reader (the ``fedtpu obs tail`` engine): a
    generator yielding span dicts as they are APPENDED to the
    events-JSONL set — the live counterpart of :func:`load_spans`.

    Files named up front start at their end (``from_start=True`` replays
    them first); files that APPEAR later under ``trace_dir`` (a process
    opening its ``--trace-jsonl`` mid-run) are picked up from offset 0 —
    a late-starting client's spans are new by definition. Partial tails
    are never parsed: a line is consumed only once its newline landed,
    so a mid-append poll cannot yield half a record (the writers append
    whole lines atomically, obs/trace.py). ``stop`` is a zero-arg
    callable polled between passes — the tailer's only exit besides
    GeneratorExit."""
    offsets: dict[str, int] = {}

    def _files() -> list[str]:
        files = list(paths or [])
        if trace_dir:
            files.extend(
                sorted(glob.glob(os.path.join(trace_dir, "*.jsonl")))
            )
        return files

    for path in _files():
        try:
            offsets[path] = 0 if from_start else os.path.getsize(path)
        except OSError:
            offsets[path] = 0
    while True:
        for path in _files():
            off = offsets.setdefault(path, 0)
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read()
            except OSError:
                continue
            if not chunk:
                continue
            end = chunk.rfind(b"\n")
            if end < 0:
                continue  # no complete line yet
            offsets[path] = off + end + 1
            for line in chunk[: end + 1].splitlines():
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(rec, dict) or rec.get("schema") != SCHEMA:
                    continue
                if "span" not in rec or "ts" not in rec or "dur_s" not in rec:
                    continue
                yield rec
        if stop is not None and stop():
            return
        time.sleep(poll_s)


def group_rounds(spans: Iterable[dict]) -> dict[tuple, list[dict]]:
    """(trace, round) -> spans. Spans that carry neither identity
    (e.g. serve-batch outside any round) group under (None, None)."""
    groups: dict[tuple, list[dict]] = {}
    for s in spans:
        key = (s.get("trace"), s.get("round"))
        groups.setdefault(key, []).append(s)
    return groups


def _one(spans: list[dict], name: str, proc: str | None = None) -> dict | None:
    cands = [
        s
        for s in spans
        if s["span"] == name and (proc is None or s.get("proc") == proc)
    ]
    return max(cands, key=lambda s: s["dur_s"]) if cands else None


def round_breakdown(spans: list[dict]) -> dict:
    """One (trace, round) group -> the per-client phase attribution the
    module docstring defines, plus slowest-span attribution."""
    agg = _one(spans, "agg")
    # Server-side reply fan-out ONLY: without an agg span (a partial
    # deployment where the server isn't tracing) there is no server
    # identity to filter on, and a wildcard would grab a CLIENT's
    # wire-reply recv window — misattributing straggler wait as reply.
    srv_proc = agg.get("proc") if agg else None
    srv_reply = (
        _one(spans, "wire-reply", proc=srv_proc) if srv_proc else None
    )
    agg_s = agg["dur_s"] if agg else 0.0
    reply_s = srv_reply["dur_s"] if srv_reply else 0.0
    # Streaming chunk aggregation (comm/stream_agg.py): fold work that
    # ran DURING the wire phase — hidden inside clients' wait, so it
    # joins no per-client sum; reported as the round's overlapped-vs-
    # exposed wire attribution instead. The exposed aggregation time is
    # the ``agg`` span as before.
    overlap = _one(spans, "wire-overlap", proc=srv_proc) if srv_proc else None
    overlap_s = overlap["dur_s"] if overlap else 0.0
    round_span = _one(spans, "round")
    client_procs = sorted(
        {
            s["proc"]
            for s in spans
            if s["span"] in ("client-local", "wire-upload")
        }
    )
    clients: dict[str, dict] = {}
    for proc in client_procs:
        mine = [s for s in spans if s.get("proc") == proc]
        compute = sum(
            s["dur_s"] for s in mine if s["span"] == "client-local"
        )
        upload = sum(s["dur_s"] for s in mine if s["span"] == "wire-upload")
        recv = sum(
            s["dur_s"]
            for s in mine
            if s["span"] == "wire-reply"
        )
        wait = max(recv - agg_s - reply_s, 0.0)
        t0 = min(s["ts"] for s in mine)
        t1 = max(s["ts"] + s["dur_s"] for s in mine)
        clients[proc] = {
            "compute_s": compute,
            "upload_s": upload,
            "wait_s": wait,
            "agg_s": agg_s,
            "reply_s": reply_s,
            "attributed_s": compute + upload + wait + agg_s + reply_s,
            "measured_s": t1 - t0,
        }
    slowest = max(spans, key=lambda s: s["dur_s"]) if spans else None
    return {
        "trace": spans[0].get("trace") if spans else None,
        "round": spans[0].get("round") if spans else None,
        "round_wall_s": round_span["dur_s"] if round_span else None,
        # The server's aggregated-contributor ids (agg span attr):
        # a client row present here but absent from contributors was
        # dropped/excluded; absent entirely = never arrived. None on
        # traces from servers that predate the attribute.
        "contributors": agg.get("contributors") if agg else None,
        "failed": bool(round_span.get("failed")) if round_span else False,
        "agg_s": agg_s,
        "reply_s": reply_s,
        "overlap_s": overlap_s,
        "overlap_frac": overlap.get("overlap_frac") if overlap else None,
        "peak_agg_bytes": (
            overlap.get("peak_agg_bytes") if overlap else None
        ),
        "clients": clients,
        "slowest_span": (
            {
                "span": slowest["span"],
                "proc": slowest.get("proc"),
                "dur_s": slowest["dur_s"],
            }
            if slowest
            else None
        ),
        "n_spans": len(spans),
    }


def timeline_table(
    spans: list[dict], *, round_filter: int | None = None
) -> str:
    """Human-readable per-round table over the merged spans (the
    ``fedtpu obs timeline`` output)."""
    groups = group_rounds(spans)
    out: list[str] = []
    keys = sorted(
        (k for k in groups if k != (None, None)),
        key=lambda k: (k[1] if k[1] is not None else -1, str(k[0])),
    )
    for key in keys:
        trace, rnd = key
        if round_filter is not None and rnd != round_filter:
            continue
        b = round_breakdown(groups[key])
        head = f"trace {trace or '-'} round {rnd if rnd is not None else '-'}"
        if b["round_wall_s"] is not None:
            head += f"  server wall {b['round_wall_s']:.3f}s"
        if b["failed"]:
            head += "  FAILED"
        if b["contributors"] is not None:
            head += f"  contributors {b['contributors']}"
        out.append(head)
        if b["clients"]:
            out.append(
                f"  {'client':<14} {'compute':>9} {'upload':>9} "
                f"{'wait':>9} {'agg':>9} {'reply':>9} {'total':>9} "
                f"{'measured':>9}"
            )
            for proc, row in sorted(b["clients"].items()):
                out.append(
                    f"  {proc:<14} "
                    f"{row['compute_s']:>8.3f}s {row['upload_s']:>8.3f}s "
                    f"{row['wait_s']:>8.3f}s {row['agg_s']:>8.3f}s "
                    f"{row['reply_s']:>8.3f}s {row['attributed_s']:>8.3f}s "
                    f"{row['measured_s']:>8.3f}s"
                )
        # Device-vs-host row (obs/profile.py StepProfiler): client-local
        # spans carrying sampled step attrs split their compute seconds
        # into host batch-prep / dispatch / device-execute.
        for s in groups[key]:
            if s["span"] != "client-local" or s.get(
                "step_device_ms_p50"
            ) is None:
                continue
            out.append(
                f"  step-profile   {str(s.get('proc', '?')):<14} "
                f"host {s.get('step_host_ms_p50', 0.0):.2f}ms  "
                f"dispatch {s.get('step_dispatch_ms_p50', 0.0):.2f}ms  "
                f"device {s['step_device_ms_p50']:.2f}ms p50 "
                f"({s.get('step_sampled', 0)} sampled)"
            )
        # Wire-codec row (obs/profile.py "wire" site): wire-upload /
        # wire-reply spans carrying sampled per-leaf pack/unpack timings
        # — the stream hot loops the step profiler's train/score sites
        # never covered.
        for s in groups[key]:
            if s["span"] not in ("wire-upload", "wire-reply") or s.get(
                "step_wire_ms_p50"
            ) is None:
                continue
            kind = "pack" if s["span"] == "wire-upload" else "unpack"
            out.append(
                f"  wire-codec     {str(s.get('proc', '?')):<14} "
                f"{kind} {s['step_wire_ms_p50']:.2f}ms p50 / "
                f"{s.get('step_wire_ms_p95', 0.0):.2f}ms p95 per leaf "
                f"({s.get('step_sampled', 0)} sampled)"
            )
        if b["overlap_s"] > 0.0:
            # Overlapped vs exposed wire/aggregation time: fold seconds
            # hidden inside the wire phase, next to the exposed agg.
            frac = b["overlap_frac"]
            peak = b["peak_agg_bytes"]
            out.append(
                f"  wire-overlap   {b['overlap_s']:>8.3f}s folded during "
                "the wire phase"
                + (f" ({frac:.0%} of fold input)" if frac is not None else "")
                + (f", peak agg {peak / 1e6:.1f} MB" if peak else "")
            )
        # Wire-efficiency row: quantized-upload dtypes + fold
        # engine/throughput ride the wire-overlap span; sparse upward
        # hops stamp their bytes on relay-forward spans. One compressed
        # line showing what the round's wire actually carried.
        for s in groups[key]:
            if s["span"] != "wire-overlap" or (
                not s.get("wire_dtypes")
                and not s.get("fold_engine")
            ):
                continue
            dts = s.get("wire_dtypes") or ["fp32"]
            gbps = s.get("fold_throughput_gbps")
            out.append(
                f"  wire-dtype     uploads {'+'.join(str(d) for d in dts)}"
                + (f", fold {s['fold_engine']}" if s.get("fold_engine") else "")
                + (f" @ {gbps:.2f} GB/s" if gbps else "")
            )
        up_spans = [
            s
            for s in groups[key]
            if s["span"] == "relay-forward"
            and s.get("upward_bytes") is not None
        ]
        if up_spans:
            up_total = sum(int(s["upward_bytes"]) for s in up_spans)
            n_sparse = sum(1 for s in up_spans if s.get("upward_sparse"))
            out.append(
                f"  relay-upward   {up_total / 1e6:>8.2f} MB over "
                f"{len(up_spans)} hop(s)"
                + (
                    f" ({n_sparse} sparse topk)"
                    if n_sparse
                    else " (dense)"
                )
            )
        extra = [
            s
            for s in groups[key]
            if s["span"]
            in (
                "eval-gate",
                "promote",
                "serve-batch",
                "batch-prefetch",
                "relay-forward",
                "router-forward",
                "replica-drain",
                "slo-eval",
                "postmortem-dump",
                "drift-trigger",
                "xla-compile",
            )
        ]
        for s in extra:
            out.append(
                f"  {s['span']:<14} {s['dur_s']:>8.3f}s  ({s.get('proc')})"
            )
        if b["slowest_span"]:
            sl = b["slowest_span"]
            out.append(
                f"  slowest span: {sl['span']} on {sl['proc']} "
                f"({sl['dur_s']:.3f}s)"
            )
        out.append("")
    # Health-plane spans carry NO (trace, round) by construction — the
    # hub's slo-eval poll and a flight-recorder dump happen outside any
    # round's identity — so they live in the (None, None) group the
    # per-round rendering above excludes. Surface the notable ones in a
    # trailing section (newest last, capped) instead of dropping them.
    unscoped = [
        s
        for s in groups.get((None, None), ())
        if s["span"]
        in (
            "postmortem-dump",
            "drift-trigger",
            "slo-eval",
            "xla-compile",
            "shadow-mirror",
            "shadow-compare",
            "shadow-gate",
            "canary-probe",
            "sentinel-eval",
            "regression-fire",
        )
    ]
    if unscoped and round_filter is None:
        out.append("unscoped health-plane spans:")
        for s in unscoped[-10:]:
            attrs = " ".join(
                f"{k}={s[k]}"
                for k in (
                    "reason", "bundle", "drift", "firing", "up",
                    "site", "recompile", "pairs", "flip_rate", "passed",
                    "artifact", "mirrored", "mismatches", "flips",
                    "drift_fired", "regressions", "field", "now_mean",
                )
                if s.get(k) is not None
            )
            out.append(
                f"  {s['span']:<16} {s['dur_s']:>8.3f}s  "
                f"({s.get('proc')})" + (f"  {attrs}" if attrs else "")
            )
        out.append("")
    if not out:
        return "(no round-scoped spans found)\n"
    return "\n".join(out)


# ------------------------------------------------------- chrome export
def chrome_trace(spans: list[dict]) -> dict:
    """Chrome trace-event JSON (the object form with ``traceEvents``):
    one "X" complete event per span, microsecond timestamps rebased to
    the earliest span, pid per process, tid per span name (nested server
    spans become lanes, never overlaps)."""
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(s["ts"] for s in spans)
    procs = sorted({str(s.get("proc", "?")) for s in spans})
    pid_of = {p: i + 1 for i, p in enumerate(procs)}
    names = sorted({s["span"] for s in spans})
    tid_of = {n: i + 1 for i, n in enumerate(names)}
    events: list[dict[str, Any]] = []
    for p in procs:
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid_of[p],
                "tid": 0,
                "args": {"name": p},
            }
        )
    for n in names:
        for p in procs:
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid_of[p],
                    "tid": tid_of[n],
                    "args": {"name": n},
                }
            )
    for s in spans:
        args = {
            k: v
            for k, v in s.items()
            if k not in ("schema", "proc", "span", "ts", "dur_s")
        }
        events.append(
            {
                "name": s["span"],
                "cat": "fedtpu",
                "ph": "X",
                "ts": round((s["ts"] - t0) * 1e6, 3),
                "dur": round(s["dur_s"] * 1e6, 3),
                "pid": pid_of[str(s.get("proc", "?"))],
                "tid": tid_of[s["span"]],
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(
    spans: list[dict], out_path: str
) -> str:
    """Write :func:`chrome_trace` to ``out_path``; returns the path."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(chrome_trace(spans), f)
    return out_path


def round_summaries(spans: list[dict]) -> list[dict]:
    """Machine-readable per-round breakdowns (what ``obs timeline
    --json`` prints), sorted by round."""
    groups = group_rounds(spans)
    out = [
        round_breakdown(g)
        for key, g in sorted(
            groups.items(),
            key=lambda kv: (
                kv[0][1] if kv[0][1] is not None else -1,
                str(kv[0][0]),
            ),
        )
        if key != (None, None)
    ]
    return out
