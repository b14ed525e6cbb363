"""Observability of the port: tracing, metrics, timelines, postmortems and
the device performance plane (the port of the JAX package's ``obs/``).

* :mod:`.trace` — round-scoped trace contexts with span ids propagated
  across the TCP wire protocols via an optional meta field; every
  process appends spans to a unified events-JSONL.
* :mod:`.metrics` — in-process counters/gauges/histograms exposed over a
  stdlib-HTTP ``/metrics`` endpoint in Prometheus text format, plus the
  machine-readable ``/metrics.json`` twin.
* :mod:`.timeline` — the ``obs`` merge/analysis layer: per-round
  timeline tables and Chrome trace-event export.
* :mod:`.flight` — the failure flight recorder: bounded in-memory rings
  dumped as postmortem bundles on round failure or scoring failure.
* :mod:`.profile` — the device performance plane: the dispatch ledger
  (first dispatch per site and shape), strided fenced step-time
  attribution, CUDA memory watermarks, and the analytic-vs-counted
  FLOPs cross-check behind ``obs profile``.
* :mod:`.slo` — declarative SLOs as multi-window burn rates over
  ``/metrics`` snapshots, and the alert manager behind ``obs health``.
* :mod:`.fleet` — the scrape hub: every daemon's ``/metrics.json`` and
  span tail merged into one fleet snapshot, judged and rendered.
* :mod:`.sentinel` — canary probes through the live scorer, the
  journal tail's supervised drift, and the long-horizon retention ring
  behind ``obs sentinel``.

The span files, metric families, postmortem bundles, Chrome traces,
alerts, fleet snapshots and sentinel reports are the JAX package's
formats: one timeline merges a round whose server and clients come from
either package, and one hub scrapes daemons of both.
"""

from .flight import (  # noqa: F401
    FlightRecorder,
    get_global_recorder,
    list_bundles,
    load_bundle,
    set_global_recorder,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MetricsServer,
    default_registry,
    maybe_start_metrics_server,
)
from .fleet import (  # noqa: F401
    ScrapeHub,
    Target,
    health_verdict,
    parse_target,
)
from .profile import (  # noqa: F401
    FLOPS_RATIO_TOLERANCE,
    CompileLedger,
    StepProfiler,
    counted_flops,
    default_ledger,
    device_memory_stats,
    memory_report,
    note_memory,
    profile_stride,
    render_profile_report,
    run_profile_session,
    set_profile_stride,
)
from .sentinel import (  # noqa: F401
    CanaryFlow,
    CanaryProber,
    JournalTail,
    RetentionRing,
    Sentinel,
    load_canary_flows,
)
from .slo import (  # noqa: F401
    SLO,
    AlertManager,
    default_slos,
    slos_from_spec,
)
from .timeline import (  # noqa: F401
    chrome_trace,
    export_chrome_trace,
    group_rounds,
    load_spans,
    round_breakdown,
    round_summaries,
    tail_spans,
    timeline_table,
)
from .trace import (  # noqa: F401
    META_TRACE,
    SCHEMA,
    SPAN_NAMES,
    Tracer,
    get_global_tracer,
    get_run_id,
    maybe_span,
    new_trace_id,
    set_global_tracer,
)
