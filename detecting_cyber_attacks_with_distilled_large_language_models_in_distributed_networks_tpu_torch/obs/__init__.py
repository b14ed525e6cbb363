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

The span files, metric families, postmortem bundles and Chrome traces
are the JAX package's formats: one timeline merges a round whose server
and clients come from either package. The JAX package's fleet read side
(``slo``, ``fleet``, ``sentinel``) is not ported.
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
