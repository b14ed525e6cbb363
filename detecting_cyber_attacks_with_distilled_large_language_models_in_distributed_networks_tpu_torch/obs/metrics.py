"""In-process metrics registry + stdlib-HTTP ``/metrics`` endpoint (the
port's copy of the JAX package's ``obs/metrics.py``: the same families
render the same text and JSON, so one scraper reads either package).

Counters, gauges, and histograms that server, controller, and infer-serve
update on their hot paths (queue depth, bytes on wire, retries, per-phase
seconds, gate rejections) and expose in Prometheus text exposition format
over a lightweight ``http.server`` endpoint (``--metrics-port``, off by
default). Pure stdlib + a lock — no client library, no background
scrape-state, nothing on the hot path beyond an int/float update under a
lock.

Naming follows Prometheus conventions: ``*_total`` for counters,
``*_seconds``/``_bytes`` units in the name, labels for low-cardinality
partitions (reject kind, round phase). One process-wide
:func:`default_registry` mirrors the Prometheus client-library pattern so
the tiers need no plumbing to share an endpoint; tests build private
:class:`MetricsRegistry` instances.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Mapping

_INF = float("inf")

#: Schema tag on every ``/metrics.json`` body, so the scrape hub can
#: reject (or version-switch on) foreign JSON documents.
SNAPSHOT_SCHEMA = "fedtpu-metrics-v1"


def _parse_label_str(label_str: str) -> dict[str, str]:
    """Invert :func:`_label_str` for snapshot(): the registry memoizes
    children on the rendered label string, so the machine-readable twin
    recovers the mapping from it (values never contain quotes here — the
    registry's own call sites use plain identifiers)."""
    if not label_str:
        return {}
    out: dict[str, str] = {}
    for part in label_str[1:-1].split(","):
        k, _, v = part.partition("=")
        out[k] = v.strip('"')
    return out


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers without the trailing .0."""
    f = float(v)
    if f == _INF:
        return "+Inf"
    if f.is_integer():
        return str(int(f))
    return repr(f)


def _label_str(labels: Mapping[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing value (`*_total`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment {amount} must be >= 0")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Instantaneous value (queue depth, serving round, ...)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` buckets + sum + count)."""

    DEFAULT_BUCKETS = (
        0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
    )

    def __init__(self, buckets: Iterable[float] | None = None) -> None:
        edges = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self._edges = edges
        self._lock = threading.Lock()
        self._counts = [0] * (len(edges) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._n = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            self._n += 1
            for i, edge in enumerate(self._edges):
                if v <= edge:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> tuple[tuple[float, ...], list[int], float, int]:
        with self._lock:
            return self._edges, list(self._counts), self._sum, self._n


class MetricsRegistry:
    """Name -> metric family store with Prometheus text rendering.

    ``counter``/``gauge``/``histogram`` are get-or-create (memoized on
    (name, labels)), so hot paths hold direct metric references and
    re-registration from a second server instance in one process simply
    shares the family — standard client-library semantics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> {"type": ..., "help": ..., "children": {label_str: metric}}
        self._families: dict[str, dict] = {}

    def _get(
        self,
        name: str,
        kind: str,
        help: str,
        labels: Mapping[str, str] | None,
        factory,
    ):
        key = _label_str(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = {"type": kind, "help": help, "children": {}}
                self._families[name] = fam
            elif fam["type"] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam['type']}"
                )
            child = fam["children"].get(key)
            if child is None:
                child = factory()
                fam["children"][key] = child
            return child

    def counter(
        self,
        name: str,
        *,
        help: str = "",
        labels: Mapping[str, str] | None = None,
    ) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(
        self,
        name: str,
        *,
        help: str = "",
        labels: Mapping[str, str] | None = None,
    ) -> Gauge:
        return self._get(name, "gauge", help, labels, Gauge)

    def histogram(
        self,
        name: str,
        *,
        help: str = "",
        labels: Mapping[str, str] | None = None,
        buckets: Iterable[float] | None = None,
    ) -> Histogram:
        return self._get(
            name, "histogram", help, labels, lambda: Histogram(buckets)
        )

    # ------------------------------------------------------------- rendering
    def snapshot(self) -> dict:
        """Machine-readable registry state (the ``/metrics.json`` body and
        the scrape hub's input): one JSON-able dict, no text-format parser
        needed on the consuming side. Histogram buckets are CUMULATIVE
        ``[edge_str, count]`` pairs ending at ``"+Inf"`` — the same
        numbers the Prometheus rendering exposes, so the two endpoints
        can never disagree."""
        with self._lock:
            families = {
                name: (
                    fam["type"],
                    fam["help"],
                    dict(fam["children"]),
                )
                for name, fam in sorted(self._families.items())
            }
        out: dict[str, dict] = {}
        for name, (kind, help_text, children) in families.items():
            samples: list[dict] = []
            for label_str, metric in sorted(children.items()):
                labels = _parse_label_str(label_str)
                if kind == "histogram":
                    edges, counts, total, n = metric.snapshot()
                    cum = 0
                    buckets: list[list] = []
                    for edge, c in zip(edges + (_INF,), counts):
                        cum += c
                        buckets.append([_fmt(edge), cum])
                    samples.append(
                        {
                            "labels": labels,
                            "buckets": buckets,
                            "sum": total,
                            "count": n,
                        }
                    )
                else:
                    samples.append(
                        {"labels": labels, "value": metric.value}
                    )
            out[name] = {"type": kind, "help": help_text, "samples": samples}
        return {"schema": SNAPSHOT_SCHEMA, "families": out}

    def render_json(self) -> str:
        import json

        return json.dumps(self.snapshot())

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            families = {
                name: (
                    fam["type"],
                    fam["help"],
                    dict(fam["children"]),
                )
                for name, fam in sorted(self._families.items())
            }
        for name, (kind, help_text, children) in families.items():
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for label_str, metric in sorted(children.items()):
                if kind == "histogram":
                    edges, counts, total, n = metric.snapshot()
                    base = label_str[1:-1] if label_str else ""
                    cum = 0
                    for edge, c in zip(edges + (_INF,), counts):
                        cum += c
                        le = f'le="{_fmt(edge)}"'
                        inner = f"{base},{le}" if base else le
                        lines.append(
                            f"{name}_bucket{{{inner}}} {cum}"
                        )
                    lines.append(f"{name}_sum{label_str} {_fmt(total)}")
                    lines.append(f"{name}_count{label_str} {n}")
                else:
                    lines.append(
                        f"{name}{label_str} {_fmt(metric.value)}"
                    )
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the tiers record into (the Prometheus
    client-library pattern: no plumbing needed to share one endpoint)."""
    return _DEFAULT


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set per server class below

    def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
        path = self.path.split("?", 1)[0]
        if path == "/metrics.json":
            # The machine-readable twin (obs/fleet.py scrape hub, tests):
            # same numbers as the text rendering, no exposition-format
            # parser needed on the consuming side.
            body = self.registry.render_json().encode()
            ctype = "application/json"
        elif path in ("/metrics", "/"):
            body = self.registry.render().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args) -> None:  # scrapes stay off stdout
        pass


class MetricsServer:
    """``/metrics`` over stdlib ``ThreadingHTTPServer`` on its own daemon
    thread. ``port=0`` binds an ephemeral port (tests); the CLI flag's
    0-means-off convention lives at the call sites, not here."""

    def __init__(
        self,
        port: int,
        *,
        host: str = "0.0.0.0",
        registry: MetricsRegistry | None = None,
    ):
        reg = registry or default_registry()
        handler = type("BoundHandler", (_Handler,), {"registry": reg})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="fedtpu-metrics",
            daemon=True,
        )

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def maybe_start_metrics_server(
    port: int | None, *, host: str = "127.0.0.1"
) -> MetricsServer | None:
    """CLI-facing helper: 0/None = off (the default), else bind + start
    on the default registry. The endpoint is unauthenticated, so the
    default bind is LOOPBACK — call sites that serve a network-facing
    tier pass that tier's explicit --host so the operator's bind choice
    covers the metrics port too, never wider."""
    if not port:
        return None
    return MetricsServer(int(port), host=host).start()
