"""Obs-vocabulary pass: the observability contracts stay closed.

Three cross-cutting vocabularies hold the obs layer together, and all
three are string-matched at runtime with no compiler in the loop:

``obs-span-vocab``
    Every span name emitted through a ``Tracer`` (``tracer.span(...)``,
    ``tracer.record(...)``, ``maybe_span(tracer, ...)``) must be a
    member of ``obs/trace.py``'s ``SPAN_NAMES`` tuple. The timeline
    tool groups by exact name; a typo'd or unregistered span silently
    falls out of every per-round attribution sum the tests pin to 10%
    of wall. The vocabulary is read from the SCANNED tree (not the
    imported package), so a mutated temp copy lints against its own
    contract.

``obs-metric-once``
    Metric families must be coherent: one name = one kind (a counter
    re-registered as a gauge raises at runtime — in whatever process
    first runs both paths), counters follow the ``*_total`` Prometheus
    convention the endpoint documents, and a family is registered from
    exactly one module (two tiers independently minting the same name
    will drift in help text and labels; share it from one place
    instead).

``bench-headline``
    Every headline field bench.py ASSERTS present (the
    ``[k for k in (...) if k not in rec]`` exit-3 pattern) must be
    produced somewhere (a dict-literal key or ``rec[...] =`` store in
    bench.py or the package). An asserted-but-never-produced field
    means the bench exits 3 on every run — this catches the rename
    half-done before a bench run does.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Project, call_name, register, str_const

TRACE_REL = "obs/trace.py"
BENCH_REL = "bench.py"

_METRIC_KINDS = ("counter", "gauge", "histogram")


def _span_vocab(project: Project) -> tuple[frozenset[str], object] | None:
    trace = project.module(TRACE_REL)
    if trace is None or trace.tree is None:
        return None
    for node in trace.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "SPAN_NAMES"
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            names = [str_const(e) for e in node.value.elts]
            if all(n is not None for n in names):
                return frozenset(names), trace
    return None


def _receiver_mentions_trace(func: ast.expr) -> bool:
    """True for ``tracer.span`` / ``self.tracer.record`` — the receiver
    chain's terminal name mentions "trace", which is what separates a
    Tracer call from any other ``.record()``/``.span()`` in the tree."""
    if not isinstance(func, ast.Attribute):
        return False
    recv = func.value
    name = ""
    if isinstance(recv, ast.Attribute):
        name = recv.attr
    elif isinstance(recv, ast.Name):
        name = recv.id
    return "trace" in name.lower()


@register(
    "obs-span-vocab",
    "every literal span name emitted through a Tracer is a member of "
    "obs/trace.py SPAN_NAMES",
)
def check_span_vocab(project: Project) -> Iterator[Finding]:
    got = _span_vocab(project)
    if got is None:
        yield Finding(
            "obs-span-vocab",
            TRACE_REL,
            1,
            "SPAN_NAMES tuple of string literals not found in "
            "obs/trace.py — the span-vocabulary pass has lost its anchor",
        )
        return
    vocab, _trace = got
    for m in project.modules:
        for node in m.walk():
            if not isinstance(node, ast.Call):
                continue
            name_arg: ast.expr | None = None
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "span",
                "record",
            ):
                if _receiver_mentions_trace(node.func) and node.args:
                    name_arg = node.args[0]
            elif call_name(node).rsplit(".", 1)[-1] == "maybe_span":
                if len(node.args) >= 2:
                    name_arg = node.args[1]
            if name_arg is None:
                continue
            span = str_const(name_arg)
            if span is not None and span not in vocab:
                yield Finding(
                    "obs-span-vocab",
                    m.rel,
                    node.lineno,
                    f"span name {span!r} is not in obs/trace.py "
                    "SPAN_NAMES — the timeline tool will drop it from "
                    "every per-round attribution; add it to the "
                    "vocabulary (and the timeline docs) first",
                )


@register(
    "obs-metric-once",
    "metric names keep one kind, counters end _total, and each family "
    "is registered from exactly one module",
)
def check_metric_once(project: Project) -> Iterator[Finding]:
    # name -> {"kind": str, "modules": {rel: first line}}
    families: dict[str, dict] = {}
    registrations: list[tuple[str, str, str, int]] = []  # (name, kind, rel, line)
    for m in project.modules:
        if m.rel.endswith("obs/metrics.py"):
            continue  # the registry's own plumbing
        for node in m.walk():
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_KINDS
                and node.args
            ):
                continue
            name = str_const(node.args[0])
            if name is None:
                continue  # np.histogram(arr, ...) and friends
            registrations.append((name, node.func.attr, m.rel, node.lineno))
    for name, kind, rel, line in registrations:
        fam = families.setdefault(name, {"kind": kind, "modules": {}})
        if fam["kind"] != kind:
            yield Finding(
                "obs-metric-once",
                rel,
                line,
                f"metric {name!r} registered as {kind} here but as "
                f"{fam['kind']} elsewhere — the registry raises on the "
                "second registration at runtime",
            )
            continue
        fam["modules"].setdefault(rel, line)
        if kind == "counter" and not name.endswith("_total"):
            yield Finding(
                "obs-metric-once",
                rel,
                line,
                f"counter {name!r} does not end in '_total' — the "
                "Prometheus convention the /metrics endpoint documents",
            )
    for name, fam in sorted(families.items()):
        if len(fam["modules"]) > 1:
            mods = sorted(fam["modules"])
            rel = mods[1]
            yield Finding(
                "obs-metric-once",
                rel,
                fam["modules"][rel],
                f"metric {name!r} registered from multiple modules "
                f"({', '.join(mods)}) — help text and labels will drift; "
                "register it in one place and share the reference",
            )


@register(
    "bench-headline",
    "every headline field bench.py asserts present is actually "
    "produced by a record builder",
)
def check_bench_headline(project: Project) -> Iterator[Finding]:
    bench = project.module(BENCH_REL)
    if bench is None or bench.tree is None:
        return
    # Asserted: string constants S appearing in an `S not in X` compare
    # (the exit-3 missing-fields pattern) anywhere in bench.py, plus the
    # comprehension form where the iterated tuple holds the candidates.
    asserted: dict[str, int] = {}
    for node in bench.walk():
        if isinstance(node, ast.Compare) and len(node.ops) == 1 and isinstance(
            node.ops[0], ast.NotIn
        ):
            s = str_const(node.left)
            if s is not None:
                asserted.setdefault(s, node.lineno)
        elif isinstance(
            node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)
        ):
            # The `[k for k in (...) if k not in rec]` assert shape: a
            # comprehension over a literal tuple whose filter is NotIn.
            for gen in node.generators:
                if isinstance(gen.iter, (ast.Tuple, ast.List)) and any(
                    isinstance(cond, ast.Compare)
                    and len(cond.ops) == 1
                    and isinstance(cond.ops[0], ast.NotIn)
                    for cond in gen.ifs
                ):
                    for elt in gen.iter.elts:
                        v = str_const(elt)
                        if v is not None:
                            asserted.setdefault(v, elt.lineno)
    if not asserted:
        return
    # Produced: dict-literal keys and `X["k"] = ...` stores, bench.py +
    # package wide (records cross the module boundary via stats()/
    # timeline dicts).
    produced: set[str] = set()
    for m in project.modules:
        for node in m.walk():
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    v = str_const(k) if k is not None else None
                    if v is not None:
                        produced.add(v)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        v = str_const(t.slice)
                        if v is not None:
                            produced.add(v)
    for name, line in sorted(asserted.items()):
        if name not in produced:
            yield Finding(
                "bench-headline",
                bench.rel,
                line,
                f"bench.py asserts headline field {name!r} but nothing "
                "in bench.py or the package produces it — every run "
                "would exit 3 (half-done rename?)",
            )


