"""Concurrency pass: cross-thread attribute writes need a held lock.

The threaded tiers (aggregation server + upload pool, serving scorer /
reader / writer threads, fault proxy, relay) share instance state
between a thread target and the methods other threads call. The GIL
makes single bytecodes atomic, not read-modify-writes: ``self.n += 1``
from two threads loses increments, ``self.d[k] += v`` likewise. The
pass encodes the house rule:

    An attribute written both from a ``threading.Thread`` /
    ``ThreadPoolExecutor`` target (or anything those targets call) and
    from any other method must have every write under a held lock, or
    carry ``# fedtpu: allow(unguarded): <reason>``.

Additionally, a read-modify-write (``+=``-style, attribute or
subscript) inside a method that runs CONCURRENTLY WITH ITSELF — a pool
``submit`` target, or a Thread target spawned inside a loop — is
flagged even with no second writer: N copies of the same method are
already a race.

What counts as "guarded": the write is lexically inside a ``with``
whose context expression's terminal name contains ``lock`` (``with
self._lock:``, ``with rnd.lock:``). What never counts as shared state:
attributes assigned a synchronization/queue object in ``__init__``
(Lock/RLock/Event/Condition/Semaphore/Queue/ThreadPoolExecutor) — they
synchronize themselves — and ``__init__`` writes themselves
(construction happens-before thread start).

Static limits, by design: guards are recognized lexically (a helper
that documents "caller holds the lock" needs a pragma), and reads are
not tracked (stale reads are real but drown the signal). The runtime
lock-order detector (:mod:`analysis.lockorder`) is the dynamic
complement: this pass says where a lock is missing, that one says when
the locks you do hold can deadlock.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Project, call_name, register, self_attr

RULE = "unguarded"

_SYNC_CTORS = frozenset(
    {
        "Lock",
        "RLock",
        "Event",
        "Condition",
        "Semaphore",
        "BoundedSemaphore",
        "Barrier",
        "Queue",
        "LifoQueue",
        "PriorityQueue",
        "SimpleQueue",
        "ThreadPoolExecutor",
    }
)

#: Method calls that mutate their receiver — a shared list/dict/set
#: mutated cross-thread races exactly like an assignment.
_MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "add",
        "update",
        "extend",
        "insert",
        "remove",
        "discard",
        "clear",
        "setdefault",
    }
)

_SPAWN_CALLS = ("Thread", "Timer")


class _Write:
    __slots__ = ("attr", "line", "method", "guarded", "rmw")

    def __init__(self, attr, line, method, guarded, rmw):
        self.attr = attr
        self.line = line
        self.method = method
        self.guarded = guarded
        self.rmw = rmw  # read-modify-write (augmented assignment)


class _ClassScan(ast.NodeVisitor):
    """Collect, for one class: self-attribute writes (with lexical
    lock-guard state), the self-method call graph, thread-entry
    methods, and which entries run concurrently with themselves."""

    def __init__(self):
        self.methods: set[str] = set()
        self.writes: list[_Write] = []
        self.calls: dict[str, set[str]] = {}
        self.entries: set[str] = set()
        self.concurrent_entries: set[str] = set()
        self.sync_attrs: set[str] = set()
        self._method: str | None = None
        self._guard_depth = 0
        self._loop_depth = 0

    # ------------------------------------------------------------- structure
    def scan(self, cls: ast.ClassDef) -> "_ClassScan":
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods.add(node.name)
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._method = node.name
                self.calls.setdefault(node.name, set())
                for stmt in node.body:
                    self.visit(stmt)
                self._method = None
        return self

    # ------------------------------------------------------------ traversal
    def visit_With(self, node: ast.With) -> None:
        guarded = any(
            self._is_lock_expr(item.context_expr) for item in node.items
        )
        if guarded:
            self._guard_depth += 1
        self.generic_visit(node)
        if guarded:
            self._guard_depth -= 1

    def _loop(self, node) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = visit_AsyncFor = visit_While = _loop

    @staticmethod
    def _is_lock_expr(expr: ast.expr) -> bool:
        # `with self._lock:` / `with rnd.lock:` / bare `with lock:` —
        # the terminal name mentioning "lock" is the recognized guard.
        name = None
        if isinstance(expr, ast.Attribute):
            name = expr.attr
        elif isinstance(expr, ast.Name):
            name = expr.id
        elif isinstance(expr, ast.Call):
            # `with self._lock.acquire_timeout(...)` style helpers.
            return _ClassScan._is_lock_expr(expr.func)
        return name is not None and "lock" in name.lower()

    # --------------------------------------------------------------- writes
    def _record_target(self, target: ast.expr, rmw: bool) -> None:
        attr = self_attr(target)
        if attr is None and isinstance(target, ast.Subscript):
            attr = self_attr(target.value)
        if attr is None or self._method is None:
            return
        self.writes.append(
            _Write(attr, target.lineno, self._method, self._guard_depth > 0, rmw)
        )

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            targets = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for tt in targets:
                self._record_target(tt, rmw=False)
        if self._method == "__init__":
            self._note_sync_attr(node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target, rmw=True)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target, rmw=False)
        self.generic_visit(node)

    def _note_sync_attr(self, node: ast.Assign) -> None:
        if not isinstance(node.value, ast.Call):
            return
        ctor = call_name(node.value).rsplit(".", 1)[-1]
        if ctor in _SYNC_CTORS:
            for t in node.targets:
                attr = self_attr(t)
                if attr:
                    self.sync_attrs.add(attr)

    # ---------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call) -> None:
        if self._method is not None:
            callee = self_attr(node.func)
            if callee is not None:
                self.calls.setdefault(self._method, set()).add(callee)
            # Mutating method call on a self attribute == a write.
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS
            ):
                attr = self_attr(node.func.value)
                if attr is not None:
                    self.writes.append(
                        _Write(
                            attr,
                            node.lineno,
                            self._method,
                            self._guard_depth > 0,
                            False,
                        )
                    )
        target = call_name(node)
        tail = target.rsplit(".", 1)[-1]
        if tail in _SPAWN_CALLS or tail == "submit":
            spawned = self._spawned_methods(node)
            self.entries.update(spawned)
            if tail == "submit" or self._loop_depth > 0:
                # Pool targets and loop-spawned threads run concurrently
                # with themselves.
                self.concurrent_entries.update(spawned)
        self.generic_visit(node)

    def _spawned_methods(self, call: ast.Call) -> set[str]:
        """``self.X`` references anywhere in a Thread(...)/submit(...)
        call's arguments that name a method of this class — including
        through a lambda target."""
        out: set[str] = set()
        for sub in ast.walk(call):
            if sub is call.func:
                continue
            attr = self_attr(sub)
            if attr in self.methods:
                out.add(attr)
        return out


def _thread_side(scan: _ClassScan) -> set[str]:
    """Entry methods plus everything reachable from them through
    self-method calls."""
    seen: set[str] = set()
    frontier = list(scan.entries)
    while frontier:
        m = frontier.pop()
        if m in seen:
            continue
        seen.add(m)
        frontier.extend(scan.calls.get(m, ()))
    return seen


def _concurrent_side(scan: _ClassScan) -> set[str]:
    seen: set[str] = set()
    frontier = list(scan.concurrent_entries)
    while frontier:
        m = frontier.pop()
        if m in seen:
            continue
        seen.add(m)
        frontier.extend(scan.calls.get(m, ()))
    return seen


@register(
    RULE,
    "attributes written both from a thread target and another method "
    "must hold a lock; pool-concurrent read-modify-writes likewise",
)
def check_unguarded(project: Project) -> Iterator[Finding]:
    for m in project.modules:
        if m.tree is None:
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            scan = _ClassScan().scan(node)
            if not scan.entries:
                continue
            thread_side = _thread_side(scan)
            concurrent = _concurrent_side(scan)
            writes = [
                w
                for w in scan.writes
                if w.method not in ("__init__", "__new__")
                and w.attr not in scan.sync_attrs
            ]
            by_attr: dict[str, list[_Write]] = {}
            for w in writes:
                by_attr.setdefault(w.attr, []).append(w)
            for attr, ws in sorted(by_attr.items()):
                thread_writers = {w.method for w in ws if w.method in thread_side}
                other_writers = {
                    w.method for w in ws if w.method not in thread_side
                }
                cross = bool(thread_writers) and bool(
                    other_writers or len(thread_writers) > 1
                )
                for w in ws:
                    if w.guarded:
                        continue
                    if cross and w.method in thread_side | other_writers:
                        peers = sorted(
                            (thread_writers | other_writers) - {w.method}
                        ) or sorted(thread_writers)
                        yield Finding(
                            RULE,
                            m.rel,
                            w.line,
                            f"{node.name}.{attr} written without a held "
                            f"lock in {w.method}() while also written via "
                            f"{', '.join(p + '()' for p in peers)} on the "
                            "thread-target path",
                        )
                    elif w.rmw and w.method in concurrent:
                        yield Finding(
                            RULE,
                            m.rel,
                            w.line,
                            f"{node.name}.{attr} read-modify-write without "
                            f"a held lock in {w.method}(), which runs "
                            "concurrently with itself on the pool/thread "
                            "fan-out",
                        )
