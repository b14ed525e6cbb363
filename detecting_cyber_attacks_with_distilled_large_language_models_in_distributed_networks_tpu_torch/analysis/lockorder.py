"""Runtime lock-order cycle detector — the dynamic half of the
concurrency pass.

The static pass (:mod:`analysis.thread_rules`) says where a lock is
missing; this module says when the locks you DO hold can deadlock. It
wraps ``threading.Lock``/``threading.RLock`` so every successful
acquire records an edge ``held-lock -> acquired-lock`` in a global
digraph over lock INSTANCES (monotonic uids, never recycled). A cycle
in that graph means two threads took the same two locks in opposite
orders: the classic ABBA deadlock, latent until the interleaving is
unlucky — exactly the class a 256-client round flushes out in
production and a unit test never does. Instances — not creation sites
— are the nodes on purpose: one line can create several distinct locks
(CPython's ``ThreadPoolExecutor.__init__`` makes ``_shutdown_lock``
and the idle semaphore's inner lock back to back, and ``submit``
chains shutdown→global→semaphore), and a site-aggregated graph reports
that as a cycle no real schedule can deadlock on. For the REPORT,
edges and cycles are rendered by creation site (``file:line``) — the
human-actionable identity.

Armed by chip_smoke.py's ``check`` phase over a full-width TCP round
and a router loop on the card (it fails on any cycle), and by
tests/test_torch_check.py. By default only locks created by the port's
package are tracked — the factory
walks a few stack frames and hands stdlib-internal creations the
original primitive untouched, so the interpreter's own locking stays
invisible and free.

Same-site NESTING (holding one instance while acquiring another from
the same creation line — per-round locks, per-client locks) is
additionally counted in ``same_site_edges``: consistent-order nesting
is often ordered by construction (ascending client id) and only a
human can tell, so it is surfaced, not failed. If two same-site
instances are ever taken in OPPOSITE orders, that is an instance-level
cycle like any other and fails the session.

Standalone use (tests, notebooks)::

    det = LockOrderDetector()
    a, b = det.lock("a"), det.lock("b")
    ... acquire in both orders from two threads ...
    assert det.report().cycles
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from dataclasses import dataclass, field

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
#: Default tracked tree: the package directory (lockorder's parent's
#: parent is the package root).
PACKAGE_DIR = os.path.dirname(_THIS_DIR)


@dataclass
class LockOrderReport:
    """Session summary: the acquisition-order digraph + its analysis."""

    edges: dict[tuple[str, str], int] = field(default_factory=dict)
    #: site -> how many tracked lock instances were created there
    sites: dict[str, int] = field(default_factory=dict)
    cycles: list[list[str]] = field(default_factory=list)
    same_site_edges: dict[str, int] = field(default_factory=dict)
    acquisitions: int = 0

    def render(self) -> str:
        lines = [
            f"lock-order: {len(self.sites)} tracked site(s), "
            f"{self.acquisitions} acquisition(s), "
            f"{len(self.edges)} order edge(s)"
        ]
        for cyc in self.cycles:
            lines.append(
                "  CYCLE (ABBA deadlock risk): " + " -> ".join(cyc + cyc[:1])
            )
        for site, n in sorted(self.same_site_edges.items()):
            lines.append(
                f"  same-site nesting at {site} ({n}x) — safe only if "
                "instances are acquired in a pinned order"
            )
        return "\n".join(lines)


class LockOrderDetector:
    """Collects acquisition-order edges from :class:`_TrackedLock`s.

    Edges are recorded between lock INSTANCES (monotonic uids — never
    recycled, unlike ``id()``), and only aggregated up to creation
    sites for display. Site-level cycle detection would invent ABBA
    where none exists: one creation line can host several distinct
    locks (CPython's own ``ThreadPoolExecutor.__init__`` makes
    ``_shutdown_lock`` AND the idle semaphore's inner lock on adjacent
    lines; ``submit`` orders shutdown→global→semaphore — a site-graph
    "cycle" spanning three different locks that can never deadlock).
    An instance-level cycle IS a real opposite-order proof, including
    between same-site instances (two rounds' locks taken in reversed
    orders), so those fail too."""

    def __init__(self) -> None:
        # Guards the dicts below. The interpreter's primitive, never the
        # factory another armed detector may have patched in.
        self._graph_lock = _thread.allocate_lock()
        self._edges: dict[tuple[int, int], int] = {}  # uid digraph
        self._uid_site: dict[int, str] = {}
        self._sites: dict[str, int] = {}
        self._same_site: dict[str, int] = {}
        self._acquisitions = 0
        self._next_uid = 0
        # Held stacks keyed by thread id, NOT threading.local: a
        # threading.Lock may legally be released by a different thread
        # than its acquirer (handoff patterns), and a thread-local
        # stack would keep the stale entry forever — every later
        # acquire in the acquirer's thread would then record phantom
        # edges, and one matching reverse edge turns into a fabricated
        # ABBA cycle failing the session.
        self._held_by_thread: dict[int, list] = {}

    # ---------------------------------------------------------- construction
    def lock(self, site: str | None = None):
        """A tracked ``threading.Lock`` (tests name the site). It wraps
        the interpreter's primitive, so a detector armed around this one
        (the JAX package's, in the test session) never sees it."""
        return _TrackedLock(self, _thread.allocate_lock, site or _caller_site())

    def rlock(self, site: str | None = None):
        return _TrackedLock(self, _thread.RLock, site or _caller_site())

    def _register(self, site: str) -> int:
        with self._graph_lock:
            self._sites[site] = self._sites.get(site, 0) + 1
            self._next_uid += 1
            self._uid_site[self._next_uid] = site
            return self._next_uid

    # ------------------------------------------------------------- recording
    def _on_acquired(self, lock: "_TrackedLock", *, record_edges: bool) -> None:
        tid = threading.get_ident()
        with self._graph_lock:
            held = self._held_by_thread.setdefault(tid, [])
            reentrant = any(entry[0] is lock for entry in held)
            if record_edges and not reentrant:
                self._acquisitions += 1
                for prior, prior_site in held:
                    if prior is lock:
                        continue
                    key = (prior.uid, lock.uid)
                    self._edges[key] = self._edges.get(key, 0) + 1
                    if prior_site == lock.site:
                        self._same_site[lock.site] = (
                            self._same_site.get(lock.site, 0) + 1
                        )
            held.append((lock, lock.site))

    def _on_released(self, lock: "_TrackedLock") -> None:
        tid = threading.get_ident()
        with self._graph_lock:
            # The releasing thread's stack first (the overwhelmingly
            # common case), then every other thread's — a cross-thread
            # release must clear the ACQUIRER's entry or it pollutes
            # that thread's ordering context forever.
            stacks = [tid] + [t for t in self._held_by_thread if t != tid]
            for t in stacks:
                held = self._held_by_thread.get(t)
                if not held:
                    continue
                for i in range(len(held) - 1, -1, -1):
                    if held[i][0] is lock:
                        del held[i]
                        if not held:
                            del self._held_by_thread[t]
                        return

    # --------------------------------------------------------------- analysis
    def report(self) -> LockOrderReport:
        with self._graph_lock:
            uid_edges = dict(self._edges)
            uid_site = dict(self._uid_site)
            sites = dict(self._sites)
            same = dict(self._same_site)
            acq = self._acquisitions
        site_edges: dict[tuple[str, str], int] = {}
        for (a, b), n in uid_edges.items():
            key = (uid_site[a], uid_site[b])
            site_edges[key] = site_edges.get(key, 0) + n
        cycles = [
            [uid_site[u] for u in cyc] for cyc in _find_cycles(uid_edges)
        ]
        return LockOrderReport(
            edges=site_edges,
            sites=sites,
            cycles=cycles,
            same_site_edges=same,
            acquisitions=acq,
        )


def _find_cycles(edges: dict[tuple[int, int], int]) -> list[list[int]]:
    """Strongly connected components with >1 node (Tarjan, iterative)
    over the lock-INSTANCE digraph. Self-edges never exist (reentrant
    acquires are filtered), so every multi-node SCC is a genuine
    opposite-order cycle."""
    adj: dict[int, list[int]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    index: dict[int, int] = {}
    low: dict[int, int] = {}
    on_stack: set[int] = set()
    stack: list[int] = []
    counter = [0]
    sccs: list[list[int]] = []

    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(adj[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(adj[nxt])))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))
    return sccs


class _TrackedLock:
    """Lock/RLock wrapper feeding a :class:`LockOrderDetector`.

    Implements the ``Condition`` interplay surface explicitly
    (``_release_save``/``_acquire_restore``/``_is_owned``) so a
    ``Condition.wait`` keeps the held-stack accurate: the save pops,
    the restore pushes WITHOUT recording edges (a post-wait re-acquire
    is a scheduling event, not an ordering decision)."""

    def __init__(self, detector: LockOrderDetector, factory, site: str):
        self._inner = factory()
        self._det = detector
        self.site = site
        self.uid = detector._register(site)

    # ------------------------------------------------------------- lock API
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._det._on_acquired(self, record_edges=True)
        return got

    def release(self) -> None:
        self._inner.release()
        self._det._on_released(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # --------------------------------------------- Condition interplay (RLock)
    def __getattr__(self, name: str):
        # ``Condition.__init__`` binds ``_release_save``/
        # ``_acquire_restore``/``_is_owned`` via attribute access inside
        # try/except AttributeError — a plain Lock must NOT expose them
        # (the fallback path uses acquire/release, which we track), so
        # they are resolved dynamically: present exactly when the inner
        # primitive has them, wrapped to keep the held-stack accurate
        # across a wait (the restore records no edges — a post-wait
        # re-acquire is a scheduling event, not an ordering decision).
        if name == "_release_save":
            inner = self._inner._release_save  # AttributeError on Lock

            def _release_save():
                state = inner()
                self._det._on_released(self)
                return state

            return _release_save
        if name == "_acquire_restore":
            inner = self._inner._acquire_restore

            def _acquire_restore(state):
                inner(state)
                self._det._on_acquired(self, record_edges=False)

            return _acquire_restore
        # Everything else (``_is_owned``, ``_at_fork_reinit``, future
        # internals) delegates straight to the wrapped primitive.
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<TrackedLock site={self.site} {self._inner!r}>"


# --------------------------------------------------------------- global arm
_ARMED: dict | None = None


def _caller_site() -> str:
    """First stack frame outside this module, as ``relpath:lineno``."""
    frame = sys._getframe(1)
    for _ in range(24):
        if frame is None:
            break
        fn = frame.f_code.co_filename
        if fn != __file__:
            return f"{_relsite(fn)}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>:0"


def _relsite(path: str) -> str:
    root = os.path.dirname(PACKAGE_DIR)
    try:
        return os.path.relpath(path, root).replace(os.sep, "/")
    except ValueError:
        return path


def _repo_site(paths: tuple[str, ...]) -> str | None:
    """Nearest stack frame inside one of ``paths`` (skipping this
    module), or None — the factory's tracked/untracked decision. The
    walk looks THROUGH stdlib frames (dataclasses ``default_factory``,
    ``queue.Queue.__init__``) so locks the repo creates indirectly are
    still attributed to the repo line that caused them."""
    frame = sys._getframe(2)
    for _ in range(16):
        if frame is None:
            return None
        fn = frame.f_code.co_filename
        if fn != __file__ and any(fn.startswith(p) for p in paths):
            return f"{_relsite(fn)}:{frame.f_lineno}"
        frame = frame.f_back
    return None


def arm(paths: tuple[str, ...] | None = None) -> LockOrderDetector:
    """Patch ``threading.Lock``/``RLock`` with tracked factories for
    locks created (directly or transitively) by code under ``paths``
    (default: the port's package). Idempotent; :func:`disarm` restores.
    A tracked lock wraps what the factories were at arming time: inside
    an armed JAX detector (the test session's), a JAX tracked lock.
    """
    global _ARMED
    if _ARMED is not None:
        return _ARMED["detector"]
    det = LockOrderDetector()
    tracked_paths = tuple(paths) if paths else (PACKAGE_DIR,)
    orig_lock, orig_rlock = threading.Lock, threading.RLock

    def make_lock():  # noqa: ANN202 - threading factory signature
        site = _repo_site(tracked_paths)
        if site is None:
            return orig_lock()
        return _TrackedLock(det, orig_lock, site)

    def make_rlock():
        site = _repo_site(tracked_paths)
        if site is None:
            return orig_rlock()
        return _TrackedLock(det, orig_rlock, site)

    threading.Lock = make_lock
    threading.RLock = make_rlock
    _ARMED = {
        "detector": det,
        "orig": (orig_lock, orig_rlock),
    }
    return det


def disarm() -> LockOrderReport | None:
    """Restore the original factories and return the session report
    (None when not armed)."""
    global _ARMED
    if _ARMED is None:
        return None
    threading.Lock, threading.RLock = _ARMED["orig"]
    det = _ARMED["detector"]
    _ARMED = None
    return det.report()


def armed_detector() -> LockOrderDetector | None:
    return _ARMED["detector"] if _ARMED is not None else None
