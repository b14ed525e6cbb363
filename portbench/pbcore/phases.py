"""Host times of the program's calls, from its own phase records.

The program keeps one record a call at two sites (``obs/profile.py``'s
``phase_records``): ``engine.train_step``, phases ``place``, ``forward``,
``backward``, ``optimizer``; and ``serving.score``, phases ``prep``,
``dispatch``, ``wait``. Stamps are integer ns on the profiler's clock, so
they compare with the traced window's µs directly. A reader takes the
records of the window's untraced part, the part ``mfu.*`` and
``device_idle.*`` divide by: the last ``plain_steps`` records of the site
that end at or before the traced window opens. No profiler runs then.

A program that keeps no records, another mode's window, or a log that
wrapped (fewer records than ``plain_steps``) gives None.
"""

from __future__ import annotations

import statistics
from importlib import import_module

from .harness import PORT

SITES = {"train": "engine.train_step", "score": "serving.score"}


def records(site: str) -> list | None:
    """The program's records of ``site``, oldest first; None where the
    program keeps none."""
    try:
        profile = import_module(PORT + ".obs.profile")
    except ImportError:
        return None
    read = getattr(profile, "phase_records", None)
    return None if read is None else read(site)


def untraced(tl, mode: str) -> list | None:
    """The records of ``mode``'s site in the window's untraced part."""
    if tl is None or tl.extra.get("mode") != mode or not tl.extra.get("plain_steps"):
        return None
    recs = records(SITES[mode])
    if recs is None:
        return None
    t0_ns = tl.t0 * 1e3
    before = [r for r in recs if r.ends_ns[-1] <= t0_ns]
    n = tl.extra["plain_steps"]
    return before[-n:] if len(before) >= n else None


def median_ms(tl, mode: str, phases: tuple[str, ...] | None = None) -> float | None:
    """The median over the untraced records of the named phases' summed
    host time (the whole call where ``phases`` is None), in ms."""
    recs = untraced(tl, mode)
    if not recs:
        return None
    vals = []
    for r in recs:
        bounds = (r.start_ns, *r.ends_ns)
        if phases is None:
            vals.append(bounds[-1] - bounds[0])
        else:
            durs = dict(zip(r.phases, (b - a for a, b in zip(bounds, bounds[1:]))))
            vals.append(sum(durs[p] for p in phases))
    return statistics.median(vals) * 1e-6
