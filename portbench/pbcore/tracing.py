"""The traced window: the harness's own ranges, the profiler's device
operations, and the reductions the per-layer readers take from them.

With ``--trace 1`` a driver opens ``torch.profiler`` over the last part
of its measured window, between two ``torch.cuda.synchronize()`` calls,
inside the range ``portbench.window``, and wraps each thing it does in a
``record_function`` range of its own (``portbench.fetch``,
``portbench.train_step``, ``portbench.score``, ``portbench.record``).
:class:`Timeline` holds what the profiler saw in that range:

* device operations (kernels, copies, sets) with their start and end;
* the device-side copies of ``record_function`` ranges, the harness's and
  any the program opens (``device_ranges``): the profiler marks them as
  user annotations, and they are kept apart by that mark, whatever their
  name, since each spans its range's kernels and the gaps between them
  and is no operation of the device;
* the harness's ranges and the host operations under them, which label
  each idle gap of the device by what the host was doing then.

Kernel categories are a frozen copy of ``chip_profile.py``'s, by kernel
name, first match wins.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

#: Kernel-name fragments -> category, first match wins.
CATEGORIES = (
    ("K1 flash_fwd", ("flash_fwd",)),
    ("K2 flash_dkdv", ("flash_dkdv",)),
    ("K3 flash_dq", ("flash_dq",)),
    ("K4 fold", ("fold_",)),
    ("optimizer", ("foreach", "multi_tensor", "MultiTensor")),
    ("dropout rng", ("philox", "distribution", "uniform", "random")),
    ("hash mask", ("bitwise", "shift")),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("softmax", ("softmax", "SoftMax")),
    ("copy/cast", ("copy", "Memcpy", "memcpy", "cat", "Cat")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "gelu")),
)

RANGE_PREFIX = "portbench."
WINDOW = "portbench.window"


def category(name: str) -> str:
    for cat, frags in CATEGORIES:
        if any(f in name for f in frags):
            return cat
    return "other"


Span = tuple[str, float, float]  # name, start µs, end µs
DeviceEvent = tuple[str, float, float, bool]  # name, start µs, end µs, a range's device-side copy


def _union(spans) -> list[tuple[float, float]]:
    """The intervals of ``(name, start, end)`` spans, merged."""
    out: list[list[float]] = []
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Timeline:
    """One traced window. Times in µs on the profiler's clock."""

    t0: float
    t1: float
    device: list[Span]
    host: list[Span]
    cpu: list[Span]
    extra: dict = field(default_factory=dict)
    device_ranges: list[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(e - s for s, e in _union(self.device)) * 1e-6

    def busy_in(self, prefix: str) -> float:
        """Seconds in which some device operation ran inside the device-side
        copy of a range whose name starts with ``prefix``."""
        inside = _union(r for r in self.device_ranges if r[0].startswith(prefix))
        busy, i, total = _union(self.device), 0, 0.0
        for s, e in inside:
            while i < len(busy) and busy[i][1] <= s:
                i += 1
            j = i
            while j < len(busy) and busy[j][0] < e:
                total += min(e, busy[j][1]) - max(s, busy[j][0])
                j += 1
        return total * 1e-6

    def kernel(self, fragment: str) -> tuple[float, int]:
        """(device seconds, launches) of the operations whose name holds
        ``fragment``."""
        durs = [e - s for n, s, e in self.device if fragment in n]
        return sum(durs) * 1e-6, len(durs)

    def categories(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for n, s, e in self.device:
            c = category(n)
            out[c] = out.get(c, 0.0) + (e - s) * 1e-6
        return out

    def top_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time, summed by name."""
        by: dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v] for k, v in top]

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals of the device inside the window."""
        out, t = [], self.t0
        for s, e in _union(self.device):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def _innermost(self, spans: list[Span], at: float) -> str | None:
        best = None
        for name, s, e in spans:
            if s <= at <= e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else None

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The longest idle gaps, each labelled by the harness range and
        the host operation under way at its midpoint."""
        top = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        out = []
        for s, e in top:
            mid = 0.5 * (s + e)
            label = self._innermost(self.host, mid) or "outside any range"
            op = self._innermost(self.cpu, mid)
            out.append([f"{label}/{_short(op)}" if op else label, (e - s) * 1e-6])
        return out


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def _spans(prof) -> tuple[list[DeviceEvent], list[Span]]:
    """(device events, each marked whether the profiler made it as a
    user range's device-side copy; host operations) of a finished
    profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev: list[DeviceEvent] = []
    host: list[Span] = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for e in results.events():
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
            else:
                s, d = float(e.start_us()), float(e.duration_us())
            if e.device_type() == cuda:
                dev.append((e.name(), s, s + d, bool(e.is_user_annotation())))
            else:
                host.append((e.name(), s, s + d))
    else:
        for e in prof.events():
            s, t = float(e.time_range.start), float(e.time_range.end)
            if e.device_type == cuda:
                dev.append((e.name, s, t, bool(e.is_user_annotation)))
            else:
                host.append((e.name, s, t))
    return dev, host


def timeline_from_spans(dev: list[DeviceEvent], host: list[Span], extra: dict | None = None) -> Timeline:
    """Cut the profile down to the window range: device operations and the
    ranges' device-side copies, apart, clipped to it; harness ranges and
    host operations that overlap it."""
    windows = [(s, e) for n, s, e in host if n == WINDOW]
    if not windows:
        raise RuntimeError("the profile holds no portbench.window range")
    t0, t1 = windows[0]
    device: list[Span] = []
    device_ranges: list[Span] = []
    for n, s, e, is_range in dev:
        if e > t0 and s < t1 and e > s:
            (device_ranges if is_range else device).append((n, max(s, t0), min(e, t1)))
    ranges = [x for x in host if x[0].startswith(RANGE_PREFIX) and x[0] != WINDOW and x[2] > t0 and x[1] < t1]
    cpu = [x for x in host if not x[0].startswith(RANGE_PREFIX) and x[2] > t0 and x[1] < t1]
    return Timeline(t0, t1, device, ranges, cpu, dict(extra or {}), device_ranges)


class Tracer:
    """``record_function`` ranges and one profiled window, when on."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.timeline: Timeline | None = None

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(RANGE_PREFIX + name)

    @contextlib.contextmanager
    def window(self, sync):
        """Profile the block as the window range; ``sync`` waits for the
        device before it opens and before it closes. A no-op when off."""
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            sync()
            with record_function(WINDOW):
                yield
                sync()
        self.timeline = timeline_from_spans(*_spans(prof))


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks, as numpy's default."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    i = int(pos)
    j = min(i + 1, len(xs) - 1)
    return xs[i] + (xs[j] - xs[i]) * (pos - i)

