"""What a driver gets and gives back, and the checks it reports."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .bench import Cell, sub_seed
from .tracing import Timeline, Tracer

PORT = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch"


@dataclass
class Run:
    """One run of one cell."""

    cell: Cell
    seed: int
    seconds: float
    tracer: Tracer
    device: object  # torch.device
    t_start: float  # process start, on time.perf_counter's clock
    #: (stage, seconds since the process started) through set-up.
    marks: list = field(default_factory=list)

    def sub(self, tag: str) -> int:
        return sub_seed(self.seed, tag)

    def mark(self, stage: str) -> float:
        """Note that set-up reached ``stage``; returns the seconds since
        the process started."""
        t = time.perf_counter() - self.t_start
        self.marks.append((stage, t))
        return t


@dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


@dataclass
class Outcome:
    metrics: dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: list[Check]
    timeline: Timeline | None = None
    notes: dict = field(default_factory=dict)
    marks: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


def sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if getattr(device, "type", str(device)) == "cuda" else "cpu"


def memory_peak(device) -> int:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.empty_cache()
