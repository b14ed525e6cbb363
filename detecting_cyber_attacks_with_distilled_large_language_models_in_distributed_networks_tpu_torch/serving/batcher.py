"""Dynamic micro-batcher: bounded admission + gather-window coalescing.

The port's copy of the JAX package's ``serving/batcher.py``. Host-side
only: connection threads ``submit()`` tokenized
requests; the single scorer thread pulls coalesced lists with
``next_batch()``. Two decisions live here and nowhere else:

* **Admission control.** The queue is bounded. A submit against a full
  queue fails immediately — the caller answers with the explicit reject
  frame — so overload degrades to fast, honest 503s instead of a latency
  cliff (the FL-server hot-path lesson of arXiv:2307.06561: backpressure
  must be designed in, not discovered).
* **Coalescing.** ``next_batch`` blocks for the first request, then keeps
  gathering until either ``max_batch`` requests are in hand or the
  ``gather_window`` since the first request elapses. Concurrent clients
  land in one padded bucket dispatch; a lone request pays at most the
  window (default a few ms) on top of its own score time.

Deadline bookkeeping rides each request (``expired()``); enforcement is
the scorer's job — it holds the moment closest to dispatch.
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class ScoreRequest:
    """One tokenized flow awaiting a scorer slot.

    ``reply``/``reject`` are bound by the connection handler to its
    socket (with the per-connection write lock closed over); the scorer
    never touches sockets directly."""

    req_id: int
    input_ids: Any  # np.int32 [L]
    attention_mask: Any  # np.int32 [L]
    reply: Callable[..., None]
    reject: Callable[[int, str], None]
    deadline_s: float | None = None  # relative budget from t_enqueue
    #: Optional trace id the request carried; echoed in the reply.
    trace: str | None = None
    t_enqueue: float = field(default_factory=time.monotonic)

    def expired(self, now: float | None = None) -> bool:
        if self.deadline_s is None:
            return False
        return (time.monotonic() if now is None else now) >= (
            self.t_enqueue + self.deadline_s
        )


class MicroBatcher:
    """Bounded queue + gather-window coalescing (see module docstring)."""

    def __init__(
        self,
        *,
        max_batch: int = 128,
        max_queue: int = 1024,
        gather_window_s: float = 0.005,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        if max_queue < max_batch:
            # A queue smaller than one batch could never fill a bucket.
            raise ValueError(
                f"max_queue={max_queue} must be >= max_batch={max_batch}"
            )
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.gather_window_s = float(gather_window_s)
        self._q: queue.Queue[ScoreRequest] = queue.Queue(maxsize=max_queue)

    def submit(self, req: ScoreRequest) -> bool:
        """Admit a request. False = queue full (caller sends the 503-style
        reject); never blocks the connection thread."""
        try:
            self._q.put_nowait(req)
            return True
        except queue.Full:
            return False

    def next_batch(self, timeout: float | None = 0.1) -> list[ScoreRequest]:
        """Blocking coalesce: wait up to ``timeout`` for the first request
        (empty list on timeout — the scorer's idle tick, where reload
        polls happen), then gather until ``max_batch`` or the window
        closes. The window is anchored at the FIRST request so a steady
        trickle cannot stall a batch indefinitely."""
        try:
            first = self._q.get(timeout=timeout)
        except queue.Empty:
            return []
        batch = [first]
        window_end = time.monotonic() + self.gather_window_s
        while len(batch) < self.max_batch:
            remaining = window_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch
