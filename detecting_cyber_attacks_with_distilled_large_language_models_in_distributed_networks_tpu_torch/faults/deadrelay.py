"""``dead-relay`` fault plan: a seeded mid-round kill of a fold-tree relay
(the port's copy of the JAX package's ``faults/deadrelay.py``).

A hierarchical fold tree fails a whole subtree when its relay dies;
the survivable-tree work (comm/client.py fallback parents, comm/server.py
adoption + degraded rounds) exists to route around exactly that. This
module is the chaos side of the contract: a :class:`~.proxy.FaultProxy`
fronts the victim relay's subtree port, throttles the children's uploads
so they are genuinely in flight, and — once the cumulative forwarded
upload bytes cross a SEEDED threshold — tears the relay down
(``RelayAggregator.close()``, which sheds every pending child connection
as a prompt explicit failure). The children observe a mid-exchange death
and re-home to their fallback parents; the root completes the round over
the surviving subtrees.

Everything is deterministic under ``seed``: the kill threshold derives
from ``crc32(repr(("dead-relay", seed)))`` (the proxy layer's keying
convention), and the throttle makes the byte clock coarse enough that
the kill always lands mid-upload for payloads larger than the window's
upper edge.
"""

from __future__ import annotations

import random
import threading
import zlib

import logging
from .proxy import FaultProxy, FaultSpec

log = logging.getLogger(__name__)


def wait_registered(server, ids, *, timeout: float) -> bool:
    """Block until every id in ``ids`` has an upload registered in
    ``server``'s current round (or ``timeout`` passes). The chaos
    harnesses' adoption gate — a deterministic ordering point that keeps
    the adoptive relay's round open through the adoption window without
    each harness poking the server's round state itself. Returns whether
    the ids all registered."""
    import time

    want = {int(i) for i in ids}
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rnd = server._cur_rnd
        if rnd is not None:
            with rnd.lock:
                have = set(rnd.done)
            if want <= have:
                return True
        time.sleep(0.05)
    return False


class DeadRelayFault:
    """Kill ``relay`` once its children's uploads (through the fronting
    proxy) have moved a seeded number of bytes.

    Children must dial ``(fault.host, fault.port)`` instead of the relay
    itself; their fallback parents are dialed directly (the re-home path
    is already the failure path). ``close()`` tears the proxy down; the
    relay is only closed by the trigger (or by the caller)."""

    def __init__(
        self,
        relay,
        *,
        seed: int = 0,
        kill_window: tuple[int, int] = (4 << 10, 16 << 10),
        throttle_bps: float = 512_000.0,
        relay_host: str = "127.0.0.1",
        host: str = "127.0.0.1",
    ):
        if not 0 < kill_window[0] < kill_window[1]:
            raise ValueError(f"bad kill_window {kill_window}")
        rng = random.Random(
            zlib.crc32(repr(("dead-relay", seed)).encode("utf-8"))
        )
        #: The seeded byte threshold: same seed, same kill point.
        self.kill_after_bytes = rng.randrange(*kill_window)
        self.relay = relay
        self._lock = threading.Lock()
        self._forwarded = 0
        self.killed = threading.Event()
        # Throttled pass-through: the children's uploads must still be
        # in flight when the threshold crosses, or the "mid-round" kill
        # would land between rounds and test nothing.
        self.proxy = FaultProxy(
            relay_host,
            relay.port,
            plan=FaultSpec(throttle_bps=throttle_bps),
            seed=seed,
            host=host,
            on_forward=self._on_forward,
        )
        self.host, self.port = self.proxy.host, self.proxy.port

    # ------------------------------------------------------------ trigger
    def _on_forward(self, conn_index: int, nbytes: int) -> None:
        with self._lock:
            self._forwarded += nbytes
            fire = (
                self._forwarded >= self.kill_after_bytes
                and not self.killed.is_set()
            )
            if fire:
                self.killed.set()
        if fire:
            # Off the pump thread: close() joins handler state and must
            # not deadlock the very connection that pulled the trigger.
            threading.Thread(target=self._kill, daemon=True).start()

    def _kill(self) -> None:
        log.warning(
            f"[DEAD-RELAY] killing relay {self.relay.relay_id} after "
            f"{self.kill_after_bytes} forwarded upload byte(s) "
            "(seeded mid-round kill)"
        )
        self.relay.close()

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        self.proxy.close()

    def __enter__(self) -> "DeadRelayFault":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
