"""Client personas: named misbehavior profiles for the real TCP tier (the
port's copy of the JAX package's ``faults/personas.py``).

A persona combines CLIENT-side behavior (train fewer steps, sit rounds
out) with a WIRE-side fault plan (delay/throttle/reset, executed by
:class:`~.proxy.FaultProxy` against the live server). The profiles are
the heterogeneous-client regimes the reference never exercised
(TurboSVM-FL's lazy clients, arXiv:2401.12012; the straggler/dropout
rows of the communication survey, arXiv:2405.20431):

=============  ====================================================
``honest``     the well-behaved baseline (no faults)
``lazy``       trains a fraction of the normal local steps, uploads
               on time (an under-resourced client)
``slow``       full training, but the upload crawls through a
               throttled, delayed link (the straggler)
``intermittent`` dies mid-upload on the FIRST connection of every
               exchange, then retries clean (a flapping host; the
               retry path must converge)
``stale``      sits out every second round entirely, then rejoins
               with whatever it last held (a sometimes-offline edge
               site; under DP this is the resync machinery's driver)
``flaky-net``  every connection risks a random mid-stream reset
               (seeded; never two in a row, so a retry can always
               land inside the same round), retries until the
               budget runs out
=============  ====================================================

Everything is deterministic under ``--fault-seed``: the wire plan for
client ``c``'s connection ``i`` derives from ``(fault_seed, c, i)``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any

from .proxy import FaultProxy, FaultSpec


@dataclass(frozen=True)
class Persona:
    """One client's behavior profile (see module docstring)."""

    name: str
    #: Fraction of the normal local-training work this client performs
    #: (lazy). Callers scale steps/epochs/rows by it, floored at one
    #: unit — a client that trains nothing uploads its init, which is
    #: legal but a different scenario.
    train_scale: float = 1.0
    #: Sit out every k-th round: round r is skipped when
    #: ``(r % skip_every) == skip_every - 1`` (stale). 0 = never.
    skip_every: int = 0
    #: Wire faults (executed by a FaultProxy; zero/negative = off).
    delay_s: float = 0.0
    throttle_bps: float = 0.0
    #: Reset the FIRST connection of every exchange after N upload
    #: bytes; the retry connection passes clean (intermittent).
    reset_first_connect_after: int = -1
    #: Per-connection probability of a random mid-stream reset, drawn
    #: deterministically from the connection rng (flaky-net).
    reset_probability: float = 0.0
    reset_window: tuple[int, int] = (512, 8192)

    def wire_faults(self) -> bool:
        """Does this persona need a FaultProxy on its connections?"""
        return (
            self.delay_s > 0.0
            or self.throttle_bps > 0.0
            or self.reset_first_connect_after >= 0
            or self.reset_probability > 0.0
        )

    def skips_round(self, round_index: int) -> bool:
        return (
            self.skip_every > 0
            and round_index % self.skip_every == self.skip_every - 1
        )

    def scaled(self, units: int) -> int:
        """Scale a work count (epochs, steps, rows) by ``train_scale``,
        floored at 1."""
        return max(1, int(round(units * self.train_scale)))


#: The registry. Wire numbers are sized for model uploads in the tens
#: of KB to tens of MB: the throttle makes `slow` a multi-second
#: straggler on the scenario runner's payloads without wedging a real
#: DistilBERT upload forever, and the reset offsets land mid-upload for
#: anything bigger than a handshake.
_PERSONAS = {
    "honest": Persona("honest"),
    "lazy": Persona("lazy", train_scale=0.25),
    "slow": Persona("slow", delay_s=0.5, throttle_bps=64_000),
    "intermittent": Persona(
        "intermittent", reset_first_connect_after=4096
    ),
    "stale": Persona("stale", skip_every=2),
    "flaky-net": Persona(
        "flaky-net", reset_probability=0.45, reset_window=(512, 8192)
    ),
}

PERSONA_NAMES = tuple(_PERSONAS)


def get_persona(name: str) -> Persona:
    try:
        return _PERSONAS[name]
    except KeyError:
        raise ValueError(
            f"unknown persona {name!r} (one of {', '.join(PERSONA_NAMES)})"
        ) from None


def persona_plan(persona: Persona):
    """The persona's per-connection FaultProxy plan: a callable
    ``(conn_index, rng) -> FaultSpec`` (rng is the proxy's deterministic
    per-connection generator)."""

    state = {"last_reset": False}

    def plan(index: int, rng: random.Random) -> FaultSpec:
        if persona.reset_first_connect_after >= 0 and index % 2 == 0:
            # Every exchange's first dial dies mid-upload; the retry
            # (the odd-indexed connection) passes clean.
            return FaultSpec(
                delay_s=persona.delay_s,
                throttle_bps=persona.throttle_bps,
                reset_after_bytes=persona.reset_first_connect_after,
            )
        if (
            persona.reset_probability > 0.0
            and not state["last_reset"]  # never two resets in a row: a
            # failed attempt's retry must be able to land inside the
            # same round (each client retry costs ~4 s of backoff +
            # mode-diagnosis peek; two in a row would slip past any
            # reasonable round deadline and smear the upload into the
            # NEXT round)
            and rng.random() < persona.reset_probability
        ):
            state["last_reset"] = True
            return FaultSpec(
                delay_s=persona.delay_s,
                throttle_bps=persona.throttle_bps,
                reset_after_bytes=rng.randrange(*persona.reset_window),
            )
        state["last_reset"] = False
        return FaultSpec(
            delay_s=persona.delay_s, throttle_bps=persona.throttle_bps
        )

    return plan


def start_persona_proxy(
    persona: Persona,
    server_host: str,
    server_port: int,
    *,
    fault_seed: Any = 0,
    client_id: int = 0,
) -> FaultProxy | None:
    """Start the persona's wire-fault proxy in front of the server (or
    return None for personas with client-side behavior only). The
    caller connects to ``(proxy.host, proxy.port)`` instead of the
    server and closes the proxy when the campaign ends.

    Caveat (documented, not hidden): behind a proxy, a client's
    connect-probe succeeds even while the *server* is still down — the
    reference-style wait-for-server probing then burns exchange retries
    instead of dial retries. Start the server first.
    """
    if not persona.wire_faults():
        return None
    return FaultProxy(
        server_host,
        server_port,
        plan=persona_plan(persona),
        seed=(fault_seed, client_id),
    )
