"""Disagreement-gated promotion: the candidate earns serving on live
traffic, or it doesn't serve (the port's copy of the JAX package's
``shadow/gate.py``).

The controller's eval gate answers "is the candidate at least as good on
the held-out split?" — a necessary check that says nothing about the
traffic actually hitting the fleet. :class:`ShadowGate` adds the second,
live question: with the candidate held in the registry ``shadow`` state
and the fleet manager mirroring sampled traffic onto it (shadow/mirror +
shadow/compare), the gate waits for at least ``min_pairs`` mirrored
pairs and promotes only when the measured disagreement (flip rate AND
paired-score PSI) sits under threshold. Everything else **fails closed**
to ``rejected`` — a regression, an uncomputable distance, or a timeout
with too little evidence all leave the serving pointer exactly where it
was, with the verdict recorded on the registry event.

Coordination is file-shaped, like the rest of the control plane: the
comparator (running inside the fleet-manager process) atomically
publishes ``<registry>/shadow/<artifact>.status.json``; the gate
(running inside the controller process) polls it. Clock and sleep are
injectable so the gate's whole decision surface unit-tests without a
wall clock.
"""

from __future__ import annotations

import json
import logging
import os
import time

from .compare import evaluate_status

log = logging.getLogger(__name__)


def shadow_dir(registry_root: str) -> str:
    """Where the shadow plane's per-artifact evidence lands (under the
    registry root — the control plane's one coordination directory)."""
    return os.path.join(os.path.abspath(registry_root), "shadow")


def status_path(registry_root: str, aid: str) -> str:
    return os.path.join(shadow_dir(registry_root), f"{aid}.status.json")


def pairs_path(registry_root: str, aid: str) -> str:
    return os.path.join(shadow_dir(registry_root), f"{aid}.pairs.jsonl")


def read_status(registry_root: str, aid: str) -> dict | None:
    """The comparator's latest atomic snapshot for ``aid`` (None before
    the first publish; a torn/corrupt file reads as absent — the writer
    uses tmp+replace, so this is a foreign-writer guard, not a race)."""
    try:
        with open(status_path(registry_root, aid)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class ShadowGate:
    """Block until the shadow plane produced a verdict for an artifact.

    ``wait(aid)`` returns ``(ok, verdict)``; the caller (the controller)
    promotes on ok and rejects otherwise, attaching ``verdict`` to the
    registry event either way. ``clock``/``sleep`` are injectable — the
    timeout path is pure (now, status) arithmetic."""

    def __init__(
        self,
        registry_root: str,
        *,
        min_pairs: int = 256,
        max_flip_rate: float = 0.02,
        psi_threshold: float = 0.25,
        timeout_s: float = 600.0,
        poll_s: float = 0.5,
        tracer=None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        if int(min_pairs) < 1:
            raise ValueError(f"min_pairs={min_pairs} must be >= 1")
        if not 0.0 <= float(max_flip_rate) <= 1.0:
            raise ValueError(
                f"max_flip_rate={max_flip_rate} must be in [0, 1]"
            )
        if float(psi_threshold) <= 0.0:
            raise ValueError(
                f"psi_threshold={psi_threshold} must be > 0"
            )
        if float(timeout_s) <= 0.0:
            raise ValueError(f"timeout_s={timeout_s} must be > 0")
        self.registry_root = os.path.abspath(registry_root)
        self.min_pairs = int(min_pairs)
        self.max_flip_rate = float(max_flip_rate)
        self.psi_threshold = float(psi_threshold)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self.tracer = tracer
        self._clock = clock
        self._sleep = sleep

    def _verdict(self, ok: bool, reason: str, status: dict | None) -> dict:
        status = status or {}
        return {
            "ok": bool(ok),
            "reason": reason,
            "pairs": int(status.get("pairs", 0) or 0),
            "flip_rate": status.get("flip_rate"),
            "mean_abs_dprob": status.get("mean_abs_dprob"),
            "psi": status.get("psi"),
            "min_pairs": self.min_pairs,
            "max_flip_rate": self.max_flip_rate,
            "psi_threshold": self.psi_threshold,
        }

    def wait(self, aid: str) -> tuple[bool, dict]:
        """Poll the comparator's status until >= ``min_pairs`` pairs
        accumulated (then rule on the evidence) or the timeout expires
        (then FAIL CLOSED — a candidate that never earned its evidence
        never earns the pointer)."""
        t_unix = time.time()
        t0 = self._clock()
        deadline = t0 + self.timeout_s
        status: dict | None = None
        while True:
            status = read_status(self.registry_root, aid)
            if status is not None and int(status.get("pairs", 0) or 0) >= (
                self.min_pairs
            ):
                ok, reason = evaluate_status(
                    status,
                    min_pairs=self.min_pairs,
                    max_flip_rate=self.max_flip_rate,
                    psi_threshold=self.psi_threshold,
                )
                verdict = self._verdict(ok, reason, status)
                break
            if self._clock() >= deadline:
                pairs = int((status or {}).get("pairs", 0) or 0)
                verdict = self._verdict(
                    False,
                    f"shadow gate timeout after {self.timeout_s:.0f}s "
                    f"with {pairs} mirrored pair(s) < "
                    f"min_pairs={self.min_pairs} (no live evidence — "
                    "failing closed)",
                    status,
                )
                ok = False
                break
            self._sleep(self.poll_s)
        if self.tracer is not None:
            self.tracer.record(
                "shadow-gate",
                t_start=t_unix,
                dur_s=self._clock() - t0,
                artifact=aid,
                passed=bool(ok),
                pairs=verdict["pairs"],
                flip_rate=verdict["flip_rate"],
                psi=verdict["psi"],
            )
        log.info(
            f"[SHADOW] gate verdict for {aid}: "
            f"{'PASS' if ok else 'FAIL'} ({verdict['reason']})"
        )
        return ok, verdict
