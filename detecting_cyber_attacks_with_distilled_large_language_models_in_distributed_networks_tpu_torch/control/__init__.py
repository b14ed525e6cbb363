"""Control plane: the unattended train -> gate -> promote -> serve ->
monitor loop.

The reference is one-shot: a federated round happens only when a human
re-runs three scripts, and nothing connects "a round finished" to "the
serving tier loads it". *Federated Learning in the Wild* (arxiv
2509.17836) shows cybersecurity FL degrading under non-IID drift unless
retraining is monitored and triggered, and *Exploring the Practicality
of Federated Learning* (arxiv 2405.20431) identifies the round
orchestration loop — not any single round — as the real efficiency
objective. This package is that loop:

* :mod:`.controller` — the long-lived ``fedtpu controller`` daemon:
  drives the existing TCP round engine (comm/server.py) round after
  round, evaluates every aggregate on a held-out split, registers it as
  an immutable candidate (registry/), and promotes it through the
  eval gate — a candidate worse than the incumbent is REJECTED and the
  serving pointer never moves (automatic rollback-by-refusal). A
  structured controller-state JSONL makes a restarted controller resume
  mid-campaign.
* :mod:`.drift` — score-distribution shift (PSI/KS) of live serving
  traffic (the serving tier's metrics-JSONL histogram export) against
  the promoted artifact's eval reference histogram; a fired verdict is
  what triggers the next training round instead of a fixed clock.

The port's copy of the JAX package's ``control/``, with the same names,
the controller's shadow, label and error-rate gates included.
"""

from .controller import Controller, ControllerStats, SloActuator
from .drift import (
    DriftMonitor,
    ErrorRateMonitor,
    SentinelLink,
    cadence_interval_s,
    drift_cohort_fraction,
    ks_distance,
    psi,
)

__all__ = [
    "Controller",
    "ControllerStats",
    "DriftMonitor",
    "ErrorRateMonitor",
    "SentinelLink",
    "SloActuator",
    "cadence_interval_s",
    "drift_cohort_fraction",
    "ks_distance",
    "psi",
]
