"""Serving replica fleet: a thin router over N ``infer-serve`` scorers
(the port's copy of the JAX package's ``router/``).

``route`` runs the model-free TCP router standalone (:mod:`.core` —
least-in-flight pick, in-band stats health probes, eject/readmit,
end-to-end HMAC), and ``fleet`` composes N local replicas behind it with
registry-following **rolling hot-reload** (:mod:`.fleet` — drain one
replica at a time around each promotion, so the serving pointer moves
without dropping a request). The replicas score on the card.
"""

from .core import Replica, ScoringRouter
from .fleet import FleetReplica, ServingFleet

__all__ = [
    "FleetReplica",
    "Replica",
    "ScoringRouter",
    "ServingFleet",
]
