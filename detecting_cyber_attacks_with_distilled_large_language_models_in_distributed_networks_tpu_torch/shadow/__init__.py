"""Shadow evaluation plane: live-traffic A/B before the pointer moves
(the port's copy of the JAX package's ``shadow/``; host-side, the
candidate scores on the card in its own fleet replica).

The registry ladder's ``shadow`` state finally carries traffic: the
router duplicates a deterministic sample of live scoring requests onto
the candidate artifact (:mod:`.mirror` — fire-and-forget on a bounded
queue, never in the live reply's way), the serving/shadow
probability pairs accumulate into flip-rate + PSI disagreement evidence
(:mod:`.compare` — atomic paired JSONL + status file), and promotion is
gated on that LIVE evidence (:mod:`.gate` — under-threshold
disagreement promotes, anything else fails closed to ``rejected`` with
the verdict on the registry event). ``controller --shadow-gate``
drives the gate; ``fleet --shadow-sample N`` arms the mirror;
``shadow status|report`` is the operator surface.
"""

from .compare import PAIR_SCHEMA, ShadowCompare, evaluate_status
from .gate import (
    ShadowGate,
    pairs_path,
    read_status,
    shadow_dir,
    status_path,
)
from .mirror import ShadowMirror

__all__ = [
    "PAIR_SCHEMA",
    "ShadowCompare",
    "ShadowGate",
    "ShadowMirror",
    "evaluate_status",
    "pairs_path",
    "read_status",
    "shadow_dir",
    "status_path",
]
