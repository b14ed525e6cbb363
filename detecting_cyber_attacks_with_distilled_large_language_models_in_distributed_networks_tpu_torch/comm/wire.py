"""The scoring frames' magics, shared byte for byte with the JAX package.

Only what the scoring service needs: the wire error type and the three
4-byte magics of the request, reply and reject frames (the JAX package's
``comm/wire.py``). The port speaks the JAX package's scoring protocol, so
a JAX client can score against the port's server and the reverse; the
bytes must stay equal to the JAX package's, and its static checker tracks
uniqueness of magics there, not here.
"""

from __future__ import annotations


class WireError(ValueError):
    """Malformed, truncated, or tampered wire message."""


#: One flow record to score (text or raw features) + an optional deadline.
SCORE_REQ_MAGIC = b"SCRQ"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
#: P(attack) plus serving telemetry (model round, batch size, queue wait).
SCORE_REP_MAGIC = b"SCRP"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
#: The explicit 503/504-style refusal (admission control, deadline).
SCORE_REJ_MAGIC = b"SCRJ"  # fedtpu: allow(wire-magic-coverage): the JAX package's scoring magic, copied byte for byte so both packages speak one protocol
