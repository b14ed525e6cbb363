"""Online scoring service on the port: protocol, batcher, engine, server,
client, reload watchers (see each module)."""

from .batcher import MicroBatcher, ScoreRequest  # noqa: F401
from .client import ScoreRejected, ScoringClient  # noqa: F401
from .engine import DEFAULT_BUCKETS, ScoreEngine  # noqa: F401
from .reload import CheckpointWatcher, RegistryWatcher  # noqa: F401
from .protocol import (  # noqa: F401
    build_reject,
    build_reply,
    build_request,
    parse_reject,
    parse_reply,
    parse_request,
)
from .server import ScoringServer  # noqa: F401
