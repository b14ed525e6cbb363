"""Online scoring service on the port: protocol, batcher, engine, server,
clients and load generator, reload watchers (see each module)."""

from .batcher import MicroBatcher, ScoreRequest
from .client import (
    AsyncScoringClient,
    PipelinedScoringClient,
    ScoreRejected,
    ScoringClient,
    fetch_stats,
    load_arrival_trace,
    run_load,
)
from .engine import DEFAULT_BUCKETS, ScoreEngine
from .protocol import (
    build_reject,
    build_reply,
    build_request,
    parse_reject,
    parse_reply,
    parse_request,
)
from .reload import CheckpointWatcher, RegistryWatcher
from .server import ScoringServer

__all__ = [
    "AsyncScoringClient",
    "CheckpointWatcher",
    "DEFAULT_BUCKETS",
    "MicroBatcher",
    "PipelinedScoringClient",
    "RegistryWatcher",
    "ScoreEngine",
    "ScoreRejected",
    "ScoreRequest",
    "ScoringClient",
    "ScoringServer",
    "build_reject",
    "build_reply",
    "build_request",
    "fetch_stats",
    "load_arrival_trace",
    "parse_reject",
    "parse_reply",
    "parse_request",
    "run_load",
]
