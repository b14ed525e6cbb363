"""Wire transport of the port: framing, the weight and scoring messages,
and the federated round over TCP (aggregation server + client)."""

from .client import FederatedClient, backoff_intervals, connect_with_retry  # noqa: F401
from .server import AggregationServer, aggregate_flat  # noqa: F401
from .stream_agg import StreamAgg, StreamAggPoisoned  # noqa: F401
from .wire import ModeError, WireError  # noqa: F401
