"""Wire transport of the port: framing, the weight and scoring messages,
the federated round over TCP (aggregation server + client), secure
aggregation and the fold tree's relays."""

from .client import FederatedClient, backoff_intervals, connect_with_retry  # noqa: F401
from .framing import PipelinedSender, recv_frame, send_frame  # noqa: F401
from .relay import RelayAggregator, aggregate_tree  # noqa: F401
from .secure import SecureAggError, aggregate_masked, masked_upload  # noqa: F401
from .server import AggregationServer, aggregate_flat  # noqa: F401
from .stream_agg import StreamAgg, StreamAggPoisoned  # noqa: F401
from .wire import ModeError, WireError, decode, encode, flatten_params, unflatten_params  # noqa: F401
