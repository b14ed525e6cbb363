"""Server aggregation strategies of the TCP round (the port of the JAX
package's ``strategies/``): a pure transform of (previous global, folded
mean) applied once per round at finalize. The fold underneath stays the
bit-exact weighted mean, and ``fedavg`` is the identity on it."""

from .core import (
    STRATEGIES,
    FedAvg,
    FedOpt,
    FedProx,
    HeadBoost,
    Momentum,
    Strategy,
    make_strategy,
    parse_strategy,
)

__all__ = [
    "STRATEGIES",
    "FedAvg",
    "FedOpt",
    "FedProx",
    "HeadBoost",
    "Momentum",
    "Strategy",
    "make_strategy",
    "parse_strategy",
]
