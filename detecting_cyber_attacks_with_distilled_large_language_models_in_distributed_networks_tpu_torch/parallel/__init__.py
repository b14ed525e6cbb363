from .fedavg import (  # noqa: F401
    ServerOptimizer,
    fedavg,
    make_server_optimizer,
    stack_params,
    weighted_mean,
)
