"""Hierarchical fold tree: the ``relay`` intermediate aggregator (the
port's copy of the JAX package's ``comm/relay.py``).

A relay terminates a subtree of client connections, folds their uploads
into a partial weighted mean with the round's streaming fold (on the card
with K4, leaf by leaf, as the root folds), and forwards one upload to its
parent. The root then terminates ``n_relays`` connections instead of
``n_clients``.

A relay is an :class:`~.server.AggregationServer` (subtree-facing: auth,
streamed uploads, eager folds, spans) plus a
:class:`~.client.FederatedClient` (parent-facing), joined by the server's
``reply_via`` hook: between aggregation and the reply fan-out the subtree
partial goes up, and the root's aggregate comes back down to the
subtree's clients. Clients cannot tell a relay from a root server.

Weight contract: the relay's subtree mean is always sample-count
weighted, and its upward upload carries ``n_samples = sum(subtree
n_samples)``; run the root with ``--weighted`` so subtree means recombine
by their true mass (uniform counts give the uniform mean exactly).

Bit-exactness contract: every fold in the tree equals ``aggregate_flat``
over its own inputs bit for bit, so the depth-2 result equals
:func:`aggregate_tree` (ascending client id within a subtree, ascending
relay id at the root), replayable from captured uploads. It differs from
the single-process mean over all N clients by fp32 reduction-order ulps
only.

Out of scope by design, as in the JAX package: secure aggregation stays
single-aggregator and central DP stays at the root.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..strategies import make_strategy
from . import wire
from .client import FederatedClient
from .server import AggregationServer, aggregate_flat

log = logging.getLogger(__name__)


def aggregate_tree(
    models: list[dict[str, np.ndarray]],
    weights: list[float] | None,
    groups: list,
) -> dict[str, np.ndarray]:
    """The fold tree's arithmetic replayed flat, in numpy: per group (a
    subtree, indices into ``models`` in ascending client-id order) the
    weighted barrier mean, then the barrier mean of the partials weighted
    by each group's weight mass — the fp32 ops, in the order, the relay
    tier performs. ``groups`` may nest to any depth (a relay under a
    relay); a bare index is a leaf."""
    if not isinstance(groups, list) or not groups:
        raise ValueError("aggregate_tree needs non-empty groups")

    def _fold(node) -> tuple[dict[str, np.ndarray], float]:
        if isinstance(node, (int, np.integer)):
            return models[node], 1.0 if weights is None else float(weights[node])
        if not isinstance(node, list) or not node:
            raise ValueError("aggregate_tree needs non-empty groups")
        parts: list[dict[str, np.ndarray]] = []
        masses: list[float] = []
        for child in node:
            part, mass = _fold(child)
            parts.append(part)
            masses.append(mass)
        return aggregate_flat(parts, masses), sum(masses)

    return _fold(groups)[0]


class RelayAggregator:
    """One ``relay`` process: subtree-facing AggregationServer (its fold
    on ``device``, the card unless ``"cpu"`` is given) plus parent-facing
    FederatedClient, joined by the server's ``reply_via`` hook.

    ``relay_id`` is this relay's client id on the parent's tier (relays
    fold in ascending relay id there). ``num_clients`` is the subtree
    size."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        parent_host: str,
        parent_port: int,
        relay_id: int,
        num_clients: int,
        min_clients: int | None = None,
        timeout: float = 300.0,
        compression: str = "none",
        auth_key: bytes | None = None,
        stream_chunk_bytes: int = wire.DEFAULT_STREAM_CHUNK,
        stream: bool = True,
        subtree_deadline_factor: float = 0.5,
        tracer=None,
        strategy: str = "fedavg",
        upward_topk: float | None = None,
        device: str | torch.device | None = None,
    ):
        # Sparse upward hops (--upward-topk): the parent-facing leg runs
        # the sparse round-delta exchange against the last root aggregate
        # it fanned down, with the root's agg_crc stamp as base agreement.
        if upward_topk is not None:
            if wire.parse_compression(compression)[0] == "topk":
                raise ValueError(
                    "upward_topk composes the relay's own upward "
                    "sparsifier; give the subtree-facing --compression "
                    "a non-topk value"
                )
            wire.parse_compression(f"topk:{float(upward_topk)}")  # range check
        # The subtree deadline is strictly tighter than the round budget:
        # a slow subtree sheds its stragglers while the root still waits.
        if not 0.0 < float(subtree_deadline_factor) < 1.0:
            raise ValueError(
                f"subtree_deadline_factor={subtree_deadline_factor} "
                "must be in (0, 1): the subtree deadline has to be "
                "strictly tighter than the round budget"
            )
        self.server = AggregationServer(
            host,
            port,
            num_clients=num_clients,
            weighted=True,
            min_clients=min_clients,
            timeout=timeout,
            compression=compression,
            auth_key=auth_key,
            stream_chunk_bytes=stream_chunk_bytes,
            device=device,
            tracer=tracer,
        )
        self.parent = FederatedClient(
            parent_host,
            parent_port,
            client_id=relay_id,
            timeout=timeout,
            compression=f"topk:{float(upward_topk)}" if upward_topk is not None else compression,
            auth_key=auth_key,
            stream=stream,
            tracer=tracer,
        )
        self.upward_topk = float(upward_topk) if upward_topk is not None else None
        #: Cumulative parent-facing upload bytes (what --upward-topk shrinks).
        self.upward_bytes = 0
        # fedtpu: allow(obs-metric-once): the JAX package's comm/relay.py family, same name/kind/labels/help
        self._m_upward_bytes = obs_metrics.default_registry().counter(
            "fedtpu_relay_upward_bytes_total",
            help="parent-facing upload payload bytes shipped by this "
            "relay (sparse upward deltas shrink this, not the subtree "
            "tier's receive totals)",
        )
        self.relay_id = int(relay_id)
        self.subtree_deadline_factor = float(subtree_deadline_factor)
        self.tracer = tracer
        # The relay never transforms (a subtree partial is not a global),
        # but it declares the strategy it believes the fleet runs on every
        # upward upload, and the root refuses a mismatch; a typo fails at
        # relay start.
        self.strategy_name = make_strategy(strategy).name
        self.server.reply_via = self._forward
        self.port = self.server.port

    # ------------------------------------------------------------ rounds
    def _forward(self, agg: dict, info: dict) -> dict:
        """The ``reply_via`` hook: ship the subtree partial (with its
        sample mass and contributor record) to the parent, return the root
        aggregate for the subtree's clients; the ``relay-forward`` span
        covers the upward exchange.

        The contributor record names the clients the partial covers: a
        contributor that is itself a relay stands for the clients of its
        own record. Relay ids are local to their parent (two mid relays
        each have a relay 0), so forwarding them would make the root see
        one client in two subtrees and fail the round as double-counted."""
        total = sum(info["n_samples"].values())
        below = info.get("subtree_ids", {})
        covered = [int(c) for i in info["ids"] for c in below.get(i, [i])]
        t_unix = time.time()
        t0 = time.monotonic()
        out = self.parent.exchange(
            agg,
            n_samples=max(1, int(round(total))),
            meta={
                wire.META_SUBTREE_IDS: covered,
                wire.META_STRATEGY: {"name": self.strategy_name},
            },
        )
        dur = time.monotonic() - t0
        up_bytes = int(self.parent.last_exchange.get("upload_bytes", 0))
        self.upward_bytes += up_bytes
        self._m_upward_bytes.inc(float(up_bytes))
        if self.tracer is not None:
            parent_trace, parent_round = self.parent.last_trace
            self.tracer.record(
                "relay-forward",
                t_start=t_unix,
                dur_s=dur,
                trace=info.get("trace"),
                round=info.get("round"),
                relay=self.relay_id,
                subtree_clients=len(info["ids"]),
                parent_trace=parent_trace,
                parent_round=parent_round,
                upward_bytes=up_bytes,
                upward_sparse=1 if self.upward_topk is not None else None,
                wire_dtype=self.parent.last_exchange.get("wire_dtype", "fp32"),
            )
        log.info(
            f"[RELAY {self.relay_id}] forwarded subtree partial "
            f"({len(info['ids'])} client(s), mass {total:g}, "
            f"{up_bytes / 1e6:.2f} MB up) and received "
            f"the root aggregate in {dur:.3f}s"
        )
        return wire.flatten_params(out)

    def serve_round(self, **kw) -> dict | None:
        """One relay round: gather and fold the subtree, forward the
        partial, fan the root aggregate out. Returns the root aggregate
        (flat). The default deadline is ``subtree_deadline_factor *
        timeout``."""
        kw.setdefault("deadline", self.subtree_deadline_factor * self.server.timeout)
        return self.server.serve_round(**kw)

    def serve(self, rounds: int = 1) -> None:
        """Multi-round loop: a failed round (subtree quorum miss, parent
        unreachable) is logged and the next proceeds."""
        for r in range(rounds):
            log.info(f"[RELAY {self.relay_id}] round {r + 1}/{rounds}")
            try:
                self.serve_round()
            except (RuntimeError, ConnectionError, OSError) as e:
                log.info(f"[RELAY {self.relay_id}] round {r + 1} failed: {e}")

    # --------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Tear the relay down promptly, mid-round included: abort the
        parent-facing exchange first, then close the subtree server, which
        sheds every pending child upload (the children's dead connections
        are what make them re-home)."""
        self.parent.abort()
        self.server.close()

    def __enter__(self) -> "RelayAggregator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
