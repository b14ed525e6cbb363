"""Lockstep batch iterators of the federated trainer (the port of the JAX
package's ``train/batches.py``: ``federated_batches`` and
``federated_batches_ragged``).

Every client's rows are permuted independently per epoch with the JAX
package's keying, ``default_rng((seed·100003 + epoch)·1000003 +
client_offset + c)``, so both trainers see the same ``[C, B, ...]``
batches in the same order.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..data.pipeline import StackedClients, TokenizedSplit


def _perm_seed(seed: int, epoch: int, client: int) -> int:
    return (seed * 100_003 + epoch) * 1_000_003 + client


def federated_batches(
    stacked: TokenizedSplit,
    batch_size: int,
    *,
    seed: int,
    epoch: int,
    client_offset: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    """``[C, B, ...]`` batches over a dense stack (every client holds the
    same row count), each client's rows permuted independently;
    ``client_offset`` is the first client's global index."""
    C, N = stacked.labels.shape[:2]
    perms = np.stack(
        [np.random.default_rng(_perm_seed(seed, epoch, client_offset + c)).permutation(N) for c in range(C)]
    )
    rows = np.arange(C)[:, None]
    for i in range(N // batch_size):
        idx = perms[:, i * batch_size : (i + 1) * batch_size]
        yield {
            "input_ids": stacked.input_ids[rows, idx],
            "attention_mask": stacked.attention_mask[rows, idx],
            "labels": stacked.labels[rows, idx],
        }


def federated_batches_ragged(
    stacked: StackedClients,
    batch_size: int,
    *,
    seed: int,
    epoch: int,
    client_offset: int = 0,
    n_batches: int | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Per-epoch ``[C, B, ...]`` batches over a RAGGED stack, with a
    ``valid`` ``[C, B]`` 0/1 mask. Each client's real rows are consumed
    exactly once per epoch: a client whose rows run out pads its
    remaining lockstep batches with pad rows (index 0, ``valid == 0``:
    its step is gated off), and its final partial batch mixes real and
    pad rows. ``n_batches`` forces a longer lockstep span.

    Every batch also carries ``warmup_step`` ``[C, B]``: each client's
    OWN executed-step count entering it (``epoch·ceil(n_c/bs) + min(i,
    ceil(n_c/bs))``), which keys that client's LR warmup."""
    C = stacked.split.labels.shape[0]
    own_steps = np.array([-(-int(n) // batch_size) for n in stacked.n_rows], np.int32)
    min_steps = int(own_steps.max())
    steps = min_steps if n_batches is None else n_batches
    if steps < min_steps:
        worst = int(own_steps.argmax())
        raise ValueError(
            f"n_batches={steps} is smaller than client {worst}'s own epoch "
            f"length ceil({int(stacked.n_rows[worst])}/{batch_size})="
            f"{min_steps}; every client's rows must fit the lockstep span"
        )
    span = steps * batch_size
    idx = np.zeros((C, span), np.int64)
    valid = np.zeros((C, span), np.int32)
    for c in range(C):
        n_c = int(stacked.n_rows[c])
        idx[c, :n_c] = np.random.default_rng(_perm_seed(seed, epoch, client_offset + c)).permutation(n_c)
        valid[c, :n_c] = 1
    rows = np.arange(C)[:, None]
    for i in range(steps):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        take = idx[:, sl]
        wstep = epoch * own_steps + np.minimum(i, own_steps)
        yield {
            "input_ids": stacked.split.input_ids[rows, take],
            "attention_mask": stacked.split.attention_mask[rows, take],
            "labels": stacked.split.labels[rows, take],
            "valid": valid[:, sl],
            "warmup_step": np.broadcast_to(wstep[:, None], (C, batch_size)).copy(),
        }
