"""Batch iterators of the trainers (the port of the JAX package's
``train/batches.py``): the TCP client's one-slot epoch prefetch
(``EpochPrefetcher``, ``PrefetchSlot``) and the federated trainer's
lockstep ``federated_batches`` and ``federated_batches_ragged``.

Every client's rows are permuted independently per epoch with the JAX
package's keying, ``default_rng((seed·100003 + epoch)·1000003 +
client_offset + c)``, so both trainers see the same ``[C, B, ...]``
batches in the same order.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterator

import numpy as np

from ..data.pipeline import StackedClients, TokenizedSplit


#: Batches an armed prefetch builds ahead (the JAX package's default).
PREFETCH_BATCHES = 2


class EpochPrefetcher:
    """Background materialization of an epoch's first PREFETCH_BATCHES
    batches.

    The TCP client's round is serial: train, upload, wait for the
    aggregate, train again. The wait is spent on the NEXT round's input
    pipeline instead: the epoch's permutation and its first batches' row
    gathers run on a thread. The factory builds the exact iterator
    the epoch loop would have built, so :meth:`batches` yields the same
    batches as iterating it directly."""

    def __init__(self, factory: Callable[[], Iterator[Any]]):
        self._buf: list[Any] = []
        self._it: Iterator[Any] | None = None
        self._err: BaseException | None = None
        self._factory = factory
        #: Seconds the background work ran (the input-pipeline time hidden
        #: behind the reply wait).
        self.busy_s = 0.0
        #: When the background work started (unix seconds) and how many
        #: batches it built: the ``batch-prefetch`` span's start and attrs.
        self.t_unix = 0.0
        self.n_prefetched = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        self.t_unix = time.time()
        t0 = time.monotonic()
        try:
            it = self._factory()
            for _ in range(PREFETCH_BATCHES):
                try:
                    self._buf.append(next(it))
                except StopIteration:
                    it = iter(())
                    break
            self._it = it
            self.n_prefetched = len(self._buf)
        except BaseException as e:  # raised on consume, not on a daemon thread
            self._err = e
        finally:
            self.busy_s = time.monotonic() - t0

    def ready(self) -> bool:
        return not self._thread.is_alive()

    def batches(self) -> Iterator[Any]:
        self._thread.join()
        if self._err is not None:
            raise self._err
        yield from self._buf
        if self._it is not None:
            yield from self._it


class PrefetchSlot:
    """One armed :class:`EpochPrefetcher` keyed by the epoch it was built
    for. ``consume`` is one-shot: a mismatched key drops the armed
    buffer and the caller builds its live iterator."""

    def __init__(self) -> None:
        self._armed: tuple[tuple, EpochPrefetcher] | None = None

    @property
    def armed(self) -> bool:
        return self._armed is not None

    def arm(self, key: tuple, factory: Callable[[], Iterator[Any]]) -> EpochPrefetcher:
        pf = EpochPrefetcher(factory)
        self._armed = (tuple(key), pf)
        return pf

    def consume(self, key: tuple) -> Iterator[Any] | None:
        """The armed prefetcher's ``batches()`` when ``key`` matches the
        armed epoch, else None."""
        if self._armed is None:
            return None
        armed_key, pf = self._armed
        self._armed = None
        if armed_key == tuple(key):
            return pf.batches()
        return None


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
