"""Host-side pipeline: texts -> static-shape token arrays -> batch streams.

The port's copy of the JAX package's ``data/pipeline.py``: every split is
tokenized once into ``[N, max_len]`` int32 arrays, and epochs are
host-side permutations over them, drawn exactly as the JAX package draws
them (``np.random.default_rng(seed).shuffle``), so both trainers see the
same batches in the same order. A federated fleet is stacked into
``[C, N, ...]`` arrays: :func:`stack_clients` truncates to a common row
count, :func:`stack_clients_ragged` pads every client to the fleet max
with a validity mask so each client's whole split trains.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from .cicids import ClientSplits, SplitArrays
from .tokenizer import WordPieceTokenizer


@dataclass
class TokenizedSplit:
    input_ids: np.ndarray  # [N, L] int32
    attention_mask: np.ndarray  # [N, L] int32
    labels: np.ndarray  # [N] int32

    def __len__(self) -> int:
        return len(self.labels)


@dataclass
class TokenizedClient:
    client_id: int
    train: TokenizedSplit
    val: TokenizedSplit
    test: TokenizedSplit


def tokenize_split(
    split: SplitArrays, tok: WordPieceTokenizer, max_len: int
) -> TokenizedSplit:
    enc = tok.batch_encode(split.texts, max_len=max_len)
    return TokenizedSplit(
        enc["input_ids"], enc["attention_mask"], split.labels.astype(np.int32)
    )


def tokenize_client(
    splits: ClientSplits, tok: WordPieceTokenizer, max_len: int
) -> TokenizedClient:
    return TokenizedClient(
        splits.client_id,
        tokenize_split(splits.train, tok, max_len),
        tokenize_split(splits.val, tok, max_len),
        tokenize_split(splits.test, tok, max_len),
    )


def batch_iterator(
    split: TokenizedSplit,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int | None = None,
    drop_remainder: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    """Epoch over one split. With ``drop_remainder`` every batch has the
    same shape and the final short batch is dropped."""
    n = len(split)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = n - (n % batch_size) if drop_remainder else n
    for i in range(0, stop, batch_size):
        idx = order[i : i + batch_size]
        yield {
            "input_ids": split.input_ids[idx],
            "attention_mask": split.attention_mask[idx],
            "labels": split.labels[idx],
        }


def pad_split_to_batch(
    split: TokenizedSplit, batch_size: int, pad_id: int = 0
) -> tuple[TokenizedSplit, np.ndarray]:
    """Pad a split with PAD rows (all-zero attention mask) up to a batch
    multiple; returns the padded split plus a ``[N_padded]`` validity
    mask, so evaluation counts every example once at one batch shape.
    ``pad_id`` must be the tokenizer's pad id."""
    n = len(split)
    n_pad = (-n) % batch_size
    if n_pad == 0:
        return split, np.ones(n, dtype=np.int32)
    pad_rows = np.full(
        (n_pad, split.input_ids.shape[1]), pad_id, dtype=split.input_ids.dtype
    )
    zero_mask = np.zeros((n_pad, split.input_ids.shape[1]), dtype=split.attention_mask.dtype)
    padded = TokenizedSplit(
        np.concatenate([split.input_ids, pad_rows]),
        np.concatenate([split.attention_mask, zero_mask]),
        np.concatenate([split.labels, np.zeros(n_pad, dtype=split.labels.dtype)]),
    )
    valid = np.concatenate([np.ones(n, np.int32), np.zeros(n_pad, np.int32)])
    return padded, valid


def stack_clients(
    clients: Sequence[TokenizedSplit], n_rows: int | None = None
) -> TokenizedSplit:
    """Stack per-client splits into ``[C, N, ...]`` arrays with a common N
    (the fleet min unless given): the dense federated feed. TRUNCATES
    rows beyond N; :func:`stack_clients_ragged` keeps them all."""
    if n_rows is None:
        n_rows = min(len(c) for c in clients)
    return TokenizedSplit(
        np.stack([c.input_ids[:n_rows] for c in clients]),
        np.stack([c.attention_mask[:n_rows] for c in clients]),
        np.stack([c.labels[:n_rows] for c in clients]),
    )


@dataclass
class StackedClients:
    """Ragged per-client train splits stacked to the fleet-max row count
    with per-row validity: every client's every row enters training, and
    pad rows (``row_valid == 0``) contribute nothing to losses or
    gradients — the shape of the reference's N independent processes,
    each consuming all of its own (differently sized) sample."""

    split: TokenizedSplit  # [C, N_max, ...]
    row_valid: np.ndarray  # [C, N_max] int32 0/1
    n_rows: np.ndarray  # [C] true per-client row counts

    @property
    def labels(self) -> np.ndarray:
        return self.split.labels

    def __len__(self) -> int:
        return len(self.n_rows)


def stack_clients_ragged(
    clients: Sequence[TokenizedSplit],
    *,
    pad_id: int = 0,
    target_rows: int | None = None,
) -> StackedClients:
    """Stack unequal per-client splits into ``[C, N_max, ...]`` arrays plus
    a validity matrix, padding short clients with PAD rows (attention
    mask all zero, label 0, valid 0). ``target_rows`` raises N_max to a
    given count (at least the longest split)."""
    n_rows = np.array([len(c) for c in clients], np.int64)
    target = int(n_rows.max()) if len(clients) else 0
    if target_rows is not None:
        if target_rows < target:
            raise ValueError(
                f"target_rows={target_rows} < local max split length {target}"
            )
        target = target_rows
    ids, masks, labels, valid = [], [], [], []
    for c in clients:
        extra = target - len(c)
        L = c.input_ids.shape[1]
        ids.append(np.concatenate([c.input_ids, np.full((extra, L), pad_id, c.input_ids.dtype)]))
        masks.append(np.concatenate([c.attention_mask, np.zeros((extra, L), c.attention_mask.dtype)]))
        labels.append(np.concatenate([c.labels, np.zeros(extra, c.labels.dtype)]))
        valid.append(np.concatenate([np.ones(len(c), np.int32), np.zeros(extra, np.int32)]))
    return StackedClients(
        TokenizedSplit(np.stack(ids), np.stack(masks), np.stack(labels)),
        np.stack(valid),
        n_rows,
    )
