"""Host-side pipeline: texts -> static-shape token arrays -> batch streams.

The port's copy of the JAX package's ``data/pipeline.py``: every split is
tokenized once into ``[N, max_len]`` int32 arrays, and epochs are
host-side permutations over them, drawn exactly as the JAX package draws
them (``np.random.default_rng(seed).shuffle``), so both trainers see the
same batches in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

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
