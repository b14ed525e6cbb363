"""CICIDS2017 loading, imputation, per-client sampling and splits.

The port's copy of the JAX package's ``data/cicids.py`` for the
reference's own partition (``partition="sample"``), without pandas: a
frame is a dict of equal-length numpy columns in CSV column order.

* CSV load with headers stripped; ``±inf -> NaN``; NaN -> column mean
  (numeric columns only) — reference client1.py:86-88.
* Per-client sample ``df.sample(frac, random_state=seed)``, which draws
  ``RandomState(seed).choice(n, round(frac * n), replace=False)``; client
  i uses seed ``seed_base + i`` (42, 43, ... as in the reference).
* 60/20/20 train/val/test via two chained shuffled splits with the same
  seed — reference client1.py:365-366.
* Label map ``'DDoS' -> 1 else 0`` — reference client1.py:91.
"""

from __future__ import annotations

import csv
import re
from dataclasses import dataclass

import numpy as np

from ..config import DataConfig
from .textualize import CICIDS_TEMPLATE, render_template

#: ``{column name: values}``, every column the same length.
Frame = dict[str, np.ndarray]

#: The strings pandas' CSV reader takes as missing values.
_NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT = re.compile(r"^[+-]?\d+$")


def frame_len(frame: Frame) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def take_rows(frame: Frame, idx: np.ndarray) -> Frame:
    return {name: col[idx] for name, col in frame.items()}


def _parse_column(tokens: list[str]) -> np.ndarray:
    """pandas' type inference for one column: int64 when every value is
    an integer, float64 when every value is a number or missing, else
    the strings."""
    if tokens and all(_INT.match(t) for t in tokens):
        return np.array([int(t) for t in tokens], dtype=np.int64)
    try:
        return np.array(
            [np.nan if t in _NA_TOKENS else float(t) for t in tokens],
            dtype=np.float64,
        )
    except ValueError:
        return np.array(tokens, dtype=object)


def load_flow_csv(path: str) -> Frame:
    """Load a CICIDS2017-style CSV and impute non-finite values.

    Column names are whitespace-stripped (real CICIDS2017 exports carry
    leading spaces on some headers) and values lose leading spaces, as
    with ``pd.read_csv(skipinitialspace=True)``. In every numeric column
    ±inf becomes NaN and NaN becomes the column's mean over its finite
    values."""
    with open(path, newline="") as f:
        reader = csv.reader(f, skipinitialspace=True)
        header = [c.strip() for c in next(reader)]
        rows = [r for r in reader if r]
    frame: Frame = {}
    for j, name in enumerate(header):
        col = _parse_column([r[j] if j < len(r) else "" for r in rows])
        if col.dtype == np.float64:
            col[np.isinf(col)] = np.nan
            missing = np.isnan(col)
            if missing.any():
                count = int((~missing).sum())
                # pandas' nanmean: a sum with the missing values as 0, over
                # the count of the rest.
                mean = np.where(missing, 0.0, col).sum() / count if count else np.nan
                col[missing] = mean
        frame[name] = col
    return frame


def sample_client_frame(frame: Frame, frac: float, seed: int) -> Frame:
    """Reference-style per-client sample, ``df.sample(frac, random_state=
    seed)`` (reference client1.py:89). Independent samples per client —
    overlap between clients is possible, exactly as in the reference."""
    n = frame_len(frame)
    idx = np.random.RandomState(seed).choice(n, round(frac * n), replace=False)
    return take_rows(frame, idx)


def _two_way_split(
    n: int, test_size: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Shuffled split matching sklearn.model_selection.train_test_split
    semantics (ceil on the test side), which the reference uses at
    client1.py:365-366."""
    n_test = int(np.ceil(n * test_size))
    n_train = int(np.floor(n * (1.0 - test_size)))
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    return perm[n_test : n_test + n_train], perm[:n_test]


def train_val_test_split(
    n: int, seed: int, val_fraction: float = 0.2, test_fraction: float = 0.2
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """60/20/20 via two chained splits, same seed for both — reference
    client1.py:365-366 (``test_size=0.4`` then ``test_size=0.5``)."""
    holdout = val_fraction + test_fraction
    train_idx, temp_idx = _two_way_split(n, holdout, seed)
    val_rel, test_rel = _two_way_split(len(temp_idx), test_fraction / holdout, seed)
    return train_idx, temp_idx[val_rel], temp_idx[test_rel]


@dataclass
class SplitArrays:
    texts: list[str]
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.texts)


@dataclass
class ClientSplits:
    client_id: int
    train: SplitArrays
    val: SplitArrays
    test: SplitArrays

    @property
    def n_train(self) -> int:
        return len(self.train)


def frame_texts(frame: Frame) -> list[str]:
    """The CICIDS2017 template over every row (reference client1.py:90)."""
    missing = [c for _, c, _ in CICIDS_TEMPLATE if c not in frame]
    if missing:
        raise KeyError(f"flow frame is missing template columns {missing}")
    return render_template(frame, CICIDS_TEMPLATE)


def frame_labels(frame: Frame, cfg: DataConfig) -> np.ndarray:
    """Binary labels: ``positive_label -> 1 else 0`` (reference
    client1.py:91)."""
    if cfg.label_column not in frame:
        raise KeyError(f"flow frame has no label column {cfg.label_column!r}")
    return (frame[cfg.label_column] == cfg.positive_label).astype(np.int32)


def _splits_from_frame(part: Frame, client_id: int, cfg: DataConfig) -> ClientSplits:
    texts, labels = frame_texts(part), frame_labels(part, cfg)
    tr, va, te = train_val_test_split(
        len(texts), cfg.client_seed(client_id), cfg.val_fraction, cfg.test_fraction
    )

    def _take(idx: np.ndarray) -> SplitArrays:
        return SplitArrays([texts[i] for i in idx], labels[idx])

    return ClientSplits(client_id, _take(tr), _take(va), _take(te))


def make_client_splits(
    frame: Frame, client_id: int, num_clients: int, cfg: DataConfig
) -> ClientSplits:
    """One client's path: sample -> textualize -> split."""
    if not 0 <= client_id < num_clients:
        raise ValueError(f"client_id {client_id} outside [0, {num_clients})")
    part = sample_client_frame(frame, cfg.data_fraction, cfg.client_seed(client_id))
    return _splits_from_frame(part, client_id, cfg)


def make_all_client_splits(
    frame: Frame, num_clients: int, cfg: DataConfig
) -> list[ClientSplits]:
    """Every client's splits, one independent sample per client seed."""
    return [make_client_splits(frame, cid, num_clients, cfg) for cid in range(num_clients)]
