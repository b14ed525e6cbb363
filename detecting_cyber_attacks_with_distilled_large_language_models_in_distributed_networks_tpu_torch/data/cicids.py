"""Flow CSV loading, imputation, per-client partitioning and splits.

The port's copy of the JAX package's ``data/cicids.py``, without pandas:
a frame is a dict of equal-length numpy columns in CSV column order.

* CSV load with headers stripped; ``±inf -> NaN``; NaN -> column mean
  (numeric columns only) — reference client1.py:86-88.
* The reference's partition (``partition="sample"``): a per-client
  ``df.sample(frac, random_state=seed)``, which draws
  ``RandomState(seed).choice(n, round(frac * n), replace=False)``; client
  i uses seed ``seed_base + i`` (42, 43, ... as in the reference). The
  index-based schemes (``disjoint``, ``dirichlet``, ``quantity``) cut one
  partition of the whole frame (data/partition.py).
* 60/20/20 train/val/test via two chained shuffled splits with the same
  seed — reference client1.py:365-366.
* Texts and labels through the configured dataset's spec
  (data/datasets.py): for CICIDS2017 the template of reference
  client1.py:68-81 and ``'DDoS' -> 1 else 0`` (client1.py:91).
* A schema-erased :class:`~.datasets.Corpus` (``--source``, possibly
  several datasets) partitions by row index the same way.
"""

from __future__ import annotations

import csv
import re
from dataclasses import dataclass

import numpy as np

from ..config import DataConfig
from .datasets import CICIDS2017, Corpus, DatasetSpec, get_dataset
from .partition import log_manifest, partition_indices, partition_manifest, save_manifest

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


def frame_texts(frame: Frame, spec: DatasetSpec = CICIDS2017) -> list[str]:
    """The dataset's template over every row (for CICIDS2017, reference
    client1.py:90)."""
    return spec.render_texts(frame)


def frame_labels(frame: Frame, cfg: DataConfig) -> np.ndarray:
    """Binary labels under the configured dataset's spec; for a
    positive-match spec (CICIDS2017) the config's ``label_column`` and
    ``positive_label`` apply (reference client1.py:91)."""
    spec = get_dataset(cfg.dataset)
    if spec.label_kind == "positive":
        return spec.binary_labels(
            frame, label_column=cfg.label_column, positive_value=cfg.positive_label
        )
    return spec.binary_labels(frame)


def _splits_from_arrays(
    texts: list[str], labels: np.ndarray, client_id: int, cfg: DataConfig
) -> ClientSplits:
    tr, va, te = train_val_test_split(
        len(texts), cfg.client_seed(client_id), cfg.val_fraction, cfg.test_fraction
    )

    def _take(idx: np.ndarray) -> SplitArrays:
        return SplitArrays([texts[i] for i in idx], labels[idx])

    return ClientSplits(client_id, _take(tr), _take(va), _take(te))


def _splits_from_frame(part: Frame, client_id: int, cfg: DataConfig) -> ClientSplits:
    texts = frame_texts(part, get_dataset(cfg.dataset))
    return _splits_from_arrays(texts, frame_labels(part, cfg), client_id, cfg)


def _all_client_frames(frame: Frame, num_clients: int, cfg: DataConfig) -> list[Frame]:
    """Every client's rows: one sample per client seed, or one
    index-based partition of the whole frame."""
    if cfg.partition == "sample":
        return [
            sample_client_frame(frame, cfg.data_fraction, cfg.client_seed(cid))
            for cid in range(num_clients)
        ]
    parts = partition_indices(frame_labels(frame, cfg), num_clients, cfg)
    return [take_rows(frame, idx) for idx in parts]


def make_client_splits(
    frame: Frame, client_id: int, num_clients: int, cfg: DataConfig
) -> ClientSplits:
    """One client's path: partition -> textualize -> split."""
    if not 0 <= client_id < num_clients:
        raise ValueError(f"client_id {client_id} outside [0, {num_clients})")
    if cfg.partition == "sample":
        part = sample_client_frame(frame, cfg.data_fraction, cfg.client_seed(client_id))
    else:
        part = _all_client_frames(frame, num_clients, cfg)[client_id]
    return _splits_from_frame(part, client_id, cfg)


def make_all_client_splits(
    frame: Frame, num_clients: int, cfg: DataConfig, *, manifest_path: str | None = None
) -> list[ClientSplits]:
    """Every client's splits, the partition computed once. The
    per-client label-histogram manifest is logged, and written as JSON
    when ``manifest_path`` is given (data/partition.py)."""
    frames = _all_client_frames(frame, num_clients, cfg)
    manifest = partition_manifest(
        [frame_labels(p, cfg) for p in frames], cfg=cfg, total_rows=frame_len(frame)
    )
    log_manifest(manifest)
    if manifest_path:
        save_manifest(manifest, manifest_path)
    return [_splits_from_frame(p, cid, cfg) for cid, p in enumerate(frames)]


def make_all_client_splits_from_corpus(
    corpus: Corpus, num_clients: int, cfg: DataConfig, *, manifest_path: str | None = None
) -> list[ClientSplits]:
    """Every client's splits over a schema-erased (possibly mixed) corpus.

    ``sample`` takes the first ``round(n * data_fraction)`` rows of a
    ``RandomState(client seed)`` permutation per client; the index-based
    schemes cut :func:`partition_indices` over the corpus labels. A
    client's shard can span source datasets."""
    n = len(corpus)
    if cfg.partition == "sample":
        per_client = max(1, int(round(n * cfg.data_fraction)))
        parts = [
            np.random.RandomState(cfg.client_seed(cid)).permutation(n)[:per_client]
            for cid in range(num_clients)
        ]
    else:
        parts = partition_indices(corpus.labels, num_clients, cfg)
    manifest = partition_manifest([corpus.labels[idx] for idx in parts], cfg=cfg, total_rows=n)
    log_manifest(manifest)
    if manifest_path:
        save_manifest(manifest, manifest_path)
    return [
        _splits_from_arrays([corpus.texts[i] for i in idx], corpus.labels[idx], cid, cfg)
        for cid, idx in enumerate(parts)
    ]
