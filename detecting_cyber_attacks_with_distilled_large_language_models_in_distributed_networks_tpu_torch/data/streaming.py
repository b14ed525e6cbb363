"""Two-pass streaming CSV -> per-client token arrays, for corpora larger
than RAM (the port of the JAX package's ``data/streaming.py``, rebuilt on
the ``csv`` module and numpy as :mod:`.cicids` rebuilt the loader).

The reference loads its whole CSV at once (client1.py:85): fine for the
bundled ~225k-row file, impossible for the real CIC-DDoS2019 exports (tens
of GB). This reader never holds the whole table:

* **Pass 1** (a scan, chunk by chunk): per column the sum
  and count of its finite values, for the reference's ``±inf -> NaN ->
  column-mean`` imputation (client1.py:86-88); per column its whole-file
  type (int64 when every cell is an integer, float64 when every cell is a
  number or missing, else strings, as :func:`.cicids.load_flow_csv`
  infers it over the whole file), so pass 2 renders ``443`` and
  ``443.0`` as the in-memory path does whatever chunk a row lies in; and
  the binary label vector (4 bytes a row).
* **Partition plan** (labels only): per-client row indices through the
  same ``disjoint``/``dirichlet``/``quantity`` partitioners as the
  in-memory path, then the reference's 60/20/20 split per client,
  located per chunk with ``searchsorted``.
* **Pass 2**: parse each chunk under the pinned types, impute with the
  pass-1 means, render the dataset's template, batch-encode, and scatter
  the rows into preallocated ``[N_split, max_len]`` int32 arrays.

Peak memory is the output arrays, the destination index (~17 bytes a
selected row) and one chunk. The ``sample`` scheme takes index
permutations (the corpus convention), not the reference's per-client
``df.sample``. A mean is the sum of per-chunk sums, so an imputed value
may differ from the in-memory path's in its last digit; each chunk's sum
is the JAX reader's, so the two streamed readers agree.
"""

from __future__ import annotations

import csv
from typing import Iterator

import numpy as np

from ..config import DataConfig
from .cicids import _INT, _NA_TOKENS, Frame, train_val_test_split
from .datasets import DatasetSpec, get_dataset
from .partition import partition_indices
from .pipeline import TokenizedClient, TokenizedSplit
from .tokenizer import WordPieceTokenizer

_SPLIT_NAMES = ("train", "val", "test")


class _Pass1:
    """The scan's results."""

    def __init__(self, means: dict[str, float], labels: np.ndarray, kinds: dict[str, str]):
        self.means = means
        self.labels = labels
        #: Each column's whole-file type: "int", "float" or "str".
        self.kinds = kinds


def _chunks(path: str, chunk_rows: int) -> Iterator[tuple[list[str], list[list[str]]]]:
    """``(stripped header, rows)`` chunk by chunk, values without their
    leading spaces (``pd.read_csv(skipinitialspace=True)``)."""
    with open(path, newline="") as f:
        reader = csv.reader(f, skipinitialspace=True)
        header = [c.strip() for c in next(reader)]
        rows: list[list[str]] = []
        for r in reader:
            if not r:
                continue
            rows.append(r)
            if len(rows) == chunk_rows:
                yield header, rows
                rows = []
        if rows:
            yield header, rows


def _tokens(rows: list[list[str]], j: int) -> list[str]:
    return [r[j] if j < len(r) else "" for r in rows]


def _kind(tokens: list[str]) -> str:
    """One chunk's inference for a column: "int", "float" or "str"."""
    if tokens and all(_INT.match(t) for t in tokens):
        return "int"
    try:
        for t in tokens:
            if t not in _NA_TOKENS:
                float(t)
    except ValueError:
        return "str"
    return "float"


def _floats(tokens: list[str]) -> np.ndarray:
    return np.array([np.nan if t in _NA_TOKENS else float(t) for t in tokens], dtype=np.float64)


def _parse(tokens: list[str], kind: str) -> np.ndarray:
    if kind == "int":
        return np.array([int(t) for t in tokens], dtype=np.int64)
    if kind == "float":
        return _floats(tokens)
    return np.array(tokens, dtype=object)


def _chunk_frame(header: list[str], rows: list[list[str]], kinds: dict[str, str] | None = None) -> Frame:
    """A chunk as a frame: each column under ``kinds`` (pass 2) or under
    the chunk's own inference (pass 1)."""
    out: Frame = {}
    for j, name in enumerate(header):
        tokens = _tokens(rows, j)
        out[name] = _parse(tokens, kinds[name] if kinds is not None else _kind(tokens))
    return out


def _scan(path: str, spec: DatasetSpec, cfg: DataConfig, chunk_rows: int) -> _Pass1:
    sums: dict[str, float] = {}
    counts: dict[str, int] = {}
    kinds: dict[str, str] = {}
    labels: list[np.ndarray] = []
    for header, rows in _chunks(path, chunk_rows):
        frame = _chunk_frame(header, rows)
        if spec.label_kind == "positive":
            labels.append(
                spec.binary_labels(frame, label_column=cfg.label_column, positive_value=cfg.positive_label)
            )
        else:
            labels.append(spec.binary_labels(frame))
        for col, vals in frame.items():
            chunk_kind = "str" if vals.dtype == object else ("int" if vals.dtype == np.int64 else "float")
            if chunk_kind == "str":
                kinds[col] = "str"
                continue
            vals = vals.astype(np.float64, copy=False)
            finite = np.isfinite(vals)
            if not finite.all():
                chunk_kind = "float"
            if kinds.get(col) != "str":
                kinds[col] = "float" if "float" in (chunk_kind, kinds.get(col)) else "int"
            sums[col] = sums.get(col, 0.0) + float(vals[finite].sum())
            counts[col] = counts.get(col, 0) + int(finite.sum())
    # A column with a string in ANY chunk is a string column whole-file:
    # no imputation.
    means = {c: (sums[c] / counts[c] if counts[c] else 0.0) for c in sums if kinds[c] != "str"}
    return _Pass1(means, np.concatenate(labels) if labels else np.zeros(0, np.int32), kinds)


def _impute(frame: Frame, means: dict[str, float]) -> Frame:
    for col, mean in means.items():
        vals = frame.get(col)
        if vals is None or vals.dtype != np.float64:
            continue
        bad = ~np.isfinite(vals)
        if bad.any():
            vals[bad] = mean
    return frame


def _client_split_indices(labels: np.ndarray, num_clients: int, cfg: DataConfig) -> list[dict[str, np.ndarray]]:
    """Per-client ``{train, val, test}`` -> global row indices."""
    n = len(labels)
    if cfg.partition == "sample":
        per_client = max(1, int(round(n * cfg.data_fraction)))
        parts = [
            np.random.RandomState(cfg.client_seed(cid)).permutation(n)[:per_client]
            for cid in range(num_clients)
        ]
    else:
        parts = partition_indices(labels, num_clients, cfg)
    out = []
    for cid, rows in enumerate(parts):
        tr, va, te = train_val_test_split(len(rows), cfg.client_seed(cid), cfg.val_fraction, cfg.test_fraction)
        out.append({"train": rows[tr], "val": rows[va], "test": rows[te]})
    return out


def stream_client_tokens_for(
    path: str,
    cfg: DataConfig,
    num_clients: int,
    tok: WordPieceTokenizer,
    client_ids: list[int],
    *,
    max_len: int | None = None,
    chunk_rows: int = 100_000,
) -> tuple[list[TokenizedClient], list[dict[str, int]]]:
    """Streamed token arrays for a SUBSET of the fleet's clients, plus
    every client's split sizes.

    The partition plan covers all ``num_clients`` (it must be the same
    whoever computes it); token arrays are filled only for
    ``client_ids``. Returns ``(clients in client_ids order, [{"train": n,
    "val": n, "test": n} for every client])``."""
    max_len = cfg.max_len if max_len is None else max_len
    wanted = list(client_ids)
    # Before the full-file scan: a bad id fails at once, not after the
    # I/O of a multi-GB CSV.
    bad = [c for c in wanted if not 0 <= c < num_clients]
    if bad:
        raise ValueError(f"client_ids {bad} outside [0, {num_clients})")
    spec = get_dataset(cfg.dataset)
    scan = _scan(path, spec, cfg, chunk_rows)
    plans = _client_split_indices(scan.labels, num_clients, cfg)
    sizes = [{name: int(len(plan[name])) for name in _SPLIT_NAMES} for plan in plans]

    # Destinations (wanted clients only) and one row-sorted index over
    # them: (global row, local client, split, position); a row may land in
    # several destinations under the 'sample' scheme.
    dest: list[dict[str, TokenizedSplit]] = []
    rows_l, client_l, split_l, pos_l = [], [], [], []
    for local, cid in enumerate(wanted):
        splits = {}
        for sid, name in enumerate(_SPLIT_NAMES):
            rows = plans[cid][name]
            m = len(rows)
            splits[name] = TokenizedSplit(
                np.full((m, max_len), tok.pad_id, np.int32),
                np.zeros((m, max_len), np.int32),
                scan.labels[rows].astype(np.int32),
            )
            rows_l.append(rows.astype(np.int64))
            client_l.append(np.full(m, local, np.int32))
            split_l.append(np.full(m, sid, np.int8))
            pos_l.append(np.arange(m, dtype=np.int64))
        dest.append(splits)
    rows_all = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    order = np.argsort(rows_all, kind="stable")
    rows_all = rows_all[order]
    client_all = np.concatenate(client_l)[order] if rows_l else np.zeros(0, np.int32)
    split_all = np.concatenate(split_l)[order] if rows_l else np.zeros(0, np.int8)
    pos_all = np.concatenate(pos_l)[order] if rows_l else np.zeros(0, np.int64)

    row_base = 0
    for header, rows in _chunks(path, chunk_rows):
        lo = np.searchsorted(rows_all, row_base)
        hi = np.searchsorted(rows_all, row_base + len(rows))
        if hi > lo:
            hit = rows_all[lo:hi] - row_base  # chunk-local, may repeat
            uniq, inverse = np.unique(hit, return_inverse=True)
            sub = _impute(_chunk_frame(header, [rows[i] for i in uniq], scan.kinds), scan.means)
            enc = tok.batch_encode(spec.render_texts(sub), max_len=max_len)
            for k in range(hi - lo):
                split = dest[client_all[lo + k]][_SPLIT_NAMES[split_all[lo + k]]]
                src, p = inverse[k], pos_all[lo + k]
                split.input_ids[p] = enc["input_ids"][src]
                split.attention_mask[p] = enc["attention_mask"][src]
        row_base += len(rows)

    clients = [TokenizedClient(cid, d["train"], d["val"], d["test"]) for cid, d in zip(wanted, dest)]
    return clients, sizes


def stream_client_tokens(
    path: str,
    cfg: DataConfig,
    num_clients: int,
    tok: WordPieceTokenizer,
    *,
    max_len: int | None = None,
    chunk_rows: int = 100_000,
) -> list[TokenizedClient]:
    """The streamed counterpart of ``make_all_client_splits`` +
    ``tokenize_client`` for every client; peak memory is the output
    arrays, the destination index and one chunk of the CSV."""
    clients, _ = stream_client_tokens_for(
        path, cfg, num_clients, tok, list(range(num_clients)), max_len=max_len, chunk_rows=chunk_rows
    )
    return clients
