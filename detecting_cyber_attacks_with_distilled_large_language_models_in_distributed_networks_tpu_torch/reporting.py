"""Reporting: the reference's one-row metrics CSV (the port's copy).

``save_metrics`` writes the reference's exact five-column schema
``Accuracy,Loss,Precision,Recall,F1-Score`` (reference client1.py:339-350),
so a CSV written by the port sits beside one written by the JAX package
or the reference. ``append_metrics_jsonl`` writes the JAX package's
structured metrics stream (the same record keys, schema tag and run id).
The JAX package's plots are not ported: they need matplotlib.
"""

from __future__ import annotations

import csv
import os
from typing import Mapping

import numpy as np

METRIC_COLUMNS = ("Accuracy", "Loss", "Precision", "Recall", "F1-Score")


def save_metrics(metrics: Mapping[str, float], filename: str) -> str:
    """One-row CSV in the reference's schema (reference client1.py:339-350)."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(METRIC_COLUMNS))
        writer.writeheader()
        writer.writerow({k: metrics[k] for k in METRIC_COLUMNS})
    return filename


def load_metrics(filename: str) -> dict[str, float]:
    """Inverse of ``save_metrics`` (also reads the reference's recorded CSVs)."""
    with open(filename, newline="") as f:
        row = next(csv.DictReader(f))
    return {k: float(v) for k, v in row.items()}


#: metrics-JSONL schema tag: lets ``obs`` tools and the drift monitor
#: merge streams (and reject foreign/obs-span lines) without guessing.
METRICS_SCHEMA = "fedtpu-metrics-v1"


def append_metrics_jsonl(path: str, record: Mapping[str, object]) -> None:
    """Append one structured metrics record as a JSON line (the JAX
    package's ``--metrics-jsonl`` stream): one self-describing record per
    (round, client, phase), loadable line by line. Non-scalar entries
    (probs/labels arrays, the confusion matrix) are dropped, except short
    scalar lists (<= 64 entries, e.g. the serving tier's binned
    ``score_hist``). The whole line goes down in ONE ``os.write`` on an
    ``O_APPEND`` descriptor (obs.trace.append_jsonl_line), so threads
    appending to one stream never interleave. Every record carries
    ``ts``, ``schema`` and ``run_id``."""
    import json
    import time

    from .obs.trace import append_jsonl_line, get_run_id

    def _short_scalar_list(v: object) -> list | None:
        if not isinstance(v, (list, tuple)) or len(v) > 64:
            return None
        out = []
        for x in v:
            if isinstance(x, np.generic):
                x = x.item()
            if isinstance(x, bool) or not isinstance(x, (int, float)):
                return None
            out.append(x)
        return out

    clean = {}
    for k, v in record.items():
        if isinstance(v, (str, int, float, bool, np.generic)) or v is None:
            clean[k] = v.item() if isinstance(v, np.generic) else v
        else:
            lst = _short_scalar_list(v)
            if lst is not None:
                clean[k] = lst
    clean.setdefault("ts", time.time())
    clean.setdefault("schema", METRICS_SCHEMA)
    clean.setdefault("run_id", get_run_id())
    append_jsonl_line(path, json.dumps(clean))
