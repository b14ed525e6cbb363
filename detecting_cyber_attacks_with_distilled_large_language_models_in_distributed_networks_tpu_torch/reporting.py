"""Reporting: the reference's one-row metrics CSV (the port's copy).

``save_metrics`` writes the reference's exact five-column schema
``Accuracy,Loss,Precision,Recall,F1-Score`` (reference client1.py:339-350),
so a CSV written by the port sits beside one written by the JAX package
or the reference. The JAX package's plots are not ported: they need
matplotlib.
"""

from __future__ import annotations

import csv
import os
from typing import Mapping

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
