"""Delayed ground-truth plane (the port's copy of the JAX package's
``labels/``: the same journal and join, so either package reads what the
other wrote).

A DDoS platform eventually learns which flows were attacks — hours or
days after the scoring tier answered. This package turns that delayed
signal into a first-class control-plane input:

* :mod:`labels.store` — an append-only, atomically-written ground-truth
  journal (``fedtpu-label-v1`` JSONL) keyed by the request ids the
  serving tier stamps, tolerant of late / out-of-order / duplicate /
  conflicting arrivals, with a monotone "labels complete through T"
  watermark;
* :mod:`labels.join` — a deterministic join of scored-request records
  (shadow mirror pairs, serving scored-JSONL) against the journal,
  producing per-model supervised verdicts (accuracy / FPR / FNR,
  per-class counts) with coverage accounting, plus the supervised
  promotion gate (:class:`LabelGate`) the controller stacks on top of
  the unsupervised shadow gate.
"""

from .join import (
    JOINED_SCHEMA,
    LabelGate,
    evaluate_supervised,
    join_records,
    supervised_verdict,
)
from .store import (
    LABEL_SCHEMA,
    LabelStore,
    journal_path,
    labels_dir,
)

__all__ = [
    "JOINED_SCHEMA",
    "LABEL_SCHEMA",
    "LabelGate",
    "LabelStore",
    "evaluate_supervised",
    "join_records",
    "journal_path",
    "labels_dir",
    "supervised_verdict",
]
