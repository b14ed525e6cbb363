"""Append-only ground-truth journal: ``fedtpu-label-v1`` JSONL (the
port's copy of the JAX package's ``labels/store.py``).

Ground truth for DDoS flows arrives LATE — from incident review, abuse
reports, honeypot confirmation — hours after the scoring tier answered,
out of order, sometimes twice, sometimes contradicting an earlier
verdict. The journal is built for exactly that arrival discipline:

* every ingested label is one ATOMIC appended line (the obs/trace.py
  append discipline — concurrent writers can never interleave partial
  lines), keyed by the request id (``rid``) the serving tier stamps on
  every scored flow;
* in-memory state is a last-writer-wins map by the CALLER-SUPPLIED
  label timestamp: a duplicate (same label) counts on ``duplicates``, a
  conflicting re-label counts on ``conflicts`` and the newer timestamp
  wins (a strictly-older conflicting arrival is counted but does not
  overwrite);
* a monotone **watermark** — "labels are complete through T" — is an
  explicit journal record, never inferred: labels arriving with
  ``ts <= watermark`` still apply but count on ``late`` (evidence the
  upstream labeler's completeness promise was optimistic, and the
  reason the join layer reports coverage instead of trusting it);
* ``load()`` replays the journal tolerating torn tails and foreign
  lines, so a store can be rebuilt from the file by any process (the
  gate, the CLI, the drift monitor) without coordination beyond the
  filesystem.

Timestamps are caller-supplied throughout: replaying a journal must
rebuild bit-identical state, so nothing here reads a clock.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Iterator

from ..obs import metrics as obs_metrics
from ..obs.trace import append_jsonl_line

#: Schema tag on every journal line, so stream consumers can reject
#: foreign JSONL lines when files get concatenated.
LABEL_SCHEMA = "fedtpu-label-v1"


def labels_dir(registry_root: str) -> str:
    """Where the ground-truth plane's files land (under the registry
    root — the control plane's one coordination directory)."""
    return os.path.join(os.path.abspath(registry_root), "labels")


def journal_path(registry_root: str) -> str:
    return os.path.join(labels_dir(registry_root), "journal.jsonl")


class LabelStore:
    """The journal plus its replayable in-memory projection.

    ``ingest``/``advance_watermark`` append one line and apply it;
    ``load`` replays an existing journal through the SAME apply path,
    so a store rebuilt from disk is bit-identical to the one that wrote
    it (the determinism contract the crc scope pins)."""

    def __init__(self, path: str, *, tracer=None):
        self.path = os.path.abspath(path)
        self.tracer = tracer
        self._lock = threading.Lock()
        # rid -> (ts, label): last-writer-wins by caller-supplied ts.
        self._labels: dict[str, tuple[float, int]] = {}
        self._watermark: float | None = None
        self._ingested = 0
        self._duplicates = 0
        self._conflicts = 0
        self._late = 0
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's labels/store.py family, same name/kind/labels/help
        self._m_ingested = m.counter(
            "fedtpu_labels_ingested_total",
            help="ground-truth label records applied to the journal",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's labels/store.py family, same name/kind/labels/help
        self._m_conflicts = m.counter(
            "fedtpu_labels_conflicts_total",
            help="label arrivals that contradicted an earlier label "
            "for the same request id (last-writer-wins by ts)",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's labels/store.py family, same name/kind/labels/help
        self._m_late = m.counter(
            "fedtpu_labels_late_total",
            help="label arrivals timestamped at or before the "
            "completeness watermark",
        )

    # ------------------------------------------------------------- ingestion
    def ingest(self, rid: str, label: int, *, ts: float) -> bool:
        """Journal + apply one ground-truth label.

        ``ts`` is the labeler's timestamp (caller-supplied — nothing in
        this module reads a clock). Returns True when the label changed
        the projection (new rid, or a conflicting newer arrival)."""
        rec = {
            "schema": LABEL_SCHEMA,
            "rid": str(rid),
            "label": int(label),
            "ts": float(ts),
        }
        append_jsonl_line(self.path, json.dumps(rec))
        return self._apply_label(rec)

    def advance_watermark(self, ts: float) -> float:
        """Journal + apply "labels are complete through ``ts``".

        Monotone: an older watermark never rewinds a newer one (the
        record is still journaled — replay sees the same sequence)."""
        rec = {"schema": LABEL_SCHEMA, "watermark": float(ts)}
        append_jsonl_line(self.path, json.dumps(rec))
        self._apply_watermark(rec)
        with self._lock:
            return float(self._watermark or 0.0)

    def _apply_label(self, rec: dict) -> bool:
        rid = str(rec["rid"])
        label = int(rec["label"])
        ts = float(rec["ts"])
        with self._lock:
            if self._watermark is not None and ts <= self._watermark:
                self._late += 1
                self._m_late.inc()
            prev = self._labels.get(rid)
            if prev is None:
                self._labels[rid] = (ts, label)
                self._ingested += 1
                self._m_ingested.inc()
                return True
            if prev[1] == label:
                self._duplicates += 1
                return False
            self._conflicts += 1
            self._m_conflicts.inc()
            if ts >= prev[0]:
                # Last-writer-wins: the newer labeler verdict stands.
                self._labels[rid] = (ts, label)
                return True
            return False

    def _apply_watermark(self, rec: dict) -> None:
        ts = float(rec["watermark"])
        with self._lock:
            if self._watermark is None or ts > self._watermark:
                self._watermark = ts

    def load(self) -> int:
        """Replay the journal from disk (tolerating a torn tail and
        foreign JSONL lines). Returns the number of applied records."""
        applied = 0
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail / foreign writer
                    if not isinstance(rec, dict) or (
                        rec.get("schema") != LABEL_SCHEMA
                    ):
                        continue
                    if "watermark" in rec:
                        self._apply_watermark(rec)
                        applied += 1
                    elif "rid" in rec and "label" in rec and "ts" in rec:
                        self._apply_label(rec)
                        applied += 1
        except OSError:
            return 0
        return applied

    # --------------------------------------------------------------- readers
    @property
    def watermark(self) -> float | None:
        with self._lock:
            return self._watermark

    def get(self, rid: str) -> int | None:
        with self._lock:
            hit = self._labels.get(str(rid))
            return None if hit is None else hit[1]

    def labels_map(self) -> dict[str, int]:
        """rid -> label snapshot, sorted by rid (a deterministic
        iteration order for every downstream join/fold)."""
        with self._lock:
            items = sorted(self._labels.items())
        return {rid: label for rid, (_ts, label) in items}

    def __len__(self) -> int:
        with self._lock:
            return len(self._labels)

    def __iter__(self) -> Iterator[str]:
        with self._lock:
            rids = sorted(self._labels)
        return iter(rids)

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {
                "schema": LABEL_SCHEMA,
                "path": self.path,
                "labels": len(self._labels),
                "watermark": self._watermark,
                "ingested": self._ingested,
                "duplicates": self._duplicates,
                "conflicts": self._conflicts,
                "late": self._late,
            }
