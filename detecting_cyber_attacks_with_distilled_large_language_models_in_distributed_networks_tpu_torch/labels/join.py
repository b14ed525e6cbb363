"""Deterministic join of scored-request records against ground truth (the
port's copy of the JAX package's ``labels/join.py``).

The serving tier records what each model ANSWERED (the shadow plane's
paired records carry both the incumbent's and the candidate's
probability for the same live flow, keyed by the request id; the
optional scored-JSONL carries the serving answer alone). The journal
(labels/store.py) records what the flow actually WAS. This module joins
the two streams by request id and turns the intersection into the
supervised evidence the unsupervised plane cannot produce:

* per-model verdicts — accuracy, FPR, FNR over the joined set, plus
  per-class ground-truth counts (the K-class plane: class 0 is benign,
  any other class is an attack, so the binary decision arithmetic holds
  for every K);
* **coverage accounting** — joined / total scored records. Delayed
  labels mean the join is always partial; a gate that ruled on three
  joined flows out of ten thousand would be noise wearing a verdict's
  clothes, so :func:`evaluate_supervised` FAILS CLOSED below a floor;
* the supervised promotion rung — :class:`LabelGate` reads a
  candidate's mirror pairs and the journal from the registry directory
  (the control plane's one coordination surface) and rules
  candidate-vs-serving error. A candidate that flips nothing (clean
  flip-rate/PSI) but is WRONG where the incumbent was right is exactly
  the regression flip-rate cannot see — both models confidently agree
  on the wrong answer only when the candidate never disagrees, so the
  supervised rung compares each side against truth instead of against
  each other.

Everything here is pure (records in, verdicts out): same journal + same
pairs file -> bit-identical report, no clock reads in the join
arithmetic (only the spans around it read the clock).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Iterable, Mapping, Sequence

from ..obs.trace import maybe_span
from .store import LabelStore, journal_path

log = logging.getLogger(__name__)

#: Schema tag on rendered join reports.
JOINED_SCHEMA = "fedtpu-labeljoin-v1"


def supervised_verdict(
    joined: Sequence[tuple[int, int]],
) -> dict[str, Any]:
    """Binary decision metrics over ``(pred, label)`` pairs.

    ``label`` may be K-class: class 0 is benign, everything else is an
    attack, so TP/FP/FN/TN reduce over ``label != 0`` while
    ``per_class`` keeps the full K-class ground-truth histogram."""
    tp = fp = fn = tn = 0
    per_class: dict[int, int] = {}
    for pred, label in joined:
        attack = int(label) != 0
        per_class[int(label)] = per_class.get(int(label), 0) + 1
        if pred and attack:
            tp += 1
        elif pred and not attack:
            fp += 1
        elif not pred and attack:
            fn += 1
        else:
            tn += 1
    n = tp + fp + fn + tn
    return {
        "n": n,
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "tn": tn,
        "accuracy": ((tp + tn) / n) if n else None,
        "error": ((fp + fn) / n) if n else None,
        "fpr": (fp / (fp + tn)) if (fp + tn) else None,
        "fnr": (fn / (fn + tp)) if (fn + tp) else None,
        "per_class": {str(k): per_class[k] for k in sorted(per_class)},
    }


def join_records(
    records: Iterable[Mapping[str, Any]],
    labels: Mapping[str, int],
    *,
    threshold: float = 0.5,
    sides: Mapping[str, str] = (
        ("serving", "serving_prob"),
        ("candidate", "shadow_prob"),
    ),
) -> dict[str, Any]:
    """Join scored records against a rid -> label map.

    ``sides`` names each model's probability field on the record
    (shadow pair records carry ``serving_prob``/``shadow_prob``; the
    serving tier's scored-JSONL carries ``prob`` alone — pass
    ``sides={"serving": "prob"}``). A record joins when it carries a
    ``rid`` present in ``labels`` and at least one side's probability.
    Records without a rid count toward ``total`` (they were scored; the
    serving tier just wasn't exporting ids) — coverage is honest about
    the whole scored population, not the joinable subset."""
    side_items = (
        tuple(sides.items()) if isinstance(sides, Mapping) else tuple(sides)
    )
    thr = float(threshold)
    total = 0
    joined_n = 0
    per_side: dict[str, list[tuple[int, int]]] = {
        name: [] for name, _key in side_items
    }
    per_candidate: dict[str, int] = {}
    for rec in records:
        total += 1
        rid = rec.get("rid")
        if rid is None:
            continue
        label = labels.get(str(rid))
        if label is None:
            continue
        hit = False
        for name, key in side_items:
            prob = rec.get(key)
            if prob is None:
                continue
            per_side[name].append((int(float(prob) >= thr), int(label)))
            hit = True
        if hit:
            joined_n += 1
            cand = rec.get("cand")
            if cand is not None:
                per_candidate[str(cand)] = per_candidate.get(str(cand), 0) + 1
    report: dict[str, Any] = {
        "schema": JOINED_SCHEMA,
        "total": total,
        "joined": joined_n,
        "coverage": (joined_n / total) if total else 0.0,
        "threshold": thr,
        "models": {
            name: supervised_verdict(per_side[name])
            for name, _key in side_items
        },
    }
    if per_candidate:
        report["per_candidate_joined"] = {
            k: per_candidate[k] for k in sorted(per_candidate)
        }
    return report


def evaluate_supervised(
    report: Mapping[str, Any],
    *,
    min_joined: int,
    coverage_floor: float,
    max_regression: float,
) -> tuple[bool, str]:
    """The supervised gate's verdict arithmetic over one join report —
    a pure function shared by the in-process and cross-process gates.
    Fails closed: too few joined flows, coverage under the floor, or an
    uncomputable error on either side are all refusals."""
    joined = int(report.get("joined", 0) or 0)
    if joined < int(min_joined):
        return False, (
            f"insufficient ground truth: {joined} joined flow(s) < "
            f"min_joined={min_joined}"
        )
    coverage = float(report.get("coverage", 0.0) or 0.0)
    if coverage < float(coverage_floor):
        return False, (
            f"label coverage {coverage:.4f} < floor={coverage_floor} "
            f"over {int(report.get('total', 0) or 0)} scored record(s)"
        )
    models = report.get("models") or {}
    serving_err = (models.get("serving") or {}).get("error")
    candidate_err = (models.get("candidate") or {}).get("error")
    if serving_err is None or candidate_err is None:
        return False, (
            "supervised error uncomputable on "
            f"{'serving' if serving_err is None else 'candidate'} side "
            f"over {joined} joined flow(s)"
        )
    if float(candidate_err) > float(serving_err) + float(max_regression):
        return False, (
            f"supervised regression: candidate error "
            f"{float(candidate_err):.4f} > serving "
            f"{float(serving_err):.4f} + {max_regression} over "
            f"{joined} joined flow(s)"
        )
    return True, (
        f"supervised agreement: candidate error "
        f"{float(candidate_err):.4f} <= serving "
        f"{float(serving_err):.4f} + {max_regression} over "
        f"{joined} joined flow(s) at coverage {coverage:.4f}"
    )


def read_pair_records(path: str) -> list[dict]:
    """The shadow plane's paired records, tolerating torn tails and
    foreign lines (same reader discipline as the journal replay)."""
    from ..shadow.compare import PAIR_SCHEMA

    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and rec.get("schema") == PAIR_SCHEMA:
                    out.append(rec)
    except OSError:
        return []
    return out


class LabelGate:
    """The supervised promotion rung over a candidate's mirror pairs.

    ``evaluate(aid)`` loads the ground-truth journal, joins it against
    ``<registry>/shadow/<aid>.pairs.jsonl``, and rules candidate-vs-
    serving error — returning ``(ok, verdict)`` exactly like
    ``ShadowGate.wait``, so the controller stacks the two rungs. The
    whole decision is a file read + pure arithmetic: no polling loop —
    by the time this gate runs, the shadow gate has already waited for
    the pairs to exist; labels either cover them or the gate refuses."""

    def __init__(
        self,
        registry_root: str,
        *,
        journal: str | None = None,
        threshold: float = 0.5,
        min_joined: int = 32,
        coverage_floor: float = 0.05,
        max_regression: float = 0.0,
        tracer=None,
    ):
        if int(min_joined) < 1:
            raise ValueError(f"min_joined={min_joined} must be >= 1")
        if not 0.0 <= float(coverage_floor) <= 1.0:
            raise ValueError(
                f"coverage_floor={coverage_floor} must be in [0, 1]"
            )
        if float(max_regression) < 0.0:
            raise ValueError(
                f"max_regression={max_regression} must be >= 0"
            )
        self.registry_root = os.path.abspath(registry_root)
        self.journal = journal or journal_path(self.registry_root)
        self.threshold = float(threshold)
        self.min_joined = int(min_joined)
        self.coverage_floor = float(coverage_floor)
        self.max_regression = float(max_regression)
        self.tracer = tracer

    def join(self, aid: str) -> dict[str, Any]:
        """The join report for one shadow-state candidate's pairs."""
        from ..shadow.gate import pairs_path

        store = LabelStore(self.journal)
        store.load()
        records = read_pair_records(pairs_path(self.registry_root, aid))
        # Secondary ranked candidates tag their pairs with "cand" — the
        # gated verdict covers the primary candidate's pairs only.
        records = [r for r in records if not r.get("cand")]
        # The span reads the clock; the join arithmetic inside is pure.
        with maybe_span(self.tracer, "label-join", artifact=aid) as span:
            report = join_records(
                records, store.labels_map(), threshold=self.threshold
            )
            report["watermark"] = store.watermark
            span.update(
                total=report["total"],
                joined=report["joined"],
                coverage=round(report["coverage"], 6),
            )
        return report

    def evaluate(self, aid: str) -> tuple[bool, dict]:
        """(ok, verdict) for one candidate — the supervised analogue of
        ``ShadowGate.wait`` (no wait: rules on the evidence as it sits)."""
        with maybe_span(self.tracer, "label-gate", artifact=aid) as span:
            report = self.join(aid)
            ok, reason = evaluate_supervised(
                report,
                min_joined=self.min_joined,
                coverage_floor=self.coverage_floor,
                max_regression=self.max_regression,
            )
            models = report.get("models") or {}
            verdict = {
                "ok": bool(ok),
                "reason": reason,
                "joined": report["joined"],
                "total": report["total"],
                "coverage": round(report["coverage"], 6),
                "watermark": report.get("watermark"),
                "serving_error": (models.get("serving") or {}).get("error"),
                "candidate_error": (models.get("candidate") or {}).get("error"),
                "min_joined": self.min_joined,
                "coverage_floor": self.coverage_floor,
                "max_regression": self.max_regression,
            }
            span.update(
                passed=bool(ok),
                joined=verdict["joined"],
                coverage=verdict["coverage"],
                serving_error=verdict["serving_error"],
                candidate_error=verdict["candidate_error"],
            )
        log.info(
            f"[LABELS] supervised gate verdict for {aid}: "
            f"{'PASS' if ok else 'FAIL'} ({reason})"
        )
        return ok, verdict
