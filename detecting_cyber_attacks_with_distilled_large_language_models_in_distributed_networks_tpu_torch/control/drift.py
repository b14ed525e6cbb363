"""Score-distribution drift: PSI/KS over serving-score histograms (the
port's copy of the JAX package's ``control/drift.py``: numpy on the host,
the same verdicts on the same inputs).

The detector's output distribution is the cheapest drift signal a
deployment already has: every scored flow produces one P(attack), the
serving tier bins them (serving/server.py exports a per-batch
``score_hist`` on the metrics-JSONL channel), and the promoted
artifact's manifest carries the histogram of the SAME model's scores on
the held-out eval split (train/fedeval.reference_histogram). When live
traffic stops looking like the validation traffic — new attack family,
topology change, seasonal shift — the two histograms diverge long before
anyone labels a flow.

Two standard distances over the binned distributions:

* **PSI** (population stability index): ``sum((o - e) * ln(o / e))``
  over bin fractions, the industry-standard monitoring score; > 0.25 is
  the classic "significant shift, retrain" bound.
* **KS**: max absolute CDF gap — bounded [0, 1], less sensitive to
  tail bins than PSI's log ratio.

:class:`DriftMonitor` tails the serving metrics-JSONL incrementally
(byte-offset resume, partial trailing lines left for the next poll) and
fires a verdict once enough scores accumulated AND the distance crosses
the threshold. Firing resets the observation window — one burst of
drifted traffic triggers one round, not one round per poll.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any

import numpy as np

log = logging.getLogger(__name__)

_EPS = 1e-4  # empty-bin smoothing: PSI's log ratio must never see a zero


def _fractions(counts: Any) -> np.ndarray:
    c = np.asarray(counts, np.float64).ravel()
    if c.ndim != 1 or c.size < 2 or (c < 0).any():
        raise ValueError(f"histogram counts must be a 1-D >=2-bin non-negative array, got {c!r}")
    total = c.sum()
    if total <= 0:
        raise ValueError("histogram has no mass")
    return c / total


def _psi_terms(expected: Any, observed: Any) -> tuple:
    """(per-bin PSI terms, clipped e fractions, clipped o fractions) —
    the ONE copy of the clip/renormalize/term arithmetic both
    :func:`psi` (their sum) and :func:`psi_contributions` (their
    ranking) are defined over, so the localization decomposes the
    reported distance EXACTLY by construction."""
    e = np.clip(_fractions(expected), _EPS, None)
    o = np.clip(_fractions(observed), _EPS, None)
    if e.shape != o.shape:
        raise ValueError(f"bin count mismatch: {e.shape} vs {o.shape}")
    # Renormalize after clipping so both still sum to 1.
    e, o = e / e.sum(), o / o.sum()
    return (o - e) * np.log(o / e), e, o


def psi(expected: Any, observed: Any) -> float:
    """Population stability index between two count histograms (same
    binning). 0 = identical; > 0.25 = significant shift (classic bound)."""
    terms, _, _ = _psi_terms(expected, observed)
    return float(np.sum(terms))


def psi_contributions(
    expected: Any, observed: Any, *, top_k: int = 3
) -> list[dict]:
    """Per-bin PSI localization: WHICH score region moved.

    PSI is a sum of per-bin terms ``(o_i - e_i) * ln(o_i / e_i)`` (each
    >= 0 after the clipping both :func:`psi` and this function apply),
    so the bins sorted by term ARE the drift's location. A page that
    says "PSI 0.4" sends the operator histogram-diffing; one that says
    "bin 9 (the top score decile) holds 80% of the shift" says a new
    attack family is scoring hot — the ROADMAP's drift-localization
    residual. Ties break toward the lower bin index (deterministic
    output for identical inputs).

    Returns the ``top_k`` bins as ``{"bin": i, "psi": term,
    "expected_frac": e_i, "observed_frac": o_i}``, largest term first,
    zero-contribution bins omitted. Built on the SAME ``_psi_terms``
    arithmetic as :func:`psi`, so ``sum(term over ALL bins) == psi()``
    exactly by construction.
    """
    terms, e, o = _psi_terms(expected, observed)
    order = sorted(
        range(terms.size), key=lambda i: (-terms[i], i)
    )[: max(int(top_k), 0)]
    return [
        {
            "bin": int(i),
            "psi": round(float(terms[i]), 6),
            "expected_frac": round(float(e[i]), 6),
            "observed_frac": round(float(o[i]), 6),
        }
        for i in order
        if terms[i] > 0.0
    ]


def cadence_interval_s(
    drift: float,
    *,
    threshold: float,
    min_s: float,
    max_s: float | None,
    urgency_span: float = 2.0,
) -> float:
    """Adaptive round cadence: map a fired verdict's drift MAGNITUDE to
    the controller's next inter-round interval.

    A verdict always means ``drift >= threshold``, but 0.26 and 2.6 are
    different emergencies: the first is a slow seasonal shift the fleet
    can absorb on a relaxed cadence, the second is a new attack family
    scoring hot right now. Linear interpolation between the configured
    bounds: at the bare threshold the interval stays at ``max_s`` (the
    relaxed clock), at ``urgency_span * threshold`` or beyond it floors
    at ``min_s`` (back-to-back throttle only). Pure arithmetic — no
    clock reads, unit-testable from synthetic verdicts — and with
    ``max_s`` unset (purely drift-driven campaigns with no clock at
    all) it degrades to ``min_s``.
    """
    min_s = float(min_s)
    if max_s is None or float(max_s) <= min_s:
        return min_s
    threshold = float(threshold)
    hi = threshold * float(urgency_span)
    if hi <= threshold:
        return min_s
    frac = (float(drift) - threshold) / (hi - threshold)
    frac = min(max(frac, 0.0), 1.0)
    return float(max_s) - (float(max_s) - min_s) * frac


def drift_cohort_fraction(
    drift: float,
    *,
    threshold: float,
    min_frac: float,
    max_frac: float,
    urgency_span: float = 2.0,
) -> float:
    """Drift-scaled client sampling: map a fired verdict's drift
    MAGNITUDE to the fraction of the fleet the next round must hear
    from (cadence adapts via :func:`cadence_interval_s`; cohort SIZE
    does too).

    The inverse shape of the cadence map: at the bare threshold the
    round keeps the small steady-state quorum (``min_frac`` of the
    fleet — a routine refresh), at ``urgency_span * threshold`` or
    beyond it demands ``max_frac`` (a new attack family needs the
    widest, most representative update the fleet can produce — exactly
    when label-skewed non-IID cohorts mislead the most). Pure
    arithmetic, same interpolation discipline as the cadence map, so
    one unit test pins both ends and the midpoint.
    """
    min_frac = min(max(float(min_frac), 0.0), 1.0)
    max_frac = min(max(float(max_frac), 0.0), 1.0)
    if max_frac <= min_frac:
        return min_frac
    threshold = float(threshold)
    hi = threshold * float(urgency_span)
    if hi <= threshold:
        return max_frac
    frac = (float(drift) - threshold) / (hi - threshold)
    frac = min(max(frac, 0.0), 1.0)
    return min_frac + (max_frac - min_frac) * frac


def ks_distance(expected: Any, observed: Any) -> float:
    """Max absolute CDF gap between two count histograms (same binning)."""
    e = _fractions(expected)
    o = _fractions(observed)
    if e.shape != o.shape:
        raise ValueError(f"bin count mismatch: {e.shape} vs {o.shape}")
    return float(np.max(np.abs(np.cumsum(o) - np.cumsum(e))))


class DriftMonitor:
    """Accumulate live serving-score histograms; fire on distribution
    shift vs the promoted artifact's eval reference.

    Sources compose: :meth:`observe` ingests a histogram directly (tests,
    in-process wiring) and :meth:`poll` tails a serving metrics-JSONL
    file for ``serve_batch`` records carrying ``score_hist`` (the
    cross-process wiring — ``fedtpu infer-serve --metrics-jsonl X`` plus
    ``fedtpu controller --drift-jsonl X``). Either way :meth:`check`
    decides; a fired verdict resets the window.

    The reference histogram is per-PROMOTION state: the controller calls
    :meth:`set_reference` with each newly promoted artifact's eval
    histogram, which also resets the window (scores produced by the old
    model must not count against the new reference).
    """

    def __init__(
        self,
        jsonl_path: str | None = None,
        *,
        reference: Any | None = None,
        threshold: float = 0.25,
        min_scores: int = 256,
        method: str = "psi",
        window_scores: int | None = None,
    ):
        if method not in ("psi", "ks"):
            raise ValueError(f"method={method!r} must be 'psi' or 'ks'")
        if threshold <= 0.0:
            raise ValueError(f"threshold={threshold} must be > 0")
        self.jsonl_path = jsonl_path
        self.threshold = float(threshold)
        self.min_scores = int(min_scores)
        self.method = method
        # Observation-window cap (exponential decay): once the window
        # holds this many scores, each new ingestion halves the existing
        # counts — an UNBOUNDED window would let a week of stable traffic
        # dilute a fresh shift so far below threshold that the trigger
        # fires days late (recent traffic must stay a constant fraction
        # of the window). Default: 64x the verdict floor.
        self.window_scores = (
            64 * self.min_scores if window_scores is None else int(window_scores)
        )
        if self.window_scores < self.min_scores:
            raise ValueError(
                f"window_scores={self.window_scores} below "
                f"min_scores={self.min_scores}"
            )
        self._ref: np.ndarray | None = None
        self._obs: np.ndarray | None = None
        self._offset = 0  # resume point into the JSONL tail
        if reference is not None:
            self.set_reference(reference)

    # ------------------------------------------------------------ ingestion
    def set_reference(self, counts: Any) -> None:
        """Adopt a newly promoted artifact's eval histogram; resets the
        observation window (old-model scores must not fire against it)
        AND fast-forwards the JSONL tail to end-of-file — records already
        on disk were scored by the OLD model (during the training round,
        or a whole backlog on controller restart) and counting them
        against the new reference would fire a spurious round right after
        every promotion."""
        self._ref = np.asarray(counts, np.int64).ravel()
        _fractions(self._ref)  # validate now, not at check time
        self.reset_window()
        if self.jsonl_path is not None:
            try:
                self._offset = os.path.getsize(self.jsonl_path)
            except OSError:
                self._offset = 0

    def reset_window(self) -> None:
        self._obs = None

    @property
    def has_reference(self) -> bool:
        return self._ref is not None

    @property
    def observed_scores(self) -> int:
        return 0 if self._obs is None else int(self._obs.sum())

    def observe(self, counts: Any) -> None:
        c = np.asarray(counts, np.int64).ravel()
        if (c < 0).any():
            # Validate on INGESTION, not at check(): a malformed record in
            # the tailed JSONL must be skipped by _ingest_jsonl's guard,
            # never poison the window and crash the controller daemon at
            # verdict time.
            raise ValueError(f"negative histogram counts {c.tolist()}")
        if self._ref is not None and c.shape != self._ref.shape:
            raise ValueError(
                f"observed histogram has {c.size} bins, reference has "
                f"{self._ref.size} — serving and eval must bin identically"
            )
        if self._obs is None:
            self._obs = c
        else:
            if self._obs.sum() >= self.window_scores:
                self._obs //= 2  # decay old traffic; recency must matter
            self._obs = self._obs + c

    def poll(self) -> dict | None:
        """Tail the JSONL for new ``serve_batch`` score histograms, then
        :meth:`check`. Returns the fired verdict dict or None."""
        if self.jsonl_path is not None:
            self._ingest_jsonl()
        return self.check()

    def _ingest_jsonl(self) -> None:
        # Shared incremental tail (obs/timeline.py): complete lines
        # only, truncation restarts at 0, missing file is empty.
        from ..obs.timeline import read_new_jsonl_lines

        self._offset, lines = read_new_jsonl_lines(
            self.jsonl_path, self._offset
        )
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("phase") != "serve_batch":
                continue
            hist = rec.get("score_hist")
            if isinstance(hist, list) and hist:
                try:
                    self.observe(hist)
                except ValueError as e:
                    log.warning(f"[DRIFT] skipping malformed score_hist: {e}")

    # -------------------------------------------------------------- verdict
    def distance(self) -> tuple[float | None, int]:
        """(current distance or None when undecidable, scores observed)."""
        n = self.observed_scores
        if self._ref is None or self._obs is None or n == 0:
            return None, n
        fn = psi if self.method == "psi" else ks_distance
        return fn(self._ref, self._obs), n

    def check(self) -> dict | None:
        """Fire when >= min_scores accumulated and distance >= threshold.
        A fired verdict resets the window."""
        d, n = self.distance()
        if d is None or n < self.min_scores:
            return None
        if d < self.threshold:
            return None
        verdict = {
            "drift": round(d, 6),
            "method": self.method,
            "threshold": self.threshold,
            "scores": n,
            # Localization: the top per-bin PSI contributions (computed
            # regardless of the verdict method — PSI's additive terms
            # are the localization; KS's max-gap is not decomposable).
            "top_bins": psi_contributions(self._ref, self._obs),
        }
        top = verdict["top_bins"]
        where = (
            ", ".join(
                f"bin {b['bin']} ({b['psi']:.3f})" for b in top
            )
            if top
            else "no single bin dominates"
        )
        log.info(
            f"[DRIFT] {self.method}={d:.4f} >= {self.threshold} over {n} "
            f"live scores — triggering a training round (moved: {where})"
        )
        self.reset_window()
        return verdict


class ErrorRateMonitor:
    """Supervised drift: the serving model's measured error over joined
    ground truth (labels/join.py) vs its reference error.

    PSI/KS fire when the traffic stops LOOKING like the validation
    split; they are blind to traffic that looks the same but is now
    labeled differently (an attack family the model scores cold —
    volatile encrypted-flow distributions make the score-only trigger
    noisy in both directions). This monitor consumes the delayed
    ground-truth plane instead: ingest joined ``(wrong, total)`` counts
    — e.g. a join report's serving-side verdict — and fire once enough
    joined flows accumulated AND the error rate exceeds the reference
    by ``margin``. Same lifecycle as :class:`DriftMonitor`: a fired
    verdict resets the window, and the controller re-references on each
    promotion (the new model's error anchors the next comparison).
    """

    def __init__(
        self,
        *,
        reference_error: float | None = None,
        margin: float = 0.05,
        min_joined: int = 64,
    ):
        if float(margin) <= 0.0:
            raise ValueError(f"margin={margin} must be > 0")
        if int(min_joined) < 1:
            raise ValueError(f"min_joined={min_joined} must be >= 1")
        self.margin = float(margin)
        self.min_joined = int(min_joined)
        self._ref: float | None = None
        self._wrong = 0
        self._total = 0
        if reference_error is not None:
            self.set_reference(reference_error)

    # ------------------------------------------------------------ ingestion
    def set_reference(self, error: float) -> None:
        if not 0.0 <= float(error) <= 1.0:
            raise ValueError(f"reference error {error} must be in [0, 1]")
        self._ref = float(error)
        self.reset_window()

    def reset_window(self) -> None:
        self._wrong = 0
        self._total = 0

    @property
    def has_reference(self) -> bool:
        return self._ref is not None

    @property
    def observed_joined(self) -> int:
        return self._total

    def observe(self, wrong: int, total: int) -> None:
        if int(wrong) < 0 or int(total) < int(wrong):
            raise ValueError(
                f"need 0 <= wrong <= total, got wrong={wrong} total={total}"
            )
        self._wrong += int(wrong)
        self._total += int(total)

    def observe_verdict(self, verdict: Any) -> None:
        """Ingest one supervised verdict dict (labels/join.py
        ``supervised_verdict`` shape: ``n`` joined flows, ``error``)."""
        n = int(verdict.get("n", 0) or 0)
        err = verdict.get("error")
        if n > 0 and err is not None:
            self.observe(round(float(err) * n), n)

    # -------------------------------------------------------------- verdict
    def check(self) -> dict | None:
        """Fire when >= min_joined flows joined and the measured error
        exceeds reference + margin. A fired verdict resets the window."""
        if self._ref is None or self._total < self.min_joined:
            return None
        err = self._wrong / self._total
        if err < self._ref + self.margin:
            return None
        verdict = {
            "drift": round(err - self._ref, 6),
            "method": "error_rate",
            "threshold": self.margin,
            "scores": self._total,
            "error": round(err, 6),
            "reference_error": round(self._ref, 6),
        }
        log.info(
            f"[DRIFT] supervised error {err:.4f} >= reference "
            f"{self._ref:.4f} + {self.margin} over {self._total} joined "
            "flow(s) — triggering a training round"
        )
        self.reset_window()
        return verdict


class SentinelLink:
    """The controller's tail of the sentinel's verdicts-JSONL — the
    cross-process poke that turns a between-gates supervised-drift
    verdict (obs/sentinel.py JournalTail) into a corrective round.

    Same incremental discipline as :class:`DriftMonitor`'s metrics tail:
    byte-offset resume, complete lines only, foreign lines skipped. The
    offset initializes to the file's CURRENT end — a restarted
    controller must not replay last week's verdicts as fresh triggers.
    ``poll()`` returns the newest verdict since the last poll (one
    trigger per poll even if several fired while training ran — the
    corrective round answers all of them) or None."""

    #: The verdict schema the sentinel journals (obs/sentinel.py).
    SCHEMA = "fedtpu-sentinel-verdict-v1"

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        try:
            self._offset = os.path.getsize(path)
        except OSError:
            pass  # not written yet — start from 0 when it appears
        self.seen = 0

    def poll(self) -> dict | None:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return None
        if size < self._offset:
            self._offset = 0  # rotated/truncated underneath us
        if size == self._offset:
            return None
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            chunk = f.read(size - self._offset)
        # Only complete lines; a torn tail waits for the next poll.
        end = chunk.rfind(b"\n")
        if end < 0:
            return None
        self._offset += end + 1
        latest: dict | None = None
        for raw in chunk[: end + 1].splitlines():
            try:
                rec = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict) or rec.get("schema") != self.SCHEMA:
                continue
            if "drift" not in rec or "method" not in rec:
                continue
            self.seen += 1
            latest = rec
        return latest
