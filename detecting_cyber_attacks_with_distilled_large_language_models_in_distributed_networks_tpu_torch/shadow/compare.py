"""Online A/B comparison of serving vs shadow scores, pair by pair (the
port's copy of the JAX package's ``shadow/compare.py``: the same pairs
file, status file and verdicts, so either package's gate rules on the
other's evidence).

The mirror (shadow/mirror.py) produces two probabilities for one live
flow — the incumbent's and the candidate's, computed on the SAME bytes
at the same moment. This module pairs them by the router's mirror id and
turns the stream of pairs into the disagreement evidence the promotion
gate (shadow/gate.py) rules on:

* **flip rate** — the fraction of pairs whose thresholded prediction
  differs (the operator-facing "how often would the candidate have
  answered differently?");
* **mean |Δprob|** — the magnitude of score movement even when the
  decision held;
* **paired score histograms + PSI** — both sides binned on the SAME
  [0, 1] edges the drift monitor uses, with the candidate-vs-incumbent
  PSI (control/drift.py — one distance implementation repo-wide)
  catching distribution shifts that flips alone miss (a candidate that
  scores everything 0.1 hotter flips nothing near the extremes but has
  plainly drifted).

Every completed pair is one ATOMIC line on the paired-records JSONL
(obs/trace.py append discipline — concurrent writers can never
interleave partial lines), counted on ``fedtpu_shadow_pairs_total`` /
``fedtpu_shadow_flips_total``, and periodically folded into an atomic
``status.json`` (tmp + os.replace) — the cross-process surface the
controller's gate polls, so the comparator and the gate can live in
different processes exactly like the rest of the control plane
coordinates through the registry directory.

Pairing state is bounded: at ``max_pending`` half-open pairs the oldest
is dropped (counted) — a one-sided flood (shadow dead mid-burst, ejected
serving replicas) can never grow the dict without bound.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any

import numpy as np

from ..control.drift import psi
from ..obs import metrics as obs_metrics
from ..obs.trace import append_jsonl_line

log = logging.getLogger(__name__)

#: Schema tag on every paired record, so stream consumers can reject
#: foreign JSONL lines when files get concatenated.
PAIR_SCHEMA = "fedtpu-shadow-v1"


def evaluate_status(
    status: dict,
    *,
    min_pairs: int,
    max_flip_rate: float,
    psi_threshold: float,
) -> tuple[bool, str]:
    """The gate's verdict arithmetic over one comparator snapshot — a
    pure function so the controller-side gate and in-process callers
    share ONE implementation. Fails closed: too few pairs is a refusal,
    and so is an uncomputable PSI."""
    pairs = int(status.get("pairs", 0) or 0)
    if pairs < int(min_pairs):
        return False, (
            f"insufficient evidence: {pairs} mirrored pair(s) < "
            f"min_pairs={min_pairs}"
        )
    flip_rate = float(status.get("flip_rate", 1.0))
    if flip_rate > float(max_flip_rate):
        return False, (
            f"live disagreement: flip_rate={flip_rate:.4f} > "
            f"{max_flip_rate} over {pairs} pair(s)"
        )
    d = status.get("psi")
    if d is None:
        return False, (
            f"live disagreement: paired-score PSI uncomputable over "
            f"{pairs} pair(s)"
        )
    if float(d) > float(psi_threshold):
        return False, (
            f"live disagreement: paired-score psi={float(d):.4f} > "
            f"{psi_threshold} over {pairs} pair(s)"
        )
    return True, (
        f"live agreement: flip_rate={flip_rate:.4f} <= {max_flip_rate}, "
        f"psi={float(d):.4f} <= {psi_threshold} over {pairs} pair(s)"
    )


class ShadowCompare:
    """Pair (serving_prob, shadow_prob) by mirror id; accumulate the
    disagreement statistics and publish them.

    Either side of a pair may arrive first (the shadow reply races the
    serving reply by construction); ``abandon`` sheds a pair whose other
    half can never arrive (reject, eject, dead shadow)."""

    def __init__(
        self,
        *,
        threshold: float = 0.5,
        bins: int = 10,
        pairs_jsonl: str | None = None,
        status_path: str | None = None,
        status_every: int = 8,
        max_pending: int = 8192,
        tracer=None,
        span_stride: int = 64,
        candidates: tuple[str, ...] = (),
    ):
        if not 0.0 < float(threshold) < 1.0:
            raise ValueError(f"threshold={threshold} must be in (0, 1)")
        if int(bins) < 2:
            raise ValueError(f"bins={bins} must be >= 2")
        self.threshold = float(threshold)
        self.pairs_jsonl = pairs_jsonl
        self.status_path = status_path
        self.status_every = max(1, int(status_every))
        self.max_pending = max(1, int(max_pending))
        self.tracer = tracer
        self._span_stride = max(1, int(span_stride))
        # Ranked candidate list: rank 0 is the GATED candidate
        # — the aggregate stats (what status.json and the gate rule on)
        # cover rank 0 only, so striding mirrored traffic across extra
        # candidates never dilutes the promotion verdict. Empty = the
        # single-candidate shape, where every pair is rank 0.
        self.candidates = tuple(str(c) for c in candidates)
        self._lock = threading.Lock()
        # Serializes write_status: two reply threads completing pairs
        # concurrently would share the per-pid tmp name, and the loser's
        # os.replace would find its tmp already consumed.
        self._status_lock = threading.Lock()
        # mid -> (side, prob, cand); insertion-ordered so overflow drops
        # oldest.
        self._open: dict[int, tuple[str, float, int]] = {}
        # mid -> request id (the serving tier's stamp), registered at
        # admission so completed pairs carry the join key the ground-
        # truth plane (labels/join.py) matches on. Bounded like _open.
        self._rids: dict[int, str] = {}
        # rank -> [pairs, flips] — per-candidate accounting.
        self._cand: dict[int, list[int]] = {}
        self._bins = int(bins)
        self._hist_serving = np.zeros(int(bins), np.int64)
        self._hist_shadow = np.zeros(int(bins), np.int64)
        self._pairs = 0
        self._flips = 0
        self._abs_dprob_sum = 0.0
        self._abandoned = 0
        self._pending_dropped = 0
        m = obs_metrics.default_registry()
        # fedtpu: allow(obs-metric-once): the JAX package's shadow/compare.py family, same name/kind/labels/help
        self._m_pairs = m.counter(
            "fedtpu_shadow_pairs_total",
            help="completed serving/shadow probability pairs",
        )
        # fedtpu: allow(obs-metric-once): the JAX package's shadow/compare.py family, same name/kind/labels/help
        self._m_flips = m.counter(
            "fedtpu_shadow_flips_total",
            help="pairs whose thresholded prediction disagreed",
        )

    # -------------------------------------------------------------- ingestion
    def register_rid(self, mid: int, rid: str) -> None:
        """Attach the live request's id (the serving tier's stamp) to a
        mirror id at admission, so the completed pair record carries the
        ground-truth join key. Bounded like the half-open dict."""
        with self._lock:
            if len(self._rids) >= 2 * self.max_pending:
                oldest = next(iter(self._rids))
                del self._rids[oldest]
            self._rids[int(mid)] = str(rid)

    def note_serving(self, mid: int, prob: float) -> None:
        self._note(mid, "serving", prob, 0)

    def note_shadow(self, mid: int, prob: float, cand: int = 0) -> None:
        """The shadow side of a pair; ``cand`` is the candidate's RANK
        when the mirror strides across a ranked list (0 = the gated
        candidate — the only rank the aggregate verdict counts)."""
        self._note(mid, "shadow", prob, int(cand))

    def abandon(self, mid: int) -> None:
        with self._lock:
            self._rids.pop(mid, None)
            if self._open.pop(mid, None) is not None:
                self._abandoned += 1

    def _note(self, mid: int, side: str, prob: float, cand: int) -> None:
        p = float(prob)
        rec = None
        with self._lock:
            other = self._open.get(mid)
            if other is None:
                if len(self._open) >= self.max_pending:
                    # Bounded half-open state: drop the OLDEST waiter —
                    # a one-sided flood must not grow memory unbounded.
                    oldest = next(iter(self._open))
                    del self._open[oldest]
                    self._rids.pop(oldest, None)
                    self._pending_dropped += 1
                self._open[mid] = (side, p, cand)
                return
            if other[0] == side:
                # Duplicate arrival on one side (a retried mirror send):
                # keep the first value, stay half-open.
                return
            del self._open[mid]
            rid = self._rids.pop(mid, None)
            serving = p if side == "serving" else other[1]
            shadow = p if side == "shadow" else other[1]
            # The pair's candidate rank rides the SHADOW side (the
            # serving side has no candidate identity).
            rank = cand if side == "shadow" else other[2]
            flip = (serving >= self.threshold) != (shadow >= self.threshold)
            cstat = self._cand.setdefault(rank, [0, 0])
            cstat[0] += 1
            if flip:
                cstat[1] += 1
            primary = rank == 0
            if primary:
                self._pairs += 1
                if flip:
                    self._flips += 1
                self._abs_dprob_sum += abs(serving - shadow)
                # Fixed [0, 1] bins: one multiply + clamp per scalar — the
                # np.histogram machinery is array-sized overkill on a path
                # that runs once per pair (p == 1.0 lands in the top bin,
                # matching the closed right edge everywhere else).
                self._hist_serving[
                    min(int(min(max(serving, 0.0), 1.0) * self._bins),
                        self._bins - 1)
                ] += 1
                self._hist_shadow[
                    min(int(min(max(shadow, 0.0), 1.0) * self._bins),
                        self._bins - 1)
                ] += 1
            pairs_now = self._pairs
            rec = {
                "schema": PAIR_SCHEMA,
                "mid": int(mid),
                "serving_prob": serving,
                "shadow_prob": shadow,
                "flip": int(flip),
            }
            if rid is not None:
                rec["rid"] = rid
            if rank:
                rec["cand"] = int(rank)
        self._m_pairs.inc()
        if rec["flip"]:
            self._m_flips.inc()
        if self.pairs_jsonl:
            try:
                append_jsonl_line(self.pairs_jsonl, json.dumps(rec))
            except OSError as e:
                log.warning(
                    f"[SHADOW] paired-record append failed (non-fatal): {e}"
                )
        if self.status_path and primary and (
            pairs_now % self.status_every == 0
        ):
            self.write_status()
        if self.tracer is not None and primary and (
            (pairs_now - 1) % self._span_stride == 0
        ):
            s = self.snapshot()
            self.tracer.record(
                "shadow-compare",
                t_start=time.time(),
                dur_s=0.0,
                pairs=s["pairs"],
                flip_rate=s["flip_rate"],
                psi=s["psi"],
                sampled_pairs=(
                    self._span_stride if self._span_stride > 1 else None
                ),
            )

    # --------------------------------------------------------------- verdict
    def snapshot(self) -> dict[str, Any]:
        """The current disagreement evidence (what status.json carries)."""
        with self._lock:
            pairs = self._pairs
            flips = self._flips
            dsum = self._abs_dprob_sum
            hs = self._hist_serving.copy()
            hd = self._hist_shadow.copy()
            abandoned = self._abandoned
            pending = len(self._open)
            pending_dropped = self._pending_dropped
            per_candidate = {
                str(rank): {
                    "candidate": (
                        self.candidates[rank]
                        if rank < len(self.candidates)
                        else None
                    ),
                    "pairs": c[0],
                    "flips": c[1],
                    "flip_rate": (c[1] / c[0]) if c[0] else 0.0,
                }
                for rank, c in sorted(self._cand.items())
            }
        d = None
        if pairs > 0 and hs.sum() > 0 and hd.sum() > 0:
            try:
                # Serving = expected, shadow = observed: "how far has the
                # candidate's score distribution moved off the incumbent's
                # on identical live flows" — the same PSI the drift
                # monitor speaks, so thresholds transfer.
                d = round(psi(hs, hd), 6)
            except ValueError:
                d = None
        return {
            "schema": PAIR_SCHEMA,
            "pairs": pairs,
            "flips": flips,
            "flip_rate": (flips / pairs) if pairs else 0.0,
            "mean_abs_dprob": (dsum / pairs) if pairs else 0.0,
            "psi": d,
            "threshold": self.threshold,
            "hist_serving": hs.tolist(),
            "hist_shadow": hd.tolist(),
            "abandoned": abandoned,
            "pending": pending,
            "pending_dropped": pending_dropped,
            "candidates": list(self.candidates),
            "per_candidate": per_candidate,
            "ts": time.time(),
        }

    def verdict(
        self,
        *,
        min_pairs: int,
        max_flip_rate: float,
        psi_threshold: float,
    ) -> tuple[bool, dict]:
        """(ok, verdict dict) over the CURRENT snapshot — the in-process
        shape of the gate's decision (the cross-process gate evaluates
        the same arithmetic over status.json)."""
        status = self.snapshot()
        ok, reason = evaluate_status(
            status,
            min_pairs=min_pairs,
            max_flip_rate=max_flip_rate,
            psi_threshold=psi_threshold,
        )
        return ok, {
            "ok": ok,
            "reason": reason,
            "pairs": status["pairs"],
            "flip_rate": round(status["flip_rate"], 6),
            "mean_abs_dprob": round(status["mean_abs_dprob"], 6),
            "psi": status["psi"],
            "min_pairs": int(min_pairs),
            "max_flip_rate": float(max_flip_rate),
            "psi_threshold": float(psi_threshold),
        }

    def write_status(self) -> None:
        """Atomically publish the snapshot (tmp + os.replace): a gate
        polling from another process sees the old status or the new one,
        never a torn write."""
        if not self.status_path:
            return
        snap = self.snapshot()
        tmp = f"{self.status_path}.tmp.{os.getpid()}"
        with self._status_lock:
            try:
                os.makedirs(
                    os.path.dirname(self.status_path) or ".", exist_ok=True
                )
                with open(tmp, "w") as f:
                    json.dump(snap, f)
                os.replace(tmp, self.status_path)
            except OSError as e:
                log.warning(
                    f"[SHADOW] status write failed (non-fatal): {e}"
                )
