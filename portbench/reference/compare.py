"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out from the same inputs.

Training:

* ``loss_gap``: ``|loss - ref| / ref``, the worst over the checked
  steps; ``loss1_gap`` the first step's alone;
* ``grad_gap``: the first gradient's norm per leaf, ``|norm - ref|``
  over the larger of the reference's norm of that leaf and of the median
  leaf (some gradients are all but zero), the worst leaf;
  ``grad_median_gap`` the median leaf's;
* ``change_gap``: the same of each leaf's change over the checked steps,
  over the leaves whose first gradient in the reference is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding, the attention keys' bias under softmax, moves under Adam by
  round-off alone), the worst leaf; ``change_median_gap`` the median
  leaf's.

A cell compares the ones its limits name.

Scoring, over every answer of the window:

* ``prob_gap``: the widest gap, over every answer and class, between the
  program's per-class probability and the reference's;
* ``prob_decorrelation``: one less the Pearson correlation of the
  program's P(class 1) with the reference's. With random weights the
  answers of different rows lie close together (their spread is of the
  order of ``prob_gap``'s limit), so this is the number that tells the
  right row's answer from another row's.
"""

from __future__ import annotations

import math

import numpy as np

#: A leaf's change counts when its reference gradient norm reaches this
#: share of the median leaf's.
MOVING_LEAF = 1e-3


def _median(values) -> float:
    return float(np.median(np.asarray(list(values), dtype=np.float64)))


def loss_gap(prog: list[float], ref: list[float]) -> float:
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog, ref)]
    if len(prog) != len(ref) or not gaps or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], names=None) -> list[float]:
    """Each leaf's ``|norm - ref|`` over the larger of its reference norm
    and the median leaf's (inf for a leaf the program lacks or a NaN)."""
    names = list(ref) if names is None else list(names)
    if not names or any(n not in prog for n in names):
        return [math.inf]
    med = _median(ref[n] for n in names)
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], med) for n in names]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def _worst_and_median(gaps: list[float]) -> tuple[float, float]:
    if any(math.isinf(g) for g in gaps):
        return math.inf, math.inf
    return max(gaps), _median(gaps)


def moving_leaves(ref_grad: dict[str, float]) -> list[str]:
    med = _median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= MOVING_LEAF * med]


def train_gaps(prog, ref) -> dict[str, float]:
    """The training numbers of ``prog`` against ``ref`` (each with
    ``losses``, ``grad_norms`` and ``change_norms``)."""
    grad, grad_med = _worst_and_median(leaf_gaps(prog.grad_norms, ref.grad_norms))
    change, change_med = _worst_and_median(
        leaf_gaps(prog.change_norms, ref.change_norms, moving_leaves(ref.grad_norms)))
    return {
        "loss_gap": loss_gap(prog.losses, ref.losses),
        "loss1_gap": loss_gap(prog.losses[:1], ref.losses[:1]),
        "grad_gap": grad,
        "grad_median_gap": grad_med,
        "change_gap": change,
        "change_median_gap": change_med,
    }


def prob_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return math.inf
    gap = float(np.max(np.abs(prog.astype(np.float64) - ref.astype(np.float64)))) if prog.size else math.inf
    return gap if math.isfinite(gap) else math.inf


def decorrelation(prog: np.ndarray, ref: np.ndarray) -> float:
    """``1 - r`` of two equal-length series (inf where r is undefined)."""
    if prog.shape != ref.shape or prog.size < 2:
        return math.inf
    r = float(np.corrcoef(prog.astype(np.float64), ref.astype(np.float64))[0, 1])
    return 1.0 - r if math.isfinite(r) else math.inf
