"""Federated evaluation (the port of the JAX package's
``train/fedeval.py``): eval-split stacking, the stacked metrics loop, and
the control plane's eval-gate hooks.

The reference evaluates each client separately (client1.py:118-150);
here every client evaluates in one sweep over a padded ``[C, M, ...]``
stack, with per-client sufficient statistics accumulated on the device
and one host read per evaluation.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..data.pipeline import TokenizedSplit, pad_split_to_batch
from ..ops.metrics import BinaryCounts, ClassCounts, finalize_class_metrics, finalize_metrics


def stack_eval_splits(
    splits: Sequence[TokenizedSplit],
    batch_size: int,
    pad_id: int = 0,
    *,
    target_rows: int | None = None,
) -> tuple[TokenizedSplit, np.ndarray]:
    """Pad per-client eval splits to one ``[C, M, ...]`` stack (M a batch
    multiple, at least ``target_rows``) plus a ``[C, M]`` validity matrix,
    so every real example counts exactly once per client."""
    target = max(len(s) for s in splits)
    if target_rows is not None:
        target = max(target, target_rows)
    target += (-target) % batch_size
    ids, masks, labels, valid = [], [], [], []
    for s in splits:
        padded, v = pad_split_to_batch(s, batch_size, pad_id=pad_id)
        extra = target - len(padded)
        L = padded.input_ids.shape[1]
        ids.append(np.concatenate([padded.input_ids, np.full((extra, L), pad_id, np.int32)]))
        masks.append(np.concatenate([padded.attention_mask, np.zeros((extra, L), np.int32)]))
        labels.append(np.concatenate([padded.labels, np.zeros(extra, np.int32)]))
        valid.append(np.concatenate([v, np.zeros(extra, np.int32)]))
    return TokenizedSplit(np.stack(ids), np.stack(masks), np.stack(labels)), np.stack(valid)


class PreparedEval(NamedTuple):
    """Stacked eval splits, padded once and reused across rounds."""

    stacked: TokenizedSplit  # [C, M, ...], M a batch multiple
    valid: np.ndarray  # [C, M] 0/1
    batch_size: int


def evaluate_stacked(
    trainer,
    stacked_params: Mapping[str, torch.Tensor],
    prepared: PreparedEval,
    *,
    collect_probs: bool = False,
) -> list[dict]:
    """Per-client metrics dicts (the reference's five-metric schema) from
    one sweep of :func:`.fedsteps.eval_step` over a prepared stack; with
    ``collect_probs`` also each client's scores and labels of its valid
    rows, in split order."""
    from ..obs.profile import default_ledger
    from .fedsteps import eval_step

    # Dispatch ledger: the first eval step of each [C, B, L] shape.
    step = default_ledger().timed(
        "fed.eval_step", eval_step,
        signature=lambda trainer, params, batch, valid: tuple(int(d) for d in batch["input_ids"].shape),
    )
    stacked, valid, bs = prepared.stacked, prepared.valid, prepared.batch_size
    C = trainer.C
    M = stacked.labels.shape[1]
    totals: list[BinaryCounts | ClassCounts | None] = [None] * C
    probs: list[list[torch.Tensor]] = [[] for _ in range(C)]
    ran: list[list[int]] = [[] for _ in range(C)]
    for i in range(M // bs):
        sl = slice(i * bs, (i + 1) * bs)
        batch = {
            "input_ids": stacked.input_ids[:, sl],
            "attention_mask": stacked.attention_mask[:, sl],
            "labels": stacked.labels[:, sl],
        }
        for c, res in enumerate(step(trainer, stacked_params, batch, valid[:, sl])):
            if res is None:
                continue
            counts, p = res
            totals[c] = counts if totals[c] is None else totals[c] + counts
            if collect_probs:
                probs[c].append(p)
                ran[c].append(i)
    out = []
    host_probs = None
    if collect_probs:
        host_probs = [torch.cat(p).cpu().numpy() if p else np.zeros(0, np.float32) for p in probs]
    for c in range(C):
        counts = totals[c] if totals[c] is not None else BinaryCounts.zero(trainer.device)
        m = finalize_class_metrics(counts) if isinstance(counts, ClassCounts) else finalize_metrics(counts)
        if collect_probs:
            # Padding appends rows, so the valid rows of the batches that ran
            # are the split in its order.
            rows = np.concatenate([np.arange(i * bs, (i + 1) * bs) for i in ran[c]]).astype(np.int64) if ran[c] else np.zeros(0, np.int64)
            keep = valid[c, rows] == 1
            m["probs"] = host_probs[c][keep]
            m["labels"] = stacked.labels[c, rows][keep]
        out.append(m)
    return out


# ----------------------------------------------------- control-plane hooks
def reference_histogram(probs: Any, *, bins: int = 10) -> np.ndarray:
    """Score-distribution fingerprint of a held-out evaluation: integer
    counts of P(attack) over ``bins`` equal buckets spanning [0, 1] (the
    serving tier exports the same binning)."""
    p = np.clip(np.asarray(probs, np.float64).ravel(), 0.0, 1.0)
    counts, _ = np.histogram(p, bins=int(bins), range=(0.0, 1.0))
    return counts.astype(np.int64)


def eval_gate(
    candidate: Mapping[str, Any],
    incumbent: Mapping[str, Any] | None,
    *,
    metric: str = "Accuracy",
    min_delta: float = 0.0,
) -> tuple[bool, str]:
    """The promotion gate: may ``candidate`` replace ``incumbent``?

    Returns ``(ok, reason)``. A candidate whose gate metric is missing or
    non-finite never passes (can't evaluate fails closed). With no
    incumbent any finite candidate passes; otherwise the candidate must
    score at least ``incumbent[metric] - min_delta`` (higher is better)."""
    try:
        cand = float(candidate[metric])
    except (KeyError, TypeError, ValueError):
        return False, f"candidate has no finite {metric!r}"
    if not np.isfinite(cand):
        return False, f"candidate {metric}={cand} is not finite"
    if incumbent is None:
        return True, f"bootstrap: no incumbent ({metric} {cand:.4f})"
    try:
        inc = float(incumbent[metric])
    except (KeyError, TypeError, ValueError):
        return True, f"incumbent has no {metric!r}; promoting {cand:.4f}"
    if not np.isfinite(inc):
        return True, f"incumbent {metric} not finite; promoting {cand:.4f}"
    if cand >= inc - float(min_delta):
        return True, f"{metric} {cand:.4f} >= incumbent {inc:.4f} - {min_delta}"
    return (
        False,
        f"{metric} {cand:.4f} < incumbent {inc:.4f} - {min_delta} (regression)",
    )
