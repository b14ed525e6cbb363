"""On-device classification metrics (the port of ``ops/metrics.py``).

The eval step accumulates sufficient statistics (loss sum, correct count,
TP/FP/FN/TN, or a dense [K, K] confusion matrix) as 0-dim fp32 tensors on
the device, one tuple per batch; the host finalizes the reference's five
metrics (Accuracy, Loss, Precision, Recall, F1) and the confusion matrix
once per evaluation. K = 2 routes through the binary counts verbatim.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BinaryCounts(NamedTuple):
    """Sufficient statistics for binary classification metrics."""

    loss_sum: torch.Tensor  # fp32 scalar — sum of per-batch mean losses
    n_batches: torch.Tensor  # fp32 scalar
    n_examples: torch.Tensor  # fp32 scalar
    correct: torch.Tensor  # fp32 scalar
    tp: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor
    tn: torch.Tensor

    @classmethod
    def zero(cls, device: torch.device | str = "cpu") -> "BinaryCounts":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(z, z, z, z, z, z, z, z)

    def __add__(self, other: "BinaryCounts") -> "BinaryCounts":  # type: ignore[override]
        return BinaryCounts(*(a + b for a, b in zip(self, other)))


def binary_counts(
    logits: torch.Tensor,  # [B, 2]
    labels: torch.Tensor,  # [B]
    loss: torch.Tensor,  # scalar — batch mean loss
    valid: torch.Tensor | None = None,  # [B] 0/1 — padded-row mask
) -> BinaryCounts:
    preds = torch.argmax(logits, dim=-1)
    if valid is None:
        valid = torch.ones_like(labels)
    v = valid.to(torch.float32)
    pos = (labels == 1).to(torch.float32) * v
    neg = (labels == 0).to(torch.float32) * v
    pred_pos = (preds == 1).to(torch.float32)
    pred_neg = (preds == 0).to(torch.float32)
    has_valid = (v.sum() > 0).to(torch.float32)
    return BinaryCounts(
        # All-padding batches must not dilute the batch-mean loss.
        loss_sum=loss.to(torch.float32) * has_valid,
        n_batches=has_valid,
        n_examples=v.sum(),
        correct=((preds == labels).to(torch.float32) * v).sum(),
        tp=(pos * pred_pos).sum(),
        fp=(neg * pred_pos).sum(),
        fn=(pos * pred_neg).sum(),
        tn=(neg * pred_neg).sum(),
    )


def finalize_metrics(counts: BinaryCounts) -> dict:
    """Host-side finalization into the reference's five-metric schema
    (Accuracy in percent) + confusion matrix. Precision/recall/F1 are 0.0
    where undefined (sklearn's ``average='binary'`` zero-division rule)."""
    c = {k: float(v) for k, v in counts._asdict().items()}
    n = max(c["n_examples"], 1.0)
    precision = c["tp"] / (c["tp"] + c["fp"]) if (c["tp"] + c["fp"]) > 0 else 0.0
    recall = c["tp"] / (c["tp"] + c["fn"]) if (c["tp"] + c["fn"]) > 0 else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if (precision + recall) > 0
        else 0.0
    )
    return {
        "Accuracy": 100.0 * c["correct"] / n,
        "Loss": c["loss_sum"] / max(c["n_batches"], 1.0),
        "Precision": precision,
        "Recall": recall,
        "F1-Score": f1,
        "confusion_matrix": np.array(
            [[c["tn"], c["fp"]], [c["fn"], c["tp"]]], dtype=np.int64
        ),
        "n": int(c["n_examples"]),
    }


class ClassCounts(NamedTuple):
    """Sufficient statistics for K-class metrics: ``cm`` is the dense
    [K, K] confusion matrix, rows truth, columns prediction."""

    loss_sum: torch.Tensor
    n_batches: torch.Tensor
    n_examples: torch.Tensor
    correct: torch.Tensor
    cm: torch.Tensor  # [K, K] fp32

    @classmethod
    def zero(cls, n_classes: int, device: torch.device | str = "cpu") -> "ClassCounts":
        z = torch.zeros((), dtype=torch.float32, device=device)
        cm = torch.zeros((n_classes, n_classes), dtype=torch.float32, device=device)
        return cls(z, z, z, z, cm)

    def __add__(self, other: "ClassCounts") -> "ClassCounts":  # type: ignore[override]
        return ClassCounts(*(a + b for a, b in zip(self, other)))


def class_counts(
    logits: torch.Tensor,  # [B, K]
    labels: torch.Tensor,  # [B]
    loss: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> ClassCounts:
    """K-class sufficient statistics. K = 2 routes through
    :func:`binary_counts` and reassembles its four scalars into the
    [2, 2] matrix."""
    k = int(logits.shape[-1])
    if k == 2:
        b = binary_counts(logits, labels, loss, valid)
        return ClassCounts(
            loss_sum=b.loss_sum,
            n_batches=b.n_batches,
            n_examples=b.n_examples,
            correct=b.correct,
            cm=torch.stack([torch.stack([b.tn, b.fp]), torch.stack([b.fn, b.tp])]),
        )
    preds = torch.argmax(logits, dim=-1)
    if valid is None:
        valid = torch.ones_like(labels)
    v = valid.to(torch.float32)
    classes = torch.arange(k, device=logits.device)
    # One-hot contraction: cm[t, p] = sum_b valid_b [label_b==t][pred_b==p].
    oh_true = (labels[:, None] == classes[None, :]).to(torch.float32)
    oh_pred = (preds[:, None] == classes[None, :]).to(torch.float32)
    cm = (oh_true * v[:, None]).T @ oh_pred
    has_valid = (v.sum() > 0).to(torch.float32)
    return ClassCounts(
        loss_sum=loss.to(torch.float32) * has_valid,
        n_batches=has_valid,
        n_examples=v.sum(),
        correct=((preds == labels).to(torch.float32) * v).sum(),
        cm=cm,
    )


def finalize_class_metrics(counts: ClassCounts) -> dict:
    """Host-side K-class finalization. K = 2 delegates to
    :func:`finalize_metrics`; K > 2 renders the same schema with
    macro-averaged Precision/Recall/F1 (0.0 where undefined) plus
    ``per_class`` rows."""
    cm = counts.cm.detach().to("cpu", torch.float64).numpy()
    k = cm.shape[0]
    if k == 2:
        return finalize_metrics(
            BinaryCounts(
                loss_sum=counts.loss_sum,
                n_batches=counts.n_batches,
                n_examples=counts.n_examples,
                correct=counts.correct,
                tp=counts.cm[1, 1],
                fp=counts.cm[0, 1],
                fn=counts.cm[1, 0],
                tn=counts.cm[0, 0],
            )
        )
    n = max(float(counts.n_examples), 1.0)
    diag = np.diag(cm)
    pred_tot = cm.sum(axis=0)
    true_tot = cm.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        prec = np.where(pred_tot > 0, diag / np.maximum(pred_tot, 1.0), 0.0)
        rec = np.where(true_tot > 0, diag / np.maximum(true_tot, 1.0), 0.0)
        denom = prec + rec
        f1 = np.where(denom > 0, 2 * prec * rec / np.maximum(denom, 1e-38), 0.0)
    return {
        "Accuracy": 100.0 * float(counts.correct) / n,
        "Loss": float(counts.loss_sum) / max(float(counts.n_batches), 1.0),
        "Precision": float(prec.mean()),
        "Recall": float(rec.mean()),
        "F1-Score": float(f1.mean()),
        "confusion_matrix": cm.astype(np.int64),
        "per_class": {
            str(c): {
                "precision": float(prec[c]),
                "recall": float(rec[c]),
                "f1": float(f1[c]),
                "support": int(true_tot[c]),
            }
            for c in range(k)
        },
        "n": int(float(counts.n_examples)),
        "n_classes": k,
    }
