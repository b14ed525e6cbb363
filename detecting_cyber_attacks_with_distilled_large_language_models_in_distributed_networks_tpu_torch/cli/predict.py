"""``predict``: batch inference on new flows from a training checkpoint
(the port of the JAX package's ``cli/predict.py``): a ``local`` or
``client`` state, or a ``federated`` one, whose global model (client 0's
row of the aggregate) scores.

Reads a flow CSV of the ``--dataset`` schema (the label column is
optional), renders it through that dataset's template and writes one row
per flow: P(attack), the thresholded 0/1 prediction and its label name;
logs the thresholded metrics against the dataset's binary labels when
the CSV has them. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import csv
import logging
import time

import numpy as np

from ..data.tokenizer import default_tokenizer
from ..device import resolve_device
from .common import resolve_config

log = logging.getLogger(__name__)


def run_predict(args) -> dict:
    """The ``predict`` command's work; returns ``probs`` (P(attack) per
    flow, float32), ``predictions``, ``labels`` (None without a label
    column), ``model_config``, ``trainer``, ``seconds`` (the scoring
    alone, tokenized rows in, probs on the host out) and ``output``."""
    from ..data.cicids import frame_labels, frame_texts, load_flow_csv
    from ..data.datasets import get_dataset
    from ..data.pipeline import TokenizedSplit
    from ..train.checkpoint import CheckpointError, restore_for_inference
    from ..train.engine import Trainer

    if not args.csv:
        raise SystemExit("predict needs --csv (the flows to classify)")
    for flag in ("source", "synthetic"):
        if getattr(args, flag, None):
            raise SystemExit(
                f"--{flag} is a training-data option; predict reads the "
                "flows to classify from --csv only"
            )
    device = resolve_device(args.device)  # raises before any work without CUDA
    tok = default_tokenizer()
    cfg = resolve_config(args, vocab_size=len(tok.vocab))
    if not cfg.checkpoint_dir:
        raise SystemExit(
            "predict needs trained weights: pass --checkpoint-dir (a "
            "training checkpoint of `local`, `client` or `federated`)"
        )
    try:
        model_cfg, params, step, meta = restore_for_inference(cfg.checkpoint_dir, cfg.model, device=device)
    except CheckpointError as e:
        raise SystemExit(str(e)) from None
    log.info(f"[PREDICT] restored {meta.get('kind', 'local')} checkpoint (step {step})")
    trainer = Trainer(model_cfg, cfg.train, pad_id=tok.pad_id, device=device)

    spec = get_dataset(cfg.data.dataset)
    frame = load_flow_csv(args.csv)
    texts = frame_texts(frame, spec)
    if not texts:
        raise SystemExit(f"--csv {args.csv} has no data rows")
    label_col = cfg.data.label_column if spec.label_kind == "positive" else spec.label_column
    labels = frame_labels(frame, cfg.data) if label_col in frame else None
    enc = tok.batch_encode(texts, max_len=model_cfg.max_len)
    split = TokenizedSplit(
        enc["input_ids"],
        enc["attention_mask"],
        labels if labels is not None else np.zeros(len(texts), np.int32),
    )
    t0 = time.perf_counter()
    # Trainer.evaluate is the one eval pipeline (pad, slice, accumulate);
    # its metrics are ignored here (the labels may be dummies).
    probs = trainer.evaluate(params, split, batch_size=cfg.data.eval_batch_size)["probs"]
    seconds = time.perf_counter() - t0
    preds = (probs >= args.threshold).astype(np.int32)
    positive = cfg.data.positive_label if spec.label_kind == "positive" else "attack"
    with open(args.output, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["prob_attack", "prediction", "label_name"])
        for p, y in zip(probs, preds):
            w.writerow([str(p), int(y), positive if y == 1 else "BENIGN"])
    log.info(
        f"[PREDICT] wrote {len(preds)} predictions to {args.output} "
        f"({int(preds.sum())} flagged {positive}; {len(preds) / seconds:.1f} flows/s on {device})"
    )
    if labels is not None:
        # Metrics at the threshold the predictions used (sklearn
        # average='binary', as the reference's evaluate_model).
        tp = int(((preds == 1) & (labels == 1)).sum())
        fp = int(((preds == 1) & (labels == 0)).sum())
        fn = int(((preds == 0) & (labels == 1)).sum())
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        log.info(
            f"[PREDICT] against the CSV's labels (threshold {args.threshold}): "
            f"acc {(preds == labels).mean() * 100:.4f} prec {prec:.4f} "
            f"rec {rec:.4f} f1 {f1:.4f}"
        )
    return {
        "probs": probs, "predictions": preds, "labels": labels,
        "model_config": model_cfg, "trainer": trainer, "seconds": seconds,
        "output": args.output,
    }


def cmd_predict(args) -> int:
    run_predict(args)
    return 0
