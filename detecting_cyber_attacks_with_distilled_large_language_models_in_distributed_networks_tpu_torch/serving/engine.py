"""Pad-to-bucket scoring: variable-size batches through a fixed shape ladder.

Port of the JAX package's ``serving/engine.py`` (without the sharded
``mesh`` path). A batch of n rows is padded up to the smallest bucket of
the ladder (default 1/8/32/128) with pad rows built the way the eval
pipeline builds them (``pad_id`` ids, zero mask) and the pad rows are
sliced off the result. PyTorch runs eagerly, so there is no compile per
shape to amortize; the ladder keeps the shapes the card sees, and so its
kernels' launch shapes, to a fixed small set, and keeps each row's
probability independent of how many siblings share its batch.

The probability math is the eval path's: ``softmax(model(...))``, scalar
score ``[:, 1]`` for K = 2 and ``1 - [:, 0]`` for K > 2 (a static branch
on the head width), with the full per-class softmax alongside.
"""

from __future__ import annotations

import logging
import threading
from typing import Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models.distilbert import DDoSClassifier, build_model

log = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 32, 128)


class ScoreEngine:
    """Pad-to-bucket scoring over one model on one device.

    Thread contract: ``score`` is called by the single scorer thread;
    ``swap`` may be called from any thread. The model reference is
    swapped atomically under a lock, and scoring holds whichever model it
    read at dispatch, so a reload never tears a batch."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        params: Mapping[str, torch.Tensor],
        *,
        pad_id: int = 0,
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        round_id: int = 0,
        device: str | torch.device | None = None,
    ):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets {buckets} must be positive")
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.pad_id = int(pad_id)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.seq_len = int(model_cfg.max_len)
        self._lock = threading.Lock()
        self._model = build_model(model_cfg, params, self.device)
        self._round_id = int(round_id)

    # ------------------------------------------------------------ versioning
    @property
    def round_id(self) -> int:
        return self._round_id

    def swap(self, params: Mapping[str, torch.Tensor], *, round_id: int) -> None:
        """Adopt new params of the same architecture (strict load: a
        changed architecture raises and needs a new engine)."""
        new = build_model(self.model_cfg, params, self.device)
        with self._lock:
            self._model = new
            self._round_id = int(round_id)

    def snapshot(self) -> tuple[DDoSClassifier, int]:
        with self._lock:
            return self._model, self._round_id

    # --------------------------------------------------------------- scoring
    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` (callers cap n at max bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket {self.buckets[-1]}"
        )

    def warmup(self) -> None:
        """Run every bucket once before traffic arrives (builds the CUDA
        kernels and warms the allocator and cuBLAS handles)."""
        for b in self.buckets:
            self.score(
                np.full((b, self.seq_len), self.pad_id, np.int32),
                np.zeros((b, self.seq_len), np.int32),
            )
        log.info(
            f"[SERVE] warmed {len(self.buckets)} buckets "
            f"(batch in {self.buckets}, seq {self.seq_len}) on {self.device}"
        )

    def score(
        self, input_ids: np.ndarray, attention_mask: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, int, int]:
        """Score ``[n, seq]`` rows -> (float32 probs [n], per-class
        softmax [n, K], bucket, round)."""
        n = int(input_ids.shape[0])
        bucket = self.bucket_for(n)
        if input_ids.shape[1] != self.seq_len:
            raise ValueError(
                f"rows have seq {input_ids.shape[1]}, engine expects "
                f"{self.seq_len}"
            )
        if n < bucket:
            pad_ids = np.full((bucket - n, self.seq_len), self.pad_id, np.int32)
            pad_mask = np.zeros((bucket - n, self.seq_len), np.int32)
            input_ids = np.concatenate([input_ids, pad_ids])
            attention_mask = np.concatenate([attention_mask, pad_mask])
        model, round_id = self.snapshot()
        ids = torch.from_numpy(np.ascontiguousarray(input_ids, np.int64))
        mask = torch.from_numpy(np.ascontiguousarray(attention_mask, np.int32))
        with torch.inference_mode():
            logits = model(ids.to(self.device), mask.to(self.device))
            class_probs = torch.softmax(logits, dim=-1)
            if logits.shape[-1] == 2:
                probs = class_probs[:, 1]
            else:
                probs = 1.0 - class_probs[:, 0]
            probs = probs.cpu().numpy()
            class_probs = class_probs.cpu().numpy()
        return probs[:n], class_probs[:n], bucket, round_id
