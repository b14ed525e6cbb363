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

Each engine keeps a private dispatch ledger (:mod:`..obs.profile`) at the
JAX engine's site ``serving.probs``: one signature per bucket shape, noted
at its first dispatch; :meth:`ScoreEngine.warmup` marks the site warm, so
a shape outside the ladder afterwards is a flagged recompile event (the
ladder makes one impossible while the padding holds, across reloads
too: a swap changes weights, never shapes). With ``--profile-stride``
every Nth dispatch is split into host pad-prep / dispatch / device.
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
from ..obs.profile import CompileLedger, maybe_step_profiler, profile_stride

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
        # Private dispatch ledger: per-engine counts (two engines in one
        # process must not mix them) over the shared fedtpu_xla_* families.
        self.ledger = CompileLedger()
        self._probs = self.ledger.timed(
            "serving.probs", self._forward, signature=lambda model, ids, mask: tuple(ids.shape)
        )
        # Score-path step attribution: armed only when profiling is on
        # process-wide (--profile-stride).
        self.step_profiler = maybe_step_profiler("score")

    @property
    def compile_counts(self) -> dict[tuple[int, int], int]:
        """(batch, seq) -> first-dispatch count, straight off the ledger
        (the JAX engine's ``compile_counts`` shape)."""
        return self.ledger.compile_counts("serving.probs")

    # ------------------------------------------------------------ versioning
    @property
    def round_id(self) -> int:
        return self._round_id

    def swap(self, params: Mapping[str, torch.Tensor], *, round_id: int) -> None:
        """Adopt new params of the same architecture (strict load: a
        changed architecture raises and needs a new engine). The new
        weights are on the device before the swap publishes them: no batch
        can read a half-copied model."""
        new = build_model(self.model_cfg, params, self.device)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
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
        kernels and warms the allocator and cuBLAS handles), then mark the
        site warm: any later novel shape is a flagged recompile."""
        for b in self.buckets:
            self.score(
                np.full((b, self.seq_len), self.pad_id, np.int32),
                np.zeros((b, self.seq_len), np.int32),
            )
        self.ledger.mark_warm()
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
        # Strided step attribution: a sampled dispatch splits host
        # pad-prep / dispatch / device-execute; unsampled dispatches (and
        # profiling off) run the bare path. Re-checked lazily (one
        # lock-free int read when off): the CLI may install the stride
        # after the engine is built.
        prof = self.step_profiler
        if prof is None and profile_stride() > 0:
            prof = self.step_profiler = maybe_step_profiler("score")
        sampled = prof.tick() if prof is not None else False
        t0 = prof.clock() if sampled else 0.0
        if n < bucket:
            pad_ids = np.full((bucket - n, self.seq_len), self.pad_id, np.int32)
            pad_mask = np.zeros((bucket - n, self.seq_len), np.int32)
            input_ids = np.concatenate([input_ids, pad_ids])
            attention_mask = np.concatenate([attention_mask, pad_mask])
        model, round_id = self.snapshot()
        ids = torch.from_numpy(np.ascontiguousarray(input_ids, np.int64))
        mask = torch.from_numpy(np.ascontiguousarray(attention_mask, np.int32))
        if sampled:
            prof.note_host(prof.clock() - t0)
            t1 = prof.clock()
            probs, class_probs = self._probs(model, ids, mask)
            prof.note_dispatch(prof.clock() - t1)
            prof.fence(probs)
        else:
            probs, class_probs = self._probs(model, ids, mask)
        return probs.cpu().numpy()[:n], class_probs.cpu().numpy()[:n], bucket, round_id

    def _forward(self, model: DDoSClassifier, ids: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(score [b], per-class softmax [b, K]) on the device, queued."""
        with torch.inference_mode():
            logits = model(ids.to(self.device), mask.to(self.device))
            class_probs = torch.softmax(logits, dim=-1)
            if logits.shape[-1] == 2:
                probs = class_probs[:, 1]
            else:
                probs = 1.0 - class_probs[:, 0]
        return probs, class_probs
