"""Pad-to-bucket scoring: variable-size batches through a fixed shape ladder.

Port of the JAX package's ``serving/engine.py``. A batch of n rows is padded up to the smallest bucket of
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

Sharded serving (``mesh=``, ``infer-serve --data-parallel N --fsdp``):
the engine holds its params split per leaf AT REST over the mesh's
``data`` slots (:class:`..parallel.mesh.ShardedLeaf`; per-slot static
bytes ~1/N) and gathers them AT USE onto its first slot for each
dispatch, through its ledger under the JAX engine's ``serving.gather``
site (one signature, noted once). The gather is byte-exact and the
bucket forward after it is the replicated engine's on the same shapes,
so probabilities are bit-identical to the replicated engine's; the
gathered weights are dropped with the dispatch. A swap re-places the new
params onto the same shape-determined layout.
"""

from __future__ import annotations

import logging
import threading
from typing import Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from torch.func import functional_call

from ..models.distilbert import DDoSClassifier, build_model, model_skeleton
from ..obs.profile import CompileLedger, maybe_step_profiler, profile_stride
from ..parallel.mesh import Mesh, ShardedLeaf, axis_slots, gather_tree, shard_tree

log = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 32, 128)


class ShardedParams(dict):
    """The sharded engine's weights at rest: state-dict key ->
    :class:`..parallel.mesh.ShardedLeaf` (what ``snapshot`` returns in
    place of a module)."""

    def state_dict(self) -> dict[str, ShardedLeaf]:
        return dict(self)


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
        mesh: Mesh | None = None,
    ):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets {buckets} must be positive")
        self.model_cfg = model_cfg
        self.mesh = mesh
        self.n_shards = int(mesh.shape["data"]) if mesh is not None else 1
        if mesh is None:
            self.device = resolve_device(device)
        else:
            # Sharded: the slots hold the shards; the first slot runs the buckets.
            self._slots = [resolve_device(s) for s in axis_slots(mesh, "data")]
            self.device = self._slots[0]
            if device is not None and resolve_device(device).type != self.device.type:
                raise ValueError(f"device={device} differs from the mesh's first slot {self.device}")
            self._skeleton = model_skeleton(model_cfg)
        self.pad_id = int(pad_id)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.seq_len = int(model_cfg.max_len)
        self._lock = threading.Lock()
        self._model = self._place(params)
        self._round_id = int(round_id)
        # Private dispatch ledger: per-engine counts (two engines in one
        # process must not mix them) over the shared fedtpu_xla_* families.
        self.ledger = CompileLedger()
        self._probs = self.ledger.timed(
            "serving.probs", self._forward, signature=lambda model, ids, mask: tuple(ids.shape)
        )
        # The sharded engine's gather at use, its own ledger site.
        self._gather = self.ledger.timed(
            "serving.gather", lambda params: gather_tree(params, self.device), signature=lambda params: ("gather",)
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
        new = self._place(params)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        with self._lock:
            self._model = new
            self._round_id = int(round_id)

    def _place(self, params: Mapping[str, torch.Tensor]) -> DDoSClassifier | ShardedParams:
        """The module on the device, or (sharded) the params split onto
        the mesh's slots as fp32, under the model's key set."""
        if self.mesh is None:
            return build_model(self.model_cfg, params, self.device)
        want = set(self._skeleton.state_dict())
        if set(params) != want:
            raise KeyError(
                f"state dict keys differ from the model's: missing {sorted(want - set(params))[:4]}, "
                f"unexpected {sorted(set(params) - want)[:4]}"
            )
        return ShardedParams(shard_tree(params, self.mesh, dtype=torch.float32))

    def snapshot(self) -> tuple[DDoSClassifier | ShardedParams, int]:
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

    def _forward(
        self, model: DDoSClassifier | ShardedParams, ids: torch.Tensor, mask: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(score [b], per-class softmax [b, K]) on the device, queued."""
        with torch.inference_mode():
            if isinstance(model, ShardedParams):
                full = self._gather(model)  # gathered at use, dropped with the dispatch
                logits = functional_call(self._skeleton, full, (ids.to(self.device), mask.to(self.device)))
            else:
                logits = model(ids.to(self.device), mask.to(self.device))
            class_probs = torch.softmax(logits, dim=-1)
            if logits.shape[-1] == 2:
                probs = class_probs[:, 1]
            else:
                probs = 1.0 - class_probs[:, 0]
        return probs, class_probs
