"""One round's incremental weighted-mean state (the port of ``comm/stream_agg.py``).

Uploads register an *intent* (key set + sample count, from a stream
header or a dense frame) and hand over their leaves: all at once
(:meth:`StreamAgg.add_dense`) or one by one as a stream's bytes arrive
(:meth:`StreamAgg.add_leaf`). Once every expected client's intent is in,
the server freezes the fold set, and each key is **folded** into the
round's mean the moment every member's copy of it is present, while the
slower clients are still on the wire. Each fold is one ``fold_ordered``
call: one launch of the fold kernel (K4) per parameter leaf when the
server runs on the card.

Bit-exactness contract: the result equals ``comm.server.aggregate_flat``,
the barrier mean, BIT-EXACTLY, whatever the arrival order. The fold
replays the identical fp32 arithmetic in the identical order: per key
``acc = zeros; acc += float32(w_i) * leaf_i`` over clients in ascending
id order, with the weights normalized in float64 and then cast to fp32,
exactly as the barrier does. Quantized leaves arrive dequantized (fp32),
and a sparse-delta upload folds as ``base[key] + float32(delta)``, the
barrier's absolute reconstruction (its shapes are checked against the
base when it arrives).

Consequences of folding early:

* the fold set must be frozen before the first fold (the weights are
  normalized over it). Before any fold a frozen set may still change (a
  member died between its intent and its first complete leaf, or a new
  contributor is admitted): it is re-frozen over the final set;
* a fold set that changes after its first fold, or a member that dies
  or re-uploads after folds began, poisons the round: its folded leaves
  cannot be subtracted back out. The round then fails with the reason
  attached, as does a fold that raises (a kernel that does not build or
  launch, for instance).

Folds run under the state's lock on the server's connection threads; a
fold on the card runs on the server's device (``fold_ordered`` enters
it), and its CUDA-event timings are taken per call.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Mapping

import numpy as np
import torch

from ..ops import fold as fold_ops
from . import wire


class StreamAggPoisoned(RuntimeError):
    """The running aggregate can no longer reach a correct mean (a folded
    contributor died or re-uploaded, or a fold failed)."""


class StreamAgg:
    """One round's incremental weighted-mean state, folded on ``device``.

    ``eager=False`` never freezes before :meth:`finalize`: every upload is
    held and the barrier mean is folded at close. ``base`` is the last
    aggregate, the base of sparse-delta uploads.

    Thread-safety: one internal lock serializes every mutation; folds run
    under it, which also serializes the fp32 accumulation."""

    def __init__(
        self,
        *,
        device: str | torch.device,
        eager: bool = True,
        base: Mapping[str, np.ndarray] | None = None,
    ):
        self.device = torch.device(device)
        self.eager = bool(eager)
        self.base = base
        self._lock = threading.Lock()
        #: cid -> {"keys": tuple, "n_samples": float, "delta": bool}
        self.intents: dict[int, dict] = {}
        self._pending: dict[str, dict[int, np.ndarray]] = {}
        self._acc: dict[str, np.ndarray] = {}
        self._folded: set[str] = set()
        self.fold_ids: list[int] | None = None
        self._weights: dict[int, np.float64] | None = None
        self.poisoned: str | None = None
        self._wait_over = False
        #: cids whose upload fully arrived: a fold only counts as
        #: "overlapped" while some member's bytes are still in flight.
        self._complete: set[int] = set()
        #: Per-client fold stats the round's strategy is handed, cid ->
        #: {"weight", "bytes", "scale"}; an entry lives exactly as long as
        #: the client's intent.
        self._client_stats: dict[int, dict[str, float]] = {}
        self._cur_bytes = 0
        self.peak_bytes = 0
        self.early_bytes = 0
        self.late_bytes = 0
        self.early_s = 0.0
        self.late_s = 0.0
        #: CUDA-event milliseconds of the folds' copies and kernels (card only).
        self._fold_ms: dict[str, float] = {}

    # ------------------------------------------------------------ intents
    def register(self, cid: int, *, keys: tuple, n_samples: float, delta: bool = False) -> None:
        with self._lock:
            self.intents[cid] = {"keys": tuple(keys), "n_samples": float(n_samples), "delta": bool(delta)}
            self._client_stats[cid] = {"weight": float(n_samples), "bytes": 0.0, "scale": 1.0}

    def admit(self, cid: int) -> bool:
        """Take a NEW contributor into the round's fold. Before any fold a
        frozen set is un-frozen (the next freeze re-normalizes over the
        grown set); once folds consumed the frozen weights no correct mean
        including ``cid`` exists: returns False and the caller refuses."""
        with self._lock:
            if self.fold_ids is None or cid in self.fold_ids:
                return True
            if self._folded:
                return False
            self.fold_ids = None
            self._weights = None
            return True

    def drop_client(self, cid: int, *, poison: bool = True) -> bool:
        """Forget a client's unfolded state (a death, a duplicate upload).
        Returns False when folds already consumed its leaves, poisoning
        the round when ``poison`` (a folded contributor died) or leaving
        the folded original standing when not (a duplicate is refused).
        Before any fold a frozen fold set holding ``cid`` is un-frozen, so
        ``finalize`` re-freezes over the survivors."""
        with self._lock:
            if self.fold_ids and cid in self.fold_ids:
                if self._folded:
                    if poison:
                        self.poisoned = (
                            f"client {cid} dropped its upload after "
                            f"{len(self._folded)} leaf folds already "
                            "consumed it"
                        )
                        self.intents.pop(cid, None)
                        self._client_stats.pop(cid, None)
                        self._complete.discard(cid)
                    return False
                self.fold_ids = None
                self._weights = None
            self.intents.pop(cid, None)
            self._client_stats.pop(cid, None)
            self._complete.discard(cid)
            for leaves in self._pending.values():
                arr = leaves.pop(cid, None)
                if arr is not None:
                    self._cur_bytes -= arr.nbytes
            return True

    def mark_complete(self, cid: int) -> None:
        """The client's upload fully arrived (trailer verified): later
        folds no longer overlap ITS wire time."""
        with self._lock:
            self._complete.add(cid)

    # ------------------------------------------------------------- leaves
    def _put(self, cid: int, key: str, arr: np.ndarray) -> None:
        """Caller holds the lock; a re-supplied leaf replaces, not adds."""
        prev = self._pending.setdefault(key, {}).get(cid)
        if prev is not None:
            self._cur_bytes -= prev.nbytes
        self._pending[key][cid] = arr
        self._cur_bytes += arr.nbytes
        if cid in self._client_stats:
            self._client_stats[cid]["bytes"] += float(arr.nbytes)

    def add_leaf(self, cid: int, key: str, arr: np.ndarray) -> None:
        """One leaf of a streamed upload, decoded as its bytes completed."""
        with self._lock:
            if key in self._folded:
                # Only a non-member's late leaf: a member's were all
                # present before the key folded.
                return
            self._put(cid, key, arr)
            self.peak_bytes = max(self.peak_bytes, self._cur_bytes)
            if self.fold_ids is not None:
                self._maybe_fold(key)

    def add_dense(self, cid: int, flat: Mapping[str, np.ndarray]) -> None:
        """A single-frame upload: all of a client's leaves at once (dense
        and streamed clients mix in one fold)."""
        with self._lock:
            self._complete.add(cid)
            for key, arr in flat.items():
                if key not in self._folded:
                    self._put(cid, key, np.asarray(arr))
            self.peak_bytes = max(self.peak_bytes, self._cur_bytes)
            if self.fold_ids is not None:
                for key in list(self._pending):
                    self._maybe_fold(key)

    # -------------------------------------------------------------- folds
    def freeze(self, ids: list[int], weights: list[float] | None) -> None:
        """Fix the fold set and its normalized weights (the weight math of
        ``aggregate_flat``), then fold every leaf already complete."""
        with self._lock:
            if self.poisoned:
                return
            ids = sorted(int(i) for i in ids)
            if self.fold_ids is not None:
                if ids == self.fold_ids:
                    return
                if self._folded:
                    self.poisoned = (
                        f"fold set changed after {len(self._folded)} "
                        f"folds ({self.fold_ids} -> {ids})"
                    )
                    return
                self.fold_ids = None
                self._weights = None
            if weights is None:
                w = np.ones(len(ids), np.float64)
            else:
                w = np.asarray(weights, np.float64)
                if w.shape != (len(ids),) or w.sum() <= 0:
                    raise ValueError(f"bad weights {weights}")
            w = w / w.sum()
            self._weights = {cid: w[i] for i, cid in enumerate(ids)}
            self.fold_ids = ids
            for key in list(self._pending):
                self._maybe_fold(key)

    def _maybe_fold(self, key: str) -> None:
        """Caller holds the lock; folds ``key`` when every fold-set
        member's leaf is present."""
        if self.poisoned or key in self._folded:
            return
        leaves = self._pending.get(key)
        if leaves is None or any(c not in leaves for c in self.fold_ids):
            return
        t0 = time.monotonic()
        try:
            ordered: list[np.ndarray] = []
            for cid in self.fold_ids:
                arr = leaves[cid]
                if self.intents[cid]["delta"]:
                    arr = self.base[key] + np.asarray(arr, np.float32)
                arr = np.asarray(arr, np.float32)
                if ordered and arr.shape != ordered[0].shape:
                    raise wire.WireError(f"shape mismatch for {key!r}")
                ordered.append(arr)
            acc = fold_ops.fold_ordered(
                ordered,
                [np.float32(self._weights[c]) for c in self.fold_ids],
                device=self.device,
                times=self._fold_ms,
            )
        except Exception as e:  # poison the round, don't kill the handler thread
            self.poisoned = f"fold of {key!r} failed: {e}"
            return
        self._acc[key] = acc
        freed = sum(a.nbytes for a in leaves.values())
        del self._pending[key]
        self._cur_bytes += acc.nbytes - freed
        self.peak_bytes = max(self.peak_bytes, self._cur_bytes)
        self._folded.add(key)
        dur = time.monotonic() - t0
        overlapped = not self._wait_over and any(c not in self._complete for c in self.fold_ids)
        if overlapped:
            self.early_bytes += freed
            self.early_s += dur
        else:
            self.late_bytes += freed
            self.late_s += dur

    def mark_wait_end(self) -> None:
        """The round's wait phase is over: folds from here on are exposed
        aggregation time, not overlapped wire time."""
        with self._lock:
            self._wait_over = True

    # ----------------------------------------------------------- finalize
    def finalize(
        self, ids: list[int], weights: list[float] | None
    ) -> dict[str, np.ndarray]:
        """Fold whatever is left over the FINAL contributor set and return
        the mean (sorted by key). With a prior freeze, ``ids`` must match
        it: a divergence after folds began poisons the round."""
        if self.poisoned:
            raise StreamAggPoisoned(self.poisoned)
        self.freeze(ids, weights)
        with self._lock:
            if self.poisoned:
                raise StreamAggPoisoned(self.poisoned)
            want = set(str(k) for i in self.fold_ids for k in self.intents[i]["keys"])
            for i in self.fold_ids:
                if set(self.intents[i]["keys"]) != want:
                    raise wire.WireError(f"model {i} key set differs from the round's")
            for key in sorted(want - self._folded):
                leaves = self._pending.get(key, {})
                absent = [c for c in self.fold_ids if c not in leaves]
                if absent:
                    raise wire.WireError(f"leaf {key!r} never arrived from clients {absent}")
                self._maybe_fold(key)
            if self.poisoned:
                raise StreamAggPoisoned(self.poisoned)
            return dict(sorted(self._acc.items()))

    # -------------------------------------------------------------- stats
    def client_stats(self) -> dict[int, dict[str, float]]:
        """Per-client fold stats for the round's strategy (a snapshot)."""
        with self._lock:
            return {cid: dict(self._client_stats[cid]) for cid in sorted(self._client_stats)}

    def stats(self) -> dict[str, Any]:
        """Fold accounting: bytes and seconds folded during and after the
        wait phase, the engine, and on the card the CUDA-event milliseconds
        of the folds' copies in, launches and kernels, and copies back
        (``fold_ordered``'s ``times``)."""
        with self._lock:
            stale = sorted(set(self._client_stats) - set(self.intents))
            if stale:
                raise RuntimeError(f"client stats leak for dropped clients {stale}")
            folded = self.early_bytes + self.late_bytes
            fold_s = self.early_s + self.late_s
            return {
                "peak_bytes": int(self.peak_bytes),
                "early_bytes": int(self.early_bytes),
                "late_bytes": int(self.late_bytes),
                "early_s": float(self.early_s),
                "late_s": float(self.late_s),
                "overlap_frac": self.early_bytes / folded if folded else 0.0,
                "fold_engine": fold_ops.engine_name(self.device),
                "fold_s": float(fold_s),
                "fold_throughput_gbps": (
                    folded / fold_s / 1e9 if fold_s > 0 and folded else 0.0
                ),
                "fold_h2d_ms": self._fold_ms.get("h2d_ms", 0.0),
                "fold_kernel_ms": self._fold_ms.get("kernel_ms", 0.0),
                "fold_d2h_ms": self._fold_ms.get("d2h_ms", 0.0),
            }
