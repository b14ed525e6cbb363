"""Hot reload: the scoring service follows training or the control plane
(the port of the JAX package's ``serving/reload.py``).

The scorer's idle tick calls ``watcher.poll(engine)`` between batches (no
watcher thread races the scorer). On something new the watcher restores
it and swaps the engine's model through ``ScoreEngine.swap``: in-flight
batches finish on the old weights, the next batch serves the new ones,
and every reply names the round that scored it.

* :class:`CheckpointWatcher` follows a training checkpoint directory: a
  new finished step (an all-digit directory name, see
  ``train/checkpoint.py``) restores through the same path ``predict``
  uses (``restore_for_inference``).
* :class:`RegistryWatcher` follows the model registry's serving pointer,
  so only what the control plane promoted reaches traffic, and a
  rollback takes effect within one poll.

Both refuse an architecture change (restart the service for that) and
never let a failed reload end the scorer: the serving weights stay.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

from ..models.convert import params_from_jax
from ..train.checkpoint import _shapes_match, latest_finalized_step, restore_for_inference

log = logging.getLogger(__name__)

__all__ = ["CheckpointWatcher", "RegistryWatcher", "checkpoint_restorer", "latest_finalized_step"]

#: step (None = the latest) -> (model_cfg, params, round_id, step restored).
RestoreFn = Callable[[int | None], tuple[Any, Any, int, int]]

#: Failed restores of one step before the watcher writes it off (the last
#: round's step has no newer one coming to replace it).
_MAX_RETRIES = 5


def checkpoint_restorer(ckpt_dir: str, model_cfg, *, device) -> RestoreFn:
    """Bind ``restore_for_inference`` (the ``predict`` path) to a
    directory, the resolved model config and a device. The returned
    function restores the step it is given (the latest for None) and
    reads the round id (meta ``round``, else the step) from that same
    step, and returns the step with the weights."""

    def restore(step: int | None) -> tuple[Any, Any, int, int]:
        cfg, params, step, meta = restore_for_inference(ckpt_dir, model_cfg, device=device, step=step)
        return cfg, params, int(meta.get("round", step)), step

    return restore


class CheckpointWatcher:
    """Poll-on-idle reload from a checkpoint directory.

    ``poll(engine)`` rate-limits itself to ``poll_interval_s``, detects a
    new finished step, restores it and swaps it in (same architecture
    only). A failed restore logs and keeps the serving weights; the step
    is retried on later polls, up to ``_MAX_RETRIES`` times, before it is
    written off."""

    def __init__(self, ckpt_dir: str, restore_fn: RestoreFn, *, poll_interval_s: float = 2.0):
        self.ckpt_dir = ckpt_dir
        self.restore_fn = restore_fn
        self.poll_interval_s = float(poll_interval_s)
        self._last_poll = 0.0
        self._seen_step: int | None = None
        self._fail_step: int | None = None
        self._fail_count = 0
        self._primed = False
        self.reload_count = 0

    @property
    def primed(self) -> bool:
        return self._primed

    def prime(self, step: int | None = None) -> None:
        """Record the step already serving. Pass the step the caller
        restored: a directory scan would mark a step finished since then
        as already seen."""
        self._seen_step = latest_finalized_step(self.ckpt_dir) if step is None else step
        self._primed = True

    def poll(self, engine, *, force: bool = False) -> bool:
        """One idle-tick check; True when a new step was adopted."""
        now = time.monotonic()
        if not force and now - self._last_poll < self.poll_interval_s:
            return False
        self._last_poll = now
        step = latest_finalized_step(self.ckpt_dir)
        if step is None or (self._seen_step is not None and step <= self._seen_step):
            return False
        try:
            model_cfg, params, round_id, step = self.restore_fn(step)
        except Exception as e:
            if self._fail_step != step:
                self._fail_step, self._fail_count = step, 0
            self._fail_count += 1
            if self._fail_count >= _MAX_RETRIES:
                self._seen_step = step  # a newer step still reloads
            log.warning(
                f"[SERVE] checkpoint reload from {self.ckpt_dir} (step {step}) "
                f"failed ({type(e).__name__}: {e}); keeping the serving weights "
                f"(attempt {self._fail_count}/{_MAX_RETRIES})"
            )
            return False
        self._fail_step, self._fail_count = None, 0
        self._seen_step = step
        if model_cfg != engine.model_cfg:
            log.warning(
                f"[SERVE] checkpoint at step {step} declares a different "
                "architecture than the serving engine; skipping hot reload "
                "(restart the service to change model shapes)"
            )
            return False
        engine.swap(params, round_id=round_id)
        self.reload_count += 1
        log.info(f"[SERVE] hot-reloaded checkpoint step {step} (model round {round_id})")
        return True


class RegistryWatcher:
    """Pointer-following reload: serve only what the control plane
    promoted. Same duck type as :class:`CheckpointWatcher`."""

    def __init__(self, registry, *, poll_interval_s: float = 2.0):
        self.registry = registry
        self.poll_interval_s = float(poll_interval_s)
        self._last_poll = 0.0
        self._seen: str | None = None
        # An incompatible artifact is not marked seen (a rollback to a
        # compatible one must still be adopted): warn about it once.
        self._warned: str | None = None
        self._primed = False
        self.reload_count = 0

    @property
    def primed(self) -> bool:
        return self._primed

    def prime(self, artifact: str | None = None) -> None:
        """Record the artifact already serving; None reads the pointer."""
        if artifact is None:
            info = self.registry.serving_info()
            artifact = info["artifact"] if info else None
        self._seen = artifact
        self._primed = True

    def _refuse(self, aid: str, why: str) -> bool:
        if self._warned != aid:
            self._warned = aid
            log.warning(f"[SERVE] serving artifact {aid} {why}; skipping hot swap (restart the service to change shapes)")
        return False

    def poll(self, engine, *, force: bool = False) -> bool:
        """One idle-tick check; True when a newly promoted (or rolled-back
        to) artifact was adopted. Any registry error keeps the serving
        weights."""
        now = time.monotonic()
        if not force and now - self._last_poll < self.poll_interval_s:
            return False
        self._last_poll = now
        try:
            info = self.registry.serving_info()
        except Exception as e:
            log.warning(f"[SERVE] registry pointer read failed: {e}")
            return False
        if info is None or info.get("artifact") == self._seen:
            return False
        aid = info["artifact"]
        try:
            manifest = self.registry.manifest(aid)
            mc = manifest.get("model_config")
            if mc is not None and mc != dataclasses.asdict(engine.model_cfg):
                return self._refuse(aid, "declares a different architecture than the engine")
            params = params_from_jax(self.registry.load_params(aid))
            if mc is None and not _shapes_match(engine.snapshot()[0].state_dict(), params):
                # No recorded architecture: the param tree is the claim.
                return self._refuse(aid, "has a different param tree than the engine (no model_config recorded)")
            engine.swap(params, round_id=int(manifest.get("round", 0)))
        except Exception as e:
            log.warning(
                f"[SERVE] reload of serving artifact {aid} failed "
                f"({type(e).__name__}: {e}); keeping the serving weights"
            )
            return False
        self._seen = aid
        self._warned = None
        self.reload_count += 1
        log.info(f"[SERVE] hot-swapped to promoted artifact {aid} (round {manifest.get('round')})")
        return True
