"""Checkpoint and warm start of a training state (the port of the JAX
package's ``train/checkpoint.py``).

The reference saves ``model.state_dict()`` after local training and after
adopting the aggregate, and loads it again on the next launch (reference
client1.py:375-377,388,403): its only multi-round mechanism. Here the FULL
state is saved, so a resumed run continues the uninterrupted one: a
:class:`~.engine.TrainState` (params, Adam moments and count, the global
step and the dropout generator) or a federated
:class:`~.fedsteps.FedState` (stacked ``[C, ...]`` params and moments,
one Adam count and one dropout generator per client, the lockstep step
and the server optimizer's state).

Layout, one directory a step (not orbax's: a JAX process cannot read it;
the model registry is the format the two packages share)::

    <dir>/<step>/state.pt    torch.save of {"params", "mu", "nu", "count",
                             "step", "generator": {"device_type", "state"}}
                             (with gradient accumulation also "acc" and
                             "mini_step", so a run saved mid-window resumes
                             inside it; federated: "count" and
                             "mini_step" are [C], "acc" stacked,
                             "generators" a list, plus "server_opt")
    <dir>/<step>/meta.json   the caller's meta + "_leaf_shapes"

A step is written under ``<dir>/<step>.tmp-<pid>/`` and renamed to
``<dir>/<step>/`` when complete, orbax's finalization rule: a directory
whose name is all digits is a finished step, which is what the serving
tier's reload watcher polls for. ``max_to_keep`` deletes the oldest
finished steps. Files load with ``torch.load(..., weights_only=True,
map_location="cpu")``, memory-mapped, and the leaves are copied onto the
caller's device, so a checkpoint written on the card reads on the CPU and
the reverse.

A generator's state depends on its device type (16 bytes of Philox seed
and offset on CUDA, 5,056 bytes of mt19937 on the CPU) and neither loads
into the other: a restore on the same device type continues the dropout
stream exactly; on another it keeps the template's freshly seeded
generator (as ``Trainer.init_state`` seeds it) and warns.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
from typing import Any, Mapping

import torch

from ..config import ExperimentConfig, ModelConfig
from ..models.distilbert import model_skeleton
from ..parallel.mesh import ShardedLeaf
from .engine import AdamState, TrainState
from .fedsteps import FedAdamState, FedState

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def latest_finalized_step(directory: str) -> int | None:
    """Largest finished step in ``directory`` (None when empty or
    missing): all-digit directory names only, tmp directories carry a
    suffix. One ``os.scandir``, cheap enough for a poll on every idle
    tick."""
    steps = _finalized_steps(directory)
    return steps[-1] if steps else None


def _finalized_steps(directory: str) -> list[int]:
    try:
        entries = list(os.scandir(directory))
    except OSError:
        return []
    return sorted(
        int(e.name) for e in entries if e.name.isdigit() and e.is_dir(follow_symlinks=False)
    )


def _server_leaves(server_opt: Mapping[str, Any] | None) -> list[torch.Tensor]:
    """The server optimizer state's tensors in a fixed order."""
    if not server_opt:
        return []
    return [t for k in sorted(server_opt) if isinstance(server_opt[k], Mapping) for t in server_opt[k].values()]


def _leaf_shapes(state: TrainState | FedState) -> list[list[int]]:
    """Per-leaf shapes in a fixed order: params, then Adam's mu and nu (in
    the state's order), then the count (a scalar, or ``[C]`` for a
    federated state) and the step, then a federated state's server
    optimizer leaves, then the gradient accumulator (a federated state's
    after its ``[C]`` mini steps). A positional list, so two tables
    swapping sizes still differ, and a state with accumulation never
    matches one without."""
    tensors = [*state.params.values(), *state.opt_state.mu.values(), *state.opt_state.nu.values()]
    shapes = [[int(d) for d in t.shape] for t in tensors]
    if isinstance(state, FedState):
        acc = state.opt_state.acc
        tail = [] if acc is None else [[len(state.opt_state.mini_step)]] + [
            [int(d) for d in t.shape] for t in acc.values()
        ]
        return shapes + [[len(state.opt_state.count)], []] + [
            [int(d) for d in t.shape] for t in _server_leaves(state.server_opt)
        ] + tail
    acc = [[int(d) for d in t.shape] for t in (state.acc or {}).values()]
    return shapes + [[], []] + acc


def _shapes_match(a: Mapping[str, Any], b: Mapping[str, Any]) -> bool:
    """True when two flat leaf maps agree on names and per-leaf shapes —
    the compatibility a restore needs (dtypes are the template's)."""
    return a.keys() == b.keys() and all(tuple(a[n].shape) == tuple(b[n].shape) for n in a)


def _payload(state: TrainState | FedState) -> dict:
    """What ``state.pt`` holds for ``state``."""
    opt = state.opt_state
    payload = {
        "params": _whole(state.params),
        "mu": _whole(opt.mu),
        "nu": _whole(opt.nu),
        "step": int(state.step),
    }
    if isinstance(state, FedState):
        payload["count"] = torch.tensor(opt.count, dtype=torch.int64)
        payload["generators"] = [
            {"device_type": g.device.type, "state": g.get_state()} for g in state.generators
        ]
        payload["server_opt"] = state.server_opt
        if opt.acc is not None:
            payload["acc"] = dict(opt.acc)
            payload["mini_step"] = torch.tensor(opt.mini_step, dtype=torch.int64)
    else:
        payload["count"] = int(opt.count)
        payload["generator"] = {"device_type": state.generator.device.type, "state": state.generator.get_state()}
        if state.acc is not None:
            payload["acc"] = _whole(state.acc)
            payload["mini_step"] = int(state.mini_step)
    return payload


def _whole(leaves: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Leaves as whole tensors: a leaf split over mesh slots
    (parallel/mesh.py ``ShardedLeaf``) is gathered to the host, so a
    sharded state saves the same file as a single-device one."""
    return {n: t.gather("cpu") if isinstance(t, ShardedLeaf) else t.detach() for n, t in leaves.items()}


def _to_device(tree: Any, device: torch.device) -> Any:
    """A loaded (host, memory-mapped) tree's tensors copied onto ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def _generator(saved: Mapping[str, Any], template: torch.Generator) -> torch.Generator:
    """The saved dropout generator on the template's device, or (another
    device type) a copy of the template's freshly seeded one."""
    device = template.device
    g = torch.Generator(device=device)
    if saved["device_type"] == device.type:
        g.set_state(saved["state"].cpu())
    else:
        log.warning(
            f"checkpoint's dropout generator was saved on {saved['device_type']}, "
            f"the trainer runs on {device.type}: its state does not load there, "
            "so the dropout stream restarts from the trainer's seed"
        )
        g.set_state(template.get_state())
    return g


class CheckpointError(ValueError):
    """A checkpoint directory that cannot give inference weights: missing,
    empty, or saved under another model."""


class Checkpointer:
    """Save and restore :class:`~.engine.TrainState` s and
    :class:`~.fedsteps.FedState` s under one directory.

    The restore template, a fresh ``init_state()`` of the trainer, gives
    the device, the dtypes, which leaves train, and the generators' seeds
    for generators that cannot be restored; the checkpoint gives the
    values.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep={max_to_keep} must be >= 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: TrainState | FedState, *, meta: Mapping[str, Any] | None = None) -> None:
        """Write ``state`` as step ``step`` (synchronous: the step is
        finished when this returns). A step that already exists is kept
        and this save skipped, as orbax does."""
        final = self._step_dir(step)
        if os.path.isdir(final):
            log.warning(f"checkpoint step {step} already exists in {self.directory}; not overwritten")
            return
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(_payload(state), os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump({**(dict(meta) if meta else {}), "_leaf_shapes": _leaf_shapes(state)}, f)
            os.rename(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for old in _finalized_steps(self.directory)[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def wait(self) -> None:
        """Saves are synchronous; kept so callers read as with orbax."""

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        return latest_finalized_step(self.directory)

    def _resolve(self, step: int | None) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return int(step)

    def _load(self, step: int | None) -> dict:
        """The step's saved tree, memory-mapped on the host: a tensor's
        bytes are read only when it is copied out."""
        path = os.path.join(self._step_dir(self._resolve(step)), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)

    def restore(self, template: TrainState | FedState, *, step: int | None = None) -> TrainState | FedState:
        """The state saved at ``step`` (default: latest) on the template's
        device; leaf names or shapes unlike the template's raise
        ValueError."""
        device = next(iter(template.params.values())).device
        saved = self._load(step)

        def leaves(group: str, like: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
            got = saved[group]
            if not _shapes_match(got, like):
                raise ValueError(f"checkpoint {group} names or shapes differ from the template's")
            return {
                n: t.like(got[n]).requires_grad_(t.requires_grad) if isinstance(t, ShardedLeaf)
                else got[n].to(device=device, dtype=t.dtype, copy=True).requires_grad_(t.requires_grad)
                for n, t in like.items()
            }

        opt = template.opt_state
        if isinstance(template, FedState):
            count = [int(c) for c in saved["count"].tolist()]
            if len(count) != len(template.generators) or len(saved["generators"]) != len(count):
                raise ValueError("checkpoint client count differs from the template's")
            if (opt.acc is None) != ("acc" not in saved):
                raise ValueError("checkpoint gradient accumulation differs from the template's")
            acc = mini = None
            if opt.acc is not None:
                acc = leaves("acc", opt.acc)
                mini = [int(c) for c in saved["mini_step"].tolist()]
            return FedState(
                leaves("params", template.params),
                FedAdamState(count, leaves("mu", opt.mu), leaves("nu", opt.nu), acc, mini),
                int(saved["step"]),
                [_generator(g, t) for g, t in zip(saved["generators"], template.generators)],
                _to_device(saved["server_opt"], device),
            )
        if (template.acc is None) != ("acc" not in saved):
            raise ValueError("checkpoint gradient accumulation differs from the template's")
        return TrainState(
            leaves("params", template.params),
            AdamState(int(saved["count"]), leaves("mu", opt.mu), leaves("nu", opt.nu)),
            int(saved["step"]),
            _generator(saved["generator"], template.generator),
            None if template.acc is None else leaves("acc", template.acc),
            int(saved.get("mini_step", 0)),
        )

    def saved_compatible(self, template: TrainState | FedState, *, step: int | None = None) -> bool:
        """Does the step's recorded ``_leaf_shapes`` list equal the
        template's? Checked before any tensor loads. Every step save()
        writes records the list, so a step without it is not one of
        ours -> False."""
        try:
            step = self._resolve(step)
        except FileNotFoundError:
            return False
        recorded = self._restore_meta_raw(step=step).get("_leaf_shapes")
        if recorded is None:
            return False
        return [list(map(int, s)) for s in recorded] == _leaf_shapes(template)

    def restore_params(
        self, *, step: int | None = None, device: str | torch.device = "cpu", client: int | None = None
    ) -> dict[str, torch.Tensor]:
        """Only the params of a saved state, as fp32 copies on ``device``:
        the file is memory-mapped, so the moments are never read.
        ``client``: of a federated state, that client's row alone (the
        other rows are not read either)."""
        saved = self._load(step)
        return {
            n: (t if client is None else t[client]).to(device=device, dtype=torch.float32, copy=True)
            for n, t in saved["params"].items()
        }

    def restore_meta(self, *, step: int | None = None) -> dict:
        """The caller's meta (the underscore keys save() adds stripped)."""
        return {k: v for k, v in self._restore_meta_raw(step=step).items() if not str(k).startswith("_")}

    def _restore_meta_raw(self, *, step: int | None = None) -> dict:
        path = os.path.join(self._step_dir(self._resolve(step)), META_FILE)
        try:
            with open(path) as f:
                return dict(json.load(f))
        except (OSError, json.JSONDecodeError):
            return {}

    def close(self) -> None:
        """Nothing is held open; kept for the context manager."""

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def maybe_warm_start(
    directory: str, template: TrainState | FedState
) -> tuple[TrainState | FedState | None, int | None]:
    """The reference's warm start (client1.py:375-377): the latest saved
    state in ``directory``, or ``(None, None)`` when there is none.

    Returns ``(state, step)``. A checkpoint saved under another model
    shape, another set of trained leaves, or one that fails to load
    degrades to a fresh start with a warning: warm start is an
    optimization, and the reference proceeds from scratch when its
    ``.pth`` is absent."""
    if not os.path.isdir(directory):
        return None, None
    with Checkpointer(directory) as ckpt:
        step = ckpt.latest_step()
        if step is None:
            return None, None
        if not ckpt.saved_compatible(template, step=step):
            log.warning(
                f"checkpoint at {directory} (step {step}) was saved under a "
                "different model shape; starting fresh"
            )
            return None, None
        try:
            restored = ckpt.restore(template, step=step)
        except (OSError, RuntimeError, KeyError, ValueError, pickle.UnpicklingError) as e:
            # A file that does not load, or leaves unlike the template's.
            log.warning(
                f"checkpoint at {directory} (step {step}) failed to restore "
                f"({type(e).__name__}: {e}); starting fresh"
            )
            return None, None
        return restored, step


def restore_for_inference(
    directory: str, model_cfg: ModelConfig, *, device: str | torch.device, step: int | None = None
) -> tuple[ModelConfig, dict[str, torch.Tensor], int, dict]:
    """Trained weights for inference from ``step`` (default: the latest),
    as ``(model_cfg, params, step, meta)`` with fp32 params on ``device``.
    The params, the meta and the returned step all come from that one
    step, so a step finished meanwhile can never label old weights.

    The checkpoint's recorded model config wins over ``model_cfg`` (its
    gelu variant, say, changes no shape, so a wrong preset would restore
    fine and then run the wrong activation); ``model_cfg`` gives the
    tokenizer's vocab size it must agree with. A federated checkpoint
    (meta ``kind == "federated"``) gives client 0's row of the stacked
    params, the global model (FedAvg writes the mean into every row), and
    reads nothing else. Raises CheckpointError instead of predicting from
    random weights, and never creates ``directory``."""
    if not os.path.isdir(directory):
        raise CheckpointError(f"checkpoint dir {directory} does not exist")
    with Checkpointer(directory) as ckpt:
        step = ckpt.latest_step() if step is None else int(step)
        if step is None:
            raise CheckpointError(f"no checkpoint found in {directory}")
        meta = ckpt.restore_meta(step=step)
        if "config" in meta:
            saved = ExperimentConfig.from_checkpoint_dict(meta["config"]).model
            if saved.vocab_size != model_cfg.vocab_size:
                raise CheckpointError(
                    f"checkpoint model vocab ({saved.vocab_size}) != "
                    f"tokenizer vocab ({model_cfg.vocab_size}); pass the "
                    "matching --hf-dir / vocab"
                )
            model_cfg = saved
        federated = meta.get("kind") == "federated"
        params = ckpt.restore_params(step=step, device=device, client=0 if federated else None)
    if not _shapes_match(params, model_skeleton(model_cfg).state_dict()):
        raise CheckpointError(
            f"checkpoint at {directory} (step {step}) does not match the "
            "resolved model; pass the --preset the checkpoint was trained with"
        )
    return model_cfg, params, step, meta
