"""Content-addressed artifact store with an atomic serving pointer (the
port of the JAX package's ``registry/store.py``; one root may be written
by both packages in turn).

Layout under the registry root::

    artifacts/<id>/params.npz     flat fp32 params ('/'-joined JAX keys)
    artifacts/<id>/manifest.json  round, state, eval metrics, model config
    serving.json                  the serving pointer (atomic os.replace)
    shadow.json                   the artifact under shadow evaluation
    events.jsonl                  append-only audit trail

The artifact id is a truncated SHA-256 over the sorted (key, dtype,
shape, bytes) of the params in the JAX package's flat layout (a port
state dict goes through ``params_to_jax`` first), so the same weights get
the same id in both packages. Artifacts are staged under a tmp directory
and renamed into place, manifests and pointers are rewritten through tmp
+ ``os.replace``: every read a serving process makes sees the old state
or the new one, never a torn write. With a ``tracer`` (obs/trace.py)
every promotion, pointer swap and rollback is also a ``promote`` span, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import time
from typing import Any, Mapping

import numpy as np
import torch

from ..comm import wire
from ..models.convert import params_to_jax

log = logging.getLogger(__name__)

#: Promotion ladder (promote() advances one rung; serving swaps the
#: pointer). ``rejected`` is the eval gate's terminal verdict; ``retired``
#: is what a serving artifact becomes when another one replaces it.
STATES = ("candidate", "shadow", "serving", "rejected", "retired")
_LADDER = ("candidate", "shadow", "serving")

_POINTER = "serving.json"
_SHADOW = "shadow.json"
_EVENTS = "events.jsonl"
_ID_HEX = 16  # 64 bits of sha256


class RegistryError(ValueError):
    """Unknown artifact, illegal state transition, or a corrupt store."""


def _atomic_write_json(path: str, obj: Mapping[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _flatten(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Params -> the flat fp32 dict the registry stores, in the JAX
    package's keys. Takes a port state dict (every value a tensor; it goes
    through ``params_to_jax``) or that flat '/'-keyed dict itself."""
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        params = wire.flatten_params(params_to_jax(params))
    elif any(isinstance(v, Mapping) for v in params.values()):
        raise TypeError("registry params: a port state dict or a flat '/'-keyed dict, not a nested tree")
    return {str(k): np.asarray(v, np.float32) for k, v in params.items()}


def artifact_id(params: Mapping[str, Any]) -> str:
    """Content address: SHA-256 over the sorted (key, dtype, shape, bytes)
    manifest, truncated to 64 bits of hex."""
    flat = _flatten(params)
    h = hashlib.sha256()
    for key in sorted(flat):
        arr = np.ascontiguousarray(flat[key])
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:_ID_HEX]


def _shadow_evidence(root: str, aid: str) -> tuple[str, str]:
    """The shadow gate's status snapshot and paired-records paths for
    ``aid`` (the JAX package's ``shadow/gate.py`` layout)."""
    d = os.path.join(os.path.abspath(root), "shadow")
    return os.path.join(d, f"{aid}.status.json"), os.path.join(d, f"{aid}.pairs.jsonl")


class ModelRegistry:
    """Artifact store + promotion state machine + serving pointer."""

    def __init__(self, root: str, *, tracer=None):
        self.root = os.path.abspath(root)
        self._artifacts = os.path.join(self.root, "artifacts")
        self.tracer = tracer

    def _promote_span(self, t_unix: float, t0: float, aid: str, state: str, round_index) -> None:
        if self.tracer is None:
            return
        self.tracer.record(
            "promote",
            t_start=t_unix,
            dur_s=time.monotonic() - t0,
            round=round_index if isinstance(round_index, int) else None,
            artifact=aid,
            state=state,
        )

    def _event(self, kind: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "event": kind, **fields}
        with open(os.path.join(self.root, _EVENTS), "a") as f:
            f.write(json.dumps(rec) + "\n")

    # --------------------------------------------------------------- writing
    def add(
        self,
        params: Mapping[str, Any],
        *,
        round_index: int,
        metrics: Mapping[str, float] | None = None,
        eval_hist: Any | None = None,
        model_config: Any | None = None,
        parent: str | None = None,
        extra: Mapping[str, Any] | None = None,
    ) -> str:
        """Register one finished round's params as an immutable candidate
        and return its id. Re-adding identical params returns the
        existing id (content addressing). ``params``: a port state dict or
        its flat '/'-keyed JAX form. ``eval_hist``: the held-out score
        histogram (train/fedeval.reference_histogram) the drift monitor
        compares live scores against once this artifact serves.
        ``model_config`` (a ModelConfig or its asdict) lets the serving
        tier refuse to hot-swap an architecture mismatch. ``parent``: the
        artifact that served when this one was made (the controller's
        lineage). ``extra``: free-form provenance (the ``federated`` verb
        writes its tier and client count), recorded only when given. The
        manifest is the JAX package's, key for key."""
        flat = _flatten(params)
        aid = artifact_id(flat)
        final = os.path.join(self._artifacts, aid)
        if os.path.isdir(final):
            log.info(f"[REGISTRY] artifact {aid} already registered (dedup)")
            return aid
        if model_config is not None and dataclasses.is_dataclass(model_config):
            model_config = dataclasses.asdict(model_config)
        manifest = {
            "id": aid,
            "state": "candidate",
            "round": int(round_index),
            "created_unix": time.time(),
            "parent": parent,
            "metrics": _scalar_metrics(metrics),
            "eval_hist": (
                None
                if eval_hist is None
                else [int(c) for c in np.asarray(eval_hist).ravel()]
            ),
            "model_config": model_config,
            "n_tensors": len(flat),
            "n_params": int(sum(v.size for v in flat.values())),
        }
        if extra:
            manifest["extra"] = dict(extra)
        tmp = os.path.join(self._artifacts, f".tmp-{aid}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)  # creates the root on the first add
        try:
            with open(os.path.join(tmp, "params.npz"), "wb") as f:
                np.savez(f, **flat)
            _atomic_write_json(os.path.join(tmp, "manifest.json"), manifest)
            os.rename(tmp, final)
        except OSError:
            # A racing add() of the same content may have won the rename;
            # that is success (identical bytes by construction).
            if not os.path.isdir(final):
                raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self._event("added", artifact=aid, round=int(round_index))
        log.info(
            f"[REGISTRY] registered candidate {aid} (round {round_index}, "
            f"{manifest['n_params']:,} params)"
        )
        return aid

    # --------------------------------------------------------------- reading
    def _manifest_path(self, aid: str) -> str:
        return os.path.join(self._artifacts, aid, "manifest.json")

    def manifest(self, aid: str) -> dict:
        try:
            with open(self._manifest_path(aid)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise RegistryError(f"unknown or corrupt artifact {aid!r}: {e}") from None

    def load_params(self, aid: str) -> dict[str, np.ndarray]:
        """Artifact params as the flat '/'-keyed dict of numpy arrays
        (``models.convert.params_from_jax`` takes it as it is)."""
        path = os.path.join(self._artifacts, aid, "params.npz")
        try:
            with np.load(path) as z:
                return {k: np.asarray(z[k]) for k in z.files}
        except OSError as e:
            raise RegistryError(f"artifact {aid!r} has no params: {e}") from None

    def list(self) -> list[dict]:
        """Every artifact's manifest, oldest first."""
        try:
            entries = sorted(os.listdir(self._artifacts))
        except OSError:
            return []
        out = []
        for name in entries:
            if name.startswith("."):
                continue
            try:
                out.append(self.manifest(name))
            except RegistryError:
                continue
        out.sort(key=lambda m: m.get("created_unix", 0.0))
        return out

    # -------------------------------------------------------------- pointers
    def _read_pointer(self, name: str, what: str) -> dict | None:
        try:
            with open(os.path.join(self.root, name)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError) as e:
            raise RegistryError(f"corrupt {what} pointer: {e}") from None

    def serving_info(self) -> dict | None:
        """The serving pointer's content (None before any promotion).
        One atomic file read — safe against a concurrent promote()."""
        return self._read_pointer(_POINTER, "serving")

    def serving_manifest(self) -> dict | None:
        info = self.serving_info()
        return None if info is None else self.manifest(info["artifact"])

    def shadow_info(self) -> dict | None:
        """The shadow pointer's content (None when nothing is under live
        shadow evaluation)."""
        return self._read_pointer(_SHADOW, "shadow")

    def _clear_shadow(self, aid: str) -> None:
        """Drop the shadow pointer iff it names ``aid``; a pointer naming
        another artifact is left alone."""
        try:
            info = self.shadow_info()
        except RegistryError:
            info = None
        if info is not None and info.get("artifact") == aid:
            try:
                os.remove(os.path.join(self.root, _SHADOW))
            except OSError:
                pass

    # ----------------------------------------------------- state transitions
    def _set_state(self, aid: str, state: str) -> dict:
        if state not in STATES:
            raise RegistryError(f"unknown state {state!r}")
        m = self.manifest(aid)
        m["state"] = state
        m[f"{state}_unix"] = time.time()
        _atomic_write_json(self._manifest_path(aid), m)
        return m

    def promote(self, aid: str, *, to: str | None = None) -> dict:
        """Advance ``aid`` one rung up the ladder (or straight ``to`` a
        named rung). Reaching ``serving`` swaps the pointer atomically and
        retires the previous serving artifact. Returns the new manifest."""
        t_unix = time.time()
        t0 = time.monotonic()
        m = self.manifest(aid)
        cur = m.get("state", "candidate")
        if cur in ("rejected", "retired") and to is None:
            raise RegistryError(
                f"artifact {aid} is {cur}; promote it explicitly with "
                "to='candidate' first if that is really intended"
            )
        if to is None:
            if cur not in _LADDER:
                to = "candidate"
            elif cur == "serving":
                raise RegistryError(f"artifact {aid} is already serving")
            else:
                to = _LADDER[_LADDER.index(cur) + 1]
        if to not in STATES:
            raise RegistryError(f"unknown state {to!r}")
        if to != "serving":
            if to == "shadow":
                serving = self.serving_info()
                if serving is not None and serving.get("artifact") == aid:
                    raise RegistryError(
                        f"artifact {aid} is serving; a shadow evaluation "
                        "compares a CANDIDATE against the incumbent"
                    )
            m = self._set_state(aid, to)
            if to == "shadow":
                # A previous evaluation's evidence goes before the pointer
                # announces the new one (the pairs file is truncated, not
                # removed: its appender keeps one fd per path).
                status, pairs = _shadow_evidence(self.root, aid)
                try:
                    os.remove(status)
                except OSError:
                    pass
                try:
                    os.truncate(pairs, 0)
                except OSError:
                    pass
                _atomic_write_json(
                    os.path.join(self.root, _SHADOW),
                    {"artifact": aid, "round": m.get("round"), "since_unix": time.time()},
                )
            else:
                self._clear_shadow(aid)
            self._event("promoted", artifact=aid, state=to)
            log.info(f"[REGISTRY] {aid}: {cur} -> {to}")
            self._promote_span(t_unix, t0, aid, to, m.get("round"))
            return m
        prev = self.serving_info()
        prev_id = prev["artifact"] if prev else None
        if prev_id == aid:
            raise RegistryError(f"artifact {aid} is already serving")
        m = self._set_state(aid, "serving")
        self._clear_shadow(aid)
        pointer = {
            "artifact": aid,
            "round": m.get("round"),
            "promoted_at_unix": time.time(),
            # Rollback chain, most recent first.
            "history": ([prev_id] + list(prev.get("history", []))) if prev else [],
        }
        _atomic_write_json(os.path.join(self.root, _POINTER), pointer)
        if prev_id is not None:
            try:
                self._set_state(prev_id, "retired")
            except RegistryError:
                pass  # deleted out of band; the pointer moved anyway
        self._event("serving", artifact=aid, previous=prev_id)
        log.info(
            f"[REGISTRY] serving pointer -> {aid} (round {m.get('round')})"
            + (f", retired {prev_id}" if prev_id else "")
        )
        self._promote_span(t_unix, t0, aid, "serving", m.get("round"))
        return m

    def reject(self, aid: str, *, reason: str = "") -> dict:
        """Mark a candidate rejected (it stays on disk as lineage and
        reaches the pointer only through an explicit re-promote)."""
        m = self._set_state(aid, "rejected")
        self._clear_shadow(aid)
        self._event("rejected", artifact=aid, reason=reason)
        log.info(f"[REGISTRY] rejected {aid}" + (f": {reason}" if reason else ""))
        return m

    def rollback(self) -> dict:
        """Swap the pointer back to the previous serving artifact (one
        atomic step). The demoted artifact is marked retired."""
        t_unix = time.time()
        t0 = time.monotonic()
        cur = self.serving_info()
        if cur is None:
            raise RegistryError("nothing is serving; no rollback target")
        history = list(cur.get("history", []))
        if not history:
            raise RegistryError(f"serving artifact {cur['artifact']} has no predecessor")
        target, rest = history[0], history[1:]
        m = self.manifest(target)  # must still exist before anyone is demoted
        self._set_state(target, "serving")
        pointer = {
            "artifact": target,
            "round": m.get("round"),
            "promoted_at_unix": time.time(),
            "history": rest,
            "rolled_back_from": cur["artifact"],
        }
        _atomic_write_json(os.path.join(self.root, _POINTER), pointer)
        try:
            self._set_state(cur["artifact"], "retired")
        except RegistryError:
            pass
        self._event("rollback", artifact=target, previous=cur["artifact"])
        log.info(f"[REGISTRY] rollback: serving pointer {cur['artifact']} -> {target}")
        self._promote_span(t_unix, t0, target, "rollback", m.get("round"))
        return m

    # ------------------------------------------------------------------- gc
    def gc(self, *, max_artifacts: int) -> list[str]:
        """Prune the oldest retired/rejected artifacts until at most
        ``max_artifacts`` remain; returns the pruned ids, oldest first.
        The serving artifact, its rollback chain and live
        candidate/shadow artifacts are never pruned, whatever the
        budget."""
        if max_artifacts < 1:
            raise RegistryError(f"max_artifacts={max_artifacts} must be >= 1")
        protected: set[str] = set()
        info = self.serving_info()
        if info is not None:
            protected.add(info["artifact"])
            protected.update(h for h in info.get("history", []) if h is not None)
        manifests = self.list()
        excess = len(manifests) - int(max_artifacts)
        removed: list[str] = []
        for m in manifests:
            if excess <= 0:
                break
            aid = m["id"]
            if aid in protected or m.get("state") not in ("retired", "rejected"):
                continue
            path = os.path.join(self._artifacts, aid)
            shutil.rmtree(path, ignore_errors=True)
            if os.path.exists(path):
                # Not removed: it still counts, and is not reported pruned.
                log.warning(f"[REGISTRY] gc could not remove artifact {aid} ({path})")
                continue
            removed.append(aid)
            excess -= 1
        if removed:
            self._event("gc", removed=removed, max_artifacts=int(max_artifacts))
            log.info(
                f"[REGISTRY] gc pruned {len(removed)} retired/rejected "
                f"artifact(s) (budget {max_artifacts}): {removed}"
            )
        return removed


def _scalar_metrics(metrics: Mapping[str, Any] | None) -> dict:
    """Only scalar metrics, and only finite numeric ones: arrays (probs,
    labels) stay out of the manifest, and a NaN metric is dropped rather
    than stored as null."""
    out: dict[str, Any] = {}
    for k, v in (metrics or {}).items():
        if isinstance(v, (bool, str)):
            out[k] = v
        elif isinstance(v, (int, float, np.generic)):
            f = float(v)
            if np.isfinite(f):
                out[k] = f
    return out
