"""The read half of the JAX package's model registry.

Layout under the registry root (written by the JAX package's
``ModelRegistry``; this module only reads it)::

    artifacts/<id>/params.npz     flat fp32 params ('/'-joined keys)
    artifacts/<id>/manifest.json  round lineage, state, eval metrics,
                                  model config
    serving.json                  the serving pointer (atomic os.replace)

Every file here is swapped in atomically by the writer, so each read sees
the old state or the new one, never a torn write. With it an artifact
the JAX control plane promoted serves on the port as it is.
"""

from __future__ import annotations

import json
import os

import numpy as np

_POINTER = "serving.json"


class RegistryError(ValueError):
    """Unknown artifact or a corrupt store."""


class ModelRegistry:
    """Read-only view of a registry root."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._artifacts = os.path.join(self.root, "artifacts")

    def manifest(self, aid: str) -> dict:
        path = os.path.join(self._artifacts, aid, "manifest.json")
        try:
            with open(path) as f:
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

    def serving_info(self) -> dict | None:
        """The serving pointer's content (None before any promotion)."""
        try:
            with open(os.path.join(self.root, _POINTER)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError) as e:
            raise RegistryError(f"corrupt serving pointer: {e}") from None
