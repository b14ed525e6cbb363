"""Carry weights between the JAX parameter tree and the port's state dict.

The JAX package keeps its params as a nested flax dict
(``encoder/layer_0/attn/q/kernel``), and the registry stores the same
tree flattened with '/'-joined keys (``params.npz``). The port's modules
carry the same names, so a key maps by path alone:

* ``a/b/kernel`` ``[in, out]``  <->  ``a.b.weight`` ``[out, in]`` (transposed)
* ``a/b/embedding``             <->  ``a.b.weight`` (embedding tables)
* ``a/b/scale``                 <->  ``a.b.weight`` (LayerNorm)
* ``a/b/bias``                  <->  ``a.b.bias``

Every leaf converts exactly (a transpose or a copy), so a round trip
returns the same bits.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Nested dict -> flat dict with '/'-joined keys (the registry's form)."""
    out: dict[str, Any] = {}
    for key, node in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(node, Mapping):
            out.update(flatten_tree(node, path))
        else:
            out[path] = node
    return out


def params_from_jax(tree_or_flat: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX params (nested flax dict or its '/'-joined flat form, numpy
    leaves) -> the port's fp32 state dict."""
    flat = flatten_tree(tree_or_flat)
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        module, _, name = path.rpartition("/")
        arr = np.asarray(leaf, np.float32)
        if name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{path}: kernel must be 2-D, got {arr.shape}")
            arr, name = arr.T, "weight"
        elif name in ("embedding", "scale"):
            name = "weight"
        elif name != "bias":
            raise ValueError(f"unknown parameter leaf {path!r}")
        sd[f"{module.replace('/', '.')}.{name}"] = torch.tensor(arr)  # a copy
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state dict -> the nested flax dict of numpy fp32 leaves
    (the inverse of :func:`params_from_jax`)."""
    tree: dict = {}
    for key, t in state_dict.items():
        module, _, name = key.rpartition(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            if arr.ndim == 1:
                name = "scale"  # LayerNorm
            elif module.endswith("_embeddings"):
                name = "embedding"
            else:
                arr, name = arr.T, "kernel"
        elif name != "bias":
            raise ValueError(f"unknown parameter {key!r}")
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree
