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
returns the same bits. The ``stacked`` forms carry a leading clients
axis ``[C, ...]`` on every leaf (the federated trainers' layout) and
transpose the last two axes of a kernel.
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


def params_from_jax(tree_or_flat: Mapping[str, Any], *, stacked: bool = False) -> dict[str, torch.Tensor]:
    """JAX params (nested flax dict or its '/'-joined flat form, numpy
    leaves) -> the port's fp32 state dict; ``stacked``: every leaf has a
    leading clients axis."""
    flat = flatten_tree(tree_or_flat)
    lead = 1 if stacked else 0
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        module, _, name = path.rpartition("/")
        arr = np.asarray(leaf, np.float32)
        if name == "kernel":
            if arr.ndim != 2 + lead:
                raise ValueError(f"{path}: kernel must be {2 + lead}-D, got {arr.shape}")
            arr, name = np.swapaxes(arr, -1, -2), "weight"
        elif name in ("embedding", "scale"):
            name = "weight"
        elif name != "bias":
            raise ValueError(f"unknown parameter leaf {path!r}")
        sd[f"{module.replace('/', '.')}.{name}"] = torch.tensor(arr)  # a copy
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor], *, stacked: bool = False) -> dict:
    """The port's state dict -> the nested flax dict of numpy fp32 leaves
    (the inverse of :func:`params_from_jax`). Kernels are transposed
    where the tensor lies (on the card for a card's state), and every
    leaf is a host copy that never aliases the state."""
    lead = 1 if stacked else 0
    tree: dict = {}
    for key, t in state_dict.items():
        module, _, name = key.rpartition(".")
        t = t.detach().to(torch.float32)
        if name == "weight":
            if t.ndim == 1 + lead:
                name = "scale"  # LayerNorm
            elif module.endswith("_embeddings"):
                name = "embedding"
            else:
                t, name = t.transpose(-1, -2), "kernel"
        elif name != "bias":
            raise ValueError(f"unknown parameter {key!r}")
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[name] = t.contiguous().to("cpu", copy=True).numpy()
    return tree
