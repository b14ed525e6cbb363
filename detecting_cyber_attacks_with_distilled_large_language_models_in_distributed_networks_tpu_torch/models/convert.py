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


class HostLeaf:
    """One state tensor in the JAX layout, gathered to host numpy fp32 on
    first use (``np.asarray(leaf)``) and cached: the streamed upload's
    per-leaf gather, so leaf k+1 comes off the card while chunk k is on
    the wire. ``shape`` and ``dtype`` are the JAX layout's, known before
    the gather (what a stream header plans from). The leaf reads the
    tensor as it is at that first use: the TCP client uploads before it
    trains again, and ``adopt_aggregate`` starts a new state."""

    __slots__ = ("_t", "_transpose", "_arr", "shape", "dtype")

    def __init__(self, t: torch.Tensor, transpose: bool):
        self._t = t.detach()
        self._transpose = transpose
        self._arr: np.ndarray | None = None
        shape = tuple(int(s) for s in t.shape)
        self.shape = shape[:-2] + (shape[-1], shape[-2]) if transpose else shape
        self.dtype = np.dtype(np.float32)

    def numpy(self) -> np.ndarray:
        if self._arr is None:
            t = self._t.to(torch.float32)
            if self._transpose:
                t = t.transpose(-1, -2)
            self._arr = t.contiguous().to("cpu", copy=True).numpy()
            self._t = None  # the card's tensor is no longer referenced
        return self._arr

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a.copy() if copy else a


def params_to_jax(
    state_dict: Mapping[str, torch.Tensor], *, stacked: bool = False, lazy: bool = False
) -> dict:
    """The port's state dict -> the nested flax dict of numpy fp32 leaves
    (the inverse of :func:`params_from_jax`). Kernels are transposed
    where the tensor lies (on the card for a card's state), and every
    leaf is a host copy that never aliases the state; ``lazy`` returns
    :class:`HostLeaf` leaves, each copied when first read."""
    lead = 1 if stacked else 0
    tree: dict = {}
    for key, t in state_dict.items():
        module, _, name = key.rpartition(".")
        transpose = False
        if name == "weight":
            if t.ndim == 1 + lead:
                name = "scale"  # LayerNorm
            elif module.endswith("_embeddings"):
                name = "embedding"
            else:
                transpose, name = True, "kernel"
        elif name != "bias":
            raise ValueError(f"unknown parameter {key!r}")
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        leaf = HostLeaf(t, transpose)
        node[name] = leaf if lazy else leaf.numpy()
    return tree
