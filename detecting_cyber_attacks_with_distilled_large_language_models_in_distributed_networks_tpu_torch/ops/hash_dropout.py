"""Coordinate-keyed dropout for sequence-split forwards (the port of the
JAX package's ``ops/hash_dropout.py``).

``torch.rand`` fills a mask in the order of the local tensor, so the same
generator gives other masks when the sequence is split over more slots:
a run at seq 2 would train another trajectory than the same run at seq 1.
Here the keep bit of every element is a hash of two uint32 seed words and
the element's coordinates, each offset to its GLOBAL index: a chunk at
position offset ``k`` hashes positions ``[k, k + L_local)`` and gets
exactly the slice of the mask the unsplit forward computes there, at any
split.

The construction is the JAX package's, bit for bit: every axis ``i``
multiplies its index by its own odd constant ``_AXIS_CONSTS[i]`` and the
products are XORed together, then ``s0`` is XORed in and ``s1 *
0x632BE59B`` added, then the murmur3 finalizer. Only that finalizer is
shared with the flash kernels' mask (``csrc/keep_mask.cuh``), which mixes
(q, k, b, h) another way: the two streams differ in bits.

Plain torch, as the JAX version is plain XLA. The uint32 arithmetic runs
in int64 masked back to 32 bits after each step, on the CPU and the card
alike (torch's ``uint32`` lacks ``>>``, ``+`` and ``>=`` on the CPU).
The seed words come from an explicit generator
(:func:`.flash_attention.draw_seed_words`), as ``jax.random.bits`` draws
them from a key in the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .flash_attention import _M32, _mul32, keep_threshold

# One odd mixing constant per coordinate axis (murmur/xxhash-style).
_AXIS_CONSTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)


def _seed_pair(seed_words, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The two seed words as int64 scalars on ``device`` (uint32 values);
    a tensor stays on the device (no host read)."""
    if isinstance(seed_words, torch.Tensor):
        w = seed_words.to(device=device, dtype=torch.int64).reshape(-1)
    else:
        w = torch.as_tensor(np.asarray(seed_words, np.int64).reshape(-1), device=device)
    w = w & _M32
    return w[0], w[1]


def hash_keep_mask(
    seed_words,
    shape: Sequence[int],
    rate: float,
    *,
    offsets: Mapping[int, int] | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """fp32 0/1 keep mask of ``shape``: element ``(i0, i1, ...)`` keeps iff
    the murmur-finalized hash of the seed and ``(i0 + off0, i1 + off1,
    ...)`` is at least ``round(rate * 2^32)``. ``offsets`` maps an axis to
    this chunk's global start along it. ``seed_words``: two uint32 values
    (a tensor, e.g. from ``draw_seed_words``, or a sequence of ints). The
    mask lands on ``device``, else on the seed tensor's device, else the
    CPU."""
    shape = tuple(int(d) for d in shape)
    if len(shape) > len(_AXIS_CONSTS):
        raise ValueError(f"hash_keep_mask supports rank <= {len(_AXIS_CONSTS)}")
    if device is None:
        device = seed_words.device if isinstance(seed_words, torch.Tensor) else torch.device("cpu")
    device = torch.device(device)
    offsets = offsets or {}
    x = torch.zeros((1,) * len(shape), dtype=torch.int64, device=device)
    for axis, n in enumerate(shape):
        view = [1] * len(shape)
        view[axis] = n
        idx = (torch.arange(n, dtype=torch.int64, device=device) + int(offsets.get(axis, 0))) & _M32
        # Each coordinate mixed with its own odd constant; the XOR keeps
        # the combination bijective per axis before the finalizer.
        x = x ^ _mul32(idx.reshape(view), _AXIS_CONSTS[axis])
    x = x.expand(shape)
    s0, s1 = _seed_pair(seed_words, device)
    x = x ^ s0
    x = (x + _mul32(s1, 0x632BE59B)) & _M32
    # The murmur3 finalizer (the flash kernels' too).
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >= keep_threshold(rate)).to(torch.float32)


def hash_dropout(
    x: torch.Tensor,
    rate: float,
    seed_words,
    *,
    offsets: Mapping[int, int] | None = None,
    deterministic: bool = False,
) -> torch.Tensor:
    """Inverted dropout with a coordinate-keyed mask: ``x * keep / (1 -
    rate)``, the divisor in x's dtype (as the JAX version divides).

    ``offsets`` maps each split axis of ``x`` to this chunk's global start
    along it: the position axis and the batch axis (rows on different data
    slots must not reuse one mask). Every chunk of one forward takes the
    same seed words."""
    if deterministic or rate == 0.0:
        return x
    keep = hash_keep_mask(seed_words, x.shape, rate, offsets=offsets, device=x.device)
    return (x * keep.to(x.dtype)) / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
