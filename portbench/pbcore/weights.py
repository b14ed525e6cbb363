"""Classifier weights made on the device from the seed.

The benchmark makes the weights and hands the same to the program and to
the plain reference. The cell's family (``reference/<name>.py``) names
every leaf by the program's state-dict key, gives its shape, and says how
it starts: ``normal`` leaves are ``normal(0, initializer_range)`` from one
``torch.Generator`` on the device, in one draw over all of them in sorted
key order; ``zero`` and ``one`` leaves are constant. All in fp32, the type
the program keeps its parameters in; the program's loader checks the keys
strictly.
"""

from __future__ import annotations

from types import ModuleType

import torch

KINDS = ("normal", "zero", "one")


def make_weights(family: ModuleType, cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 leaves of ``family``'s model on ``device``, in its key order:
    the normal ones are views of one draw."""
    shapes = family.leaf_shapes(cfg)
    kinds = {k: family.leaf_kind(k) for k in shapes}
    odd = sorted(k for k, kind in kinds.items() if kind not in KINDS)
    if odd:
        raise ValueError(f"leaves of no known kind ({', '.join(KINDS)}): {odd[:5]}")
    normal = sorted(k for k in shapes if kinds[k] == "normal")
    sizes = [torch.Size(shapes[k]).numel() for k in normal]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, cfg["initializer_range"], generator=gen)
    out = {k: t.view(shapes[k]) for k, t in zip(normal, flat.split(sizes))}
    for k, shape in shapes.items():
        if kinds[k] == "zero":
            out[k] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif kinds[k] == "one":
            out[k] = torch.ones(shape, dtype=torch.float32, device=device)
    return {k: out[k] for k in shapes}
