"""Classifier weights made on the device from the seed.

The benchmark makes the weights and hands the same to the program and to
the plain reference. Keys follow the port's state-dict layout (``nn.Linear``
weights ``[out, in]``); the program's loader checks them strictly.
Matrices and embeddings are ``normal(0, initializer_range)`` from one
``torch.Generator`` on the device, in one draw over all of them, biases
zero, LayerNorm scale one and shift zero: the port's initialization, in
fp32, the type the program keeps its parameters in.
"""

from __future__ import annotations

import torch


def leaf_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every leaf of the classifier, by state-dict key."""
    D, F = cfg["dim"], cfg["hidden_dim"]
    shapes: dict[str, tuple[int, ...]] = {
        "encoder.embeddings.word_embeddings.weight": (cfg["vocab_size"], D),
        "encoder.embeddings.position_embeddings.weight": (cfg["max_position_embeddings"], D),
        "encoder.embeddings.ln.weight": (D,),
        "encoder.embeddings.ln.bias": (D,),
    }
    for i in range(cfg["n_layers"]):
        p = f"encoder.layer_{i}."
        for name in ("q", "k", "v", "o"):
            shapes[f"{p}attn.{name}.weight"] = (D, D)
            shapes[f"{p}attn.{name}.bias"] = (D,)
        shapes[f"{p}sa_ln.weight"] = (D,)
        shapes[f"{p}sa_ln.bias"] = (D,)
        shapes[f"{p}lin1.weight"] = (F, D)
        shapes[f"{p}lin1.bias"] = (F,)
        shapes[f"{p}lin2.weight"] = (D, F)
        shapes[f"{p}lin2.bias"] = (D,)
        shapes[f"{p}out_ln.weight"] = (D,)
        shapes[f"{p}out_ln.bias"] = (D,)
    shapes["classifier.weight"] = (cfg["n_classes"], D)
    shapes["classifier.bias"] = (cfg["n_classes"],)
    return shapes


def _kind(name: str) -> str:
    if name.endswith(".bias"):
        return "zero"
    if name.rsplit(".", 2)[-2].endswith("ln"):
        return "one"
    return "normal"


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 leaves on ``device``: the normal ones are views of one draw."""
    shapes = leaf_shapes(cfg)
    normal = sorted(k for k in shapes if _kind(k) == "normal")
    sizes = [torch.Size(shapes[k]).numel() for k in normal]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, cfg["initializer_range"], generator=gen)
    out = {k: t.view(shapes[k]) for k, t in zip(normal, flat.split(sizes))}
    for k, shape in shapes.items():
        kind = _kind(k)
        if kind == "zero":
            out[k] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif kind == "one":
            out[k] = torch.ones(shape, dtype=torch.float32, device=device)
    return {k: out[k] for k in shapes}
