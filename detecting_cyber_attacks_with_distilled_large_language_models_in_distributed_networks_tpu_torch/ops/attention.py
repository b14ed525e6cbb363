"""Attention ops (the port of the JAX package's ``ops/attention.py``).

* ``dot``   — plain PyTorch attention: fp32 scores and softmax, weights
              cast back to the activation dtype before ``@ v``.
* ``flash`` — the hand-written kernels in :mod:`.flash_attention`.

Both take ``[B, H, L, D]`` tensors and an additive key bias.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e9  # large-negative mask addend; safe in fp32 softmax


def make_attention_bias(
    attention_mask: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """``[B, L]`` 0/1 mask -> additive ``[B, 1, 1, L]`` bias (0 keep, -1e9 drop)."""
    bias = (1.0 - attention_mask.to(dtype)) * NEG_INF
    return bias[:, None, None, :]


def dot_product_attention(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, H, Lk, D]
    v: torch.Tensor,  # [B, H, Lk, D]
    bias: torch.Tensor | None = None,  # additive, broadcastable to [B, H, Lq, Lk]
    *,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Scaled dot-product attention with fp32 scores and softmax.

    Products of bf16 inputs are exact in fp32, so ``q.float() @ k.float()ᵀ``
    is the JAX path's bf16 einsum with fp32 accumulation. The output
    returns to q's dtype. With ``dropout_rate`` > 0 and not
    ``deterministic``, the weights (after the cast back to q's dtype) are
    multiplied by a keep mask drawn from ``generator`` and by
    ``1 / (1 - rate)``, as the JAX dot path does: the same distribution,
    not the same bits."""
    depth = q.shape[-1]
    # The scale in fp32, as the JAX path computes it (1/sqrt of an fp32).
    scale = float(np.float32(1.0) / np.sqrt(np.float32(depth)))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and not deterministic:
        if generator is None:
            raise ValueError("attention dropout needs a generator")
        keep = torch.rand(
            weights.shape, generator=generator, device=weights.device
        ) < (1.0 - dropout_rate)
        weights = weights * keep.to(q.dtype) * (1.0 / (1.0 - dropout_rate))
    return torch.matmul(weights, v)
