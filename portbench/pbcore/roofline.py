"""Peaks and byte bounds: the benchmark's yardstick.

Frozen copies, so that a change to the program cannot move the ruler:

* ``attention_bound`` and ``backward_bound``: ``chip_smoke.py``'s least
  times of K1 and of K2/K3, each input read once and each output written
  once, widened to a launch whose keys and values have fewer heads than
  its queries (grouped KV) and to a causal mask, which keeps
  ``L(L+1)/2`` of a head's ``L²`` scores;
* the peaks of one H100 SXM from NVIDIA's data sheet (dense bf16 tensor
  cores, HBM3).

``adam_bound`` adds the optimizer's: fp32 params, grads, ``mu`` and
``nu`` read once and params, ``mu`` and ``nu`` written once, for every
trainable element. A model's FLOPs, its trainable elements and its
attention launch are its family's (``reference/<name>.py``).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
BF16_BYTES = 2

#: Dense bf16 tensor-core peak of a card, matched as a substring of
#: ``torch.cuda.get_device_name()``; "H100 80GB HBM3" is the SXM part.
PEAK_BF16_FLOPS = (
    ("H100 80GB HBM3", 989e12),
    ("H100 SXM", 989e12),
    ("H100 NVL", 835e12),
    ("H100 PCIe", 756e12),
)


def peak_flops(device_name: str) -> float | None:
    for key, flops in PEAK_BF16_FLOPS:
        if key in device_name:
            return flops
    return None


def train_step_flops(forward_flops: float) -> float:
    """A training step's FLOPs from its forward's: forward + backward, 3×."""
    return 3.0 * forward_flops


def _least(nbytes: float, flops: float) -> float:
    """Least seconds for the work at the card's peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def _scores(b: int, h: int, l: int, causal: bool) -> int:
    """Score entries a launch computes: every query against every key, or
    under a causal mask each query against the keys up to it."""
    return b * h * (l * (l + 1) // 2 if causal else l * l)


def attention_bound(b: int, h: int, l: int, d: int, kv_heads: int | None = None, causal: bool = False) -> float:
    """Least seconds of one K1 launch: q and O at the ``h`` query heads,
    k and v at the ``kv_heads`` (default ``h``), lse and the key bias."""
    hk = h if kv_heads is None else kv_heads
    nbytes = 2 * b * h * l * d * BF16_BYTES + 2 * b * hk * l * d * BF16_BYTES + b * h * l * 4 + b * l * 4
    return _least(nbytes, 4 * _scores(b, h, l, causal) * d)


def backward_bound(b: int, h: int, l: int, d: int, kernel: str, kv_heads: int | None = None,
                   causal: bool = False) -> float:
    """Least seconds of one K2 (``"dkdv"``) or K3 (``"dq"``) launch: k, v,
    dk and dv at the ``kv_heads`` (default ``h``), the rest at the query
    heads."""
    hk = h if kv_heads is None else kv_heads
    rows = b * h * l
    tile = rows * d * BF16_BYTES
    kv_tile = b * hk * l * d * BF16_BYTES
    nbytes = 2 * tile + 2 * kv_tile + rows * 4 + b * l * 4  # q, dO; k, v; lse, key bias
    if kernel == "dkdv":  # delta in; dk, dv and the per-head dbias rows out
        nbytes += rows * 4 + 2 * kv_tile + rows * 4
        flops = 4 * 2 * _scores(b, h, l, causal) * d
    elif kernel == "dq":  # O in; dq and delta out
        nbytes += 2 * tile + rows * 4
        flops = 3 * 2 * _scores(b, h, l, causal) * d
    else:
        raise ValueError(f"unknown backward kernel {kernel!r}")
    return _least(nbytes, flops)


def adam_bound(n_elements: int) -> float:
    """Least seconds of one Adam update over ``n_elements`` fp32 leaves."""
    return 7 * 4 * n_elements / HBM_BYTES_PER_S
