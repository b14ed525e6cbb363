"""Peaks, analytic FLOPs and byte bounds: the benchmark's yardstick.

Frozen copies, so that a change to the program cannot move the ruler:

* ``forward_flops``: the port's ``utils/profiling.py`` count of one
  classifier forward's matmul FLOPs (2·M·N·K a contraction: the Q/K/V/O
  projections, the two attention contractions, the FFN, the head);
* ``attention_bound`` and ``backward_bound``: ``chip_smoke.py``'s least
  times of K1 and of K2/K3, each input read once and each output written
  once;
* the peaks of one H100 SXM from NVIDIA's data sheet (dense bf16 tensor
  cores, HBM3).

``adam_bound`` adds the optimizer's: fp32 params, grads, ``mu`` and
``nu`` read once and params, ``mu`` and ``nu`` written once, for every
trainable element.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

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


def forward_flops(cfg: dict, batch: int, seq_len: int) -> float:
    """Matmul FLOPs of one classifier forward over ``[batch, seq_len]``;
    ``cfg`` holds ``dim``, ``hidden_dim``, ``n_layers`` and ``n_classes``."""
    L, D, F = seq_len, cfg["dim"], cfg["hidden_dim"]
    per_layer = 8 * L * D * D + 4 * L * L * D + 4 * L * D * F
    return float(batch) * (cfg["n_layers"] * per_layer + 2 * D * cfg["n_classes"])


def train_step_flops(cfg: dict, batch: int, seq_len: int) -> float:
    """Forward + backward: 3× the forward's."""
    return 3.0 * forward_flops(cfg, batch, seq_len)


def _least(nbytes: float, flops: float) -> float:
    """Least seconds for the work at the card's peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def attention_bound(b: int, h: int, l: int, d: int, elsize: int = 2) -> float:
    """Least seconds of one K1 launch: q, k, v, O, lse and the key bias."""
    nbytes = 4 * b * h * l * d * elsize + b * h * l * 4 + b * l * 4
    return _least(nbytes, 4 * b * h * l * l * d)


def backward_bound(b: int, h: int, l: int, d: int, kernel: str, elsize: int = 2) -> float:
    """Least seconds of one K2 (``"dkdv"``) or K3 (``"dq"``) launch."""
    rows = b * h * l
    tile = rows * d * elsize
    nbytes = 4 * tile + rows * 4 + b * l * 4  # q, k, v, dO, lse, key bias
    if kernel == "dkdv":  # delta in; dk, dv and the per-head dbias rows out
        nbytes += rows * 4 + 2 * tile + rows * 4
        flops = 4 * 2 * b * h * l * l * d
    elif kernel == "dq":  # O in; dq and delta out
        nbytes += 2 * tile + rows * 4
        flops = 3 * 2 * b * h * l * l * d
    else:
        raise ValueError(f"unknown backward kernel {kernel!r}")
    return _least(nbytes, flops)


def adam_bound(n_elements: int) -> float:
    """Least seconds of one Adam update over ``n_elements`` fp32 leaves."""
    return 7 * 4 * n_elements / HBM_BYTES_PER_S


def n_params(cfg: dict) -> int:
    """Elements of the classifier's leaves (all trainable)."""
    D, F, V, P, C = cfg["dim"], cfg["hidden_dim"], cfg["vocab_size"], cfg["max_position_embeddings"], cfg["n_classes"]
    embed = V * D + P * D + 2 * D
    layer = 4 * (D * D + D) + (D * F + F) + (F * D + D) + 4 * D
    return embed + cfg["n_layers"] * layer + D * C + C
