"""Profiling: analytic FLOPs, MFU accounting and ``torch.profiler`` traces
(the port of the JAX package's ``utils/profiling.py``).

The model's step cost is computed analytically from the config (the same
formulas as the JAX package), so any timed step yields MFU against the
card's peak. The peak table is NVIDIA's H100 data sheet, keyed on
``torch.cuda.get_device_name()``; ``trace`` wraps ``torch.profiler`` and
writes a Chrome trace of the CPU and CUDA activity.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

from ..config import ModelConfig

#: Peak dense bf16 tensor-core TFLOP/s of one card (NVIDIA's H100 data
#: sheet, dense rates, without sparsity), matched as substrings of
#: ``torch.cuda.get_device_name()``; the first match wins, so the more
#: specific names come first. "H100 80GB HBM3" is torch's name for the
#: SXM part.
GPU_PEAK_TFLOPS: tuple[tuple[str, float], ...] = (
    ("H100 80GB HBM3", 989.0),
    ("H100 SXM", 989.0),
    ("H100 NVL", 835.0),
    ("H100 PCIe", 756.0),
)


def forward_flops(
    cfg: ModelConfig, batch_size: int, seq_len: int | None = None
) -> float:
    """Analytic matmul FLOPs of one classifier forward pass.

    Counts every dense contraction (2·M·N·K per matmul): per transformer
    layer the Q/K/V/output projections (8·L·D²), the attention score and
    value contractions (4·L²·D), and the two FFN matmuls (4·L·D·F); plus the
    CLS head (2·D·C). Embedding gathers, layernorms, softmaxes, and biases
    are O(L·D) — negligible against the D² terms and excluded, which also
    matches how XLA's own cost model attributes transformer step cost.
    """
    L = seq_len if seq_len is not None else cfg.max_len
    D, F = cfg.dim, cfg.hidden_dim
    per_layer = 8 * L * D * D + 4 * L * L * D + 4 * L * D * F
    head = 2 * D * cfg.n_classes
    return float(batch_size) * (cfg.n_layers * per_layer + head)


def train_step_flops(
    cfg: ModelConfig, batch_size: int, seq_len: int | None = None
) -> float:
    """Forward + backward ≈ 3× forward (the backward pass contracts twice
    per forward matmul: grads w.r.t. activations and w.r.t. weights)."""
    return 3.0 * forward_flops(cfg, batch_size, seq_len)


def peak_tflops(device_name: str) -> float | None:
    """The table's dense bf16 TFLOP/s for a device name, None when unknown."""
    for key, tflops in GPU_PEAK_TFLOPS:
        if key in device_name:
            return tflops
    return None


def device_peak_flops(device=None) -> float | None:
    """Peak dense bf16 FLOP/s of one card, or None when unknown (a card
    the table does not name, the CPU, or no CUDA at all).

    ``device`` defaults to the current CUDA device."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    tflops = peak_tflops(torch.cuda.get_device_name(device))
    return tflops * 1e12 if tflops is not None else None


def mfu(
    flops_per_step: float,
    step_time_s: float,
    n_devices: int = 1,
    peak_flops_per_device: float | None = None,
) -> float | None:
    """Model FLOPs utilization in [0, 1], or None when the peak is unknown."""
    if peak_flops_per_device is None:
        peak_flops_per_device = device_peak_flops()
    if peak_flops_per_device is None or step_time_s <= 0:
        return None
    return flops_per_step / (step_time_s * peak_flops_per_device * n_devices)


@contextlib.contextmanager
def trace(log_dir: str | None) -> Iterator[None]:
    """``torch.profiler`` over the block, gated on ``log_dir`` — pass None
    for a no-op, so call sites need no branching (the CLI's --profile-dir
    plumbs here). Records CPU activity, and CUDA activity when CUDA is
    available, and writes one Chrome trace into ``log_dir``
    (``trace-<pid>-<ms>.json``: open it in ui.perfetto.dev or
    chrome://tracing)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
