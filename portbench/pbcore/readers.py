"""Reductions shared by the per-layer readers under ``portbench/metrics/``.

Each reader reads one traced run's :class:`~pbcore.tracing.Timeline` and
returns a number, or None where the run holds nothing to read: another
mode's run, no launch of the kernel, a card whose peak the table lacks, a
family whose model runs no K1-K3. A share is in percent.

The work a share divides by (FLOPs, trainable elements, the attention
launch) is the family's that the driver names in ``extra["reference"]``
(``extra["bench"]`` the directory its module is in), DistilBERT's where
the timeline names none.
"""

from __future__ import annotations

from . import bench, roofline


def family(tl):
    """The family module of the traced run's model."""
    return bench.load_family(tl.extra.get("reference", bench.DEFAULT_FAMILY), tl.extra.get("bench", bench.BENCH_DIR))


def _ours(tl, mode: str) -> bool:
    return tl is not None and tl.extra.get("mode") == mode


def mfu(tl, mode: str) -> float | None:
    """The whole step's share of the card's dense bf16 peak over the
    window's untraced part: analytic FLOPs of each step or call times
    their count, over the seconds, over the peak."""
    if not _ours(tl, mode) or not tl.extra.get("plain_steps"):
        return None
    peak = roofline.peak_flops(tl.extra["device_name"])
    if peak is None:
        return None
    cfg, b, l = tl.extra["cfg"], tl.extra["batch"], tl.extra["seq_len"]
    per = family(tl).forward_flops(cfg, b, l)
    if mode == "train":
        per = roofline.train_step_flops(per)
    return 100.0 * per * tl.extra["plain_steps"] / (tl.extra["plain_s"] * peak)


def kernel_roofline(tl, mode: str, fragment: str, kernel: str) -> float | None:
    """Least time of one launch at the family's launch shape over the
    kernel's mean device time a launch in the trace. ``kernel``: ``fwd``,
    ``dkdv`` or ``dq``."""
    if not _ours(tl, mode):
        return None
    seconds, launches = tl.kernel(fragment)
    if launches == 0 or seconds <= 0:
        return None
    launch = family(tl).attention_launch(tl.extra["cfg"], tl.extra["batch"], tl.extra["seq_len"])
    if launch is None:
        return None
    b, h, h_kv, l, d, causal = launch
    if kernel == "fwd":
        bound = roofline.attention_bound(b, h, l, d, kv_heads=h_kv, causal=causal)
    else:
        bound = roofline.backward_bound(b, h, l, d, kernel, kv_heads=h_kv, causal=causal)
    return 100.0 * bound / (seconds / launches)


def adam_roofline(tl) -> float | None:
    """The optimizer's byte bound over its kernels' device time a step."""
    if not _ours(tl, "train") or not tl.extra.get("traced_steps"):
        return None
    seconds = tl.categories().get("optimizer", 0.0)
    if seconds <= 0:
        return None
    per_step = seconds / tl.extra["traced_steps"]
    return 100.0 * roofline.adam_bound(family(tl).n_trainable(tl.extra["cfg"])) / per_step


def device_idle(tl, mode: str) -> float | None:
    """The share of an untraced step in which no device operation runs:
    one less the device's busy seconds a step (or call) in the trace over
    the wall seconds a step in the window's untraced part. The traced
    window's own idle share (``device.busy_s`` over ``window_s``) also
    holds the profiler's host work a step."""
    if not _ours(tl, mode) or not tl.device or not tl.extra.get("traced_steps") or not tl.extra.get("plain_steps"):
        return None
    busy = tl.busy_s / tl.extra["traced_steps"]
    wall = tl.extra["plain_s"] / tl.extra["plain_steps"]
    return 100.0 * (1.0 - busy / wall)
