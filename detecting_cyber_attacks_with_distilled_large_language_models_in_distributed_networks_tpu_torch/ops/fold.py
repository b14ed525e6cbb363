"""The server's ordered weighted fold: a hand-written Hopper kernel (K4)
and its plain version.

Port of the JAX package's ``ops/fold.py``. ``comm/stream_agg.py`` folds
one parameter leaf's K client copies into the round's mean as
``acc = zeros; acc += float32(w_k) * leaf_k`` over clients in ascending
id order: the exact fp32 arithmetic every crc replay of a round pins.

* :func:`fold_reference` is that loop in PyTorch (the JAX ``fold_naive``):
  the CPU path, and what the tests and ``chip_smoke.py`` hold the kernel
  against. Each multiply and add is its own operation, rounded on its own,
  on the CPU and on the card alike.
* :func:`fold_stacked` launches K4 (``csrc/fold.cu``) on a CUDA tensor and
  runs :func:`fold_reference` on a CPU tensor; nothing else.
* :func:`fold_ordered` is the aggregator's entry: host numpy fp32 leaves
  in (the wire's form), host numpy fp32 out, on the server's device.

There is one engine per device and no override: the card folds with K4
and ``device="cpu"`` with the plain version. A kernel that fails to build
or launch raises; the aggregator turns that into a failed round with the
reason attached. Nothing demotes to another engine.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device

#: Launches of K4 in this process (one per launch, counted by its
#: wrapper). Read and reset by callers that check the main path ran it.
FOLD_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_FN = None


def engine_name(device: str | torch.device) -> str:
    """What folds on ``device``: ``"cuda"`` (K4) or ``"reference"``."""
    return "cuda" if torch.device(device).type == "cuda" else "reference"


def _weights(weights, device) -> torch.Tensor:
    return torch.tensor(
        np.asarray([np.float32(w) for w in weights], np.float32), device=device
    )


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over the fp32 array (copied only if it is read-only)."""
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def fold_reference(
    leaves: Sequence[torch.Tensor], weights: Sequence[float] | torch.Tensor
) -> torch.Tensor:
    """``acc = 0; acc += float32(w_k) * leaf_k`` for k in the given order,
    in fp32 (the JAX ``fold_naive``). Each ``w_k`` is a 0-dim fp32 tensor,
    so every product is an fp32 multiply of fp32 operands, rounded before
    the add."""
    w = weights if isinstance(weights, torch.Tensor) else _weights(weights, leaves[0].device)
    acc = torch.zeros(leaves[0].shape, dtype=torch.float32, device=leaves[0].device)
    for k, x in enumerate(leaves):
        acc += w[k].to(acc.device) * x.to(torch.float32)
    return acc


def _kernel_fn():
    global _FN
    if _FN is None:
        from ._build import load

        fn = load("fold").fold_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int,  # K
            ctypes.c_longlong,  # n
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def fold_stacked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fold the rows of ``x`` (fp32 ``[K, n]``, row k the k-th leaf in
    fold order) with weights ``w`` (fp32 ``[K]``) -> fp32 ``[n]``: K4 on a
    CUDA tensor, :func:`fold_reference` on a CPU tensor."""
    global FOLD_LAUNCHES
    if x.ndim != 2 or w.shape != (x.shape[0],) or x.shape[0] < 1:
        raise ValueError(f"want x [K, n] and w [K], got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"the fold takes fp32, got {x.dtype} and {w.dtype}")
    if x.device.type == "cpu":
        return fold_reference(list(x), w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x and w must lie on one CUDA device, got {x.device} and {w.device}")
    k, n = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel's float4 rows need a 16-byte aligned base
    w = w.contiguous()
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), k, n,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fold kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        FOLD_LAUNCHES += 1
    return out


def fold_ordered(
    leaves: Sequence[np.ndarray],
    weights: Sequence[np.float32],
    *,
    device: str | torch.device,
    times: dict[str, float] | None = None,
) -> np.ndarray:
    """Weighted sum of same-shape fp32 host ``leaves`` in their given
    order, folded on ``device`` (K4 on ``cuda``, :func:`fold_reference` on
    ``cpu``); returns host numpy fp32 of the leaves' shape.

    On the card each leaf is copied into its row of one ``[K, n]`` buffer
    and the result copied back. ``times``, when given, accumulates CUDA
    event milliseconds under ``h2d_ms`` (the leaves' and weights' copies),
    ``kernel_ms`` (from the copies' end to the kernel's end, so the
    wrapper's host time before the launch is in it) and ``d2h_ms``."""
    if not leaves:
        raise ValueError("fold_ordered needs at least one leaf")
    dev = resolve_device(device)
    shape = np.asarray(leaves[0]).shape
    flat = [np.ascontiguousarray(a, np.float32).reshape(-1) for a in leaves]
    if any(a.size != flat[0].size for a in flat):
        raise ValueError("fold_ordered leaves differ in size")
    if dev.type == "cpu":
        out = fold_reference([_host_tensor(a) for a in flat], weights)
        return out.numpy().reshape(shape)
    with torch.cuda.device(dev):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        x = torch.empty((len(flat), flat[0].size), dtype=torch.float32, device=dev)
        for row, a in zip(x, flat):
            row.copy_(_host_tensor(a))
        w = _weights(weights, dev)
        ev[1].record()
        acc = fold_stacked(x, w)
        ev[2].record()
        out = acc.cpu().numpy()
        ev[3].record()
        ev[3].synchronize()
    if times is not None:
        for key, a, b in (("h2d_ms", 0, 1), ("kernel_ms", 1, 2), ("d2h_ms", 2, 3)):
            times[key] = times.get(key, 0.0) + ev[a].elapsed_time(ev[b])
    return out.reshape(shape)
