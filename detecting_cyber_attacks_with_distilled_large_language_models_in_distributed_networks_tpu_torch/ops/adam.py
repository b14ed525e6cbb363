"""Adam's update over a step's leaves: a hand-written multi-tensor kernel
and its plain version.

The update is optax's ``clip_by_global_norm -> scale_by_adam -> (AdamW
decay) -> scale(-lr) -> (warmup)`` chain, in its order of operations, in
place on the params and both moments (call under ``no_grad``). The
engine (``train/engine.py:adam_update``) works out the step's scalars,
:class:`AdamStep`, and calls :func:`adam`.

* :func:`adam_reference` is the chain as ``torch._foreach_*`` passes: the
  CPU path, and what the card tests hold the kernel to.
* :func:`adam_multi_tensor` launches ``csrc/adam.cu``: one pass over
  every leaf, reading p, g, mu and nu once and writing p, mu and nu once,
  each fp32 operation rounded as the chain's foreach op rounds it, so the
  two agree bit for bit.
* :func:`adam` takes the kernel for leaves on one CUDA device and the
  plain version for leaves on the CPU. A CUDA list that mixes devices or
  holds a non-contiguous or non-fp32 leaf raises ``ValueError`` and
  launches nothing; nothing falls back.

The kernel's leaf table travels in its parameter space (:class:`AdamArgs`,
a ctypes mirror of the C struct), so a step costs one launch per
:data:`MAX_LEAVES` leaves, no host sync and no copy to the card. How a
leaf is walked is decided here, in Python that the CPU tests reach
(:func:`kernel_leaves`, :func:`launch_spans`): a leaf whose four pointers
are 16-byte aligned goes as float4 (its ragged tail as scalars), any
other leaf as scalars throughout. The port's leaves are allocations of
their own, so aligned; a stacked federated row is misaligned only where
its leaf's size is not a multiple of 4.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch

#: Launches of the Adam kernel in this process (one per launch, counted by
#: its wrapper). Read and reset by callers that check the main path ran it.
ADAM_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

#: Leaves a launch's table holds (``kMaxLeaves`` in csrc/adam.cu).
MAX_LEAVES = 512
#: Elements a block updates per chunk (``kChunk`` in csrc/adam.cu).
CHUNK = 4096

_FN = None


class AdamStep(NamedTuple):
    """One step's scalars, as Python floats, in the chain's terms."""

    b1: float
    b2: float
    eps: float
    learning_rate: float
    bc1: float  # 1 - b1**count and 1 - b2**count (the bias corrections)
    bc2: float
    weight_decay: float = 0.0  # AdamW's decay; 0 leaves the term out
    warmup: float | None = None  # the warmup factor; None: no warmup
    max_norm: float | None = None  # clip_by_global_norm's max; None: no clip


def adam_reference(
    step: AdamStep,
    params: list[torch.Tensor],
    mus: list[torch.Tensor],
    nus: list[torch.Tensor],
    grads: list[torch.Tensor],
    g_norm: torch.Tensor | None = None,
) -> None:
    """The chain as ``torch._foreach_*`` passes, in place. ``g_norm`` (the
    clip's global norm) is required when ``step.max_norm`` is set."""
    if step.max_norm is not None:
        keep = g_norm < step.max_norm
        grads = [torch.where(keep, g, (g / g_norm) * step.max_norm) for g in grads]
    torch._foreach_mul_(mus, step.b1)
    torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - step.b1))
    torch._foreach_mul_(nus, step.b2)
    torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - step.b2))
    mu_hat = torch._foreach_div(mus, step.bc1)
    nu_hat = torch._foreach_div(nus, step.bc2)
    den = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(den, step.eps)
    updates = torch._foreach_div(mu_hat, den)
    if step.weight_decay > 0.0:
        torch._foreach_add_(updates, torch._foreach_mul(params, step.weight_decay))
    torch._foreach_mul_(updates, -step.learning_rate)
    if step.warmup is not None:
        torch._foreach_mul_(updates, step.warmup)
    torch._foreach_add_(params, updates)


def adam(
    step: AdamStep,
    params: list[torch.Tensor],
    mus: list[torch.Tensor],
    nus: list[torch.Tensor],
    grads: list[torch.Tensor],
    g_norm: torch.Tensor | None = None,
) -> None:
    """One update in place: the kernel for leaves on one CUDA device, the
    plain version for leaves on the CPU. ``g_norm``: the global gradient
    norm when ``grads`` are only part of the gradient (one slot's
    shards); by default, with a clip, the norm of ``grads``."""
    if step.max_norm is not None and g_norm is None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if params and params[0].is_cuda:
        adam_multi_tensor(step, params, mus, nus, grads, g_norm)
    elif all(not t.is_cuda for lst in (params, mus, nus, grads) for t in lst):
        adam_reference(step, params, mus, nus, grads, g_norm)
    else:
        raise ValueError("Adam's leaves mix the CPU and a CUDA device")


# ---------------------------------------------------------- the kernel
class AdamArgs(ctypes.Structure):
    """One launch's arguments: ``struct AdamArgs`` of csrc/adam.cu."""

    _fields_ = [
        ("g_norm", ctypes.c_void_p),
        *[(name, ctypes.c_float) for name in (
            "b1", "one_minus_b1", "b2", "one_minus_b2", "inv_bc1", "inv_bc2", "eps",
            "weight_decay", "neg_lr", "warmup", "max_norm")],
        ("clip", ctypes.c_int),
        ("decay", ctypes.c_int),
        ("warm", ctypes.c_int),
        ("count", ctypes.c_int),
        ("p", ctypes.c_void_p * MAX_LEAVES),
        ("m", ctypes.c_void_p * MAX_LEAVES),
        ("v", ctypes.c_void_p * MAX_LEAVES),
        ("g", ctypes.c_void_p * MAX_LEAVES),
        ("n", ctypes.c_longlong * MAX_LEAVES),
        ("chunk_end", ctypes.c_int * MAX_LEAVES),
        ("vec", ctypes.c_int * MAX_LEAVES),
    ]


class Leaves(NamedTuple):
    """The kernel's leaf list: byte addresses of each leaf's first element
    in p, mu, nu and g, its element count, and 1 where all four are
    16-byte aligned (float4 loads and stores), 0 for scalars."""

    p: np.ndarray
    m: np.ndarray
    v: np.ndarray
    g: np.ndarray
    n: np.ndarray
    vec: np.ndarray


def kernel_leaves(p, m, v, g, n) -> Leaves:
    """The leaves the kernel walks, from their four fp32 base addresses
    and element counts (sequences of ints): empty leaves left out, order
    kept, each marked for float4 where its four addresses are 16-byte
    aligned."""
    p, m, v, g = (np.asarray(a, np.uint64) for a in (p, m, v, g))
    n = np.asarray(n, np.int64)
    vec = ((p | m | v | g) % 16 == 0).astype(np.int32)
    keep = n > 0
    return Leaves(p[keep], m[keep], v[keep], g[keep], n[keep], vec[keep])


def launch_spans(count: int) -> list[tuple[int, int]]:
    """The leaves each launch takes: ``[start, stop)``, at most
    :data:`MAX_LEAVES` a launch."""
    return [(i, min(i + MAX_LEAVES, count)) for i in range(0, count, MAX_LEAVES)]


def pack_args(step: AdamStep, leaves: Leaves, start: int, stop: int, g_norm_ptr: int = 0) -> AdamArgs:
    """The arguments of the launch over ``leaves[start:stop]``. Each
    scalar is narrowed to fp32 as PyTorch narrows a Python scalar for an
    fp32 foreach op (``1 - b1`` etc. computed in double first, as the
    chain computes them); the bias corrections go as their reciprocals."""
    k = stop - start
    if not 0 < k <= MAX_LEAVES:
        raise ValueError(f"a launch takes 1 to {MAX_LEAVES} leaves, got {k}")
    n = leaves.n[start:stop]
    ends = np.cumsum((n + CHUNK - 1) // CHUNK)
    if ends[-1] >= 2**31:
        raise ValueError("a launch's chunks overflow int32")
    a = AdamArgs()
    a.g_norm = g_norm_ptr or None
    f32 = np.float32
    a.b1, a.one_minus_b1 = f32(step.b1), f32(1 - step.b1)
    a.b2, a.one_minus_b2 = f32(step.b2), f32(1 - step.b2)
    # The chain's CUDA divide by a scalar multiplies by its reciprocal,
    # taken in double and narrowed once.
    a.inv_bc1, a.inv_bc2, a.eps = f32(1.0 / step.bc1), f32(1.0 / step.bc2), f32(step.eps)
    a.weight_decay, a.neg_lr = f32(step.weight_decay), f32(-step.learning_rate)
    a.warmup = f32(1.0 if step.warmup is None else step.warmup)
    a.max_norm = f32(0.0 if step.max_norm is None else step.max_norm)
    a.clip, a.decay, a.warm = step.max_norm is not None, step.weight_decay > 0.0, step.warmup is not None
    a.count = k
    cols = (("p", leaves.p[start:stop], np.uint64), ("m", leaves.m[start:stop], np.uint64),
            ("v", leaves.v[start:stop], np.uint64), ("g", leaves.g[start:stop], np.uint64),
            ("n", n, np.int64), ("chunk_end", ends, np.int32), ("vec", leaves.vec[start:stop], np.int32))
    for name, col, dtype in cols:
        np.frombuffer(a, dtype, count=k, offset=getattr(AdamArgs, name).offset)[:] = col
    return a


def _kernel_fn():
    global _FN
    if _FN is None:
        from ._build import load

        lib = load("adam")
        for symbol, want in (("adam_args_bytes", ctypes.sizeof(AdamArgs)), ("adam_max_leaves", MAX_LEAVES),
                             ("adam_chunk_elements", CHUNK)):
            got = getattr(lib, symbol)()
            if got != want:
                raise RuntimeError(f"csrc/adam.cu's {symbol} is {got}, ops/adam.py mirrors {want}")
        fn = lib.adam_f32
        fn.argtypes = [ctypes.POINTER(AdamArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _leaf_table(lists: Sequence[list[torch.Tensor]]) -> tuple[int, list[np.ndarray]]:
    """Check the four lists for the kernel and read them: the CUDA device
    index, and per list its leaves' addresses and element counts."""
    if len({len(lst) for lst in lists}) != 1:
        raise ValueError(f"Adam's lists differ in length: {[len(lst) for lst in lists]}")
    addrs, sizes, devices = [], [], set()
    for lst in lists:
        bad = next((t for t in lst if t.dtype != torch.float32), None)
        if bad is None and not all(map(torch.Tensor.is_contiguous, lst)):
            bad = next(t for t in lst if not t.is_contiguous())
        if bad is not None:
            raise ValueError(f"the Adam kernel takes contiguous fp32 leaves, got {bad.dtype} of strides {bad.stride()}")
        addrs.append(np.fromiter(map(torch.Tensor.data_ptr, lst), np.uint64, len(lst)))
        sizes.append(np.fromiter(map(torch.Tensor.numel, lst), np.int64, len(lst)))
        devices.update(map(torch.Tensor.get_device, lst))
    if any(not np.array_equal(sizes[0], s) for s in sizes[1:]):
        raise ValueError("Adam's params, moments and gradients differ in size")
    if len(devices) != 1 or min(devices) < 0:
        raise ValueError(f"the Adam kernel takes leaves on one CUDA device, got device indices {sorted(devices)} (-1: CPU)")
    return devices.pop(), [*addrs, sizes[0]]


def adam_multi_tensor(
    step: AdamStep,
    params: list[torch.Tensor],
    mus: list[torch.Tensor],
    nus: list[torch.Tensor],
    grads: list[torch.Tensor],
    g_norm: torch.Tensor | None = None,
) -> None:
    """The update in place by csrc/adam.cu, on the current stream, with
    no sync. ``g_norm`` (a device scalar, fp32, on the leaves' device) is
    required when ``step.max_norm`` is set."""
    global ADAM_LAUNCHES
    if not params:
        return
    index, (p, m, v, g, n) = _leaf_table((params, mus, nus, grads))
    g_norm_ptr = 0
    if step.max_norm is not None:
        if g_norm is None or g_norm.numel() != 1 or g_norm.dtype != torch.float32 or g_norm.get_device() != index:
            raise ValueError(f"the clip needs g_norm as one fp32 element on cuda:{index}")
        g_norm_ptr = g_norm.data_ptr()
    leaves = kernel_leaves(p, m, v, g, n)
    if len(leaves.n) == 0:
        return
    fn = _kernel_fn()
    spans = launch_spans(len(leaves.n))
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream().cuda_stream
        for start, stop in spans:
            err = fn(ctypes.byref(pack_args(step, leaves, start, stop, g_norm_ptr)), stream)
            if err != 0:
                raise RuntimeError(f"Adam kernel launch failed: CUDA error {err}")
            with _COUNT_LOCK:
                ADAM_LAUNCHES += 1
