"""Residual add + LayerNorm of a post-LN block: a hand-written kernel pair
and its plain version.

``LayerNorm(x + r)`` as the model computes it at both post-LN sites of a
block: the add in the activation dtype, fp32 statistics over the rounded
sum, fp32 gamma and beta, the output rounded once to the activation dtype
(flax ``LayerNorm(dtype=compute_dtype)`` over the residual sum).

* :func:`residual_layer_norm_reference` is that expression in four
  PyTorch ops: the CPU path, and what the card tests hold the kernel to.
* On CUDA tensors :func:`residual_layer_norm` launches ``csrc/residual_ln.cu``
  (built by :mod:`._build` at first use): one pass a row, reading x and r
  once and writing the output once. Under autograd
  (:class:`ResidualLayerNorm`) the forward also keeps the rounded sum and
  each row's mean and rstd, and the backward kernel writes one ``dx``,
  the gradient of both x and r, and per-block fp32 partials of dgamma and
  dbeta that a second small kernel sums in a fixed order, so two runs give
  the same bits.

The wrapper raises ``ValueError`` on what the kernels do not take: another
device, dtype or width than the parameters', non-contiguous x or r, no
rows. Nothing falls back to the plain version on the card. The kernels'
route and launch shape (:func:`vectors_a_lane`, :func:`bwd_blocks`) are
worked out here, in Python that the CPU tests reach.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from .flash_attention import _kernel_fn, _run

#: Launches of the forward kernel, and of the backward pair (its two
#: kernels counted once), in this process. Read and reset by callers that
#: check that the main path ran them.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

#: The widest bf16 row the register route holds: one warp a row, at most
#: 4 vectors of 8 elements a lane.
REGISTER_ROW = 1024
#: Warps of a backward block (``kBwdWarps`` in csrc/residual_ln.cu), and the
#: backward's blocks an SM at most.
BWD_WARPS = 8
BWD_BLOCKS_PER_SM = 2

_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def residual_layer_norm_reference(
    x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, dtype: torch.dtype
) -> torch.Tensor:
    """The plain version: ``LayerNorm(x + r)`` with the sum in the inputs'
    dtype, fp32 statistics, fp32 weight and bias, the output in ``dtype``."""
    return F.layer_norm((x + r).float(), (x.shape[-1],), weight, bias, eps).to(dtype)


def vectors_a_lane(n: int, dtype: torch.dtype, *tensors: torch.Tensor) -> int:
    """The kernels' route for rows of ``n`` elements: PER, the least of 1,
    2 and 4 16-byte vectors a lane that holds the row in one warp's
    registers, for a bf16 row at most :data:`REGISTER_ROW` wide whose
    width is a whole number of vectors and whose ``tensors`` start 16-byte
    aligned (the rows then do too); else 0, the route that walks any row
    with element loads (fp32, odd widths, misaligned views)."""
    if dtype != torch.bfloat16 or n % 8 or n > REGISTER_ROW or any(t.data_ptr() % 16 for t in tensors):
        return 0
    need = -(-n // 256)
    return 1 if need == 1 else 2 if need == 2 else 4


def bwd_blocks(rows: int, sms: int) -> int:
    """Blocks of the backward: one a :data:`BWD_WARPS` rows, at most
    :data:`BWD_BLOCKS_PER_SM` an SM; each block writes one fp32 partial
    row of 2n sums."""
    return max(1, min(-(-rows // BWD_WARPS), BWD_BLOCKS_PER_SM * sms))


def _check(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> int:
    """The forward kernel's contract; returns the width."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the residual LayerNorm kernel takes bf16 or fp32, got {x.dtype}")
    if r.dtype != x.dtype:
        raise ValueError(f"x {x.dtype} and r {r.dtype} must share one dtype")
    if r.shape != x.shape or x.ndim < 1:
        raise ValueError(f"x {tuple(x.shape)} and r {tuple(r.shape)} must share one shape")
    n = x.shape[-1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or tuple(p.shape) != (n,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 [{n}], got {p.dtype} {tuple(p.shape)}")
    if not (x.is_cuda and r.device == x.device and weight.device == x.device and bias.device == x.device):
        raise ValueError("x, r, weight and bias must lie on the same CUDA device")
    if not (x.is_contiguous() and r.is_contiguous()):
        raise ValueError(f"x and r must be contiguous, got strides {x.stride()} and {r.stride()}")
    if x.numel() == 0:
        raise ValueError(f"the residual LayerNorm kernel needs at least one row, got {tuple(x.shape)}")
    return n


def residual_ln_forward(
    x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, save: bool = False
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """The forward kernel -> ``(y, s, stats)``: with ``save`` also the
    rounded sum ``s`` (x's dtype and shape) and fp32 ``[rows, 2]`` (mean,
    rstd) for :func:`residual_ln_backward`, else None for both."""
    global FWD_LAUNCHES
    n = _check(x, r, weight, bias)
    rows = x.numel() // n
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    s = torch.empty_like(y) if save else None
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device) if save else None
    fn = _kernel_fn("residual_ln", "residual_ln_fwd", x.dtype, _FWD_ARGTYPES)
    _run(
        fn, "residual_ln_fwd", x.device,
        x.data_ptr(), r.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        None if s is None else s.data_ptr(), None if stats is None else stats.data_ptr(),
        rows, n, float(eps), vectors_a_lane(n, x.dtype, x, r, weight, bias),
    )
    with _COUNT_LOCK:
        FWD_LAUNCHES += 1
    return y, s, stats


def residual_ln_backward(
    dy: torch.Tensor, s: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels -> ``(dx, dweight, dbias)``: dx in s's dtype,
    the gradient of both x and r; dweight and dbias fp32. A ``dy`` in
    another dtype or layout than s's is made so first."""
    global BWD_LAUNCHES
    n = s.shape[-1]
    rows = s.numel() // n
    if dy.dtype != s.dtype or not dy.is_contiguous():
        dy = dy.to(dtype=s.dtype, memory_format=torch.contiguous_format)
    dx = torch.empty_like(s)
    blocks = bwd_blocks(rows, torch.cuda.get_device_properties(s.device).multi_processor_count)
    partial = torch.empty((blocks, 2 * n), dtype=torch.float32, device=s.device)
    dparams = torch.empty((2, n), dtype=torch.float32, device=s.device)
    fn = _kernel_fn("residual_ln", "residual_ln_bwd", s.dtype, _BWD_ARGTYPES)
    _run(
        fn, "residual_ln_bwd", s.device,
        dy.data_ptr(), s.data_ptr(), stats.data_ptr(), weight.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dparams.data_ptr(), rows, n, blocks, vectors_a_lane(n, s.dtype, dy, s, weight),
    )
    with _COUNT_LOCK:
        BWD_LAUNCHES += 1
    dweight, dbias = dparams.unbind(0)
    return dx, dweight, dbias


class ResidualLayerNorm(torch.autograd.Function):
    """The kernel pair with its gradient: the forward saves the rounded sum,
    each row's (mean, rstd) and the weight; the backward hands the one dx
    to both x and r."""

    @staticmethod
    def forward(ctx, x, r, weight, bias, eps):
        y, s, stats = residual_ln_forward(x, r, weight, bias, eps, save=True)
        ctx.save_for_backward(s, stats, weight)
        return y

    @staticmethod
    def backward(ctx, dy):
        s, stats, weight = ctx.saved_tensors
        dx, dweight, dbias = residual_ln_backward(dy, s, stats, weight)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dx if need[1] else None, dweight if need[2] else None,
                dbias if need[3] else None, None)


def residual_layer_norm(
    x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, dtype: torch.dtype
) -> torch.Tensor:
    """``LayerNorm(x + r)`` in ``dtype``: the plain version for CPU tensors,
    the kernels for CUDA tensors (differentiable through
    :class:`ResidualLayerNorm` whenever an input requires grad)."""
    if x.device.type == "cpu":
        return residual_layer_norm_reference(x, r, weight, bias, eps, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if dtype != x.dtype:
        raise ValueError(f"the residual LayerNorm kernel writes x's dtype {x.dtype}, not {dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, r, weight, bias)):
        return ResidualLayerNorm.apply(x, r, weight, bias, eps)
    return residual_ln_forward(x, r, weight, bias, eps)[0]
