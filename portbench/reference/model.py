"""What every family's plain reference shares: precision, dropout, and
the loops that turn a family's forward into answers and training readings.

Plain PyTorch in fp32 with TF32 off, importing nothing of the program or
of JAX. A family (``reference/<name>.py``, named by a configuration's
``"reference"`` key; ``distilbert`` where it has none) writes its forward
from its architecture's description and hands it to ``softmax_rows`` and
``adam_steps``; it takes the benchmark's weights and batches and works out
everything the program derives from them again.

Dropout follows the configuration: keep with probability ``1 - rate``
and scale the kept values by ``1 / (1 - rate)``. The masks come from the
seed the benchmark hands to both sides, drawn from a ``torch.Generator``
on the device (``DropStream``) in the order the family's forward visits
its sites: the hidden sites' masks are ``torch.rand(shape) < 1 - rate``,
and an attention weights' mask is the murmur3-finalised hash of two
uint32 seed words and the (batch, head, query, key) coordinate, whose
arithmetic (the port's K1) is copied here.

``Precision("fp8")`` is the control, computed a precision below the
configuration's bf16: each layer's outputs and every matrix product's
operands rounded to float8 (e4m3 going forward, e5m2 for the gradients
coming back) under one scale per tensor, the rest in fp32.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF


# ------------------------------------------------------------ precision
def _round8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8 type) under one per-tensor
    scale that maps its largest magnitude onto the type's largest."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = _round8(x, torch.float8_e4m3fn), _round8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.T + b

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = _round8(gy, torch.float8_e5m2)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
        return gx, gw, gy.reshape(-1, gy.shape[-1]).sum(0)


class _Round8(torch.autograd.Function):
    """An activation stored in float8: the value rounded to e4m3 going
    forward, its gradient to e5m2 coming back, each under one scale."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


@dataclass(frozen=True)
class Precision:
    """``fp32``: the reference. ``fp8``: the control, computed a precision
    below the configuration's bf16: each layer's outputs and their
    gradients stored in float8, and every matrix product's operands in
    float8."""

    name: str = "fp32"

    def linear(self, x, w, b):
        if self.name == "fp8":
            return self.act(_Fp8Linear.apply(x, w, b))
        return x @ w.T + b

    def operand(self, x):
        """A matmul operand inside attention (straight-through rounding)."""
        if self.name == "fp8":
            return x + (_round8(x, torch.float8_e4m3fn) - x).detach()
        return x

    def act(self, x):
        """An activation as the precision stores it."""
        if self.name == "fp8":
            return _Round8.apply(x)
        return x


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for matmuls and convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


# ------------------------------------------------------------- dropout
def _mul32(x, c: int):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def keep_hash(s0: int, s1: int, b, h, q, k):
    """The attention keep mask's hash on int64 tensors holding uint32s."""
    x = _mul32(q, 0x9E3779B1) ^ _mul32(k, 0x85EBCA77)
    x = x ^ ((s0 + _mul32(b, 0xC2B2AE3D) + _mul32(h, 0x27D4EB2F)) & M32)
    x = (x + _mul32(s1, 0x632BE59B)) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def attention_keep(words: torch.Tensor, shape, rate: float) -> torch.Tensor:
    """Bool ``[B, H, Lq, Lk]``: keep iff the hash reaches
    ``round(rate · 2^32)``."""
    s0, s1 = (int(w) & M32 for w in words.tolist())
    dev = words.device

    def ax(n, dim):
        s = [1, 1, 1, 1]
        s[dim] = n
        return torch.arange(n, dtype=torch.int64, device=dev).reshape(s)

    x = keep_hash(s0, s1, *(ax(n, i) for i, n in enumerate(shape)))
    return x >= min(2**32 - 1, int(round(rate * 4294967296.0)))


class DropStream:
    """The dropout masks of training forwards, drawn from ``seed``."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = torch.device(device)

    def hidden(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=self.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))

    def words(self) -> torch.Tensor:
        return torch.randint(0, 2**32, (2,), generator=self.gen, device=self.device, dtype=torch.int64)


# ------------------------------------------------------------ training
@dataclass
class TrainReadings:
    """What the checked steps leave: each step's loss, each leaf's first
    gradient norm, and each leaf's change over the steps."""

    losses: list[float]
    grad_norms: dict[str, float]
    change_norms: dict[str, float]


def _norms(tensors: dict) -> dict[str, float]:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].double()) for n in names]).tolist()
    return dict(zip(names, vals))


def softmax_rows(logits, ids, mask, block: int, prec: Precision = Precision()) -> torch.Tensor:
    """Per-class softmax of every row of ``logits(ids, mask, prec)``, a
    family's inference forward, ``block`` rows at a time."""
    out = []
    with torch.no_grad(), strict_fp32():
        for i in range(0, len(ids), block):
            out.append(torch.softmax(logits(ids[i:i + block], mask[i:i + block], prec), -1))
    return torch.cat(out)


def adam_steps(logits, w0: dict, batches, drop_seed: int, opt: dict,
               prec: Precision = Precision(), half_batch: bool = False) -> TrainReadings:
    """Adam steps from ``w0`` over ``batches`` (``(ids, mask, labels)``
    on the device), each loss the mean softmax cross-entropy over the
    batch of ``logits(params, ids, mask, drop, prec)``, a family's
    training forward. ``opt``: ``learning_rate``, ``b1``, ``b2``,
    ``eps``. ``half_batch`` plants a fault: the loss over the first half
    of each batch only."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    drop = DropStream(drop_seed, next(iter(w0.values())).device)
    lr, b1, b2, eps = opt["learning_rate"], opt["b1"], opt["b2"], opt["eps"]
    losses, first = [], None
    with strict_fp32():
        for t, (ids, mask, labels) in enumerate(batches, start=1):
            out = logits(params, ids, mask, drop, prec)
            if half_batch:
                n = len(labels) // 2
                loss = F.cross_entropy(out[:n], labels[:n].long())
            else:
                loss = F.cross_entropy(out, labels.long())
            names = list(params)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            losses.append(loss.item())
            with torch.no_grad():
                if first is None:
                    first = _norms(dict(zip(names, grads)))
                c1 = 1.0 - b1**t
                c2 = 1.0 - b2**t
                for n, g in zip(names, grads):
                    mu[n].mul_(b1).add_(g * (1.0 - b1))
                    nu[n].mul_(b2).add_(g * g * (1.0 - b2))
                    params[n].sub_(lr * (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps))
            del grads, out, loss
    with torch.no_grad():
        change = _norms({n: params[n] - w0[n] for n in params})
    return TrainReadings(losses, first, change)
