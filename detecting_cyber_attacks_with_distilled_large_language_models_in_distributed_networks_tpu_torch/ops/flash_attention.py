"""Flash attention: hand-written Hopper kernels and their plain versions.

Port of the JAX package's ``ops/flash_attention.py``: the forward
(``_fwd_kernel``, here ``csrc/flash_fwd.cu``, K1), the backward
(``_dkdv_kernel`` and ``_dq_kernel``, here ``csrc/flash_bwd.cu``, K2 and
K3), and the in-kernel attention dropout they share (``_keep_mask``, here
``csrc/keep_mask.cuh``). On CUDA tensors the wrappers launch the kernels
(built by :mod:`._build` at first use) and raise if a kernel cannot build
or launch; on CPU tensors they run the plain versions beside them
(:func:`flash_attention_reference`, :func:`flash_backward_reference`,
:func:`keep_mask_reference`), the same arithmetic in eager PyTorch.
Nothing falls back from the card to a plain version.

Contract kept from the JAX wrapper: ``[B, H, L, D]`` shapes, an additive
key-position bias ``[B, 1, 1, Lk]`` only (any other bias raises
``ValueError``), fp32 scores and softmax statistics, p cast to the
activation dtype before ``p @ v`` in the forward, an fp32 backward, O and
the gradients in the input dtype, the per-row ``lse = m + log l`` in fp32.

Layout contract of the forward (K1), stated and checked by
:func:`flash_layout`: q, k and v are taken as they come and read through
their (batch, head, row) strides in elements, so the model's
``[B, L, H, D] -> [B, H, L, D]`` views of its projections (or the chunks
of one fused qkv product) reach the kernel without a copy. Each must have
a contiguous last dim and 16-byte aligned row starts (base address and
every stride a multiple of 16 bytes); on the card anything else raises
``ValueError``, and nothing is made contiguous behind the caller's back
(the plain version on the CPU takes any layout). O, on the card and the
CPU alike, is allocated as ``[B, Lq, H, D]`` (:func:`empty_out`) and
returned as its ``[B, H, Lq, D]`` transpose view, so merging the heads
back (``O.transpose(1, 2).reshape(B, Lq, H * D)``) is a view. ``lse`` is
dense fp32 ``[B, H, Lq, 1]``.

Layout contract of the backward (K3, then K2), stated and checked by
:class:`_BwdInputs`: q, k, v and O as the forward saved them, and dO where
autograd hands it over, are read through their strides under the same
rule. The model's dO is a view of O's ``[B, L, H, D]`` storage and
qualifies; a dO that does not (another dtype, a stride-0 grad of
``out.sum()``, a misaligned or last-dim-strided view) gets one dense copy,
counted in ``BWD_DO_COPIES`` (:func:`bwd_dout`). dq, dk and dv come back
as ``[B, H, L, D]`` views of ``[B, L, H, D]`` storage, on the card and the
CPU alike, so the projections' backward merges the heads as a view.
``delta = rowsum(dO ⊙ O)`` is computed by K3 from the rows it loads and
read by K2, which launches after it.

Dropout: the keep bit of each ``(b, h, q, k)`` is a hash of two uint32
seed words and the global coordinates, so all three kernels regenerate
the same mask and nothing of size L x L is stored. The wrapper draws the
two words per call from an explicit ``torch.Generator`` (the JAX wrapper
draws them with ``jax.random.bits``); given the same words, the port and
the JAX kernels drop the same weights.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

#: Launches of each CUDA kernel in this process (one per launch of the
#: kernel, counted by its wrapper). Read and reset by callers that check
#: that the main path ran the kernels. K1 is two kernels, one template
#: instantiation each: rate 0 (FWD_LAUNCHES) and dropout on
#: (FWD_DROPOUT_LAUNCHES).
FWD_LAUNCHES = 0
FWD_DROPOUT_LAUNCHES = 0
DKDV_LAUNCHES = 0
DQ_LAUNCHES = 0
#: Dense copies the backward made of a dO that its kernels could not read
#: where it lay (:func:`bwd_dout`); the model's training path makes none.
BWD_DO_COPIES = 0
#: Guards the counters' read-modify-writes: two trainers in one process
#: (a federated round's clients as threads) launch concurrently.
_COUNT_LOCK = threading.Lock()

#: The head dims the CUDA kernels are built for.
KERNEL_HEAD_DIMS = (64,)

_FNS: dict[tuple[str, torch.dtype], object] = {}
_M32 = 0xFFFFFFFF

#: ctypes signatures: tensor pointers (the key bias's batch stride after
#: the bias pointer), the sizes (B, H, Lq, Lk), the (batch, head, row)
#: strides of every strided operand (K1: q, k, v, O; K2/K3: q, k, v, O,
#: dO, dq, dk, dv), then scale, keep threshold, 1 / (1 - rate) and the
#: stream.
_SIZES = [ctypes.c_int] * 4
_TAIL = [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]
_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
    + _SIZES + [ctypes.c_longlong] * 12 + _TAIL
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 9
    + _SIZES + [ctypes.c_longlong] * 24 + _TAIL
)
_UNUSED = (0, 0, 0)  # the strides of an operand a launch ignores


# ------------------------------------------------------------ keep mask
def keep_threshold(rate: float) -> int:
    """The integer keep threshold of ``_keep_mask``: keep iff the hash is
    at least ``round(rate * 2^32)`` (Python's round half to even)."""
    return min(2**32 - 1, int(round(rate * 4294967296.0)))


def _inv_keep(rate: float) -> float:
    """``1 / (1 - rate)`` as the fp32 value the kernels scale by."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _mul32(x, c: int):
    """``x * c mod 2^32`` for x in [0, 2^32) without overflowing int64:
    the multiplier is split into 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _keep_hash(s0: int, s1: int, b, h, q, k):
    """The murmur3-finalized hash of ``_keep_mask`` on int64 tensors (or
    ints) holding uint32 values: torch has no CPU ``>>``, ``+`` or ``>=``
    for uint32, so every step masks back to 32 bits."""
    x = _mul32(q, 0x9E3779B1) ^ _mul32(k, 0x85EBCA77)
    x = x ^ ((s0 + _mul32(b, 0xC2B2AE3D) + _mul32(h, 0x27D4EB2F)) & _M32)
    x = (x + _mul32(s1, 0x632BE59B)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _seed_ints(seed_words) -> tuple[int, int]:
    words = seed_words.tolist() if isinstance(seed_words, torch.Tensor) else seed_words
    s0, s1 = (int(w) for w in np.asarray(words).reshape(-1))
    return s0 & _M32, s1 & _M32


def keep_mask_reference(
    seed_words, b: int, h: int, q0: int, k0: int, bq: int, bk: int, rate: float
) -> torch.Tensor:
    """Plain version of the kernels' keep mask: fp32 ``[bq, bk]`` 0/1 for
    queries ``q0..q0+bq`` and keys ``k0..k0+bk`` of (batch b, head h),
    bit for bit the JAX ``_keep_mask`` on the same two seed words."""
    s0, s1 = _seed_ints(seed_words)
    qi = torch.arange(bq, dtype=torch.int64)[:, None] + q0
    ki = torch.arange(bk, dtype=torch.int64)[None, :] + k0
    return (_keep_hash(s0, s1, b, h, qi, ki) >= keep_threshold(rate)).float()


def _keep_full(seed_words, b: int, h: int, lq: int, lk: int, rate: float,
               device) -> torch.Tensor:
    """The whole call's keep mask, fp32 ``[B, H, Lq, Lk]``."""
    s0, s1 = _seed_ints(seed_words)

    def ax(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)

    x = _keep_hash(s0, s1, ax(b, 0), ax(h, 1), ax(lq, 2), ax(lk, 3))
    return (x >= keep_threshold(rate)).float()


def draw_seed_words(generator: torch.Generator) -> torch.Tensor:
    """Two uint32 seed words (as int64, on the generator's device) for one
    call's dropout mask."""
    return torch.randint(
        0, 2**32, (2,), generator=generator, device=generator.device,
        dtype=torch.int64,
    )


# ------------------------------------------------------- plain versions
def _key_bias(
    bias: torch.Tensor | None, batch: int, lk: int, device: torch.device
) -> torch.Tensor:
    """Key-position bias as contiguous fp32 ``[B, Lk]`` (zeros for None)."""
    if bias is None:
        return torch.zeros((batch, lk), dtype=torch.float32, device=device)
    if bias.ndim != 4 or bias.shape[1] != 1 or bias.shape[2] != 1:
        raise ValueError(
            "flash_attention supports key-position bias [B,1,1,Lk] only, "
            f"got {tuple(bias.shape)}"
        )
    return bias[:, 0, 0, :].to(torch.float32).expand(batch, lk).contiguous()


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(
            f"want q [B,H,Lq,D], k and v [B,H,Lk,D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D"
        )
    if k.shape[2] < 1:
        raise ValueError("flash attention needs at least one key")


def _check_rate(rate: float, seed) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} must lie in [0, 1)")
    if rate and seed is None:
        raise ValueError("flash attention dropout needs seed words")


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    seed: torch.Tensor | None = None,
    rate: float = 0.0,
    block_k: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked online-softmax attention in eager PyTorch -> ``(O, lse)``.

    The same arithmetic as K1 and the JAX ``_fwd_kernel``: fp32 scores
    ``(q·kᵀ)·scale + bias``, running max and denominator over the
    unrounded, undropped p, then (at ``rate`` > 0) p times the keep mask
    of ``seed`` times ``1/(1-rate)``, cast to v's dtype before ``p·v``
    with fp32 accumulation. A last key block shorter than ``block_k`` is
    simply shorter, so any length works. ``lse`` is ``[B, H, Lq, 1]``."""
    _check_shapes(q, k, v)
    _check_rate(rate, seed)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    key_bias = _key_bias(bias, b, lk, q.device)
    scale = 1.0 / (d**0.5)
    keep = _keep_full(seed, b, h, lq, lk, rate, q.device) if rate else None
    inv = _inv_keep(rate) if rate else 1.0
    qf = q.float()
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    for k0 in range(0, lk, block_k):
        k_blk = k[:, :, k0 : k0 + block_k].float()
        v_blk = v[:, :, k0 : k0 + block_k]
        s = (
            torch.matmul(qf, k_blk.transpose(-1, -2)) * scale
            + key_bias[:, None, None, k0 : k0 + block_k]
        )
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        # -1e9 mask addends keep l > 0 even for fully masked rows.
        l = l * alpha + p.sum(dim=-1)
        if keep is not None:
            p = p * keep[..., k0 : k0 + block_k] * inv
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).float(), v_blk.float()
        )
        m = m_new
    out = (acc / l[..., None]).to(q.dtype)
    return out, (m + torch.log(l))[..., None]


def _delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO ⊙ O)`` in fp32, ``[B, H, Lq]``: the plain version's
    (XLA outside the Pallas kernels in JAX; K3 on the card)."""
    return (do.float() * out.float()).sum(dim=-1)


def _dbias(db_h: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor | None:
    """Per-head key-bias rows ``[B, H, Lk]`` -> the bias's own layout."""
    if bias is None:
        return None
    dbias = db_h.sum(dim=1)[:, None, None, :]
    if bias.shape[0] == 1 and dbias.shape[0] != 1:
        dbias = dbias.sum(dim=0, keepdim=True)
    return dbias.to(bias.dtype)


def _bwd_recompute(q, k, v, bias, seed, out, lse, do, rate):
    """The score-tile recompute both backward kernels start from, in
    fp32: ``(qf, kf, dof, y, ds, scale)``."""
    _check_shapes(q, k, v)
    _check_rate(rate, seed)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    key_bias = _key_bias(bias, b, lk, q.device)
    scale = 1.0 / (d**0.5)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale + key_bias[:, None, None, :]
    p = torch.exp(s - lse.reshape(b, h, lq, 1))
    dpn = torch.matmul(dof, vf.transpose(-1, -2))
    y = p
    if rate:
        keep = _keep_full(seed, b, h, lq, lk, rate, q.device)
        inv = _inv_keep(rate)
        y = p * keep * inv
        dpn = dpn * keep * inv
    ds = p * (dpn - _delta(do, out)[..., None])
    return qf, kf, dof, y, ds, scale


def flash_dkdv_reference(
    q, k, v, bias, seed, out, lse, do, *, rate: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 (the JAX ``_dkdv_kernel``) -> ``(dk, dv,
    db_h)`` with the per-head key-bias rows ``db_h [B, H, Lk]``."""
    qf, _, dof, y, ds, scale = _bwd_recompute(q, k, v, bias, seed, out, lse, do, rate)
    dv = torch.matmul(y.transpose(-1, -2), dof)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    return dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=2)


def flash_dq_reference(
    q, k, v, bias, seed, out, lse, do, *, rate: float = 0.0
) -> torch.Tensor:
    """Plain version of K3 (the JAX ``_dq_kernel``) -> ``dq``."""
    _, kf, _, _, ds, scale = _bwd_recompute(q, k, v, bias, seed, out, lse, do, rate)
    return (scale * torch.matmul(ds, kf)).to(q.dtype)


def flash_backward_reference(
    q, k, v, bias, seed, out, lse, do, *, rate: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain version of K2 + K3 (the JAX ``_flash_backward``) ->
    ``(dq, dk, dv, dbias)``.

    fp32 throughout: q, k, v and dO are widened and p is not rounded.
    ``p = exp(s - lse)`` is the undropped softmax; the keep mask scales
    the weights that multiplied v (``y``, for dv) and ``dO·vᵀ``, and
    ``ds = p·(dpn - delta)``. ``dbias`` (None without a bias) sums the
    per-head rows over heads."""
    dk, dv, db_h = flash_dkdv_reference(q, k, v, bias, seed, out, lse, do, rate=rate)
    dq = flash_dq_reference(q, k, v, bias, seed, out, lse, do, rate=rate)
    return dq, dk, dv, _dbias(db_h, bias)


# ---------------------------------------------------------- the layout
def _row_strides(name: str, t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, row) strides of a ``[B, H, L, D]`` operand, checked:
    a size-1 dim's stride is never used and counts as 0."""
    (b, h, l, d), (sb, sh, sr, sd) = t.shape, t.stride()
    if d > 1 and sd != 1:
        raise ValueError(
            f"flash kernel: {name} needs a contiguous last dim, got strides "
            f"{t.stride()}"
        )
    strides = (0 if b == 1 else sb, 0 if h == 1 else sh, 0 if l == 1 else sr)
    size = t.element_size()
    # Spelled out, not any(...) over a generator: this runs four times a
    # launch, and the launch's host time is what small batches wait for.
    if (
        t.data_ptr() % 16 or strides[0] * size % 16
        or strides[1] * size % 16 or strides[2] * size % 16
    ):
        raise ValueError(
            f"flash kernel: {name} rows must start 16-byte aligned, got base "
            f"offset {t.data_ptr() % 16} B and strides {t.stride()} of "
            f"{size}-byte elements"
        )
    return strides


def flash_layout(q, k, v, out) -> tuple[tuple[int, int, int], ...]:
    """K1's layout contract: the (batch, head, row) strides in elements
    of q, k, v and O, in that order. Raises ``ValueError`` for an operand
    whose last dim is not contiguous or whose rows do not start 16-byte
    aligned. Pure Python over shapes, strides and addresses, so it holds
    for CPU tensors as for CUDA ones."""
    return tuple(_row_strides(n, t) for n, t in (("q", q), ("k", k), ("v", v), ("O", out)))


def empty_out(q: torch.Tensor) -> torch.Tensor:
    """O as K1 writes it: ``[B, Lq, H, D]`` storage returned as its
    ``[B, H, Lq, D]`` transpose view, so merging the heads is a view."""
    b, h, lq, d = q.shape
    return torch.empty_strided(
        (b, h, lq, d), (lq * h * d, d, h * d, 1), dtype=q.dtype, device=q.device
    )


# ---------------------------------------------------------- the kernels
def _kernel_fn(lib_name: str, symbol: str, dtype: torch.dtype, argtypes: list):
    fn = _FNS.get((symbol, dtype))
    if fn is None:
        from ._build import load

        suffix = "bf16" if dtype == torch.bfloat16 else "f32"
        fn = getattr(load(lib_name), f"{symbol}_{suffix}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(symbol, dtype)] = fn
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_kernel_inputs(q, k, v) -> None:
    d = q.shape[3]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash kernels support head_dim {KERNEL_HEAD_DIMS}, "
            f"got {d}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA flash kernels take bf16 or fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if not (k.is_cuda and v.is_cuda) or k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on the same CUDA device")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(
            f"B*H={q.shape[0] * q.shape[1]} exceeds the kernels' grid limit 65535"
        )


def _drop_args(seed, rate: float, device) -> tuple[torch.Tensor | None, int, float]:
    """(device seed words or None, threshold, inverse keep) of a launch."""
    if not rate:
        return None, 0, 1.0
    seed = _aligned(seed.to(device=device, dtype=torch.int64).reshape(2))
    return seed, keep_threshold(rate), _inv_keep(rate)


def _run(fn, name: str, device, *args) -> None:
    """Launch on the device's current stream; enter the device only when
    it is not the current one already."""
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _kernel_bias(bias, batch: int, lk: int, device) -> tuple[torch.Tensor, int]:
    """The kernels' key bias and its batch stride in elements (0: one row for
    every batch): an fp32 ``[B or 1, 1, 1, Lk]`` bias with its keys
    contiguous is read where it lies; anything else becomes a dense fp32
    ``[B, Lk]`` copy."""
    if bias is not None and bias.dtype == torch.float32 and bias.ndim == 4:
        rows, heads, queries, keys = bias.shape
        if (
            heads == queries == 1 and keys == lk and rows in (1, batch)
            and (lk == 1 or bias.stride(3) == 1)
        ):
            return bias, 0 if rows == 1 else bias.stride(0)
    return _key_bias(bias, batch, lk, device), lk


def _launch_fwd(q, k, v, bias, seed, rate) -> tuple[torch.Tensor, torch.Tensor]:
    global FWD_LAUNCHES, FWD_DROPOUT_LAUNCHES
    _check_kernel_inputs(q, k, v)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias)
    ):
        raise RuntimeError(
            "flash_forward returns no gradient; call flash_attention, whose "
            "FlashAttention backward runs the K2/K3 kernels"
        )
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = empty_out(q)
    # q, k and v as the model hands them over (views of its projections):
    # read through their strides, never copied.
    sq, sk, sv, so = flash_layout(q, k, v, out)
    key_bias, bias_b = _kernel_bias(bias, b, lk, q.device)
    seed_d, thresh, inv = _drop_args(seed, rate, q.device)
    lse = torch.empty((b, h, lq, 1), dtype=torch.float32, device=q.device)
    fn = _kernel_fn("flash_fwd", "flash_fwd", q.dtype, _FWD_ARGTYPES)
    _run(
        fn, "flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), bias_b,
        out.data_ptr(), lse.data_ptr(), _ptr(seed_d), b, h, lq, lk,
        *sq, *sk, *sv, *so, 1.0 / (d**0.5), thresh, inv,
    )
    with _COUNT_LOCK:
        if seed_d is None:
            FWD_LAUNCHES += 1
        else:
            FWD_DROPOUT_LAUNCHES += 1
    return out, lse


def flash_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    seed: torch.Tensor | None = None,
    rate: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)``: K1 for CUDA tensors, the plain version for CPU
    tensors. ``seed`` (two uint32 words as int64) keys the dropout mask
    at ``rate`` > 0. O comes back in K1's layout on both (a view of
    ``[B, Lq, H, D]`` storage, :func:`empty_out`). Not differentiable:
    :func:`flash_attention` is."""
    _check_shapes(q, k, v)
    _check_rate(rate, seed)
    if q.device.type == "cpu":
        ref, lse = flash_attention_reference(q, k, v, bias, seed=seed, rate=rate)
        return empty_out(q).copy_(ref), lse
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_fwd(q, k, v, bias, seed, rate)


def bwd_dout(do: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """dO as K2 and K3 read it: the tensor autograd handed over, where it
    lies, when it has q's dtype and shape and passes the kernels' layout
    rule (:func:`_row_strides`); else one dense copy in q's dtype, counted
    in ``BWD_DO_COPIES``. The model's dO (a view of O's ``[B, L, H, D]``
    storage) qualifies; a stride-0 grad of ``out.sum()`` does not."""
    global BWD_DO_COPIES
    if do.dtype == q.dtype and do.shape == q.shape:
        try:
            _row_strides("dO", do)
            return do
        except ValueError:
            pass
    with _COUNT_LOCK:
        BWD_DO_COPIES += 1
    return _aligned(do.to(q.dtype))


class _BwdInputs:
    """The backward's operands, checked and laid out as K3 and K2 take
    them: q, k, v and O read through their strides (as K1 took q, k and v
    and wrote O), dO through :func:`bwd_dout`, the kernels' key bias, fp32
    ``[B, H, Lq]`` lse, the fp32 delta buffer K3 fills for K2, and the
    launch's dropout words."""

    def __init__(self, q, k, v, bias, seed, out, lse, do, rate):
        _check_kernel_inputs(q, k, v)
        b, h, lq, d = q.shape
        lk = k.shape[2]
        if out.dtype != q.dtype or out.shape != q.shape:
            raise ValueError(f"O {out.dtype} {tuple(out.shape)} does not match q")
        self.q, self.k, self.v, self.out = q, k, v, out
        self.do = bwd_dout(do, q)
        self.strides = (*flash_layout(q, k, v, out), _row_strides("dO", self.do))
        self.key_bias, self.bias_b = _kernel_bias(bias, b, lk, q.device)
        self.lse = _aligned(lse.reshape(b, h, lq).to(torch.float32))
        self.delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
        self.seed, self.thresh, self.inv = _drop_args(seed, rate, q.device)
        self.dims = (b, h, lq, lk)
        self.scale = 1.0 / (d**0.5)

    def launch(self, symbol: str, dq=None, dk=None, dv=None, db=None) -> None:
        fn = _kernel_fn("flash_bwd", symbol, self.q.dtype, _BWD_ARGTYPES)
        outs = [_row_strides(n, t) if t is not None else _UNUSED
                for n, t in (("dq", dq), ("dk", dk), ("dv", dv))]
        _run(
            fn, symbol, self.q.device,
            self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
            self.key_bias.data_ptr(), self.bias_b, self.out.data_ptr(),
            self.lse.data_ptr(), self.delta.data_ptr(), self.do.data_ptr(),
            _ptr(self.seed), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(db), *self.dims,
            *(x for st in (*self.strides, *outs) for x in st),
            self.scale, self.thresh, self.inv,
        )


def flash_bwd_dq(x: _BwdInputs) -> torch.Tensor:
    """K3 -> ``dq`` (a ``[B, H, Lq, D]`` view of ``[B, Lq, H, D]``
    storage); also fills ``x.delta``, which :func:`flash_bwd_dkdv` reads,
    so it launches first."""
    global DQ_LAUNCHES
    dq = empty_out(x.q)
    x.launch("flash_bwd_dq", dq=dq)
    with _COUNT_LOCK:
        DQ_LAUNCHES += 1
    return dq


def flash_bwd_dkdv(x: _BwdInputs) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 -> ``(dk, dv, db_h)``, dk and dv as views of ``[B, Lk, H, D]``
    storage, with per-head bias rows ``db_h [B,H,Lk]``. Reads the delta
    that :func:`flash_bwd_dq` wrote into ``x``."""
    global DKDV_LAUNCHES
    b, h, _, lk = x.dims
    dk, dv = empty_out(x.k), empty_out(x.v)
    db_h = torch.empty((b, h, lk), dtype=torch.float32, device=x.q.device)
    x.launch("flash_bwd_dkdv", dk=dk, dv=dv, db=db_h)
    with _COUNT_LOCK:
        DKDV_LAUNCHES += 1
    return dk, dv, db_h


def flash_backward(
    q, k, v, bias, seed, out, lse, do, *, rate: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """``(dq, dk, dv, dbias)``: K3 then K2 for CUDA tensors, the plain
    version for CPU tensors; dq, dk and dv come back as ``[B, H, L, D]``
    views of ``[B, L, H, D]`` storage on both (:func:`empty_out`).
    ``dbias`` is None without a bias."""
    _check_shapes(q, k, v)
    _check_rate(rate, seed)
    if q.device.type == "cpu":
        dq, dk, dv, dbias = flash_backward_reference(
            q, k, v, bias, seed, out, lse, do, rate=rate
        )
        return empty_out(q).copy_(dq), empty_out(k).copy_(dk), empty_out(v).copy_(dv), dbias
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    x = _BwdInputs(q, k, v, bias, seed, out, lse, do, rate)
    dq = flash_bwd_dq(x)
    dk, dv, db_h = flash_bwd_dkdv(x)
    return dq, dk, dv, _dbias(db_h, bias)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient (the JAX ``custom_vjp`` of
    ``_flash``): the forward saves q, k, v (the caller's views, as K1
    read them), bias, the seed words, O and lse; the backward returns dq,
    dk, dv and, when the bias requires grad, dbias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate):
        out, lse = flash_forward(q, k, v, bias, seed=seed, rate=rate)
        ctx.save_for_backward(q, k, v, bias, seed, out, lse)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seed, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_backward(
            q, k, v, bias, seed, out, lse, do, rate=ctx.rate
        )
        return dq, dk, dv, dbias if ctx.needs_input_grad[3] else None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, H, Lk, D]
    v: torch.Tensor,  # [B, H, Lk, D]
    bias: torch.Tensor | None = None,  # [B, 1, 1, Lk] additive key mask
    *,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Drop-in for :func:`.attention.dot_product_attention`; returns O.

    Differentiable through :class:`FlashAttention` whenever an input
    requires grad (K1 forward, K2 + K3 backward on the card). Dropout
    runs at ``dropout_rate`` unless ``deterministic``, keyed by two seed
    words drawn from ``generator`` per call."""
    rate = 0.0
    if dropout_rate > 0.0 and not deterministic:
        if generator is None:
            raise ValueError("flash attention dropout needs a generator")
        rate = float(dropout_rate)
    seed = draw_seed_words(generator) if rate else None
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias)
    ):
        return FlashAttention.apply(q, k, v, bias, seed, rate)
    return flash_forward(q, k, v, bias, seed=seed, rate=rate)[0]
