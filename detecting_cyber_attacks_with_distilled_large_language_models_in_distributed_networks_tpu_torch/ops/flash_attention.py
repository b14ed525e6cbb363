"""Flash attention forward: a hand-written Hopper kernel and its plain version.

Port of the JAX package's ``ops/flash_attention.py`` forward
(``_fwd_kernel``). On a CUDA tensor :func:`flash_forward` launches
``csrc/flash_fwd.cu`` (built by :mod:`._build` at first use) and raises if
the kernel cannot build or launch; on a CPU tensor it runs
:func:`flash_attention_reference`, the same blocked online softmax in
eager PyTorch. Nothing falls back from the card to the plain version.

Contract kept from the JAX wrapper: ``[B, H, L, D]`` layout, an additive
key-position bias ``[B, 1, 1, Lk]`` only (any other bias raises
``ValueError``), fp32 scores and softmax statistics, p cast to the
activation dtype before ``p @ v``, O in the input dtype and the per-row
``lse = m + log l`` in fp32.

Not yet ported (the training slice): attention dropout (``_keep_mask``)
and the backward kernels. On the card, dropout at rate > 0 and inputs
that require grad raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch

#: Launches of the CUDA forward kernel in this process (one per call of
#: the kernel path). Read and reset by callers that check that the main
#: path ran the kernel.
FWD_LAUNCHES = 0

#: The head dims the CUDA kernel is built for.
KERNEL_HEAD_DIMS = (64,)

_FNS: dict[torch.dtype, object] = {}


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


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    block_k: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked online-softmax attention in eager PyTorch -> ``(O, lse)``.

    The same arithmetic as the kernel and the JAX ``_fwd_kernel``: fp32
    scores ``(q·kᵀ)·scale + bias``, running max and denominator over the
    unrounded p, p cast to v's dtype before ``p·v`` with fp32
    accumulation. A last key block shorter than ``block_k`` is simply
    shorter, so any length works. ``lse`` is ``[B, H, Lq, 1]`` fp32."""
    _check_shapes(q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    key_bias = _key_bias(bias, b, lk, q.device)
    scale = 1.0 / (d**0.5)
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
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).float(), v_blk.float()
        )
        m = m_new
    out = (acc / l[..., None]).to(q.dtype)
    return out, (m + torch.log(l))[..., None]


def _kernel_fn(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        from ._build import load

        lib = load("flash_fwd")
        fn = lib.flash_fwd_bf16 if dtype == torch.bfloat16 else lib.flash_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, bias) -> tuple[torch.Tensor, torch.Tensor]:
    global FWD_LAUNCHES
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash kernel supports head_dim {KERNEL_HEAD_DIMS}, "
            f"got {d}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA flash kernel takes bf16 or fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if not (k.is_cuda and v.is_cuda) or k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on the same CUDA device")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the kernel's grid limit 65535")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias)
    ):
        raise NotImplementedError(
            "the CUDA flash kernel is forward-only; its backward kernels "
            "arrive with the training slice"
        )
    # split() hands over a non-contiguous [B,H,L,D] view of [B,L,H,D]; the
    # kernel takes dense rows, so the wrapper copies (strides are later work).
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    key_bias = _aligned(_key_bias(bias, b, lk, q.device))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq, 1), dtype=torch.float32, device=q.device)
    fn = _kernel_fn(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, lq, lk, 1.0 / (d**0.5),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    FWD_LAUNCHES += 1
    return out, lse


def flash_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, bias)


def flash_attention(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, H, Lk, D]
    v: torch.Tensor,  # [B, H, Lk, D]
    bias: torch.Tensor | None = None,  # [B, 1, 1, Lk] additive key mask
    *,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
) -> torch.Tensor:
    """Drop-in for :func:`.attention.dot_product_attention`; returns O."""
    if dropout_rate > 0.0 and not deterministic:
        raise NotImplementedError(
            "flash attention dropout (the in-kernel hash mask) arrives with "
            "the training slice"
        )
    return flash_forward(q, k, v, bias)[0]
