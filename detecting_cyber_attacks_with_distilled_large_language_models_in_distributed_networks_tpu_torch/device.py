"""Device and dtype policy of the port.

Entry points take ``device`` and resolve it here: the default is the
card, and a machine without CUDA raises instead of falling back, so a
run can never measure or serve on the CPU by accident. Tests pass
``device="cpu"`` explicitly.

Dtypes mirror the JAX package: parameters stay fp32, activations run in
``ModelConfig.compute_dtype`` (bf16 on the card), and LayerNorm and
softmax statistics and the classifier head run in fp32.
"""

from __future__ import annotations

import torch

# fp32 matrix products and convolutions run in full fp32, never TF32:
# the fp32 checks on the card hold the kernels to the JAX package's fp32
# bound, which TF32's ~3 decimal digits would break.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` and ``"cuda"`` mean the card; raises ``RuntimeError`` when
    CUDA is absent. ``"cpu"`` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda|cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; the port runs on the "
            "card unless the caller passes device='cpu'"
        )
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig`` dtype name -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r} ({'|'.join(_DTYPES)})"
        ) from None
