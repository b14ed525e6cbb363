"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and skip without one (a CUDA kernel has
no CPU mode). This file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    flash_attention as flash_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    make_attention_bias,
)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,l", [(1, 128), (8, 128), (3, 40), (2, 200)])
def test_flash_kernel_matches_reference(cuda_device, dtype, atol, b, l):
    g = torch.Generator(device=cuda_device).manual_seed(b * 1000 + l)
    q, k, v = (
        torch.randn(b, 12, l, 64, generator=g, device=cuda_device).to(dtype)
        for _ in range(3)
    )
    mask = (torch.rand(b, l, generator=g, device=cuda_device) > 0.3).int()
    mask[:, 0] = 1
    mask[-1] = 0  # a bucket pad row
    bias = make_attention_bias(mask)
    before = flash_mod.FWD_LAUNCHES
    out, lse = flash_mod.flash_forward(q, k, v, bias)
    torch.cuda.synchronize()
    assert flash_mod.FWD_LAUNCHES == before + 1
    ref, ref_lse = flash_mod.flash_attention_reference(q, k, v, bias)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= atol
    # lse sits near -1e9 on the pad row: compare relative to its size.
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-7)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_do(cuda_device):
    q = torch.randn(1, 2, 16, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_mod.flash_forward(q, q, q)
    q = torch.randn(1, 2, 16, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_mod.flash_forward(q, q, q)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_mod.flash_attention(
            q.detach(), q.detach(), q.detach(), dropout_rate=0.1, deterministic=False
        )
