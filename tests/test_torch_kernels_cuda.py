"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and skip without one (a CUDA kernel has
no CPU mode). This file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Bounds. K1: fp32 atol 2e-5 (the JAX flash-vs-dot bound), bf16 atol 2e-2
(p and O each take one bf16 rounding). K2/K3: fp32 atol 1e-4 (the JAX
flash gradient bound, tests/test_attention.py); bf16 atol 1e-5 + rtol
8e-3 (both sides compute in fp32 from the same bf16 inputs and round the
result once, so they may differ by one bf16 ulp, at most 2^-7 = 7.8e-3
relative; atol covers values near zero); dbias atol 1e-3 in both (an
fp32 sum over H·Lq terms taken in another order). K4 (the fold): no
tolerance at all, ``array_equal`` with its plain version on the card and
with numpy's ``acc += float32(w) * x`` on the host, subnormals included.
"""

import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    flash_attention as flash_mod,
    fold as fold_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    make_attention_bias,
)

BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 8e-3)}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, b, l, dtype, seed, h=12):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (
        torch.randn(b, h, l, 64, generator=g, device=device).to(dtype)
        for _ in range(4)
    )
    mask = (torch.rand(b, l, generator=g, device=device) > 0.3).int()
    mask[:, 0] = 1
    mask[-1] = 0  # a bucket pad row
    words = torch.randint(0, 2**32, (2,), generator=g, device=device, dtype=torch.int64)
    return q, k, v, do, make_attention_bias(mask), words


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,l", [(1, 128), (8, 128), (3, 40), (2, 200)])
def test_flash_kernel_matches_reference(cuda_device, dtype, atol, b, l):
    q, k, v, _, bias, _ = _inputs(cuda_device, b, l, dtype, b * 1000 + l)
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
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,l,rate", [(16, 128, 0.1), (3, 40, 0.3), (2, 200, 0.1)])
def test_flash_kernel_dropout_matches_reference(cuda_device, dtype, atol, b, l, rate):
    q, k, v, _, bias, words = _inputs(cuda_device, b, l, dtype, 7 * l + b)
    before = (flash_mod.FWD_LAUNCHES, flash_mod.FWD_DROPOUT_LAUNCHES)
    out, lse = flash_mod.flash_forward(q, k, v, bias, seed=words, rate=rate)
    torch.cuda.synchronize()
    assert (flash_mod.FWD_LAUNCHES, flash_mod.FWD_DROPOUT_LAUNCHES) == (before[0], before[1] + 1)
    ref, ref_lse = flash_mod.flash_attention_reference(q, k, v, bias, seed=words, rate=rate)
    assert (out.float() - ref.float()).abs().max().item() <= atol
    # Dropout leaves the softmax statistics alone.
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-7)
    plain, _ = flash_mod.flash_forward(q, k, v, bias)
    assert (plain.float() - out.float()).abs().max().item() > atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,rate", [(16, 128, 0.0), (16, 128, 0.1), (3, 40, 0.3), (2, 200, 0.1)])
def test_flash_backward_kernels_match_reference(cuda_device, dtype, b, l, rate):
    q, k, v, do, bias, words = _inputs(cuda_device, b, l, dtype, 11 * l + b)
    seed = words if rate else None
    out, lse = flash_mod.flash_forward(q, k, v, bias, seed=seed, rate=rate)
    k2, k3 = flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES
    got = flash_mod.flash_backward(q, k, v, bias, seed, out, lse, do, rate=rate)
    torch.cuda.synchronize()
    assert (flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES) == (k2 + 1, k3 + 1)
    want = flash_mod.flash_backward_reference(q, k, v, bias, seed, out, lse, do, rate=rate)
    atol, rtol = BWD_TOL[dtype]
    for name, a, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.dtype == dtype and torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), w.float(), atol=atol, rtol=rtol, msg=name)
    torch.testing.assert_close(got[3], want[3], atol=1e-3, rtol=0.0)
    # No atomics: the same inputs give the same bits.
    again = flash_mod.flash_backward(q, k, v, bias, seed, out, lse, do, rate=rate)
    for a, w in zip(got, again):
        assert torch.equal(a, w)


@pytest.mark.cuda
def test_flash_attention_autograd_runs_the_kernels(cuda_device):
    q, k, v, do, bias, _ = _inputs(cuda_device, 4, 128, torch.bfloat16, 5)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    g = torch.Generator(device=cuda_device).manual_seed(3)
    counts = (flash_mod.FWD_DROPOUT_LAUNCHES, flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES)
    out = flash_mod.flash_attention(
        q, k, v, bias, dropout_rate=0.1, generator=g, deterministic=False
    )
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_mod.FWD_DROPOUT_LAUNCHES, flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES) == tuple(
        c + 1 for c in counts
    )
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_do(cuda_device):
    q = torch.randn(1, 2, 16, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_mod.flash_forward(q, q, q)
    q = torch.randn(1, 2, 16, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_mod.flash_forward(q, q, q)
    with pytest.raises(ValueError, match="generator"):
        flash_mod.flash_attention(
            q.detach(), q.detach(), q.detach(), dropout_rate=0.1, deterministic=False
        )


def _numpy_fold(leaves, weights):
    """The JAX package's ``fold_naive``: ``acc += float32(w) * leaf``."""
    acc = np.zeros(leaves[0].shape, np.float32)
    for a, w in zip(leaves, weights):
        acc += np.float32(w) * a
    return acc


def _fold_inputs(k, n, seed, subnormal=False):
    rng = np.random.default_rng(seed)
    if subnormal:
        leaves = [(rng.choice([-1.0, 1.0], size=n) * 1e-40).astype(np.float32) for _ in range(k)]
    else:
        leaves = [
            (rng.normal(size=n) * 10.0 ** rng.integers(-4, 5)).astype(np.float32) for _ in range(k)
        ]
    weights = np.asarray(rng.random(k) + 0.05, np.float32)
    return leaves, weights


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("n,subnormal", [(1, False), (3, False), (768, False), (32769, False), (4099, True), (4100, True)])
def test_fold_kernel_is_bit_exact(cuda_device, k, n, subnormal):
    leaves, weights = _fold_inputs(k, n, seed=k * 100003 + n, subnormal=subnormal)
    x = torch.from_numpy(np.stack(leaves)).to(cuda_device)
    w = torch.from_numpy(weights).to(cuda_device)
    before = fold_mod.FOLD_LAUNCHES
    got = fold_mod.fold_stacked(x, w)
    torch.cuda.synchronize()
    assert fold_mod.FOLD_LAUNCHES == before + 1
    want = _numpy_fold(leaves, weights)
    assert torch.equal(got, fold_mod.fold_reference(list(x), w))
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if subnormal:
        assert np.any((want != 0) & (np.abs(want) < np.finfo(np.float32).tiny))
    # Same inputs, same bits.
    assert torch.equal(fold_mod.fold_stacked(x, w), got)


@pytest.mark.cuda
def test_fold_ordered_on_the_card_launches_once_per_leaf(cuda_device):
    leaves, weights = _fold_inputs(3, 999, seed=7)
    shaped = [a.reshape(27, 37) for a in leaves]
    times: dict = {}
    before = fold_mod.FOLD_LAUNCHES
    got = fold_mod.fold_ordered(shaped, weights, device=cuda_device, times=times)
    assert fold_mod.FOLD_LAUNCHES == before + 1
    assert got.shape == (27, 37) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _numpy_fold(shaped, weights))
    assert set(times) == {"h2d_ms", "kernel_ms", "d2h_ms"} and all(v >= 0 for v in times.values())
