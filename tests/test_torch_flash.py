"""The port's flash attention held against the JAX package's on the CPU.

The JAX flash kernel runs as its own tests run it off-TPU (Pallas
interpret mode); the port's CPU path is its plain PyTorch version, the
same function the CUDA kernel is held against on the card. Bound: the
JAX flash-vs-dot tests' fp32 atol 2e-5 (tests/test_attention.py).

The kernel itself needs the card: tests/test_torch_kernels_cuda.py runs
it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops.attention import (
    dot_product_attention as jax_dot,
    make_attention_bias as jax_bias,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops.flash_attention import (
    _flash_forward as jax_flash_forward,
    flash_attention as jax_flash,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    flash_attention as flash_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    dot_product_attention,
    make_attention_bias,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_forward,
)

torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(seed, b=2, h=2, l=64, d=16, fully_masked_row=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(3))
    mask = (rng.random((b, l)) > 0.2).astype(np.int32)
    mask[:, 0] = 1  # CLS always visible
    if fully_masked_row:
        mask[-1, :] = 0  # a bucket pad row
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize(
    "l,block,with_bias", [(64, 16, True), (32, 8, False), (64, 8, True)]
)
def test_reference_matches_jax_flash_and_dot(l, block, with_bias):
    q, k, v, mask = _inputs(1, l=l)
    jb = jax_bias(jnp.asarray(mask)) if with_bias else None
    tb = make_attention_bias(torch.from_numpy(mask)) if with_bias else None
    got, _ = flash_attention_reference(*_t(q, k, v), tb)
    want_flash = jax_flash(*_j(q, k, v), jb, block_q=block, block_k=block)
    want_dot = jax_dot(*_j(q, k, v), jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_flash), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_dot), atol=ATOL)
    # The port's own dot path and the wrapper on a CPU tensor agree too.
    np.testing.assert_allclose(
        dot_product_attention(*_t(q, k, v), tb).numpy(), np.asarray(want_dot), atol=ATOL
    )
    np.testing.assert_allclose(
        flash_attention(*_t(q, k, v), tb).numpy(), got.numpy(), atol=0
    )


@pytest.mark.parametrize("fully_masked_row", [False, True])
def test_lse_and_masked_rows_match_jax_kernel(fully_masked_row):
    q, k, v, mask = _inputs(2, fully_masked_row=fully_masked_row)
    out, lse = flash_attention_reference(
        *_t(q, k, v), make_attention_bias(torch.from_numpy(mask))
    )
    want_out, want_lse = jax_flash_forward(
        *_j(q, k, v),
        jax_bias(jnp.asarray(mask)),
        jnp.zeros((1, 2), jnp.uint32),
        rate=0.0,
        block_q=16,
        block_k=16,
        interpret=True,
    )
    assert lse.shape == tuple(want_lse.shape) and lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL)


def test_make_attention_bias_matches_jax():
    mask = _inputs(3, fully_masked_row=True)[3]
    got = make_attention_bias(torch.from_numpy(mask))
    want = np.asarray(jax_bias(jnp.asarray(mask)))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_full_bias_raises():
    q, k, v, _ = _inputs(4, l=16)
    with pytest.raises(ValueError, match="key-position bias"):
        flash_attention(*_t(q, k, v), torch.zeros(2, 2, 16, 16))


def test_ragged_length_matches_jax_dot():
    """L=40 is no multiple of the 64-key block: the last block is short.
    (The JAX wrapper sends such lengths to its dot path.)"""
    q, k, v, mask = _inputs(5, l=40)
    got = flash_attention(*_t(q, k, v), make_attention_bias(torch.from_numpy(mask)))
    want = jax_dot(*_j(q, k, v), jax_bias(jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_inputs_round_p_like_the_kernel():
    """bf16 inputs: O comes back bf16 and lse fp32, and p is rounded to
    bf16 before p·v (the JAX kernel's ``p.astype(v.dtype)``)."""
    q, k, v, mask = _inputs(6)
    qb, kb, vb = (x.to(torch.bfloat16) for x in _t(q, k, v))
    bias = make_attention_bias(torch.from_numpy(mask))
    out, lse = flash_forward(qb, kb, vb, bias)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # fp32 reference on the bf16-rounded values: p rounding is the only
    # difference, a bf16 ulp of the weights at most.
    ref, ref_lse = flash_attention_reference(qb.float(), kb.float(), vb.float(), bias)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


def test_dropout_needs_a_generator_and_deterministic_calls_ignore_the_rate():
    """tests/test_torch_dropout.py holds the dropout mask against JAX;
    here: train mode needs a generator, and deterministic calls ignore the
    rate, as in the JAX wrapper."""
    q, k, v, _ = _inputs(7, l=16)
    with pytest.raises(ValueError, match="generator"):
        flash_attention(*_t(q, k, v), dropout_rate=0.1, deterministic=False)
    plain = flash_attention(*_t(q, k, v))
    same = flash_attention(*_t(q, k, v), dropout_rate=0.1, deterministic=True)
    assert torch.equal(plain, same)
    dropped = flash_attention(
        *_t(q, k, v), dropout_rate=0.1, deterministic=False,
        generator=torch.Generator().manual_seed(0),
    )
    assert not torch.equal(plain, dropped)


def test_cpu_path_counts_no_launches():
    counters = ("FWD_LAUNCHES", "FWD_DROPOUT_LAUNCHES", "DKDV_LAUNCHES", "DQ_LAUNCHES")
    before = [getattr(flash_mod, c) for c in counters]
    q, k, v, _ = _inputs(8, l=16)
    flash_forward(*_t(q, k, v))
    tq = torch.from_numpy(q).requires_grad_(True)
    flash_attention(tq, *_t(k, v)).sum().backward()
    flash_attention(
        tq, *_t(k, v), dropout_rate=0.1, deterministic=False,
        generator=torch.Generator().manual_seed(0),
    ).sum().backward()
    assert tq.grad is not None
    assert [getattr(flash_mod, c) for c in counters] == before


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The CUDA build names its failure; nothing falls back to the plain
    version. The library is keyed by a hash of the source and flags."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
        _build,
    )

    path = _build.library_path("flash_fwd")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.library_path("flash_fwd") != path
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
