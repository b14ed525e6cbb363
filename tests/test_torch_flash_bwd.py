"""The port's flash backward (FlashAttention, K2 + K3's plain version)
held against the JAX package's, on the CPU.

The JAX flash runs as its own tests run it off-TPU (Pallas interpret
mode); the port's CPU path is the plain PyTorch version of K1, K2 and K3,
the same functions the CUDA kernels are held against on the card.

Bounds: gradients atol 1e-4 and the forward atol 2e-5, the JAX flash
tests' bounds (tests/test_attention.py). With dropout on, the JAX
``_flash`` gets the very seed words the port drew from its generator, so
both apply the same keep mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops.attention import (
    make_attention_bias as jax_bias,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops.flash_attention import (
    _flash as jax_flash_core,
    flash_attention as jax_flash,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    flash_attention as flash_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    make_attention_bias,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.flash_attention import (
    FlashAttention,
    draw_seed_words,
    flash_attention,
)

torch.set_num_threads(1)

FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4

# (b, h, l, d): L=40 and L=72 are no multiples of the port's 64-row tile.
SHAPES = [(2, 2, 40, 16), (1, 3, 72, 8), (2, 2, 64, 16)]


def _inputs(seed, b, h, l, d):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(4))
    mask = (rng.random((b, l)) > 0.25).astype(np.int32)
    mask[:, 0] = 1
    mask[-1, :] = 0  # a fully masked row (an eval pad row)
    return q, k, v, do, mask


def _port(q, k, v, do, mask, **kw):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    bias = make_attention_bias(torch.from_numpy(mask)).requires_grad_(True)
    out = flash_attention(tq, tk, tv, bias, **kw)
    (out * torch.from_numpy(do)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv, bias)]


def _jax_grads(fn, q, k, v, do, mask):
    args = (*(jnp.asarray(x) for x in (q, k, v)), jax_bias(jnp.asarray(mask)))
    out = fn(*args)
    grads = jax.grad(lambda *a: (fn(*a) * jnp.asarray(do)).sum(), argnums=(0, 1, 2, 3))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax_with_dropout_off(shape):
    q, k, v, do, mask = _inputs(1, *shape)
    l = shape[2]
    out, grads = _port(q, k, v, do, mask)
    want_out, want = _jax_grads(
        lambda *a: jax_flash(*a, block_q=l, block_k=l), q, k, v, do, mask
    )
    np.testing.assert_allclose(out, want_out, atol=FWD_ATOL)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_forward_and_gradients_match_jax_with_dropout_on(rate, shape):
    q, k, v, do, mask = _inputs(2, *shape)
    l = shape[2]
    g = torch.Generator().manual_seed(17)
    # The words the wrapper will draw: the same draw from a twin generator.
    words = draw_seed_words(torch.Generator().manual_seed(17))
    out, grads = _port(q, k, v, do, mask, dropout_rate=rate, generator=g, deterministic=False)
    seed = jnp.asarray(words.numpy().astype(np.uint32)[None, :])
    want_out, want = _jax_grads(
        lambda q_, k_, v_, b_: jax_flash_core(q_, k_, v_, b_, seed, rate, l, l, True),
        q, k, v, do, mask,
    )
    np.testing.assert_allclose(out, want_out, atol=FWD_ATOL)
    for name, gr, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
        np.testing.assert_allclose(gr, w, atol=GRAD_ATOL, err_msg=name)
    # The mask really dropped something: without it the output differs.
    plain, _ = _port(q, k, v, do, mask)
    assert np.abs(plain - out).max() > 10 * FWD_ATOL


def test_bias_gradient_only_when_asked_and_plain_version_splits():
    q, k, v, do, mask = _inputs(3, 2, 2, 40, 16)
    tq = torch.tensor(q, requires_grad=True)
    bias = make_attention_bias(torch.from_numpy(mask))  # no grad wanted
    out = FlashAttention.apply(tq, torch.tensor(k), torch.tensor(v), bias, None, 0.0)
    out.backward(torch.from_numpy(do))
    assert tq.grad is not None and bias.grad is None
    # K2's and K3's plain versions compose to the full plain backward.
    words = torch.tensor([5, 2**32 - 5])
    args = (*(torch.from_numpy(x) for x in (q, k, v)), bias, words)
    o, lse = flash_mod.flash_forward(*args[:4], seed=words, rate=0.2)
    dq, dk, dv, dbias = flash_mod.flash_backward(*args, o, lse, torch.from_numpy(do), rate=0.2)
    dk2, dv2, db_h = flash_mod.flash_dkdv_reference(*args, o, lse, torch.from_numpy(do), rate=0.2)
    dq3 = flash_mod.flash_dq_reference(*args, o, lse, torch.from_numpy(do), rate=0.2)
    assert torch.equal(dq, dq3) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dbias, db_h.sum(1)[:, None, None, :])


def test_full_bias_raises():
    q, k, v, _, _ = _inputs(4, 2, 2, 16, 8)
    tq = torch.tensor(q, requires_grad=True)
    with pytest.raises(ValueError, match="key-position bias"):
        flash_attention(tq, torch.tensor(k), torch.tensor(v), torch.zeros(2, 2, 16, 16))
    with pytest.raises(ValueError, match="rate"):
        flash_mod.flash_forward(tq.detach(), tq.detach(), tq.detach(), rate=1.0, seed=torch.tensor([1, 2]))
