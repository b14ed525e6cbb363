"""The port's attention dropout held against the JAX package's, on the CPU.

* The flash kernels' keep mask: ``keep_mask_reference`` (the plain version
  of ``csrc/keep_mask.cuh``) is bit-exact with the JAX ``_keep_mask`` on
  the same seed words — the bound of the JAX hash-mask tests
  (tests/test_hash_dropout.py: exact equality).
* The dot path and the model's other dropout sites draw from an explicit
  ``torch.Generator``: the same distribution as the JAX path, not its bits
  (JAX's keys cannot be reproduced in torch). So they are held to the
  keep rate and to determinism in the generator's seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops.flash_attention import (
    _keep_mask as jax_keep_mask,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    build_model,
    init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    dot_product_attention,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.flash_attention import (
    draw_seed_words,
    keep_mask_reference,
    keep_threshold,
)

torch.set_num_threads(1)

SEEDS = [(0, 0), (0xDEADBEEF, 0x9ABCDEF1), (2**32 - 1, 2**31 + 7), (123456789, 3_000_000_000)]


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("b,h,q0,k0", [(0, 0, 0, 0), (3, 11, 64, 128), (15, 5, 200, 40)])
def test_keep_mask_is_bit_exact_with_jax(rate, seed, b, h, q0, k0):
    want = np.asarray(
        jax_keep_mask(jnp.asarray(np.array(seed, np.uint32)), b, h, q0, k0, 24, 40, rate)
    )
    got = keep_mask_reference(seed, b, h, q0, k0, 24, 40, rate)
    assert got.dtype == torch.float32 and got.shape == (24, 40)
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_mask_rate_zero_keeps_everything_and_rate_sets_the_share():
    assert keep_threshold(0.0) == 0
    assert keep_mask_reference(SEEDS[1], 1, 2, 0, 0, 16, 16, 0.0).all()
    m = keep_mask_reference(SEEDS[2], 0, 0, 0, 0, 256, 256, 0.3)
    assert abs(float(m.mean()) - 0.7) < 0.01
    # A seed word as a tensor (the wrapper's form) gives the same mask.
    t = torch.tensor(SEEDS[2], dtype=torch.int64)
    assert torch.equal(keep_mask_reference(t, 0, 0, 0, 0, 256, 256, 0.3), m)
    # Python's round half to even, as in the JAX expression.
    assert keep_threshold(0.5) == 2**31 and keep_threshold(1.0) == 2**32 - 1


def test_seed_words_come_from_the_generator():
    g = torch.Generator().manual_seed(5)
    a = draw_seed_words(g)
    assert a.dtype == torch.int64 and a.shape == (2,)
    assert ((a >= 0) & (a < 2**32)).all()
    assert torch.equal(a, draw_seed_words(torch.Generator().manual_seed(5)))
    assert not torch.equal(a, draw_seed_words(g))


def _weights_through_dot(rate, seed):
    """Attention weights as the output: v is the identity (D = Lk)."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.normal(size=(2, 4, 64, 64)).astype(np.float32)) for _ in range(2))
    v = torch.eye(64).expand(2, 4, 64, 64)
    g = None if seed is None else torch.Generator().manual_seed(seed)
    return dot_product_attention(
        q, k, v, dropout_rate=rate, generator=g, deterministic=seed is None
    )


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dot_dropout_keeps_one_minus_rate_and_is_seed_deterministic(rate):
    plain = _weights_through_dot(rate, None)
    dropped = _weights_through_dot(rate, 11)
    kept = dropped != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    # Kept weights are scaled by 1/(1-rate); dropped ones are exactly 0.
    torch.testing.assert_close(dropped[kept], plain[kept] / (1 - rate), rtol=1e-6, atol=0)
    assert torch.equal(dropped, _weights_through_dot(rate, 11))
    assert not torch.equal(dropped, _weights_through_dot(rate, 12))
    with pytest.raises(ValueError, match="generator"):
        dot_product_attention(*(torch.zeros(1, 1, 4, 4),) * 3, dropout_rate=rate, deterministic=False)


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_train_mode_forward_is_generator_deterministic(impl):
    cfg = ModelConfig.tiny(attention_impl=impl)
    model = build_model(cfg, init_params(cfg, torch.Generator().manual_seed(0)), torch.device("cpu"))
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(5, cfg.vocab_size, (4, cfg.max_len)).astype(np.int32))
    mask = torch.ones(4, cfg.max_len, dtype=torch.int32)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return model(ids, mask, deterministic=False, generator=g)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), model(ids, mask))
    with pytest.raises(ValueError, match="generator"):
        model(ids, mask, deterministic=False)
