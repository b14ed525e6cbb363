"""The port's DistilBERT classifier held against the JAX one on the CPU.

Same weights (JAX ``init_params`` carried over by ``params_from_jax``),
same token batch, fp32: the logits must agree to the bound the JAX
package's own parity tests use (tests/test_model.py, atol 2e-5 / rtol
1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm.wire import (
    flatten_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    build_model,
    init_params,
    params_from_jax,
    params_to_jax,
)

torch.set_num_threads(1)


def _batch(cfg, b=3, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32)
    mask = np.ones((b, cfg.max_len), np.int32)
    mask[1, 10:] = 0  # a padded row
    mask[2, :] = 0  # a bucket pad row: every key masked
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("attention_impl", ["dot", "flash"])
@pytest.mark.parametrize("gelu", ["exact", "tanh"])
@pytest.mark.parametrize("fused_qkv", [False, True])
def test_classifier_matches_jax(attention_impl, gelu, fused_qkv):
    kw = dict(attention_impl=attention_impl, gelu=gelu, fused_qkv=fused_qkv)
    jcfg = JaxModelConfig.tiny(**kw)
    cfg = ModelConfig.tiny(**kw)
    params = jax_init_params(JaxClassifier(jcfg), jcfg, jax.random.key(11))
    ids, mask = _batch(cfg)
    want = np.asarray(
        JaxClassifier(jcfg).apply(
            {"params": params}, jnp.asarray(ids), jnp.asarray(mask), True
        )
    )
    model = build_model(cfg, params_from_jax(params), torch.device("cpu"))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_params_round_trip_is_exact():
    cfg = JaxModelConfig.tiny()
    params = jax_init_params(JaxClassifier(cfg), cfg, jax.random.key(3))
    want = flatten_params(params)
    for src in (params, want):  # nested flax dict and its flat form
        back = flatten_params(params_to_jax(params_from_jax(src)))
        assert sorted(back) == sorted(want)
        for key in want:
            a, b = np.asarray(want[key]), back[key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b), key


def test_init_params_fits_the_model_and_is_seeded():
    cfg = ModelConfig.tiny()
    a = init_params(cfg, torch.Generator().manual_seed(0))
    b = init_params(cfg, torch.Generator().manual_seed(0))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    model = build_model(cfg, a, torch.device("cpu"))  # strict load
    assert torch.equal(model.encoder.layer_0.sa_ln.weight, torch.ones(cfg.dim))
    assert model.classifier.weight.shape == (cfg.n_classes, cfg.dim)
    # JAX manifests name the same layout: every key converts.
    assert set(params_from_jax(params_to_jax(a))) == set(a)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        build_model(
            ModelConfig.tiny(attention_impl="ring"), {}, torch.device("cpu")
        )
