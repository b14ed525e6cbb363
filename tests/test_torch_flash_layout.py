"""K1's layout contract and its dropout coordinates, held against JAX on
the CPU.

* The keep-mask read-out that chip_smoke.py (and the card tests) use to
  hold K1's dropout coordinates exactly: built as there, through the
  port's CPU path, ``(O != 0)`` equals the JAX ``_keep_mask`` on the same
  seed words bit for bit, so the card check is known to be built right.
* Views: q, k and v as the model hands them over (views of three
  ``[B, L, H*D]`` projections, or the chunks of one fused ``[B, L, 3*H*D]``
  product) give the JAX flash (Pallas interpret mode) and dot results at
  the JAX flash-vs-dot bound, fp32 atol 2e-5 (tests/test_attention.py);
  the model's flash forward through those views gives the JAX model's
  logits at tests/test_torch_model.py's bound (atol 2e-5, rtol 1e-4).
* ``flash_layout`` and ``empty_out``: the strides K1 is handed, what it
  refuses, and O's ``[B, L, H, D]`` storage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops.attention import (
    dot_product_attention as jax_dot,
    make_attention_bias as jax_bias,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops.flash_attention import (
    _keep_mask as jax_keep_mask,
    flash_attention as jax_flash,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    build_model,
    distilbert,
    params_from_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    flash_attention as flash_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    make_attention_bias,
)

torch.set_num_threads(1)

ATOL = 2e-5
SEED_WORDS = (0xDEADBEEF, 0x9ABCDEF1)


# ------------------------------------------------- the keep-mask read-out
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("live_tile", [0, 1])
def test_keep_mask_readout_is_the_jax_mask(dtype, rate, live_tile):
    words = torch.tensor(SEED_WORDS, dtype=torch.int64)
    inputs = chip_smoke.readout_inputs(dtype, live_tile, "cpu")
    out, _ = flash_mod.flash_forward(*inputs, seed=words, rate=rate)
    b, h, lq = chip_smoke.READOUT
    assert out.shape == (b, h, lq, 64) and out.dtype == dtype
    o = out.float().numpy()
    k0 = live_tile * chip_smoke.KEY_TILE
    seed = jnp.asarray(np.array(SEED_WORDS, np.uint32))
    for bi in range(b):
        for hi in range(h):
            want = np.asarray(jax_keep_mask(seed, bi, hi, 0, k0, lq, 64, rate))
            np.testing.assert_array_equal((o[bi, hi] != 0).astype(np.float32), want)
            if rate == 0.5:
                np.testing.assert_array_equal(o[bi, hi] * 32, want)
    # The smoke run's own comparison agrees on the same output.
    assert chip_smoke.readout_mismatches(out, words, live_tile, rate) == 0


def test_keep_mask_readout_sees_a_misplaced_bit():
    """One keep bit moved by one key column is caught (the bf16 bound of
    2e-2 would not catch it: it moves O by 1/(64·0.9) ≈ 0.017)."""
    words = torch.tensor(SEED_WORDS, dtype=torch.int64)
    out, _ = flash_mod.flash_forward(
        *chip_smoke.readout_inputs(torch.bfloat16, 1, "cpu"), seed=words, rate=0.1
    )
    moved = out.clone()
    row = moved[1, 2, 77]
    kept = (row != 0).nonzero().flatten()
    dropped = (row == 0).nonzero().flatten()
    value = row[kept[0]].item()
    row[kept[0]], row[dropped[0]] = 0, value
    assert (moved.float() - out.float()).abs().max().item() <= 2e-2
    assert chip_smoke.readout_mismatches(moved, words, 1, 0.1) == 2


# ------------------------------------------------------------- the views
def _projections(seed, b, l, h, d, fused):
    """q, k, v as numpy [B, H, L, D] and as the model's torch views."""
    rng = np.random.default_rng(seed)
    if fused:
        qkv = rng.normal(size=(b, l, 3 * h * d)).astype(np.float32)
        parts = np.split(qkv, 3, axis=-1)
        views = torch.from_numpy(qkv).chunk(3, dim=-1)
    else:
        parts = [rng.normal(size=(b, l, h * d)).astype(np.float32) for _ in range(3)]
        views = [torch.from_numpy(p) for p in parts]
    split = [t.reshape(b, l, h, d).transpose(1, 2) for t in views]
    dense = [np.ascontiguousarray(p.reshape(b, l, h, d).transpose(0, 2, 1, 3)) for p in parts]
    mask = (rng.random((b, l)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    mask[-1, :] = 0  # a bucket pad row
    return dense, split, mask


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("l,block,with_bias", [(64, 16, True), (32, 8, False)])
def test_views_match_jax_flash_and_dot(fused, l, block, with_bias):
    dense, (q, k, v), mask = _projections(3, 2, l, 2, 16, fused)
    assert not q.is_contiguous()
    jb = jax_bias(jnp.asarray(mask)) if with_bias else None
    tb = make_attention_bias(torch.from_numpy(mask)) if with_bias else None
    got = flash_mod.flash_attention(q, k, v, tb)
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    want_flash = jax_flash(*(jnp.asarray(a) for a in dense), jb, block_q=block, block_k=block)
    want_dot = jax_dot(*(jnp.asarray(a) for a in dense), jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_flash), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_dot), atol=ATOL)
    # Merging the heads back is a view of O's storage.
    merged = got.transpose(1, 2).reshape(2, l, 2 * 16)
    assert merged.data_ptr() == got.data_ptr() and merged._base is not None


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_model_flash_forward_through_views_matches_jax(fused_qkv, monkeypatch):
    kw = dict(attention_impl="flash", fused_qkv=fused_qkv)
    jcfg, cfg = JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    params = jax_init_params(JaxClassifier(jcfg), jcfg, jax.random.key(7))
    rng = np.random.default_rng(9)
    ids = rng.integers(5, cfg.vocab_size, (3, cfg.max_len)).astype(np.int32)
    mask = np.ones((3, cfg.max_len), np.int32)
    mask[1, 12:] = 0
    mask[2, :] = 0  # a bucket pad row
    ids[mask == 0] = 0
    want = np.asarray(
        JaxClassifier(jcfg).apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), True)
    )
    seen = []
    real = distilbert.flash_attention

    def spy(q, k, v, bias, **kwargs):
        out = real(q, k, v, bias, **kwargs)
        seen.append((q, k, v, out))
        return out

    monkeypatch.setattr(distilbert, "flash_attention", spy)
    model = build_model(cfg, params_from_jax(params), torch.device("cpu"))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    assert len(seen) == cfg.n_layers
    for q, k, v, out in seen:
        # The projections' views reached the kernel's wrapper as they are,
        # and O is [B, L, H, D] storage, so the model's merge is a view.
        assert not any(t.is_contiguous() for t in (q, k, v))
        assert q.transpose(1, 2).is_contiguous() or fused_qkv
        assert out.transpose(1, 2).is_contiguous()


# ------------------------------------------------------------ the layout
def test_layout_of_dense_operands_and_of_o():
    q = torch.zeros(2, 3, 40, 64)
    out = flash_mod.empty_out(q)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.transpose(1, 2).is_contiguous() and out.stride() == (40 * 3 * 64, 64, 3 * 64, 1)
    assert flash_mod.flash_layout(q, q, q, out) == (
        (3 * 40 * 64, 40 * 64, 64),
    ) * 3 + ((40 * 3 * 64, 64, 3 * 64),)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_of_the_models_views(dtype):
    b, l, h, d = 2, 16, 4, 64
    sep = torch.zeros(b, l, h * d, dtype=dtype).reshape(b, l, h, d).transpose(1, 2)
    qkv = torch.zeros(b, l, 3 * h * d, dtype=dtype)
    q, k, v = (t.reshape(b, l, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    out = flash_mod.empty_out(q)
    sq, sk, sv, so = flash_mod.flash_layout(sep, k, v, out)
    assert sq == (l * h * d, d, h * d)
    assert sk == sv == (l * 3 * h * d, d, 3 * h * d)
    assert so == (l * h * d, d, h * d)
    assert v.data_ptr() - qkv.data_ptr() == 2 * h * d * qkv.element_size()


def test_layout_of_size_one_and_broadcast_dims():
    """A size-1 dim's stride is never used (0); a broadcast operand's
    stride 0 is taken as it is: every (b, h) reads the same rows."""
    q = torch.zeros(3, 1, 8, 64)
    shared = torch.zeros(1, 1, 8, 64).expand(3, 1, 8, 64)
    assert flash_mod.flash_layout(q, shared, shared, flash_mod.empty_out(q)) == (
        (8 * 64, 0, 64), (0, 0, 64), (0, 0, 64), (8 * 64, 0, 64),
    )


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: torch.zeros(2, 3, 16, 72, dtype=torch.bfloat16)[..., 1:65], "16-byte aligned"),
        (lambda: torch.zeros(2, 3, 16, 128)[..., ::2], "contiguous last dim"),
        # A row stride of 68 bf16 (136 bytes) is no multiple of 16 bytes.
        (lambda: torch.zeros(2, 16, 68, dtype=torch.bfloat16)[..., :64].reshape(2, 16, 1, 64).transpose(1, 2), "16-byte aligned"),
    ],
)
def test_layout_refuses_what_the_kernel_does_not_take(make, match):
    bad = make()
    good = torch.zeros(bad.shape, dtype=bad.dtype)
    with pytest.raises(ValueError, match=match):
        flash_mod.flash_layout(bad, good, good, flash_mod.empty_out(good))
    with pytest.raises(ValueError, match=match):
        flash_mod.flash_layout(good, good, bad, flash_mod.empty_out(good))


def test_cpu_path_returns_o_in_the_kernels_layout():
    _, (q, k, v), mask = _projections(4, 2, 24, 2, 16, True)
    bias = make_attention_bias(torch.from_numpy(mask))
    out, lse = flash_mod.flash_forward(q, k, v, bias)
    ref, ref_lse = flash_mod.flash_attention_reference(q, k, v, bias)
    assert out.transpose(1, 2).is_contiguous() and lse.shape == (2, 2, 24, 1)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
