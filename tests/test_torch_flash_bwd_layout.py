"""The backward's layout contract (K3 + K2) and its dropout coordinates,
held against JAX on the CPU.

* Gradients through the model's own views: q, k and v as views of three
  ``[B, L, H*D]`` projections or chunks of one fused ``[B, L, 3*H*D]``
  product, dO in O's ``[B, L, H, D]`` layout, dropout off and on (the
  same seed words on both sides): dq, dk, dv (read off the projections'
  gradients) and dbias against the JAX flash gradients (Pallas interpret
  mode) at atol 1e-4, tests/test_attention.py's bound.
* ``bwd_dout``, the backward's dO rule: what it takes where it lies, and
  the one dense copy (counted in ``BWD_DO_COPIES``) of what it does not.
* The CPU path returns dq, dk and dv as ``[B, L, H, D]`` storage.
* The backward's keep-mask read-out that chip_smoke.py (and the card
  tests) use to hold K2's and K3's dropout coordinates exactly: built as
  there, through the port's CPU path, dv and dq give the JAX
  ``_keep_mask`` bit for bit; and a bit moved by one column is caught.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops.attention import (
    make_attention_bias as jax_bias,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.ops.flash_attention import (
    _flash as jax_flash_core,
    _keep_mask as jax_keep_mask,
    flash_attention as jax_flash,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    flash_attention as flash_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    make_attention_bias,
)

torch.set_num_threads(1)

GRAD_ATOL = 1e-4
SEED_WORDS = (0xDEADBEEF, 0x9ABCDEF1)


# ------------------------------------- gradients through the model's views
def _heads(t, b, l, h, d):
    """``[B, L, H*D] -> [B, H, L, D]``, a view: the model's ``split``."""
    return t.reshape(b, l, h, d).transpose(1, 2)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_gradients_through_the_models_views_match_jax(fused, rate):
    b, l, h, d = 2, 40, 2, 16
    rng = np.random.default_rng(31)
    parts = [rng.normal(size=(b, l, h * d)).astype(np.float32) for _ in range(3)]
    do = rng.normal(size=(b, h, l, d)).astype(np.float32)
    mask = (rng.random((b, l)) > 0.25).astype(np.int32)
    mask[:, 0] = 1
    mask[-1, :] = 0  # a fully masked row (an eval pad row)

    if fused:
        leaves = [torch.tensor(np.concatenate(parts, axis=-1), requires_grad=True)]
        q, k, v = (_heads(t, b, l, h, d) for t in leaves[0].chunk(3, dim=-1))
    else:
        leaves = [torch.tensor(p, requires_grad=True) for p in parts]
        q, k, v = (_heads(t, b, l, h, d) for t in leaves)
    bias = make_attention_bias(torch.from_numpy(mask)).requires_grad_(True)
    seen = []
    for t in (q, k, v):
        t.register_hook(seen.append)
    kw = {}
    if rate:
        kw = dict(dropout_rate=rate, generator=torch.Generator().manual_seed(5), deterministic=False)
    out = flash_mod.flash_attention(q, k, v, bias, **kw)
    # dO as the model hands it back: a view of O's [B, L, H, D] storage.
    d_out = flash_mod.empty_out(q).copy_(torch.from_numpy(do))
    copies = flash_mod.BWD_DO_COPIES
    out.backward(d_out)
    assert flash_mod.BWD_DO_COPIES == copies
    # The gradients reached the projections as views of [B, L, H, D].
    assert len(seen) == 3 and all(g.transpose(1, 2).is_contiguous() for g in seen)

    if fused:
        grads = [_heads(g, b, l, h, d) for g in leaves[0].grad.chunk(3, dim=-1)]
    else:
        grads = [_heads(t.grad, b, l, h, d) for t in leaves]
    got = [g.numpy() for g in grads] + [bias.grad.numpy()]

    dense = [np.ascontiguousarray(p.reshape(b, l, h, d).transpose(0, 2, 1, 3)) for p in parts]
    args = (*(jnp.asarray(x) for x in dense), jax_bias(jnp.asarray(mask)))
    if rate:
        words = flash_mod.draw_seed_words(torch.Generator().manual_seed(5))
        seed = jnp.asarray(words.numpy().astype(np.uint32)[None, :])

        def fn(q_, k_, v_, b_):
            return jax_flash_core(q_, k_, v_, b_, seed, rate, l, l, True)
    else:
        def fn(q_, k_, v_, b_):
            return jax_flash(q_, k_, v_, b_, block_q=l, block_k=l)
    want = jax.grad(lambda *a: (fn(*a) * jnp.asarray(do)).sum(), argnums=(0, 1, 2, 3))(*args)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL, err_msg=name)


# ------------------------------------------------------- the dO rule
def _q(dtype=torch.bfloat16):
    return torch.zeros(2, 3, 24, 64, dtype=dtype)


@pytest.mark.parametrize(
    "make",
    [
        lambda q: flash_mod.empty_out(q).fill_(1.0),  # the model's: O's layout
        lambda q: torch.ones_like(q).contiguous(),  # dense [B, H, L, D]
    ],
    ids=["o_layout", "dense"],
)
def test_dout_rule_takes_what_the_kernels_read_where_it_lies(make):
    q = _q()
    do = make(q)
    copies = flash_mod.BWD_DO_COPIES
    assert flash_mod.bwd_dout(do, q) is do
    assert flash_mod.BWD_DO_COPIES == copies


@pytest.mark.parametrize(
    "make",
    [
        # the stride-0 grad of out.sum()
        lambda q: torch.ones((), dtype=q.dtype).expand(q.shape),
        # another dtype than q's
        lambda q: torch.ones(q.shape, dtype=torch.float32),
        # rows that do not start 16-byte aligned
        lambda q: torch.ones(*q.shape[:3], 72, dtype=q.dtype)[..., 1:65],
        # a strided last dim
        lambda q: torch.ones(*q.shape[:3], 128, dtype=q.dtype)[..., ::2],
    ],
    ids=["stride0", "dtype", "misaligned", "strided_last_dim"],
)
def test_dout_rule_copies_what_the_kernels_cannot_read_once_and_counts_it(make):
    q = _q()
    do = make(q)
    copies = flash_mod.BWD_DO_COPIES
    got = flash_mod.bwd_dout(do, q)
    assert flash_mod.BWD_DO_COPIES == copies + 1
    assert got is not do and got.dtype == q.dtype and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got.float(), do.float())
    # What the rule returns, the kernels take: the layout check passes.
    flash_mod._row_strides("dO", got)


def test_cpu_path_returns_the_gradients_as_blhd_storage():
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 2, 24, 16)).astype(np.float32)) for _ in range(4))
    mask = np.ones((2, 24), np.int32)
    mask[1, 20:] = 0
    bias = make_attention_bias(torch.from_numpy(mask))
    out, lse = flash_mod.flash_forward(q, k, v, bias)
    got = flash_mod.flash_backward(q, k, v, bias, None, out, lse, do)
    want = flash_mod.flash_backward_reference(q, k, v, bias, None, out, lse, do)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape and g.transpose(1, 2).is_contiguous()
        assert torch.equal(g, w)
    assert torch.equal(got[3], want[3])


# ---------------------------------------------- the backward read-out
@pytest.mark.parametrize("kernel", ["dkdv", "dq"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("live_tile", [0, 1])
def test_backward_readout_is_the_jax_mask(kernel, dtype, rate, live_tile):
    words = torch.tensor(SEED_WORDS, dtype=torch.int64)
    grad = chip_smoke.bwd_readout(dtype, live_tile, kernel, words, rate, "cpu")
    b, h, l = chip_smoke.READOUT
    assert grad.shape == (b, h, l, 64) and grad.dtype == dtype
    g = grad.float().numpy()
    t0 = live_tile * chip_smoke.KEY_TILE
    seed = jnp.asarray(np.array(SEED_WORDS, np.uint32))
    for bi in range(b):
        for hi in range(h):
            if kernel == "dkdv":  # dv[key, d] <-> bit (query t0 + d, key)
                want = np.asarray(jax_keep_mask(seed, bi, hi, t0, 0, 64, l, rate))
                np.testing.assert_array_equal((g[bi, hi] != 0).T.astype(np.float32), want)
            else:  # dq[q, d] <-> bit (query q, key t0 + d), by its sign
                want = np.asarray(jax_keep_mask(seed, bi, hi, 0, t0, l, 64, rate))
                np.testing.assert_array_equal((g[bi, hi] > 0).astype(np.float32), want)
                assert (g[bi, hi] != 0).all()
    # The smoke run's own comparison agrees on the same gradient.
    assert chip_smoke.bwd_readout_mismatches(grad, words, live_tile, rate, kernel) == 0


@pytest.mark.parametrize("kernel", ["dkdv", "dq"])
def test_backward_readout_sees_a_misplaced_bit(kernel):
    """One keep bit moved to the neighbouring column shows as exactly two
    mismatches."""
    words = torch.tensor(SEED_WORDS, dtype=torch.int64)
    grad = chip_smoke.bwd_readout(torch.bfloat16, 1, kernel, words, 0.1, "cpu")
    moved = grad.clone()
    row = moved[1, 2, 77]
    on = (row > 0) if kernel == "dq" else (row != 0)
    col = next(i for i in range(63) if bool(on[i]) != bool(on[i + 1]))
    row[col], row[col + 1] = row[col + 1].clone(), row[col].clone()
    assert chip_smoke.bwd_readout_mismatches(grad, words, 1, 0.1, kernel) == 0
    assert chip_smoke.bwd_readout_mismatches(moved, words, 1, 0.1, kernel) == 2
