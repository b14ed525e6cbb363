"""The port's coordinate-keyed dropout (ops/hash_dropout.py) held against
the JAX package's, on the CPU.

* ``hash_keep_mask`` is bit-equal to the JAX one for the same two seed
  words (drawn with ``jax.random.bits``, handed over as numpy), at ranks
  1 to 5, with offsets on axes 0 to 3 (large ones included) and rates
  from 0 to 0.9; both refuse rank 6 with the same message;
* ``hash_dropout`` returns the JAX values bit for bit in fp32 and bf16
  (the divisor ``1 - rate`` in x's dtype);
* the cases of ``tests/test_hash_dropout.py`` re-bound to the port: keep
  rate and determinism, offset slices reproducing the global mask (the
  invariance to the seq slot count), batch-axis offsets giving data
  slots distinct masks, the scale and the identities; and the JAX slow
  case's model-level invariance (the ring forward with dropout on at 1,
  2 and 4 seq slots, and 2 x 2 data x seq slots, identical logits that
  differ from the deterministic ones).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"

jhd = importlib.import_module(JAX_PKG + ".ops.hash_dropout")
phd = importlib.import_module(PORT_PKG + ".ops.hash_dropout")
pcfg = importlib.import_module(PORT_PKG + ".config")
pmodel = importlib.import_module(PORT_PKG + ".models.distilbert")

torch.set_num_threads(1)


def _seed(i=0) -> np.ndarray:
    """Two uint32 seed words from a JAX key, as numpy."""
    return np.asarray(jax.random.bits(jax.random.key(i), (2,), jnp.uint32))


MASKS = [
    ((64,), {}, 0.3),
    ((4, 32, 8), {}, 0.4),
    ((4, 32, 8), {1: 16}, 0.4),
    ((8, 16, 4), {0: 4}, 0.1),
    ((2, 3, 16, 16), {0: 2, 2: 16, 3: 48}, 0.1),
    ((3, 5, 7, 9), {0: 4, 1: 2, 2: 16, 3: 2**31 - 3}, 0.3),
    ((2, 3, 4, 5, 6), {2: 7}, 0.9),
    ((16, 16), {}, 0.0),
]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("case", range(len(MASKS)))
def test_keep_mask_is_bit_equal_to_jax(seed, case):
    shape, offsets, rate = MASKS[case]
    words = _seed(seed)
    want = np.asarray(jhd.hash_keep_mask(jnp.asarray(words), shape, rate, offsets=offsets))
    got = phd.hash_keep_mask(words, shape, rate, offsets=offsets)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    # The seed words as a tensor (what draw_seed_words returns) give the same bits.
    np.testing.assert_array_equal(phd.hash_keep_mask(torch.from_numpy(words.astype(np.int64)), shape, rate,
                                                     offsets=offsets).numpy(), want)


def test_rank_above_five_is_refused_as_in_jax():
    msgs = []
    for fn, words in ((jhd.hash_keep_mask, jnp.asarray(_seed())), (phd.hash_keep_mask, _seed())):
        with pytest.raises(ValueError) as e:
            fn(words, (2,) * 6, 0.1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "hash_keep_mask supports rank <= 5"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_matches_jax(dtype):
    key = jax.random.key(5)
    words = _seed(5)  # what the JAX hash_dropout draws from key 5
    np.testing.assert_array_equal(np.asarray(jax.random.bits(key, (2,), jnp.uint32)), words)
    x = np.random.default_rng(0).normal(size=(4, 8, 16)).astype(np.float32)
    want = jhd.hash_dropout(jnp.asarray(x, dtype), 0.3, key, offsets={1: 8})
    got = phd.hash_dropout(torch.from_numpy(x).to(getattr(torch, dtype)), 0.3, words, offsets={1: 8})
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ------------------------------------------- tests/test_hash_dropout.py
def test_keep_rate_and_determinism():
    m = phd.hash_keep_mask(_seed(), (64, 64), 0.3).numpy()
    np.testing.assert_array_equal(m, phd.hash_keep_mask(_seed(), (64, 64), 0.3).numpy())
    np.testing.assert_allclose(m.mean(), 0.7, atol=0.03)
    assert not np.array_equal(m, phd.hash_keep_mask(_seed(1), (64, 64), 0.3).numpy())
    assert phd.hash_keep_mask(_seed(), (8, 8), 0.0).numpy().all()


def test_offset_slices_reproduce_global_mask():
    full = phd.hash_keep_mask(_seed(), (4, 32, 8), 0.4, offsets={}).numpy()
    for n_shards in (2, 4):
        ls = 32 // n_shards
        parts = [phd.hash_keep_mask(_seed(), (4, ls, 8), 0.4, offsets={1: i * ls}).numpy() for i in range(n_shards)]
        np.testing.assert_array_equal(np.concatenate(parts, axis=1), full)


def test_batch_axis_offsets_give_data_shards_independent_masks():
    full = phd.hash_keep_mask(_seed(), (8, 16, 4), 0.4, offsets={}).numpy()
    top = phd.hash_keep_mask(_seed(), (4, 16, 4), 0.4, offsets={0: 0}).numpy()
    bot = phd.hash_keep_mask(_seed(), (4, 16, 4), 0.4, offsets={0: 4}).numpy()
    np.testing.assert_array_equal(np.concatenate([top, bot], axis=0), full)
    assert not np.array_equal(top, bot)


def test_hash_dropout_scales_and_zeroes():
    x = torch.ones(16, 16)
    y = phd.hash_dropout(x, 0.25, _seed(5)).numpy()
    kept = y > 0
    np.testing.assert_allclose(y[kept], 1.0 / 0.75, rtol=1e-6)
    np.testing.assert_allclose(kept.mean(), 0.75, atol=0.08)
    assert torch.equal(phd.hash_dropout(x, 0.25, _seed(5), deterministic=True), x)
    assert torch.equal(phd.hash_dropout(x, 0.0, _seed(5)), x)


def test_model_seq_dropout_invariance_via_ring():
    """The ring forward with every dropout site on: the same logits at 1,
    2 and 4 seq slots and on 2 x 2 data x seq slots (the JAX slow case's
    check, atol 1e-5), and not the deterministic logits."""
    from torch.func import functional_call

    L = 16
    cfg = pcfg.ModelConfig.tiny(
        max_len=L, max_position_embeddings=L, dropout=0.2, attention_dropout=0.2, head_dropout=0.3,
        attention_impl="ring",
    )
    params = pmodel.init_params(cfg, torch.Generator().manual_seed(0))
    model = pmodel.model_skeleton(cfg)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 200, (4, L))).long()
    mask = torch.ones(4, L, dtype=torch.long)
    cpu = torch.device("cpu")

    def logits_at(data, seq):
        ctx = pmodel.SeqContext(((cpu,) * seq,) * data)
        g = torch.Generator().manual_seed(9)
        return functional_call(model, params, (ids, mask), {"deterministic": False, "generator": g, "seq": ctx}).numpy()

    l1 = logits_at(1, 1)
    for data, seq in ((1, 2), (1, 4), (2, 2)):
        np.testing.assert_allclose(logits_at(data, seq), l1, atol=1e-5, err_msg=f"{data}x{seq}")
    det = functional_call(model, params, (ids, mask)).numpy()
    assert not np.allclose(l1, det, atol=1e-5)
