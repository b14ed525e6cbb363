"""The port's ring attention (parallel/ring_attention.py) and the model's
ring path held against the JAX package's, on CPU slots.

The JAX side runs as ``tests/test_attention.py`` runs it, on the eight
virtual CPU devices; the port's ring runs over 2, 4 and 8 CPU seq slots
of one process. The bounds are that file's:

* the ring output against the JAX ring (``ring_attention_sharded`` under
  ``shard_map``) and the JAX dot path, with and without a key bias, and
  the one-device ``blockwise_attention_local``: atol 2e-5;
* the gradients of ``sum(out**2)`` in q, k and v: atol 1e-4 (K/V reach
  other slots by a differentiable copy, so their gradients come back);
* attention dropout: the port fed the seed words the JAX ring draws from
  its key gives the JAX ring's output (atol 2e-5), and its own output is
  the same at 1, 2, 4 and 8 slots (atol 1e-5), deterministic per seed,
  not the undropped one;
* a query-dimension bias refused with the JAX message;
* the classifier's ring forward over 2, 4 and 8 seq slots (and 2 x 2 data
  x seq slots) against the JAX dot model and the JAX ring model under
  ``shard_map``: atol 2e-4; its parameter gradients against the JAX dot
  model's: atol 5e-4;
* remat composes with the ring: with dropout on, the gradients with remat
  on are bit-equal to remat off (the recompute redraws the same seed
  words).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P
from torch.func import functional_call

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"

jattn = importlib.import_module(JAX_PKG + ".ops.attention")
jring = importlib.import_module(JAX_PKG + ".parallel.ring_attention")
jmesh = importlib.import_module(JAX_PKG + ".parallel.mesh")
jcfg = importlib.import_module(JAX_PKG + ".config")
jmodel = importlib.import_module(JAX_PKG + ".models.distilbert")
pattn = importlib.import_module(PORT_PKG + ".ops.attention")
pring = importlib.import_module(PORT_PKG + ".parallel.ring_attention")
pmesh = importlib.import_module(PORT_PKG + ".parallel.mesh")
pcfg = importlib.import_module(PORT_PKG + ".config")
pmodel = importlib.import_module(PORT_PKG + ".models.distilbert")
pconvert = importlib.import_module(PORT_PKG + ".models.convert")

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _qkv(rng, b=1, h=2, l=32, d=8):
    return [rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(3)]


def _mask(rng, b=1, l=32):
    mask = (rng.random((b, l)) > 0.2).astype(np.int32)
    mask[:, 0] = 1  # CLS always visible
    return mask


def _seq_mesh(n):
    return pmesh.make_mesh(1, 1, seq=n, device="cpu")


def _jax_ring(q, k, v, bias, n, **kw):
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
    args = [jnp.asarray(t) for t in (q, k, v)] + ([] if bias is None else [jnp.asarray(bias)])
    return jring.ring_attention_sharded(*args, mesh=mesh, axis_name="seq", **kw)


def _port_bias(mask):
    return pattn.make_attention_bias(torch.from_numpy(mask))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_matches_jax_ring_and_dot(eight_devices, n, with_bias):
    rng = np.random.default_rng(n)
    q, k, v = _qkv(rng)
    mask = _mask(rng)
    jbias = jattn.make_attention_bias(jnp.asarray(mask)) if with_bias else None
    ref = np.asarray(jattn.dot_product_attention(*(jnp.asarray(t) for t in (q, k, v)), jbias))
    jr = np.asarray(_jax_ring(q, k, v, None if jbias is None else np.asarray(jbias), n))
    got = pring.ring_attention_sharded(
        *(torch.from_numpy(t) for t in (q, k, v)), _port_bias(mask) if with_bias else None, mesh=_seq_mesh(n)
    ).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, jr, atol=2e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_gradients_match_jax(eight_devices, n):
    rng = np.random.default_rng(10 + n)
    q, k, v = _qkv(rng, l=16 if n < 8 else 32)
    mask = _mask(rng, l=q.shape[2])
    jbias = jattn.make_attention_bias(jnp.asarray(mask))
    jq = [jnp.asarray(t) for t in (q, k, v)]
    g_dot = jax.grad(lambda a, b, c: (jattn.dot_product_attention(a, b, c, jbias) ** 2).sum(), argnums=(0, 1, 2))(*jq)
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
    g_ring = jax.grad(
        lambda a, b, c: (jring.ring_attention_sharded(a, b, c, jbias, mesh=mesh, axis_name="seq") ** 2).sum(),
        argnums=(0, 1, 2),
    )(*jq)
    pt = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = pring.ring_attention_sharded(*pt, _port_bias(mask), mesh=_seq_mesh(n))
    grads = torch.autograd.grad((out**2).sum(), pt)
    for name, g, gd, gr in zip("qkv", grads, g_dot, g_ring):
        np.testing.assert_allclose(g.numpy(), np.asarray(gd), atol=1e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(gr), atol=1e-4, err_msg=name)


def test_blockwise_local_matches_jax_and_ring(eight_devices):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng)
    mask = _mask(rng)
    jbias = jattn.make_attention_bias(jnp.asarray(mask))
    jq = [jnp.asarray(t) for t in (q, k, v)]
    pt = [torch.from_numpy(t) for t in (q, k, v)]
    got = pring.blockwise_attention_local(*pt, _port_bias(mask), n_chunks=4).numpy()
    np.testing.assert_allclose(got, np.asarray(jring.blockwise_attention_local(*jq, jbias, n_chunks=4)), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jattn.dot_product_attention(*jq, jbias)), atol=2e-5)
    ring = pring.ring_attention_sharded(*pt, _port_bias(mask), mesh=_seq_mesh(4)).numpy()
    np.testing.assert_allclose(got, ring, atol=2e-6)
    nb = pring.blockwise_attention_local(*pt, n_chunks=8).numpy()
    np.testing.assert_allclose(nb, np.asarray(jattn.dot_product_attention(*jq, None)), atol=2e-5)
    with pytest.raises(ValueError, match="n_chunks"):
        pring.blockwise_attention_local(*pt, n_chunks=5)


def test_ring_rejects_query_bias_as_jax(eight_devices):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, l=16)
    causal = np.zeros((1, 1, 16, 16), np.float32)
    msgs = []
    with pytest.raises(ValueError) as e:
        _jax_ring(q, k, v, causal, 2)
    msgs.append(str(e.value))
    with pytest.raises(ValueError) as e:
        pring.ring_attention_sharded(*(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(causal),
                                     mesh=_seq_mesh(2))
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "key-position bias" in msgs[0]


def _port_ring_dropout(q, k, v, n, words):
    """The port's ring over n CPU slots with explicit seed words."""
    L = q.shape[2] // n
    chunks = [[torch.from_numpy(t[:, :, i * L:(i + 1) * L]) for i in range(n)] for t in (q, k, v)]
    outs = pring.ring_attention(*chunks, dropout_rate=0.3, seed_words=words, deterministic=False)
    return torch.cat(outs, dim=2).numpy()


def test_ring_attention_dropout_matches_jax_and_is_invariant(eight_devices):
    r = np.random.default_rng(0)
    q, k, v = (r.normal(size=(1, 2, 16, 8)).astype(np.float32) for _ in range(3))
    key = jax.random.key(2)
    words = np.asarray(jax.random.bits(key, (2,), jnp.uint32))  # what the JAX ring draws from key
    ports = {n: _port_ring_dropout(q, k, v, n, words) for n in (1, 2, 4, 8)}
    for n in (2, 4):
        jr = np.asarray(_jax_ring(q, k, v, None, n, dropout_rate=0.3, dropout_rng=key, deterministic=False))
        np.testing.assert_allclose(ports[n], jr, atol=2e-5, err_msg=f"n={n}")
    for n in (2, 4, 8):
        np.testing.assert_allclose(ports[n], ports[1], atol=1e-5, err_msg=f"n={n}")
    np.testing.assert_array_equal(_port_ring_dropout(q, k, v, 2, words), ports[2])
    other = np.asarray(jax.random.bits(jax.random.key(3), (2,), jnp.uint32))
    assert not np.allclose(ports[1], _port_ring_dropout(q, k, v, 2, other))
    clean = pring.ring_attention_sharded(*(torch.from_numpy(t) for t in (q, k, v)), mesh=_seq_mesh(2)).numpy()
    assert not np.allclose(clean, ports[1], atol=1e-5)
    # The wrapper draws its words from a generator: deterministic per seed.
    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    pt = [torch.from_numpy(t) for t in (q, k, v)]
    a = pring.ring_attention_sharded(*pt, mesh=_seq_mesh(2), dropout_rate=0.3, generator=g(), deterministic=False)
    b = pring.ring_attention_sharded(*pt, mesh=_seq_mesh(4), dropout_rate=0.3, generator=g(), deterministic=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="generator"):
        pring.ring_attention_sharded(*pt, mesh=_seq_mesh(2), dropout_rate=0.3, deterministic=False)


# --------------------------------------------------------------- the model
L_MODEL = 64


@pytest.fixture(scope="module")
def model_setup():
    base = jcfg.ModelConfig.tiny(attention_dropout=0.0, max_len=L_MODEL, max_position_embeddings=L_MODEL)
    tree = jmodel.init_params(jmodel.DDoSClassifier(base), base, jax.random.key(0))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, base.vocab_size, (4, L_MODEL)).astype(np.int32)
    mask = (rng.random((4, L_MODEL)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    labels = rng.integers(0, 2, 4).astype(np.int32)
    return base, tree, ids, mask, labels


def _port_ring_model(base):
    import dataclasses

    cfg = pcfg.ModelConfig(**dataclasses.asdict(base)).replace(attention_impl="ring")
    return cfg, pmodel.model_skeleton(cfg)


def _ctx(data, seq):
    return pmodel.SeqContext(((CPU,) * seq,) * data)


def test_ring_model_forward_matches_jax(model_setup, eight_devices):
    base, tree, ids, mask, _ = model_setup
    ref = np.asarray(jmodel.DDoSClassifier(base).apply({"params": tree}, jnp.asarray(ids), jnp.asarray(mask), True))
    ring_cfg = base.replace(attention_impl="ring", ring_axis="seq")
    jmr = jmodel.DDoSClassifier(ring_cfg)
    jr = np.asarray(jmesh.shard_map(
        lambda p, i, m: jmr.apply({"params": p}, i, m, True),
        mesh=JaxMesh(np.array(jax.devices()[:2]), ("seq",)),
        in_specs=(P(), P(None, "seq"), P(None, "seq")), out_specs=P(),
    )(tree, jnp.asarray(ids), jnp.asarray(mask)))
    _, model = _port_ring_model(base)
    params = pconvert.params_from_jax(jax.tree.map(np.asarray, tree))
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    with torch.no_grad():
        for data, seq in ((1, 2), (1, 4), (1, 8), (2, 2)):
            got = functional_call(model, params, (t_ids, t_mask), {"seq": _ctx(data, seq)}).numpy()
            np.testing.assert_allclose(got, ref, atol=2e-4, err_msg=f"{data}x{seq}")
            np.testing.assert_allclose(got, jr, atol=2e-4, err_msg=f"{data}x{seq}")
        # Outside a seq context "ring" is the dot path.
        np.testing.assert_allclose(functional_call(model, params, (t_ids, t_mask)).numpy(), ref, atol=2e-5)
    with pytest.raises(ValueError, match="split"):
        functional_call(model, params, (t_ids, t_mask), {"seq": _ctx(3, 1)})


@pytest.mark.parametrize("seq", [2, 4])
def test_ring_model_gradients_match_jax(model_setup, seq):
    base, tree, ids, mask, labels = model_setup

    def loss_dot(p):
        lg = jmodel.DDoSClassifier(base).apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask), True)
        return optax.softmax_cross_entropy_with_integer_labels(lg, jnp.asarray(labels)).mean()

    want = {k: v for k, v in pconvert.flatten_tree(jax.tree.map(np.asarray, jax.grad(loss_dot)(tree))).items()}
    _, model = _port_ring_model(base)
    params = {n: t.requires_grad_(True) for n, t in pconvert.params_from_jax(jax.tree.map(np.asarray, tree)).items()}
    logits = functional_call(model, params, (torch.from_numpy(ids).long(), torch.from_numpy(mask).long()),
                             {"seq": _ctx(1, seq)})
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels).long())
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
    got = pconvert.flatten_tree(pconvert.params_to_jax(grads))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-4, err_msg=k)


def test_remat_composes_with_the_ring():
    """Dropout on everywhere, 2 x 2 slots: remat on replays the block's
    generator, so the gradients are bit-equal to remat off and the
    caller's generator ends where it would."""
    L = 16
    cfg = pcfg.ModelConfig.tiny(max_len=L, max_position_embeddings=L, dropout=0.2, attention_dropout=0.2,
                                head_dropout=0.3, attention_impl="ring")
    params = pmodel.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(1, 200, (4, L))).long()
    mask = torch.ones(4, L, dtype=torch.long)
    labels = torch.tensor([0, 1, 1, 0])
    out = []
    for remat in (False, True):
        model = pmodel.model_skeleton(cfg.replace(remat=remat))
        leaves = {n: t.clone().requires_grad_(True) for n, t in params.items()}
        g = torch.Generator().manual_seed(3)
        logits = functional_call(model, leaves, (ids, mask), {"deterministic": False, "generator": g,
                                                              "seq": _ctx(2, 2)})
        loss = torch.nn.functional.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out.append((loss.detach(), grads, torch.randint(0, 2**31, (1,), generator=g)))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][2], out[1][2])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
