"""The Adam update's CPU path and the kernel's argument packing, without
a card.

* CPU leaves take the plain ``_foreach_*`` chain, bit for bit the chain
  ``train/engine.py:adam_update`` ran before the kernel existed (kept
  below as ``_chain_before``), and launch nothing.
* The leaf table the kernel walks (``ops/adam.py``: ``kernel_leaves``,
  ``launch_spans``, ``pack_args``): the float4 flag, split points, the
  fp32 narrowing of each scalar, the chunk prefix, and the struct layout
  against ``csrc/adam.cu``. Then the whole table is walked on the host
  as the kernel walks it (chunk by chunk, leaf found by the prefix) over
  CPU tensors at the addresses packed, and must update every element
  exactly once. (The kernel's rounding against the chain's is the card
  test's: on the host the chain divides where the card's multiplies by a
  reciprocal, and its vectorized sqrt is not always IEEE-rounded.)
* A list the kernel cannot take raises before anything launches.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    _build,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    adam as adam_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    engine,
)

CASES = {
    "plain": {},
    "clip-keeps": dict(max_grad_norm=1e6),
    "clip-scales": dict(max_grad_norm=0.5),
    "weight-decay": dict(weight_decay=0.01),
    "warmup": dict(warmup_steps=5),
    "all": dict(max_grad_norm=0.5, weight_decay=0.01, warmup_steps=5),
}


def _chain_before(cfg, params, mus, nus, grads, count, warmup_step):
    """``engine.adam_update`` as it was written before the kernel."""
    if cfg.max_grad_norm is not None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < cfg.max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * cfg.max_grad_norm) for g in grads]
    torch._foreach_mul_(mus, cfg.b1)
    torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - cfg.b1))
    torch._foreach_mul_(nus, cfg.b2)
    torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - cfg.b2))
    mu_hat = torch._foreach_div(mus, engine.bias_correction(cfg.b1, count))
    nu_hat = torch._foreach_div(nus, engine.bias_correction(cfg.b2, count))
    den = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(den, cfg.eps)
    updates = torch._foreach_div(mu_hat, den)
    if cfg.weight_decay > 0.0:
        torch._foreach_add_(updates, torch._foreach_mul(params, cfg.weight_decay))
    torch._foreach_mul_(updates, -cfg.learning_rate)
    if cfg.warmup_steps > 0:
        torch._foreach_mul_(updates, engine.warmup_factor(warmup_step, cfg.warmup_steps))
    torch._foreach_add_(params, updates)


def _leaves(sizes, seed, offsets=None):
    """(params, mus, nus) over ``sizes``; leaf i starts ``offsets[i]``
    elements into a buffer of its own (one offset per list)."""
    g = torch.Generator().manual_seed(seed)
    out = ([], [], [])
    for i, n in enumerate(sizes):
        off = (0, 0, 0) if offsets is None else offsets[i][:3]
        for k, (lst, scale) in enumerate(zip(out, (1.0, 1e-3, 1e-6))):
            t = torch.randn(n, generator=g) * scale
            if k == 2:
                t = t.abs()
            leaf = torch.empty(n + off[k])[off[k]:]
            leaf.copy_(t)
            lst.append(leaf)
    return out


def _grads(sizes, seed, offsets=None):
    g = torch.Generator().manual_seed(seed)
    out = []
    for i, n in enumerate(sizes):
        off = 0 if offsets is None else offsets[i][3]
        leaf = torch.empty(n + off)[off:]
        leaf.copy_(torch.randn(n, generator=g) * 10.0 ** (i % 5 - 3))
        out.append(leaf)
    return out


def _bits(ts):
    return torch.cat([t.reshape(-1) for t in ts]).view(torch.int32)


def _clone(lists):
    return tuple([t.clone() for t in lst] for lst in lists)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_leaves_take_the_chain_bit_for_bit(case):
    cfg = TrainConfig(learning_rate=1e-3, **CASES[case])
    sizes = [1, 3, 7, 64, 4097, 300]
    ours = _leaves(sizes, seed=1)
    before = _clone(ours)
    launches = adam_mod.ADAM_LAUNCHES
    for count in (1, 2, 3):
        grads = _grads(sizes, seed=10 + count)
        engine.adam_update(cfg, *ours, grads, count, count + 2)
        _chain_before(cfg, *before, grads, count, count + 2)
        for a, b in zip(ours, before):
            assert torch.equal(_bits(a), _bits(b))
    assert adam_mod.ADAM_LAUNCHES == launches


def test_the_table_mirrors_the_kernel_source():
    with open(os.path.join(_build.CSRC_DIR, "adam.cu")) as f:
        src = f.read()
    assert int(re.search(r"kMaxLeaves = (\d+);", src).group(1)) == adam_mod.MAX_LEAVES
    assert re.search(r"kChunk = kThreads \* kVec \* 4;", src)
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    vec = int(re.search(r"kVec = (\d+);", src).group(1))
    assert threads * vec * 4 == adam_mod.CHUNK
    # The C struct's fields, in order, against the ctypes mirror.
    body = re.search(r"struct AdamArgs \{(.*?)\};", src, re.S).group(1)
    c_fields = [name for decl in re.sub(r"//[^\n]*", "", body).split(";") if decl.strip()
                for name in re.findall(r"\*?\s*(\w+)(?:\[kMaxLeaves\])?\s*(?:,|$)", decl.strip())]
    assert c_fields == [name for name, _ in adam_mod.AdamArgs._fields_]
    assert adam_mod.AdamArgs.p.offset == 72  # the source's static_assert
    assert ctypes.sizeof(adam_mod.AdamArgs) <= 32764  # CUDA's parameter space
    assert "adam" in _build.SOURCES and _build.SOURCES["adam"] == "adam.cu"


@pytest.mark.parametrize(
    "addrs,n,vec",
    [
        # All four 16-byte aligned: float4 (the kernel takes the tail).
        ((256, 512, 768, 1024), 10, 1),
        # A shared offset of 4 bytes: scalars.
        ((260, 516, 772, 1028), 10, 0),
        # A shared offset of 12 bytes: scalars.
        ((268, 524, 780, 1036), 2, 0),
        # Only the gradient misaligned: scalars.
        ((256, 512, 768, 1032), 1, 0),
        # Offsets that disagree: scalars.
        ((260, 520, 768, 1024), 9, 0),
    ],
)
def test_kernel_leaves_take_float4_only_where_all_four_are_aligned(addrs, n, vec):
    leaves = adam_mod.kernel_leaves(*[[a] for a in addrs], [n])
    assert [int(x) for x in (leaves.p[0], leaves.m[0], leaves.v[0], leaves.g[0])] == list(addrs)
    assert (len(leaves.n), int(leaves.n[0]), int(leaves.vec[0])) == (1, n, vec)


def test_kernel_leaves_keep_order_and_drop_empty_leaves():
    leaves = adam_mod.kernel_leaves([256, 4100, 8192], [512, 4356, 8448], [768, 4612, 8704], [1024, 4868, 8960], [5, 0, 9])
    assert [int(p) for p in leaves.p] == [256, 8192]
    assert [int(k) for k in leaves.n] == [5, 9]


@pytest.mark.parametrize("count,want", [
    (1, [(0, 1)]),
    (adam_mod.MAX_LEAVES, [(0, adam_mod.MAX_LEAVES)]),
    (adam_mod.MAX_LEAVES + 1, [(0, adam_mod.MAX_LEAVES), (adam_mod.MAX_LEAVES, adam_mod.MAX_LEAVES + 1)]),
    (1031, [(0, 512), (512, 1024), (1024, 1031)]),
])
def test_launch_spans_split_at_the_table_size(count, want):
    assert adam_mod.MAX_LEAVES == 512
    assert adam_mod.launch_spans(count) == want


def test_pack_args_narrows_each_scalar_as_torch_does():
    step = adam_mod.AdamStep(0.9, 0.999, 1e-8, 2e-5, engine.bias_correction(0.9, 3),
                             engine.bias_correction(0.999, 3), weight_decay=0.01, warmup=0.75, max_norm=1.0)
    leaves = adam_mod.kernel_leaves([256, 4096], [512, 8192], [768, 12288], [1024, 16384], [4097, 8192 * 3])
    a = adam_mod.pack_args(step, leaves, 0, 2, g_norm_ptr=4096)
    f32 = np.float32
    # PyTorch narrows the double ``1 - b1`` to fp32 (not 1 - fp32(b1)).
    assert np.float32(a.one_minus_b1) == f32(1 - 0.9) and np.float32(a.one_minus_b2) == f32(1 - 0.999)
    assert np.float32(a.b1) == f32(0.9) and np.float32(a.neg_lr) == f32(-2e-5)
    # The chain's CUDA divide by a scalar multiplies by its reciprocal.
    assert np.float32(a.inv_bc1) == f32(1 / step.bc1) and np.float32(a.inv_bc2) == f32(1 / step.bc2)
    assert np.float32(a.eps) == f32(1e-8)
    assert (a.clip, a.decay, a.warm, a.count, a.g_norm) == (1, 1, 1, 2, 4096)
    assert list(a.n[:2]) == [4097, 8192 * 3] and list(a.chunk_end[:2]) == [2, 8]
    assert list(a.p[:2]) == [256, 4096] and list(a.g[:2]) == [1024, 16384] and list(a.vec[:2]) == [1, 1]
    assert a.p[2] is None and a.n[2] == 0
    off = adam_mod.pack_args(adam_mod.AdamStep(0.9, 0.999, 1e-8, 2e-5, 0.1, 0.001), leaves, 1, 2)
    assert (off.clip, off.decay, off.warm, off.count, off.g_norm) == (0, 0, 0, 1, None)
    assert list(off.p[:1]) == [4096] and list(off.chunk_end[:1]) == [6]
    for start, stop in ((0, 0), (0, adam_mod.MAX_LEAVES + 1)):
        with pytest.raises(ValueError):
            adam_mod.pack_args(step, leaves, start, stop)


def _floats(addr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(addr))


def _update(p, m, v, g, a: adam_mod.AdamArgs, g_norm: float) -> None:
    """The kernel's per-element arithmetic on host arrays, in place: each
    fp32 operation rounded on its own (square roots via fp64, which
    rounds to the IEEE fp32 result)."""
    f = np.float32
    if a.clip and not f(g_norm) < f(a.max_norm):
        g = (g / f(g_norm)) * f(a.max_norm)
    m[:] = m * f(a.b1) + g * f(a.one_minus_b1)
    v[:] = v * f(a.b2) + (g * g) * f(a.one_minus_b2)
    den = np.sqrt((v * f(a.inv_bc2)).astype(np.float64)).astype(np.float32) + f(a.eps)
    u = (m * f(a.inv_bc1)) / den
    if a.decay:
        u = u + p * f(a.weight_decay)
    u = u * f(a.neg_lr)
    if a.warm:
        u = u * f(a.warmup)
    p[:] = p + u


def _walk(a: adam_mod.AdamArgs, g_norm: float) -> None:
    """The kernel's walk of one launch, on the host: every chunk, its
    leaf found by the prefix, updated where the table points."""
    ends = list(a.chunk_end[: a.count])
    for chunk in range(ends[-1]):
        leaf = int(np.searchsorted(ends, chunk, side="right"))
        base = (chunk - (ends[leaf - 1] if leaf else 0)) * adam_mod.CHUNK
        n = min(adam_mod.CHUNK, a.n[leaf] - base)
        p, m, v, g = (_floats(getattr(a, k)[leaf] + 4 * base, n) for k in ("p", "m", "v", "g"))
        _update(p, m, v, g.copy(), a, g_norm)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_packed_table_walked_as_the_kernel_walks_it_updates_every_element_once(case):
    """Over CPU tensors at the packed addresses: the walk must leave each
    leaf as one whole-leaf update leaves its copy, over 3 steps, with
    float4 and scalar leaves and two launches a step."""
    cfg = TrainConfig(learning_rate=1e-3, **CASES[case])
    rng = np.random.default_rng(5)
    sizes = [1, 2, 3, 5, 4095, 4096, 4097, 9000] + [int(s) for s in rng.integers(1, 40, adam_mod.MAX_LEAVES + 3)]
    offsets = [[(0, 0, 0, 0), (1, 1, 1, 1), (3, 3, 3, 3), (1, 2, 3, 0)][i % 4] for i in range(len(sizes))]
    ours = _leaves(sizes, seed=2, offsets=offsets)
    want = [[t.numpy().copy() for t in lst] for lst in ours]
    for count in (1, 2, 3):
        grads = _grads(sizes, seed=20 + count, offsets=offsets)
        step = adam_mod.AdamStep(
            cfg.b1, cfg.b2, cfg.eps, cfg.learning_rate,
            engine.bias_correction(cfg.b1, count), engine.bias_correction(cfg.b2, count),
            weight_decay=cfg.weight_decay,
            warmup=engine.warmup_factor(count, cfg.warmup_steps) if cfg.warmup_steps > 0 else None,
            max_norm=cfg.max_grad_norm,
        )
        g_norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
        leaves = adam_mod.kernel_leaves(*[[t.data_ptr() for t in lst] for lst in (*ours, grads)], sizes)
        assert 0 < sum(leaves.vec) < len(sizes) == len(leaves.n)
        spans = adam_mod.launch_spans(len(leaves.n))
        assert len(spans) == 2
        for start, stop in spans:
            _walk(adam_mod.pack_args(step, leaves, start, stop, g_norm_ptr=1), g_norm)
        whole = adam_mod.pack_args(step, leaves, 0, 1)
        for i, g in enumerate(grads):
            _update(want[0][i], want[1][i], want[2][i], g.numpy(), whole, g_norm)
        for got, exp in zip(ours, want):
            assert np.array_equal(_bits(got).numpy(), np.concatenate(exp).view(np.int32))


@pytest.mark.parametrize("fault,says", [
    ("cpu", "one CUDA device"),
    ("non-contiguous", "contiguous fp32"),
    ("fp64", "contiguous fp32"),
    ("lengths", "differ in length"),
    ("sizes", "differ in size"),
])
def test_the_kernel_refuses_what_it_cannot_take_before_launching(fault, says):
    params = [torch.randn(4, 4) for _ in range(3)]
    mus, nus, grads = ([torch.zeros_like(p) for p in params] for _ in range(3))
    if fault == "non-contiguous":
        grads[1] = grads[1].t()
    elif fault == "fp64":
        mus[0] = mus[0].double()
    elif fault == "lengths":
        grads = grads[:2]
    elif fault == "sizes":
        nus[2] = torch.zeros(15)
    launches = adam_mod.ADAM_LAUNCHES
    with pytest.raises(ValueError, match=says):
        adam_mod.adam_multi_tensor(adam_mod.AdamStep(0.9, 0.999, 1e-8, 1e-3, 0.1, 0.001), params, mus, nus, grads)
    assert adam_mod.ADAM_LAUNCHES == launches


def test_an_adopted_aggregate_hands_the_update_contiguous_leaves(monkeypatch):
    """A received aggregate is a JAX-layout tree whose dense kernels turn
    into transposed views; the state adopted from it must still hand the
    update contiguous leaves, the only ones the card's kernel takes."""
    model = ModelConfig.tiny(vocab_size=100, max_len=16, max_position_embeddings=32)
    trainer = engine.Trainer(model, TrainConfig(learning_rate=1e-3, log_every=0), device="cpu")
    state = trainer.init_state(seed=0)
    state = trainer.adopt_aggregate(state, trainer.host_params(state))
    seen = []

    def spy(step, params, mus, nus, grads, g_norm=None):
        seen.append([t.stride() for lst in (params, mus, nus, grads) for t in lst if not t.is_contiguous()])
        adam_mod.adam(step, params, mus, nus, grads, g_norm)

    monkeypatch.setattr(engine, "adam", spy)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(1, 100, (4, 16)).astype(np.int32),
             "attention_mask": np.ones((4, 16), np.int32), "labels": rng.integers(0, 2, 4).astype(np.int32)}
    trainer.train_step(state, batch)
    assert seen == [[]]
