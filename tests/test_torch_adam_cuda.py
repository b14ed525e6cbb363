"""The multi-tensor Adam kernel (``csrc/adam.cu``) against the plain
``_foreach_*`` chain, on the card.

These tests need an NVIDIA card and skip without one (a CUDA kernel has
no CPU mode). This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_adam_cuda.py

No tolerance: p, mu and nu must be bit-identical to the chain's after
each of 3 consecutive steps, over a ragged leaf set (a 1-element leaf,
sizes that are not multiples of 4, leaves whose pointers share a
misalignment or disagree on it (so scalars throughout), and more leaves
than two launches hold, so the table splits), with the clip off, the clip keeping and the clip
scaling the gradient, weight decay on, and warmup on.
"""

import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    FedConfig,
    ModelConfig,
    TrainConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    adam as adam_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel.mesh import (
    make_host_mesh,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    client_mesh,
    engine,
    federated,
)

CASES = {
    "plain": {},
    "clip-keeps": dict(max_grad_norm=1e6),
    "clip-scales": dict(max_grad_norm=0.5),
    "weight-decay": dict(weight_decay=0.01),
    "warmup": dict(warmup_steps=5),
}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _sizes(rng: np.random.Generator) -> list[int]:
    fixed = [1, 2, 3, 5, 7, 768, 1023, 4095, 4096, 4097, 3 * 4096 + 5, 30522 * 4 + 3]
    return fixed + [int(s) for s in rng.integers(1, 300, 2 * adam_mod.MAX_LEAVES + 7)]


def _leaf(n: int, offset: int, device) -> torch.Tensor:
    """A contiguous fp32 leaf of ``n`` elements starting ``offset``
    elements into a fresh buffer (so 4·offset bytes past a 16-byte
    boundary)."""
    return torch.empty(n + offset, device=device)[offset:]


def _state(device, seed: int):
    """Two identical copies of (params, mus, nus) over the ragged set, and
    the per-leaf offsets of (p, mu, nu, g): aligned, a shared misalignment,
    or four that disagree."""
    rng = np.random.default_rng(seed)
    sizes = _sizes(rng)
    offsets = [(0, 0, 0, 0), (1, 1, 1, 1), (3, 3, 3, 3), (1, 2, 3, 0)]
    layout = [offsets[i % len(offsets)] for i in range(len(sizes))]
    g = torch.Generator(device=device).manual_seed(seed)
    copies = [([], [], []) for _ in range(2)]
    for n, off in zip(sizes, layout):
        p0 = torch.randn(n, generator=g, device=device)
        m0 = torch.randn(n, generator=g, device=device) * 1e-3
        v0 = torch.rand(n, generator=g, device=device) * 1e-6
        for params, mus, nus in copies:
            for lst, src, o in ((params, p0, off[0]), (mus, m0, off[1]), (nus, v0, off[2])):
                leaf = _leaf(n, o, device)
                leaf.copy_(src)
                lst.append(leaf)
    return sizes, layout, copies


def _grads(sizes, layout, device, seed: int) -> list[torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for i, (n, off) in enumerate(zip(sizes, layout)):
        leaf = _leaf(n, off[3], device)
        leaf.copy_(torch.randn(n, generator=g, device=device) * 10.0 ** (i % 5 - 3))
        out.append(leaf)
    return out


def _step(cfg: TrainConfig, count: int) -> adam_mod.AdamStep:
    """The scalars ``engine.adam_update`` hands the update at ``count``."""
    return adam_mod.AdamStep(
        cfg.b1, cfg.b2, cfg.eps, cfg.learning_rate,
        engine.bias_correction(cfg.b1, count), engine.bias_correction(cfg.b2, count),
        weight_decay=cfg.weight_decay,
        warmup=engine.warmup_factor(count - 1, cfg.warmup_steps) if cfg.warmup_steps > 0 else None,
        max_norm=cfg.max_grad_norm,
    )


def _bits(ts: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts]).view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_the_foreach_chain_bit_for_bit(cuda_device, case):
    cfg = TrainConfig(learning_rate=1e-3, **CASES[case])
    sizes, layout, (ours, plain) = _state(cuda_device, seed=11)
    n_leaves = None
    for count in (1, 2, 3):
        grads = _grads(sizes, layout, cuda_device, seed=100 + count)
        step = _step(cfg, count)
        if n_leaves is None:
            addrs = [[t.data_ptr() for t in lst] for lst in (*ours, grads)]
            leaves = adam_mod.kernel_leaves(*addrs, sizes)
            n_leaves = len(leaves.n)
            assert n_leaves > 2 * adam_mod.MAX_LEAVES  # three launches a step
            assert 0 < int(leaves.vec.sum()) < n_leaves  # float4 and scalar leaves
        before = adam_mod.ADAM_LAUNCHES
        adam_mod.adam(step, *ours, grads)
        assert adam_mod.ADAM_LAUNCHES == before + len(adam_mod.launch_spans(n_leaves))
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads)) if cfg.max_grad_norm is not None else None
        if case.startswith("clip"):
            keeps = bool(g_norm < cfg.max_grad_norm)
            assert keeps == (case == "clip-keeps")
        adam_mod.adam_reference(step, *plain, grads, g_norm)
        torch.cuda.synchronize()
        for name, a, b in zip(("p", "mu", "nu"), ours, plain):
            same = _bits(a) == _bits(b)
            assert bool(same.all()), f"step {count}: {name} differs in {int((~same).sum())} elements"


def _tiny(**train):
    model = ModelConfig.tiny(vocab_size=100, max_len=16, max_position_embeddings=32)
    return model, TrainConfig(learning_rate=1e-3, log_every=0, **train)


def _batch(b: int = 4, length: int = 16, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, 100, (b, length)).astype(np.int32),
            "attention_mask": np.ones((b, length), np.int32),
            "labels": rng.integers(0, 2, b).astype(np.int32)}


@pytest.mark.cuda
@pytest.mark.parametrize("caller", ["trainer", "trainer-adopted", "mesh", "fsdp-mesh", "federated"])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_every_caller_steps_through_the_kernel(cuda_device, caller, clip):
    model, tc = _tiny(max_grad_norm=clip)
    batch = _batch()
    before = adam_mod.ADAM_LAUNCHES
    if caller.startswith("trainer"):
        tr = engine.Trainer(model, tc, device=cuda_device)
        state = tr.init_state(seed=0)
        if caller == "trainer-adopted":  # a JAX-layout aggregate, kernels transposed on the wire
            state = tr.adopt_aggregate(state, tr.host_params(state))
        tr.train_step(state, batch)
    elif caller in ("mesh", "fsdp-mesh"):
        cls = client_mesh.MeshTrainer if caller == "mesh" else client_mesh.FsdpMeshTrainer
        tr = cls(model, tc, mesh=make_host_mesh(2, devices=[cuda_device] * 2))
        tr.train_step(tr.init_state(seed=0), batch)
    else:
        cfg = ExperimentConfig(model=model, data=DataConfig(max_len=16, batch_size=4), train=tc,
                               fed=FedConfig(num_clients=2))
        ft = federated.FederatedTrainer(cfg, device=cuda_device)
        ft.train_step(ft.init_state(seed=0), {k: np.stack([v, v]) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert adam_mod.ADAM_LAUNCHES > before


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["non-contiguous", "fp64", "mixed-devices", "cpu-first"])
def test_a_leaf_the_kernel_cannot_take_raises_and_launches_nothing(cuda_device, fault):
    params = [torch.randn(8, 8, device=cuda_device) for _ in range(3)]
    mus = [torch.zeros_like(p) for p in params]
    nus = [torch.zeros_like(p) for p in params]
    grads = [torch.randn_like(p) for p in params]
    if fault == "non-contiguous":
        grads[1] = torch.randn(8, 8, device=cuda_device).t()
    elif fault == "fp64":
        nus[2] = nus[2].double()
    elif fault == "mixed-devices":
        grads[2] = grads[2].cpu()
    else:
        params[0] = params[0].cpu()
    before = [t.clone() for t in params]
    launches = adam_mod.ADAM_LAUNCHES
    with pytest.raises(ValueError):
        adam_mod.adam(_step(TrainConfig(), 1), params, mus, nus, grads)
    torch.cuda.synchronize()
    assert adam_mod.ADAM_LAUNCHES == launches
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(params, before))
