"""The residual add + LayerNorm kernels (``csrc/residual_ln.cu``) against
the plain expression, on the card.

These tests need an NVIDIA card and skip without one (a CUDA kernel has
no CPU mode). This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_residual_ln_cuda.py

Tolerances, and why:

* the rounded sum the forward keeps must equal ``x + r`` bit for bit (both
  round one fp32 sum to the activation dtype);
* the output against the plain expression on the same card: fp32 atol
  1e-5 + rtol 1e-5 (mean and variance summed in another order); bf16 atol
  1e-5 + rtol 8e-3 (both round one fp32 result to bf16, so they may differ
  by one bf16 ulp, at most 2^-7 relative);
* dx against autograd of the fp32 plain path (LayerNorm of the rounded sum
  in fp32, dy widened): fp32 atol 1e-5 + rtol 1e-4; bf16 atol 1e-5 + rtol
  8e-3 (one bf16 rounding of dx);
* dgamma and dbeta: fp32 sums over every row in another order, atol 2e-3
  + rtol 1e-4 at up to 16,384 rows; and the same bits in two runs.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    FedConfig,
    ModelConfig,
    TrainConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    distilbert,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    residual_ln as rln,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel.mesh import (
    make_host_mesh,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
    ScoreEngine,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    client_mesh,
    engine,
    federated,
)

EPS = 1e-12
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=1e-5, rtol=8e-3)}
DX_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4), torch.bfloat16: dict(atol=1e-5, rtol=8e-3)}
PARAM_TOL = dict(atol=2e-3, rtol=1e-4)

#: Row shapes: the scoring and training launches of both models, a ring
#: chunk ([B_local, L_local, dim]), odd row counts, widths the register
#: route does not take (no whole number of 16-byte vectors; past 1,024),
#: the tiny test width. fp32 always takes the element route.
SHAPES = {
    "score-768": (128, 128, 768),
    "score-1024": (128, 128, 1024),
    "ring-chunk": (8, 64, 768),
    "rows-1": (1, 1024),
    "rows-37": (37, 768),
    "rows-16383": (16383, 1024),
    "width-100": (3, 5, 100),
    "width-1032": (9, 1032),
    "width-3072": (5, 3072),
    "tiny": (4, 16, 32),
}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    n = shape[-1]
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    r = (0.5 * torch.randn(shape, generator=g, device=device) + 0.1).to(dtype)
    w = 1.0 + 0.1 * torch.randn(n, generator=g, device=device)
    b = 0.1 * torch.randn(n, generator=g, device=device)
    return x, r, w, b


def _plain(x, r, w, b):
    return F.layer_norm((x + r).float(), (x.shape[-1],), w, b, EPS).to(x.dtype)


CASES = [(shape, dtype) for shape in sorted(SHAPES) for dtype in (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", CASES)
def test_forward_matches_the_plain_expression(cuda_device, shape, dtype):
    shape = SHAPES[shape]
    x, r, w, b = _inputs(shape, dtype, cuda_device)
    before = rln.FWD_LAUNCHES
    y, s, stats = rln.residual_ln_forward(x, r, w, b, EPS, save=True)
    y_plain = rln.residual_layer_norm(x, r, w, b, EPS, dtype)
    torch.cuda.synchronize()
    assert rln.FWD_LAUNCHES == before + 2
    assert y.dtype == dtype and y.shape == x.shape and y.is_contiguous()
    assert torch.equal(y, y_plain)  # keeping s and the stats changes no bit of y
    assert torch.equal(s, x + r)
    sf = (x + r).float().reshape(-1, shape[-1])
    mean = sf.mean(-1)
    rstd = torch.rsqrt(sf.var(-1, unbiased=False) + EPS)
    torch.testing.assert_close(stats[:, 0], mean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(stats[:, 1], rstd, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(y, _plain(x, r, w, b), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_a_misaligned_input_takes_element_loads_and_agrees(cuda_device, dtype):
    x, r, w, b = _inputs((65, 768), dtype, cuda_device)
    xs = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)[1:].view(x.shape).copy_(x)
    assert xs.is_contiguous() and rln.vectors_a_lane(768, dtype, xs) == 0
    y = rln.residual_layer_norm(xs, r, w, b, EPS, dtype)
    # The two routes sum a row's statistics in another order.
    torch.testing.assert_close(y, rln.residual_layer_norm(x, r, w, b, EPS, dtype), **TOL[dtype])


def _grads(fn, x, r, w, b, dy):
    x, r, w, b = (t.detach().clone().requires_grad_(True) for t in (x, r, w, b))
    fn(x, r, w, b).backward(dy)
    return x.grad, r.grad, w.grad, b.grad


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", CASES)
def test_backward_matches_autograd_of_the_fp32_plain_path(cuda_device, shape, dtype):
    shape = SHAPES[shape]
    x, r, w, b = _inputs(shape, dtype, cuda_device)
    dy = torch.randn(shape, generator=torch.Generator(device=cuda_device).manual_seed(5), device=cuda_device).to(dtype)
    before = rln.BWD_LAUNCHES
    dx, dr, dw, db = _grads(lambda *a: rln.residual_layer_norm(*a, EPS, dtype), x, r, w, b, dy)
    torch.cuda.synchronize()
    assert rln.BWD_LAUNCHES == before + 1
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    assert torch.equal(dx, dr)
    s = (x + r).float()
    px, _, pw, pb = _grads(lambda a, _r, c, d: F.layer_norm(a, (shape[-1],), c, d, EPS), s, s, w, b, dy.float())
    torch.testing.assert_close(dx.float(), px, **DX_TOL[dtype])
    torch.testing.assert_close(dw, pw, **PARAM_TOL)
    torch.testing.assert_close(db, pb, **PARAM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", ["score-1024", "rows-37", "width-100"])
def test_dgamma_and_dbeta_are_the_same_bits_in_two_runs(cuda_device, dtype, shape):
    x, r, w, b = _inputs(SHAPES[shape], dtype, cuda_device, seed=3)
    dy = torch.randn(x.shape, device=cuda_device).to(dtype)
    runs = [_grads(lambda *a: rln.residual_layer_norm(*a, EPS, dtype), x, r, w, b, dy) for _ in range(2)]
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fault", ["x-transposed", "r-strided", "mixed-dtype", "fp16", "weight-bf16", "weight-cpu", "out-dtype",
              "shape", "no-rows"],
)
def test_what_the_kernels_do_not_take_raises_and_launches_nothing(cuda_device, fault):
    x, r, w, b = _inputs((64, 64), torch.bfloat16, cuda_device)
    dtype = torch.bfloat16
    if fault == "x-transposed":
        x = x.t()
    elif fault == "r-strided":
        r = torch.cat([r, r], 1)[:, ::2]
    elif fault == "mixed-dtype":
        r = r.float()
    elif fault == "fp16":
        x, r = x.half(), r.half()
    elif fault == "weight-bf16":
        w = w.bfloat16()
    elif fault == "weight-cpu":
        w = w.cpu()
    elif fault == "out-dtype":
        dtype = torch.float32
    elif fault == "shape":
        r = r[:32]
    else:
        x, r = x[:0], r[:0]
    before = rln.FWD_LAUNCHES
    with pytest.raises(ValueError):
        rln.residual_layer_norm(x, r, w, b, EPS, dtype)
    torch.cuda.synchronize()
    assert rln.FWD_LAUNCHES == before


def _tiny(**kw):
    model = ModelConfig.tiny(vocab_size=100, max_len=16, max_position_embeddings=32, **kw)
    return model, TrainConfig(learning_rate=1e-3, log_every=0)


def _batch(b: int = 4, length: int = 16, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, 100, (b, length)).astype(np.int32),
            "attention_mask": np.ones((b, length), np.int32),
            "labels": rng.integers(0, 2, b).astype(np.int32)}


@pytest.mark.cuda
@pytest.mark.parametrize("caller", ["trainer", "trainer-bf16", "remat", "mesh", "fsdp-mesh", "federated", "scorer",
                                    "ring"])
def test_every_caller_runs_the_kernels(cuda_device, caller):
    """Each of the model's callers on the card: 2 forward launches a block
    and forward, and in training 2 backward launches a block and step."""
    model, tc = _tiny(compute_dtype="bfloat16" if caller == "trainer-bf16" else "float32",
                      remat=caller == "remat")
    batch = _batch()
    fwd, bwd = rln.FWD_LAUNCHES, rln.BWD_LAUNCHES
    sites = 2 * model.n_layers
    if caller in ("trainer", "trainer-bf16", "remat"):
        tr = engine.Trainer(model, tc, device=cuda_device)
        tr.train_step(tr.init_state(seed=0), batch)
        # remat runs each block's forward twice: once, then again in the backward
        want = (sites * (2 if caller == "remat" else 1), sites)
    elif caller in ("mesh", "fsdp-mesh"):
        cls = client_mesh.MeshTrainer if caller == "mesh" else client_mesh.FsdpMeshTrainer
        tr = cls(model, tc, mesh=make_host_mesh(2, devices=[cuda_device] * 2))
        tr.train_step(tr.init_state(seed=0), batch)
        want = (2 * sites, 2 * sites)  # one forward and backward a data slot
    elif caller == "federated":
        cfg = ExperimentConfig(model=model, data=DataConfig(max_len=16, batch_size=4), train=tc,
                               fed=FedConfig(num_clients=2))
        ft = federated.FederatedTrainer(cfg, device=cuda_device)
        ft.train_step(ft.init_state(seed=0), {k: np.stack([v, v]) for k, v in batch.items()})
        want = None  # the stacked step's forwards, whatever their count
    elif caller == "scorer":
        params = distilbert.init_params(model, torch.Generator().manual_seed(0))
        ScoreEngine(model, params, device=cuda_device).score(batch["input_ids"], batch["attention_mask"])
        want = (sites, 0)
    else:
        cfg = dataclasses.replace(model, attention_impl="ring")
        params = {k: v.to(cuda_device).requires_grad_(True)
                  for k, v in distilbert.init_params(cfg, torch.Generator().manual_seed(0)).items()}
        ids = torch.from_numpy(batch["input_ids"]).long().to(cuda_device)
        mask = torch.from_numpy(batch["attention_mask"]).long().to(cuda_device)
        ctx = distilbert.SeqContext(((cuda_device, cuda_device),))
        logits = torch.func.functional_call(distilbert.model_skeleton(cfg), params, (ids, mask), {"seq": ctx})
        logits.sum().backward()
        # Two sequence chunks; the last block's second chunk feeds no logit
        # (the CLS token is the first chunk's), so its two sites get no gradient.
        want = (2 * sites, 2 * sites - 2)
    torch.cuda.synchronize()
    got = (rln.FWD_LAUNCHES - fwd, rln.BWD_LAUNCHES - bwd)
    if want is None:
        assert got[0] > 0 and got[1] > 0, got
    else:
        assert got == want, f"{caller}: {got} launches (forward, backward), want {want}"
