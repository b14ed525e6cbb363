"""The residual add + LayerNorm op of the port's post-LN blocks, on the CPU.

On CPU tensors the op is the model's plain expression,
``LayerNorm((x + r).float()).to(dtype)``, so forward and gradients must
equal it bit for bit. The card's kernels (``csrc/residual_ln.cu``) are
held to it in ``tests/test_torch_residual_ln_cuda.py``; here: that both
post-LN sites of every block go through the op, the route and launch
shape the wrapper works out, its refusals that need no card, the autograd wiring of
the kernel pair (with plain stand-ins for the two launches) and that the
first load of K1's library or this one builds both side by side."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    build_model,
    distilbert,
    init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    _build,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    residual_ln as rln,
)

torch.set_num_threads(1)
EPS = 1e-12


def _plain(x, r, w, b, eps, dtype):
    """The model's expression before the op: ``_layer_norm(x + r, ln, cd)``."""
    return F.layer_norm((x + r).float(), (x.shape[-1],), w, b, eps).to(dtype)


def _inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    n = shape[-1]
    x = torch.randn(shape, generator=g).to(dtype)
    r = (0.5 * torch.randn(shape, generator=g) + 0.1).to(dtype)
    w = 1.0 + 0.1 * torch.randn(n, generator=g)
    b = 0.1 * torch.randn(n, generator=g)
    return x, r, w, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [768, 1024])
@pytest.mark.parametrize("lead", [(5,), (3, 7)])
def test_the_cpu_op_is_the_plain_expression_bit_for_bit(dtype, width, lead):
    """Forward and the gradients of x, r, weight and bias, at row counts
    that are no multiple of a block's rows (4 forward, 8 backward)."""
    shape = (*lead, width)
    outs, grads = [], []
    for fn in (_plain, rln.residual_layer_norm):
        x, r, w, b = (t.clone().requires_grad_(True) for t in _inputs(shape, dtype))
        y = fn(x, r, w, b, EPS, dtype)
        dy = torch.randn(shape, generator=torch.Generator().manual_seed(9)).to(dtype)
        y.backward(dy)
        outs.append(y.detach())
        grads.append([t.grad for t in (x, r, w, b)])
    assert outs[1].dtype == dtype
    assert torch.equal(outs[0], outs[1])
    for want, got in zip(*grads):
        assert got.dtype == want.dtype and torch.equal(want, got)


def _model(cfg):
    return build_model(cfg, init_params(cfg, torch.Generator().manual_seed(3)), torch.device("cpu"))


def _ids(cfg, b=3):
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(5, cfg.vocab_size, (b, cfg.max_len)).astype(np.int64))
    mask = torch.ones_like(ids)
    mask[1, 9:] = 0
    return ids, mask


@pytest.mark.parametrize("n_layers", [1, 3])
def test_every_block_routes_both_post_ln_sites_through_the_op(monkeypatch, n_layers):
    cfg = ModelConfig.tiny(n_layers=n_layers)
    model = _model(cfg)
    ids, mask = _ids(cfg)
    with torch.no_grad():
        want = model(ids, mask)
    calls = []

    def counted(x, r, weight, bias, eps, dtype):
        calls.append((tuple(x.shape), tuple(r.shape), eps, dtype))
        return rln.residual_layer_norm(x, r, weight, bias, eps, dtype)

    monkeypatch.setattr(distilbert, "residual_layer_norm", counted)
    with torch.no_grad():
        got = model(ids, mask)
    assert len(calls) == 2 * n_layers
    assert all(c == ((3, cfg.max_len, cfg.dim),) * 2 + (cfg.layer_norm_eps, torch.float32) for c in calls)
    assert torch.equal(want, got)


def test_the_blocks_match_the_expression_they_replace(monkeypatch):
    """The model with the op against the model with the old expression at
    both sites, forward and every leaf's gradient, bf16 activations."""
    cfg = ModelConfig.tiny(n_layers=2, compute_dtype="bfloat16")
    ids, mask = _ids(cfg)
    labels = torch.tensor([0, 1, 1])
    runs = []
    for old in (False, True):
        if old:
            monkeypatch.setattr(distilbert, "residual_layer_norm", _plain)
        model = _model(cfg)
        model.requires_grad_(True)
        loss = F.cross_entropy(model(ids, mask), labels)
        loss.backward()
        runs.append((loss.detach(), {k: p.grad for k, p in model.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1].keys() == runs[1][1].keys()
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.parametrize(
    "n,per",
    [(8, 1), (32, 1), (256, 1), (264, 2), (512, 2), (520, 4), (768, 4), (1024, 4)],
)
def test_a_bf16_row_takes_the_least_vectors_a_lane_that_hold_it(n, per):
    t = torch.zeros(64, dtype=torch.float32)
    assert t.data_ptr() % 16 == 0
    assert rln.vectors_a_lane(n, torch.bfloat16, t, t) == per
    assert 32 * per * 8 >= n > 32 * 8 * {1: 0, 2: 1, 4: 2}[per]


def test_both_models_rows_take_the_register_route():
    for cfg in (ModelConfig.distilbert_base(), ModelConfig.bert_large()):
        x = torch.zeros((2, cfg.dim), dtype=torch.bfloat16)
        assert rln.vectors_a_lane(cfg.dim, torch.bfloat16, x, x) == 4


@pytest.mark.parametrize(
    "case,n,dtype", [("fp32", 768, torch.float32), ("fp32-tiny", 32, torch.float32), ("wide", 1032, torch.bfloat16),
                     ("wider", 2048, torch.bfloat16), ("odd-width", 36, torch.bfloat16),
                     ("misaligned", 768, torch.bfloat16)],
)
def test_any_other_row_takes_the_element_route(case, n, dtype):
    t = torch.zeros(2 * n + 8, dtype=dtype)
    assert t.data_ptr() % 16 == 0
    views = (t, t[1:]) if case == "misaligned" else (t, t)
    assert rln.vectors_a_lane(n, dtype, *views) == 0


@pytest.mark.parametrize("rows,sms,blocks", [(1, 132, 1), (7, 132, 1), (9, 132, 2), (16384, 132, 264),
                                             (2048, 132, 256), (100000, 4, 8)])
def test_backward_blocks_fill_the_card_without_passing_two_an_sm(rows, sms, blocks):
    assert rln.bwd_blocks(rows, sms) == blocks


@pytest.mark.parametrize(
    "case,match",
    [("dtype", "bf16 or fp32"), ("mixed", "share one dtype"), ("shape", "share one shape"),
     ("weight", "contiguous fp32"), ("bias-dtype", "contiguous fp32"), ("cpu", "same CUDA device")],
)
def test_the_kernel_wrapper_refuses_what_the_kernels_do_not_take(case, match):
    x, r, w, b = _inputs((4, 64), torch.float32)
    if case == "dtype":
        x, r = x.half(), r.half()
    elif case == "mixed":
        r = r.bfloat16()
    elif case == "shape":
        r = r[:3]
    elif case == "weight":
        w = w[:32]
    elif case == "bias-dtype":
        b = b.double()
    with pytest.raises(ValueError, match=match):
        rln.residual_ln_forward(x, r, w, b, EPS)


def test_the_op_refuses_a_device_it_has_no_path_for():
    x, r, w, b = _inputs((2, 16), torch.float32)
    meta = [t.to("meta") for t in (x, r, w, b)]
    with pytest.raises(ValueError, match="unsupported device"):
        rln.residual_layer_norm(*meta, EPS, torch.float32)


def _fwd_stand_in(x, r, weight, bias, eps, save=False):
    """The forward kernel's arithmetic in plain fp32 ops."""
    s = x + r
    sf = s.float()
    mean = sf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((sf - mean) ** 2).mean(-1, keepdim=True) + eps)
    y = ((sf - mean) * rstd * weight + bias).to(x.dtype)
    stats = torch.cat([mean, rstd], -1).reshape(-1, 2)
    return y, (s if save else None), (stats if save else None)


def _bwd_stand_in(dy, s, stats, weight):
    """The backward kernels' arithmetic in plain fp32 ops."""
    n = s.shape[-1]
    sf, d = s.float().reshape(-1, n), dy.float().reshape(-1, n)
    mean, rstd = stats[:, :1], stats[:, 1:]
    xh = (sf - mean) * rstd
    g = d * weight
    dx = rstd * (g - g.mean(-1, keepdim=True) - xh * (g * xh).mean(-1, keepdim=True))
    return dx.to(s.dtype).reshape(s.shape), (d * xh).sum(0), d.sum(0)


@pytest.mark.parametrize("grads", ["all", "activations", "params"])
def test_the_kernel_pair_s_autograd_wiring(monkeypatch, grads):
    """ResidualLayerNorm with both launches stood in for by their
    arithmetic in plain ops: the one dx reaches x and r, dgamma and dbeta
    reach the parameters, a leaf without grad gets none, and the numbers
    are autograd's of the plain expression in fp32."""
    monkeypatch.setattr(rln, "residual_ln_forward", _fwd_stand_in)
    monkeypatch.setattr(rln, "residual_ln_backward", _bwd_stand_in)
    x, r, w, b = _inputs((2, 5, 48), torch.float32, seed=4)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    act, par = grads in ("all", "activations"), grads in ("all", "params")
    want = [t.clone().requires_grad_(True) for t in (x, r, w, b)]
    _plain(*want, 1e-5, torch.float32).backward(dy)
    got = [t.clone().requires_grad_(req) for t, req in zip((x, r, w, b), (act, act, par, par))]
    y = rln.ResidualLayerNorm.apply(*got, 1e-5)
    torch.testing.assert_close(y, _plain(x, r, w, b, 1e-5, torch.float32), atol=2e-6, rtol=1e-5)
    y.backward(dy)
    for t, ref, req in zip(got, want, (act, act, par, par)):
        if req:
            torch.testing.assert_close(t.grad, ref.grad, atol=2e-5, rtol=1e-5)
        else:
            assert t.grad is None


def test_the_new_source_is_in_the_port_s_build_list():
    assert _build.SOURCES["residual_ln"] == "residual_ln.cu"
    assert os.path.isfile(os.path.join(_build.CSRC_DIR, "residual_ln.cu"))
    assert _build.source_files("residual_ln") == ["residual_ln.cu"]
    assert ("flash_fwd", "residual_ln") in _build.BUILD_GROUPS


class _Nvcc:
    """A stand-in ``subprocess.Popen`` of nvcc: records when each build
    starts and is waited on, and writes the library on the wait."""

    events: list = []

    def __init__(self, cmd, stdout=None, stderr=None):
        self.out = cmd[cmd.index("-o") + 1]
        self.name = os.path.basename(cmd[-1]).removesuffix(".cu")
        self.returncode = 0
        _Nvcc.events.append(("start", self.name))

    def communicate(self):
        _Nvcc.events.append(("wait", self.name))
        with open(self.out, "wb") as f:
            f.write(b"lib")
        return b"", None


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    _Nvcc.events = []
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _Nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    return _Nvcc.events


@pytest.mark.parametrize("first", ["flash_fwd", "residual_ln"])
def test_the_first_load_of_either_starts_both_nvccs_before_waiting(fake_nvcc, first):
    lib = _build.load(first)
    assert lib == ("lib", _build.library_path(first))
    assert sorted(fake_nvcc[:2]) == [("start", "flash_fwd"), ("start", "residual_ln")]
    assert sorted(fake_nvcc[2:]) == [("wait", "flash_fwd"), ("wait", "residual_ln")]
    # The other library of the group is built: its load compiles nothing.
    other = "residual_ln" if first == "flash_fwd" else "flash_fwd"
    _build.load(other)
    assert len(fake_nvcc) == 4
    assert os.path.isfile(_build.library_path(other))


@pytest.mark.parametrize("name", ["flash_bwd", "fold", "adam"])
def test_every_other_library_still_builds_alone(fake_nvcc, name):
    _build.load(name)
    assert fake_nvcc == [("start", name), ("wait", name)]
    assert _build.build_group(name) == [name]

