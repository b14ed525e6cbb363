"""The residual add + LayerNorm readers on timelines written by hand: the
share of the byte bound, and nothing where there is nothing to read (no
launch, a launch count a step that is not the family's post-LN sites,
the other mode, a family without post-LN blocks)."""

from __future__ import annotations

import json
import os

import pytest

from conftest import BENCH
from pbcore import roofline
from pbcore.bench import reader
from pbcore.tracing import timeline_from_spans

CARD = "NVIDIA H100 80GB HBM3"
FWD = "void (anonymous namespace)::residual_layer_norm_fwd_kernel<__nv_bfloat16, 4, true>(...)"
BWD = "void (anonymous namespace)::residual_layer_norm_bwd_kernel<__nv_bfloat16, 4, true>(...)"
DPARAMS = "(anonymous namespace)::residual_layer_norm_dparams_kernel(const float*, int, int, float*)"
LN = "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(...)"


def _cfg(config: str) -> dict:
    return json.load(open(os.path.join(BENCH, "configs", f"{config}.json")))


def _timeline(mode: str, cfg: dict, steps: int, kernels: dict[str, tuple[int, float]], **extra):
    """``steps`` traced steps; ``kernels``: name -> (launches, µs each),
    laid end to end."""
    dev, t = [], 100.0
    for name, (n, us) in kernels.items():
        for _ in range(n):
            dev.append((name, t, t + us, False))
            t += us + 1.0
    host = [("portbench.window", 0.0, t + 100.0)]
    info = dict(mode=mode, cfg=cfg, batch=128, seq_len=128, traced_steps=steps, plain_steps=50, plain_s=1.0,
                device_name=CARD)
    info.update(extra)
    return timeline_from_spans(dev, host, info)


def _fwd_bytes(cfg, save, e=2):
    rows, n = 128 * 128, cfg["dim"]
    return rows * n * e * (4 if save else 3) + 8 * n + (8 * rows if save else 0)


def _bwd_bytes(cfg, e=2):
    rows, n = 128 * 128, cfg["dim"]
    return rows * n * e * 3 + 8 * rows + 12 * n


@pytest.mark.parametrize("config", ["distilbert-base", "bert-large"])
def test_the_score_share_is_the_forward_s_bound_over_its_mean_launch(config):
    cfg = _cfg(config)
    sites = 2 * cfg["n_layers"]
    tl = _timeline("score", cfg, 3, {FWD: (3 * sites, 40.0), LN: (3, 10.0)})
    want = 100.0 * _fwd_bytes(cfg, save=False) / roofline.HBM_BYTES_PER_S / 40e-6
    assert reader("residual_ln_roofline.score").read(tl) == pytest.approx(want)
    assert reader("residual_ln_roofline.train").read(tl) is None  # the other mode


@pytest.mark.parametrize("config", ["distilbert-base", "bert-large"])
def test_the_train_share_is_both_bounds_over_the_three_kernels_time_a_step(config):
    cfg = _cfg(config)
    sites = 2 * cfg["n_layers"]
    tl = _timeline("train", cfg, 2, {FWD: (2 * sites, 50.0), BWD: (2 * sites, 45.0), DPARAMS: (2 * sites, 5.0)})
    bound = sites * (_fwd_bytes(cfg, save=True) + _bwd_bytes(cfg)) / roofline.HBM_BYTES_PER_S
    want = 100.0 * bound / (sites * 100e-6)
    assert reader("residual_ln_roofline.train").read(tl) == pytest.approx(want)
    assert reader("residual_ln_roofline.score").read(tl) is None  # the other mode


def test_fp32_activations_count_four_bytes_an_element():
    cfg = dict(_cfg("distilbert-base"), compute_dtype="float32")
    tl = _timeline("score", cfg, 1, {FWD: (12, 80.0)})
    want = 100.0 * _fwd_bytes(cfg, save=False, e=4) / roofline.HBM_BYTES_PER_S / 80e-6
    assert reader("residual_ln_roofline.score").read(tl) == pytest.approx(want)


def test_a_record_the_profiler_drops_still_reads():
    cfg = _cfg("distilbert-base")
    tl = _timeline("score", cfg, 4, {FWD: (47, 40.0)})  # 48 launched
    want = 100.0 * _fwd_bytes(cfg, save=False) / roofline.HBM_BYTES_PER_S / 40e-6
    assert reader("residual_ln_roofline.score").read(tl) == pytest.approx(want)


EMPTY_CASES = ("no-launch", "one-site-a-block", "twice-the-sites", "family-without-post-ln", "no-traced-step")


@pytest.mark.parametrize("mode,case", [(m, c) for m in ("score", "train") for c in EMPTY_CASES]
                         + [("train", "no-backward"), ("train", "no-column-sum")])
def test_nothing_to_read_reads_none(mode, case):
    cfg = _cfg("bert-large")
    sites = 2 * cfg["n_layers"]
    kernels = {FWD: (sites, 40.0), BWD: (sites, 40.0), DPARAMS: (sites, 4.0), LN: (2, 10.0)}
    extra = {}
    if case == "no-launch":
        kernels = {LN: (2 * sites, 10.0)}  # the plain path: PyTorch's LayerNorm alone
    elif case == "one-site-a-block":
        kernels[FWD] = (sites // 2, 40.0)
    elif case == "twice-the-sites":
        kernels = {k: (2 * n, us) for k, (n, us) in kernels.items()}
    elif case == "no-backward":
        del kernels[BWD]
    elif case == "no-column-sum":
        del kernels[DPARAMS]
    elif case == "family-without-post-ln":
        extra["reference"] = "decoder"
    tl = _timeline(mode, cfg, 0 if case == "no-traced-step" else 1, kernels, **extra)
    assert reader(f"residual_ln_roofline.{mode}").read(tl) is None


def test_the_new_kernels_count_as_layer_norm():
    from pbcore.tracing import category

    assert {category(k) for k in (FWD, BWD, DPARAMS)} == {"LayerNorm"}
