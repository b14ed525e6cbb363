"""The frozen yardstick: byte bounds and FLOP counts."""

from __future__ import annotations

import dataclasses
import json
import os
from importlib import import_module

import pytest

from conftest import BENCH, PORT
from pbcore import roofline


def _cfg(name: str) -> dict:
    return json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))


@pytest.mark.parametrize("bound,want_ms", [
    (lambda: roofline.attention_bound(128, 12, 128, 64), 0.0303),  # K1 serve
    (lambda: roofline.attention_bound(16, 12, 128, 64), 0.0038),  # K1 train
    (lambda: roofline.backward_bound(16, 12, 128, 64, "dkdv"), 0.0057),  # K2
    (lambda: roofline.backward_bound(16, 12, 128, 64, "dq"), 0.0057),  # K3
])
def test_bounds_reproduce_the_kernel_table(bound, want_ms):
    assert round(bound() * 1e3, 4) == want_ms


@pytest.mark.parametrize("name", ["distilbert-base", "bert-large"])
def test_flops_reproduce_the_port_s_count(name):
    config = import_module(PORT + ".config")
    profiling = import_module(PORT + ".utils.profiling")
    cfg = _cfg(name)
    mc = config.ModelConfig(**{k: cfg[k] for k in (f.name for f in dataclasses.fields(config.ModelConfig)) if k in cfg})
    for b in (16, 128):
        assert roofline.forward_flops(cfg, b, 128) == profiling.forward_flops(mc, b, 128)
        assert roofline.train_step_flops(cfg, b, 128) == profiling.train_step_flops(mc, b, 128)


@pytest.mark.parametrize("name", ["distilbert-base", "bert-large"])
def test_param_count_is_the_model_s(name):
    config = import_module(PORT + ".config")
    model = import_module(PORT + ".models.distilbert")
    cfg = _cfg(name)
    mc = config.ModelConfig(**{k: cfg[k] for k in (f.name for f in dataclasses.fields(config.ModelConfig)) if k in cfg})
    sd = model.model_skeleton(mc).state_dict()
    assert roofline.n_params(cfg) == sum(t.numel() for t in sd.values())


def test_peaks():
    assert roofline.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert roofline.peak_flops("cpu") is None
    # K1 at a scoring bucket is bound by bytes, not operations
    b, h, l, d = 128, 12, 128, 64
    assert 4 * b * h * l * l * d / roofline.BF16_FLOPS < roofline.attention_bound(b, h, l, d)
