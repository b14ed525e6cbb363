"""The frozen yardstick: byte bounds, and the DistilBERT family's FLOP
and parameter counts."""

from __future__ import annotations

import dataclasses
import json
import os
from importlib import import_module

import pytest

from conftest import BENCH, PORT
from pbcore import roofline
from reference import distilbert


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


#: (b, h, l, d) -> K1, K2, K3 least seconds at the parent commit, before
#: the bounds took key/value heads and a causal mask.
PARENT_BOUNDS = {
    (128, 12, 128, 64): (3.0303063880597014e-05, 4.579694805970149e-05, 4.556219223880597e-05),
    (16, 12, 128, 64): (3.7878829850746268e-06, 5.724618507462686e-06, 5.695274029850746e-06),
    (128, 16, 128, 64): (4.0397564179104475e-05, 6.105607641791044e-05, 6.074306865671642e-05),
    (16, 16, 128, 64): (5.0496955223880594e-06, 7.632009552238806e-06, 7.592883582089552e-06),
}


@pytest.mark.parametrize("shape", sorted(PARENT_BOUNDS))
@pytest.mark.parametrize("kw", [{}, {"kv_heads": None, "causal": False}, {"kv_heads": "h"}],
                         ids=["defaults", "explicit-defaults", "kv-heads-equal"])
def test_bounds_at_their_defaults_are_the_parent_s(shape, kw):
    kw = {k: (shape[1] if v == "h" else v) for k, v in kw.items()}
    got = (roofline.attention_bound(*shape, **kw), roofline.backward_bound(*shape, "dkdv", **kw),
           roofline.backward_bound(*shape, "dq", **kw))
    assert got == PARENT_BOUNDS[shape]


def _least(nbytes: int, flops: int) -> float:
    return max(nbytes / roofline.HBM_BYTES_PER_S, flops / roofline.BF16_FLOPS)


# Hand counts. Small: b=2, h=8 query heads over 2 KV heads, l=4, d=64,
# causal: 10 of 16 scores a head, 160 in all; a query-head tile
# (q, O, dO, dq) 2*8*4*64*2 = 8192 bytes, a KV-head tile (k, v, dk, dv)
# 2*2*4*64*2 = 2048; lse, delta, dbias rows 2*8*4*4 = 256; key bias 32.
# Large: b=1, h=32 over 8, l=4096, d=64, causal: 4096*4097/2 = 8,390,656
# scores a head, 268,500,992 in all; q and O 33,554,432 bytes, k and v
# 8,388,608, lse 524,288, key bias 16,384.
@pytest.mark.parametrize("args,kernel,nbytes,flops", [
    ((2, 8, 2, 4, 64), "fwd", 2 * 8192 + 2 * 2048 + 256 + 32, 4 * 160 * 64),
    ((2, 8, 2, 4, 64), "dkdv", 2 * 8192 + 2 * 2048 + 256 + 32 + 256 + 2 * 2048 + 256, 8 * 160 * 64),
    ((2, 8, 2, 4, 64), "dq", 2 * 8192 + 2 * 2048 + 256 + 32 + 2 * 8192 + 256, 6 * 160 * 64),
    ((1, 32, 8, 4096, 64), "fwd", 33554432 + 8388608 + 524288 + 16384, 4 * 268500992 * 64),
])
def test_causal_grouped_kv_bounds_count_by_hand(args, kernel, nbytes, flops):
    b, h, kv, l, d = args
    if kernel == "fwd":
        got = roofline.attention_bound(b, h, l, d, kv_heads=kv, causal=True)
    else:
        got = roofline.backward_bound(b, h, l, d, kernel, kv_heads=kv, causal=True)
    assert got == _least(nbytes, flops)


def test_a_causal_mask_and_fewer_kv_heads_only_lower_the_bound():
    b, h, l, d = 1, 32, 4096, 64  # bound by operations: the mask keeps 4097/8192 of them
    full, causal = roofline.attention_bound(b, h, l, d), roofline.attention_bound(b, h, l, d, causal=True)
    assert causal == pytest.approx(full * 4097 / 8192)
    b, h, l, d = 128, 32, 128, 64  # bound by bytes: k and v at 8 heads instead of 32
    assert roofline.attention_bound(b, h, l, d, kv_heads=8) < roofline.attention_bound(b, h, l, d)
    assert roofline.backward_bound(b, h, l, d, "dkdv", kv_heads=8) < roofline.backward_bound(b, h, l, d, "dkdv")


@pytest.mark.parametrize("name", ["distilbert-base", "bert-large"])
def test_flops_reproduce_the_port_s_count(name):
    config = import_module(PORT + ".config")
    profiling = import_module(PORT + ".utils.profiling")
    cfg = _cfg(name)
    mc = config.ModelConfig(**{k: cfg[k] for k in (f.name for f in dataclasses.fields(config.ModelConfig)) if k in cfg})
    for b in (16, 128):
        assert distilbert.forward_flops(cfg, b, 128) == profiling.forward_flops(mc, b, 128)
        assert roofline.train_step_flops(distilbert.forward_flops(cfg, b, 128)) == profiling.train_step_flops(mc, b, 128)


@pytest.mark.parametrize("name", ["distilbert-base", "bert-large"])
def test_param_count_is_the_model_s(name):
    config = import_module(PORT + ".config")
    model = import_module(PORT + ".models.distilbert")
    cfg = _cfg(name)
    mc = config.ModelConfig(**{k: cfg[k] for k in (f.name for f in dataclasses.fields(config.ModelConfig)) if k in cfg})
    sd = model.model_skeleton(mc).state_dict()
    assert distilbert.n_trainable(cfg) == sum(t.numel() for t in sd.values())


def test_peaks():
    assert roofline.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert roofline.peak_flops("cpu") is None
    # K1 at a scoring bucket is bound by bytes, not operations
    b, h, l, d = 128, 12, 128, 64
    assert 4 * b * h * l * l * d / roofline.BF16_FLOPS < roofline.attention_bound(b, h, l, d)
