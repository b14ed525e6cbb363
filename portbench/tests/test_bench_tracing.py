"""The traced window's reductions and the per-layer readers, on a timeline
written by hand (a CPU run has no device operations to read)."""

from __future__ import annotations

import json
import os

import pytest

from conftest import BENCH
from pbcore import readers, roofline
from pbcore.bench import reader
from pbcore.tracing import Timeline, category, percentile, timeline_from_spans

CFG = json.load(open(os.path.join(BENCH, "configs", "distilbert-base.json")))
CARD = "NVIDIA H100 80GB HBM3"


def _timeline(mode: str = "train") -> Timeline:
    dev = [
        ("void flash_fwd_tc_kernel<true>(...)", 100.0, 150.0),
        ("void flash_dq_tc_kernel<true>(...)", 150.0, 250.0),
        ("void flash_dkdv_tc_kernel<true>(...)", 260.0, 360.0),
        ("void at::native::multi_tensor_apply_kernel<...>", 400.0, 900.0),
        ("nvjet_tst_128x256", 900.0, 1000.0),
        ("portbench.train_step", 0.0, 1000.0),  # a range's device-side copy: not an operation
        ("Memcpy HtoD (Pageable -> Device)", 1200.0, 1300.0),
    ]
    host = [
        ("portbench.window", 0.0, 2000.0),
        ("portbench.train_step", 10.0, 1100.0),
        ("portbench.fetch", 1100.0, 1150.0),
        ("portbench.train_step", 1150.0, 1990.0),
        ("aten::to", 1160.0, 1310.0),
        ("aten::copy_", 1170.0, 1300.0),
        ("aten::mm", 5000.0, 5100.0),  # outside the window
    ]
    extra = dict(mode=mode, cfg=CFG, batch=128, seq_len=128, traced_steps=1, plain_steps=100,
                 plain_s=3.0, device_name=CARD)
    return timeline_from_spans(dev, host, extra)


def test_window_busy_and_gaps():
    tl = _timeline()
    assert tl.window_s == pytest.approx(2000e-6)
    assert tl.busy_s == pytest.approx((50 + 100 + 100 + 500 + 100 + 100) * 1e-6)
    assert tl.gaps()[0] == (0.0, 100.0) and tl.gaps()[-1] == (1300.0, 2000.0)
    top = tl.idle_gaps(2)
    assert top[0] == ["portbench.train_step", pytest.approx(700e-6)]
    assert top[1][0] == "portbench.fetch"  # 1000-1200: the host fetched the next batch
    assert tl.top_ops(1)[0][0].startswith("void at::native::multi_tensor")
    assert "portbench.train_step" not in [n for n, _ in tl.top_ops(10)]


def test_categories():
    assert category("void flash_fwd_tc_kernel<false>") == "K1 flash_fwd"
    assert category("multi_tensor_apply_kernel") == "optimizer"
    assert category("sm90_xmma_gemm_bf16") == "GEMM"
    assert category("something new") == "other"
    assert _timeline().categories()["optimizer"] == pytest.approx(500e-6)


def test_readers_on_a_training_window():
    tl = _timeline()
    b, h, l, d = 128, 12, 128, 64
    assert reader("k1_roofline.train").read(tl) == pytest.approx(100 * roofline.attention_bound(b, h, l, d) / 50e-6)
    assert reader("k2_roofline.train").read(tl) == pytest.approx(100 * roofline.backward_bound(b, h, l, d, "dkdv") / 100e-6)
    assert reader("k3_roofline.train").read(tl) == pytest.approx(100 * roofline.backward_bound(b, h, l, d, "dq") / 100e-6)
    assert reader("adam_roofline.train").read(tl) == pytest.approx(100 * roofline.adam_bound(roofline.n_params(CFG)) / 500e-6)
    assert reader("device_idle.train").read(tl) == pytest.approx(100 * (1 - tl.busy_s / 0.03))
    want = 100 * roofline.train_step_flops(CFG, 128, 128) * 100 / (3.0 * 989e12)
    assert reader("mfu.train").read(tl) == pytest.approx(want)
    for name in ("mfu.score", "k1_roofline.score", "device_idle.score"):
        assert reader(name).read(tl) is None  # another mode's window


def test_readers_find_nothing_to_read():
    tl = _timeline("score")
    assert reader("mfu.score").read(tl) == pytest.approx(
        100 * roofline.forward_flops(CFG, 128, 128) * 100 / (3.0 * 989e12))
    tl.device = [x for x in tl.device if "flash" not in x[0]]
    assert reader("k1_roofline.score").read(tl) is None  # no launch: no roofline, never 0
    tl.extra["device_name"] = "cpu"
    assert readers.mfu(tl, "score") is None  # no known peak
    tl.device = []
    assert reader("device_idle.score").read(tl) is None


def test_percentile_is_numpy_s_linear():
    import numpy as np

    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0]
    for q in (0, 50, 95, 100):
        assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
