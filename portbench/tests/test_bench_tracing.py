"""The traced window's reductions and the per-layer readers, on a timeline
written by hand (a CPU run has no device operations to read)."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

from conftest import BENCH
from pbcore import readers, roofline
from pbcore.bench import reader
from pbcore.tracing import Timeline, category, percentile, timeline_from_spans
from reference import distilbert

CFG = json.load(open(os.path.join(BENCH, "configs", "distilbert-base.json")))
CARD = "NVIDIA H100 80GB HBM3"


def _timeline(mode: str = "train", cfg: dict = CFG, program_ranges: tuple = ()) -> Timeline:
    dev = [
        ("void flash_fwd_tc_kernel<true>(...)", 100.0, 150.0, False),
        ("void flash_dq_tc_kernel<true>(...)", 150.0, 250.0, False),
        ("void flash_dkdv_tc_kernel<true>(...)", 260.0, 360.0, False),
        ("void at::native::multi_tensor_apply_kernel<...>", 400.0, 900.0, False),
        ("nvjet_tst_128x256", 900.0, 1000.0, False),
        ("portbench.train_step", 0.0, 1000.0, True),  # a range's device-side copy: not an operation
        ("Memcpy HtoD (Pageable -> Device)", 1200.0, 1300.0, False),
        *program_ranges,
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
    extra = dict(mode=mode, cfg=cfg, batch=128, seq_len=128, traced_steps=1, plain_steps=100,
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
    assert reader("adam_roofline.train").read(tl) == pytest.approx(
        100 * roofline.adam_bound(distilbert.n_trainable(CFG)) / 500e-6)
    assert reader("device_idle.train").read(tl) == pytest.approx(100 * (1 - tl.busy_s / 0.03))
    want = 100 * roofline.train_step_flops(distilbert.forward_flops(CFG, 128, 128)) * 100 / (3.0 * 989e12)
    assert reader("mfu.train").read(tl) == pytest.approx(want)
    for name in ("mfu.score", "k1_roofline.score", "device_idle.score"):
        assert reader(name).read(tl) is None  # another mode's window


def test_readers_find_nothing_to_read():
    tl = _timeline("score")
    assert reader("mfu.score").read(tl) == pytest.approx(
        100 * distilbert.forward_flops(CFG, 128, 128) * 100 / (3.0 * 989e12))
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


#: The readers' values on ``_timeline`` at the parent commit, before the
#: work counts moved into the families: the same timeline and
#: configuration read the same.
PARENT_READINGS = {
    ("distilbert-base", "train"): {
        "mfu.train": 14.46131954281092, "adam_roofline.train": 110.93753456716418,
        "k1_roofline.train": 60.60612776119404, "k2_roofline.train": 45.79694805970149,
        "k3_roofline.train": 45.56219223880598, "device_idle.train": 96.83333333333334},
    ("distilbert-base", "score"): {
        "mfu.score": 4.82043984760364, "k1_roofline.score": 60.60612776119404, "device_idle.score": 96.83333333333334},
    ("bert-large", "train"): {
        "mfu.train": 102.14118912517695, "adam_roofline.train": 558.4826340298507,
        "k1_roofline.train": 80.79512835820897, "k2_roofline.train": 61.056076417910454,
        "k3_roofline.train": 60.743068656716424, "device_idle.train": 96.83333333333334},
    ("bert-large", "score"): {
        "mfu.score": 34.04706304172565, "k1_roofline.score": 80.79512835820897, "device_idle.score": 96.83333333333334},
}

#: Ranges a program might open around its layers: device-side copies.
PROGRAM_RANGES = (
    ("model.block_0", 100.0, 360.0, True),
    ("model.block_0.attn", 100.0, 250.0, True),  # nested in the block: its busy time counts once
    ("model.optimizer", 380.0, 900.0, True),
)


@pytest.mark.parametrize("config,mode", sorted(PARENT_READINGS))
@pytest.mark.parametrize("program_ranges", [(), PROGRAM_RANGES], ids=["harness-ranges", "program-ranges"])
def test_readers_read_the_parent_s_values(config, mode, program_ranges):
    cfg = json.load(open(os.path.join(BENCH, "configs", f"{config}.json")))
    tl = _timeline(mode, cfg, program_ranges)
    got = {name: reader(name).read(tl) for name in PARENT_READINGS[(config, mode)]}
    assert got == PARENT_READINGS[(config, mode)]


def test_program_ranges_are_kept_apart_by_kind():
    plain, ranged = _timeline(), _timeline(program_ranges=PROGRAM_RANGES)
    assert ranged.busy_s == plain.busy_s and ranged.gaps() == plain.gaps()
    assert ranged.top_ops(10) == plain.top_ops(10) and ranged.categories() == plain.categories()
    assert [r[0] for r in ranged.device_ranges] == ["portbench.train_step"] + [r[0] for r in PROGRAM_RANGES]
    assert ranged.busy_in("model.") == pytest.approx((50 + 100 + 100 + 500) * 1e-6)
    assert ranged.busy_in("model.block_0") == pytest.approx(250e-6)
    assert ranged.busy_in("portbench.") == pytest.approx(850e-6)  # every operation before 1000 µs
    assert ranged.busy_in("nothing") == 0.0 and plain.busy_in("model.") == 0.0


class _Event:
    """A kineto event as ``torch.profiler`` hands it over."""

    def __init__(self, name, start_us, end_us, device, annotation):
        self._v = (name, int(start_us * 1e3), int((end_us - start_us) * 1e3), device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_a_profile_s_annotations_are_dropped_by_kind_not_name():
    import torch

    from pbcore.tracing import _spans

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [
        _Event("portbench.window", 0.0, 1000.0, cpu, True),
        _Event("model.block_0", 10.0, 500.0, cpu, True),
        _Event("model.block_0", 100.0, 700.0, cuda, True),  # the block's device-side copy
        _Event("portbench.window", 100.0, 900.0, cuda, True),
        _Event("gemm_kernel", 100.0, 300.0, cuda, False),
        _Event("model.fused_kernel", 400.0, 700.0, cuda, False),  # an operation, whatever its name
        _Event("portbench.like_kernel", 800.0, 900.0, cuda, False),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    tl = timeline_from_spans(*_spans(prof))
    assert [n for n, _, _ in tl.device] == ["gemm_kernel", "model.fused_kernel", "portbench.like_kernel"]
    assert tl.busy_s == pytest.approx(600e-6)
    assert sorted(n for n, _, _ in tl.device_ranges) == ["model.block_0", "portbench.window"]
    assert tl.busy_in("model.") == pytest.approx(500e-6)
