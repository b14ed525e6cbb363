"""The port's device performance plane held against the JAX package's (one
port test per test of ``tests/test_profile.py``, less its four
``test_alert_cmd_*`` of the unported ``slo.py``, and of
``tests/test_profiling.py``):

* the dispatch ledger reports what the JAX ledger reports for the same
  sequence of notes; a new signature at a warm site is one recompile
  event and trips the flight recorder; the serving engine's private
  ledger shows one signature per bucket and none after warmup or swaps;
* stride sampling, the summary, the span attrs and the window reset are
  the JAX profiler's on the same durations; stride 0 registers nothing;
* ``note_memory`` is "unavailable" on the CPU in both packages;
* ``forward_flops``/``train_step_flops`` equal the JAX ones; the FLOPs
  counted by ``FlopCounterMode`` over a CPU train step sit within 2% of
  the analytic count (the plain attention is visible on the CPU);
* the H100 peak table's lookup, MFU math, ``trace`` on the CPU;
* ``run_profile_session`` gives the JAX report's keys;
* ``profiled_step_iter`` yields what the JAX shim yields.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    obs as jobs,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.obs import (
    profile as jprofile,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.utils import (
    profiling as jprofiling,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    obs as pobs,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
    TokenizedSplit,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.obs import (
    profile as pprofile,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.obs.profile import (
    FLOPS_RATIO_TOLERANCE,
    CompileLedger,
    StepProfiler,
    counted_flops,
    device_memory_stats,
    flops_ratio_ok,
    maybe_step_profiler,
    note_memory,
    profiled_step_iter,
    run_profile_session,
    set_profile_stride,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.utils import (
    profiling,
)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)


def _tiny_split(n: int = 16, seed: int = 0) -> TokenizedSplit:
    cfg = ModelConfig.tiny()
    r = np.random.default_rng(seed)
    return TokenizedSplit(
        r.integers(1, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32),
        np.ones((n, cfg.max_len), np.int32),
        r.integers(0, 2, n).astype(np.int32),
    )


def _strip_ts(report: dict) -> dict:
    return {**report, "recompiles": [{k: v for k, v in e.items() if k != "ts"} for e in report["recompiles"]]}


# ------------------------------------------------------------ compile ledger
def test_ledger_counts_per_site_and_signature():
    """The first dispatch of each shape is noted once (a repeat counts
    nothing), its wall seconds attributed; the JAX ledger reports the
    same for the same sequence of notes."""
    reg = pobs.MetricsRegistry()
    led = CompileLedger(registry=reg)
    calls = []
    f = led.timed("t.step", lambda x: calls.append(x.shape) or x * 2, signature=lambda x: tuple(x.shape))
    for n in (2, 2, 3):
        f(torch.ones(n))
    assert len(calls) == 3
    assert led.compile_counts("t.step") == {(2,): 1, (3,): 1}
    rep = led.report()
    assert rep["sites"]["t.step"]["compiles"] == 2 and rep["sites"]["t.step"]["signatures"] == 2
    assert rep["sites"]["t.step"]["trace_s"] > 0.0 and rep["recompiles"] == []
    assert reg.snapshot()["families"]["fedtpu_xla_compiles_total"]["samples"][0]["value"] == 2.0
    # The same notes, untimed, through both packages' hooks.
    seq = [("a", (2,)), ("b", (1, 8)), ("a", (3,)), ("a", (2,))]
    reports = []
    for mod in (pprofile, jprofile):
        ledger = mod.CompileLedger(registry=(pobs if mod is pprofile else jobs).MetricsRegistry())
        for i, (site, sig) in enumerate(seq):
            ledger.hook(site)(sig)
            if i == 1:
                ledger.mark_warm("a")
        reports.append(_strip_ts(ledger.report()))
    assert reports[0] == reports[1]
    assert [e["signature"] for e in reports[0]["recompiles"]] == [(3,)]


def test_recompile_storm_exactly_one_event_per_new_signature():
    reg = pobs.MetricsRegistry()
    led = CompileLedger(registry=reg)
    f = led.timed("t.step", lambda x: x + 1, signature=lambda x: tuple(x.shape))
    f(torch.ones(2))
    led.mark_warm("t.step")
    for n in (4, 5, 6, 4, 5, 6, 2):
        f(torch.ones(n))
    assert [e["signature"] for e in led.recompiles("t.step")] == [(4,), (5,), (6,)]
    assert reg.snapshot()["families"]["fedtpu_xla_recompiles_total"]["samples"][0]["value"] == 3.0


def test_recompile_trips_flight_recorder(tmp_path):
    rec = pobs.FlightRecorder(str(tmp_path), proc="prof", min_interval_s=0.0)
    pobs.set_global_recorder(rec)
    try:
        led = CompileLedger(registry=pobs.MetricsRegistry())
        f = led.timed("t.step", lambda x: x, signature=lambda x: tuple(x.shape))
        f(torch.ones(2))
        led.mark_warm()
        f(torch.ones(3))
    finally:
        pobs.set_global_recorder(None)
    bundles = list(tmp_path.glob("postmortem-*.json"))
    assert len(bundles) == 1
    b = json.loads(bundles[0].read_text())
    assert b["reason"] == "xla-recompile" and b["extra"]["site"] == "t.step"


def test_ledger_untimed_site_counts_without_wrapper():
    led = CompileLedger(registry=pobs.MetricsRegistry())
    led.hook("bare")((2,))
    assert led.compile_counts("bare") == {(2,): 1}
    assert led.report()["sites"]["bare"]["trace_s"] == 0.0


# -------------------------------------------------------- step attribution
def test_step_profiler_zero_stride_is_off():
    reg = pobs.MetricsRegistry()
    prof = StepProfiler(0, site="train", registry=reg)
    assert not prof.enabled and all(not prof.tick() for _ in range(5))
    assert prof.summary() == {} and prof.span_attrs() == {}
    assert reg.snapshot()["families"] == {}
    set_profile_stride(0)
    assert maybe_step_profiler("train") is None
    assert [b for b, s in profiled_step_iter(None, iter([1, 2, 3]))] == [1, 2, 3]


def test_step_profiler_stride_sampling_and_summary():
    """The same ticks and durations give the JAX profiler's summary, span
    attrs and histogram counts."""
    out = []
    for mod, obs_mod in ((pprofile, pobs), (jprofile, jobs)):
        reg = obs_mod.MetricsRegistry()
        prof = mod.StepProfiler(2, site="train", registry=reg)
        ticks = [prof.tick() for _ in range(5)]
        for dt in (0.010, 0.020, 0.030):
            prof.note_host(0.001)
            prof.note_dispatch(0.002)
            prof._note("device", dt)
        wire = mod.StepProfiler(3, site="wire", registry=reg)
        wire.note("wire", 0.5)
        with pytest.raises(ValueError):
            wire.note("device", 0.1)
        out.append((ticks, prof.summary(), prof.span_attrs(), wire.span_attrs(), reg.render()))
    assert out[0] == out[1]
    ticks, s, attrs, _, _ = out[0]
    assert ticks == [True, False, True, False, True]
    assert s["device"]["p50"] == pytest.approx(0.020) and attrs["step_sampled"] == 3


def test_step_profiler_window_attrs_reset_per_fit():
    prof = StepProfiler(1, site="train", registry=pobs.MetricsRegistry())
    prof._note("device", 1.0)
    prof.begin_window()
    assert prof.span_attrs() == {}
    prof._note("device", 0.004)
    assert prof.span_attrs() == {"step_device_ms_p50": 4.0, "step_device_ms_p95": 4.0, "step_sampled": 1}
    prof._samples["device"].extend([0.001] * prof._max_samples)
    prof.begin_window()
    prof._note("device", 0.002)
    assert prof.span_attrs()["step_sampled"] == 1


def test_engine_fit_records_all_three_phases():
    cfg = ModelConfig.tiny()
    trainer = Trainer(cfg, TrainConfig(epochs_per_round=1), device="cpu")
    trainer.step_profiler = StepProfiler(1, site="train", registry=pobs.MetricsRegistry())
    state = trainer.init_state(seed=0)
    state, _ = trainer.fit(state, _tiny_split(16), batch_size=8)
    s = trainer.step_profiler.summary()
    assert set(s) == {"host", "dispatch", "device"} and s["device"]["n"] == 2
    attrs = trainer.step_profile_attrs()
    assert attrs["step_sampled"] == 2 and "step_device_ms_p50" in attrs
    bare = Trainer(cfg, TrainConfig(epochs_per_round=1), device="cpu")
    assert bare.step_profiler is None and bare.step_profile_attrs() == {}


def test_fit_arms_the_process_stride_and_fences_nothing_on_the_cpu(monkeypatch):
    """--profile-stride arms an already-built trainer at fit time; a CPU
    value needs no fence, so no torch.cuda.synchronize is called."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    trainer = Trainer(ModelConfig.tiny(), TrainConfig(epochs_per_round=1), device="cpu")
    set_profile_stride(2)
    try:
        trainer.fit(trainer.init_state(seed=0), _tiny_split(32), batch_size=8)
    finally:
        set_profile_stride(0)
    assert trainer.step_profiler.summary()["device"]["n"] == 2 and calls == []


# ------------------------------------------------------- memory watermarks
def test_note_memory_graceful_on_statsless_backend():
    """"Unavailable" on the CPU in both packages: no gauges, no raise."""
    reg = pobs.MetricsRegistry()
    assert device_memory_stats() is None and device_memory_stats("cpu") is None
    assert note_memory("t-none", registry=reg) is None
    assert pprofile.memory_report()["t-none"] == {"available": False}
    assert reg.snapshot()["families"] == {}

    class _Dev:
        def memory_stats(self):
            return None

    assert jprofile.note_memory("t-none", device=_Dev()) is None
    assert jprofile.memory_report()["t-none"] == pprofile.memory_report()["t-none"]


def test_note_memory_records_watermark_gauges(monkeypatch):
    stats = iter([
        {"bytes_in_use": 100, "peak_bytes_in_use": 150},
        {"bytes_in_use": 50, "peak_bytes_in_use": 60},
    ])
    monkeypatch.setattr(pprofile, "device_memory_stats", lambda device=None: next(stats))
    reg = pobs.MetricsRegistry()
    snap = note_memory("t-dev", registry=reg)
    assert snap["bytes_in_use"] == 100.0 and snap["peak_bytes"] == 150.0
    assert note_memory("t-dev", registry=reg)["peak_bytes"] == 150.0
    fams = reg.snapshot()["families"]
    assert fams["fedtpu_device_bytes_in_use"]["samples"][0]["value"] == 50.0
    assert fams["fedtpu_device_peak_bytes"]["samples"][0]["value"] == 150.0
    assert pprofile.peak_device_bytes() >= 150.0


def test_device_memory_stats_never_raises():
    assert device_memory_stats(object()) is None
    assert device_memory_stats("not-a-device") is None


# ------------------------------------------------------ FLOPs cross-check
def test_counted_flops_vs_analytic_within_two_percent():
    """On the CPU the attention is plain torch, so the counter sees every
    contraction the analytic model counts: the ratio sits within 2% of
    1.0 (and inside the tolerance the card's run is held to)."""
    cfg = ModelConfig.tiny(**NO_DROP)
    trainer = Trainer(cfg, TrainConfig(), device="cpu")
    state = trainer.init_state(seed=0)
    r = np.random.default_rng(0)
    batch = {
        "input_ids": r.integers(0, cfg.vocab_size, (4, cfg.max_len)).astype(np.int32),
        "attention_mask": np.ones((4, cfg.max_len), np.int32),
        "labels": r.integers(0, 2, 4).astype(np.int32),
    }
    counted = counted_flops(trainer.train_step, state, batch)
    ratio = counted / profiling.train_step_flops(cfg, 4)
    assert ratio == pytest.approx(1.0, rel=0.02)
    assert flops_ratio_ok(ratio) and flops_ratio_ok(None)
    assert not flops_ratio_ok(FLOPS_RATIO_TOLERANCE[1] * 2)
    assert FLOPS_RATIO_TOLERANCE == jprofile.FLOPS_RATIO_TOLERANCE


def test_counted_flops_of_no_matmul_is_none():
    assert counted_flops(lambda x: x + 1, torch.ones(3)) is None


# ------------------------------------------------- serving ledger dedupe
def test_serving_engine_rides_private_ledger():
    """One signature per warmed bucket, none after a storm of sizes or a
    swap of weights, per-engine counts."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
        init_params,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving.engine import (
        ScoreEngine,
    )

    cfg = ModelConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    eng = ScoreEngine(cfg, params, buckets=(1, 4), device="cpu")
    eng.warmup()
    L = cfg.max_len
    assert eng.compile_counts == {(1, L): 1, (4, L): 1}
    r = np.random.default_rng(0)
    for n in (1, 2, 3, 4, 1):
        eng.score(r.integers(0, cfg.vocab_size, (n, L)).astype(np.int32), np.ones((n, L), np.int32))
    eng.swap(init_params(cfg, torch.Generator().manual_seed(1)), round_id=1)
    eng.score(np.ones((3, L), np.int32), np.ones((3, L), np.int32))
    assert eng.compile_counts == {(1, L): 1, (4, L): 1} and eng.ledger.recompiles() == []
    assert eng.ledger.report()["sites"]["serving.probs"]["warm"]
    assert ScoreEngine(cfg, params, buckets=(1,), device="cpu").compile_counts == {}


# --------------------------------------------------------- session + CLI
def test_run_profile_session_tiny_end_to_end():
    """The session on the CPU, and its report's keys equal the JAX
    session's."""
    # An odd batch: a shape no other test dispatches, so the session's
    # ledger delta holds the train site.
    rep = run_profile_session(ModelConfig.tiny(), TrainConfig(), steps=4, batch_size=5, stride=1, device="cpu")
    assert rep["recompiles"] == [] and rep["flops_ratio_ok"]
    assert set(rep["step"]) == {"host", "dispatch", "device"} and rep["step"]["device"]["n"] == 4
    assert rep["serving"]["recompiles"] == 0 and rep["serving"]["compiles"] == 2
    assert {"post-first-step", "post-round"} <= set(rep["memory"])
    assert rep["flops_tolerance"] == list(FLOPS_RATIO_TOLERANCE)
    assert rep["flops_ratio"] == pytest.approx(1.0, rel=0.02)
    jrep = jprofile.run_profile_session(jcfg.ModelConfig.tiny(), jcfg.TrainConfig(), steps=2, batch_size=4, stride=1)
    assert set(rep) == set(jrep)
    assert set(rep["serving"]) == set(jrep["serving"])
    assert set(rep["step"]["device"]) == set(jrep["step"]["device"])
    site_keys = {"compiles", "signatures", "trace_s"}
    assert rep["sites"]["engine.train_step"]["compiles"] == 1
    assert all(set(v) == site_keys for v in [*rep["sites"].values(), *jrep["sites"].values()])
    text = pobs.render_profile_report(rep)
    assert "dispatch ledger" in text and "flops cross-check" in text and "serving bucketed path" in text


def test_xla_compile_span_in_vocabulary_and_timeline():
    assert "xla-compile" in pobs.SPAN_NAMES
    spans = [{
        "schema": pobs.SCHEMA, "proc": "client-0", "span": "xla-compile", "ts": 1.0, "dur_s": 0.8,
        "site": "engine.train_step", "signature": "(16, 128)", "recompile": True,
    }]
    table = pobs.timeline_table(spans)
    assert "xla-compile" in table and "site=engine.train_step" in table


def test_ledger_writes_xla_compile_spans_to_the_global_tracer(tmp_path):
    tracer = pobs.Tracer(str(tmp_path / "s.jsonl"), proc="client-0")
    pobs.set_global_tracer(tracer)
    try:
        trainer = Trainer(ModelConfig.tiny(), TrainConfig(epochs_per_round=1), device="cpu")
        trainer.fit(trainer.init_state(seed=0), _tiny_split(8, 3), batch_size=8)
    finally:
        pobs.set_global_tracer(None)
    spans = pobs.load_spans([str(tmp_path / "s.jsonl")])
    mine = [s for s in spans if s["span"] == "xla-compile" and s["site"] == "engine.train_step"]
    assert [s["signature"] for s in mine] in ([], ["(8, 32)"])  # the site may already know the shape
    assert all(s["dur_s"] >= 0.0 for s in spans)


def test_profile_stride_config_flag_round_trip():
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
        ObsConfig,
    )

    assert ObsConfig().profile_stride == 0 and ObsConfig(profile_stride=8).profile_stride == 8
    with pytest.raises(ValueError):
        ObsConfig(profile_stride=-1)


def test_client_local_span_attrs_via_federated_fit(tmp_path):
    """The federated fit writes one client-local span with the sampled
    step attrs (and the aggregation an agg span), as the JAX trainer."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        FedConfig,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
        stack_clients,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.federated import (
        FederatedTrainer,
    )

    model = ModelConfig.tiny()
    cfg = ExperimentConfig(
        model=model, data=DataConfig(max_len=model.max_len, batch_size=4),
        train=TrainConfig(epochs_per_round=1), fed=FedConfig(num_clients=2, rounds=1),
    )
    trainer = FederatedTrainer(cfg, device="cpu")
    path = tmp_path / "spans.jsonl"
    trainer.tracer = pobs.Tracer(str(path), proc="fed")
    trainer.step_profiler = StepProfiler(1, site="train", registry=pobs.MetricsRegistry())
    state = trainer.init_state(seed=0)
    state, _ = trainer.fit_local(state, stack_clients([_tiny_split(8, 1), _tiny_split(8, 2)]))
    trainer.round_aggregate(state, round_index=0)
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    local = [r for r in recs if r["span"] == "client-local"]
    assert len(local) == 1 and local[0]["step_sampled"] == 2 and "step_device_ms_p50" in local[0]
    assert local[0]["round"] == 0 and local[0]["path"] == "fed2" and local[0]["clients"] == 2
    assert [r["span"] for r in recs] == ["client-local", "agg"]


def test_profiled_step_iter_matches_jax():
    for stride in (0, 1, 3):
        got = []
        for mod, obs_mod in ((pprofile, pobs), (jprofile, jobs)):
            prof = mod.StepProfiler(stride, site="train", registry=obs_mod.MetricsRegistry())
            got.append((list(mod.profiled_step_iter(prof, iter(range(7)))), prof.summary().get("host", {}).get("n")))
        assert got[0] == got[1]


# ------------------------------------------------------------ profiling
def test_train_step_is_3x_forward():
    cfg = ModelConfig.tiny()
    assert profiling.train_step_flops(cfg, 8) == pytest.approx(3 * profiling.forward_flops(cfg, 8))


@pytest.mark.parametrize("preset", ["tiny", "distilbert", "bert", "bert-large"])
def test_forward_flops_scaling(preset):
    """The analytic counts equal the JAX package's at every preset."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.presets import (
        model_preset as jax_preset,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.presets import (
        model_preset,
    )

    cfg, jc = model_preset(preset), jax_preset(preset)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    for b, L in ((1, None), (16, None), (4, 40)):
        assert profiling.forward_flops(cfg, b, L) == jprofiling.forward_flops(jc, b, L)
        assert profiling.train_step_flops(cfg, b, L) == jprofiling.train_step_flops(jc, b, L)
    deep = cfg.replace(n_layers=2 * cfg.n_layers)
    head = 2 * cfg.dim * cfg.n_classes
    assert profiling.forward_flops(deep, 1) - head == pytest.approx(2 * (profiling.forward_flops(cfg, 1) - head))


def test_forward_flops_matches_counted_forward():
    """The analytic forward count equals what FlopCounterMode counts over
    a CPU forward (every contraction is a torch matmul there)."""
    from torch.utils.flop_counter import FlopCounterMode

    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.distilbert import (
        build_model,
        init_params,
    )

    cfg = ModelConfig.tiny(dim=64, n_heads=4, hidden_dim=256, max_len=64, max_position_embeddings=64, **NO_DROP)
    model = build_model(cfg, init_params(cfg, torch.Generator().manual_seed(0)), torch.device("cpu"))
    ids = torch.zeros((4, cfg.max_len), dtype=torch.int64)
    mask = torch.ones((4, cfg.max_len), dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(ids, mask)
    assert counter.get_total_flops() == pytest.approx(profiling.forward_flops(cfg, 4), rel=1e-6)


def test_device_peak_flops_table(monkeypatch):
    for name, tflops in [
        ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 SXM5 80GB", 989.0),
        ("NVIDIA H100 PCIe", 756.0), ("NVIDIA H100 NVL", 835.0),
    ]:
        assert profiling.peak_tflops(name) == tflops, name
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        assert profiling.device_peak_flops() == pytest.approx(tflops * 1e12)
    assert profiling.peak_tflops("NVIDIA A100-SXM4-80GB") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert profiling.device_peak_flops() is None
    assert profiling.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_peak_flops() is None


def test_mfu_math():
    for mod in (profiling, jprofiling):
        assert mod.mfu(1e12, 0.01, peak_flops_per_device=989e12) == pytest.approx(1e12 / (0.01 * 989e12))
        assert mod.mfu(1e12, 0.01, n_devices=2, peak_flops_per_device=989e12) == pytest.approx(
            1e12 / (0.01 * 989e12) / 2
        )
    assert profiling.mfu(1e12, 0.0, peak_flops_per_device=989e12) is None


def test_trace_noop_and_real(tmp_path):
    with profiling.trace(None):
        pass
    out = tmp_path / "prof"
    with profiling.trace(str(out)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (name,) = os.listdir(out)
    with open(out / name) as f:
        doc = json.load(f)
    assert any(e.get("name", "").startswith("aten::mm") for e in doc["traceEvents"])
