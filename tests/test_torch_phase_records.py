"""The port's phase records (``obs/profile.py``): one record a call of
``Trainer``'s train step (``engine.train_step``) and of
``ScoreEngine.score`` (``serving.score``), with contiguous phases that sum
to the call, in a bounded log threads share, stamped on the clock
``torch.profiler`` stamps its events with. The instrumented paths compute
bit for bit what they computed before the stamps, and ``StepProfiler``
reads a sampled call's host times from its record.

The JAX package has no phase records: these tests hold the port to its
own earlier code path, written out here.
"""

import threading

import numpy as np
import pytest
import torch
from torch.func import functional_call

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
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.distilbert import (
    init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.obs.profile import (
    PHASE_LOG_LEN,
    PhaseLog,
    StepProfiler,
    phase_clock,
    phase_log,
    phase_records,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel.mesh import (
    gather_tree,
    make_host_mesh,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving.engine import (
    SCORE_PHASES,
    ScoreEngine,
    ShardedParams,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.client_mesh import (
    MeshTrainer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    STEP_PHASES,
    Trainer,
    prox_sq,
)

TRAIN_PHASES = ("place", "forward", "backward", "optimizer")
SCORE = ("prep", "dispatch", "wait")


def _tiny_split(n: int = 16, seed: int = 0) -> TokenizedSplit:
    cfg = ModelConfig.tiny()
    r = np.random.default_rng(seed)
    return TokenizedSplit(
        r.integers(1, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32),
        np.ones((n, cfg.max_len), np.int32),
        r.integers(0, 2, n).astype(np.int32),
    )


def _batch(n: int = 4, seed: int = 0) -> dict:
    s = _tiny_split(n, seed)
    return {"input_ids": s.input_ids, "attention_mask": s.attention_mask, "labels": s.labels}


def _last_seq(site: str) -> int:
    recs = phase_records(site)
    return recs[-1].seq if recs else -1


def _mine(site: str, owner, after: int) -> list:
    """``owner``'s records after sequence number ``after`` (an id can be
    reused by an object made after an earlier one died)."""
    return [r for r in phase_records(site) if r.owner == id(owner) and r.seq > after]


def _engine(buckets=(1, 4, 8), mesh=None) -> ScoreEngine:
    cfg = ModelConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(3))
    if mesh is not None:
        return ScoreEngine(cfg, params, buckets=buckets, mesh=mesh)
    return ScoreEngine(cfg, params, buckets=buckets, device="cpu")


def _assert_contiguous(rec, phases):
    assert rec.phases == phases and len(rec.ends_ns) == len(phases)
    bounds = (rec.start_ns, *rec.ends_ns)
    assert all(a <= b for a, b in zip(bounds, bounds[1:]))
    assert sum(rec.phase_ns().values()) == rec.call_ns == rec.end_ns - rec.start_ns > 0
    assert list(rec.phase_ns()) == list(phases)


# ------------------------------------------------------------- one a call
def test_train_step_appends_one_contiguous_record_a_call():
    trainer = Trainer(ModelConfig.tiny(), TrainConfig(), device="cpu")
    state = trainer.init_state(seed=0)
    after = _last_seq("engine.train_step")
    t_before = phase_clock()
    for i in range(3):
        state, _ = trainer.train_step(state, _batch(seed=i))
    t_after = phase_clock()
    recs = _mine("engine.train_step", trainer, after)
    assert len(recs) == 3 and trainer.last_step_record == recs[-1]
    for rec in recs:
        assert rec.site == "engine.train_step"
        _assert_contiguous(rec, TRAIN_PHASES)
        assert t_before <= rec.start_ns and rec.end_ns <= t_after
    assert [r.seq for r in recs] == sorted(r.seq for r in recs) and len({r.seq for r in recs}) == 3
    assert all(a.end_ns <= b.start_ns for a, b in zip(recs, recs[1:]))


def test_score_appends_one_contiguous_record_a_call():
    eng = _engine()
    cfg = ModelConfig.tiny()
    rng = np.random.default_rng(0)
    after = _last_seq("serving.score")
    for n in (1, 3, 8):
        eng.score(rng.integers(0, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32), np.ones((n, cfg.max_len), np.int32))
    recs = _mine("serving.score", eng, after)
    assert len(recs) == 3
    for rec in recs:
        assert rec.site == "serving.score"
        _assert_contiguous(rec, SCORE)
    with pytest.raises(ValueError):  # a refused call leaves no record
        eng.score(np.zeros((2, cfg.max_len + 1), np.int32), np.zeros((2, cfg.max_len + 1), np.int32))
    assert len(_mine("serving.score", eng, after)) == 3


# ------------------------------------------------------------- the log
def test_log_is_bounded_and_read_as_a_copy():
    log = PhaseLog("t.bounded", ("a", "b"), maxlen=8)
    owner = object()
    for i in range(20):
        log.record(owner, 10 * i, (10 * i + 3, 10 * i + 7))
    recs = log.records()
    assert [r.seq for r in recs] == list(range(12, 20))
    assert recs[0].phase_ns() == {"a": 3, "b": 4} and recs[0].owner == id(owner)
    recs.clear()
    assert len(log.records()) == 8
    assert STEP_PHASES.maxlen >= 16_384 and SCORE_PHASES.maxlen >= 16_384 and PHASE_LOG_LEN >= 16_384
    assert phase_log("engine.train_step", TRAIN_PHASES) is STEP_PHASES
    with pytest.raises(ValueError):
        phase_log("engine.train_step", ("forward",))
    assert phase_records("no.such.site") == []


def test_two_threads_share_one_log():
    log = PhaseLog("t.threads", ("a", "b", "c"), maxlen=100_000)
    per = 5_000
    start = threading.Barrier(2)

    def work(owner):
        start.wait()
        for _ in range(per):
            t0 = phase_clock()
            log.record(owner, t0, (phase_clock(), phase_clock(), phase_clock()))

    owners = [object(), object()]
    threads = [threading.Thread(target=work, args=(o,)) for o in owners]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = log.records()
    assert len(recs) == 2 * per and sorted(r.seq for r in recs) == list(range(2 * per))
    for o in owners:
        mine = [r for r in recs if r.owner == id(o)]
        assert len(mine) == per
        assert all(a.seq < b.seq and a.end_ns <= b.start_ns for a, b in zip(mine, mine[1:]))


# ------------------------------------------------------- bit-identical
def _earlier_train_step(trainer, state, batch, anchor=None):
    """The train step's body as it was before its phase stamps."""
    ids, mask, labels = trainer._batch(batch)
    names = list(state.opt_state.mu)
    logits = trainer._logits(state.params, ids, mask, generator=state.generator)
    loss = trainer._loss(logits, ids, mask, labels)
    if anchor is not None:
        mu = float(trainer.train_cfg.prox_mu)
        loss = loss + 0.5 * mu * prox_sq([state.params[n] for n in names], [anchor[n] for n in names])
    grads = torch.autograd.grad(loss, [state.params[n] for n in names])
    with torch.no_grad():
        trainer._update(state, names, list(grads))
    state.step += 1
    return state, loss.detach()


@pytest.mark.parametrize("prox_mu", [0.0, 0.01])
def test_train_step_is_bit_identical_to_the_unstamped_step(prox_mu):
    cfg = ModelConfig.tiny()
    tcfg = TrainConfig(prox_mu=prox_mu)
    runs = []
    for stamped in (True, False):
        trainer = Trainer(cfg, tcfg, device="cpu")
        state = trainer.init_state(seed=5)
        anchor = {n: state.params[n].detach().clone() for n in state.opt_state.mu} if prox_mu else None
        losses = []
        for i in range(3):
            if stamped:
                state, loss = trainer.train_step(state, _batch(seed=i), anchor)
            else:
                state, loss = _earlier_train_step(trainer, state, _batch(seed=i), anchor)
            losses.append(loss)
        runs.append((losses, state))
    (la, sa), (lb, sb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert sa.params.keys() == sb.params.keys()
    assert all(torch.equal(sa.params[n], sb.params[n]) for n in sa.params)
    assert all(torch.equal(sa.opt_state.mu[n], sb.opt_state.mu[n]) for n in sa.opt_state.mu)
    assert all(torch.equal(sa.opt_state.nu[n], sb.opt_state.nu[n]) for n in sa.opt_state.nu)


def _earlier_score(eng, input_ids, attention_mask):
    """``ScoreEngine.score`` as it was before its phase stamps: the copies
    to the device inside the forward's inference mode."""
    n = int(input_ids.shape[0])
    bucket = eng.bucket_for(n)
    if n < bucket:
        input_ids = np.concatenate([input_ids, np.full((bucket - n, eng.seq_len), eng.pad_id, np.int32)])
        attention_mask = np.concatenate([attention_mask, np.zeros((bucket - n, eng.seq_len), np.int32)])
    model, round_id = eng.snapshot()
    ids = torch.from_numpy(np.ascontiguousarray(input_ids, np.int64))
    mask = torch.from_numpy(np.ascontiguousarray(attention_mask, np.int32))
    with torch.inference_mode():
        if isinstance(model, ShardedParams):
            full = gather_tree(model, eng.device)
            logits = functional_call(eng._skeleton, full, (ids.to(eng.device), mask.to(eng.device)))
        else:
            logits = model(ids.to(eng.device), mask.to(eng.device))
        class_probs = torch.softmax(logits, dim=-1)
        probs = class_probs[:, 1] if logits.shape[-1] == 2 else 1.0 - class_probs[:, 0]
    return probs.cpu().numpy()[:n], class_probs.cpu().numpy()[:n], bucket, round_id


@pytest.mark.parametrize("sharded", [False, True])
def test_score_is_bit_identical_to_the_unstamped_call(sharded):
    eng = _engine(mesh=make_host_mesh(2, device="cpu") if sharded else None)
    cfg = ModelConfig.tiny()
    rng = np.random.default_rng(1)
    for n in (1, 2, 4, 7):
        ids = rng.integers(0, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
        mask = (rng.random((n, cfg.max_len)) < 0.8).astype(np.int32)
        mask[:, 0] = 1
        got, want = eng.score(ids, mask), _earlier_score(eng, ids, mask)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[0].dtype == want[0].dtype and got[2:] == want[2:]


# ------------------------------------------------------- StepProfiler
def test_sampled_fit_step_dispatch_is_the_record_s_call():
    trainer = Trainer(ModelConfig.tiny(), TrainConfig(epochs_per_round=1), device="cpu")
    prof = trainer.step_profiler = StepProfiler(1, site="train", registry=pobs.MetricsRegistry())
    state = trainer.init_state(seed=0)
    after = _last_seq("engine.train_step")
    trainer.fit(state, _tiny_split(24), batch_size=8)
    recs = _mine("engine.train_step", trainer, after)
    assert len(recs) == 3
    assert prof._samples["dispatch"] == [r.call_ns * 1e-9 for r in recs]
    assert len(prof._samples["device"]) == 3 and len(prof._samples["host"]) == 3


def test_sampled_score_host_and_dispatch_are_the_record_s_phases():
    eng = _engine()
    prof = eng.step_profiler = StepProfiler(2, site="score", registry=pobs.MetricsRegistry())
    cfg = ModelConfig.tiny()
    after = _last_seq("serving.score")
    for n in (1, 4, 3, 8):
        eng.score(np.ones((n, cfg.max_len), np.int32), np.ones((n, cfg.max_len), np.int32))
    sampled = _mine("serving.score", eng, after)[::2]  # calls 0 and 2
    assert prof._samples["host"] == [r.phase_ns()["prep"] * 1e-9 for r in sampled]
    assert prof._samples["dispatch"] == [r.phase_ns()["dispatch"] * 1e-9 for r in sampled]
    assert len(prof._samples["device"]) == 2


def test_a_step_that_keeps_no_record_is_timed_by_the_clock():
    """A trainer whose own step keeps no phase record (the per-process
    mesh) still gets its sampled dispatch, from the clock around it."""
    trainer = MeshTrainer(ModelConfig.tiny(), TrainConfig(epochs_per_round=1), mesh=make_host_mesh(2, device="cpu"))
    prof = trainer.step_profiler = StepProfiler(1, site="train", registry=pobs.MetricsRegistry())
    after = _last_seq("engine.train_step")
    trainer.fit(trainer.init_state(seed=0), _tiny_split(16), batch_size=8)
    assert len(prof._samples["dispatch"]) == 2 and all(x > 0 for x in prof._samples["dispatch"])
    assert trainer.last_step_record is None and _mine("engine.train_step", trainer, after) == []


# ------------------------------------------------------- the shared clock
def _profile_events(prof) -> list[tuple[str, int, int]]:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()]


def test_records_share_the_profiler_s_clock():
    """Each record of a train step and a score call made inside a
    ``record_function`` range lies inside that range's profiler stamps,
    within 50 µs; a profiler on another clock puts it seconds away."""
    from torch.profiler import ProfilerActivity, profile, record_function

    trainer = Trainer(ModelConfig.tiny(), TrainConfig(), device="cpu")
    state = trainer.init_state(seed=0)
    eng = _engine()
    cfg = ModelConfig.tiny()
    state, _ = trainer.train_step(state, _batch())  # first dispatches outside the profile
    eng.score(np.ones((4, cfg.max_len), np.int32), np.ones((4, cfg.max_len), np.int32))
    after = (_last_seq("engine.train_step"), _last_seq("serving.score"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            state, _ = trainer.train_step(state, _batch(seed=1))
            eng.score(np.ones((4, cfg.max_len), np.int32), np.ones((4, cfg.max_len), np.int32))
    outer = [(s, e) for n, s, e in _profile_events(prof) if n == "outer"]
    assert len(outer) == 1
    lo, hi = outer[0]
    slack = 50_000
    recs = _mine("engine.train_step", trainer, after[0]) + _mine("serving.score", eng, after[1])
    assert len(recs) == 2
    for rec in recs:
        assert lo - slack <= rec.start_ns and rec.end_ns <= hi + slack, (rec, lo, hi)


def test_records_add_no_range_to_a_profile():
    """The stamps are not ``record_function`` ranges: a profile of a step
    and a call holds no event named for a site or a phase."""
    from torch.profiler import ProfilerActivity, profile

    trainer = Trainer(ModelConfig.tiny(), TrainConfig(), device="cpu")
    state = trainer.init_state(seed=0)
    eng = _engine()
    cfg = ModelConfig.tiny()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(state, _batch())
        eng.score(np.ones((4, cfg.max_len), np.int32), np.ones((4, cfg.max_len), np.int32))
    names = {n for n, _, _ in _profile_events(prof)}
    assert names and not any(n.startswith(("engine.", "serving.")) for n in names)
    assert not names & set(TRAIN_PHASES + SCORE)
