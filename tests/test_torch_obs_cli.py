"""The port's obs command line held against the JAX package's:

* every obs flag of every ported verb parses to the JAX parser's value,
  and its default too (parametrised verb x flag);
* ``obs timeline|export|tail|postmortem|profile`` answer with the JAX
  output's keys (``--json``) or lines; ``obs health|watch|sentinel``
  parse as the JAX verb's and refuse a call without inputs as it does
  (their outputs are held in ``test_torch_health.py`` and
  ``test_torch_sentinel.py``);
* ``--metrics-jsonl`` records of ``local``, ``federated`` and ``client``
  have the JAX records' keys, and their metrics agree at the tolerances
  of the CLI parity tests (dropout off, the JAX init in both);
* ``infer-serve --trace-sample`` writes one ``serve-batch`` span per
  stride of batches, and ``--scored-jsonl`` one row per answered
  request with the reply's prob; ``--trace-jsonl``/``--profile-stride``
  reach the scorer through the verb's own setup.
"""

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    obs as jobs,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    build_parser as jax_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm.server import (
    AggregationServer as JaxServer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models import (
    presets as jpresets,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    obs as pobs,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
    main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    presets as ppresets,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.convert import (
    params_from_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    engine as pengine,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    federated as pfederated,
)

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
METRICS = ("Accuracy", "Precision", "Recall", "F1-Score")

# ------------------------------------------------------------ the flags
#: (flag, value, dest) of the JAX package's per-verb obs flags.
COMMON = [
    ("--profile-dir", "p", "profile_dir"),
    ("--metrics-jsonl", "m.jsonl", "metrics_jsonl"),
    ("--trace-jsonl", "t.jsonl", "trace_jsonl"),
    ("--profile-stride", "3", "profile_stride"),
]
#: verb -> the argv it needs to parse at all.
VERBS = {
    "local": [], "federated": [], "client": ["--client-id", "0"], "distill": [], "predict": [],
    "infer-serve": [], "export-hf": ["--out", "o"], "export-config": [],
}
DAEMON = {
    "serve": [("--trace-jsonl", "t.jsonl", "trace_jsonl"), ("--metrics-port", "9100", "metrics_port"),
              ("--flight-dir", "fl", "flight_dir")],
    "infer-serve": [("--metrics-port", "9100", "metrics_port"), ("--trace-sample", "0.25", "trace_sample"),
                    ("--scored-jsonl", "s.jsonl", "scored_jsonl"), ("--flight-dir", "fl", "flight_dir")],
}
OBS = [
    ("--trace-dir", "d", "trace_dir"), ("--trace", "a.jsonl", "trace"), ("--round", "2", "round"),
    ("--trace-id", "aa", "trace_id"), ("--from-start", None, "from_start"), ("--poll", "0.1", "poll"),
    ("--max-seconds", "1.5", "max_seconds"), ("--json", None, "json"), ("--out", "o.json", "out"),
    ("--flight-dir", "fl", "flight_dir"), ("--bundle", "b.json", "bundle"), ("--preset", "distilbert", "preset"),
    ("--steps", "3", "steps"), ("--batch-size", "4", "batch_size"), ("--stride", "0", "stride"),
    ("--capture", "cap", "capture"),
]
CASES = (
    [(verb, need, *flag) for verb, need in VERBS.items() for flag in COMMON]
    + [(verb, VERBS.get(verb, []), *flag) for verb, flags in DAEMON.items() for flag in flags]
    + [("obs", ["timeline"], *flag) for flag in OBS]
)


@pytest.mark.parametrize(
    "verb,need,flag,value,dest", CASES, ids=[f"{c[0]}{c[2]}" for c in CASES]
)
def test_obs_flag_parses_to_the_jax_value(verb, need, flag, value, dest):
    given = [flag] if value is None else [flag, value]
    for argv in ([verb, *need, *given], [verb, *need]):
        port = getattr(build_parser().parse_args(argv), dest)
        want = getattr(jax_parser().parse_args(argv), dest)
        assert port == want and type(port) is type(want), (argv, port, want)


@pytest.mark.parametrize("action", ["health", "watch", "sentinel"])
def test_fleet_read_side_actions_are_refused(action, capsys):
    """``obs health|watch|sentinel`` parse to the JAX parser's namespace
    (every shared dest, with its default), and without a target or a rung
    they are refused as the JAX verb refuses them."""
    port_ns = vars(build_parser().parse_args(["obs", action]))
    jax_ns = vars(jax_parser().parse_args(["obs", action]))
    shared = set(port_ns) & set(jax_ns) - {"fn", "cmd", "command", "device"}
    assert {"target", "slo", "canaries", "serve", "ring_jsonl", "trend_field"} <= shared
    assert {k: port_ns[k] for k in shared} == {k: jax_ns[k] for k in shared}
    msgs = []
    for m in (jax_main, main):
        with pytest.raises(SystemExit) as e:
            m(["obs", action])
        msgs.append(str(e.value).replace("fedtpu obs", "obs"))
    assert msgs[1] == msgs[0] and ("--target" in msgs[0] or "rung" in msgs[0])


# ---------------------------------------------------- obs actions' output
def _spans_dir(tmp_path):
    d = tmp_path / "spans"
    t = pobs.Tracer(str(d / "server.jsonl"), proc="server")
    t.record("round", t_start=1.0, dur_s=0.5, trace="aa", round=0)
    t.record("agg", t_start=1.3, dur_s=0.1, trace="aa", round=0, contributors=[0])
    jobs.Tracer(str(d / "client0.jsonl"), proc="client-0").record(
        "client-local", t_start=0.9, dur_s=0.3, trace="aa", round=0, client=0
    )
    return str(d)


def _run(m, argv, capsys) -> str:
    capsys.readouterr()
    assert m(argv) == 0
    return capsys.readouterr().out


def test_obs_timeline_export_tail_outputs_equal_jax(tmp_path, capsys):
    d = _spans_dir(tmp_path)
    for argv in (["obs", "timeline", "--trace-dir", d], ["obs", "timeline", "--trace-dir", d, "--json"],
                 ["obs", "tail", "--trace-dir", d, "--from-start", "--max-seconds", "0.2", "--poll", "0.05"]):
        assert _run(main, argv, capsys) == _run(jax_main, argv, capsys), argv
    rounds = json.loads(_run(main, ["obs", "timeline", "--trace-dir", d, "--json"], capsys))
    assert set(rounds[0]) == set(jobs.round_summaries(jobs.load_spans(trace_dir=d))[0])
    for name, m in (("port", main), ("jax", jax_main)):
        _run(m, ["obs", "export", "--trace-dir", d, "--out", str(tmp_path / f"{name}.json")], capsys)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_obs_postmortem_json_equal_jax(tmp_path, capsys):
    rec = pobs.FlightRecorder(str(tmp_path / "fl"), proc="serve", config={"proc": "serve"})
    rec.note_span({"schema": pobs.SCHEMA, "proc": "serve", "span": "serve-batch", "ts": 1.0, "dur_s": 0.01})
    path = rec.dump("scoring-error", extra={"rejected": 2})
    fl = str(tmp_path / "fl")
    listed = json.loads(_run(main, ["obs", "postmortem", "--flight-dir", fl, "--json"], capsys))
    assert listed == json.loads(_run(jax_main, ["obs", "postmortem", "--flight-dir", fl, "--json"], capsys))
    assert [b["reason"] for b in listed] == ["scoring-error"]
    for argv in (["obs", "postmortem", "--flight-dir", fl, "--bundle", os.path.basename(path), "--json"],
                 ["obs", "postmortem", "--flight-dir", fl, "--bundle", os.path.basename(path)],
                 ["obs", "postmortem", "--flight-dir", fl]):
        assert _run(main, argv, capsys) == _run(jax_main, argv, capsys), argv
    with pytest.raises(SystemExit):
        main(["obs", "postmortem"])


def test_obs_profile_json_keys_equal_jax(capsys):
    argv = ["obs", "profile", "--preset", "tiny", "--steps", "2", "--batch-size", "4", "--json"]
    rep = json.loads(_run(main, argv + ["--device", "cpu"], capsys))
    out = _run(jax_main, argv, capsys)
    jrep = json.loads(out[out.index("{"):])
    assert set(rep) == set(jrep)
    assert rep["serving"]["recompiles"] == 0 and rep["flops_ratio_ok"] and rep["recompiles"] == []
    assert set(rep["serving"]) == set(jrep["serving"])
    assert rep["memory"]["post-round"] == {"available": False}


def test_obs_profile_renders_report_on_the_flash_path(capsys):
    """``obs profile`` profiles the flash path (its plain version on the
    CPU), and refuses to run on a machine without CUDA unless asked for
    the CPU."""
    out = _run(main, ["obs", "profile", "--preset", "tiny", "--steps", "2", "--batch-size", "4", "--device", "cpu"],
               capsys)
    assert "dispatch ledger" in out and "flops cross-check" in out and "serving bucketed path" in out
    with pytest.raises(RuntimeError, match="device='cpu'"):
        import unittest.mock

        with unittest.mock.patch.object(torch.cuda, "is_available", lambda: False):
            main(["obs", "profile", "--preset", "tiny", "--steps", "1"])


# ----------------------------------------------------- --metrics-jsonl
@pytest.fixture
def jax_init(monkeypatch):
    """Dropout off in both presets, and the port's trainers start from
    the JAX trainers' init (seed 0), as the CLI parity tests do."""
    monkeypatch.setitem(ppresets.PRESETS, "tiny", lambda **kw: pcfg.ModelConfig.tiny(**NO_DROP, **kw))
    monkeypatch.setitem(jpresets.PRESETS, "tiny", lambda **kw: jcfg.ModelConfig.tiny(**NO_DROP, **kw))

    def port_init(cfg, generator):
        jm = jcfg.ModelConfig(**dataclasses.asdict(cfg))
        tree = jax_init_params(JaxClassifier(jm), jm, jax.random.key(0, impl="rbg"))
        return params_from_jax(jax.tree.map(np.asarray, tree))

    monkeypatch.setattr(pengine, "init_params", port_init)
    monkeypatch.setattr(pfederated, "init_params", port_init)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _assert_records_match(port, jax_recs):
    assert len(port) == len(jax_recs) > 0
    for p, j in zip(port, jax_recs):
        assert set(p) == set(j), (sorted(p), sorted(j))
        assert p["schema"] == j["schema"] == "fedtpu-metrics-v1"
        for k in ("round", "client", "phase", "split"):
            assert p.get(k) == j.get(k), k
        for k in METRICS:
            np.testing.assert_allclose(p[k], j[k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(p["Loss"], j["Loss"], rtol=1e-5)


def test_local_metrics_jsonl_matches_jax(tmp_path, jax_init):
    argv = ["local", "--preset", "tiny", "--synthetic", "600", "--epochs", "1"]
    for name, m, extra in (("jax", jax_main, []), ("port", main, ["--device", "cpu"])):
        assert m(argv + extra + ["--output-dir", str(tmp_path / name),
                                 "--metrics-jsonl", str(tmp_path / f"{name}.jsonl")]) == 0
    recs = _records(tmp_path / "port.jsonl")
    assert [r["phase"] for r in recs] == ["val", "test"]
    _assert_records_match(recs, _records(tmp_path / "jax.jsonl"))


def test_federated_metrics_jsonl_matches_jax(tmp_path, jax_init):
    argv = ["federated", "--preset", "tiny", "--synthetic", "600", "--num-clients", "2", "--rounds", "2",
            "--epochs", "1"]
    for name, m, extra in (("jax", jax_main, []), ("port", main, ["--device", "cpu"])):
        assert m(argv + extra + ["--output-dir", str(tmp_path / name),
                                 "--metrics-jsonl", str(tmp_path / f"{name}.jsonl")]) == 0
    recs = _records(tmp_path / "port.jsonl")
    assert len(recs) == 2 * 2 * 4  # rounds x clients x (local, aggregated) x (val, test)
    _assert_records_match(recs, _records(tmp_path / "jax.jsonl"))


def test_client_metrics_jsonl_matches_jax(tmp_path, jax_init):
    """One round of each package's client against a JAX server, one
    client to a round: the port client's records are the JAX client's."""
    argv = ["client", "--client-id", "0", "--host", "127.0.0.1", "--preset", "tiny", "--synthetic", "300",
            "--epochs", "1", "--timeout", "60"]
    for name, m, extra in (("jax", jax_main, []), ("port", main, ["--device", "cpu"])):
        with JaxServer(port=0, num_clients=1, timeout=60, stream_chunk_bytes=0) as server:
            t = threading.Thread(target=lambda: server.serve_round(deadline=60.0), daemon=True)
            t.start()
            assert m(argv + extra + ["--port", str(server.port), "--output-dir", str(tmp_path / name),
                                     "--metrics-jsonl", str(tmp_path / f"{name}.jsonl")]) == 0
            t.join(timeout=60)
    recs = _records(tmp_path / "port.jsonl")
    assert [(r["round"], r["phase"]) for r in recs] == [(1, "local"), (1, "aggregated")]
    _assert_records_match(recs, _records(tmp_path / "jax.jsonl"))


# ------------------------------------------ --trace-sample / --scored-jsonl
def test_infer_serve_trace_sample_and_scored_rows(tmp_path):
    """``--trace-sample 0.25`` writes the serve-batch span of batches 1,
    5, 9, ... (a stride of 4, each span saying so); ``--scored-jsonl``
    one row per answered request whose prob is the reply's; the scored
    counter and the private ledger agree."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.registry import (
        ModelRegistry as JaxRegistry,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
        build_server,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.tokenizer import (
        default_tokenizer,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
        ScoringClient,
    )

    cfg = jcfg.ModelConfig.tiny(vocab_size=len(default_tokenizer().vocab))
    registry = JaxRegistry(str(tmp_path / "reg"))
    registry.promote(
        registry.add(jax_init_params(JaxClassifier(cfg), cfg, jax.random.key(1)), round_index=1, model_config=cfg),
        to="serving",
    )
    spans, scored = tmp_path / "serve.jsonl", tmp_path / "scored.jsonl"
    args = build_parser().parse_args([
        "infer-serve", "--registry-dir", str(tmp_path / "reg"), "--device", "cpu", "--host", "127.0.0.1",
        "--port", "0", "--max-wait-ms", "1", "--buckets", "1,4", "--trace-jsonl", str(spans),
        "--trace-sample", "0.25", "--scored-jsonl", str(scored), "--profile-stride", "2",
    ])
    reg = pobs.default_registry()
    before = sum(s["value"] for s in reg.snapshot()["families"].get("fedtpu_serve_scored_total", {"samples": []})["samples"])
    n = 10
    with build_server(args) as server:
        with ScoringClient("127.0.0.1", server.port) as client:
            replies = [client.score(text=f"flow {i} bytes {i * 7}") for i in range(n)]  # one batch each
        batches = server.stats()["batches"]
        profiler = server.engine.step_profiler
    pobs.set_profile_stride(0)
    assert batches == n
    after = sum(s["value"] for s in reg.snapshot()["families"]["fedtpu_serve_scored_total"]["samples"])
    assert after - before == n
    rows = _records(scored)
    assert [r["rid"] for r in rows] == [str(r["id"]) for r in replies]
    assert [r["prob"] for r in rows] == [round(r["prob"], 6) for r in replies]
    assert {r["schema"] for r in rows} == {"fedtpu-scored-v1"} and {r["round"] for r in rows} == {1}
    got = [s for s in pobs.load_spans([str(spans)]) if s["span"] == "serve-batch"]
    assert len(got) == -(-n // 4) and all(s["sampled_batches"] == 4 for s in got)
    assert all(s["proc"] == "serve" and s["batch_size"] == 1 for s in got)
    # The score step profiler sampled every 2nd dispatch (warmup included).
    assert profiler is not None and profiler.summary()["device"]["n"] == (n + 2 + 1) // 2
    assert server.engine.compile_counts == {(1, cfg.max_len): 1, (4, cfg.max_len): 1}
