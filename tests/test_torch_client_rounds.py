"""Several rounds of the port's TCP tier held against the JAX package's,
on the CPU: an all-port ``serve`` with two ``client``s over 3 rounds
against the same all-JAX run (tiny preset, dropout off in both, the port
started from the JAX client's init through ``models/convert.py``).

Round 1 goes dense and rounds 2-3 stream (the offer rides the reply, one
round behind) in both runs, with streamed replies. Held:

* each round's aggregate (the server's post-strategy global) at atol
  2e-6 / rtol 1e-5, the trajectory bound of tests/test_torch_client.py;
* each round's local and aggregated metrics at rtol 1e-6 (Accuracy,
  Precision, Recall, F1) and 1e-5 (Loss);
* one run with ``--strategy fedprox:mu=0.1`` and ``--prox-mu 0.1``: the
  attention key bias has an exactly-zero gradient in exact arithmetic,
  so FedProx amplifies each package's rounding noise there until it
  saturates at lr a step (tests/test_torch_federated.py's docstring);
  those leaves are held to that saturation bound, every other leaf and
  every metric to the full bound;
* one run with ``FEDTPU_SECRET`` set (HMAC, nonce echo);
* ``prefetch_epoch`` gives the same batches and the same losses as no
  prefetch (the CLI arms it during the reply wait).
"""

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
    AggregationServer as JaxServer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models import (
    presets as jpresets,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.train.batches import (
    EpochPrefetcher as JaxPrefetcher,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.comm import (
    build_server,
    run_client,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    wire as pwire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
    TokenizedSplit,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    params_from_jax,
    presets as ppresets,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train import (
    engine as pengine,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.batches import (
    PREFETCH_BATCHES,
    EpochPrefetcher,
)

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
METRICS = ("Accuracy", "Precision", "Recall", "F1-Score")
KEY_BIAS = "attn/k/bias"
ROUNDS = 3
CLIENT_ARGS = ["--synthetic", "300", "--epochs", "1", "--rounds", str(ROUNDS), "--timeout", "120"]
SECRET = "shared round secret"
#: case -> (serve flags, client flags)
CASES = {
    "fedavg": ([], []),
    "fedprox": (["--strategy", "fedprox:mu=0.1"], ["--prox-mu", "0.1"]),
    "secret": ([], []),
}


@pytest.fixture
def same_start(monkeypatch):
    """Dropout off in both tiny presets; the port's init is the JAX
    client's (seed 0, the rbg key its Trainer draws)."""
    monkeypatch.setitem(ppresets.PRESETS, "tiny", lambda **kw: pcfg.ModelConfig.tiny(**NO_DROP, **kw))
    monkeypatch.setitem(jpresets.PRESETS, "tiny", lambda **kw: jcfg.ModelConfig.tiny(**NO_DROP, **kw))

    def port_init(cfg, generator):
        jm = jcfg.ModelConfig(**dataclasses.asdict(cfg))
        tree = jax_init_params(JaxClassifier(jm), jm, jax.random.key(0, impl="rbg"))
        return params_from_jax(jax.tree.map(np.asarray, tree))

    monkeypatch.setattr(pengine, "init_params", port_init)


def _serve(server, aggs, errors):
    try:
        for _ in range(ROUNDS):
            aggs.append({k: np.array(v, copy=True) for k, v in server.serve_round(deadline=120.0).items()})
    except BaseException as e:  # re-raised by the test thread
        errors.append(e)


def _run(server, client_fn):
    aggs, errors, results = [], [], {}

    def client(i):
        try:
            results[i] = client_fn(i)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=_serve, args=(server, aggs, errors), daemon=True)]
    threads += [threading.Thread(target=client, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return aggs, results


def _jax_run(tmp_path, serve_flags, extra, auth_key):
    strategy = serve_flags[1] if serve_flags else None
    with JaxServer(port=0, num_clients=2, timeout=120, strategy=strategy, auth_key=auth_key) as server:
        aggs, rcs = _run(server, lambda i: jax_main([
            "client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port),
            *CLIENT_ARGS, *extra, "--output-dir", str(tmp_path / "jax"),
            "--metrics-jsonl", str(tmp_path / f"jax{i}.jsonl"),
        ]))
        totals = dict(server.stream_totals)
    assert rcs == {0: 0, 1: 0}
    assert totals["stream_uploads"] == 2 * (ROUNDS - 1)
    metrics = {}
    for i in range(2):
        with open(tmp_path / f"jax{i}.jsonl") as f:
            for rec in map(json.loads, f):
                metrics[(i, rec["round"] - 1, rec["phase"])] = rec
    return aggs, metrics


def _port_run(tmp_path, serve_flags, extra):
    server = build_server(build_parser().parse_args(
        ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--timeout", "120",
         "--device", "cpu", *serve_flags]
    ))
    uploads = []

    def serve_round(**kw):
        agg = type(server).serve_round(server, **kw)
        uploads.append(dict(server.last_uploads))
        return agg

    server.serve_round = serve_round
    with server:
        aggs, results = _run(server, lambda i: run_client(build_parser().parse_args([
            "client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port),
            *CLIENT_ARGS, *extra, "--device", "cpu", "--output-dir", str(tmp_path / "port"),
        ])))
    assert [sorted({u["shape"] for u in rec.values()}) for rec in uploads] == [["dense"], ["stream"], ["stream"]]
    metrics = {
        (i, r, phase): rec[phase]
        for i in range(2)
        for r, rec in enumerate(results[i]["rounds"])
        for phase in ("local", "aggregated")
    }
    return aggs, metrics, results


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_tcp_rounds_match_the_jax_package(case, tmp_path, monkeypatch, same_start):
    serve_flags, extra = CASES[case]
    if case == "secret":
        monkeypatch.setenv("FEDTPU_SECRET", SECRET)
    jaggs, jmetrics = _jax_run(tmp_path, serve_flags, extra, SECRET.encode() if case == "secret" else None)
    paggs, pmetrics, results = _port_run(tmp_path, serve_flags, extra)
    assert len(jaggs) == len(paggs) == ROUNDS
    steps = max(results[i]["state"].step for i in range(2))
    lr = results[0]["config"].train.learning_rate
    for r in range(ROUNDS):
        assert sorted(paggs[r]) == sorted(jaggs[r])
        for name, want in jaggs[r].items():
            got = paggs[r][name]
            if case == "fedprox" and name.endswith(KEY_BIAS):
                # Rounding noise under FedProx: bounded by lr a step, both sides.
                bound = lr * steps * 1.01
                assert np.abs(got).max() <= bound and np.abs(want).max() <= bound, (r, name)
                continue
            np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5, err_msg=f"round {r + 1} {name}")
        for i in range(2):
            for phase in ("local", "aggregated"):
                got, want = pmetrics[(i, r, phase)], jmetrics[(i, r, phase)]
                for key in METRICS:
                    np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=f"{case} {r} {i} {phase} {key}")
                np.testing.assert_allclose(got["Loss"], want["Loss"], rtol=1e-5, err_msg=f"{case} {r} {i} {phase}")
    for i in range(2):
        shapes = [(rec["exchange"]["upload_shape"], rec["exchange"]["reply_shape"]) for rec in results[i]["rounds"]]
        assert shapes == [("dense", "stream")] + [("stream", "stream")] * (ROUNDS - 1)
        meta = results[i]["rounds"][-1]["exchange"]["meta"]
        assert meta["strategy"]["name"] == ("fedprox" if case == "fedprox" else "fedavg")
        assert ("nonce" in meta) == (case == "secret")
        # The aggregate a client received is the server's, bit for bit.
        assert pwire.flat_crc32(pwire.flatten_params(results[i]["aggregate"])) == pwire.flat_crc32(paggs[-1])
        assert results[i]["config"].train.prox_mu == (0.1 if case == "fedprox" else 0.0)


def _split(n=40, L=16, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 100, (n, L)).astype(np.int32)
    mask = np.ones((n, L), np.int32)
    return TokenizedSplit(ids, mask, rng.integers(0, 2, n).astype(np.int32))


def test_prefetch_gives_the_same_batches_and_losses():
    cfg = pcfg.ModelConfig.tiny(**NO_DROP, max_len=16)
    split = _split()
    runs = []
    for prefetch in (False, True):
        trainer = pengine.Trainer(cfg, pcfg.TrainConfig(seed=4, learning_rate=1e-3, log_every=0), device="cpu")
        state = trainer.init_state()
        losses = []
        for r in range(3):
            if prefetch and r:
                assert trainer._prefetch.armed
            state, epoch_losses = trainer.fit(state, split, batch_size=8, epochs=1, epoch_offset=r)
            losses += epoch_losses
            if prefetch:
                pf = trainer.prefetch_epoch(split, r + 1, 8)
                assert isinstance(pf, EpochPrefetcher)
        runs.append((losses, {n: t.detach().clone() for n, t in state.params.items()}))
    assert runs[0][0] == runs[1][0]
    for n, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][n]), n
    # The prefetcher yields its factory's batches, as the JAX package's does;
    # a mismatched key drops the armed buffer.
    trainer = pengine.Trainer(cfg, pcfg.TrainConfig(seed=4), device="cpu")
    live = list(trainer._epoch_iterator(split, 2, 8))
    for pf in (EpochPrefetcher(lambda: trainer._epoch_iterator(split, 2, 8)),
               JaxPrefetcher(lambda: trainer._epoch_iterator(split, 2, 8), k=PREFETCH_BATCHES)):
        got = list(pf.batches())
        assert len(got) == len(live)
        for a, b in zip(got, live):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    trainer.prefetch_epoch(split, 2, 8)
    assert trainer._prefetch.consume((id(split), 3, 8)) is None and not trainer._prefetch.armed
