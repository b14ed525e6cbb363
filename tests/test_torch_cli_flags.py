"""The flags the port's parser gained to match the JAX package's, on the
CPU:

* ``client --partition --dirichlet-alpha``: client i's token arrays equal
  the JAX client's and the port's ``federated`` client i's;
* the ``federated`` DP and personalization flags and ``serve``'s DP flags
  resolve as the JAX package resolves them;
* a JAX ``infer-serve`` command line with every common flag parses on the
  port to the same values, and ``--hf-dir … --max-len 64`` serves at
  L=64 within the serving bound (atol 2e-5) of the JAX package's
  ``predict`` at the same length;
* ``predict --stream`` is refused with the JAX package's message.
"""

import numpy as np
import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    build_parser as jax_parser,
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli.common import (
    _load_clients as jax_load_clients,
    resolve_config as jax_resolve_config,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    default_tokenizer as jax_default_tokenizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
    _load_clients,
    resolve_config,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.tokenizer import (
    default_tokenizer,
)
from test_torch_hf_convert import _probs, flows_csv, hf_dirs  # noqa: F401 (fixtures)
from test_torch_streaming import _assert_clients_equal


def _resolved(argv):
    args, jargs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    tok, jtok = default_tokenizer(), jax_default_tokenizer()
    return args, resolve_config(args, vocab_size=len(tok.vocab)), jargs, jax_resolve_config(jargs, vocab_size=len(jtok.vocab))


@pytest.mark.parametrize("scheme,alpha", [("dirichlet", "0.3"), ("quantity", "0.5"), ("disjoint", None)])
def test_client_partition_rows_equal_jax_and_federated(scheme, alpha):
    common = ["--synthetic", "400", "--num-clients", "3", "--partition", scheme, "--max-len", "32"]
    if alpha:
        common += ["--dirichlet-alpha", alpha]
    tok, jtok = default_tokenizer(), jax_default_tokenizer()
    fargs, fcfg, _, _ = _resolved(["federated", *common])
    fed_clients = _load_clients(fargs, fcfg, tok, 3)
    for cid in range(3):
        args, cfg, jargs, jcfg = _resolved(["client", "--client-id", str(cid), *common])
        assert (cfg.data.partition, cfg.data.dirichlet_alpha) == (jcfg.data.partition, jcfg.data.dirichlet_alpha)
        got = _load_clients(args, cfg, tok, cfg.fed.num_clients)[cid]
        want = jax_load_clients(jargs, jcfg, jtok, jcfg.fed.num_clients)[cid]
        _assert_clients_equal([got], [want])
        _assert_clients_equal([got], [fed_clients[cid]])


def test_federated_and_serve_dp_flags_resolve_as_jax():
    argv = [
        "federated", "--num-clients", "4", "--dp-clip", "1.0", "--dp-noise-multiplier", "1.1",
        "--participation", "0.5", "--personalize-epochs", "2", "--personalize-scope", "head",
    ]
    _, cfg, _, jcfg = _resolved(argv)
    import dataclasses

    assert dataclasses.asdict(cfg.fed) == dataclasses.asdict(jcfg.fed)
    assert cfg.fed.resolve_participation_mode() == "poisson" and cfg.fed.dp_enabled()
    serve = ["serve", "--dp-clip", "0.5", "--dp-noise-multiplier", "1.0", "--dp-participation", "0.3",
             "--dp-history-file", "h.npz"]
    args, jargs = build_parser().parse_args(serve), jax_parser().parse_args(serve)
    for name in ("dp_clip", "dp_noise_multiplier", "dp_participation", "dp_history_file"):
        assert getattr(args, name) == getattr(jargs, name), name
    args = build_parser().parse_args(["client", "--client-id", "0", "--dp"])
    assert args.dp and jax_parser().parse_args(["client", "--client-id", "0", "--dp"]).dp


INFER_SERVE = [
    "infer-serve", "--config", "c.json", "--preset", "distilbert", "--gelu", "exact", "--hf-dir", "h", "--pth", "p",
    "--csv", "f.csv", "--dataset", "unswnb15", "--source", "s.csv", "--synthetic", "10", "--stream",
    "--output-dir", "o", "--batch-size", "4", "--epochs", "2", "--learning-rate", "1e-3", "--warmup-steps", "3",
    "--attention-impl", "flash", "--attention-dropout", "0.0", "--max-len", "64", "--data-fraction", "0.5",
    "--seed", "3", "--remat", "--port", "0", "--checkpoint-dir", "ck", "--threshold", "0.4",
]


def test_a_jax_infer_serve_command_line_parses_on_the_port():
    args, jargs = build_parser().parse_args(INFER_SERVE), jax_parser().parse_args(INFER_SERVE)
    shared = set(vars(args)) & set(vars(jargs)) - {"fn"}
    assert {"max_len", "csv", "synthetic", "source", "seed", "epochs", "batch_size", "learning_rate",
            "data_fraction", "output_dir", "stream", "config", "remat"} <= shared
    for name in sorted(shared):
        assert getattr(args, name) == getattr(jargs, name), name
    assert args.device == "cuda"


def test_infer_serve_max_len_64_serves_at_64_as_jax(hf_dirs, flows_csv, tmp_path):  # noqa: F811
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
        build_server,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.cicids import (
        frame_texts,
        load_flow_csv,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
        ScoringClient,
    )

    weights = ["--hf-dir", hf_dirs["st"], "--pth", hf_dirs["pth"], "--max-len", "64"]
    jout = str(tmp_path / "j.csv")
    assert jax_main(["predict", "--csv", flows_csv, *weights, "--output", jout]) == 0
    server = build_server(build_parser().parse_args(
        ["infer-serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0", *weights]
    ))
    assert server.engine.seq_len == 64 and server.engine.model_cfg.max_len == 64
    texts = frame_texts(load_flow_csv(flows_csv))[:8]
    with server:
        client = ScoringClient("127.0.0.1", server.port)
        try:
            got = np.array([client.score(text=t)["prob"] for t in texts])
        finally:
            client.close()
    np.testing.assert_allclose(got, _probs(jout)[:8], atol=2e-5)


def test_predict_refuses_stream_as_jax(tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.predict import (
        run_predict,
    )

    argv = ["predict", "--csv", str(tmp_path / "f.csv"), "--stream", "--output", str(tmp_path / "p.csv")]
    msgs = []
    for fn in (lambda: jax_main(argv), lambda: run_predict(build_parser().parse_args([*argv, "--device", "cpu"]))):
        with pytest.raises(SystemExit) as e:
            fn()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "--stream is a training-data option" in msgs[0]
