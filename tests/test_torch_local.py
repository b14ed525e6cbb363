"""The port's ``local`` command end to end on the CPU, and its refusal to
fall back to the CPU when the card is missing."""

import csv
import math
import os

import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
    main,
)

torch.set_num_threads(1)

REFERENCE_COLUMNS = ["Accuracy", "Loss", "Precision", "Recall", "F1-Score"]


@pytest.mark.parametrize("impl", ["flash", "dot"])
def test_local_writes_the_reference_metrics_csv(tmp_path, impl):
    out = tmp_path / "out"
    rc = main([
        "local", "--device", "cpu", "--preset", "tiny", "--synthetic", "600",
        "--epochs", "1", "--attention-impl", impl, "--output-dir", str(out),
    ])
    assert rc == 0
    path = out / "client0_local_metrics.csv"
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and list(rows[0]) == REFERENCE_COLUMNS
    values = {k: float(v) for k, v in rows[0].items()}
    assert all(math.isfinite(v) for v in values.values())
    assert 0.0 <= values["Accuracy"] <= 100.0 and values["Loss"] > 0.0


def test_local_without_cuda_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    args = build_parser().parse_args(
        ["local", "--preset", "tiny", "--synthetic", "600", "--output-dir", str(out)]
    )
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        args.fn(args)
    assert not os.path.exists(out)


def test_local_saves_one_step_at_the_global_step(tmp_path):
    """``local --checkpoint-dir`` saves the trained state once, as step
    ``state.step``, with the JAX package's meta; it never warm-starts."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.local import (
        run_local,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
        ExperimentConfig,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
        Checkpointer,
    )

    ckpt_dir = str(tmp_path / "ck")
    argv = ["local", "--device", "cpu", "--preset", "tiny", "--synthetic", "600", "--epochs", "1",
            "--checkpoint-dir", ckpt_dir, "--output-dir", str(tmp_path / "out")]
    res = run_local(build_parser().parse_args(argv))
    state = res["state"]
    assert state.step > 0 and os.listdir(ckpt_dir) == [str(state.step)]
    assert res["save_seconds"] is not None and res["save_seconds"] >= 0
    with Checkpointer(ckpt_dir) as ckpt:
        meta = ckpt.restore_meta()
        restored = ckpt.restore(res["trainer"].init_state())
    assert meta["client_id"] == 0 and meta["kind"] == "local"
    assert ExperimentConfig.from_dict(meta["config"]) == res["config"]
    assert res["config"].checkpoint_dir == ckpt_dir
    for n, t in state.params.items():
        assert torch.equal(restored.params[n].detach(), t.detach())
    assert restored.step == state.step and restored.opt_state.count == state.opt_state.count
    # A second run starts fresh (the same step again, which exists: kept).
    again = run_local(build_parser().parse_args(argv))
    for n, t in again["state"].params.items():
        assert torch.equal(t.detach(), state.params[n].detach())
    assert os.listdir(ckpt_dir) == [str(state.step)]
