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
