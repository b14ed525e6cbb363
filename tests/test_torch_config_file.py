"""``export-config`` and ``--config`` resolution held against the JAX
package's, for the sections the port models (model, data, train, fed,
distill, obs, control and the two paths), under every flag the resolution takes:
``--config`` (a file of either package), ``--gelu``, ``--warmup-steps``,
``--attention-dropout`` (an explicit 0 included) and the three-way
``--remat``/``--no-remat``; and ``from_checkpoint_dict``'s legacy gelu
rule.
"""

import dataclasses
import json

import pytest

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu import (
    config as jcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
    main as jax_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    config as pcfg,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    main as port_main,
)

PORT_SECTIONS = ("model", "data", "train", "fed", "distill", "obs", "control", "output_dir", "checkpoint_dir")


def _export(main, argv, capsys):
    capsys.readouterr()
    assert main(["export-config", *argv]) == 0
    return json.loads(capsys.readouterr().out)


def _file(tmp_path, name, d):
    path = tmp_path / name
    path.write_text(json.dumps(d))
    return str(path)


def _port_file(tmp_path, capsys, **changes):
    """A config the port's own export-config wrote, with ``changes``
    (section -> {key: value}) applied."""
    d = _export(port_main, ["--preset", "tiny"], capsys)
    for section, kv in changes.items():
        d[section].update(kv)
    return _file(tmp_path, "port.json", d)


CASES = {
    "defaults": [],
    "distilbert": ["--preset", "distilbert"],
    "gelu_exact": ["--preset", "distilbert", "--gelu", "exact"],
    "gelu_tanh": ["--gelu", "tanh"],
    "warmup": ["--warmup-steps", "7"],
    "attention_dropout_0": ["--attention-dropout", "0"],
    "attention_dropout": ["--attention-dropout", "0.25", "--attention-impl", "flash"],
    "remat": ["--remat"],
    "no_remat": ["--no-remat"],
    "flags": ["--epochs", "2", "--learning-rate", "1e-3", "--batch-size", "8", "--max-len", "24", "--seed", "9",
              "--num-clients", "3", "--rounds", "5", "--output-dir", "o"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_config_matches_jax(case, capsys):
    argv = CASES[case]
    jax_d = _export(jax_main, argv, capsys)
    port_d = _export(port_main, argv, capsys)
    assert set(port_d) == set(PORT_SECTIONS)
    for key in PORT_SECTIONS:
        assert port_d[key] == jax_d[key], key


@pytest.mark.parametrize("case", ["file", "file_and_flags", "file_remat_then_no_remat", "jax_file"])
def test_config_file_resolution_matches_jax(case, tmp_path, capsys):
    changes = dict(
        model={"remat": True, "gelu": "exact", "attention_dropout": 0.05},
        train={"grad_accum_steps": 3, "warmup_steps": 2, "max_grad_norm": 1.0},
        fed={"rounds": 4, "num_clients": 4},
        distill={"alpha": 0.2, "temperature": 3.0, "init_from_teacher": False},
        data={"batch_size": 8, "eval_batch_size": 8},
        obs={"trace_jsonl": "t.jsonl", "metrics_port": 9100, "run_id": "r1", "trace_sample": 0.25,
             "flight_dir": "fl", "flight_ring": 64, "profile_stride": 3},
    )
    if case == "jax_file":
        d = _export(jax_main, ["--preset", "tiny"], capsys)
        for section, kv in changes.items():
            d[section].update(kv)
        path = _file(tmp_path, "jax.json", d)  # with the sections the port drops
    else:
        path = _port_file(tmp_path, capsys, **changes)
    argv = ["--config", path]
    if case == "file_and_flags":
        argv += ["--gelu", "tanh", "--warmup-steps", "0", "--attention-dropout", "0", "--epochs", "2", "--rounds", "6"]
    elif case == "file_remat_then_no_remat":
        argv += ["--no-remat"]
    jax_d = _export(jax_main, argv, capsys)
    port_d = _export(port_main, argv, capsys)
    for key in PORT_SECTIONS:
        assert port_d[key] == jax_d[key], key
    assert port_d["train"]["grad_accum_steps"] == 3 and port_d["distill"]["alpha"] == 0.2
    assert port_d["obs"]["profile_stride"] == 3 and port_d["obs"]["trace_sample"] == 0.25
    assert port_d["model"]["remat"] is (case != "file_remat_then_no_remat")
    # What the port wrote, the JAX package reads as the same config.
    back = pcfg.ExperimentConfig.from_dict(port_d)
    assert back.to_dict() == port_d
    assert {k: v for k, v in jcfg.ExperimentConfig.from_dict(port_d).to_dict().items() if k in PORT_SECTIONS} == port_d


@pytest.mark.parametrize("saved_gelu", [None, "exact", "tanh"])
def test_from_checkpoint_dict_matches_jax(saved_gelu):
    d = pcfg.ExperimentConfig(model=pcfg.ModelConfig.tiny(), data=pcfg.DataConfig(max_len=32)).to_dict()
    if saved_gelu is None:
        del d["model"]["gelu"]  # a config from before the field existed
    else:
        d["model"]["gelu"] = saved_gelu
    port = pcfg.ExperimentConfig.from_checkpoint_dict(d)
    jax = jcfg.ExperimentConfig.from_checkpoint_dict(d)
    assert port.model.gelu == jax.model.gelu == (saved_gelu or "exact")
    assert dataclasses.asdict(port.model) == dataclasses.asdict(jax.model)
    assert "gelu" not in d["model"] or d["model"]["gelu"] == saved_gelu  # the input is not modified


def test_distill_config_validation_matches_jax():
    for kw in (dict(alpha=1.5), dict(alpha=-0.1), dict(temperature=0.0)):
        with pytest.raises(ValueError) as pe:
            pcfg.DistillConfig(**kw)
        with pytest.raises(ValueError) as je:
            jcfg.DistillConfig(**kw)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown distill config keys"):
        pcfg.ExperimentConfig.from_dict({"distill": {"bogus": 1}})


def test_obs_config_matches_jax():
    """The port's ``ObsConfig`` is the JAX package's, field for field and
    check for check."""
    assert dataclasses.asdict(pcfg.ObsConfig()) == dataclasses.asdict(jcfg.ObsConfig())
    for kw in (
        dict(metrics_port=70000), dict(trace_sample=0.0), dict(trace_sample=1.5), dict(flight_ring=0),
        dict(profile_stride=-1), dict(snapshot_max_mb=0.0), dict(sentinel_interval_s=0.0),
        dict(sentinel_ring_records=4), dict(sentinel_regression_ratio=1.0),
    ):
        with pytest.raises(ValueError) as pe:
            pcfg.ObsConfig(**kw)
        with pytest.raises(ValueError) as je:
            jcfg.ObsConfig(**kw)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown obs config keys"):
        pcfg.ExperimentConfig.from_dict({"obs": {"bogus": 1}})


def test_jax_config_control_section_round_trips(tmp_path, capsys):
    """A JAX config file's ``control`` section is read, not dropped: the
    port's ``ExperimentConfig`` holds it, writes it back unchanged, and
    ``export-config --config`` resolves it as the JAX verb does."""
    control = {"gate_metric": "F1-Score", "gate_min_delta": 0.01, "min_interval_s": 2.0, "max_interval_s": 60.0,
               "drift_method": "ks", "drift_threshold": 0.3, "drift_min_scores": 64, "score_bins": 16,
               "round_deadline_s": 30.0, "max_artifacts": 5, "adaptive_cadence": True, "slo_deadline_factor": 0.25,
               "drift_cohort": True, "cohort_min_frac": 0.25, "cohort_max_frac": 0.75}
    d = _export(jax_main, [], capsys)
    d["control"].update(control)
    path = _file(tmp_path, "jax.json", d)
    cfg = pcfg.ExperimentConfig.from_dict(d)
    assert dataclasses.asdict(cfg.control) == dataclasses.asdict(jcfg.ExperimentConfig.from_dict(d).control)
    assert cfg.to_dict()["control"] == d["control"] == {**dataclasses.asdict(jcfg.ControlConfig()), **control}
    assert _export(port_main, ["--config", path], capsys)["control"] == _export(jax_main, ["--config", path], capsys)["control"]
    with pytest.raises(ValueError, match="unknown control config keys"):
        pcfg.ExperimentConfig.from_dict({"control": {"gate_metrc": "x"}})
    with pytest.raises(ValueError, match="cohort_max_frac"):
        pcfg.ExperimentConfig.from_dict({"control": {"cohort_min_frac": 0.9, "cohort_max_frac": 0.5}})
