"""The port's shadow plane held against the JAX package's.

Every case of ``tests/test_shadow.py`` that ``test_torch_control.py``
does not already hold (that file holds the cadence, SLO-actuator and
controller-SLO cases) runs once with the JAX package's modules and once
with the port's: the comparator's pairing and bounded pending queue, the
gate arithmetic and its fail-closed timeout, ``ShadowConfig``'s
validation, the registry's shadow pointer with the verdict on the
``rejected`` event, the mirror's stride, the full-queue and dead-shadow
pass-through, the fleet's shadow lifecycle gated end to end, the
controller's shadow rung, the reload frames and the out-of-process
reload sweep, the CLI wiring and the span vocabulary. The JAX test
module's ``router``, ``serving``, ``shadow``, ``registry``, ``control``,
``comm``, ``obs`` and ``cli`` imports are re-bound to the port, and its
``ShadowConfig`` and ``ControlConfig`` are the port's; the model, the
tokenizer and the expected probabilities stay the JAX package's (see
``test_torch_router.py``), a reply held to them within atol 2e-5. The
cases the JAX package marks slow keep the mark.
"""

import pytest

from test_torch_router import PROB_EQ, marked_cases, module_fixtures, rebind_gates, run_both  # noqa: F401

#: Held by ``test_torch_control.py`` (the drift arithmetic and campaigns).
HELD_ELSEWHERE = {
    "test_cadence_interval_pure_function",
    "test_adaptive_cadence_records_interval_on_drift_span",
    "test_slo_actuator_tightens_until_clear",
    "test_controller_slo_actuation_tightens_round_deadline",
}

SHADOW = rebind_gates(
    "test_shadow",
    ("router", "serving", "shadow", "registry", "control", "comm", "obs", "cli"),
    overrides=("ShadowConfig", "ControlConfig"),
    port_extra=(PROB_EQ, ("engine = ScoreEngine(", "engine = CpuScoreEngine(")),
)
NAMES = sorted(n for n in vars(SHADOW[0]) if n.startswith("test_") and n not in HELD_ELSEWHERE)


@pytest.mark.parametrize("name,kwargs", marked_cases(SHADOW[0], NAMES))
def test_shadow_case_held_against_jax(name, kwargs, tmp_path, module_fixtures, monkeypatch, capsys):  # noqa: F811
    run_both(SHADOW, name, kwargs, tmp_path, module_fixtures, monkeypatch=monkeypatch, capsys=capsys)
