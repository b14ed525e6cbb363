"""Gradient accumulation in the port's stacked federated step
(``train.grad_accum_steps = k``: ``optax.MultiSteps`` per client) held
against the JAX package's ``FederatedTrainer``, on the CPU, dropout off,
from the same weights:

* k = 2 and 3 on ragged clients (13, 6 and 3 rows at batch 4, so the
  clients close different numbers of windows and the short one ends an
  epoch mid-window): per-client epoch losses at rtol 1e-5 and params at
  atol 2e-6 / rtol 1e-5 (tests/test_torch_federated.py's bounds), each
  client's Adam count and mini step equal to JAX's, with warmup and
  clipping on, at the package's learning rate (2e-5, as the other
  trajectory tests). At 1e-3 one element of a rarely seen embedding row
  leaves the bound (5.5e-6 against 2e-6 + 1e-5·|w|): its second moment is
  8.8e-13, so Adam divides a gradient of ~1e-6, whose last bits differ
  with the reduction order, by its own magnitude — the conditioning
  tests/test_torch_federated.py's docstring describes, in either package;
* a client idling through a lockstep step keeps its params, moments,
  count, accumulator and mini step bit for bit;
* a 2-round ``run`` with accumulation against JAX's (the per-round reset
  clears the window, as JAX's fresh ``MultiSteps`` state does);
* the federated checkpoint saves and restores the accumulator and the
  mini steps, and a template with accumulation does not warm-start from a
  checkpoint without it, nor the reverse.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.data import (
    pipeline as jpipeline,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    pipeline as ppipeline,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.batches import (
    federated_batches_ragged,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
    Checkpointer,
    maybe_warm_start,
)
from test_torch_federated import (
    _assert_metrics_close,
    _assert_params_close,
    _capture,
    _data,
    _flat_jax,
    _jax_splits,
    _port_splits,
    _trainers,
)

torch.set_num_threads(1)

SIZES = (13, 6, 3)
CASES = {
    "k2": dict(grad_accum_steps=2),
    "k3_warmup_clip": dict(grad_accum_steps=3, warmup_steps=3, max_grad_norm=0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_accumulation_matches_jax(case):
    train_kw = dict(CASES[case])
    k = train_kw["grad_accum_steps"]
    train, _ = _data(SIZES, (2, 2, 2), seed=9)
    pt, pstate, jt, jstate = _trainers(dict(num_clients=3), train_kw=train_kw)
    jstate, jl = jt.fit_local(jstate, jpipeline.stack_clients_ragged(_jax_splits(train)), epochs=2)
    pstate, pl = pt.fit_local(pstate, ppipeline.stack_clients_ragged(_port_splits(train)), epochs=2)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params_close(pstate.params, _flat_jax(jstate.params), msg=case)
    micro = [2 * -(-n // 4) for n in SIZES]  # micro steps each client took
    opt = pstate.opt_state
    assert opt.count == [m // k for m in micro]
    assert opt.mini_step == [m % k for m in micro]
    np.testing.assert_array_equal(np.asarray(optax.tree_utils.tree_get(jstate.opt_state, "count")), opt.count)
    np.testing.assert_array_equal(np.asarray(jstate.opt_state.mini_step), opt.mini_step)
    # The open windows' running means, against MultiSteps' acc_grads.
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
        flatten_tree,
        params_to_jax,
    )

    got = flatten_tree(params_to_jax({n: opt.acc[n] for n in opt.acc}, stacked=True))
    want = {k2: np.asarray(v) for k2, v in flatten_tree(jax.tree.map(np.asarray, jstate.opt_state.acc_grads)).items()}
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-6, rtol=1e-5, err_msg=name)


def test_idle_client_keeps_its_window_through_gated_steps():
    train, _ = _data(SIZES, (2, 2, 2), seed=9)
    pt, pstate, _, _ = _trainers(dict(num_clients=3), train_kw=dict(grad_accum_steps=3))
    stacked = ppipeline.stack_clients_ragged(_port_splits(train))
    gated = 0
    for batch in federated_batches_ragged(stacked, 4, seed=0, epoch=0):
        opt = pstate.opt_state
        before = (
            {n: t[2].detach().clone() for n, t in pstate.params.items()},
            {n: t[2].clone() for n, t in opt.mu.items()},
            {n: t[2].clone() for n, t in opt.nu.items()},
            {n: t[2].clone() for n, t in opt.acc.items()},
            opt.count[2],
            opt.mini_step[2],
        )
        _, has = pt.train_step(pstate, batch)
        opt = pstate.opt_state
        if batch["valid"][2].sum() == 0:
            gated += 1
            assert has[2] == 0
            for group, now in zip(before[:4], (pstate.params, opt.mu, opt.nu, opt.acc)):
                assert all(torch.equal(now[n][2], t) for n, t in group.items())
            assert (opt.count[2], opt.mini_step[2]) == before[4:]
        else:
            # Client 2's only step opens its window: nothing applied yet.
            assert (opt.count[2], opt.mini_step[2]) == (0, 1)
            assert any(not torch.equal(opt.acc[n][2], t) for n, t in before[3].items())
    assert gated == 3


def test_run_with_accumulation_matches_jax():
    fed_kw = dict(num_clients=3, rounds=2, weighted=True)
    train, evals = _data(SIZES, (6, 3, 5), seed=5)
    pt, pstate, jt, jstate = _trainers(fed_kw, train_kw=dict(grad_accum_steps=2))
    jaggs, paggs = [], []
    _capture(jt, jaggs, _flat_jax)
    _capture(pt, paggs, lambda p: {n: t.detach().clone() for n, t in p.items()})
    jstate, jhist = jt.run(jstate, jpipeline.stack_clients_ragged(_jax_splits(train)), _jax_splits(evals))
    pstate, phist = pt.run(pstate, ppipeline.stack_clients_ragged(_port_splits(train)), _port_splits(evals))
    for r in range(2):
        np.testing.assert_allclose(phist[r].epoch_losses, jhist[r].epoch_losses, rtol=1e-5)
        _assert_params_close(paggs[r], jaggs[r], msg=f"round {r}")
        _assert_metrics_close(phist[r].aggregated_metrics, jhist[r].aggregated_metrics, f"round {r}")


def test_federated_checkpoint_carries_the_window(tmp_path):
    train, _ = _data(SIZES, (2, 2, 2), seed=9)
    pt, pstate, _, _ = _trainers(dict(num_clients=3), train_kw=dict(grad_accum_steps=3))
    pstate, _ = pt.fit_local(pstate, ppipeline.stack_clients_ragged(_port_splits(train)), epochs=1)
    assert pstate.opt_state.mini_step == [1, 2, 1] and pstate.opt_state.count == [1, 0, 0]
    with Checkpointer(str(tmp_path / "ck")) as ckpt:
        ckpt.save(1, pstate)
    template = pt.init_state()
    restored, step = maybe_warm_start(str(tmp_path / "ck"), template)
    assert step == 1
    opt, want = restored.opt_state, pstate.opt_state
    assert opt.mini_step == want.mini_step and opt.count == want.count
    for group in ("acc", "mu", "nu"):
        for n, t in getattr(want, group).items():
            assert torch.equal(getattr(opt, group)[n], t), (group, n)
    assert all(torch.equal(restored.params[n], t) for n, t in pstate.params.items())
    # A template without accumulation starts fresh from it, and the reverse.
    plain, plain_state, _, _ = _trainers(dict(num_clients=3))
    assert maybe_warm_start(str(tmp_path / "ck"), plain.init_state()) == (None, None)
    with Checkpointer(str(tmp_path / "plain")) as ckpt:
        ckpt.save(1, plain_state)
    assert maybe_warm_start(str(tmp_path / "plain"), template) == (None, None)
    # The per-round reset clears the window with the moments.
    pt.reset_optimizer(restored)
    assert restored.opt_state.mini_step == [0, 0, 0]
    assert all(not t.any() for t in restored.opt_state.acc.values())
