"""The port's replica tier held against the JAX package's.

* Every case of ``tests/test_router.py`` (the stats frame and its
  replica id, the id rewrite, least-in-flight routing with drain and
  eject, end-to-end auth, the 400 on a malformed body, the pipelined and
  async clients, paced load, the rolling reload under load and the CLI
  wiring) runs once with the JAX package's modules and once with the
  port's: the JAX test module's source, its ``router``, ``serving``,
  ``comm``, ``obs`` and ``cli`` imports re-bound to the port. The model,
  its config, the tokenizer and the trainer that computes the expected
  probabilities stay the JAX package's: a port replica gets the same
  weights through ``models.convert.params_from_jax`` and scores on the
  CPU, and its replies must equal JAX's probabilities within the serving
  tests' atol 2e-5 where the JAX case asks for bit equality. The cases
  the JAX package marks slow keep the mark.
* Mixed tiers: one JAX replica and one port replica behind each
  package's router; every reply within atol 2e-5 of the JAX pipeline's
  probability, and both replicas answer.

The helpers here (``rebind_gates``, ``run_both``, the CPU wrappers)
serve ``test_torch_shadow.py`` and ``test_torch_labels.py`` too.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

from test_torch_secure import JAX_PKG, PORT_PKG, _recording, cases, rebind

torch.set_num_threads(1)

ATOL = 2e-5

pcfg = importlib.import_module(PORT_PKG + ".config")
pconvert = importlib.import_module(PORT_PKG + ".models.convert")
pdata = importlib.import_module(PORT_PKG + ".data")
pregistry = importlib.import_module(PORT_PKG + ".registry")
prouter = importlib.import_module(PORT_PKG + ".router")
pserving = importlib.import_module(PORT_PKG + ".serving")
pwire = importlib.import_module(PORT_PKG + ".comm.wire")
PORT_TOK = pdata.default_tokenizer()


# ------------------------------------------------- the port on the CPU
def port_cfg(cfg):
    """A JAX (or port) ModelConfig as the port's."""
    return pcfg.ModelConfig(**dataclasses.asdict(cfg))


def port_params(params):
    """JAX params (nested, or the registry's flat form) as a port state
    dict; a state dict passes through."""
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        return params
    return pconvert.params_from_jax(params)


class CpuFleetReplica(prouter.FleetReplica):
    """A port replica built from JAX weights, scoring on the CPU with the
    port's tokenizer (the JAX one's vocabulary)."""

    def __init__(self, replica_id, model_cfg, params, tok, **kw):
        assert tok.vocab == PORT_TOK.vocab
        kw.setdefault("device", "cpu")
        super().__init__(replica_id, port_cfg(model_cfg), port_params(params), PORT_TOK, **kw)

    def adopt(self, params, *, round_id):
        super().adopt(port_params(params), round_id=round_id)


class CpuScoreEngine(pserving.ScoreEngine):
    def __init__(self, model_cfg, params, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(port_cfg(model_cfg), port_params(params), **kw)

    def swap(self, params, *, round_id):
        super().swap(port_params(params), round_id=round_id)


class TreeRegistry(pregistry.ModelRegistry):
    """The port registry, taking the JAX tests' nested numpy trees (it
    stores their flat form, which is what the JAX registry stores)."""

    def add(self, params, **kw):
        if any(isinstance(v, dict) for v in params.values()):
            params = pwire.flatten_params(params)
        return super().add(params, **kw)


#: Port names a re-bound JAX case sees in place of the port's own.
PORT_WRAPPERS = {"FleetReplica": CpuFleetReplica, "ModelRegistry": TreeRegistry}
#: The JAX cases' bit-equality of a reply with the JAX pipeline's
#: probability, held within the serving bound for the port.
PROB_EQ = (
    'assert reply["prob"] == float(np.float32(p))',
    'assert abs(reply["prob"] - float(np.float32(p))) <= 2e-5',
)


def rebind_gates(test_module, subpackages, *, overrides=(), port_extra=()):
    """``(jax module, port module)`` for ``tests/<test_module>.py``: the
    port copy re-binds ``subpackages``, its engines score on the CPU and
    its module-level ``overrides`` (names of the JAX test's imports of
    configs the port has, e.g. ``ShadowConfig``) are the port's."""
    jax_mod = importlib.import_module(test_module)
    port_mod = rebind(test_module, subpackages=subpackages, port_extra=port_extra)
    for name, cls in PORT_WRAPPERS.items():
        if name in port_mod.__dict__:
            port_mod.__dict__[name] = cls
    port_mod.CpuScoreEngine = CpuScoreEngine  # what ``engine = ScoreEngine(`` becomes
    for name in overrides:
        port_mod.__dict__[name] = getattr(pcfg, name)
    return jax_mod, port_mod


# ------------------------------------------------------ running a case
def marked_cases(mod, names=None):
    """``cases(mod, names)``, each keeping the JAX case's ``slow`` mark."""
    out = []
    for p in cases(mod, names):
        fn = getattr(mod, p.values[0])
        slow = any(m.name == "slow" for m in getattr(fn, "pytestmark", []))
        out.append(pytest.param(*p.values, id=p.id, marks=pytest.mark.slow) if slow else p)
    return out


def _raw(fixture):
    """The function under a ``@pytest.fixture``."""
    wrapped = getattr(fixture, "__pytest_wrapped__", None)
    return wrapped.obj if wrapped is not None else fixture.__wrapped__


class ModuleFixtures:
    """The JAX test module's own fixtures (``tiny_setup``,
    ``shared_replica``), built once per package and torn down at the end
    of the test module."""

    def __init__(self):
        self.values: dict = {}
        self.gens: list = []

    def get(self, mod, label, name):
        key = (label, name)
        if key not in self.values:
            fn = _raw(getattr(mod, name))
            out = fn(**{p: self.get(mod, label, p) for p in inspect.signature(fn).parameters})
            if inspect.isgenerator(out):
                self.gens.append(out)
                out = next(out)
            self.values[key] = out
        return self.values[key]

    def close(self):
        for gen in reversed(self.gens):
            next(gen, None)


@pytest.fixture(scope="module")
def module_fixtures():
    fx = ModuleFixtures()
    yield fx
    fx.close()


def run_both(mods, name, kwargs, tmp_path, fixtures, **given):
    """Case ``name`` with the JAX module, then the port's, each with a
    fresh ``tmp_path``, ``given`` fixtures (monkeypatch, capsys) and the
    module's own fixtures; the two runs' aggregation rounds (the crc of
    each aggregate served, or the error that failed it) are equal."""
    out = {}
    for label, mod in zip(("jax", "port"), mods):
        fn = getattr(mod, name)
        d = tmp_path / label
        d.mkdir()
        args = dict(kwargs)
        for p in inspect.signature(fn).parameters:
            if p in args:
                continue
            if p == "tmp_path":
                args[p] = d
            elif p in given:
                args[p] = given[p]
            else:
                args[p] = fixtures.get(mod, label, p)
        rec: list = []
        with _recording(rec):
            fn(**args)
        out[label] = sorted(rec, key=repr)
    assert out["jax"] == out["port"]
    return out


# ------------------------------------------------------ the JAX cases
ROUTER = rebind_gates(
    "test_router",
    ("router", "serving", "comm", "obs", "cli"),
    port_extra=(
        PROB_EQ,
        ("assert reply[\"prob\"] == float(\n                np.float32(want[i % len(TEXTS)])\n            )",
         "assert abs(reply[\"prob\"] - float(np.float32(want[i % len(TEXTS)]))) <= 2e-5"),
        ("engine = ScoreEngine(", "engine = CpuScoreEngine("),
    ),
)


@pytest.mark.parametrize("name,kwargs", marked_cases(ROUTER[0]))
def test_router_case_held_against_jax(name, kwargs, tmp_path, module_fixtures, monkeypatch, capsys):
    run_both(ROUTER, name, kwargs, tmp_path, module_fixtures, monkeypatch=monkeypatch, capsys=capsys)


# ------------------------------------------------------------ mixed tiers
@pytest.mark.parametrize("front", ["jax", "port"])
def test_mixed_replicas_behind_either_router(front, module_fixtures):
    """A JAX replica and a port replica behind ``front``'s router: every
    reply is within the serving bound of the JAX pipeline's probability,
    both replicas answer, and the router's stats name both."""
    jrouter = importlib.import_module(JAX_PKG + ".router")
    jserving = importlib.import_module(JAX_PKG + ".serving")
    jax_mod = ROUTER[0]
    setup = module_fixtures.get(jax_mod, "jax", "tiny_setup")
    tok, model_cfg, _trainer, params, _p2 = setup
    want = jax_mod._expected_probs(setup, jax_mod.TEXTS)
    reps = [
        jrouter.FleetReplica(0, model_cfg, params, tok, round_id=3, buckets=(1, 4)).start(),
        CpuFleetReplica(1, model_cfg, params, tok, round_id=3, buckets=(1, 4)).start(),
    ]
    router_cls = (jrouter if front == "jax" else prouter).ScoringRouter
    router = router_cls([("127.0.0.1", r.port) for r in reps], probe_interval_s=0.2)
    try:
        router.start()
        with jserving.PipelinedScoringClient("127.0.0.1", router.port) as cli:
            futs = [cli.submit(text=jax_mod.TEXTS[i % 4]) for i in range(32)]
            replies = [f.result(timeout=60) for f in futs]
        for i, reply in enumerate(replies):
            assert reply["round"] == 3
            assert abs(reply["prob"] - float(np.float32(want[i % 4]))) <= ATOL
        per_rep = [jserving.fetch_stats("127.0.0.1", r.port) for r in reps]
        assert [s["replica"] for s in per_rep] == [0, 1]
        assert all(s["scored"] > 0 for s in per_rep), per_rep
        s = router.stats()
        assert [b["replica"] for b in s["backends"]] == [0, 1] and s["healthy"] == 2
    finally:
        router.close()
        for r in reps:
            r.close()
