"""The port's secure aggregation held against the JAX package's.

* Every case of ``tests/test_secure.py`` (masking arithmetic, the DH and
  Shamir primitives, the server's and the client's refusals, the live
  masked rounds under both protocols, dropouts before keys, after keys
  and during the unmask round, the three retry pins) runs once with the
  JAX package's modules and once with the port's: the JAX test module's
  source, re-bound to the port's ``comm`` package (every port server
  folds with ``device="cpu"``). Each run asserts the JAX test's own
  checks; the two runs' server rounds (the crc of each aggregate served,
  or the error that failed it) are equal. The cases the JAX package
  marks slow run here too.
* Mixed rounds in both directions: a JAX server with port secure clients
  and a port server with JAX ones, with and without a dropout, under both
  protocols; their aggregates equal the all-JAX round's bit for bit, and
  the dequantized ring sum over the survivors.

The re-binding helpers (``rebind``, ``cases``, ``run_both``) serve
``test_torch_relay.py``, ``test_torch_faults.py`` and
``test_torch_scenario.py`` too.
"""

import contextlib
import functools
import importlib
import os
import sys
import threading
import types

import numpy as np
import pytest

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"
TESTS = os.path.dirname(os.path.abspath(__file__))

jcomm = importlib.import_module(JAX_PKG + ".comm")
pcomm = importlib.import_module(PORT_PKG + ".comm")
jwire = importlib.import_module(JAX_PKG + ".comm.wire")
pserver_mod = importlib.import_module(PORT_PKG + ".comm.server")


def _on_cpu(cls):
    """``cls`` (a port class taking ``device=``) on the CPU unless the
    caller names a device (the JAX tests never do)."""

    class OnCpu(cls):
        def __init__(self, *a, **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*a, **kw)

    OnCpu.__name__ = OnCpu.__qualname__ = cls.__name__
    return OnCpu


PortCpuServer = _on_cpu(pserver_mod.AggregationServer)
#: The port classes a re-bound JAX test sees, folding on the CPU.
PORT_ON_CPU = {
    "AggregationServer": PortCpuServer,
    "RelayAggregator": _on_cpu(pcomm.RelayAggregator),
    "StreamAgg": _on_cpu(pcomm.StreamAgg),
}


def rebind(test_module: str, *, subpackages=("comm", "faults", "cli"), extra=(), port_extra=()):
    """The JAX test module ``tests/<test_module>.py`` with its imports of
    the JAX package's ``subpackages`` re-bound to the port's, as a new
    module (with ``subpackages=()`` the JAX module itself, re-read). Every
    port server, relay and StreamAgg it builds folds on the CPU; ``extra``
    holds further ``(old, new)`` source substitutions (a smaller cohort),
    applied to both packages' copies alike; ``port_extra`` those that name
    the port's own spelling of an internal (applied to the port's copy
    only)."""
    with open(os.path.join(TESTS, test_module + ".py")) as f:
        src = f.read()
    for sub in subpackages:
        src = src.replace(f"{JAX_PKG}.{sub}", f"{PORT_PKG}.{sub}")
    for old, new in (*extra, *(port_extra if subpackages else ())):
        assert old in src, old
        src = src.replace(old, new)
    tag = "port" if subpackages else "jax"
    mod = types.ModuleType(f"{tag}_{test_module}")
    mod.__file__ = os.path.join(TESTS, f"{tag}_{test_module}.py")
    sys.modules[mod.__name__] = mod
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    if "comm" in subpackages:
        # The port classes the re-bound cases see fold on the CPU.
        for name, cls in PORT_ON_CPU.items():
            if name in mod.__dict__:
                mod.__dict__[name] = cls
    return mod


def cases(mod, names=None):
    """``pytest.param(name, kwargs)`` for every test function of ``mod``
    (or those in ``names``), one per parametrization."""
    out = []
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or not callable(fn):
            continue
        if names is not None and name not in names:
            continue
        grid = [{}]
        for m in getattr(fn, "pytestmark", []):
            if m.name != "parametrize":
                continue
            argnames = m.args[0]
            argnames = [a.strip() for a in argnames.split(",")] if isinstance(argnames, str) else list(argnames)
            new = []
            for p in grid:
                for v in m.args[1]:
                    v = v.values if hasattr(v, "values") else v
                    vals = (v,) if len(argnames) == 1 else tuple(v)
                    new.append({**p, **dict(zip(argnames, vals))})
            grid = new
        for kw in grid:
            ident = name + ("[" + "-".join(f"{k}={v}" for k, v in kw.items()) + "]" if kw else "")
            out.append(pytest.param(name, kw, id=ident))
    assert names is None or {p.values[0] for p in out} == set(names)
    return out


@contextlib.contextmanager
def _recording(record: list):
    """Record every ``serve_round`` of either package's server: the crc
    of the aggregate it returned (None for a no-op round), or the type of
    the error that failed it."""
    patched = []
    in_flight = threading.Semaphore(64)

    for cls in (jcomm.AggregationServer, pserver_mod.AggregationServer):
        orig = cls.serve_round

        def wrapped(self, *a, _orig=orig, **kw):
            in_flight.acquire()
            try:
                out = _orig(self, *a, **kw)
                crc = None if out is None else jwire.flat_crc32({k: np.asarray(v, np.float32) for k, v in out.items()})
                record.append(("served", crc))
                return out
            except Exception as e:
                record.append(("raised", type(e).__name__))
                raise
            finally:
                in_flight.release()

        cls.serve_round = wrapped
        patched.append((cls, orig))
    try:
        yield record
        # A round still closing on a server thread (its reply already
        # out) is recorded before the case counts as done.
        for _ in range(64):
            in_flight.acquire(timeout=15.0)
    finally:
        for cls, orig in patched:
            cls.serve_round = orig


_FIXTURES = {"rng": lambda d: np.random.default_rng(0), "tmp_path": lambda d: d}


def run_both(jax_mod, port_mod, name: str, kwargs: dict, tmp_path, monkeypatch=None, compare=True):
    """Run case ``name`` with the JAX module, then the port's, each with
    fresh fixtures; assert their recorded server rounds are equal (as
    multisets: rounds of concurrent servers interleave) and return them."""
    import inspect

    out = {}
    for label, mod in (("jax", jax_mod), ("port", port_mod)):
        fn = getattr(mod, name)
        d = tmp_path / label
        d.mkdir()
        args = dict(kwargs)
        for p in inspect.signature(fn).parameters:
            if p in args:
                continue
            if p == "monkeypatch":
                args[p] = monkeypatch
            else:
                args[p] = _FIXTURES[p](d)
        rec: list = []
        with _recording(rec):
            fn(**args)
        out[label] = sorted(rec, key=repr)
    if compare:
        assert out["jax"] == out["port"]
    return out


# ------------------------------------------------------- the JAX cases
JAX_SECURE = importlib.import_module("test_secure")
PORT_SECURE = rebind("test_secure")


@pytest.mark.parametrize("name,kwargs", cases(JAX_SECURE))
def test_secure_case_held_against_jax(name, kwargs, tmp_path, monkeypatch):
    run_both(JAX_SECURE, PORT_SECURE, name, kwargs, tmp_path, monkeypatch)


def test_every_jax_secure_case_is_held():
    names = {n for n in vars(JAX_SECURE) if n.startswith("test_")}
    assert len(names) == 34 and {p.values[0] for p in cases(JAX_SECURE)} == names


# ------------------------------------------------------- mixed rounds
def _uploads(n, seed=7):
    rng = np.random.default_rng(seed)
    return [
        {"enc": {"k": rng.normal(size=(6, 4)).astype(np.float32)}, "head": rng.normal(size=(3,)).astype(np.float32)}
        for _ in range(n)
    ]


def _secure_round(server_cls, client_classes, protocol, uploads, *, dead=(), min_clients=None):
    """One secure round: ``server_cls`` serves, client i is
    ``client_classes[i]``; the ``dead`` clients deal their shares (or,
    under ``reveal``, take the key set) and die before uploading, so the
    server proceeds over the survivors at its deadline. Returns (the
    served aggregate, {client: received aggregate})."""
    n = len(uploads)
    srv = server_cls(
        port=0, num_clients=n, min_clients=min_clients, secure_agg=True, secure_protocol=protocol,
        timeout=4.0 if dead else 20.0, key_grace=2.0, auth_key=b"grp",
    )
    served = {}
    st = threading.Thread(target=lambda: served.__setitem__("agg", srv.serve_round()), daemon=True)
    st.start()
    got = {}

    def run(c):
        fc = client_classes[c](
            "127.0.0.1", srv.port, client_id=c, secure_agg=True, num_clients=n, secure_protocol=protocol,
            timeout=20.0, auth_key=b"grp", min_participants=n - len(dead) if dead else None,
        )
        try:
            got[c] = fc.exchange(uploads[c], max_retries=1 if c in dead else 5)
        except ConnectionError:
            assert c in dead

    with _dying_before_upload({f"secure-client-{c}" for c in dead}):
        ths = [threading.Thread(target=run, args=(c,), name=f"secure-client-{c}", daemon=True) for c in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        st.join(timeout=60)
    srv.close()
    return served.get("agg"), got


@contextlib.contextmanager
def _dying_before_upload(threads: set):
    """Either package's client, on one of ``threads``, dies where it
    would mask its upload: after the key set (and the share exchange),
    before any upload byte moves."""
    mods = [importlib.import_module(p + ".comm.secure") for p in (JAX_PKG, PORT_PKG)]
    origs = [m.masked_upload for m in mods]

    def patched(orig):
        def masked_upload(*a, **kw):
            if threading.current_thread().name in threads:
                raise ConnectionAbortedError("client died before its upload")
            return orig(*a, **kw)

        return masked_upload

    for m, o in zip(mods, origs):
        m.masked_upload = patched(o)
    try:
        yield
    finally:
        for m, o in zip(mods, origs):
            m.masked_upload = o


@functools.lru_cache(maxsize=None)
def _all_jax_round(dropout: bool, protocol: str) -> dict:
    dead = (2,) if dropout else ()
    agg, _ = _secure_round(
        jcomm.AggregationServer, [jcomm.FederatedClient] * 3, protocol, _uploads(3), dead=dead,
        min_clients=2 if dropout else None,
    )
    return agg


MIXES = {
    "jax-server-port-clients": (jcomm.AggregationServer, [pcomm.FederatedClient] * 3),
    "port-server-jax-clients": (PortCpuServer, [jcomm.FederatedClient] * 3),
    "port-server-mixed-clients": (PortCpuServer, [pcomm.FederatedClient, jcomm.FederatedClient, pcomm.FederatedClient]),
}


@pytest.mark.parametrize("protocol", ["double", "reveal"])
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mixed_secure_round_equals_the_all_jax_round(mix, dropout, protocol):
    """Masks of the two packages cancel in one ring sum: the mixed round's
    aggregate equals the all-JAX round's bit for bit and the dequantized
    sum of the survivors' quantized updates."""
    ups = _uploads(3)
    dead = (2,) if dropout else ()
    mc = 2 if dropout else None
    want = _all_jax_round(dropout, protocol)
    server_cls, client_classes = MIXES[mix]
    agg, got = _secure_round(server_cls, client_classes, protocol, ups, dead=dead, min_clients=mc)
    assert want is not None and agg is not None
    psecure = importlib.import_module(PORT_PKG + ".comm.secure")
    alive = [c for c in range(3) if c not in dead]
    flats = [pcomm.flatten_params(ups[c]) for c in alive]
    ring = psecure.dequantize_sum(psecure.sum_masked([psecure.quantize(f) for f in flats]), len(alive))
    for k in ring:
        assert np.array_equal(np.asarray(agg[k]), np.asarray(want[k])), k
        assert np.array_equal(np.asarray(agg[k]), ring[k]), k
    assert sorted(got) == alive
    for c in alive:
        assert jwire.flat_crc32(pcomm.flatten_params(got[c])) == jwire.flat_crc32(ring)
