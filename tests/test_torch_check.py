"""The port's ``check`` verb and its ``analysis`` package held against the
JAX package's, on the CPU.

* Every case of ``tests/test_analysis.py`` (the per-rule fixture trees,
  baseline semantics, ``--prune-baseline``, the seeded mutations, the
  repo self-scan, the parser and ``--list-rules``, the scripted lock
  schedules) runs re-bound to the port: the JAX test module's source with
  its ``analysis`` and ``cli`` imports pointing at the port's. Its repo
  copy holds both packages, ``bench.py`` and the baseline, so suffix
  rules resolve as on the real tree. Every ``run_check`` a case makes is
  held against the JAX package's on the same tree and arguments:
  ``to_dict()`` equal apart from ``check_runtime_s``, the rendered
  findings and the exit code equal, or the same error raised. Every
  ``cmd_check`` likewise: exit code, stderr and stdout (the JSON document
  without ``check_runtime_s``, the human summary without its seconds),
  and the bytes a ``--prune-baseline`` leaves in the baseline file.
  Tolerance: exact. The JAX case that reads the session's arming state is
  replaced by the port variant below.
* ``all_rules()`` names and descriptions; ``--list-rules``; ``--json`` on
  the repo root in a subprocess with JAX blocked; a mutation in the
  port's own ``strategies/`` caught by both checkers.
* The same scripted lock schedules through both packages'
  ``LockOrderDetector``: equal reports.
* The port's detector armed inside the JAX session's: the port's locks
  tracked at their port lines, each wrapping the session's tracked lock,
  the ``Condition`` hooks forwarded through both wrappers, the factories
  restored on disarm; a CPU TCP round of the port under it shows no cycle.
"""

import argparse
import contextlib
import dataclasses
import importlib
import inspect
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from test_torch_guards import BLOCKED
from test_torch_secure import cases, rebind

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

jcore = importlib.import_module(JAX_PKG + ".analysis.core")
pcore = importlib.import_module(PORT_PKG + ".analysis.core")
jcheck = importlib.import_module(JAX_PKG + ".cli.check")
pcheck = importlib.import_module(PORT_PKG + ".cli.check")
jlock = importlib.import_module(JAX_PKG + ".analysis.lockorder")
plock = importlib.import_module(PORT_PKG + ".analysis.lockorder")

RULES = (
    "bench-headline", "determinism", "obs-metric-once", "obs-span-vocab", "unguarded", "wire-domain-unique",
    "wire-magic-coverage", "wire-meta-key-unique", "wire-stream-direction",
)
#: ``rules`` in a result lists the registry in the order the process
#: imported the rule modules: in a fresh process, ``all_rules()``'s order.
#: Within one test process the two packages' imports interleave, so there
#: the lists are compared as sets.
FRESH_ORDER = [
    "determinism", "obs-span-vocab", "obs-metric-once", "bench-headline", "unguarded", "wire-domain-unique",
    "wire-magic-coverage", "wire-stream-direction", "wire-meta-key-unique",
]


# ------------------------------------------------------------ held calls
def _outcome(fn, *a, **kw):
    try:
        return fn(*a, **kw), None
    except Exception as e:  # compared with the other package's, then re-raised
        return None, e


def result_view(result) -> tuple:
    """What of a ``CheckResult`` must be equal across the packages: all of
    it but the runtime."""
    d = result.to_dict()
    d.pop("check_runtime_s")
    d["rules"] = sorted(d["rules"])
    return d, [f.render() for f in result.new], [f.render() for f in result.baselined], result.exit_code


def held_run_check(root, **kw):
    """The port's ``run_check``, held against the JAX package's on the
    same tree and arguments (or the same error)."""
    port, perr = _outcome(pcore.run_check, root, **kw)
    jax, jerr = _outcome(jcore.run_check, root, **kw)
    if perr is not None or jerr is not None:
        assert (type(perr), str(perr)) == (type(jerr), str(jerr))
        raise perr
    assert result_view(port) == result_view(jax)
    return port


def _baseline_path(args) -> str | None:
    if getattr(args, "baseline", None):
        return args.baseline
    root = getattr(args, "root", None) or REPO_ROOT
    path = os.path.join(os.path.abspath(root), "ANALYSIS_BASELINE.json")
    return path if os.path.isfile(path) else None


def _read(path):
    if path is None or not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def _run_cmd(cmd, args) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cmd(argparse.Namespace(**vars(args)))
    return rc, out.getvalue(), err.getvalue()


def cmd_view(rc: int, out: str, err: str) -> tuple:
    """A ``cmd_check`` outcome without what varies from run to run: the
    JSON document's ``check_runtime_s`` and the human summary's seconds."""
    try:
        doc = json.loads(out)
    except ValueError:
        return rc, re.sub(r"\(\d+\.\d+s\)", "(s)", out), err
    doc.pop("check_runtime_s")
    doc["rules"] = sorted(doc["rules"])
    return rc, doc, err


def held_cmd_check(args) -> int:
    """The port's ``cmd_check``, held against the JAX package's: each runs
    on the same baseline bytes (a prune rewrites the file), and their
    outputs and the bytes each left must be equal. The port's output goes
    to the caller's stdout and stderr."""
    path = _baseline_path(args)
    before = _read(path)
    jax = _run_cmd(jcheck.cmd_check, args)
    jax_after = _read(path)
    if before is not None:
        with open(path, "wb") as f:
            f.write(before)
    port = _run_cmd(pcheck.cmd_check, args)
    assert cmd_view(*port) == cmd_view(*jax)
    assert _read(path) == jax_after
    sys.stdout.write(port[1])
    sys.stderr.write(port[2])
    return port[0]


def repo_copy(tmp_path) -> str:
    """Both packages, ``bench.py`` and the baseline under ``tmp_path/copy``:
    the real tree's suffix resolution, in a tree a case may break."""
    dst = tmp_path / "copy"
    dst.mkdir()
    for pkg in (JAX_PKG, PORT_PKG):
        shutil.copytree(os.path.join(REPO_ROOT, pkg), dst / pkg, ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("bench.py", "ANALYSIS_BASELINE.json"):
        shutil.copy(os.path.join(REPO_ROOT, name), dst / name)
    return str(dst)


# ------------------------------------------------------- the JAX cases
JAX_ANALYSIS = importlib.import_module("test_analysis")
PORT_ANALYSIS = rebind("test_analysis", subpackages=("analysis", "cli"))
#: Reads the test session's arming state: the port variant is
#: test_port_detector_armed_inside_the_session.
SESSION_CASE = "test_lockorder_session_arming_state"
HELD_CASES = sorted(n for n in vars(JAX_ANALYSIS) if n.startswith("test_") and n != SESSION_CASE)


@pytest.mark.parametrize("name,kwargs", cases(PORT_ANALYSIS, HELD_CASES))
def test_analysis_case_held_against_jax(name, kwargs, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(PORT_ANALYSIS, "run_check", held_run_check)
    if name != "test_cli_parser_wires_check_subcommand":  # it pins the parser's own cmd_check
        monkeypatch.setattr(PORT_ANALYSIS, "cmd_check", held_cmd_check)
    fn = getattr(PORT_ANALYSIS, name)
    fixtures = {"tmp_path": lambda: tmp_path, "capsys": lambda: capsys, "repo_copy": lambda: repo_copy(tmp_path)}
    args = dict(kwargs)
    for p in inspect.signature(fn).parameters:
        args.setdefault(p, fixtures[p]())
    fn(**args)


def test_every_jax_analysis_case_is_held():
    names = {n for n in vars(JAX_ANALYSIS) if n.startswith("test_")}
    assert len(names) == 40 and set(HELD_CASES) == names - {SESSION_CASE}
    assert {p.values[0] for p in cases(PORT_ANALYSIS, HELD_CASES)} == set(HELD_CASES)
    # The re-bound module reads the port's analysis and check verb.
    assert PORT_ANALYSIS.lockorder is plock and PORT_ANALYSIS.cmd_check is pcheck.cmd_check


# ---------------------------------------------------- the verb, whole
def test_rules_and_list_rules_equal_the_jax_package(capsys):
    pr, jr = pcore.all_rules(), jcore.all_rules()
    assert tuple(sorted(pr)) == tuple(sorted(jr)) == RULES
    assert {n: r.description for n, r in pr.items()} == {n: r.description for n, r in jr.items()}
    args = argparse.Namespace(list_rules=True, root=None, json=False, baseline=None, rules=None)
    assert held_cmd_check(args) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(RULES)


@pytest.mark.parametrize("as_json", [False, True])
def test_cmd_check_on_the_repo_held_against_jax(as_json, capsys):
    """The verb over the repository with two rules: the human summary (its
    seconds aside) and the ``--json`` document (its runtime aside) equal
    the JAX package's; the baseline's entry is stale under these rules."""
    args = argparse.Namespace(
        list_rules=False, root=None, json=as_json, baseline=None, rules="determinism,wire-domain-unique",
        prune_baseline=False,
    )
    assert held_cmd_check(args) == 0
    out = capsys.readouterr().out
    if as_json:
        doc = json.loads(out)
        assert doc["findings_new"] == [] and doc["findings_baselined"] == 0 and len(doc["stale_baseline"]) == 1
        assert sorted(doc["rules"]) == ["determinism", "wire-domain-unique"]
    else:
        assert re.fullmatch(
            r"fedtpu check: 0 new finding\(s\), 0 baselined, \d+ pragma-allowed across \d+ modules \(\d+\.\d+s\)\n"
            r"note: 1 stale baseline entry .*\n  \[wire-magic-coverage\] .*\n",
            out,
        ), out


@pytest.fixture(scope="module")
def jax_repo_result():
    return jcore.run_check(REPO_ROOT)


def _blocked_run(argv: list[str]) -> subprocess.CompletedProcess:
    """``python -m <port>.cli <argv>`` in a subprocess with JAX, the JAX
    package and the rest of ``BLOCKED`` unimportable."""
    code = f"""
import runpy, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it raises ImportError
sys.path.insert(0, {REPO_ROOT!r})
sys.argv = ["check", *{argv!r}]
try:
    runpy.run_module("{PORT_PKG}.cli", run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None)
print(leaked, file=sys.stderr)
sys.exit(rc)
"""
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)


def test_check_json_runs_with_jax_blocked(jax_repo_result):
    res = _blocked_run(["check", "--json"])
    assert res.returncode == 0, res.stderr
    assert res.stderr.strip().splitlines()[-1] == "[]"
    doc = json.loads(res.stdout)
    assert doc["rules"] == FRESH_ORDER
    want = jax_repo_result.to_dict()
    for d in (doc, want):
        d.pop("check_runtime_s")
        d["rules"] = sorted(d["rules"])
    assert doc == want
    assert doc["findings_new"] == [] and doc["findings_baselined"] == 1 and doc["exit_code"] == 0
    assert doc["modules_scanned"] == len(pcore.Project(REPO_ROOT).modules)


def test_mutation_in_the_port_strategies_caught_by_both(tmp_path):
    """A wall clock feeding the key order of the port's server strategy:
    both checkers report the one determinism finding at the port's file."""
    root = repo_copy(tmp_path)
    path = os.path.join(root, PORT_PKG, "strategies", "core.py")
    with open(path) as f:
        src = f.read()
    for old, new in (
        ("from typing import Any\n", "import time\nfrom typing import Any\n"),
        ("keys = sorted(mean)\n", "keys = sorted(mean, key=lambda k: (time.time(), k))\n"),
    ):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    result = held_run_check(root)
    assert result.exit_code == 1
    assert [(f.rule, f.path) for f in result.new] == [("determinism", f"{PORT_PKG}/strategies/core.py")]
    assert "wall clock" in result.new[0].message


# ------------------------------------------------------- lock schedules
def _abba(lo):
    det = lo.LockOrderDetector()
    a, b = det.lock("siteA"), det.lock("siteB")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return det


def _consistent(lo):
    det = lo.LockOrderDetector()
    a, b = det.lock("siteA"), det.lock("siteB")
    for _ in range(3):
        with a:
            with b:
                pass
    return det


def _cross_thread(lo):
    det = lo.LockOrderDetector()
    a, b = det.lock("siteA"), det.lock("siteB")
    order = threading.Barrier(2, timeout=5)

    def ab():
        with a:
            with b:
                pass
        order.wait()

    def ba():
        order.wait()
        with b:
            with a:
                pass

    threads = [threading.Thread(target=ab), threading.Thread(target=ba)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    return det


def _same_site(lo):
    det = lo.LockOrderDetector()
    first, second, third = det.lock("shard"), det.lock("shard"), det.lock("shard")
    with first:
        with second:
            with third:
                pass
    with first:
        with third:
            pass
    return det


def _reentrant(lo):
    det = lo.LockOrderDetector()
    r, inner = det.rlock("outer"), det.lock("inner")
    with r:
        with r:
            with inner:
                pass
    return det


def _condition(lo):
    """A waiter holding ``a`` waits on ``cond`` (released and re-taken
    without an edge), then takes ``b``; the notifier enters only once
    the waiter is waiting, so every count is fixed."""
    det = lo.LockOrderDetector()
    a, b = det.lock("a"), det.lock("b")
    cond = threading.Condition(det.rlock("cond"))
    ready, hits = threading.Event(), []

    def waiter():
        with a:
            with cond:
                ready.set()
                hits.append(cond.wait(timeout=5))
                with b:
                    pass

    t = threading.Thread(target=waiter)
    t.start()
    assert ready.wait(timeout=5)
    with cond:
        cond.notify_all()
    t.join(timeout=5)
    assert hits == [True] and not t.is_alive()
    return det


def _handoff(lo):
    det = lo.LockOrderDetector()
    handoff, other = det.lock("handoff"), det.lock("other")
    acquired, released = threading.Event(), threading.Event()

    def acquirer():
        handoff.acquire()
        acquired.set()
        assert released.wait(timeout=5)
        with other:
            pass

    t = threading.Thread(target=acquirer)
    t.start()
    assert acquired.wait(timeout=5)
    handoff.release()
    released.set()
    t.join(timeout=5)
    assert not t.is_alive()
    return det


def _ring(lo):
    """A seeded walk over twelve locks on four sites: several cycles,
    some through same-site instances."""
    det = lo.LockOrderDetector()
    locks = [det.lock(f"site{i % 4}") for i in range(12)]
    rng = np.random.default_rng(3)
    for _ in range(40):
        picks = rng.choice(12, size=3, replace=False)
        with contextlib.ExitStack() as stack:
            for i in picks:
                stack.enter_context(locks[i])
    return det


SCHEDULES = {
    "abba": _abba, "consistent": _consistent, "cross-thread": _cross_thread, "same-site": _same_site,
    "reentrant-rlock": _reentrant, "condition": _condition, "handoff": _handoff, "ring": _ring,
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_lock_schedule_reports_equal_the_jax_package(schedule):
    reports = [SCHEDULES[schedule](lo).report() for lo in (jlock, plock)]
    assert dataclasses.asdict(reports[1]) == dataclasses.asdict(reports[0])
    assert reports[1].render() == reports[0].render()
    assert (reports[1].cycles != []) == (schedule in ("abba", "cross-thread", "ring"))


# ------------------------------------------ the port's detector, armed
def _factories():
    return threading.Lock, threading.RLock


def test_port_detector_armed_inside_the_session():
    """The port's ``arm()`` inside whatever the session armed (the JAX
    package's detector, in the fast lane): the port's locks are tracked at
    their port lines and wrap the session's factories; the JAX package's
    locks and this file's are not the port's; disarm restores the
    session's factories."""
    session = _factories()
    jax_det = jlock.armed_detector()
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.obs.metrics import (
        MetricsRegistry as JaxRegistry,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.obs.metrics import (
        MetricsRegistry,
    )

    det = plock.arm()
    try:
        assert plock.arm() is det and plock.armed_detector() is det
        reg = MetricsRegistry()
        assert isinstance(reg._lock, plock._TrackedLock)
        assert reg._lock.site.startswith(f"{PORT_PKG}/obs/metrics.py:")
        if jax_det is not None:
            # The session's tracked lock sits inside the port's.
            assert isinstance(reg._lock._inner, jlock._TrackedLock)
        with reg._lock:
            assert reg._lock.locked()
        assert not isinstance(JaxRegistry()._lock, plock._TrackedLock)
        assert not isinstance(threading.Lock(), plock._TrackedLock)
    finally:
        report = plock.disarm()
    assert _factories() == session and plock.armed_detector() is None and plock.disarm() is None
    assert jlock.armed_detector() is jax_det
    assert report.cycles == [] and report.acquisitions >= 1
    assert any(s.startswith(f"{PORT_PKG}/obs/metrics.py:") for s in report.sites)


def test_condition_hooks_pass_through_both_wrappers():
    """Locks this file creates, tracked by the port's detector (``paths``
    names the tests directory) over the session's: a ``Condition`` on a
    tracked RLock reaches the inner RLock's ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` through both wrappers, a wait
    re-takes the lock without an edge, and one on a tracked Lock takes
    the ``Condition`` fallback (no ``_release_save`` on a Lock)."""
    session = _factories()
    readies = [threading.Event() for _ in range(2)]  # untracked: made before arming
    plock.arm(paths=(TESTS,))
    try:
        rl = threading.RLock()
        lk = threading.Lock()
        other = threading.Lock()
        assert isinstance(rl, plock._TrackedLock) and rl.site.startswith("tests/test_torch_check.py:")
        assert callable(rl._release_save) and callable(rl._acquire_restore) and not rl._is_owned()
        with pytest.raises(AttributeError):
            lk._release_save
        for lock, ready in zip((rl, lk), readies):
            cond = threading.Condition(lock)
            hits = []

            def waiter(cond=cond, ready=ready, hits=hits):
                with cond:
                    ready.set()
                    hits.append(cond.wait(timeout=5))
                    with other:
                        pass

            t = threading.Thread(target=waiter)
            t.start()
            assert ready.wait(timeout=5)
            with cond:
                cond.notify_all()
            t.join(timeout=5)
            assert hits == [True] and not t.is_alive()
        assert rl._is_owned() is False
    finally:
        report = plock.disarm()
    assert _factories() == session
    assert report.cycles == []
    # rl -> other and lk -> other, once each: none from a wait's re-take.
    assert report.edges == {(rl.site, other.site): 1, (lk.site, other.site): 1}, report.edges


def test_port_tcp_round_under_the_armed_detector():
    """A CPU TCP round of the port (server folding on the CPU, two port
    clients) with the port's detector armed: no cycle, and the server's
    and the clients' locks tracked at their port lines."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.comm import (
        aggregate_flat,
        wire as jwire,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
        AggregationServer,
        FederatedClient,
        wire as pwire,
    )

    rng = np.random.default_rng(11)
    models = [
        {"enc": {"w": rng.normal(size=(8, 8)).astype(np.float32)}, "head": rng.normal(size=(3,)).astype(np.float32)}
        for _ in range(2)
    ]
    session = _factories()
    results, errors = {}, []
    plock.arm()
    try:
        with AggregationServer(port=0, num_clients=2, timeout=30, device="cpu") as server:

            def run(i):
                try:
                    got = FederatedClient("127.0.0.1", server.port, client_id=i, timeout=30).exchange(
                        models[i], max_retries=2
                    )
                    results[i] = pwire.flatten_params(got)
                except BaseException as e:  # re-raised by the test thread
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(2)]
            for t in threads:
                t.start()
            server.serve_round(deadline=30.0)
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        report = plock.disarm()
    assert _factories() == session
    assert not errors, errors
    assert report.cycles == [], report.render()
    assert report.acquisitions > 0
    sites = {s.rsplit(":", 1)[0] for s in report.sites}
    assert {f"{PORT_PKG}/comm/server.py", f"{PORT_PKG}/comm/client.py"} <= sites, sites
    want = jwire.flat_crc32(aggregate_flat([jwire.flatten_params(m) for m in models], None))
    assert sorted(results) == [0, 1] and all(pwire.flat_crc32(r) == want for r in results.values())


def test_check_verb_parses_as_the_jax_package_s():
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        build_parser as jax_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )

    def sub(parser):
        action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return action.choices["check"], {c.dest: c.help for c in action._choices_actions}["check"]

    (pp, phelp), (jp, jhelp) = sub(build_parser()), sub(jax_parser())
    assert phelp == jhelp and pp.epilog == jp.epilog
    flags = lambda p: [(a.option_strings, a.dest, a.help, a.default) for a in p._actions]  # noqa: E731
    assert flags(pp) == flags(jp)
    argv = ["check", "--json", "--rules", "determinism", "--root", "x", "--baseline", "b.json", "--prune-baseline"]
    pa, ja = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert pa.fn is pcheck.cmd_check and ja.fn is jcheck.cmd_check
    # The verb's own dest: the port's parser names it cmd, the JAX one command.
    drop = ("fn", "cmd", "command")
    assert {k: v for k, v in vars(pa).items() if k not in drop} == {k: v for k, v in vars(ja).items() if k not in drop}
    assert not hasattr(pa, "device")
    assert pcheck._default_root() == jcheck._default_root() == REPO_ROOT
