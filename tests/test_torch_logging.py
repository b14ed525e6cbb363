"""Phase brackets (utils/logging.py) held against the JAX package's.

The reference's record of a run is its begin/end brackets
(``[TAG] Starting <phase> at <time>`` / ``[TAG] Finished <phase> at
<time> (<s> s)``). A verb run by each package on the CPU prints the same
bracket lines, in the same order, timestamps and seconds aside; and
``phase`` itself prints the JAX module's lines.
"""

import importlib
import re
import subprocess
import sys

import pytest

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"

BRACKET = re.compile(r"^(\[[^]]+\] )?(Starting|Finished) (.*) at \d{4}-\d\d-\d\d [\d:.]+( \([\d.]+ s\))?$")

_RUN = {
    "jax": (
        "import jax\njax.config.update('jax_platforms', 'cpu')\n"
        f"from {JAX_PKG}.cli import main\nraise SystemExit(main({{argv!r}}))\n"
    ),
    "port": f"from {PORT_PKG}.cli import main\nraise SystemExit(main({{argv!r}} + ['--device', 'cpu']))\n",
}


def _brackets(pkg: str, argv: list[str]) -> list[tuple[str, str, str]]:
    res = subprocess.run(
        [sys.executable, "-c", _RUN[pkg].format(argv=argv)], capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out = []
    for line in res.stdout.splitlines():
        m = BRACKET.match(line)
        if m:
            out.append((m.group(1) or "", m.group(2), m.group(3)))
    return out


@pytest.mark.parametrize(
    "argv",
    [
        ["local", "--preset", "tiny", "--synthetic", "300", "--epochs", "1"],
        ["federated", "--preset", "tiny", "--synthetic", "300", "--epochs", "1", "--num-clients", "2",
         "--rounds", "1", "--personalize-epochs", "1"],
    ],
    ids=["local", "federated"],
)
def test_verb_prints_the_jax_brackets(argv, tmp_path):
    argv = [*argv, "--output-dir", str(tmp_path / "out")]
    port, jax = _brackets("port", argv), _brackets("jax", argv)
    assert len(jax) >= 6 and port == jax
    tags = {t for t, _, _ in jax}
    assert "[DATA] " in tags


def test_phase_lines_and_seconds(capsys):
    plog = importlib.import_module(PORT_PKG + ".utils.logging")
    jlog = importlib.import_module(JAX_PKG + ".utils.logging")
    assert plog._FORMAT == jlog._FORMAT
    lines = {}
    for name, mod in (("port", plog), ("jax", jlog)):
        logger = mod.get_logger(f"bracket-test-{name}")
        with mod.phase("model training", tag="CLIENT 0", logger=logger) as info:
            pass
        assert info["seconds"] >= 0.0
        lines[name] = capsys.readouterr().out.splitlines()
    for name in lines:
        assert len(lines[name]) == 2
        for line in lines[name]:
            assert BRACKET.match(line), line
    strip = [[re.sub(r" at .*", "", ln) for ln in lines[n]] for n in ("port", "jax")]
    assert strip[0] == strip[1] == ["[CLIENT 0] Starting model training", "[CLIENT 0] Finished model training"]
