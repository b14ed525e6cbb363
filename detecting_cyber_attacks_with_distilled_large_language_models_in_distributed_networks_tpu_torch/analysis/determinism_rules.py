"""Determinism pass: the crc-contract modules must stay replayable.

The aggregation paths pin bit-exactness contracts: a streamed fold must
equal the barrier mean (comm/stream_agg.py), a depth-2 relay tree must
equal ``aggregate_tree``'s flat replay (comm/relay.py), same-seed
partitions must be identical across runs AND tiers (data/partition.py),
and a chaos campaign must replay byte-for-byte from its seed (faults/).
Every one of those contracts dies the moment wall-clock time, OS
entropy, or unseeded RNG state leaks into a value or an ordering — and
dies silently, as a crc mismatch in a live 256-client run instead of a
test failure.

``determinism`` flags, inside the contract modules only:

* ``time.time()`` / ``time.time_ns()`` — wall clock in a value path
  (``time.monotonic`` is exempt: durations don't feed folds);
* unseeded stdlib ``random.*`` calls (an explicitly constructed
  ``random.Random(seed)`` instance is fine — the rule matches the
  module, not instances);
* ``np.random.*`` convenience calls (the legacy global-state API);
  seeded constructors (``default_rng``/``Generator``/``Philox``/
  ``PCG64``/``SeedSequence``/``RandomState``) pass;
* ``os.urandom`` / ``uuid.uuid4`` / ``secrets.*`` — OS entropy;
* iterating directly over a ``set`` (literal, comprehension, or
  ``set()``/``frozenset()`` call) in a ``for`` or comprehension — set
  order is hash-randomized across processes, so a fold or partition
  driven by it diverges between the live run and its replay
  (``sorted(set(...))`` does not trigger: the sort re-pins the order).

Intentional uses stay, with a reviewed reason:
``# fedtpu: allow(determinism): <why this is not order/value-feeding>``
(e.g. span timestamps, nonce generation, fault-proxy wall-clock
throttling).
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Project, call_name, register

#: The crc-contract surface: fold arithmetic, fold order,
#: partition assignment, the chaos layer's replayable plans, and the
#: FSDP shard-spec builders (parallel/mesh.py fsdp_dim/fsdp_spec must
#: pick the SAME shard layout on every process/round — the wire tier
#: scatters reply leaves onto specs it derives independently).
SCOPE = (
    "parallel/fedavg.py",
    "parallel/mesh.py",
    "comm/stream_agg.py",
    "comm/relay.py",
    "data/partition.py",
    "faults/",
    # Server aggregation strategies transform every round's global —
    # any nondeterminism here breaks the crc replay gate directly.
    "strategies/",
    # Wire-efficiency tier: the int8c quantize/dequant codec
    # and the batched fold engines both sit INSIDE the crc contract —
    # dequantization must replay bit-exactly and every fold engine must
    # match the ascending-id numpy accumulation bit-for-bit.
    "comm/quant.py",
    "ops/fold.py",
    # Delayed ground-truth plane: journal replay and the
    # scored-records join must rebuild bit-identical state from the
    # same files — timestamps are caller-supplied, never clock-read.
    "labels/",
    # Sharded scorer: the serving engine's bucket programs
    # and shard layout sit inside the crc contract too — a sharded
    # replica must replay the replicated engine's probs bit-for-bit
    # (bench's serve_fsdp_crc_exact), which any nondeterministic
    # bucketing/padding/placement choice here would break.
    "serving/engine.py",
)

_SEEDED_NP_CTORS = frozenset(
    {
        "default_rng",
        "Generator",
        "Philox",
        "PCG64",
        "PCG64DXSM",
        "MT19937",
        "SeedSequence",
        "RandomState",
    }
)

RULE = "determinism"


def _module_imports(module) -> set[str]:
    """Top-level module names bound by import statements (``random``,
    ``time``, ...), so ``random.shuffle`` from a local variable named
    ``random`` is not confused with the stdlib module."""
    names: set[str] = set()
    for node in module.walk():
        if isinstance(node, ast.Import):
            for alias in node.names:
                names.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                names.add(alias.asname or alias.name)
    return names


def _flag_call(node: ast.Call, imports: set[str]) -> str | None:
    name = call_name(node)
    if not name:
        return None
    head = name.split(".", 1)[0]
    if name in ("time.time", "time.time_ns") and "time" in imports:
        return (
            f"{name}() is wall clock — a value/ordering input here breaks "
            "the replay contract (time.monotonic for durations)"
        )
    if head == "random" and "random" in imports:
        tail = name.rsplit(".", 1)[-1]
        if tail == "SystemRandom":
            return "random.SystemRandom is OS entropy — unreplayable"
        if tail in ("Random", "seed"):
            return None  # explicit instance construction / explicit seeding
        return (
            f"{name}() draws from the process-global unseeded RNG — use a "
            "seeded random.Random(seed) / np.random.default_rng(seed)"
        )
    if (
        name.startswith(("np.random.", "numpy.random."))
        and name.rsplit(".", 1)[-1] not in _SEEDED_NP_CTORS
    ):
        return (
            f"{name}() uses numpy's legacy global RNG state — construct a "
            "seeded generator (np.random.default_rng(seed)) instead"
        )
    if name == "os.urandom" and "os" in imports:
        return "os.urandom() is OS entropy — unreplayable by definition"
    if name in ("uuid.uuid4", "uuid.uuid1") and "uuid" in imports:
        return f"{name}() is OS-entropy-derived — unreplayable"
    if head == "secrets" and "secrets" in imports:
        return f"{name}() is OS entropy — unreplayable"
    return None


def _is_set_expr(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return call_name(node) in ("set", "frozenset")
    return False


@register(
    RULE,
    "no wall clock / unseeded RNG / OS entropy / set-order iteration "
    "inside the crc-contract modules",
)
def check_determinism(project: Project) -> Iterator[Finding]:
    for m in project.select(SCOPE):
        imports = _module_imports(m)
        for node in m.walk():
            if isinstance(node, ast.Call):
                msg = _flag_call(node, imports)
                if msg:
                    yield Finding(RULE, m.rel, node.lineno, msg)
            iters: list[ast.expr] = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(
                node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
            ):
                iters.extend(gen.iter for gen in node.generators)
            for it in iters:
                if _is_set_expr(it):
                    yield Finding(
                        RULE,
                        m.rel,
                        it.lineno,
                        "iteration directly over a set — hash-randomized "
                        "order feeding a fold/partition path diverges "
                        "between run and replay; iterate "
                        "sorted(...) instead",
                    )
