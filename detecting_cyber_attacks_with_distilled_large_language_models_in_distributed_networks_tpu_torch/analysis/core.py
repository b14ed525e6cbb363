"""The pass framework behind ``fedtpu check``.

Design constraints, in order:

1. **Pure AST** — the checker never imports the code it scans, so a
   seeded-mutation self-test can point it at a temp copy of the tree
   (tests/test_torch_check.py, chip_smoke.py) and a broken module can't crash the linter
   that is supposed to flag it.
2. **Reviewed suppressions only** — a finding disappears exactly two
   ways: a per-line ``# fedtpu: allow(<rule>): reason`` pragma at the
   finding site (the reviewed-in-place form), or an entry in the
   repo-root ``ANALYSIS_BASELINE.json`` (the reviewed-at-a-distance
   form, for findings whose site is a poor home for a comment). Both
   carry a human reason; neither is emitted by tooling.
3. **Stable identity** — findings are keyed (rule, path, message), NOT
   line numbers, so a baseline survives unrelated edits above the
   finding; messages therefore name symbols, not offsets.

Exit-code contract (cli/check.py): 0 = clean (baselined/pragma'd
findings allowed), 1 = at least one non-baselined finding, 2 = usage
or internal error. chip_smoke.py's ``check`` phase requires exit 0 on
the tree it runs from and exit 1, with the one seeded finding, on each
mutated copy.
"""

from __future__ import annotations

import ast
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Mapping

#: Per-line suppression: ``# fedtpu: allow(rule)`` or
#: ``# fedtpu: allow(rule-a, rule-b): one-line reason``. The pragma
#: suppresses matching rules on ITS line and, when the pragma line is a
#: comment-only line, on the next code line (multi-line statements keep
#: the reason adjacent instead of trailing a 100-char expression).
PRAGMA_RE = re.compile(r"#\s*fedtpu:\s*allow\(([A-Za-z0-9_\-, ]+)\)")

#: Default baseline filename, resolved against the scanned root.
BASELINE_NAME = "ANALYSIS_BASELINE.json"


@dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str
    path: str  # root-relative, forward slashes
    line: int
    message: str

    @property
    def key(self) -> tuple[str, str, str]:
        """Baseline identity — line numbers excluded on purpose (they
        churn under unrelated edits; messages name symbols instead)."""
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }


class SourceModule:
    """One parsed source file: AST + lines + pragma map."""

    def __init__(self, root: str, path: str):
        self.abspath = path
        self.rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        # A file the interpreter can't parse is reported as a finding by
        # the project scan itself (rule "parse"), with tree=None; rules
        # must tolerate missing trees.
        try:
            self.tree: ast.Module | None = ast.parse(
                self.source, filename=self.rel
            )
        except SyntaxError as e:
            self.tree = None
            self.syntax_error = f"{e.msg} (line {e.lineno})"
        else:
            self.syntax_error = None
        self._allow = self._parse_pragmas()

    def _parse_pragmas(self) -> dict[int, frozenset[str]]:
        allow: dict[int, set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = PRAGMA_RE.search(text)
            if not m:
                continue
            rules = frozenset(
                r.strip() for r in m.group(1).split(",") if r.strip()
            )
            allow.setdefault(i, set()).update(rules)
            # A comment-only pragma covers the comment block it starts
            # plus the first code line after it (the reason may wrap).
            if text.lstrip().startswith("#"):
                j = i + 1
                while j <= len(self.lines) and self.lines[
                    j - 1
                ].lstrip().startswith("#"):
                    allow.setdefault(j, set()).update(rules)
                    j += 1
                allow.setdefault(j, set()).update(rules)
        return {k: frozenset(v) for k, v in allow.items()}

    def allowed(self, rule: str, line: int) -> bool:
        rules = self._allow.get(line)
        return bool(rules) and (rule in rules or "all" in rules)

    def walk(self) -> Iterator[ast.AST]:
        if self.tree is None:
            return iter(())
        return ast.walk(self.tree)


class Project:
    """The scanned tree: every package module + top-level scripts.

    ``root`` is the repo root; packages are its top-level directories
    carrying an ``__init__.py`` (``tests/`` is excluded — test files
    intentionally embed violating snippets as fixtures), plus the
    top-level ``*.py`` entry points (bench.py, __graft_entry__.py).
    """

    EXCLUDE_DIRS = {"tests", "__pycache__", ".git", ".claude"}

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.modules: list[SourceModule] = []
        for path in sorted(self._source_paths()):
            self.modules.append(SourceModule(self.root, path))
        self._by_rel = {m.rel: m for m in self.modules}

    def _source_paths(self) -> Iterator[str]:
        for entry in sorted(os.listdir(self.root)):
            full = os.path.join(self.root, entry)
            if entry.endswith(".py") and os.path.isfile(full):
                yield full
            elif (
                os.path.isdir(full)
                and entry not in self.EXCLUDE_DIRS
                and os.path.isfile(os.path.join(full, "__init__.py"))
            ):
                for dirpath, dirnames, filenames in os.walk(full):
                    dirnames[:] = [
                        d for d in dirnames if d not in self.EXCLUDE_DIRS
                    ]
                    for fn in filenames:
                        if fn.endswith(".py"):
                            yield os.path.join(dirpath, fn)

    def module(self, rel_suffix: str) -> SourceModule | None:
        """Look a module up by root-relative path suffix (the package
        directory name varies between the repo and a test's temp copy,
        so rules address ``comm/wire.py``, not the full path)."""
        for m in self.modules:
            if m.rel == rel_suffix or m.rel.endswith("/" + rel_suffix):
                return m
        return None

    def select(self, rel_suffixes: Iterable[str]) -> list[SourceModule]:
        out = []
        for suf in rel_suffixes:
            if suf.endswith("/"):
                out.extend(
                    m
                    for m in self.modules
                    if ("/" + suf) in ("/" + m.rel)
                    or m.rel.startswith(suf)
                )
            else:
                m = self.module(suf)
                if m is not None:
                    out.append(m)
        return out


@dataclass
class Rule:
    """A named pass: ``fn(project) -> iterable of Finding``."""

    name: str
    description: str
    fn: Callable[[Project], Iterable[Finding]]

    def run(self, project: Project) -> list[Finding]:
        return list(self.fn(project))


_REGISTRY: dict[str, Rule] = {}


def register(name: str, description: str):
    """Decorator: add a pass to the default rule set."""

    def deco(fn: Callable[[Project], Iterable[Finding]]):
        _REGISTRY[name] = Rule(name, description, fn)
        return fn

    return deco


def all_rules() -> dict[str, Rule]:
    """Name -> Rule for the full default set (imports the rule modules
    lazily so ``analysis.core`` stays importable on its own)."""
    from . import (  # noqa: F401
        determinism_rules,
        obs_rules,
        thread_rules,
        wire_rules,
    )

    return dict(_REGISTRY)


# ------------------------------------------------------------------ baseline
def load_baseline(path: str) -> dict[tuple[str, str, str], str]:
    """Baseline file -> {finding key: reason}. Every entry must carry a
    non-empty ``reason`` — the baseline is a reviewed artifact, not a
    dumping ground (an empty reason raises)."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out: dict[tuple[str, str, str], str] = {}
    for entry in data.get("findings", ()):
        reason = str(entry.get("reason", "")).strip()
        if not reason:
            raise ValueError(
                f"baseline entry for {entry.get('rule')}:{entry.get('path')} "
                "has no reason — baselines are reviewed suppressions"
            )
        out[(str(entry["rule"]), str(entry["path"]), str(entry["message"]))] = (
            reason
        )
    return out


def prune_baseline(path: str, stale: Iterable[Mapping]) -> int:
    """Rewrite the baseline at ``path`` minus the given stale entries
    (the remediation path for ``fedtpu check``'s reported-not-failed
    stale findings: ``--prune-baseline``). Every other field — the
    review comment, entry order, the reasons of entries that still fire
    — survives byte-for-byte in spirit (same JSON shape, 2-space
    indent). Atomic replace, so a crashed prune never leaves a torn
    baseline. Returns the number of entries removed."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    stale_keys = {
        (str(e["rule"]), str(e["path"]), str(e["message"])) for e in stale
    }
    findings = list(data.get("findings", ()))
    kept = [
        e
        for e in findings
        if (str(e.get("rule")), str(e.get("path")), str(e.get("message")))
        not in stale_keys
    ]
    removed = len(findings) - len(kept)
    if removed == 0:
        return 0
    data["findings"] = kept
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)
    return removed


@dataclass
class CheckResult:
    """One ``fedtpu check`` run's outcome."""

    new: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    allowed: int = 0  # pragma-suppressed count
    stale_baseline: list[dict] = field(default_factory=list)
    runtime_s: float = 0.0
    rules_run: tuple[str, ...] = ()
    modules_scanned: int = 0

    @property
    def exit_code(self) -> int:
        return 1 if self.new else 0

    def to_dict(self) -> dict:
        return {
            "findings_new": [f.to_dict() for f in self.new],
            "findings_baselined": len(self.baselined),
            "findings_allowed": self.allowed,
            "stale_baseline": self.stale_baseline,
            "check_runtime_s": self.runtime_s,
            "rules": list(self.rules_run),
            "modules_scanned": self.modules_scanned,
            "exit_code": self.exit_code,
        }


def run_check(
    root: str,
    *,
    rules: Iterable[str] | None = None,
    baseline_path: str | None = None,
) -> CheckResult:
    """Scan ``root`` with the selected rules (default: all), apply
    pragmas + baseline, and return the partitioned findings."""
    t0 = time.monotonic()
    registry = all_rules()
    if rules is None:
        selected = list(registry.values())
    else:
        unknown = [r for r in rules if r not in registry]
        if unknown:
            raise ValueError(
                f"unknown rule(s) {unknown}; known: {sorted(registry)}"
            )
        selected = [registry[r] for r in rules]
    project = Project(root)
    result = CheckResult(
        rules_run=tuple(r.name for r in selected),
        modules_scanned=len(project.modules),
    )

    raw: list[Finding] = []
    for m in project.modules:
        if m.syntax_error:
            raw.append(
                Finding("parse", m.rel, 1, f"syntax error: {m.syntax_error}")
            )
    for rule in selected:
        raw.extend(rule.run(project))

    if baseline_path is None:
        candidate = os.path.join(project.root, BASELINE_NAME)
        baseline_path = candidate if os.path.isfile(candidate) else None
    baseline = load_baseline(baseline_path) if baseline_path else {}

    seen_keys = set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule, f.message)):
        seen_keys.add(f.key)
        mod = project._by_rel.get(f.path)
        if mod is not None and mod.allowed(f.rule, f.line):
            result.allowed += 1
        elif f.key in baseline:
            result.baselined.append(f)
        else:
            result.new.append(f)
    # Stale entries (fixed findings still baselined) are surfaced for
    # cleanup but never fail the check — a fix shouldn't force a
    # same-commit baseline edit.
    for key, reason in baseline.items():
        if key not in seen_keys:
            result.stale_baseline.append(
                {
                    "rule": key[0],
                    "path": key[1],
                    "message": key[2],
                    "reason": reason,
                }
            )
    result.runtime_s = time.monotonic() - t0
    return result


# ------------------------------------------------------- shared AST helpers
def call_name(node: ast.Call) -> str:
    """Dotted name of a call target: ``a.b.c(...)`` -> ``"a.b.c"``
    (non-name/attribute shapes -> ``""``)."""
    parts: list[str] = []
    cur: ast.expr = node.func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


def str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def bytes_const(node: ast.AST) -> bytes | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, bytes):
        return node.value
    return None


def kwarg(node: ast.Call, name: str) -> ast.expr | None:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> ``"X"`` (anything else -> None)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None
