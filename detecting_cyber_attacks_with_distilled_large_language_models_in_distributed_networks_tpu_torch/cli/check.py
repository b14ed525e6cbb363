"""fedtpu check — run the invariant-aware static-analysis passes.

    fedtpu check                      # scan the repo, human-readable
    fedtpu check --json               # machine-readable (CI, the smoke)
    fedtpu check --rules determinism,unguarded
    fedtpu check --baseline ANALYSIS_BASELINE.json
    fedtpu check --list-rules

Exit codes: 0 = clean (pragma'd/baselined findings allowed), 1 = at
least one NON-baselined finding, 2 = usage/internal error. The port runs
it as ``python -m <port> check``; it is a host verb (no device, no
``--device``), and chip_smoke.py runs it on the card's host.

Suppression is always reviewed: a per-line
``# fedtpu: allow(<rule>): reason`` pragma at the site, or an entry
with a ``reason`` in the repo-root ``ANALYSIS_BASELINE.json``. Stale
baseline entries (findings since fixed) are reported for cleanup but
never fail the check.
"""

from __future__ import annotations

import json
import os
import sys

from ..analysis import all_rules, run_check
from ..analysis.core import BASELINE_NAME, prune_baseline


def _default_root() -> str:
    """The repo root: the parent of the package directory this module
    lives in (cli/ -> package -> root)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def cmd_check(args) -> int:
    if getattr(args, "list_rules", False):
        for name, rule in sorted(all_rules().items()):
            print(f"{name:24s} {rule.description}")
        return 0
    root = getattr(args, "root", None) or _default_root()
    rules = None
    if getattr(args, "rules", None):
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        result = run_check(
            root,
            rules=rules,
            baseline_path=getattr(args, "baseline", None),
        )
    except (ValueError, OSError) as e:
        print(f"fedtpu check: {e}", file=sys.stderr)
        return 2

    if getattr(args, "prune_baseline", False):
        # The remediation path for stale entries: rewrite the baseline
        # minus findings that no longer fire. Resolve the path exactly
        # as run_check did (explicit --baseline, else the scanned
        # root's ANALYSIS_BASELINE.json when present).
        bpath = getattr(args, "baseline", None)
        if bpath is None:
            candidate = os.path.join(os.path.abspath(root), BASELINE_NAME)
            bpath = candidate if os.path.isfile(candidate) else None
        if bpath is None:
            print(
                "fedtpu check: --prune-baseline found no baseline file "
                "to prune",
                file=sys.stderr,
            )
            return 2
        removed = (
            prune_baseline(bpath, result.stale_baseline)
            if result.stale_baseline
            else 0
        )
        print(
            f"fedtpu check: pruned {removed} stale baseline entr"
            f"{'y' if removed == 1 else 'ies'} from {bpath}",
            # --json consumers parse stdout as ONE JSON document; the
            # human-facing prune notice must not corrupt it.
            file=sys.stderr if getattr(args, "json", False) else sys.stdout,
        )
        result.stale_baseline = []

    if getattr(args, "json", False):
        json.dump(result.to_dict(), sys.stdout, indent=2)
        sys.stdout.write("\n")
        return result.exit_code

    for f in result.new:
        print(f.render())
    summary = (
        f"fedtpu check: {len(result.new)} new finding(s), "
        f"{len(result.baselined)} baselined, {result.allowed} "
        f"pragma-allowed across {result.modules_scanned} modules "
        f"({result.runtime_s:.2f}s)"
    )
    print(summary)
    if result.stale_baseline:
        print(
            f"note: {len(result.stale_baseline)} stale baseline entr"
            f"{'y' if len(result.stale_baseline) == 1 else 'ies'} "
            "(finding no longer fires — prune when convenient):"
        )
        for entry in result.stale_baseline:
            print(f"  [{entry['rule']}] {entry['path']}: {entry['message']}")
    return result.exit_code
