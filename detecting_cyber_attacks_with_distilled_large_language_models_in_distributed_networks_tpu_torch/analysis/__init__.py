"""fedtpu check — invariant-aware static analysis for the federated tier,
the port's own copy (it imports nothing of the JAX package).

The codebase's correctness rests on hand-maintained invariants that no
type checker sees: disjoint HMAC domains per frame/direction in
comm/wire.py, crc-bit-exact pinned fold order in the aggregation paths,
seeded-only randomness in the chaos/partition layers, a closed span
vocabulary in obs/trace.py, and lock discipline across the threaded
server/serving tiers. This package encodes those contracts as AST
passes (``python -m <port> check``) plus a runtime lock-order cycle
detector (:mod:`analysis.lockorder`), which chip_smoke.py arms over a
full-width round and the router on the card.

The passes scan the whole repository, both packages: a rule that names a
file by path suffix (``comm/wire.py``) resolves to the first match in
sorted order, the JAX package's; a rule that names a directory
(``strategies/``) covers both packages' copies. On the same tree this
copy gives the JAX package's findings, messages and exit codes.

Layout:

* :mod:`analysis.core` — the pass framework: :class:`~.core.Rule`,
  :class:`~.core.Finding`, project scanning, per-line
  ``# fedtpu: allow(<rule>)`` pragmas, the reviewed
  ``ANALYSIS_BASELINE.json``, and :func:`~.core.run_check`.
* :mod:`analysis.wire_rules` — wire-domain pass (magic/domain
  uniqueness + coverage, explicit stream ``direction=``).
* :mod:`analysis.determinism_rules` — determinism pass over the
  crc-contract modules (fold/partition order must be seeded and
  reproducible).
* :mod:`analysis.thread_rules` — concurrency pass (cross-thread
  attribute writes must be lock-guarded or pragma'd).
* :mod:`analysis.obs_rules` — obs-vocabulary pass (span names ⊆
  SPAN_NAMES, consistent metric registration, bench headline fields
  actually produced).
* :mod:`analysis.lockorder` — runtime lock-order detector (a
  ``threading.Lock``/``RLock`` wrapper building a per-creation-site
  acquisition graph; cycles = deadlock risk).
"""

from .core import (  # noqa: F401
    CheckResult,
    Finding,
    Rule,
    Project,
    all_rules,
    load_baseline,
    run_check,
)
