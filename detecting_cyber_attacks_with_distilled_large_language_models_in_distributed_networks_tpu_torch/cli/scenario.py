"""``scenario``: the "federated in the wild" matrix runner (the port of the
JAX package's ``cli/scenario.py``).

Sweeps a persona x partition matrix of LIVE loopback federated rounds
(faults/scenario.py): each cell is a real ``AggregationServer`` (its fold
on the card unless ``--device cpu``) plus client threads, with the cell's
persona driving wire faults through the deterministic fault proxy.
Prints the comparison grid, writes ``grid.txt`` + ``scenario.jsonl``
under ``--out-dir``, and exits 1 when the robustness contract breaks: a
quorum-satisfiable cell's round failing, or an aggregate not bit-exact
with the clean survivor mean.
"""

from __future__ import annotations

import json
import logging

log = logging.getLogger(__name__)


def cmd_scenario(args) -> int:
    from ..device import resolve_device
    from ..faults.personas import get_persona
    from ..faults.scenario import PARTITION_LABELS, ScenarioConfig, cell_record, contract_violations, run_matrix
    from ..strategies import parse_strategy

    device = str(resolve_device(args.device))  # raises before any cell without CUDA
    personas = tuple(p.strip() for p in args.personas.split(",") if p.strip())
    for p in personas:
        get_persona(p)  # an operator message, not a traceback mid-run
    partitions = tuple(p.strip() for p in args.partitions.split(",") if p.strip())
    for p in partitions:
        if p not in PARTITION_LABELS:
            raise SystemExit(f"unknown partition {p!r} (one of {', '.join(PARTITION_LABELS)})")
    if not personas or not partitions:
        raise SystemExit("need at least one persona and one partition")
    strategies: tuple[str, ...] = ()
    if args.strategies:
        # ';' separates specs (a spec's own params use ','); plain ','
        # still works for bare names.
        raw = args.strategies
        sep = ";" if ";" in raw or ":" in raw else ","
        strategies = tuple(s.strip() for s in raw.split(sep) if s.strip())
        for s in strategies:
            try:
                parse_strategy(s)
            except ValueError as e:
                raise SystemExit(str(e)) from None
    cfg = ScenarioConfig(
        num_clients=args.clients,
        rounds=args.rounds,
        personas=personas,
        partitions=partitions,
        dirichlet_alpha=args.dirichlet_alpha,
        seed=args.fault_seed,
        payload_kb=args.payload_kb,
        deadline_s=args.deadline,
        stream_chunk_bytes=0 if args.no_stream else (1 << 15),
        auth_cell=not args.no_auth_cell,
        dead_relay_cell=not args.no_dead_relay_cell,
        train=args.train,
        strategies=strategies,
        device=device,
    )
    results, grid = run_matrix(cfg, args.out_dir)
    if args.json:
        for res in results:
            print(json.dumps(cell_record(res)))
    else:
        print(grid)
    violations = contract_violations(results)
    if violations:
        for v in violations:
            log.error(f"[SCENARIO] contract violation: {v}")
        return 1
    log.info(
        f"[SCENARIO] {len(results)} cells x {cfg.rounds} rounds: every "
        "quorum-satisfiable round succeeded over survivors, all "
        "aggregates crc-pinned bit-exact to the clean survivor mean "
        f"(outputs under {args.out_dir})"
    )
    return 0
