"""``shadow``: the shadow evaluation plane's operator surface (the port of
the JAX package's ``cli/shadow.py``; it reads the registry directory
only, whichever package wrote it).

``status`` answers "what is under live shadow evaluation right now, and
how is it doing?" from the registry directory alone: the shadow pointer,
the comparator's latest atomic status snapshot, and the serving pointer
it is being measured against. ``report`` replays an artifact's paired-
records JSONL into the full disagreement picture (pairs, flips, score
movement, per-side histograms) — the evidence behind a gate verdict,
inspectable after the fact exactly like a registry event.
"""

from __future__ import annotations

import json


def _load_pairs(path: str) -> list[dict]:
    from ..shadow import PAIR_SCHEMA

    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail / foreign line
                if (
                    isinstance(rec, dict)
                    and rec.get("schema") == PAIR_SCHEMA
                ):
                    out.append(rec)
    except OSError:
        pass
    return out


def _resolve_artifact(args, registry) -> str | None:
    """--artifact wins; else the current shadow pointer's artifact."""
    aid = getattr(args, "artifact", None)
    if aid:
        return aid
    info = registry.shadow_info()
    return info.get("artifact") if info else None


def cmd_shadow(args) -> int:
    from ..registry import ModelRegistry, RegistryError
    from ..shadow import pairs_path, read_status

    registry = ModelRegistry(args.registry_dir)
    try:
        if args.action == "status":
            shadow = registry.shadow_info()
            serving = registry.serving_info()
            status = (
                read_status(args.registry_dir, shadow["artifact"])
                if shadow
                else None
            )
            if args.json:
                print(
                    json.dumps(
                        {
                            "shadow": shadow,
                            "serving": serving,
                            "status": status,
                        }
                    )
                )
                return 0
            if shadow is None:
                print("(nothing is under shadow evaluation)")
                if serving:
                    print(f"serving: {serving['artifact']}")
                return 0
            print(
                f"shadow artifact: {shadow['artifact']} "
                f"(round {shadow.get('round')})"
            )
            print(
                "serving incumbent: "
                + (serving["artifact"] if serving else "(none)")
            )
            if status is None:
                print("no comparator status yet (mirror not armed, or "
                      "no mirrored traffic)")
                return 0
            print(
                f"pairs {status.get('pairs', 0)}  flips "
                f"{status.get('flips', 0)}  flip_rate "
                f"{status.get('flip_rate', 0.0):.4f}  mean|dprob| "
                f"{status.get('mean_abs_dprob', 0.0):.4f}  psi "
                + (
                    f"{status['psi']:.4f}"
                    if status.get("psi") is not None
                    else "n/a"
                )
            )
            return 0
        if args.action == "report":
            aid = _resolve_artifact(args, registry)
            if aid is None:
                raise SystemExit(
                    "nothing under shadow evaluation and no --artifact "
                    "given — pass the artifact id whose paired records "
                    "to report"
                )
            pairs = _load_pairs(pairs_path(args.registry_dir, aid))
            status = read_status(args.registry_dir, aid)
            if args.json:
                print(
                    json.dumps(
                        {"artifact": aid, "status": status, "pairs": pairs}
                    )
                )
                return 0
            if not pairs and status is None:
                print(f"(no shadow evidence recorded for {aid})")
                return 1
            flips = sum(int(p.get("flip", 0)) for p in pairs)
            dsum = sum(
                abs(
                    float(p.get("serving_prob", 0.0))
                    - float(p.get("shadow_prob", 0.0))
                )
                for p in pairs
            )
            print(f"shadow report for {aid}:")
            print(
                f"  {len(pairs)} paired record(s), {flips} flip(s) "
                f"(rate {flips / len(pairs):.4f}), mean|dprob| "
                f"{dsum / len(pairs):.4f}"
                if pairs
                else "  (pairs JSONL empty; status snapshot only)"
            )
            if status is not None:
                print(
                    f"  status: pairs {status.get('pairs')}  psi "
                    + (
                        f"{status['psi']:.4f}"
                        if status.get("psi") is not None
                        else "n/a"
                    )
                    + f"  serving hist {status.get('hist_serving')}"
                    + f"  shadow hist {status.get('hist_shadow')}"
                )
            return 0
    except RegistryError as e:
        raise SystemExit(str(e)) from None
    raise SystemExit(f"unknown shadow action {args.action!r}")
