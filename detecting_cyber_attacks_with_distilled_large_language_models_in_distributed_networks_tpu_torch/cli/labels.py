"""``labels``: the delayed ground-truth plane's operator surface (the port
of the JAX package's ``cli/labels.py``; the journal and the join are the
JAX package's, so either package reads what the other wrote).

``ingest`` appends labeler verdicts (a JSONL file of
``{"rid", "label", "ts"}`` records, or one ``--rid/--label`` pair) into
the registry's append-only journal and optionally advances the
completeness watermark. ``status`` replays the journal into its
projection counters (labels, duplicates, conflicts, late arrivals,
watermark). ``report`` runs the deterministic join of scored-request
records — a shadow candidate's mirror pairs, or a serving tier's
scored-JSONL — against the journal and prints the supervised verdicts
the label gate rules on, inspectable after the fact exactly like a
registry event.
"""

from __future__ import annotations

import json


def _journal(args) -> str:
    from ..labels import journal_path

    return getattr(args, "journal", None) or journal_path(args.registry_dir)


def _iter_ingest_records(path: str):
    """JSONL label records from a labeler export; non-dict and foreign
    lines are skipped (counted for the operator)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                yield None
                continue
            yield rec if isinstance(rec, dict) else None


def cmd_labels(args) -> int:
    from ..labels import LabelStore

    if args.action == "ingest":
        store = LabelStore(_journal(args))
        store.load()
        applied = skipped = 0
        if getattr(args, "rid", None) is not None:
            if getattr(args, "label", None) is None:
                raise SystemExit("labels ingest --rid needs --label")
            store.ingest(
                args.rid,
                int(args.label),
                ts=float(getattr(args, "ts", None) or 0.0),
            )
            applied += 1
        elif getattr(args, "file", None):
            default_ts = getattr(args, "ts", None)
            try:
                records = list(_iter_ingest_records(args.file))
            except OSError as e:
                raise SystemExit(f"cannot read {args.file}: {e}") from None
            for rec in records:
                if rec is None or "rid" not in rec or "label" not in rec:
                    skipped += 1
                    continue
                ts = rec.get("ts", default_ts)
                store.ingest(
                    str(rec["rid"]),
                    int(rec["label"]),
                    ts=float(ts) if ts is not None else 0.0,
                )
                applied += 1
        elif getattr(args, "watermark", None) is None:
            raise SystemExit(
                "labels ingest needs --file, --rid/--label, or --watermark"
            )
        if getattr(args, "watermark", None) is not None:
            store.advance_watermark(float(args.watermark))
        s = store.status()
        if args.json:
            print(json.dumps({**s, "applied": applied, "skipped": skipped}))
            return 0
        print(
            f"ingested {applied} record(s)"
            + (f", skipped {skipped} malformed" if skipped else "")
            + f"; journal now holds {s['labels']} label(s) "
            f"(conflicts {s['conflicts']}, late {s['late']}, watermark "
            + (
                f"{s['watermark']:.3f}"
                if s["watermark"] is not None
                else "unset"
            )
            + ")"
        )
        return 0

    if args.action == "status":
        store = LabelStore(_journal(args))
        store.load()
        s = store.status()
        if args.json:
            print(json.dumps(s))
            return 0
        print(f"journal: {s['path']}")
        print(
            f"labels {s['labels']}  duplicates {s['duplicates']}  "
            f"conflicts {s['conflicts']}  late {s['late']}  watermark "
            + (
                f"{s['watermark']:.3f}"
                if s["watermark"] is not None
                else "unset"
            )
        )
        return 0

    if args.action == "report":
        from ..labels import LabelGate, join_records
        from ..registry import ModelRegistry, RegistryError

        if getattr(args, "scored", None):
            # Serving-tier scored-JSONL: one model, "prob" field.
            store = LabelStore(_journal(args))
            store.load()
            records = [
                r
                for r in _iter_ingest_records(args.scored)
                if r is not None and r.get("schema") == "fedtpu-scored-v1"
            ]
            report = join_records(
                records,
                store.labels_map(),
                threshold=args.threshold,
                sides={"serving": "prob"},
            )
            report["watermark"] = store.watermark
        else:
            registry = ModelRegistry(args.registry_dir)
            aid = getattr(args, "artifact", None)
            if not aid:
                try:
                    info = registry.shadow_info()
                except RegistryError as e:
                    raise SystemExit(str(e)) from None
                aid = info.get("artifact") if info else None
            if aid is None:
                raise SystemExit(
                    "nothing under shadow evaluation and no --artifact "
                    "or --scored given — name the evidence to join"
                )
            gate = LabelGate(
                args.registry_dir,
                journal=getattr(args, "journal", None),
                threshold=args.threshold,
            )
            report = gate.join(aid)
            report["artifact"] = aid
        if args.json:
            print(json.dumps(report))
            return 0
        if report.get("artifact"):
            print(f"label join for {report['artifact']}:")
        print(
            f"  {report['joined']}/{report['total']} scored record(s) "
            f"joined (coverage {report['coverage']:.4f}, watermark "
            + (
                f"{report['watermark']:.3f}"
                if report.get("watermark") is not None
                else "unset"
            )
            + ")"
        )
        for name, v in report.get("models", {}).items():
            if not v.get("n"):
                print(f"  {name}: no joined evidence")
                continue
            print(
                f"  {name}: n={v['n']} accuracy="
                + (
                    f"{v['accuracy']:.4f}"
                    if v["accuracy"] is not None
                    else "n/a"
                )
                + " fpr="
                + (f"{v['fpr']:.4f}" if v["fpr"] is not None else "n/a")
                + " fnr="
                + (f"{v['fnr']:.4f}" if v["fnr"] is not None else "n/a")
                + f" per_class={v['per_class']}"
            )
        return 0

    raise SystemExit(f"unknown labels action {args.action!r}")
