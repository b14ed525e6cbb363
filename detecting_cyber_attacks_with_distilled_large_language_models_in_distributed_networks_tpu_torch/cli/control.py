"""``registry``: the model registry's operator commands (the port of
``cmd_registry`` in the JAX package's ``cli/control.py``): ``list``,
``promote``, ``rollback`` and ``gc``. A registry root may be written by
both packages in turn."""

from __future__ import annotations

from ..registry import ModelRegistry, RegistryError


def cmd_registry(args) -> int:
    registry = ModelRegistry(args.registry_dir)
    try:
        if args.action == "list":
            serving = registry.serving_info()
            serving_id = serving["artifact"] if serving else None
            rows = registry.list()
            if not rows:
                print(f"(registry {args.registry_dir} is empty)")
                return 0
            for m in rows:
                metrics = m.get("metrics") or {}
                headline = ", ".join(
                    f"{k}={v:.4f}" for k, v in sorted(metrics.items()) if isinstance(v, float)
                )
                marker = " <- serving" if m["id"] == serving_id else ""
                print(f"{m['id']}  round={m.get('round')}  state={m.get('state')}  {headline}{marker}")
            return 0
        if args.action == "promote":
            if not args.artifact:
                raise SystemExit("registry promote needs --artifact <id>")
            m = registry.promote(args.artifact, to=args.to)
            print(f"{m['id']} -> {m['state']}")
            return 0
        if args.action == "rollback":
            m = registry.rollback()
            print(f"serving pointer -> {m['id']} (round {m.get('round')})")
            return 0
        if args.max_artifacts is None:  # gc
            raise SystemExit("registry gc needs --max-artifacts N")
        removed = registry.gc(max_artifacts=args.max_artifacts)
        for aid in removed:
            print(f"pruned {aid}")
        print(f"{len(removed)} artifact(s) pruned, {len(registry.list())} kept")
        return 0
    except RegistryError as e:
        raise SystemExit(str(e)) from None
