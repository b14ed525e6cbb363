"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic, limits
and metrics are found by name (``portbench/pbcore/bench.py``); the
traffic's ``mode`` picks the driver under ``portbench/drivers/``. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with the
reference beside its limit, which also close standard error.

Exit codes: 0 a result was printed (correct or not); 2 bad arguments;
3 no CUDA device, or fewer than the cell asks for; 4 a JAX module was
loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

T_IMPORT = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (from
    ``/proc``; this module's import time where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        started = ticks / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def cache_environment(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(root, "build", "portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"


def result_line(cell, outcome, trace: bool, device: dict) -> dict:
    """The run's result, with ``checks`` last."""
    if trace:
        from pbcore.bench import reader

        metrics = {}
        for m in cell.per_layer:
            value = reader(m.name, cell.bench).read(outcome.timeline)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        metrics = {m.name: {"value": outcome.metrics[m.name], "unit": m.unit} for m in cell.end_to_end}
    out = {
        "correct": outcome.correct,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device,
    }
    if trace and outcome.timeline is not None:
        tl = outcome.timeline
        out["breakdown"] = {"device_ops": tl.top_ops(10), "idle_gaps": tl.idle_gaps(10)}
    out["checks"] = {c.name: {"value": _num(c.value), "limit": c.limit} for c in outcome.checks}
    return out


def _num(x: float):
    return x if math.isfinite(x) else str(x)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float, root: str = ROOT):
    """Drive one cell on ``device``; returns (cell, outcome). Looks for no
    card: ``main`` does that."""
    from pbcore.bench import driver, load_cell
    from pbcore.harness import Run
    from pbcore.tracing import Tracer

    if root not in sys.path:
        sys.path.insert(0, root)
    cell = load_cell(name, root)
    run = Run(cell=cell, seed=seed, seconds=seconds, tracer=Tracer(trace), device=device, t_start=t_start)
    run.mark("torch")
    outcome = driver(cell).run(run)
    outcome.marks = run.marks
    return cell, outcome


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_environment(ROOT)

    from pbcore.bench import forbidden_loaded, load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)  # the CUDA context, so the set-up stages after it are the cell's own
    cell, outcome = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), dev, t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(dev),
        "count": cell.chips,
        "memory_peak_bytes": outcome.memory_peak_bytes,
    }
    if args.trace:
        device["busy_s"] = outcome.timeline.busy_s
        device["window_s"] = outcome.timeline.window_s
    line = result_line(cell, outcome, bool(args.trace), device)
    print("setup " + " ".join(f"{stage}={t:.3f}" for stage, t in outcome.marks), file=sys.stderr)
    notes = dict(outcome.notes)
    if args.trace:
        tl = outcome.timeline
        notes.update(traced_steps=tl.extra.get("traced_steps"), device_s_by_category=tl.categories())
    print("notes " + json.dumps(notes), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
