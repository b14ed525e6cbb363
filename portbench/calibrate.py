"""Readings that the limits of ``correct`` are set from (on the card).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 10]

(every control seed is one of ``--seeds``).

For each seed, the numbers a run of the cell compares, of:

* ``program``: the program against the plain reference (the lower
  readings: every limit lies above the largest of them);
* ``control``: the reference computed with float8 products put in the
  program's place (the control; a limit lies below the smallest);
* ``half_batch`` (training cells): the reference with the loss over half
  of each batch put in the program's place (a fault); ``unchanged`` a
  state the steps left as it was (a fault);
* ``wrong_rows`` (scoring cells): each row answered with its
  neighbour's reference answer (a fault).

Training needs no window: the checked steps are set-up's. A scoring cell
scores back to back for ``--seconds`` at the cell's own load, as a run
does, and compares every answer. One JSON line per reading, then the
largest program reading and the smallest control and fault readings of
each number. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from pbcore.bench import ROOT, driver, load_cell
from pbcore.harness import Run, free
from pbcore.tracing import Tracer
from reference import compare
from reference import model as ref_model

FP8 = ref_model.Precision("fp8")


def train_readings(drv, run: Run, control: bool) -> list[dict]:
    trainer, state, feed, prog, rows, _ = drv.build(run)
    del trainer, state, feed
    free(run.device)
    ref = drv.reference(run, rows)
    out = [{"kind": "program", **compare.train_gaps(prog, ref)}]
    if control:
        out.append({"kind": "control", **compare.train_gaps(drv.reference(run, rows, FP8), ref)})
        out.append({"kind": "half_batch", **compare.train_gaps(drv.reference(run, rows, half_batch=True), ref)})
        still = ref_model.TrainReadings(prog.losses, {n: 0.0 for n in ref.grad_norms}, {n: 0.0 for n in ref.change_norms})
        out.append({"kind": "unchanged", **compare.train_gaps(still, ref)})
    return out


def score_readings(drv, run: Run, control: bool) -> list[dict]:
    t = run.cell.traffic
    engine, ids, mask = drv.build(run)
    cycle = drv.Cycle(ids, mask, t["bucket"])
    for _ in range(t["warm_calls"]):
        engine.score(*cycle.next()[1:])
    answers: list = []
    drv.window(run, engine, cycle, run.seconds, answers, [])
    del engine
    free(run.device)
    ref = drv.reference_probs(run, ids, mask)
    gaps, short = drv.answer_gaps(answers, ref, t["bucket"])
    out = [{"kind": "program", **gaps, "calls": len(answers), "short": short}]
    if control:
        ctl = drv.reference_probs(run, ids, mask, FP8)
        out.append({"kind": "control", "prob_gap": compare.prob_gap(ctl, ref),
                    "prob_decorrelation": compare.decorrelation(ctl[:, 1], ref[:, 1])})
        wrong = np.roll(ref, 1, axis=0)  # each row answered with its neighbour's answer
        out.append({"kind": "wrong_rows", "prob_gap": compare.prob_gap(wrong, ref),
                    "prob_decorrelation": compare.decorrelation(wrong[:, 1], ref[:, 1])})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    drv = driver(cell)
    readings = train_readings if cell.traffic["mode"] == "train" else score_readings
    rows = []
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    plan = [(int(s), int(s) in controls) for s in args.seeds.split(",") if s]
    for seed, control in plan:
        t0 = time.perf_counter()
        run = Run(cell=cell, seed=seed, seconds=args.seconds, tracer=Tracer(False), device=dev, t_start=t0)
        for r in readings(drv, run, control):
            r.update(workload=cell.name, seed=seed, s=round(time.perf_counter() - t0, 2))
            rows.append(r)
            print(json.dumps(r), flush=True)
        free(dev)
    numbers = [k for k in rows[0] if k.endswith("_gap") or k == "prob_decorrelation"]
    summary = {"workload": cell.name, "card": torch.cuda.get_device_name(dev)}
    for kind in ("program", "control", "half_batch", "unchanged", "wrong_rows"):
        got = [r for r in rows if r["kind"] == kind]
        if got:
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(r[k] for r in got) for k in numbers} | {"seeds": len(got)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
