"""Command line of the port: ``python -m <package> <verb> ...``.

The verbs and flags mirror the JAX package's ``cli/parser.py``; the port
has ``local`` (single-client training) and ``infer-serve`` so far. Both
run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..models.presets import preset_names
from .local import cmd_local
from .serving import cmd_infer_serve


def _add_device(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help=f"where {what} (default cuda; there is no silent CPU fallback)",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fedtpu-torch",
        description="fedtpu on PyTorch + CUDA (the H100 port)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("local", help="single-client train/eval/report")
    p.add_argument(
        "--preset", default="tiny", help=f"{'|'.join(preset_names())}"
    )
    p.add_argument("--csv", help="CICIDS2017-style flow CSV path")
    p.add_argument("--synthetic", type=int, metavar="N", help="use N synthetic flows")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--epochs", type=int, help="epochs per round")
    p.add_argument("--learning-rate", type=float)
    p.add_argument(
        "--attention-impl",
        choices=["dot", "flash"],
        help="attention path: dot (plain PyTorch, default) or flash (the "
        "CUDA kernels: K1 forward, K2/K3 backward, dropout in-kernel)",
    )
    p.add_argument("--max-len", type=int)
    p.add_argument("--data-fraction", type=float)
    p.add_argument("--seed", type=int)
    p.add_argument("--client-id", type=int, default=0)
    _add_device(p, "training and evaluation run")
    p.set_defaults(fn=cmd_local)

    p = sub.add_parser(
        "infer-serve",
        help="online inference: dynamic-batching TCP scoring service",
        epilog="Requests are one frame each (serving/protocol.py): "
        '{"id": N, "text": "..."} or {"id": N, "features": {...}} with an '
        "optional per-request deadline_ms; replies carry P(attack) plus "
        "telemetry (model round, batch size, queue wait). A full queue or "
        "a blown deadline gets an explicit reject frame, never a hang.",
    )
    p.add_argument(
        "--registry-dir",
        required=True,
        help="serve the model registry's PROMOTED artifact (the serving "
        "pointer a JAX controller or `fedtpu registry promote` wrote)",
    )
    p.add_argument(
        "--preset",
        default="tiny",
        help=f"{'|'.join(preset_names())}; the artifact manifest's "
        "model_config wins when it has one",
    )
    p.add_argument(
        "--attention-impl",
        choices=["dot", "flash"],
        help="attention path: dot (plain PyTorch) or flash (the CUDA "
        "kernel); the artifact manifest's model_config wins",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=12380)
    p.add_argument(
        "--buckets",
        default="1,8,32,128",
        help="micro-batch bucket shapes (default 1,8,32,128)",
    )
    p.add_argument(
        "--max-wait-ms",
        type=float,
        default=5.0,
        help="batch gather window after the first queued request (default 5)",
    )
    p.add_argument(
        "--max-queue",
        type=int,
        default=1024,
        help="admission-control queue bound; a submit beyond it is "
        "rejected immediately with a 503-style frame (default 1024)",
    )
    p.add_argument(
        "--default-deadline-ms",
        type=float,
        default=None,
        help="deadline applied to requests that name none (default: wait "
        "forever); expired requests get an explicit reject frame",
    )
    p.add_argument(
        "--threshold",
        type=float,
        default=0.5,
        help="P(attack) decision threshold in replies (default 0.5)",
    )
    _add_device(p, "the model runs")
    p.set_defaults(fn=cmd_infer_serve)
    return ap


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    return args.fn(args)
