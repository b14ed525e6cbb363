"""Command line of the port: ``python -m <package> <verb> ...``.

The verbs and flags mirror the JAX package's ``cli/parser.py``; the port
has ``local`` (single-client training), ``federated`` (N clients in one
process), ``serve``, ``relay`` and ``client`` (a federated round over
TCP, secure or through a fold tree of relays), ``scenario`` (the fault
harness's persona x partition matrix), ``controller`` (the unattended round -> gate -> promote loop),
``distill`` (teacher -> student), ``predict`` (batch inference),
``infer-serve`` (online scoring with hot reload), ``route`` and
``fleet`` (the replica tier: a router over scorers, rolling reload on
promotion, the shadow mirror), ``shadow`` and ``labels`` (the shadow
plane's and the delayed ground truth's operator commands), ``export-hf``
(weights to the HF layout), ``export-config`` (the resolved config as
JSON), ``registry`` (the model registry's operator commands), ``obs``
(timelines, Chrome export, span tailing, fleet health, the sentinel,
postmortems and the device profile) and ``check`` (the static-analysis
passes over the repository, a host verb): all 19 of the JAX package's
verbs. Each that computes runs on the card unless ``--device cpu`` is
given. The obs flags
(``--trace-jsonl``, ``--metrics-jsonl``, ``--profile-dir``,
``--profile-stride``, ``--metrics-port``, ``--flight-dir``,
``--trace-sample``, ``--scored-jsonl``) are the JAX package's, on the
same verbs, and so are the mesh flags (``federated --data-parallel
--seq-parallel --coordinator --num-processes --process-id``, ``client
--data-parallel --seq-parallel --fsdp``, ``infer-serve --data-parallel
--fsdp``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from ..data.datasets import DATASETS
from ..models.presets import preset_names
from .check import cmd_check
from .comm import cmd_client, cmd_relay, cmd_serve
from .common import resolve_config
from .control import cmd_controller, cmd_registry
from .distill import cmd_distill
from .federated import cmd_federated
from .local import cmd_local
from .obs import cmd_obs
from .labels import cmd_labels
from .predict import cmd_export_hf, cmd_predict
from .router import cmd_fleet, cmd_route
from .scenario import cmd_scenario
from .serving import cmd_infer_serve
from .shadow import cmd_shadow


def _wire_compression(spec: str) -> str:
    """argparse type of the client's --compression: none|bf16|int8|topk[:frac]."""
    from ..comm import wire

    try:
        wire.parse_compression(spec)
    except wire.WireError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return spec


def _reply_compression(spec: str) -> str:
    """argparse type of the server's --compression: as the client's, but
    topk is refused (the reply is an absolute aggregate)."""
    spec = _wire_compression(spec)
    if spec.startswith("topk"):
        raise argparse.ArgumentTypeError(
            "topk is an upload-side (sparse round-delta) compression; "
            "the reply is an absolute aggregate — use none/bf16/int8"
        )
    return spec


def cmd_export_config(args) -> int:
    """Print the resolved config (defaults <- --config <- flags) as JSON."""
    from ..data.tokenizer import default_tokenizer

    cfg = resolve_config(args, vocab_size=len(default_tokenizer().vocab))
    json.dump(cfg.to_dict(), sys.stdout, indent=2)
    sys.stdout.write("\n")
    return 0


def _add_flight_dir(p: argparse.ArgumentParser) -> None:
    """The daemons' failure-flight-recorder flag (serve | infer-serve)."""
    p.add_argument(
        "--flight-dir",
        default=None,
        help="arm the failure flight recorder (obs/flight.py): keep a "
        "bounded in-memory ring of recent spans and dump a postmortem "
        "bundle (ring + config + /metrics snapshot) to this directory "
        "on round failure or scoring-dispatch failure. Inspect with "
        "`obs postmortem`",
    )


def _add_metrics_port(p: argparse.ArgumentParser, help: str) -> None:
    p.add_argument("--metrics-port", type=int, default=0, help=help)


def _add_obs(p: argparse.ArgumentParser) -> None:
    """The JAX package's per-verb obs flags (its ``_add_common``)."""
    p.add_argument(
        "--profile-dir",
        help="write a torch.profiler Chrome trace of the training phase "
        "here (CPU and CUDA activity; open it in ui.perfetto.dev)",
    )
    p.add_argument(
        "--metrics-jsonl",
        help="append one structured JSON record per (round, client, phase) "
        "here — machine-readable observability the reference's prints/CSVs "
        "lack",
    )
    p.add_argument(
        "--trace-jsonl",
        help="append obs spans (round/client-local/wire/agg/... with the "
        "round's shared trace id) to this events-JSONL; give every "
        "process its own file and merge with `obs timeline "
        "--trace-dir DIR`",
    )
    p.add_argument(
        "--profile-stride",
        type=int,
        default=None,
        help="device performance plane (obs/profile.py): fence every Nth "
        "train/score step into host/dispatch/device-execute timers "
        "(fedtpu_*_step_seconds on /metrics + step attrs on the "
        "client-local span). 0/absent = off — the hot loops run the "
        "literal unprofiled path",
    )


def _add_device(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help=f"where {what} (default cuda; there is no silent CPU fallback)",
    )


def _add_dataset(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--dataset",
        choices=sorted(DATASETS),
        help="registered dataset schema: its text template and label "
        "semantics (default cicids2017)",
    )


def _add_model_source(p: argparse.ArgumentParser) -> None:
    """Where the config and the initial weights come from, and the model
    knobs the JAX package's ``_add_common`` gives every such verb."""
    p.add_argument("--config", help="JSON config file (ExperimentConfig.to_dict shape)")
    p.add_argument(
        "--gelu",
        choices=["exact", "tanh"],
        help="FFN activation: tanh (the preset default, within a few bf16 "
        "ulps of erf) or exact (HF's erf form, fp32 parity)",
    )
    p.add_argument(
        "--hf-dir",
        help="HF DistilBERT checkpoint dir (config.json + vocab.txt + "
        "model.safetensors|pytorch_model.bin) — the reference's required "
        "./distilbert-base-uncased; pretrained encoder + fresh head",
    )
    p.add_argument(
        "--pth",
        help="a reference-run .pth state dict (its DDoSClassifier / "
        "aggregated model) as the weights, with --hf-dir supplying "
        "tokenizer + architecture — direct migration of a model the "
        "reference trained",
    )
    p.add_argument(
        "--warmup-steps",
        type=int,
        help="linear LR warmup steps (global step count; 0 = constant)",
    )
    p.add_argument(
        "--attention-dropout",
        type=float,
        help="attention-weight dropout rate (default from the preset/config)",
    )
    p.add_argument(
        "--remat",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="recompute each transformer block's activations in the "
        "backward (trade FLOPs for activation memory); --no-remat "
        "overrides a config file's remat=true",
    )


def _add_training(p: argparse.ArgumentParser, *, device: bool = True) -> None:
    """The data, model and training flags ``local``, ``client``,
    ``federated``, ``distill``, ``predict`` and the export verbs share
    (``export-config`` computes nothing, so it takes no ``--device``)."""
    p.add_argument(
        "--preset", default="tiny", help=f"{'|'.join(preset_names())}"
    )
    _add_model_source(p)
    p.add_argument("--csv", help="flow CSV path (schema set by --dataset)")
    _add_dataset(p)
    p.add_argument(
        "--source",
        action="append",
        metavar="[DATASET=]PATH",
        help="mixed-corpus CSV source (repeatable, exclusive with --csv); "
        "the dataset is --dataset's, else detected from the schema, when "
        "the entry names none",
    )
    p.add_argument("--synthetic", type=int, metavar="N", help="use N synthetic flows of --dataset's schema")
    p.add_argument(
        "--stream",
        action="store_true",
        help="two-pass chunked CSV reader (corpora larger than RAM); "
        "index-based sampling semantics",
    )
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
    _add_obs(p)
    if device:
        _add_device(p, "training and evaluation run")


def _add_obs_verb(sub) -> None:
    """``obs``: the JAX package's timeline | export | tail | postmortem |
    profile actions, with their flags and defaults."""
    p = sub.add_parser(
        "obs",
        help="observability: round timelines, Chrome export, live span "
        "tailing, postmortem bundles, device profiling",
        epilog="Every tier writes spans with --trace-jsonl; the server "
        "stamps one trace id per round into its replies, so the merged "
        "files agree on (trace, round), whichever package wrote them. "
        "`timeline` attributes each round's wall-clock to per-client "
        "compute / straggler wait / wire / agg; `export` writes "
        "chrome://tracing JSON; `tail` follows the files live; "
        "`postmortem` lists/inspects the flight recorder's bundles "
        "(--flight-dir). `profile` runs the device performance plane "
        "(obs/profile.py) end to end on real train steps on the card: "
        "the dispatch ledger by site, recompile flags, the fenced "
        "host/dispatch/device step split, memory watermarks, the "
        "analytic-vs-counted FLOPs cross-check, and the bucketed serving "
        "path's zero-new-shape storm (--capture DIR wraps torch.profiler "
        "around the profiled steps).",
    )
    p.add_argument(
        "action",
        choices=[
            "timeline", "export", "tail", "health", "watch", "postmortem",
            "profile", "sentinel",
        ],
    )
    p.add_argument(
        "--trace-dir",
        help="directory of span JSONLs (every *.jsonl is merged; tail "
        "also picks up files that appear later)",
    )
    p.add_argument(
        "--trace",
        action="append",
        metavar="FILE",
        help="individual span JSONL (repeatable; composes with --trace-dir)",
    )
    p.add_argument("--round", type=int, default=None, help="only this round (timeline/tail)")
    p.add_argument("--trace-id", default=None, help="tail: only spans carrying this trace id")
    p.add_argument(
        "--from-start",
        action="store_true",
        help="tail: replay existing spans before following (default: "
        "start at each file's end, new spans only)",
    )
    p.add_argument(
        "--poll", type=float, default=0.5, help="tail: seconds between file polls (default 0.5)"
    )
    p.add_argument(
        "--max-seconds",
        type=float,
        default=None,
        help="tail: stop after this many seconds (default: follow until "
        "interrupted)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable JSON instead of the rendered output "
        "(timeline/health/postmortem/profile; sentinel: one tick)",
    )
    p.add_argument("--out", help="output path (export)")
    p.add_argument(
        "--target",
        action="append",
        metavar="TIER=HOST:PORT[,events=PATH]",
        help="health/watch: a daemon's /metrics.json endpoint to scrape "
        "(repeatable; TIER in serve|relay|controller|infer-serve|route|"
        "fleet names the lane; events=PATH additionally tails that "
        "process's span JSONL for drift/postmortem state)",
    )
    p.add_argument(
        "--slo",
        help="health/watch: JSON file of SLO objects (obs/slo.py SLO "
        "fields) replacing the built-in fleet objectives",
    )
    p.add_argument(
        "--alerts-jsonl",
        help="health/watch: append burn-alert fire/clear events here "
        "(one atomic JSON line each)",
    )
    p.add_argument(
        "--snapshot-jsonl",
        help="health/watch: append one merged fleet snapshot record "
        "per poll here, keyed by (tier, instance)",
    )
    p.add_argument(
        "--snapshot-max-mb",
        type=float,
        default=None,
        help="health/watch/sentinel: bound the snapshot JSONL — past "
        "this size the live file atomically rolls to <path>.1 and a "
        "fresh generation starts (at most ~2x the cap on disk; "
        "default: unbounded, the pre-existing behavior)",
    )
    p.add_argument(
        "--watch",
        action="store_true",
        help="health: live-refresh loop instead of one pass (same as "
        "the watch action)",
    )
    p.add_argument(
        "--interval",
        type=float,
        default=None,
        help="watch: seconds between scrape passes; health: spacing of "
        "the one-shot pass's two polls — burn rates and cadence are "
        "counter DELTAS, so one scrape has no baseline (default 2)",
    )
    p.add_argument(
        "--scrape-timeout",
        type=float,
        default=None,
        help="health/watch: per-target scrape timeout seconds "
        "(default 2); a slower daemon is marked DOWN, never blocks "
        "the screen",
    )
    p.add_argument(
        "--trace-jsonl",
        help="health/watch: append the hub's own slo-eval spans here",
    )
    p.add_argument(
        "--flight-dir",
        help="postmortem: the flight-recorder bundle directory the "
        "daemons were started with (--flight-dir on serve/controller/"
        "infer-serve); health/watch/sentinel: ALSO arm the hub's own "
        "recorder there, so a page-severity SLO fire dumps a postmortem "
        "bundle (the hub is the process that evaluates SLOs — daemon "
        "recorders never learn of a page)",
    )
    p.add_argument(
        "--bundle",
        help="postmortem: inspect this bundle (name from the list, or "
        "a path) instead of listing",
    )
    p.add_argument(
        "--alert-cmd",
        help="health/watch: run this shell command once per page-"
        "severity SLO fire, with the alert event JSON on stdin (the "
        "notification fan-out next to --alerts-jsonl); rate-limited to "
        "one spawn per --alert-interval, OSError-guarded — a broken "
        "pager never kills the poll loop",
    )
    p.add_argument(
        "--alert-interval",
        type=float,
        default=None,
        help="health/watch: minimum seconds between --alert-cmd spawns "
        "(default 30)",
    )
    p.add_argument(
        "--preset",
        default="tiny",
        help="profile: model preset to profile "
        f"({'|'.join(preset_names())}; default tiny)",
    )
    p.add_argument(
        "--steps", type=int, default=12, help="profile: profiled train steps after warmup (default 12)"
    )
    p.add_argument("--batch-size", type=int, default=8, help="profile: train batch size (default 8)")
    p.add_argument(
        "--stride",
        type=int,
        default=1,
        help="profile: sample every Nth step (default 1 — every step "
        "fenced; production daemons use --profile-stride instead)",
    )
    p.add_argument(
        "--capture",
        metavar="DIR",
        help="profile: additionally wrap torch.profiler around the "
        "profiled steps and write a Chrome trace here",
    )
    p.add_argument(
        "--canaries",
        help="sentinel: canary-flows JSONL fixture (fedtpu-canary-v1 "
        "lines: id, preset, label, text) scored through the live "
        "serving chain every tick",
    )
    p.add_argument(
        "--canary-preset",
        default=None,
        help="sentinel: only this preset's canaries from --canaries "
        "(default: all)",
    )
    p.add_argument(
        "--serve",
        metavar="HOST:PORT",
        help="sentinel: the scoring endpoint (router or replica) the "
        "canary probes dial",
    )
    p.add_argument(
        "--registry-dir",
        help="sentinel: model registry root — canary replies must match "
        "its promoted serving pointer (round + artifact identity)",
    )
    p.add_argument(
        "--scored-jsonl",
        help="sentinel: the serving tier's scored-request export "
        "(fedtpu-scored-v1) to tail for the supervised-drift join",
    )
    p.add_argument(
        "--labels-journal",
        help="sentinel: the ground-truth labels journal "
        "(fedtpu-label-v1) to tail against --scored-jsonl",
    )
    p.add_argument(
        "--reference-error",
        type=float,
        default=None,
        help="sentinel: the promoted model's reference error rate the "
        "continuous supervised monitor compares against (required with "
        "--scored-jsonl/--labels-journal)",
    )
    p.add_argument(
        "--error-margin",
        type=float,
        default=None,
        help="sentinel: supervised error margin over the reference "
        "before a drift verdict fires (default 0.05)",
    )
    p.add_argument(
        "--error-min-joined",
        type=int,
        default=None,
        help="sentinel: joined flows required before a supervised "
        "verdict may fire (default 64)",
    )
    p.add_argument(
        "--verdicts-jsonl",
        help="sentinel: append fired supervised-drift verdicts here — "
        "the file the controller's --sentinel-jsonl tails for its "
        "corrective-round poke",
    )
    p.add_argument(
        "--ring-jsonl",
        help="sentinel: the long-horizon retention ring's on-disk path "
        "(downsampled per-tick rows; survives sentinel restarts)",
    )
    p.add_argument(
        "--ring-records",
        type=int,
        default=None,
        help="sentinel: ring rows retained (default 512)",
    )
    p.add_argument(
        "--ring-stride",
        type=int,
        default=None,
        help="sentinel: retain every Nth tick in the ring (default 1)",
    )
    p.add_argument(
        "--baseline-n",
        type=int,
        default=None,
        help="sentinel: ring rows pinned as the regression baseline "
        "window (the first N retained; default 8)",
    )
    p.add_argument(
        "--window-n",
        type=int,
        default=None,
        help="sentinel: current-window rows a trend check averages "
        "(default 8)",
    )
    p.add_argument(
        "--regression-ratio",
        type=float,
        default=None,
        help="sentinel: fire when a watched field's current-window mean "
        "moves past baseline * ratio (default 1.5; round cadence fires "
        "on the inverse drop)",
    )
    p.add_argument(
        "--trend-field",
        action="append",
        default=None,
        metavar="NAME[:direction]",
        help="sentinel: ALSO run the retention-ring trend check on this "
        "per-deployment field (repeatable). The value is read from the "
        "scraped targets' metric snapshots (max across targets, like "
        "eject rate); direction up (default) fires on a rise past "
        "baseline * ratio, down on the inverse drop. --regression-ratio "
        "applies to these too",
    )
    _add_device(p, "the profiled steps run")
    p.set_defaults(fn=cmd_obs)


def _add_check_verb(sub) -> None:
    """``check``: the JAX package's static-analysis verb, with its flags,
    help and epilog. A host verb: it scans source files and takes no
    ``--device``."""
    p = sub.add_parser(
        "check",
        help="invariant-aware static analysis: wire-domain, determinism, "
        "concurrency, and obs-vocabulary passes over the tree",
        epilog="Findings are suppressed only by a reviewed per-line "
        "`# fedtpu: allow(<rule>): reason` pragma or an entry (with "
        "reason) in the repo-root ANALYSIS_BASELINE.json. Exit 0 = "
        "clean, 1 = non-baselined findings, 2 = usage/internal error.",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable result object instead of the finding list",
    )
    p.add_argument(
        "--baseline",
        help="baseline JSON path (default: ANALYSIS_BASELINE.json at the "
        "scanned root, when present)",
    )
    p.add_argument(
        "--root",
        help="tree to scan (default: this checkout's repo root) — the "
        "seeded-mutation self-tests point this at a temp copy",
    )
    p.add_argument(
        "--rules",
        help="comma-separated subset of rule names (default: all; see "
        "--list-rules)",
    )
    p.add_argument(
        "--list-rules",
        action="store_true",
        help="print the registered rules and exit",
    )
    p.add_argument(
        "--prune-baseline",
        action="store_true",
        help="rewrite the baseline file minus STALE entries (findings "
        "that no longer fire) — the remediation path for the "
        "reported-not-failed stale list; live entries and the review "
        "comment survive untouched",
    )
    p.set_defaults(fn=cmd_check)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fedtpu-torch",
        description="fedtpu on PyTorch + CUDA (the H100 port)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("local", help="single-client train/eval/report")
    _add_training(p)
    p.add_argument("--client-id", type=int, default=0)
    p.add_argument("--checkpoint-dir", help="save the trained state here (step = its global step)")
    p.set_defaults(fn=cmd_local)

    p = sub.add_parser(
        "federated",
        help="N clients in one process: lockstep local epochs + FedAvg, multi-round",
        epilog="Writes client{N}_local_metrics.csv and "
        "client{N}_aggregated_metrics.csv per client (and "
        "partition_manifest.json for the non-IID partitions).",
    )
    _add_training(p)
    p.add_argument("--num-clients", type=int, default=None, help="clients in the fleet (default 2)")
    p.add_argument("--rounds", type=int)
    p.add_argument("--data-parallel", type=int, help="per-client data-parallel shards")
    p.add_argument(
        "--seq-parallel",
        type=int,
        help="sequence-parallel shards per client (ring attention over a "
        "third 'seq' mesh axis; model.max_len must divide by it)",
    )
    g = p.add_mutually_exclusive_group()
    g.add_argument(
        "--weighted", action="store_true",
        help="require sample-count FedAvg weights (the default already "
        "weights by sample count)",
    )
    g.add_argument(
        "--unweighted", action="store_true",
        help="force the uniform mean (the reference's server.py:73-76)",
    )
    p.add_argument("--partition", choices=["sample", "disjoint", "dirichlet", "quantity"])
    p.add_argument(
        "--dirichlet-alpha", type=float,
        help="skew concentration for --partition dirichlet (label skew) or "
        "quantity (size skew); smaller = more non-IID (default 0.5)",
    )
    p.add_argument("--prox-mu", type=float, help="FedProx proximal weight (0 = plain FedAvg)")
    p.add_argument(
        "--personalize-epochs",
        type=int,
        help="after the final round, fine-tune the aggregate on each "
        "client's own shard for this many epochs and report a third "
        "'personalized' evaluation phase (0 = off)",
    )
    p.add_argument(
        "--personalize-scope",
        choices=["full", "head"],
        help="personalization scope: 'full' fine-tunes everything "
        "(FedAvg+FT); 'head' freezes the shared encoder and adapts only "
        "the classifier head (FedPer)",
    )
    p.add_argument(
        "--participation", type=float,
        help="fraction of clients aggregated per round (sampled, seeded); "
        "1.0 = everyone (reference behavior)",
    )
    p.add_argument(
        "--participation-mode", choices=["auto", "fixed", "poisson"],
        help="cohort sampler under --participation < 1: 'fixed' draws an "
        "exact-size cohort; 'poisson' draws each client independently "
        "(the DP accountant's assumption, making epsilon exact); 'auto' "
        "(default) = poisson when DP is on",
    )
    p.add_argument(
        "--dp-clip",
        type=float,
        help="DP-FedAvg: clip each client's round update to this L2 norm "
        "before aggregation (0 = off)",
    )
    p.add_argument(
        "--dp-noise-multiplier",
        type=float,
        help="DP-FedAvg: Gaussian noise multiplier on the clipped mean "
        "update (std = multiplier * clip / n_participants); requires "
        "--dp-clip",
    )
    p.add_argument(
        "--server-opt", choices=["none", "momentum", "adam", "yogi"],
        help="FedOpt server optimizer over the round's mean update: "
        "momentum = FedAvgM, adam = FedAdam, yogi = FedYogi (default none)",
    )
    p.add_argument("--server-lr", type=float, help="server optimizer learning rate (default 1.0)")
    p.add_argument("--server-momentum", type=float, help="FedAvgM momentum (default 0.9)")
    p.add_argument(
        "--checkpoint-dir",
        help="save every round's state here (step = round) and resume from "
        "the latest finished round",
    )
    p.add_argument(
        "--registry-dir",
        help="also publish every round's aggregate to this model registry "
        "as a candidate artifact (fleet-mean validation metrics attached)",
    )
    p.add_argument(
        "--coordinator",
        help="multi-host: coordinator HOST:PORT (every process passes the "
        "same address; also via JAX_COORDINATOR_ADDRESS)",
    )
    p.add_argument("--num-processes", type=int, help="multi-host: process count")
    p.add_argument("--process-id", type=int, help="multi-host: this process's id")
    p.set_defaults(fn=cmd_federated)

    p = sub.add_parser(
        "serve",
        help="TCP aggregation server: dense or streamed FedAvg rounds, folded on the card",
        epilog="Clients upload single FTPW frames (round 1) or leaf-by-leaf "
        "streams (once a reply offered them) and get the aggregate back on the "
        "same connection; a JAX client interoperates. The fold runs on the card "
        "(the hand-written K4 kernel) unless --device cpu. Set FEDTPU_SECRET "
        "(env var, same value on the server and every client) to require "
        "HMAC-SHA256-authenticated, replay-protected exchanges.",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=12345)
    p.add_argument("--num-clients", type=int, default=2)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--min-clients", type=int, default=None)
    p.add_argument("--weighted", action="store_true", help="weight the mean by n_samples")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument(
        "--compression",
        default="none",
        type=_reply_compression,
        help="reply encoding: none|bf16|int8 (topk is upload-side only)",
    )
    p.add_argument(
        "--reply-dtype",
        choices=["fp32", "bf16", "int8"],
        default="fp32",
        help="wire dtype of the STREAMED reply, for the clients that advertise "
        "it (everyone else, and dense replies, stay fp32); a lossy dtype is "
        "refused with --compression",
    )
    p.add_argument(
        "--stream-chunk-mb",
        type=float,
        default=None,
        help="offer chunk-streamed uploads at this chunk size (MB, default 4): "
        "clients stream leaf by leaf from their next upload on and the server "
        "folds each leaf as every client's copy arrives, bit-exact with the "
        "barrier mean. 0 turns the offer and the early folds off",
    )
    p.add_argument(
        "--strategy",
        default=None,
        help="server strategy applied to the folded mean, NAME[:k=v,...]: "
        "fedavg (default), fedprox[:mu=0.01] (advertises mu to the clients), "
        "fedopt[:opt=adam|yogi,lr=0.1], momentum[:lr=1.0,momentum=0.9], "
        "headboost[:gamma=1.5,match=classifier]",
    )
    p.add_argument(
        "--strategy-state-file",
        default=None,
        help="keep the last post-strategy global and the strategy's optimizer "
        "state in this npz file (the JAX package's layout) and resume from it "
        "on start; ignored when it holds another strategy",
    )
    p.add_argument(
        "--secure-agg",
        action="store_true",
        help="secure aggregation: accept pairwise-masked uploads and "
        "recover only their sum — individual client weights are never "
        "visible to the server",
    )
    p.add_argument(
        "--secure-protocol",
        choices=["double", "reveal"],
        default="double",
        help="dropout recovery: double (default, full Bonawitz "
        "double-masking — Shamir-shared seeds, survives unmask-phase "
        "dropouts, false death claims recover nothing) or reveal "
        "(cheaper; a reveal-phase dropout fails the round). Set "
        "identically on clients",
    )
    p.add_argument(
        "--secure-threshold",
        type=int,
        default=None,
        help="Shamir threshold for double-masking (default: strict "
        "majority of the keyed participants — the value that makes the "
        "either/or share-reveal rule binding). Set identically on clients",
    )
    p.add_argument(
        "--dp-clip",
        type=float,
        default=0.0,
        help="central DP: require clipped round-delta uploads (clients "
        "run with --dp), aggregate mean(clipped deltas) + Gaussian noise, "
        "reply with the noised mean delta — the server never holds "
        "absolute weights",
    )
    p.add_argument(
        "--dp-noise-multiplier",
        type=float,
        default=0.0,
        help="Gaussian noise std on the mean delta is "
        "multiplier * clip / n_clients; the accountant banner reports "
        "the (epsilon, delta) guarantee for the served rounds",
    )
    p.add_argument(
        "--dp-participation",
        type=float,
        default=1.0,
        help="Poisson cohort sampling rate q: each round samples every "
        "registered client independently with probability q; non-sampled "
        "clients sit the round out (they still receive the reply). "
        "q < 1 buys privacy amplification — the banner's subsampled "
        "accountant is exact for this sampler",
    )
    p.add_argument(
        "--dp-history-file",
        default=None,
        help="persist the DP resync window (the retained post-noise "
        "round deltas) to this npz file and reload it on startup, so a "
        "server restart between rounds does not re-strand stale "
        "clients — they heal bit-exactly from the reloaded fp32 "
        "history. Post-noise deltas are DP outputs; persisting them "
        "costs no privacy",
    )
    p.add_argument(
        "--trace-jsonl",
        help="append obs spans (round/agg/wire-reply with each round's "
        "trace id, also stamped into every reply meta) to this "
        "events-JSONL; merge with `obs timeline --trace-dir`",
    )
    _add_metrics_port(
        p,
        "expose live counters/gauges (rounds, uploads, wire bytes, "
        "per-phase seconds) at http://HOST:PORT/metrics in Prometheus "
        "text format (0 = off, the default)",
    )
    _add_flight_dir(p)
    _add_device(p, "the fold runs")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "relay",
        help="intermediate aggregator: fold a subtree of clients into a "
        "partial weighted mean (on the card) and forward one upload upward",
        epilog="Clients point at the relay exactly as at a root server "
        "(same wire protocol, same FEDTPU_SECRET auth). Run the ROOT "
        "`serve` with --num-clients = the relay count and --weighted, so "
        "subtree means recombine by their sample mass. Secure aggregation "
        "and central DP stay single-aggregator by design — run those "
        "fleets flat.",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=12346, help="subtree-facing listen port (default 12346)")
    p.add_argument("--parent-host", default="127.0.0.1", help="root (or higher-tier relay) host (default 127.0.0.1)")
    p.add_argument("--parent-port", type=int, default=12345, help="root (or higher-tier relay) port (default 12345)")
    p.add_argument(
        "--relay-id", type=int, required=True,
        help="this relay's client id on the PARENT tier — the fixed subtree order at the root (ascending relay id)",
    )
    p.add_argument("--num-clients", type=int, default=2, help="subtree size: how many clients this relay terminates")
    p.add_argument("--min-clients", type=int, default=None)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument(
        "--compression", default="none", type=_reply_compression,
        help="wire encoding both ways at this hop: none|bf16|int8",
    )
    p.add_argument(
        "--stream-chunk-mb", type=float, default=None,
        help="chunk-streamed upload offer for the subtree (see `serve --stream-chunk-mb`); "
        "0 = barrier shape below this relay",
    )
    p.add_argument(
        "--no-stream-upload", dest="stream_upload", action="store_false", default=True,
        help="send the upward partial as one dense frame (and skip the streamed-reply advert to the parent)",
    )
    p.add_argument(
        "--subtree-deadline-factor", type=float, default=0.5,
        help="per-subtree straggler deadline as a fraction of --timeout, strictly inside (0, 1): "
        "a slow subtree sheds its stragglers (set --min-clients below the subtree size) or fails "
        "its local quorum — so its clients can re-home — while the root is still inside ITS "
        "deadline (default 0.5)",
    )
    p.add_argument(
        "--trace-jsonl",
        help="append obs spans (round/agg/wire-reply/relay-forward) to this events-JSONL; "
        "merge with `obs timeline --trace-dir`",
    )
    _add_metrics_port(p, "Prometheus /metrics for this relay's round engine (0 = off, the default)")
    p.add_argument(
        "--upward-topk", type=float, default=None,
        help="sparsify the UPWARD hop: after round 1 the relay uploads topk deltas of its subtree "
        "partial against the last root aggregate it fanned down (error feedback carries the "
        "dropped mass). Needs the root on lossless reply compression; value is the kept "
        "fraction, e.g. 0.01",
    )
    p.add_argument(
        "--strategy", default="fedavg",
        help="strategy id this relay declares on every upward upload (strategies apply at the "
        "ROOT only; the root refuses a relay whose declared strategy differs). Must name the "
        "root's --strategy (default fedavg)",
    )
    _add_flight_dir(p)
    _add_device(p, "the subtree fold runs")
    p.set_defaults(fn=cmd_relay)

    p = sub.add_parser(
        "client",
        help="TCP federated client: train -> exchange -> adopt, per round",
        epilog="Writes client{N}_local_metrics.csv and, after a round, "
        "client{N}_aggregated_metrics.csv; a failed exchange leaves the "
        "local report only. A JAX server interoperates. Set FEDTPU_SECRET "
        "to authenticate the exchange.",
    )
    _add_training(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=12345)
    p.add_argument(
        "--parent", action="append", metavar="HOST:PORT", default=None,
        help="parent aggregator as HOST:PORT; REPEATABLE — the first is the primary (overrides "
        "--host/--port), every further one a ranked fallback. When the primary's dial budget runs "
        "out, or its connection dies mid-exchange, the client re-homes to the next parent and "
        "re-uploads (dense, marked): the adoptive relay folds it as an EXTRA contributor",
    )
    p.add_argument(
        "--rehome-dial-budget", type=float, default=8.0,
        help="seconds of seeded dial backoff per parent when fallback parents are configured "
        "(a dead parent costs this, not the whole --timeout; default 8)",
    )
    p.add_argument("--client-id", type=int, required=True)
    p.add_argument("--num-clients", type=int, default=None, help="clients the data is split for (default 2)")
    p.add_argument(
        "--data-parallel",
        type=int,
        help="shard the local training batch over this many of THIS "
        "host's devices (params replicated, gradients summed over the "
        "slots); the trajectory matches the single-device client to fp32 "
        "reduction-order ulps and the wire exchange is unchanged",
    )
    p.add_argument(
        "--seq-parallel",
        type=int,
        help="sequence-parallel shards for the local phase (ring "
        "attention over a local 'seq' mesh axis via a C=1 fedseq trainer; "
        "model.max_len must divide by it)",
    )
    p.add_argument(
        "--fsdp",
        action="store_true",
        default=None,
        help="FSDP shard-at-rest with --data-parallel N: params AND "
        "optimizer state shard per-leaf over the N local devices "
        "(all-gather at use, gradients summed onto each shard) so "
        "per-device static bytes scale ~1/N. Trajectory matches the "
        "replicated mesh to fp32 reduction-order ulps; the wire "
        "exchange, secure-agg, and DP compose unchanged",
    )
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument(
        "--compression",
        default="none",
        type=_wire_compression,
        help="upload encoding: none|bf16|int8|topk[:frac]. topk switches the "
        "exchange to sparse round deltas with client-side error feedback "
        "after the first, dense round",
    )
    p.add_argument(
        "--wire-dtype",
        choices=["fp32", "bf16", "int8"],
        default="fp32",
        help="quantize STREAMED upload chunks to this dtype once the server "
        "offers it (round 1 goes fp32); int8 carries an fp32 scale per 4096 "
        "elements. Refused with --compression",
    )
    p.add_argument(
        "--no-stream-upload",
        dest="stream_upload",
        action="store_false",
        default=True,
        help="never chunk-stream uploads nor ask for a streamed reply, even "
        "when the server offers them: every upload and reply is one dense "
        "frame (a topk client keeps an exact base against a server with a "
        "lossy --reply-dtype)",
    )
    p.add_argument(
        "--prox-mu",
        type=float,
        default=None,
        help="FedProx proximal weight of the local phase: each step adds "
        "mu/2 * ||params - round-start aggregate||^2 (pairs with the "
        "server's --strategy fedprox); 0/unset = plain local training",
    )
    p.add_argument(
        "--secure-agg",
        action="store_true",
        help="mask the upload with per-pair Diffie-Hellman secrets (fresh "
        "ephemeral keys each round, relayed through the server) so the "
        "server sees only the sum and no client can unmask another pair",
    )
    p.add_argument(
        "--min-participants",
        type=int,
        default=None,
        help="secure-agg quorum floor THIS client will mask over (default: "
        "the full fleet). Set to the server's --min-clients to opt into "
        "dropout-recovery quorums; a keys frame below the floor is "
        "refused without retry (anti-downgrade)",
    )
    p.add_argument(
        "--secure-protocol",
        choices=["double", "reveal"],
        default="double",
        help="secure-agg dropout recovery; must match the server's "
        "--secure-protocol (a mismatched advert is refused — downgrade "
        "protection)",
    )
    p.add_argument(
        "--secure-threshold",
        type=int,
        default=None,
        help="Shamir threshold for double-masking; must match the "
        "server's --secure-threshold (default: majority of the keyed "
        "participants)",
    )
    p.add_argument(
        "--dp",
        action="store_true",
        help="central DP (server runs with --dp-clip): upload the clipped "
        "round delta vs this round's starting params; the clip bound and "
        "noise multiplier come from the server's advert",
    )
    p.add_argument(
        "--persona",
        choices=["honest", "lazy", "slow", "intermittent", "stale", "flaky-net"],
        default=None,
        help="run this client under a misbehavior persona (faults/personas.py): lazy trains "
        "fewer epochs; slow throttles its upload through a local fault proxy; intermittent dies "
        "mid-upload once per exchange and retries; stale sits out every second round; flaky-net "
        "randomly resets connections (seeded). Wire faults run through a deterministic "
        "in-process TCP proxy against the REAL server — start the server first",
    )
    p.add_argument(
        "--fault-seed", type=int, default=0,
        help="seed for the persona's deterministic wire-fault draws (same seed = same faults, byte-for-byte)",
    )
    p.add_argument(
        "--partition", choices=["sample", "disjoint", "dirichlet", "quantity"],
        help="sample|disjoint|dirichlet|quantity",
    )
    p.add_argument(
        "--dirichlet-alpha",
        type=float,
        help="skew concentration for --partition dirichlet/quantity "
        "(smaller = more non-IID; default 0.5). Same seeded partition "
        "as the federated verb: client i holds identical rows on both",
    )
    p.add_argument(
        "--checkpoint-dir",
        help="warm-start + save full state here (the reference's "
        "client{N}_model.pth re-launch pattern, client1.py:375-377,388,403)",
    )
    p.set_defaults(fn=cmd_client)

    p = sub.add_parser(
        "predict",
        help="batch inference: flow CSV -> per-row attack probability CSV",
    )
    _add_training(p)  # --csv (required here), model and batch flags
    p.add_argument("--output", default="predictions.csv", help="predictions CSV path")
    p.add_argument(
        "--checkpoint-dir",
        help="training checkpoint (of `local`, `client` or `federated`; a "
        "federated one scores its global model)",
    )
    p.add_argument(
        "--threshold", type=float, default=0.5,
        help="P(attack) decision threshold (default 0.5)",
    )
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser(
        "infer-serve",
        help="online inference: dynamic-batching TCP scoring service",
        epilog="Requests are one frame each (serving/protocol.py): "
        '{"id": N, "text": "..."} or {"id": N, "features": {...}} (rendered '
        "through --dataset's template) with an optional per-request "
        "deadline_ms; replies carry P(attack) plus telemetry (model round, "
        "batch size, queue wait). A full queue or a blown deadline gets an "
        "explicit reject frame, never a hang. Stats probes and reload-now "
        "frames ride the same connection.",
    )
    p.add_argument(
        "--registry-dir",
        help="serve the model registry's PROMOTED artifact and follow the "
        "serving pointer (hot swap on promotion or rollback)",
    )
    p.add_argument(
        "--checkpoint-dir",
        help="serve (and hot-reload) from this local training checkpoint; "
        "new steps are picked up between batches",
    )
    p.add_argument(
        "--reload-poll",
        type=float,
        default=2.0,
        help="seconds between reload-source polls on the scorer's idle "
        "tick (default 2)",
    )
    # The model, tokenizer and dataset flags of the training verbs, as the
    # JAX package gives them (--max-len sets the served sequence length);
    # an artifact manifest's or checkpoint's model_config wins.
    _add_training(p, device=False)
    p.add_argument(
        "--auth",
        action="store_true",
        help="require the HMAC challenge-response on every scoring "
        "connection (shared secret from FEDTPU_SECRET; the SDK passes "
        "auth_key). Default: open port, like the reference",
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
    _add_metrics_port(
        p,
        "expose live gauges/counters (queue depth, rejects by kind, "
        "scored total, queue-wait histogram) at http://HOST:PORT/metrics "
        "in Prometheus text format (0 = off, the default)",
    )
    p.add_argument(
        "--trace-sample",
        type=float,
        default=None,
        help="serve-batch span sampling rate in (0, 1]: with --trace-jsonl"
        " on a high-rate scorer, emit one span per ~1/RATE coalesced "
        "batches (deterministic batch-counter stride, not RNG; each span "
        "carries sampled_batches so the timeline can re-scale). Default "
        "1.0 = every batch",
    )
    p.add_argument(
        "--scored-jsonl",
        help="append one {rid, prob, round} record per ANSWERED request "
        "here — the join key against a delayed ground-truth journal. Off "
        "by default: the metrics stream keeps exporting binned "
        "histograms, never raw scores",
    )
    p.add_argument(
        "--data-parallel",
        type=int,
        default=None,
        help="with --fsdp: shard the serving params over this many local "
        "devices (N >= 2). Serves models bigger than one device: per-device "
        "static bytes scale ~1/N and each dispatch gathers the weights at "
        "use",
    )
    p.add_argument(
        "--fsdp",
        action="store_true",
        default=None,
        help="shard-at-rest serving (needs --data-parallel N): checkpoint "
        "restore scatters leaves straight onto shards, hot reloads swap "
        "onto the same layout, probs stay bit-identical to the replicated "
        "engine",
    )
    _add_flight_dir(p)
    _add_device(p, "the model runs")
    p.set_defaults(fn=cmd_infer_serve)

    p = sub.add_parser(
        "registry",
        help="model registry operations: list | promote | rollback | gc",
    )
    p.add_argument("action", choices=["list", "promote", "rollback", "gc"])
    p.add_argument("--registry-dir", required=True)
    p.add_argument("--artifact", help="artifact id (promote)")
    p.add_argument(
        "--to",
        choices=["candidate", "shadow", "serving"],
        default=None,
        help="promotion target state (default: one rung up the "
        "candidate -> shadow -> serving ladder)",
    )
    p.add_argument(
        "--max-artifacts",
        type=int,
        default=None,
        help="gc: prune oldest retired/rejected artifacts until at most "
        "this many remain; the serving artifact, its rollback chain and "
        "live candidate/shadow artifacts are never pruned",
    )
    p.set_defaults(fn=cmd_registry)

    p = sub.add_parser(
        "route",
        help="serving router: load-balance the scoring protocol across N "
        "infer-serve replicas (least-in-flight pick, health probes, "
        "eject/readmit)",
        epilog="The router is model-free — it never tokenizes or scores; "
        "per-request cost is two id rewrites and two socket writes. "
        "Health rides the in-band stats() probe on each replica "
        "connection, so 'probe healthy' cannot diverge from 'requests "
        "flow'. With FEDTPU_SECRET + --auth the whole chain "
        "(client -> router -> replica) is HMAC-authenticated.",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=12390)
    p.add_argument(
        "--backend",
        action="append",
        metavar="HOST:PORT",
        help="an infer-serve replica to route across (repeatable, >= 1)",
    )
    p.add_argument(
        "--auth",
        action="store_true",
        help="HMAC challenge-response on the front port AND on every "
        "backend dial (shared secret from FEDTPU_SECRET)",
    )
    p.add_argument(
        "--probe-interval",
        type=float,
        default=1.0,
        help="seconds between per-replica stats() health probes (default 1)",
    )
    p.add_argument(
        "--probe-timeout",
        type=float,
        default=5.0,
        help="unanswered-probe age that ejects a replica (default 5)",
    )
    p.add_argument(
        "--max-inflight",
        type=int,
        default=1024,
        help="per-replica in-flight bound; a replica at the bound leaves "
        "the pick set until replies drain it (default 1024)",
    )
    p.add_argument(
        "--trace-jsonl",
        help="append obs spans (router-forward) to this events-JSONL",
    )
    p.add_argument(
        "--trace-sample",
        type=float,
        default=None,
        help="router-forward span sampling rate in (0, 1] (counter-strided"
        ", like infer-serve --trace-sample); default 1.0",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        default=0,
        help="Prometheus /metrics: per-replica in-flight gauges, eject and "
        "forward counters (0 = off, the default)",
    )
    _add_flight_dir(p)
    p.set_defaults(fn=cmd_route)

    p = sub.add_parser(
        "fleet",
        help="local replica fleet: N infer-serve replicas behind the "
        "router with registry-following ROLLING hot-reload (zero-drop "
        "promotions)",
        epilog="Serves the registry's PROMOTED artifact on every replica. "
        "On a promotion the fleet manager drains one replica at a time "
        "(router pick-set removal -> in-flight wait -> hot-swap -> "
        "readmit), so the serving pointer moves under load without "
        "dropping a request.",
    )
    _add_training(p, device=False)  # model/tokenizer/dataset resolution flags
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=12390)
    p.add_argument(
        "--replicas",
        type=int,
        default=None,
        help="replica count (default: config router.replicas = 3)",
    )
    p.add_argument(
        "--registry-dir",
        required=True,
        help="model registry whose serving pointer the fleet follows",
    )
    p.add_argument(
        "--auth",
        action="store_true",
        help="HMAC auth end-to-end: front port, every replica port, and "
        "the router's backend dials (FEDTPU_SECRET)",
    )
    p.add_argument(
        "--buckets",
        default="1,8,32,128",
        help="per-replica micro-batch bucket shapes (default 1,8,32,128)",
    )
    p.add_argument(
        "--max-wait-ms",
        type=float,
        default=5.0,
        help="per-replica batch gather window (default 5)",
    )
    p.add_argument(
        "--max-queue",
        type=int,
        default=1024,
        help="per-replica admission-control queue bound (default 1024)",
    )
    p.add_argument(
        "--reload-poll",
        type=float,
        default=2.0,
        help="seconds between serving-pointer polls (default 2)",
    )
    p.add_argument(
        "--threshold",
        type=float,
        default=0.5,
        help="P(attack) decision threshold in replies (default 0.5)",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        default=0,
        help="Prometheus /metrics for the router + replicas (0 = off)",
    )
    p.add_argument(
        "--shadow-sample",
        type=int,
        default=None,
        help="arm the shadow evaluation plane (shadow/): mirror one live "
        "request in N onto the registry's shadow-state artifact "
        "(deterministic counter stride, fire-and-forget — a full mirror "
        "queue drops the copy, never a live reply). The shadow replica "
        "is spun up by this fleet manager and NEVER joins the router's "
        "pick set. Default: config shadow.sample (0 = off)",
    )
    _add_flight_dir(p)
    _add_device(p, "every replica's model runs")
    p.set_defaults(fn=cmd_fleet)

    p = sub.add_parser(
        "controller",
        help="control plane: continuous eval-gated federated rounds "
        "(round -> gate -> promote -> serve -> drift-monitor loop)",
        epilog="Set FEDTPU_SECRET to authenticate the round endpoint "
        "(same contract as `serve`). The fold (K4) and the eval gate (K1 at "
        "rate 0) run on the card unless --device cpu. Central DP is not "
        "supported here: a DP server never holds the absolute params an "
        "artifact needs.",
    )
    _add_training(p)  # dataset/model flags resolve the held-out gate split; --device
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=12345)
    p.add_argument("--num-clients", type=int, default=None)
    p.add_argument("--min-clients", type=int, default=None)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument(
        "--rounds",
        type=int,
        default=0,
        help="stop after this many controller cycles (0 = run until "
        "interrupted — the daemon shape)",
    )
    p.add_argument(
        "--registry-dir",
        required=True,
        help="model registry root: every finished round writes an "
        "immutable candidate artifact here; the serving pointer is the "
        "file infer-serve --registry-dir follows",
    )
    p.add_argument(
        "--state-jsonl",
        default=None,
        help="controller-state JSONL (default: "
        "<registry-dir>/controller_state.jsonl); a restarted controller "
        "replays it and resumes the campaign mid-way",
    )
    p.add_argument(
        "--secure-agg",
        action="store_true",
        help="accept pairwise-masked uploads (comm/secure.py); the gate "
        "evaluates the recovered mean as usual",
    )
    p.add_argument(
        "--gate-metric",
        default=None,
        help="held-out metric the promotion gate compares (default "
        "Accuracy; higher is better)",
    )
    p.add_argument(
        "--gate-min-delta",
        type=float,
        default=None,
        help="tolerated regression: candidate must score >= incumbent - "
        "delta (default 0 = never promote a worse model)",
    )
    p.add_argument(
        "--interval",
        type=float,
        default=None,
        help="minimum seconds between round starts (fixed cadence when no "
        "--drift-jsonl is given; default 0 = back-to-back)",
    )
    p.add_argument(
        "--max-interval",
        type=float,
        default=None,
        help="with --drift-jsonl: force a round after this many seconds "
        "even when no drift fired (default: none — purely drift-driven)",
    )
    p.add_argument(
        "--drift-jsonl",
        help="serving metrics-JSONL to tail (infer-serve --metrics-jsonl "
        "X): rounds trigger when the live score distribution shifts off "
        "the promoted artifact's eval histogram",
    )
    p.add_argument(
        "--drift-threshold",
        type=float,
        default=None,
        help="drift distance that triggers a round (default 0.25 — the "
        "classic PSI 'significant shift' bound)",
    )
    p.add_argument(
        "--drift-min-scores",
        type=int,
        default=None,
        help="minimum live scores before a drift verdict (default 256)",
    )
    p.add_argument(
        "--drift-method",
        choices=["psi", "ks"],
        default=None,
        help="distribution distance: psi (default) or ks",
    )
    p.add_argument(
        "--round-deadline",
        type=float,
        default=None,
        help="per-round straggler deadline in seconds handed to the round "
        "engine (default: the server --timeout)",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        default=0,
        help="expose live counters (rounds, promotions, gate rejections, "
        "round-phase seconds) at http://HOST:PORT/metrics in Prometheus "
        "text format (0 = off, the default)",
    )
    p.add_argument(
        "--stream-chunk-mb",
        type=float,
        default=None,
        help="chunk-streamed upload advert for the embedded round engine "
        "(see `serve --stream-chunk-mb`); 0 = barrier shape",
    )
    p.add_argument(
        "--max-artifacts",
        type=int,
        default=None,
        help="registry GC after every promotion/rejection: prune oldest "
        "retired/rejected artifacts beyond this count (the serving "
        "artifact and its rollback chain are never pruned); default: "
        "keep everything",
    )
    p.add_argument(
        "--shadow-gate",
        action="store_true",
        help="hold every eval-passing candidate in the registry SHADOW "
        "state and promote only after the live mirror (fedtpu fleet "
        "--shadow-sample) accumulated >= --shadow-min-pairs pairs with "
        "disagreement under threshold; regression (or no evidence "
        "inside --shadow-timeout) fails closed to rejected with the "
        "verdict on the registry event",
    )
    p.add_argument(
        "--shadow-min-pairs",
        type=int,
        default=None,
        help="mirrored pairs required before the shadow gate rules "
        "(default: config shadow.min_pairs = 256)",
    )
    p.add_argument(
        "--shadow-timeout",
        type=float,
        default=None,
        help="seconds the shadow gate waits for its evidence before "
        "failing closed (default: config shadow.timeout_s = 600)",
    )
    p.add_argument(
        "--shadow-max-flip-rate",
        type=float,
        default=None,
        help="max tolerated prediction-flip fraction across mirrored "
        "pairs (default: config shadow.max_flip_rate = 0.02)",
    )
    p.add_argument(
        "--shadow-psi-threshold",
        type=float,
        default=None,
        help="max tolerated PSI between the paired serving/shadow score "
        "histograms (default: config shadow.psi_threshold = 0.25)",
    )
    p.add_argument(
        "--adaptive-cadence",
        action="store_true",
        help="scale the inter-round interval between --interval and "
        "--max-interval by each drift verdict's magnitude (barely over "
        "threshold -> relaxed max; >= 2x threshold -> urgent min); the "
        "chosen interval rides the drift-trigger span",
    )
    p.add_argument(
        "--label-gate",
        action="store_true",
        help="supervised promotion rung AFTER the shadow gate: join the "
        "candidate's mirror pairs against the delayed ground-truth "
        "journal (<registry>/labels/journal.jsonl, fedtpu labels "
        "ingest) and reject any candidate whose supervised error "
        "exceeds the incumbent's by more than --label-max-regression; "
        "too few joined labels or coverage under --label-coverage-floor "
        "fails closed",
    )
    p.add_argument(
        "--label-journal",
        help="ground-truth journal override (default: "
        "<registry>/labels/journal.jsonl)",
    )
    p.add_argument(
        "--label-min-joined",
        type=int,
        default=None,
        help="joined (labeled) flows required before the label gate "
        "rules (default: config labels.min_joined = 32)",
    )
    p.add_argument(
        "--label-coverage-floor",
        type=float,
        default=None,
        help="minimum joined/total coverage of the scored population "
        "(default: config labels.coverage_floor = 0.05)",
    )
    p.add_argument(
        "--label-max-regression",
        type=float,
        default=None,
        help="max tolerated candidate-over-serving supervised error "
        "excess (default: config labels.max_regression = 0)",
    )
    p.add_argument(
        "--error-drift",
        action="store_true",
        help="with --label-gate: also trigger rounds when the SERVING "
        "model's supervised error over joined ground truth rises "
        "labels.error_margin past its promoted reference (the "
        "regression score-histogram drift cannot see)",
    )
    p.add_argument(
        "--sentinel-jsonl",
        help="tail this sentinel verdicts-JSONL (fedtpu obs sentinel "
        "--verdicts-jsonl) and treat each new supervised-drift verdict "
        "as a corrective-round trigger — the cross-process twin of "
        "--error-drift (only verdicts appended AFTER startup count)",
    )
    p.add_argument(
        "--drift-cohort",
        action="store_true",
        help="scale the corrective round's quorum by each drift "
        "verdict's magnitude between --cohort-min-frac and "
        "--cohort-max-frac of --min-clients (one round, then the base "
        "quorum restores); the chosen quorum rides the drift-trigger "
        "record",
    )
    p.add_argument(
        "--cohort-min-frac",
        type=float,
        default=None,
        help="quorum fraction at barely-over-threshold drift (default: "
        "config control.cohort_min_frac = 0.5)",
    )
    p.add_argument(
        "--cohort-max-frac",
        type=float,
        default=None,
        help="quorum fraction at >= 2x-threshold drift (default: "
        "config control.cohort_max_frac = 1.0)",
    )
    p.add_argument(
        "--slo-alerts-jsonl",
        help="tail the health plane's alerts-JSONL (fedtpu obs "
        "health|watch --alerts-jsonl) and, while the round-duration "
        "burn alert FIRES, tighten the straggler deadline by "
        "--slo-deadline-factor until it clears",
    )
    p.add_argument(
        "--slo-deadline-factor",
        type=float,
        default=None,
        help="straggler-deadline multiplier applied while the "
        "round-duration SLO fires (default: config "
        "control.slo_deadline_factor = 0.5)",
    )
    _add_flight_dir(p)
    p.set_defaults(fn=cmd_controller)

    p = sub.add_parser(
        "scenario",
        help='the "federated in the wild" matrix: persona x partition '
        "cells of live loopback rounds with wire-level fault injection",
        epilog="Each cell runs a REAL AggregationServer + client fleet "
        "on loopback (every server's fold on the card unless --device cpu), "
        "with the row's persona driving faults through the "
        "deterministic TCP fault proxy (faults/). Outcomes come from "
        "the obs timeline (contributors, drop attribution, straggler "
        "wait); every successful round's aggregate is crc-pinned "
        "bit-exact against the clean barrier mean over the same "
        "survivor set. Exits 1 on any contract violation.",
    )
    p.add_argument(
        "--personas", default="lazy,slow,intermittent",
        help="comma list of matrix rows (honest|lazy|slow|intermittent|stale|flaky-net; "
        "default lazy,slow,intermittent)",
    )
    p.add_argument(
        "--partitions", default="iid,dirichlet",
        help="comma list of matrix columns (iid|dirichlet|quantity; default iid,dirichlet)",
    )
    p.add_argument(
        "--dirichlet-alpha", type=float, default=0.1,
        help="skew concentration for the dirichlet/quantity columns (default 0.1 — heavily non-IID)",
    )
    p.add_argument("--clients", type=int, default=3)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--payload-kb", type=int, default=64, help="synthetic per-client model payload size (default 64)")
    p.add_argument("--deadline", type=float, default=8.0, help="per-round straggler deadline seconds (default 8)")
    p.add_argument("--fault-seed", type=int, default=0)
    p.add_argument(
        "--out-dir", default="outputs/scenario",
        help="grid.txt + scenario.jsonl + per-cell trace JSONLs land here (default outputs/scenario)",
    )
    p.add_argument(
        "--train", action="store_true",
        help="train a tiny real model per client on the partitioned shards (adds the per-cell "
        "accuracy column; slower)",
    )
    p.add_argument("--no-auth-cell", action="store_true", help="skip the extra HMAC-authenticated cell")
    p.add_argument(
        "--no-dead-relay-cell", action="store_true",
        help="skip the dead-relay cell (depth-2 fold tree with a seeded mid-round relay kill: the "
        "victim subtree's clients re-home to the surviving relay and the root completes a degraded "
        "round, crc-pinned against the actual-contributor replay)",
    )
    p.add_argument(
        "--no-stream", action="store_true",
        help="dense single-frame uploads in every cell (default: the server advertises "
        "chunk-streamed uploads, so round 2+ streams)",
    )
    p.add_argument(
        "--strategies", default=None,
        help="';'-separated server strategy specs (NAME[:k=v,...], see `serve --strategy`; plain "
        "',' also works for bare names) to APPEND as extra matrix cells — each persona x "
        "partition pair re-runs under every listed non-fedavg strategy, with the base cells as "
        "the fedavg baseline (add --train for the accuracy comparator)",
    )
    p.add_argument("--json", action="store_true", help="print one JSON record per cell instead of the grid")
    _add_device(p, "every cell's fold (and a --train cell's clients) runs")
    p.set_defaults(fn=cmd_scenario)

    p = sub.add_parser(
        "shadow",
        help="shadow evaluation plane: status | report — what is under "
        "live shadow evaluation and the paired disagreement evidence",
        epilog="Reads the registry directory only (the shadow pointer, "
        "the comparator's atomic status snapshot, and the paired-records "
        "JSONL under <registry>/shadow/) — works from any host that "
        "mounts it, like every other control-plane surface.",
    )
    p.add_argument("action", choices=["status", "report"])
    p.add_argument("--registry-dir", required=True)
    p.add_argument(
        "--artifact",
        help="report: this artifact's paired records (default: the "
        "artifact currently under shadow evaluation)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable output instead of the rendered summary",
    )
    p.set_defaults(fn=cmd_shadow)

    p = sub.add_parser(
        "labels",
        help="delayed ground-truth plane: ingest | status | report — "
        "append labeler verdicts to the journal and join them against "
        "what the models answered",
        epilog="Reads and appends under the registry directory only "
        "(<registry>/labels/journal.jsonl plus the shadow plane's "
        "paired records) — works from any host that mounts it, like "
        "every other control-plane surface.",
    )
    p.add_argument("action", choices=["ingest", "status", "report"])
    p.add_argument("--registry-dir", required=True)
    p.add_argument(
        "--journal",
        help="ground-truth journal override (default: "
        "<registry>/labels/journal.jsonl)",
    )
    p.add_argument(
        "--file",
        help='ingest: JSONL of {"rid", "label", "ts"} labeler records '
        "(missing ts falls back to --ts, then 0.0)",
    )
    p.add_argument("--rid", help="ingest: one request id")
    p.add_argument(
        "--label",
        type=int,
        default=None,
        help="ingest: the ground-truth class for --rid (0 = benign; "
        "any other class is an attack)",
    )
    p.add_argument(
        "--ts",
        type=float,
        default=None,
        help="ingest: labeler timestamp for records that carry none "
        "(last-writer-wins key; default 0.0)",
    )
    p.add_argument(
        "--watermark",
        type=float,
        default=None,
        help='ingest: advance the monotone "labels complete through T" '
        "watermark after applying the records",
    )
    p.add_argument(
        "--artifact",
        help="report: join this artifact's mirror pairs (default: the "
        "artifact currently under shadow evaluation)",
    )
    p.add_argument(
        "--scored",
        help="report: join a serving tier's scored-JSONL (infer-serve "
        "--scored-jsonl) instead of mirror pairs",
    )
    p.add_argument(
        "--threshold",
        type=float,
        default=0.5,
        help="decision threshold the join applies to each model's "
        "probability (default 0.5)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable output instead of the rendered summary",
    )
    p.set_defaults(fn=cmd_labels)

    p = sub.add_parser("distill", help="teacher -> student knowledge distillation")
    _add_training(p)
    p.add_argument("--teacher-layers", type=int, help="default: 2x student layers")
    p.add_argument(
        "--teacher-checkpoint",
        help="distill FROM this trained checkpoint (local or federated — "
        "e.g. a federated fleet's aggregate) instead of training a fresh "
        "teacher; --pth + --hf-dir similarly supplies a reference-trained "
        "teacher",
    )
    p.add_argument(
        "--student-layers",
        type=int,
        help="student depth (default: the resolved model's) — e.g. distill "
        "a migrated 6-layer model into 3 layers",
    )
    p.add_argument("--distill-epochs", type=int, help="default: train epochs")
    p.add_argument("--temperature", type=float, help="KD softmax temperature")
    p.add_argument("--alpha", type=float, help="KD loss weight in [0,1]")
    p.add_argument(
        "--no-teacher-init",
        action="store_true",
        help="skip the every-other-layer student init",
    )
    p.add_argument("--checkpoint-dir", help="save the student's state here (its architecture recorded)")
    p.set_defaults(fn=cmd_distill)

    p = sub.add_parser(
        "export-hf",
        help="export a trained checkpoint to the HF DistilBERT layout "
        "(config.json + model.safetensors + vocab.txt)",
    )
    _add_training(p)
    # Not required: --pth + --hf-dir is the other weight source (checked
    # when the command runs).
    p.add_argument("--checkpoint-dir")
    p.add_argument("--out", required=True, help="output HF checkpoint dir")
    p.set_defaults(fn=cmd_export_hf)

    _add_obs_verb(sub)
    _add_check_verb(sub)

    p = sub.add_parser("export-config", help="print the resolved config as JSON")
    _add_training(p, device=False)
    p.add_argument("--num-clients", type=int)
    p.add_argument("--rounds", type=int)
    p.set_defaults(fn=cmd_export_config)
    return ap


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    return args.fn(args)
