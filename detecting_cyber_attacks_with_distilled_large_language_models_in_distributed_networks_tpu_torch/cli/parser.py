"""Command line of the port: ``python -m <package> <verb> ...``.

The verbs and flags mirror the JAX package's ``cli/parser.py``; the port
has ``local`` (single-client training), ``federated`` (N clients in one
process), ``serve`` and ``client`` (a federated round over TCP),
``distill`` (teacher -> student), ``predict`` (batch inference),
``infer-serve`` (online scoring with hot reload), ``export-hf`` (weights
to the HF layout), ``export-config`` (the resolved config as JSON) and
``registry`` (the model registry's operator commands) so far. Each that
computes runs on the card unless ``--device cpu`` is given. Flags of
features the port has not reached (``--metrics-jsonl``, ``--profile-dir``,
``--trace-jsonl``, ``--secure-agg``, ``--data-parallel``,
``--seq-parallel``) are absent, so argparse refuses them.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from ..data.datasets import DATASETS
from ..models.presets import preset_names
from .comm import cmd_client, cmd_serve
from .common import resolve_config
from .control import cmd_registry
from .distill import cmd_distill
from .federated import cmd_federated
from .local import cmd_local
from .predict import cmd_export_hf, cmd_predict
from .serving import cmd_infer_serve


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
    if device:
        _add_device(p, "training and evaluation run")


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
    _add_device(p, "the fold runs")
    p.set_defaults(fn=cmd_serve)

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
    p.add_argument("--client-id", type=int, required=True)
    p.add_argument("--num-clients", type=int, default=None, help="clients the data is split for (default 2)")
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
        "--dp",
        action="store_true",
        help="central DP (server runs with --dp-clip): upload the clipped "
        "round delta vs this round's starting params; the clip bound and "
        "noise multiplier come from the server's advert",
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
