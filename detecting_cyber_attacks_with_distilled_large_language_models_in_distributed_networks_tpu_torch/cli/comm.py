"""``serve`` / ``client``: the federated round over TCP (the reference's
socket deployment, server.py + client1.py end to end; the port of the JAX
package's ``cli/comm.py`` for the dense fp32 FedAvg round).

Both run on the card unless ``--device cpu`` is given. A JAX ``serve`` or
``client`` interoperates with these on the dense fp32 wire.
"""

from __future__ import annotations

import logging
import time

from ..comm import AggregationServer, FederatedClient
from ..data.tokenizer import default_tokenizer
from ..device import resolve_device
from .common import _load_clients, _write_reports, resolve_config

log = logging.getLogger(__name__)


def build_server(args) -> AggregationServer:
    """The aggregation server the ``serve`` flags describe, bound and
    listening (``server.port`` is the bound port), not yet serving."""
    return AggregationServer(
        host=args.host,
        port=args.port,
        num_clients=args.num_clients,
        weighted=args.weighted,
        min_clients=args.min_clients,
        timeout=args.timeout,
        device=args.device,
    )


def cmd_serve(args) -> int:
    with build_server(args) as server:
        log.info(f"[SERVER] listening on {args.host}:{server.port} (fold on {server.device})")
        server.serve(rounds=args.rounds)
    return 0


def run_client(args) -> dict:
    """The ``client`` command's work: (train -> evaluate -> exchange ->
    evaluate the aggregate -> adopt it) per round, then the metrics CSVs;
    degrades to local-only reports when an exchange fails
    (client1.py:405-410). Returns what it measured and wrote: ``config``,
    ``trainer``, ``state``, ``local`` and ``aggregated`` metrics (None
    after a failed exchange), ``uploaded`` and ``aggregate`` (the last
    round's params as sent and as received, JAX layout), ``seconds`` per
    phase of the last round (with the data and model set-up before the
    first), ``exchange`` (the client's wire record of it) and
    ``metrics_csvs``."""
    from ..train.engine import Trainer

    t_start = time.perf_counter()
    device = resolve_device(args.device)  # raises before any work without CUDA
    tok = default_tokenizer()
    cfg = resolve_config(args, vocab_size=len(tok.vocab))
    client = _load_clients(args, cfg, tok, cfg.fed.num_clients)[args.client_id]
    trainer = Trainer(
        cfg.model, cfg.train, pad_id=tok.pad_id,
        drop_remainder=cfg.data.drop_remainder, device=device,
    )
    state = trainer.init_state()
    fed = FederatedClient(args.host, args.port, client_id=args.client_id, timeout=args.timeout)
    tag = f"[CLIENT {args.client_id}] "
    E = cfg.train.epochs_per_round
    eval_bs = cfg.data.eval_batch_size
    local = agg_metrics = uploaded = aggregated = None
    setup_s = time.perf_counter() - t_start
    seconds: dict[str, float] = {}
    for r in range(cfg.fed.rounds):
        t0 = time.perf_counter()
        state, _ = trainer.fit(
            state, client.train, batch_size=cfg.data.batch_size, epoch_offset=r * E, tag=tag
        )
        t1 = time.perf_counter()
        local = trainer.evaluate_state(state, client.test, batch_size=eval_bs)
        t2 = time.perf_counter()
        uploaded = trainer.host_params(state)
        t3 = time.perf_counter()
        seconds = {"setup": setup_s, "train": t1 - t0, "eval_local": t2 - t1, "host_params": t3 - t2}
        try:
            aggregated = fed.exchange(uploaded, n_samples=len(client.train))
        except OSError as e:  # ConnectionError included: the server is gone
            agg_metrics = aggregated = None
            log.info(f"{tag}round {r + 1} exchange failed ({e}); local-only reports")
            break
        t4 = time.perf_counter()
        agg_metrics = trainer.evaluate(aggregated, client.test, batch_size=eval_bs)
        t5 = time.perf_counter()
        log.info(
            f"{tag}round {r + 1}: local acc {local['Accuracy']:.4f} -> "
            f"aggregated acc {agg_metrics['Accuracy']:.4f}"
        )
        # The next round trains FROM the aggregate with a fresh Adam and a
        # continuing step counter.
        state = trainer.adopt_aggregate(state, aggregated)
        seconds.update(exchange=t4 - t3, eval_aggregated=t5 - t4, adopt=time.perf_counter() - t5)
    paths = _write_reports(args.client_id, local, agg_metrics, cfg.output_dir)
    return {
        "config": cfg, "trainer": trainer, "state": state, "local": local,
        "aggregated": agg_metrics, "uploaded": uploaded, "aggregate": aggregated,
        "seconds": seconds, "exchange": fed.last_exchange, "metrics_csvs": paths,
    }


def cmd_client(args) -> int:
    run_client(args)
    return 0
