"""``local`` — one client: train -> eval -> metrics CSV (the reference's
client1.py minus the sockets), on the card unless ``--device cpu``."""

from __future__ import annotations

import logging
import time

from ..device import resolve_device
from ..utils.logging import phase
from .common import _append_metrics, _load_clients, _obs_setup, _resolve_with_pretrained, _write_reports

log = logging.getLogger(__name__)


def run_local(args) -> dict:
    """The ``local`` command's work; returns what it measured and wrote:
    ``config``, ``client`` (its token arrays), ``trainer``, ``state``,
    ``losses`` (per epoch), ``val``
    and ``test`` metrics, ``train_samples``, ``train_seconds``,
    ``metrics_csv`` and, with a checkpoint directory, ``save_seconds``
    (None without one). The state is saved once, after the reports, at
    step ``state.step``; ``local`` never warm-starts from it (as in the
    JAX package). With ``--hf-dir`` training starts from the checkpoint's
    encoder (and ``--pth``'s weights), else from a seeded init.

    Obs, as the JAX verb's flags: ``--profile-dir`` wraps the fit in a
    torch.profiler trace, ``--metrics-jsonl`` gets the val and test
    records. The port's ``local`` also installs ``--profile-stride``,
    ``--trace-jsonl`` and ``--flight-dir`` (the JAX verb parses them but
    leaves them unused): the fit's sampled step timers, and the dispatch
    ledger's spans."""
    from ..train.checkpoint import Checkpointer
    from ..train.engine import Trainer
    from ..utils.profiling import trace

    device = resolve_device(args.device)  # raises before any work without CUDA
    tok, cfg, pretrained = _resolve_with_pretrained(args)
    _tracer, metrics_server = _obs_setup(args, proc=f"client-{args.client_id}", cfg=cfg)
    client = _load_clients(args, cfg, tok, max(args.client_id + 1, 1))[args.client_id]
    trainer = Trainer(
        cfg.model, cfg.train, pad_id=tok.pad_id,
        drop_remainder=cfg.data.drop_remainder, device=device,
    )
    state = trainer.init_state(params=pretrained)
    tag = f"[CLIENT {args.client_id}] "
    t0 = time.perf_counter()
    with phase(f"client {args.client_id} local training", tag="TRAIN"), trace(args.profile_dir):
        state, losses = trainer.fit(
            state, client.train, batch_size=cfg.data.batch_size, tag=tag
        )  # fit syncs at each epoch's end (the mean loss)
    train_seconds = time.perf_counter() - t0
    steps = state.step
    with phase("validation evaluation", tag="EVAL"):
        val = trainer.evaluate(state.params, client.val, batch_size=cfg.data.eval_batch_size)
    with phase("test evaluation", tag="EVAL"):
        test = trainer.evaluate(state.params, client.test, batch_size=cfg.data.eval_batch_size)
    log.info(
        f"{tag}val acc {val['Accuracy']:.4f} | "
        f"test acc {test['Accuracy']:.4f} f1 {test['F1-Score']:.4f}"
    )
    _append_metrics(args, ({"client": args.client_id, "phase": name, **m} for name, m in (("val", val), ("test", test))))
    (path,) = _write_reports(args.client_id, test, None, cfg.output_dir)
    save_seconds = None
    if cfg.checkpoint_dir:
        t0 = time.perf_counter()
        with Checkpointer(cfg.checkpoint_dir) as ckpt:
            ckpt.save(
                state.step, state,
                meta={"client_id": args.client_id, "kind": "local", "config": cfg.to_dict()},
            )
        save_seconds = time.perf_counter() - t0
        log.info(f"{tag}saved step {state.step} to {cfg.checkpoint_dir} in {save_seconds:.3f} s")
    if metrics_server is not None:
        metrics_server.close()
    return {
        "config": cfg, "client": client, "trainer": trainer, "state": state,
        "losses": losses,
        "val": val, "test": test, "train_samples": steps * cfg.data.batch_size,
        "train_seconds": train_seconds, "metrics_csv": path, "save_seconds": save_seconds,
    }


def cmd_local(args) -> int:
    run_local(args)
    return 0
