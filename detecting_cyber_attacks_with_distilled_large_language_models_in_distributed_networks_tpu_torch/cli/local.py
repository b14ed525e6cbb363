"""``local`` — one client: train -> eval -> metrics CSV (the reference's
client1.py minus the sockets), on the card unless ``--device cpu``."""

from __future__ import annotations

import logging
import time

from ..data.tokenizer import default_tokenizer
from ..device import resolve_device
from .common import _load_clients, _write_reports, resolve_config

log = logging.getLogger(__name__)


def run_local(args) -> dict:
    """The ``local`` command's work; returns what it measured and wrote:
    ``config``, ``client`` (its token arrays), ``trainer``, ``state``,
    ``losses`` (per epoch), ``val``
    and ``test`` metrics, ``train_samples``, ``train_seconds`` and
    ``metrics_csv``."""
    from ..train.engine import Trainer

    device = resolve_device(args.device)  # raises before any work without CUDA
    tok = default_tokenizer()
    cfg = resolve_config(args, vocab_size=len(tok.vocab))
    client = _load_clients(args, cfg, tok, max(args.client_id + 1, 1))[args.client_id]
    trainer = Trainer(
        cfg.model, cfg.train, pad_id=tok.pad_id,
        drop_remainder=cfg.data.drop_remainder, device=device,
    )
    state = trainer.init_state()
    tag = f"[CLIENT {args.client_id}] "
    t0 = time.perf_counter()
    state, losses = trainer.fit(
        state, client.train, batch_size=cfg.data.batch_size, tag=tag
    )  # fit syncs at each epoch's end (the mean loss)
    train_seconds = time.perf_counter() - t0
    steps = state.step
    val = trainer.evaluate(state.params, client.val, batch_size=cfg.data.eval_batch_size)
    test = trainer.evaluate(state.params, client.test, batch_size=cfg.data.eval_batch_size)
    log.info(
        f"{tag}val acc {val['Accuracy']:.4f} | "
        f"test acc {test['Accuracy']:.4f} f1 {test['F1-Score']:.4f}"
    )
    path = _write_reports(args.client_id, test, cfg.output_dir)
    return {
        "config": cfg, "client": client, "trainer": trainer, "state": state,
        "losses": losses,
        "val": val, "test": test, "train_samples": steps * cfg.data.batch_size,
        "train_seconds": train_seconds, "metrics_csv": path,
    }


def cmd_local(args) -> int:
    run_local(args)
    return 0
