"""Timestamped phase logging (the port's copy of the JAX package's
``utils/logging.py``).

The reference's observability is ``print(f"... at {datetime.now()}")``
begin/end brackets around every phase (e.g. reference
client1.py:85,92,97,115), and its terminal logs are the de-facto record
of a run. :func:`phase` keeps that bracket shape (the same greppable
``Starting``/``Finished`` lines as the JAX package) on top of
``logging``; the measured seconds come back to the caller.
"""

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager
from datetime import datetime
from typing import Iterator

_FORMAT = "%(message)s"


def get_logger(name: str = "fedtpu") -> logging.Logger:
    """The bracket logger: plain messages on stdout, not propagated to
    the root logger (whose handler the CLI configures for the rest)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def timestamp() -> str:
    return str(datetime.now())


@contextmanager
def phase(name: str, tag: str = "", logger: logging.Logger | None = None) -> Iterator[dict]:
    """Begin/end bracket with wall-clock duration, reference-log style::

        [CLIENT 0] Starting model training at 2026-07-29 ...
        [CLIENT 0] Finished model training at ... (12.3 s)

    Yields a dict; the measured duration lands in ``info['seconds']``.
    """
    log = logger or get_logger()
    prefix = f"[{tag}] " if tag else ""
    log.info(f"{prefix}Starting {name} at {timestamp()}")
    info: dict = {}
    t0 = time.perf_counter()
    try:
        yield info
    finally:
        info["seconds"] = time.perf_counter() - t0
        log.info(f"{prefix}Finished {name} at {timestamp()} ({info['seconds']:.2f} s)")
