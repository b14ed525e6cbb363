"""Client data partitioners: one source dataset -> N client shards (the
port's copy of the JAX package's ``data/partition.py``, numpy only).

The reference's only notion of partitioning is an independent
``df.sample(frac, random_state=seed)`` per copy-pasted client script
(reference client1.py:89, client2.py:84): IID by construction, overlap
between clients possible. The index-based schemes here:

* ``disjoint``  — equal disjoint shards of one global permutation (IID,
                  no overlap).
* ``dirichlet`` — label-skew non-IID (Hsu et al.): for each class, split
                  its rows among clients by Dirichlet(alpha) proportions.
* ``quantity``  — quantity skew: disjoint IID-content shards whose SIZES
                  are drawn from Dirichlet(alpha).

Every scheme is seeded from ``DataConfig.seed_base`` and draws exactly
what the JAX package draws, so client i holds the identical row set in
both packages (pinned by tests/test_torch_partition.py). Each partition
also yields a MANIFEST of per-client label histograms, logged and
written next to the run outputs.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Sequence

import numpy as np

from ..config import DataConfig

log = logging.getLogger(__name__)

#: Registered partition schemes (``sample`` is the reference's
#: per-client fraction sample, implemented in data/cicids.py; the rest
#: are index-based and dispatch through :func:`partition_indices`).
PARTITION_SCHEMES = ("sample", "disjoint", "dirichlet", "quantity")

#: Default filename the CLI writes the manifest under (in output_dir).
MANIFEST_FILENAME = "partition_manifest.json"


def dirichlet_label_indices(
    labels: np.ndarray,
    num_clients: int,
    *,
    alpha: float,
    data_fraction: float,
    rng: np.random.Generator,
) -> list[np.ndarray]:
    """Label-skew partition: per class, shuffle its rows and split them
    among clients by Dirichlet(alpha) proportions. ``data_fraction`` is
    per-dataset (each client targets ``frac * n`` rows in expectation;
    the class cap is ``frac * num_clients`` of each class's rows)."""
    out: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        idx = idx[: max(1, int(len(idx) * data_fraction * num_clients))]
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for cid, chunk in enumerate(np.split(idx, cuts)):
            out[cid].append(chunk)
    return [
        np.concatenate(chunks) if chunks else np.array([], int)
        for chunks in out
    ]


def quantity_skew_indices(
    n: int,
    num_clients: int,
    *,
    alpha: float,
    data_fraction: float,
    rng: np.random.Generator,
) -> list[np.ndarray]:
    """Quantity-skew partition: one global permutation cut into disjoint
    shards whose sizes follow Dirichlet(alpha) — IID content, unbalanced
    counts. Every client is guaranteed at least one row (a zero-row
    client would crash its local loader, and a Dirichlet draw lands on
    exact zero with probability > 0 only through float truncation
    anyway)."""
    if data_fraction * num_clients > 1.0 + 1e-9:
        raise ValueError(
            f"quantity partition infeasible: data_fraction="
            f"{data_fraction} x {num_clients} clients > 1"
        )
    total = min(n, max(num_clients, int(n * data_fraction * num_clients)))
    if total < num_clients:
        raise ValueError(
            f"quantity partition infeasible: {n} rows cannot give "
            f"{num_clients} clients one row each"
        )
    perm = rng.permutation(n)[:total]
    props = rng.dirichlet([alpha] * num_clients)
    # floor over (total - C) spare rows plus one guaranteed row each;
    # the flooring remainder goes to the largest shard so sizes sum to
    # ``total`` exactly.
    sizes = np.floor(props * (total - num_clients)).astype(int) + 1
    sizes[int(np.argmax(sizes))] += total - int(sizes.sum())
    cuts = np.cumsum(sizes)[:-1]
    return [np.asarray(part) for part in np.split(perm, cuts)]


def partition_indices(
    labels: np.ndarray,
    num_clients: int,
    cfg: DataConfig,
) -> list[np.ndarray]:
    """Row indices per client for the index-based schemes
    (``disjoint`` | ``dirichlet`` | ``quantity``), seeded from
    ``cfg.seed_base``; the same seed reproduces the identical index
    sets on every run and every deployment tier.

    ``data_fraction`` is always per-dataset (same convention across
    schemes): each client gets ``frac * n`` rows (exactly for disjoint,
    in expectation for the skewed schemes).
    """
    n = len(labels)
    rng = np.random.default_rng(cfg.seed_base)
    if cfg.partition == "disjoint":
        # data_fraction is per-dataset (same convention as 'sample' and
        # 'dirichlet'): each client gets frac*n rows, disjoint across clients.
        if cfg.data_fraction * num_clients > 1.0 + 1e-9:
            raise ValueError(
                f"disjoint partition infeasible: data_fraction="
                f"{cfg.data_fraction} x {num_clients} clients > 1"
            )
        perm = rng.permutation(n)
        per_client = max(1, int(n * cfg.data_fraction))
        return [
            perm[cid * per_client : (cid + 1) * per_client]
            for cid in range(num_clients)
        ]
    if cfg.partition == "dirichlet":
        return dirichlet_label_indices(
            np.asarray(labels),
            num_clients,
            alpha=cfg.dirichlet_alpha,
            data_fraction=cfg.data_fraction,
            rng=rng,
        )
    if cfg.partition == "quantity":
        return quantity_skew_indices(
            n,
            num_clients,
            alpha=cfg.dirichlet_alpha,
            data_fraction=cfg.data_fraction,
            rng=rng,
        )
    raise ValueError(f"unknown partition scheme {cfg.partition!r}")


# ----------------------------------------------------------- manifest
def partition_manifest(
    client_labels: Sequence[np.ndarray],
    *,
    cfg: DataConfig,
    total_rows: int,
) -> dict:
    """Per-client label histograms for one computed partition — the
    record of exactly what each client saw under a non-IID scheme.
    ``client_labels`` is each client's binary label array (the shard's
    rows, pre train/val/test split)."""
    classes = sorted(
        {int(c) for arr in client_labels for c in np.unique(np.asarray(arr))}
    )
    clients = []
    for cid, arr in enumerate(client_labels):
        arr = np.asarray(arr)
        clients.append(
            {
                "client": cid,
                "rows": int(len(arr)),
                "label_hist": {
                    str(c): int((arr == c).sum()) for c in classes
                },
            }
        )
    return {
        "scheme": cfg.partition,
        "seed": int(cfg.seed_base),
        "alpha": (
            float(cfg.dirichlet_alpha)
            if cfg.partition in ("dirichlet", "quantity")
            else None
        ),
        "data_fraction": float(cfg.data_fraction),
        "num_clients": len(clients),
        "total_rows": int(total_rows),
        "assigned_rows": int(sum(c["rows"] for c in clients)),
        # 'sample' draws independently per client, so shards may overlap
        # (assigned_rows can exceed distinct source rows); the
        # index-based schemes are disjoint by construction.
        "disjoint": cfg.partition != "sample",
        "clients": clients,
    }


def log_manifest(manifest: dict) -> None:
    """One INFO line summarizing the partition (per-client row count +
    label histogram) — the at-a-glance record of how skewed a run was."""
    per = ", ".join(
        f"c{c['client']}:{c['rows']}rows{c['label_hist']}"
        for c in manifest["clients"]
    )
    log.info(
        f"[DATA] partition {manifest['scheme']} (seed {manifest['seed']}"
        + (
            f", alpha {manifest['alpha']}"
            if manifest.get("alpha") is not None
            else ""
        )
        + f"): {manifest['assigned_rows']}/{manifest['total_rows']} rows -> "
        + per
    )


def save_manifest(manifest: dict, path: str) -> str:
    """Write the manifest JSON (atomic replace; reruns overwrite)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, path)
    return path
