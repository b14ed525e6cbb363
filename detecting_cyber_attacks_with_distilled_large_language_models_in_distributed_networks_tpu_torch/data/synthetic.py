"""Synthetic CICIDS2017-style flow generator (the port's copy).

The same generator as the JAX package's ``data/synthetic.py``
(``make_synthetic_flows``): separable BENIGN vs DDoS populations with a
sprinkle of ±inf and NaN, drawn from one ``np.random.default_rng(seed)``
in the same order, so both packages build the same flows from one seed.
Without pandas, a frame is a dict of equal-length numpy columns in the
CSV's column order (see :mod:`.cicids`).
"""

from __future__ import annotations

import numpy as np

#: Schema filler after the 10 rendered columns (kept for loader parity).
_EXTRA_COLUMNS: tuple[str, ...] = (
    "Fwd Packet Length Mean",
    "Fwd Packet Length Std",
    "Bwd Packet Length Max",
    "Bwd Packet Length Min",
    "Flow IAT Mean",
    "Flow IAT Std",
)


def make_synthetic_flows(
    n_rows: int = 2000,
    ddos_fraction: float = 0.5,
    seed: int = 0,
    inf_fraction: float = 0.01,
    nan_fraction: float = 0.01,
) -> dict[str, np.ndarray]:
    """A separable BENIGN/DDoS flow table as ``{column: array}``, rows
    shuffled, with ±inf and NaN in the float columns."""
    rng = np.random.default_rng(seed)
    n_ddos = int(n_rows * ddos_fraction)
    n_benign = n_rows - n_ddos

    def _mix(benign_sampler, ddos_sampler):
        return np.concatenate([benign_sampler(n_benign), ddos_sampler(n_ddos)])

    cols: dict[str, np.ndarray] = {}
    cols["Destination Port"] = _mix(
        lambda n: rng.choice([53, 443, 8080, 22, 3389], size=n),
        lambda n: rng.choice([80, 443], size=n),
    ).astype(np.int64)
    cols["Flow Duration"] = _mix(
        lambda n: rng.integers(1_000, 10_000_000, size=n),
        lambda n: rng.integers(1, 5_000, size=n),
    ).astype(np.int64)
    cols["Total Fwd Packets"] = _mix(
        lambda n: rng.integers(1, 30, size=n),
        lambda n: rng.integers(100, 2_000, size=n),
    ).astype(np.int64)
    cols["Total Backward Packets"] = _mix(
        lambda n: rng.integers(1, 30, size=n),
        lambda n: rng.integers(0, 3, size=n),
    ).astype(np.int64)
    cols["Total Length of Fwd Packets"] = _mix(
        lambda n: rng.integers(0, 5_000, size=n),
        lambda n: rng.integers(50_000, 500_000, size=n),
    ).astype(np.int64)
    cols["Total Length of Bwd Packets"] = _mix(
        lambda n: rng.integers(0, 5_000, size=n),
        lambda n: rng.integers(0, 200, size=n),
    ).astype(np.int64)
    cols["Fwd Packet Length Max"] = _mix(
        lambda n: rng.integers(0, 1_500, size=n),
        lambda n: rng.integers(1_000, 1_500, size=n),
    ).astype(np.int64)
    cols["Fwd Packet Length Min"] = _mix(
        lambda n: rng.integers(0, 100, size=n),
        lambda n: rng.integers(500, 1_000, size=n),
    ).astype(np.int64)
    cols["Flow Bytes/s"] = np.round(
        _mix(
            lambda n: rng.uniform(10, 1e5, size=n),
            lambda n: rng.uniform(1e6, 5e7, size=n),
        ),
        4,
    )
    cols["Flow Packets/s"] = np.round(
        _mix(
            lambda n: rng.uniform(0.1, 1e3, size=n),
            lambda n: rng.uniform(1e4, 1e6, size=n),
        ),
        4,
    )
    for name in _EXTRA_COLUMNS:
        cols[name] = np.round(rng.uniform(0, 1_000, size=n_rows), 4)

    labels = np.array(["BENIGN"] * n_benign + ["DDoS"] * n_ddos)

    # Inject ±inf / NaN into float columns only (imputation targets).
    float_cols = ["Flow Bytes/s", "Flow Packets/s", *list(_EXTRA_COLUMNS)]
    for name in float_cols:
        arr = cols[name].astype(np.float64)
        bad = rng.random(n_rows)
        arr[bad < inf_fraction] = np.inf
        arr[(bad >= inf_fraction) & (bad < inf_fraction + nan_fraction)] = np.nan
        cols[name] = arr

    cols["Label"] = labels
    # Shuffle rows so class blocks don't align with sampling order.
    perm = rng.permutation(n_rows)
    return {name: col[perm] for name, col in cols.items()}
