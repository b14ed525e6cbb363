"""Synthetic flow generators (the port's copy).

The same generators as the JAX package's ``data/synthetic.py``: separable
benign and attack populations with a sprinkle of ±inf and NaN, for the
CICIDS2017 schema (``make_synthetic_flows``), the CIC-DDoS2019 one
(``make_synthetic_ddos2019``: the same columns, per-attack labels) and
UNSW-NB15 (``make_synthetic_unsw``). Each draws from
``np.random.default_rng`` in the JAX generator's order, so both packages
build the same rows from one seed. Without pandas, a frame is a dict of
equal-length numpy columns in the CSV's column order (see
:mod:`.cicids`); string columns hold numpy strings, or Python objects
where labels of unequal lengths are mixed.
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


#: CIC-DDoS2019 attack-class label vocabulary (a subset of the real set).
DDOS2019_ATTACKS: tuple[str, ...] = (
    "DrDoS_DNS",
    "DrDoS_LDAP",
    "DrDoS_NTP",
    "DrDoS_UDP",
    "Syn",
    "UDP-lag",
)


def make_synthetic_ddos2019(
    n_rows: int = 2000,
    attack_fraction: float = 0.5,
    seed: int = 0,
    **kwargs,
) -> dict[str, np.ndarray]:
    """A CIC-DDoS2019-style frame: the CICIDS2017 schema with one of
    DDOS2019_ATTACKS on every attack row, drawn from ``seed + 1``."""
    frame = make_synthetic_flows(n_rows, ddos_fraction=attack_fraction, seed=seed, **kwargs)
    rng = np.random.default_rng(seed + 1)
    attack = frame["Label"] == "DDoS"
    labels = frame["Label"].astype(object)
    labels[attack] = rng.choice(DDOS2019_ATTACKS, size=int(attack.sum()))
    frame["Label"] = labels
    return frame


def make_synthetic_unsw(
    n_rows: int = 2000,
    attack_fraction: float = 0.5,
    seed: int = 0,
    inf_fraction: float = 0.01,
    nan_fraction: float = 0.01,
) -> dict[str, np.ndarray]:
    """A UNSW-NB15-style frame: separable normal and attack populations
    over the 10 templated columns (data/datasets.py UNSW_TEMPLATE), filler
    columns, and the official ``attack_cat`` / ``label`` tail."""
    rng = np.random.default_rng(seed)
    n_attack = int(n_rows * attack_fraction)
    n_normal = n_rows - n_attack

    def _mix(normal_sampler, attack_sampler):
        return np.concatenate([normal_sampler(n_normal), attack_sampler(n_attack)])

    cols: dict[str, np.ndarray] = {}
    cols["dur"] = np.round(
        _mix(
            lambda n: rng.uniform(0.05, 30.0, size=n),
            lambda n: rng.uniform(1e-4, 0.02, size=n),
        ),
        6,
    )
    cols["proto"] = _mix(
        lambda n: rng.choice(["tcp", "udp", "arp"], size=n),
        lambda n: rng.choice(["tcp", "udp"], size=n),
    )
    cols["service"] = _mix(
        lambda n: rng.choice(["http", "dns", "smtp", "-"], size=n),
        lambda n: rng.choice(["dns", "-"], size=n),
    )
    cols["spkts"] = _mix(
        lambda n: rng.integers(2, 40, size=n),
        lambda n: rng.integers(100, 4_000, size=n),
    ).astype(np.int64)
    cols["dpkts"] = _mix(
        lambda n: rng.integers(2, 40, size=n),
        lambda n: rng.integers(0, 3, size=n),
    ).astype(np.int64)
    cols["sbytes"] = _mix(
        lambda n: rng.integers(100, 10_000, size=n),
        lambda n: rng.integers(50_000, 1_000_000, size=n),
    ).astype(np.int64)
    cols["dbytes"] = _mix(
        lambda n: rng.integers(100, 10_000, size=n),
        lambda n: rng.integers(0, 500, size=n),
    ).astype(np.int64)
    cols["rate"] = np.round(
        _mix(
            lambda n: rng.uniform(0.5, 500.0, size=n),
            lambda n: rng.uniform(5e4, 1e6, size=n),
        ),
        4,
    )
    cols["sload"] = np.round(
        _mix(
            lambda n: rng.uniform(1e2, 1e6, size=n),
            lambda n: rng.uniform(1e8, 5e9, size=n),
        ),
        4,
    )
    cols["dload"] = np.round(
        _mix(
            lambda n: rng.uniform(1e2, 1e6, size=n),
            lambda n: rng.uniform(0, 1e3, size=n),
        ),
        4,
    )
    # Schema-filler tail columns from the official feature list.
    for name in ("sttl", "dttl", "sloss", "dloss"):
        cols[name] = rng.integers(0, 255, size=n_rows).astype(np.int64)
    for name in ("sinpkt", "dinpkt", "sjit", "djit"):
        arr = np.round(rng.uniform(0, 1_000, size=n_rows), 4)
        bad = rng.random(n_rows)
        arr[bad < inf_fraction] = np.inf
        arr[(bad >= inf_fraction) & (bad < inf_fraction + nan_fraction)] = np.nan
        cols[name] = arr

    cols["attack_cat"] = _mix(
        lambda n: np.array(["Normal"] * n),
        lambda n: rng.choice(["Generic", "Exploits", "DoS", "Fuzzers"], size=n),
    )
    cols["label"] = np.concatenate(
        [np.zeros(n_normal, np.int64), np.ones(n_attack, np.int64)]
    )
    perm = rng.permutation(n_rows)
    return {name: col[perm] for name, col in cols.items()}


_GENERATORS = {
    "cicids2017": make_synthetic_flows,
    "cicddos2019": make_synthetic_ddos2019,
    "unswnb15": make_synthetic_unsw,
}


def make_synthetic(dataset: str, n_rows: int = 2000, **kwargs) -> dict[str, np.ndarray]:
    """The generator of a registered dataset's schema."""
    try:
        gen = _GENERATORS[dataset]
    except KeyError:
        raise ValueError(
            f"no synthetic generator for dataset {dataset!r}; "
            f"have {sorted(_GENERATORS)}"
        ) from None
    return gen(n_rows, **kwargs)
