"""Server aggregation strategies over flat numpy param dicts (the port of
the JAX package's ``strategies/core.py``).

Contract
--------
A strategy never touches the fold: ``comm/stream_agg.py`` keeps folding
raw leaves in ascending-id order into the bit-exact weighted mean. At
finalize the server calls::

    new_global = strategy.apply(prev_global, mean, round_no=r, client_stats=stats)

with ``prev_global`` the previous post-strategy global (None on the first
round), ``mean`` the folded mean and ``client_stats`` the per-client fold
stats of ``StreamAgg.client_stats()`` (telemetry only). ``apply`` is a
pure function of ``(prev_global, mean)``, so a replay fed the same means
reproduces the live global.

FedOpt strategies treat the round's mean as a pseudo-gradient ``g = prev -
mean`` and step a persistent server optimizer over it: the port's
``parallel/fedavg.ServerOptimizer`` (optax's order of operations), on the
server's device. At server_lr=1 with no momentum a step is the mean.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.fedavg import ServerOptimizer

__all__ = [
    "STRATEGIES",
    "Strategy",
    "FedAvg",
    "FedProx",
    "Momentum",
    "FedOpt",
    "HeadBoost",
    "parse_strategy",
    "make_strategy",
]

Flat = dict[str, np.ndarray]


class Strategy:
    """Base: a stateful per-server object applied once per round."""

    name: str = ""

    def params(self) -> dict[str, Any]:
        """Hyperparameters for the reply's strategy stamp."""
        return {}

    def client_mu(self) -> float:
        """Proximal weight advertised to clients (FedProx); 0 = none."""
        return 0.0

    def reset(self) -> None:
        """Drop optimizer state (the model's shape changed)."""

    def describe(self) -> dict[str, Any]:
        return {"name": self.name, "params": self.params()}

    def export_state(self) -> "list[np.ndarray] | None":
        """Optimizer-state leaves for the server's state file; None =
        stateless."""
        return None

    def restore_state(self, leaves: "list[np.ndarray]", template_params: Flat) -> bool:
        """Rebuild optimizer state from exported leaves against the
        restored global. False = the leaves do not fit (start fresh)."""
        return False

    def apply(
        self,
        prev: Flat | None,
        mean: Flat,
        *,
        round_no: int = 0,
        client_stats: dict[int, dict[str, float]] | None = None,
    ) -> Flat:
        raise NotImplementedError


def _compatible(prev: Flat | None, mean: Flat) -> bool:
    """prev is usable as the round anchor: same keys, same shapes."""
    if prev is None:
        return False
    if sorted(prev) != sorted(mean):
        return False
    return all(np.shape(prev[k]) == np.shape(mean[k]) for k in sorted(mean))


class FedAvg(Strategy):
    """Identity on the folded mean: the plain fold, bit for bit."""

    name = "fedavg"

    def apply(self, prev, mean, *, round_no=0, client_stats=None):
        return mean


class FedProx(Strategy):
    """Server-side identity; the proximal term ``mu/2 · ||w - w_round_start||²``
    lives in the CLIENT's loss (``TrainConfig.prox_mu``). The strategy
    carries ``mu`` so the reply's stamp advertises it."""

    name = "fedprox"

    def __init__(self, mu: float = 0.01):
        if mu <= 0.0:
            raise ValueError(f"fedprox mu={mu} must be > 0")
        self.mu = float(mu)

    def params(self):
        return {"mu": self.mu}

    def client_mu(self):
        return self.mu

    def apply(self, prev, mean, *, round_no=0, client_stats=None):
        return mean


class _ServerOptStrategy(Strategy):
    """Shared FedOpt machinery: ``g = prev - mean``, ``new = prev +
    opt(g)``, with the optimizer state kept across rounds. It lives on
    ``device`` (the server's; None means the card)."""

    device: torch.device | None = None

    def __init__(self, server_opt: str, lr: float, momentum: float = 0.9):
        if lr <= 0.0:
            raise ValueError(f"{self.name} lr={lr} must be > 0")
        if not 0.0 <= momentum < 1.0:
            raise ValueError(f"{self.name} momentum={momentum} must be in [0, 1)")
        self.lr = float(lr)
        self.momentum = float(momentum)
        self._opt = ServerOptimizer(server_opt, self.lr, self.momentum)
        self._opt_state: dict | None = None

    def _tensors(self, flat, keys) -> dict[str, torch.Tensor]:
        dev = resolve_device(self.device)
        return {k: torch.tensor(np.asarray(flat[k], np.float32), device=dev) for k in keys}

    def reset(self):
        self._opt_state = None

    def _leaf_groups(self, state: dict) -> list:
        """The state's leaves in the JAX package's (optax) tree order:
        adam/yogi ``[count, mu..., nu...]``, momentum ``[trace...]``, each
        group in sorted key order."""
        if self._opt.kind == "momentum":
            return [state["trace"]]
        return [state["count"], state["mu"], state["nu"]]

    def export_state(self):
        if self._opt_state is None:
            return None
        out: list[np.ndarray] = []
        for group in self._leaf_groups(self._opt_state):
            if isinstance(group, dict):
                out += [group[k].cpu().numpy() for k in sorted(group)]
            else:
                out.append(np.asarray(group, np.int32))
        return out

    def restore_state(self, leaves, template_params):
        keys = sorted(template_params)
        template = self._opt.init(self._tensors(template_params, keys))
        shapes = []
        for group in self._leaf_groups(template):
            shapes += [tuple(group[k].shape) for k in keys] if isinstance(group, dict) else [()]
        if len(leaves) != len(shapes) or any(np.shape(a) != s for a, s in zip(leaves, shapes)):
            return False
        it = iter(leaves)
        dev = resolve_device(self.device)
        state = {}
        for name, group in zip(template, self._leaf_groups(template)):
            if isinstance(group, dict):
                state[name] = {k: torch.tensor(np.asarray(next(it), np.float32), device=dev) for k in keys}
            else:
                state[name] = int(np.asarray(next(it)))
        self._opt_state = state
        return True

    @torch.no_grad()
    def apply(self, prev, mean, *, round_no=0, client_stats=None):
        if not _compatible(prev, mean):
            # First round, or the model changed: the mean IS the new
            # global and the optimizer restarts.
            self.reset()
            return mean
        keys = sorted(mean)
        prev32 = self._tensors(prev, keys)
        grad = {k: prev32[k] - m for k, m in self._tensors(mean, keys).items()}
        if self._opt_state is None:
            self._opt_state = self._opt.init(prev32)
        updates, self._opt_state = self._opt.update(grad, self._opt_state)
        return {k: (prev32[k] + updates[k]).cpu().numpy() for k in keys}


class Momentum(_ServerOptStrategy):
    """FedAvgM: heavy-ball memory over round updates (Hsu et al.)."""

    name = "momentum"

    def __init__(self, lr: float = 1.0, momentum: float = 0.9):
        super().__init__("momentum", lr, momentum)

    def params(self):
        return {"lr": self.lr, "momentum": self.momentum}


class FedOpt(_ServerOptStrategy):
    """FedAdam / FedYogi: adaptive per-parameter server steps."""

    name = "fedopt"

    def __init__(self, opt: str = "adam", lr: float = 0.1):
        opt = str(opt)
        if opt not in ("adam", "yogi"):
            raise ValueError(f"fedopt opt={opt!r} must be adam|yogi")
        self.opt = opt
        super().__init__(opt, lr)

    def params(self):
        return {"opt": self.opt, "lr": self.lr}


class HeadBoost(Strategy):
    """TurboSVM-style head boost (arXiv:2401.12012, adapted): the leaves
    whose key holds ``match`` take ``prev + gamma · (mean - prev)``, every
    other leaf the plain mean. Exact FedAvg without a previous global."""

    name = "headboost"

    def __init__(self, gamma: float = 1.5, match: str = "classifier"):
        if gamma <= 0.0:
            raise ValueError(f"headboost gamma={gamma} must be > 0")
        if not match:
            raise ValueError("headboost match pattern must be non-empty")
        self.gamma = float(gamma)
        self.match = str(match)

    def params(self):
        return {"gamma": self.gamma, "match": self.match}

    def apply(self, prev, mean, *, round_no=0, client_stats=None):
        if not _compatible(prev, mean):
            return mean
        out: Flat = {}
        for k in sorted(mean):
            m = np.asarray(mean[k], np.float32)
            if self.match in k:
                p = np.asarray(prev[k], np.float32)
                out[k] = np.asarray(p + self.gamma * (m - p), np.float32)
            else:
                out[k] = m
        return out


STRATEGIES: dict[str, type[Strategy]] = {
    FedAvg.name: FedAvg,
    FedProx.name: FedProx,
    Momentum.name: Momentum,
    FedOpt.name: FedOpt,
    HeadBoost.name: HeadBoost,
}


def parse_strategy(spec: str) -> tuple[str, dict[str, Any]]:
    """``"name:key=val,key=val"`` -> (name, kwargs); a value parses as a
    float when it looks like one (``fedopt:opt=yogi,lr=0.05``)."""
    spec = str(spec).strip()
    name, _, rest = spec.partition(":")
    name = name.strip()
    if name not in STRATEGIES:
        raise ValueError(f"unknown strategy {name!r} (choose from {'|'.join(sorted(STRATEGIES))})")
    kwargs: dict[str, Any] = {}
    if rest.strip():
        for item in rest.split(","):
            key, sep, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if not key or not sep or not val:
                raise ValueError(
                    f"bad strategy param {item!r} in {spec!r} (want key=value[,key=value...])"
                )
            try:
                kwargs[key] = float(val)
            except ValueError:
                kwargs[key] = val
    return name, kwargs


def make_strategy(
    spec: "str | Strategy | None", *, device: str | torch.device | None = None
) -> Strategy:
    """A Strategy from a spec string (None -> fedavg); a FedOpt or
    momentum strategy steps its optimizer on ``device`` (None: the card)."""
    if spec is None:
        return FedAvg()
    if isinstance(spec, Strategy):
        return spec
    name, kwargs = parse_strategy(spec)
    try:
        strat = STRATEGIES[name](**kwargs)
    except TypeError as exc:
        raise ValueError(f"strategy {name!r} rejected params {sorted(kwargs)}: {exc}") from None
    if isinstance(strat, _ServerOptStrategy):
        strat.device = None if device is None else torch.device(device)
    return strat
