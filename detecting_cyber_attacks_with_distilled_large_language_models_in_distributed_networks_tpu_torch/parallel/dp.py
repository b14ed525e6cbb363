"""Differentially private FedAvg (DP-FedAvg) over the stacked ``[C, ...]``
params (the port of the JAX package's ``parallel/dp.py``).

The reference ships each client's raw fp32 state dict to the server
(reference client1.py:276-295): the aggregate leaks every client's exact
update, and it has no privacy mechanism of any kind. Here the round
boundary can run the Gaussian mechanism of DP-FedAvg (McMahan et al.,
"Learning Differentially Private Recurrent Language Models", 2018):

1. each client's round update ``delta_c = params_c - anchor`` is clipped to
   a global L2 norm of at most ``clip``;
2. the uniform mean over the ``n`` participating clients is taken;
3. Gaussian noise of std ``noise_multiplier * clip / n`` is added to the
   mean update before it is applied to the anchor.

Adjacency (what the reported epsilon means): zeroed-contribution with a
fixed divisor, sensitivity ``clip / n`` (McMahan et al.'s convention).
Under replace-one adjacency the sensitivity is ``2 * clip / n``; the
accountant reports both (:func:`dp_epsilon_both`).

The clip, mean and noise are plain torch on the device that holds the
aggregate, as they are plain XLA in the JAX package. The noise comes from
a ``torch.Generator`` on that device: JAX's threefry stream cannot be
reproduced, so the two packages agree on the noise's law, not its bits.

The accountant (:func:`sgm_rdp`, :func:`dp_epsilon`,
:func:`dp_epsilon_both`) is host math in float64, copied line for line so
that it gives the JAX package's numbers: RDP composition of the Gaussian
mechanism, and with ``sampling_rate < 1`` the subsampled-Gaussian bound at
integer orders (Mironov, Talwar & Zhang 2019), which assumes Poisson
sampling (``FedConfig.participation_mode="poisson"``, the default under
DP).
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Sequence

import numpy as np
import torch


def client_update_norms(
    stacked_params: Mapping[str, torch.Tensor], anchor: Mapping[str, torch.Tensor]
) -> torch.Tensor:
    """Per-client global L2 norm of ``params - anchor`` over every leaf,
    ``[C]``, computed in fp32 whatever the leaves' dtype."""
    sq = None
    for n, p in stacked_params.items():
        d = p.detach().to(torch.float32) - anchor[n].detach().to(torch.float32)
        part = torch.sum(torch.square(d.reshape(d.shape[0], -1)), dim=1)
        sq = part if sq is None else sq + part
    return torch.sqrt(sq)


@torch.no_grad()
def dp_fedavg(
    stacked_params: Mapping[str, torch.Tensor],
    anchor: Mapping[str, torch.Tensor],
    generator: torch.Generator | None,
    mask: np.ndarray | torch.Tensor | None,
    *,
    clip: float,
    noise_multiplier: float,
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Clipped mean plus noise.

    ``anchor``: the stacked round-start params (identical rows, the
    previous round's aggregate). Returns the single-model noised
    aggregate ``anchor + mean + noise``, cast to each leaf's dtype, and
    the ``[C]`` pre-clip update norms.

    Masked-out clients (``mask`` 0/1, ``[C]``) contribute nothing, and the
    mean's divisor and the noise std shrink to the survivor count.
    ``generator`` draws the noise on the leaves' device, leaf by leaf in
    the dict's order; it may be None only at ``noise_multiplier == 0``."""
    first = next(iter(stacked_params.values()))
    C, dev = int(first.shape[0]), first.device
    m = torch.ones(C, dtype=torch.float32, device=dev) if mask is None else torch.as_tensor(
        np.asarray(mask), dtype=torch.float32
    ).to(dev)
    n = torch.clamp(m.sum(), min=1.0)
    norms = client_update_norms(stacked_params, anchor)
    factor = torch.clamp(clip / torch.clamp(norms, min=1e-12), max=1.0) * m / n
    sigma = noise_multiplier * clip / n
    if noise_multiplier > 0.0 and generator is None:
        raise ValueError("dp_fedavg with noise needs a generator")
    out = {}
    for name, p in stacked_params.items():
        a32 = anchor[name].detach().to(torch.float32)
        d = p.detach().to(torch.float32) - a32
        mean = (d * factor.view(-1, *([1] * (d.ndim - 1)))).sum(0)
        res = a32[0] + mean
        if noise_multiplier > 0.0:
            res = res + sigma * torch.randn(mean.shape, generator=generator, device=dev, dtype=torch.float32)
        out[name] = res.to(p.dtype)
    return out, norms


def noise_seed(dp_seed: int | None) -> int:
    """The run's private noise seed: ``dp_seed`` when set (tests only: a
    known seed lets anyone subtract the noise), else fresh OS entropy (the
    training seed is public config, so noise derived from it could be
    regenerated)."""
    if dp_seed is not None:
        return int(dp_seed)
    return int.from_bytes(os.urandom(8), "little") >> 1


def round_generator(seed: int, round_index: int, device: torch.device) -> torch.Generator:
    """The noise generator of one round, on ``device``: the run's seed and
    the round mixed through numpy's SeedSequence, so rounds draw
    independent streams."""
    mixed = np.random.SeedSequence([int(seed), int(round_index)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) >> 1)


DEFAULT_RDP_ORDERS: tuple[float, ...] = tuple(
    [1.0 + x / 10.0 for x in range(1, 100)] + list(range(11, 512))
)


def sgm_rdp(alpha: int, q: float, sigma: float) -> float:
    """RDP of one subsampled-Gaussian-mechanism step at INTEGER order
    ``alpha >= 2`` (Mironov, Talwar & Zhang 2019):

        RDP(alpha) = log( sum_{k=0..alpha} C(alpha,k) (1-q)^(alpha-k) q^k
                          * exp(k (k-1) / (2 sigma^2)) ) / (alpha - 1)

    computed in log space (the exp terms overflow float64 near
    alpha ~ sigma * 50)."""
    if not (isinstance(alpha, int) or float(alpha).is_integer()) or alpha < 2:
        raise ValueError(f"sgm_rdp needs an integer order >= 2, got {alpha}")
    alpha = int(alpha)
    if not 0.0 < q <= 1.0:
        raise ValueError(f"sampling rate q={q} must be in (0, 1]")
    if q == 1.0:
        return alpha / (2.0 * sigma**2)
    log_terms = []
    log_q, log_1q = math.log(q), math.log1p(-q)
    for k in range(alpha + 1):
        log_terms.append(
            math.lgamma(alpha + 1)
            - math.lgamma(k + 1)
            - math.lgamma(alpha - k + 1)
            + (alpha - k) * log_1q
            + k * log_q
            + k * (k - 1) / (2.0 * sigma**2)
        )
    m = max(log_terms)
    log_sum = m + math.log(sum(math.exp(t - m) for t in log_terms))
    return log_sum / (alpha - 1)


def dp_epsilon(
    rounds: int,
    noise_multiplier: float,
    delta: float,
    orders: Sequence[float] = DEFAULT_RDP_ORDERS,
    *,
    sampling_rate: float = 1.0,
) -> float:
    """(epsilon, delta)-DP after ``rounds`` adaptive compositions by Renyi
    DP: the minimum over orders of ``R * RDP(alpha) + log(1/delta) /
    (alpha - 1)``. The full-participation Gaussian bound holds at every
    real order (and stays valid under subsampling); with
    ``sampling_rate < 1`` the subsampled-Gaussian bound at integer orders
    >= 2 (:func:`sgm_rdp`) competes with it. A client-level guarantee:
    the clipped unit is one client's whole round update."""
    if rounds < 0:
        raise ValueError(f"rounds={rounds} must be >= 0")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta={delta} must be in (0, 1)")
    if not 0.0 < sampling_rate <= 1.0:
        raise ValueError(f"sampling_rate={sampling_rate} must be in (0, 1]")
    if noise_multiplier <= 0.0:
        return math.inf
    if rounds == 0:
        return 0.0
    log_delta_inv = math.log(1.0 / delta)
    best = math.inf
    for a in orders:
        if a <= 1.0:
            continue
        eps = rounds * a / (2.0 * noise_multiplier**2) + log_delta_inv / (a - 1.0)
        best = min(best, eps)
    if sampling_rate == 1.0:
        return best
    for a in orders:
        if a < 2.0 or not float(a).is_integer():
            continue
        eps = rounds * sgm_rdp(int(a), sampling_rate, noise_multiplier)
        eps += log_delta_inv / (a - 1.0)
        best = min(best, eps)
    return best


def dp_epsilon_both(
    rounds: int,
    noise_multiplier: float,
    delta: float,
    *,
    sampling_rate: float = 1.0,
) -> tuple[float, float]:
    """Epsilon under both adjacency notions, same mechanism and noise:
    zeroed-contribution (sensitivity ``clip/n``, :func:`dp_epsilon`'s)
    and replace-one (sensitivity ``2*clip/n``: an effective noise
    multiplier of ``noise_multiplier / 2``)."""
    return (
        dp_epsilon(rounds, noise_multiplier, delta, sampling_rate=sampling_rate),
        dp_epsilon(rounds, noise_multiplier / 2.0, delta, sampling_rate=sampling_rate),
    )
