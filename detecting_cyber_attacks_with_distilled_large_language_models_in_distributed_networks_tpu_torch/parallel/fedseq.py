"""Federated sequence-parallel training over a ``clients x data x seq``
mesh (the port of the JAX package's ``parallel/fedseq.py``).

Composes the federated axis (the stacked ``[C, ...]`` replicas, FedAvg
over clients, :mod:`.fedavg`) with sequence parallelism: client ``c``'s
lockstep batch ``[B, L]`` runs over its mesh row's ``data x seq`` block
of slots, rows split over ``data`` and positions over ``seq``, ring
attention across each data row's seq slots (the model's ring path,
``models/distilbert.py`` :class:`SeqContext`, and
:mod:`.ring_attention`).

The JAX package runs that as one ``shard_map`` program with a ``pmean``
over ``data``; here one process runs every chunk in lockstep and the
losses combine the data slots as the collectives do:

* dense: the mean over data slots of each slot's mean loss
  (:func:`dense_loss`, the ``pmean`` of the JAX loss);
* masked (ragged stacks): each slot's loss sum and valid-row count,
  added up over the slots before the divide (:func:`masked_loss`), so
  the mean is over the client's valid rows wherever they sit;
* evaluation: the counts over every row, the loss recomputed from the
  global masked mean (:func:`eval_client_counts`).

FedProx's term is added once per client (the params are replicated over
the slots). One backward of the sum of the clients' objectives gives
every client's gradient, as the dense federated step
(:mod:`..train.fedsteps`), whose update, gating and warmup the steps here
reuse. Dropout trains ON: every site's mask is hash-keyed on global
coordinates from seed words the client's generator draws once per site,
so the trajectory does not depend on how many seq (or data) slots there
are.

JAX's packed single-client step (``make_fedseq_packed_loss``, the
single-device speed path) has no counterpart: the port's dense steps
have no packed form either.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import torch
import torch.nn.functional as F

from ..models.distilbert import SeqContext
from ..train.engine import eval_counts
from ..train.fedsteps import FedAdamState, init_opt_state
from .fedavg import stack_params
from .mesh import Mesh, make_mesh


def make_seq_mesh(
    clients: int,
    data: int,
    seq: int,
    *,
    devices: list | None = None,
    axis_names: tuple[str, str, str] = ("clients", "data", "seq"),
    device: str | torch.device | None = None,
) -> Mesh:
    """A ``clients x data x seq`` mesh: :func:`.mesh.make_mesh` with the
    third (ring attention) axis."""
    return make_mesh(clients, data, seq=seq, devices=devices, axis_names=axis_names, device=device)


def client_contexts(mesh: Mesh, num_clients: int, clients: range) -> list[SeqContext]:
    """The seq context of each client in ``clients`` (global indices):
    its mesh row's ``data x seq`` block, the rows holding
    ``num_clients / rows`` clients each."""
    per = num_clients // int(mesh.devices.shape[0])
    return [SeqContext.from_grid(mesh.devices[c // per]) for c in clients]


def data_rows(batch: int, data: int) -> list[slice]:
    """Each data slot's rows of a ``[B, ...]`` client batch."""
    if batch % data:
        raise ValueError(f"batch of {batch} rows does not split over data={data}")
    per = batch // data
    return [slice(d * per, (d + 1) * per) for d in range(data)]


def dense_loss(logits: torch.Tensor, labels: torch.Tensor, data: int) -> torch.Tensor:
    """One client's loss on a dense batch: the mean over the data slots of
    each slot's mean softmax-CE (the JAX loss's ``pmean``)."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    means = [ce[p].mean() for p in data_rows(int(labels.shape[0]), data)]
    return sum(means[1:], means[0]) / float(data)


def masked_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, data: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One client's loss on a ragged batch and whether it had rows: the
    per-slot sums of the valid rows' CE and the per-slot counts, each
    added up over the slots, then one divide (0 with no valid row)."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    v = valid.to(torch.float32)
    parts = data_rows(int(labels.shape[0]), data)
    sums, counts = [(ce[p] * v[p]).sum() for p in parts], [v[p].sum() for p in parts]
    s_loss, s_cnt = sum(sums[1:], sums[0]), sum(counts[1:], counts[0])
    return s_loss / torch.clamp(s_cnt, min=1.0), (s_cnt > 0).to(torch.float32)


def eval_client_counts(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, data: int):
    """One client's eval statistics and scores: the counts over every data
    slot's rows, the batch loss recomputed from the global masked mean
    (per-slot sums added before the divide)."""
    loss, has = masked_loss(logits, labels, valid, data)
    counts, probs = eval_counts(logits, labels, valid)
    return counts._replace(loss_sum=loss * has, n_batches=has), probs


class FedSeqSteps(NamedTuple):
    """The lockstep steps over a ``clients x data x seq`` mesh: ``(trainer,
    state, batch, anchor) -> ([C] losses, [C] had-rows)``, dense and
    ragged (masked, idle clients gated, warmup on each client's own step
    count). They are :func:`..train.fedsteps.train_step` run through the
    sequence-parallel trainer's client hooks (:func:`dense_loss`,
    :func:`masked_loss`); evaluation runs the federated sweep through the
    same hooks (:func:`eval_client_counts`)."""

    train_step: Callable
    ragged_step: Callable


def build_fedseq_steps() -> FedSeqSteps:
    """The steps of a :class:`..train.seqfed.FedSeqTrainer`. The dispatch
    ledger notes the first dense lockstep step of each ``[C, B, L]`` shape
    under ``fedseq.train_step``, the JAX package's site; its ragged step
    has none there either."""
    from ..obs.profile import default_ledger
    from ..train.fedsteps import train_step

    timed = default_ledger().timed(
        "fedseq.train_step", train_step,
        signature=lambda trainer, state, batch, anchor=None: tuple(int(d) for d in batch["input_ids"].shape),
    )
    return FedSeqSteps(train_step=timed, ragged_step=train_step)


def init_fedseq_state(
    params: Mapping[str, torch.Tensor], num_clients: int, *, device: str | torch.device, accum_steps: int = 1
) -> tuple[dict[str, torch.Tensor], FedAdamState]:
    """Single-model ``params`` stacked into the ``[C, ...]`` layout on
    ``device`` (every client starts identical: the reference's shared
    pretrained start, client1.py:56), every leaf requiring grad, and zero
    Adam moments."""
    single = {n: torch.as_tensor(t).detach().to(device=device, dtype=torch.float32) for n, t in params.items()}
    stacked = {n: t.requires_grad_(True) for n, t in stack_params(single, num_clients).items()}
    return stacked, init_opt_state(stacked, num_clients, accum_steps)

