"""Meshed local training for the separate-process TCP client (the port of
the JAX package's ``train/client_mesh.py``).

``client --data-parallel N`` trains the local phase over N device slots of
this process (:func:`..parallel.mesh.make_host_mesh`) instead of one:

* :class:`MeshTrainer` — one replica per slot. Each step refreshes the
  other slots' replicas from the first slot's params, splits the batch
  rows over the slots, runs each slot's forward and backward on its rows
  and sums the per-slot gradients onto the first slot in slot order
  (deterministic), where the optimizer applies them. A batch whose rows
  do not split evenly (the final short batch) runs whole on the first
  slot, so its math is the single-device engine's. Params agree with the
  single-device client to fp32 reduction-order ulps (the per-slot partial
  sums round differently from one reduction).
* :class:`FsdpMeshTrainer` (``--fsdp``) — params and Adam moments split at
  rest per leaf over the slots (:class:`..parallel.mesh.ShardedLeaf`,
  along :func:`..parallel.mesh.fsdp_dim`). Each slot gathers the full
  params at use, runs its rows' forward and backward and drops the
  gathered copy; the full gradients are summed in slot order into each
  shard on its own slot (a reduce-scatter), the clip norm is taken over
  every shard, and Adam runs shard-local. Per-slot static bytes scale
  ~1/N.

Dropout: the first slot draws from the state's generator, slot k >= 1
from a stream of its own seeded from the run seed and k, so a meshed
trajectory with dropout on is not the single-device one (the JAX package
states the same of its non-threefry PRNGs); the held-against comparisons
run with dropout off. Evaluation runs on the first slot with the full
params (gathered once under FSDP), the single-device engine's sweep.

The wire tier is untouched: ``host_params`` gives the JAX-layout tree
(leaf by leaf, gathered off the shards when read under FSDP), and
``reply_leaf_sink`` places each decoded reply leaf onto the mesh as its
bytes land (comm/client.py), so secure aggregation and central DP compose
unchanged.

``client --seq-parallel M`` (with ``--data-parallel N``) trains with
:class:`FedSeqClientTrainer`: the C=1 sequence-parallel federated trainer
(:class:`.seqfed.FedSeqTrainer`) over an ``N x M`` block of this
process's slots behind the same surface. Its trajectory is the fedseq
one (hash-keyed dropout, the federated batch order), the same at any
``M``, not the single-device engine's.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Mapping

import numpy as np
import torch

from ..config import ExperimentConfig, ModelConfig, TrainConfig
from ..device import resolve_device
from ..models.convert import flatten_tree, params_from_jax, params_to_jax, port_key
from ..models.distilbert import init_params, model_skeleton
from ..parallel.mesh import (
    Mesh,
    ShardedLeaf,
    axis_slots,
    device_tree_bytes,
    fsdp_dim,
    gather_tree,
    make_host_mesh,
    shard_tree,
    slot_copy,
)
from .engine import AdamState, Trainer, TrainState, adam_update, prox_sq

log = logging.getLogger(__name__)


def _placed(leaf: Any) -> bool:
    return isinstance(leaf, (torch.Tensor, ShardedLeaf))


def port_params(tree: Mapping[str, Any]) -> dict[str, Any]:
    """A port state dict from a received aggregate: a JAX-layout tree
    whose leaves are host arrays, or leaves ``reply_leaf_sink`` already
    placed (port layout, on the mesh); a port state dict passes through."""
    if tree and all(_placed(v) for v in tree.values()):
        return dict(tree)
    out: dict[str, Any] = {}
    for path, leaf in flatten_tree(tree).items():
        if _placed(leaf):
            out[port_key(path)[0]] = leaf
        else:
            out.update(params_from_jax({path: leaf}))
    return out


def _wire_leaf(key: str, arr: np.ndarray) -> torch.Tensor:
    """One decoded reply leaf (JAX layout) as the port's leaf, on the host."""
    _, transpose = port_key(key)
    t = torch.from_numpy(np.array(arr, np.float32))  # a writable copy of the wire buffer's view
    return t.transpose(-1, -2) if transpose else t


def _slot_seed(seed: int, slot: int) -> int:
    return (seed + 1) * 7_919 + slot


class MeshTrainer(Trainer):
    """The single-client engine over a per-process ``data`` mesh axis:
    one replica per slot, batch rows over the slots, per-slot gradients
    summed in slot order onto the first slot (see the module docstring)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        *,
        mesh: Mesh,
        pad_id: int = 0,
        drop_remainder: bool = True,
    ):
        self.mesh = mesh
        self.slots = [resolve_device(s) for s in axis_slots(mesh, "data")]
        super().__init__(model_cfg, train_cfg, pad_id=pad_id, drop_remainder=drop_remainder, device=self.slots[0])
        self.n_slots = len(self.slots)
        self._replicas: dict[int, dict[str, torch.Tensor]] = {}
        self._slot_generators: dict[int, torch.Generator] = {}

    # ------------------------------------------------------------ state
    def wire_params(self, tree: Mapping[str, Any]) -> dict[str, Any]:
        return port_params(tree)

    def init_state(self, seed: int | None = None, params=None) -> TrainState:
        """The engine's state on the first slot (also the aggregate
        adoption path), with fresh dropout streams for the other slots."""
        state = super().init_state(seed=seed, params=params)
        seed = self.train_cfg.seed if seed is None else seed
        self._slot_generators = {
            k: torch.Generator(device=s).manual_seed(_slot_seed(seed, k)) for k, s in enumerate(self.slots) if k
        }
        return state

    def _replica(self, state: TrainState, k: int) -> dict[str, torch.Tensor]:
        """Slot k's replica, refreshed from the first slot's params (a
        copy into buffers of its own: slots sharing a device never alias)."""
        rep = self._replicas.get(k)
        if rep is None or rep.keys() != state.params.keys():
            rep = self._replicas[k] = {
                n: slot_copy(t.detach(), self.slots[k]).requires_grad_(t.requires_grad)
                for n, t in state.params.items()
            }
        else:
            with torch.no_grad():
                for n, t in state.params.items():
                    rep[n].copy_(t.detach())
        return rep

    def _generator(self, state: TrainState, k: int) -> torch.Generator:
        if k == 0:
            return state.generator
        g = self._slot_generators.get(k)
        if g is None:
            g = self._slot_generators[k] = torch.Generator(device=self.slots[k]).manual_seed(
                _slot_seed(self.train_cfg.seed, k)
            )
        return g

    # ------------------------------------------------------------ steps
    @staticmethod
    def _host_batch(batch: dict) -> tuple[torch.Tensor, ...]:
        return tuple(
            batch[k] if isinstance(batch[k], torch.Tensor) else torch.from_numpy(np.ascontiguousarray(batch[k]))
            for k in ("input_ids", "attention_mask", "labels")
        )

    def _row_parts(self, rows: int) -> list[slice]:
        """Each slot's rows of a batch; one part on the first slot when the
        rows do not split evenly."""
        n = self.n_slots
        if n == 1 or rows % n:
            return [slice(0, rows)]
        per = rows // n
        return [slice(k * per, (k + 1) * per) for k in range(n)]

    def _slot_loss(self, params, k: int, generator, ids, mask, labels, frac: float) -> torch.Tensor:
        slot = self.slots[k]
        ids, mask, labels = (t.to(slot) for t in (ids, mask, labels))
        logits = self._logits(params, ids, mask, generator=generator)
        loss = self._loss(logits, ids, mask, labels)
        return loss if frac == 1.0 else loss * frac

    def _train_step(self, state: TrainState, batch: dict, anchor=None) -> tuple[TrainState, torch.Tensor]:
        ids, mask, labels = self._host_batch(batch)
        names = list(state.opt_state.mu)
        B = int(labels.shape[0])
        grads: list[torch.Tensor] | None = None
        total = None
        for k, rows in enumerate(self._row_parts(B)):
            params = state.params if k == 0 else self._replica(state, k)
            loss = self._slot_loss(
                params, k, self._generator(state, k), ids[rows], mask[rows], labels[rows], (rows.stop - rows.start) / B
            )
            obj = loss
            if anchor is not None and k == 0:
                mu = float(self.train_cfg.prox_mu)
                obj = loss + 0.5 * mu * prox_sq([params[n] for n in names], [anchor[n] for n in names])
            g = torch.autograd.grad(obj, [params[n] for n in names])
            # Slot order: the first slot's gradient, plus each later one.
            grads = list(g) if grads is None else [a + b.to(self.device) for a, b in zip(grads, g)]
            total = loss.detach() if total is None else total + loss.detach().to(self.device)
        with torch.no_grad():
            self._update(state, names, grads)
        state.step += 1
        return state, total

    # ------------------------------------------------------------ wire
    def reply_leaf_sink(self, key: str, arr: np.ndarray) -> torch.Tensor:
        """Streamed-reply leaf placement (comm/client.py): one decoded
        aggregate leaf onto the first slot, in the port's layout, the
        moment its bytes land (the replicas take it at the next step's
        refresh). Placement only: bit-identical to the host-tree path."""
        return slot_copy(_wire_leaf(key, arr), self.device)


class FsdpMeshTrainer(MeshTrainer):
    """FSDP shard-at-rest over the per-process ``data`` slots
    (``client --data-parallel N --fsdp``): params and Adam moments split
    per leaf over the slots, gathered at use, gradients summed into each
    shard on its own slot (see the module docstring)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        *,
        mesh: Mesh,
        pad_id: int = 0,
        drop_remainder: bool = True,
    ):
        super().__init__(model_cfg, train_cfg, mesh=mesh, pad_id=pad_id, drop_remainder=drop_remainder)
        self.n_shards = self.n_slots

    # ------------------------------------------------------------ placement
    def leaf_sharding(self, shape) -> tuple:
        """The shard-at-rest layout of one leaf: ``(dim, slots)``, a pure
        function of its shape (:func:`..parallel.mesh.fsdp_dim`)."""
        return fsdp_dim(tuple(int(d) for d in shape), self.n_shards), tuple(self.slots)

    def place_state_tree(self, tree: Mapping[str, Any]) -> dict[str, ShardedLeaf]:
        """A port state dict split onto its per-leaf shards as fp32 (copies;
        a leaf already sharded passes through)."""
        return shard_tree(tree, self.mesh, dtype=torch.float32)

    def init_state(self, seed: int | None = None, params=None) -> TrainState:
        """The engine's state shard-at-rest: ``params`` (a port state
        dict, host or placed leaves) or a seeded init, split onto the
        slots; zero moments on the same shards; the dropout generators as
        the replicated mesh's. Also the aggregate-adoption path: a reply
        leaf the sink already placed is copied shard to shard."""
        seed = self.train_cfg.seed if seed is None else seed
        if params is None:
            params = init_params(self.model_cfg, torch.Generator().manual_seed(seed))
        shapes = {k: tuple(t.shape) for k, t in model_skeleton(self.model_cfg).state_dict().items()}
        got = {k: tuple(int(d) for d in t.shape) for k, t in params.items()}
        if got != shapes:
            raise KeyError(f"state dict keys or shapes differ from the model's: {sorted(set(got.items()) ^ set(shapes.items()))[:4]}")
        trainable = self.train_cfg.trainable
        # The model's key order, as the one-device state's; a leaf the reply
        # sink placed is copied, so the state never aliases its input.
        placed = self.place_state_tree({n: params[n] for n in shapes})
        leaves = {
            n: (leaf.clone() if leaf is params[n] else leaf).requires_grad_(
                trainable == "all" or n.startswith("classifier.")
            )
            for n, leaf in placed.items()
        }
        names = [n for n, t in leaves.items() if t.requires_grad]
        opt = AdamState(0, {n: leaves[n].zeros_like() for n in names}, {n: leaves[n].zeros_like() for n in names})
        acc = {n: leaves[n].zeros_like() for n in names} if self.train_cfg.grad_accum_steps > 1 else None
        self._slot_generators = {
            k: torch.Generator(device=s).manual_seed(_slot_seed(seed, k)) for k, s in enumerate(self.slots) if k
        }
        state = TrainState(leaves, opt, 0, torch.Generator(device=self.device).manual_seed(seed + 1), acc)
        self._note_static_bytes(state)
        return state

    def _note_static_bytes(self, state: TrainState) -> None:
        """The per-slot static-state gauge (``fedtpu_fsdp_static_state_bytes``):
        bytes of params + optimizer state on the first slot."""
        from ..obs.metrics import default_registry

        # fedtpu: allow(obs-metric-once): the JAX package's train/client_mesh.py family, per-slot bytes of the port's shards
        default_registry().gauge(
            "fedtpu_fsdp_static_state_bytes",
            help="per-device bytes of FSDP shard-at-rest params + optimizer state",
        ).set(float(device_tree_bytes((state.params, state.opt_state))))

    # ------------------------------------------------------------ steps
    def _train_step(self, state: TrainState, batch: dict, anchor=None) -> tuple[TrainState, torch.Tensor]:
        ids, mask, labels = self._host_batch(batch)
        names = list(state.opt_state.mu)
        B = int(labels.shape[0])
        # One gradient buffer per shard, on the shard's slot.
        shard_grads: dict[str, list[torch.Tensor | None]] = {n: [None] * len(state.params[n].shards) for n in names}
        total = None
        for k, rows in enumerate(self._row_parts(B)):
            slot = self.slots[k]
            full = gather_tree(state.params, slot)  # gathered at use, dropped after the backward
            for n in names:
                full[n].requires_grad_(True)
            loss = self._slot_loss(
                full, k, self._generator(state, k), ids[rows], mask[rows], labels[rows], (rows.stop - rows.start) / B
            )
            obj = loss
            if anchor is not None and k == 0:
                mu = float(self.train_cfg.prox_mu)
                obj = loss + 0.5 * mu * prox_sq([full[n] for n in names], [anchor[n].gather(slot) for n in names])
            g = torch.autograd.grad(obj, [full[n] for n in names])
            del full
            with torch.no_grad():
                for n, gn in zip(names, g):
                    leaf = state.params[n]
                    for j, (part, dest) in enumerate(zip(leaf.parts(gn), leaf.slots)):
                        acc = shard_grads[n][j]
                        # Slot order: slot 0's part, plus each later slot's.
                        shard_grads[n][j] = slot_copy(part, dest) if acc is None else acc + part.to(dest)
            total = loss.detach().to(self.device) if total is None else total + loss.detach().to(self.device)
        with torch.no_grad():
            self._update_shards(state, names, shard_grads)
        state.step += 1
        return state, total

    def _update_shards(self, state: TrainState, names: list[str], grads: dict[str, list[torch.Tensor]]) -> None:
        """The engine's update (accumulation window, then clip -> Adam),
        shard by shard: the clip norm is taken over every shard, and each
        slot's shards update on that slot."""
        k = self.train_cfg.grad_accum_steps
        flat_g = [g for n in names for g in grads[n]]
        if k > 1:
            acc = [s for n in names for s in state.acc[n].shards]
            torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(flat_g, acc), float(state.mini_step + 1)))
            if state.mini_step < k - 1:
                state.mini_step += 1
                return
            flat_g = acc
        count = state.opt_state.count + 1
        params = [s for n in names for s in state.params[n].shards]
        mus = [s for n in names for s in state.opt_state.mu[n].shards]
        nus = [s for n in names for s in state.opt_state.nu[n].shards]
        g_norm = None
        if self.train_cfg.max_grad_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g).to(self.device) for g in flat_g))
        for slot in dict.fromkeys(p.device for p in params):
            idx = [i for i, p in enumerate(params) if p.device == slot]
            adam_update(
                self.train_cfg,
                [params[i] for i in idx], [mus[i] for i in idx], [nus[i] for i in idx], [flat_g[i] for i in idx],
                count, state.step, g_norm=None if g_norm is None else g_norm.to(slot),
            )
        state.opt_state = AdamState(count, state.opt_state.mu, state.opt_state.nu)
        if k > 1:
            torch._foreach_zero_(flat_g)
            state.mini_step = 0

    def evaluate(self, params: Mapping[str, Any], split, *, batch_size: int = 16) -> dict:
        """Metrics on the first slot with the full params, gathered once
        before the sweep; ``params`` may be a state's sharded leaves or a
        received aggregate."""
        if any(isinstance(v, Mapping) for v in params.values()):
            params = port_params(params)
        if any(isinstance(v, ShardedLeaf) for v in params.values()):
            params = gather_tree(params, self.device)
        return super().evaluate(params, split, batch_size=batch_size)

    def reply_leaf_sink(self, key: str, arr: np.ndarray) -> ShardedLeaf:
        """Streamed-reply leaf placement: one decoded aggregate leaf split
        straight onto its shards the moment its bytes land (never a full
        copy per slot). Placement only: bit-identical to the host path."""
        return ShardedLeaf.scatter(_wire_leaf(key, arr), self.slots)


class FedSeqClientTrainer:
    """The C=1 :class:`.seqfed.FedSeqTrainer` behind the TCP client's
    single-client surface (``fit``, ``evaluate``, ``evaluate_state``,
    ``host_params``, ``adopt_aggregate``, ``prefetch_epoch``).

    A fleet of one reuses the sequence-parallel federated trainer whole:
    the state is its stacked ``[1, ...]`` FedState. The round loop feeds
    the same split objects every round, so the dense ``[1, N, ...]`` train
    stack and the padded eval stack are cached on the split's identity
    (one entry each)."""

    def __init__(self, cfg: ExperimentConfig, *, pad_id: int = 0, device: str | torch.device | None = None):
        from ..parallel.fedseq import make_seq_mesh
        from .seqfed import FedSeqTrainer

        self.cfg = dataclasses.replace(
            cfg,
            fed=dataclasses.replace(cfg.fed, num_clients=1),
            mesh=dataclasses.replace(cfg.mesh, clients=1),
        )
        self.mesh = make_seq_mesh(1, cfg.mesh.data, cfg.mesh.seq, device=device)
        self.inner = FedSeqTrainer(self.cfg, pad_id=pad_id, device=device, mesh=self.mesh)
        self.device = self.inner.device
        self.pad_id = pad_id
        self._train_cache: tuple[Any, Any] | None = None
        self._eval_cache: tuple[Any, int, Any] | None = None

    def init_state(self, seed: int | None = None, params=None):
        """The inner trainer's ``[1, ...]`` state from ``params`` (a port
        state dict, or a received JAX-layout aggregate) or a seeded init."""
        if params is not None:
            params = port_params(params)
        return self.inner.init_state(seed=seed, params=params)

    def _stacked(self, split):
        from ..data.pipeline import stack_clients

        if self._train_cache is None or self._train_cache[0] is not split:
            self._train_cache = (split, stack_clients([split]))
        return self._train_cache[1]

    def fit(self, state, split, *, batch_size: int = 16, epochs: int | None = None, epoch_offset: int = 0,
            tag: str = ""):
        """E local epochs over the dense ``[1, N, ...]`` stack; returns the
        state and the engine-shaped per-epoch loss list."""
        state, losses = self.inner.fit_local(
            state, self._stacked(split), batch_size=batch_size, epochs=epochs, epoch_offset=epoch_offset
        )
        return state, [float(e[0]) for e in losses]

    def evaluate(self, params: Mapping[str, Any], split, *, batch_size: int | None = None) -> dict:
        """The reference metrics of unstacked ``params`` (a received
        aggregate, either layout), through the stacked eval sweep."""
        from ..parallel.fedavg import stack_params

        single = {n: torch.as_tensor(t).to(self.device) for n, t in port_params(params).items()}
        return self._evaluate_stacked(stack_params(single, 1), split, batch_size=batch_size)

    def evaluate_state(self, state, split, *, batch_size: int | None = None) -> dict:
        """Metrics of the live (stacked) state."""
        return self._evaluate_stacked(state.params, split, batch_size=batch_size)

    def _evaluate_stacked(self, stacked, split, *, batch_size: int | None) -> dict:
        # The default is resolved before the cache key, so the round
        # loop's local and aggregated evaluations share one entry.
        if batch_size is None:
            batch_size = self.cfg.data.eval_batch_size
        cache = self._eval_cache
        if cache is None or cache[0] is not split or cache[1] != batch_size:
            cache = self._eval_cache = (split, batch_size, self.inner.prepare_eval([split], batch_size=batch_size))
        return self.inner.evaluate_clients(stacked, prepared=cache[2], collect_probs=True)[0]

    def prefetch_epoch(self, split, epoch: int, batch_size: int):
        """Arm the inner trainer's epoch prefetch for the cached stack of
        ``split`` (what ``fit`` trains on)."""
        return self.inner.prefetch_epoch(self._stacked(split), epoch, batch_size)

    def step_profile_attrs(self) -> dict:
        prof = self.inner.step_profiler
        return prof.span_attrs() if prof is not None else {}

    def host_params(self, state, *, lazy: bool = False) -> dict:
        """The one replica's params as the JAX-layout tree of host arrays
        (the upload form)."""
        return params_to_jax({n: t[0] for n, t in state.params.items()}, lazy=lazy)

    def adopt_aggregate(self, state, aggregated: Mapping[str, Any]):
        """Fresh Adam from the received aggregate, the step counter
        continuing (the engine's adoption semantics)."""
        new = self.init_state(params=aggregated)
        new.step = state.step
        return new


def make_client_trainer(
    cfg: ExperimentConfig, *, pad_id: int = 0, device: str | torch.device | None = None
) -> Trainer | FedSeqClientTrainer:
    """The TCP client's local-phase trainer for the resolved mesh config:
    the plain engine (``data`` 1), the meshed engine (``data`` N) or its
    FSDP form (``--fsdp``), or the C=1 sequence-parallel trainer (``seq``
    M > 1), over ``device``'s slots (the cards, or CPU slots for
    ``cpu``)."""
    data = cfg.mesh.data
    if data > 1 and cfg.data.batch_size % data:
        raise ValueError(
            f"batch_size={cfg.data.batch_size} must divide over "
            f"--data-parallel {data} (row shards)"
        )
    kw = dict(pad_id=pad_id, drop_remainder=cfg.data.drop_remainder)
    if cfg.mesh.fsdp:
        return FsdpMeshTrainer(cfg.model, cfg.train, mesh=make_host_mesh(data, device=device), **kw)
    if cfg.mesh.seq > 1:
        # (FedSeqTrainer validates max_len % seq; make_mesh the slots.)
        return FedSeqClientTrainer(cfg, pad_id=pad_id, device=device)
    if data > 1:
        return MeshTrainer(cfg.model, cfg.train, mesh=make_host_mesh(data, device=device), **kw)
    return Trainer(cfg.model, cfg.train, device=device, **kw)
