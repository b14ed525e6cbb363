"""Device meshes for the port (the port of the JAX package's
``parallel/mesh.py``).

JAX runs one controller per process over that process's local devices and
lays a ``jax.sharding.Mesh`` over them. The port mirrors that in PyTorch's
idiom: a :class:`Mesh` is a numpy grid of explicit ``torch.device`` slots
under the JAX axis names, with the process that owns each slot:

* ``clients`` — federated replicas; the FedAvg mean rides this axis (within
  a process it is the stacked ``[C, ...]`` leading axis, across processes
  one ``torch.distributed`` collective a round, :mod:`.multihost`);
* ``data`` — per-client batch parallelism: one replica per slot, batch rows
  split over the slots, per-slot gradients summed in slot order
  (:mod:`..train.client_mesh`).

Two slots may name the same device (the tests put every slot on the CPU;
one card can hold two slots). ``t.to(device)`` onto the device a tensor
already lives on returns the same storage, so every placement onto a slot
here copies explicitly (:func:`slot_copy`): slots never write into each
other.

FSDP keeps each leaf split at rest along :func:`fsdp_dim` (a pure
function of the shape, copied from the JAX package) as a
:class:`ShardedLeaf`, shard ``k`` on slot ``k``, and gathers it at use
(:meth:`ShardedLeaf.gather`): the counterparts of ``fsdp_tree_shardings``
and ``fsdp_gather_program``. A gather is byte-exact (a concatenation of
copies), so a gathered leaf is the full leaf bit for bit, in the same
dtype and a contiguous layout. JAX's ``shard_map`` compatibility binding
has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from ..device import resolve_device

#: CPU slots a process offers when its mesh runs on the CPU (tests): the
#: JAX tests' eight virtual CPU devices.
CPU_SLOTS = 8


def local_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """This process's device slots: every card for ``cuda`` (the default;
    raises without CUDA, as :func:`..device.resolve_device` does), or
    :data:`CPU_SLOTS` slots on the CPU for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * CPU_SLOTS
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def slot_copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` with storage of its own,
    also when ``t`` already lives there (``to`` would alias it); no
    autograd history."""
    out = torch.empty(tuple(t.shape), dtype=t.dtype, device=device)
    out.copy_(t.detach())
    return out


class Mesh:
    """A grid of device slots under named axes.

    ``devices``: an object ndarray of ``torch.device``; ``processes``: an
    int ndarray of the same shape, the process that owns each slot (all 0
    in a single process). ``shape`` maps axis name -> size, as JAX's."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...], processes: np.ndarray | None = None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh grid {devices.shape} does not match axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = (
            np.zeros(devices.shape, np.int64) if processes is None else np.asarray(processes, np.int64)
        )
        if self.processes.shape != devices.shape:
            raise ValueError("mesh processes grid must match its device grid")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, (int(d) for d in self.devices.shape)))

    def slots(self) -> list[torch.device]:
        """Every slot, row-major (a host mesh's ``data`` axis in order)."""
        return list(self.devices.reshape(-1))

    def _key(self) -> tuple:
        return (tuple(str(d) for d in self.devices.reshape(-1)), self.devices.shape, self.axis_names,
                tuple(self.processes.reshape(-1).tolist()))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({axes}; {', '.join(str(d) for d in self.slots())})"


def make_mesh(
    clients: int = 1,
    data: int = 1,
    *,
    seq: int | None = None,
    devices: list | None = None,
    axis_names: tuple[str, ...] | None = None,
    device: str | torch.device | None = None,
) -> Mesh:
    """A ``clients x data`` mesh over the first ``clients*data`` slots of
    ``devices`` (default: :func:`local_devices` of ``device``); ``seq``
    adds the third axis (ring attention, :mod:`.fedseq`)."""
    dims = (clients, data) if seq is None else (clients, data, seq)
    if axis_names is None:
        axis_names = ("clients", "data", "seq")[: len(dims)]
    devs = list(local_devices(device) if devices is None else devices)
    need = int(np.prod(dims))
    if len(devs) < need:
        raise ValueError(
            f"mesh {'x'.join(map(str, dims))} needs {need} devices, have {len(devs)}"
        )
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return Mesh(grid.reshape(dims), axis_names)


def make_host_mesh(
    data: int = 1,
    *,
    seq: int | None = None,
    devices: list | None = None,
    device: str | torch.device | None = None,
) -> Mesh:
    """A single-process ``data`` (or ``data x seq``) mesh over this
    process's local slots: the TCP client's and the sharded scorer's view
    of their own devices (``client --data-parallel N``). No ``clients``
    axis: federation happens over the wire."""
    if data < 1 or (seq is not None and seq < 1):
        raise ValueError(f"host mesh axes must be >= 1 (data={data}, seq={seq})")
    devs = list(local_devices(device) if devices is None else devices)
    dims = (data,) if seq is None else (data, seq)
    need = data * (seq or 1)
    if len(devs) < need:
        raise ValueError(
            f"host mesh {'x'.join(map(str, dims))} needs {need} local "
            f"devices, have {len(devs)}"
        )
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return Mesh(grid.reshape(dims), ("data",) if seq is None else ("data", "seq"))


def fit_clients_axis(num_clients: int, data: int, n_devices: int) -> int:
    """Largest clients-axis size that (a) divides the logical client count
    (several replicas may stack per mesh row) and (b) fits the hardware
    alongside the ``data`` axis. Raises when even one row doesn't fit."""
    rows = max(
        (r for r in range(1, num_clients + 1) if num_clients % r == 0 and r * data <= n_devices),
        default=None,
    )
    if rows is None:
        raise ValueError(f"mesh data axis {data} alone exceeds the {n_devices} available devices")
    return rows


@dataclass(frozen=True)
class FedShardings:
    """Which rows and which slots hold what on a ``clients x data`` mesh
    (the counterpart of the JAX package's three shardings): client
    replicas stack over the mesh rows, a client's batch rows split over
    its row's ``data`` slots, and a replicated value sits on every slot."""

    mesh: Mesh

    def client_rows(self, num_clients: int) -> list[range]:
        """Per mesh row, the clients it holds (``[C, ...]`` over ``clients``)."""
        rows = int(self.mesh.devices.shape[0])
        per = num_clients // rows
        return [range(r * per, (r + 1) * per) for r in range(rows)]

    def row_slots(self, row: int) -> list[torch.device]:
        """The ``data`` slots of one mesh row (its clients' batch shards)."""
        return list(np.asarray(self.mesh.devices[row]).reshape(-1))

    def batch_rows(self, batch: int) -> list[slice]:
        """Per ``data`` slot, its rows of a ``[B, ...]`` batch (``B`` divides)."""
        n = int(self.mesh.shape["data"])
        if batch % n:
            raise ValueError(f"batch of {batch} rows does not split over data={n}")
        per = batch // n
        return [slice(s * per, (s + 1) * per) for s in range(n)]

    def replicated(self) -> list[torch.device]:
        return self.mesh.slots()


# ---------------------------------------------------------------- FSDP specs
def fsdp_dim(shape: tuple[int, ...], n_shards: int) -> int | None:
    """The dimension index FSDP shards ``shape`` over ``n_shards``, or
    None when the leaf stays whole (scalar, or no dimension divides the
    axis). Deterministic and a pure function of (shape, n_shards), so the
    wire tier places a decoded reply leaf onto its shards
    (``reply_leaf_sink``) without a negotiated layout. Largest divisible
    dimension wins (most bytes saved per shard); ties break to the lowest
    index."""
    if n_shards <= 1:
        return None
    best: int | None = None
    for i, d in enumerate(shape):
        if d % n_shards:
            continue
        if best is None or d > shape[best]:
            best = i
    return best


def fsdp_spec(shape: tuple[int, ...], n_shards: int, *, axis: str = "data") -> tuple:
    """Per-leaf FSDP spec in ``PartitionSpec`` form (a tuple naming the
    axis at the sharded dimension, None elsewhere; ``()`` = whole)."""
    dim = fsdp_dim(tuple(int(d) for d in shape), n_shards)
    if dim is None:
        return ()
    spec: list = [None] * len(shape)
    spec[dim] = axis
    return tuple(spec)


def _memory_order(t: torch.Tensor) -> tuple[int, ...]:
    """``t``'s dimensions from outermost to innermost in memory when ``t``
    is a permuted view of contiguous storage (a transposed kernel), else
    the identity."""
    ident = tuple(range(t.ndim))
    if t.ndim < 2 or t.is_contiguous():
        return ident
    perm = tuple(sorted(ident, key=lambda d: -t.stride(d)))
    return perm if t.permute(perm).is_contiguous() else ident


class ShardedLeaf:
    """One leaf at rest over a mesh's ``data`` slots: split along ``dim``
    with shard ``k`` on slot ``k``, or (``dim`` None: a scalar or a leaf no
    dimension of which divides the slot count) whole on the first slot.

    The shards keep the source's memory layout (``perm``, its dimensions'
    order in memory): a gathered leaf has the source's strides as well as
    its bytes, so the kernels after the gather are the ones the source
    would run (a transposed weight picks other GEMM variants, which round
    differently). ``gather(device)`` gives the full leaf on one device;
    ``shape``/``ndim``/``dtype`` are the full leaf's."""

    __slots__ = ("shards", "dim", "slots", "shape", "dtype", "perm")

    def __init__(
        self, shards: list[torch.Tensor], dim: int | None, slots: list[torch.device], shape: tuple[int, ...],
        perm: tuple[int, ...],
    ):
        self.shards = shards
        self.dim = dim
        self.slots = slots
        self.shape = torch.Size(shape)
        self.dtype = shards[0].dtype
        self.perm = perm

    @classmethod
    def scatter(cls, t: torch.Tensor, slots: list[torch.device], *, dtype: torch.dtype | None = None) -> "ShardedLeaf":
        """Split ``t`` over ``slots`` along :func:`fsdp_dim` (copies: the
        leaf never aliases ``t``)."""
        t = t.detach()
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        shape = tuple(int(d) for d in t.shape)
        dim = fsdp_dim(shape, len(slots))
        used = [slots[0]] if dim is None else list(slots)
        proto = cls([t], dim, used, shape, _memory_order(t))
        return cls([slot_copy(p, s) for p, s in zip(proto.parts(t), used)], dim, used, shape, proto.perm)

    def parts(self, full: torch.Tensor) -> list[torch.Tensor]:
        """Views of ``full`` (the whole leaf, any layout) shaped as this
        leaf's shards, one per shard."""
        base = full.permute(self.perm)
        if self.dim is None:
            return [base]
        mdim = self.perm.index(self.dim)
        size = int(self.shape[self.dim]) // len(self.slots)
        return [base.narrow(mdim, k * size, size) for k in range(len(self.slots))]

    def like(self, t: torch.Tensor) -> "ShardedLeaf":
        """``t`` (the full leaf) split onto this leaf's layout."""
        if tuple(t.shape) != tuple(self.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit the sharded leaf {tuple(self.shape)}")
        shards = [slot_copy(p.to(self.dtype), s) for p, s in zip(self.parts(t), self.slots)]
        return ShardedLeaf(shards, self.dim, list(self.slots), tuple(self.shape), self.perm)

    def zeros_like(self) -> "ShardedLeaf":
        return ShardedLeaf([torch.zeros_like(s) for s in self.shards], self.dim, list(self.slots), tuple(self.shape), self.perm)

    def clone(self) -> "ShardedLeaf":
        return ShardedLeaf([s.detach().clone() for s in self.shards], self.dim, list(self.slots), tuple(self.shape), self.perm)

    def gather(self, device: str | torch.device) -> torch.Tensor:
        """The full leaf on ``device``: new storage, never a view of a
        shard, in the source's dtype and memory layout."""
        device = torch.device(device)
        if self.dim is None:
            base = slot_copy(self.shards[0], device)
        else:
            base = torch.cat([s.detach().to(device) for s in self.shards], dim=self.perm.index(self.dim))
        inverse = [0] * len(self.perm)
        for i, d in enumerate(self.perm):
            inverse[d] = i
        return base.permute(inverse)

    def detach(self) -> "ShardedLeaf":
        return self

    @property
    def device(self) -> torch.device:
        """The first slot (where a whole leaf lives)."""
        return self.slots[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def requires_grad(self) -> bool:
        return self.shards[0].requires_grad

    def requires_grad_(self, flag: bool = True) -> "ShardedLeaf":
        for s in self.shards:
            s.requires_grad_(flag)
        return self

    def shard_bytes(self) -> int:
        """Bytes this leaf holds on its first slot."""
        return int(self.shards[0].numel() * self.shards[0].element_size())

    def __repr__(self) -> str:
        return f"ShardedLeaf(shape={tuple(self.shape)}, dim={self.dim}, shards={len(self.shards)})"


def axis_slots(mesh: Mesh, axis: str = "data") -> list[torch.device]:
    """The slots along ``axis`` (at index 0 of every other axis): a host
    mesh's ``data`` slots in order."""
    idx: list = [0] * mesh.devices.ndim
    idx[mesh.axis_names.index(axis)] = slice(None)
    return list(mesh.devices[tuple(idx)])


def shard_tree(
    tree: Mapping[str, Any], mesh: Mesh, *, axis: str = "data", dtype: torch.dtype | None = None
) -> dict[str, ShardedLeaf]:
    """Every leaf of a flat state dict split at rest over ``mesh``'s
    ``axis`` slots (the counterpart of ``fsdp_tree_shardings``), cast to
    ``dtype`` when given; a leaf already sharded passes through."""
    slots = axis_slots(mesh, axis)
    return {
        n: t if isinstance(t, ShardedLeaf) else ShardedLeaf.scatter(torch.as_tensor(t), slots, dtype=dtype)
        for n, t in tree.items()
    }


def gather_tree(tree: Mapping[str, Any], device: str | torch.device) -> dict[str, torch.Tensor]:
    """Every sharded leaf gathered onto ``device`` (the counterpart of
    ``fsdp_gather_program``); a plain tensor is copied there."""
    out = {}
    for n, t in tree.items():
        out[n] = t.gather(device) if isinstance(t, ShardedLeaf) else slot_copy(t.detach(), torch.device(device))
    return out


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, (torch.Tensor, ShardedLeaf)):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().values()
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def device_tree_bytes(tree: Any) -> int:
    """Bytes ``tree``'s leaves occupy on ONE slot (the first): a sharded
    leaf counts its first shard, a plain tensor its full size (every slot
    holding the tree holds a copy). Exact, from the tensors' sizes, so it
    works on CPU slots as on the card."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, ShardedLeaf):
            total += leaf.shard_bytes()
        else:
            total += int(leaf.numel() * leaf.element_size())
    return total
