"""Multi-process federation: the ``torch.distributed`` bootstrap, the
global mesh and the per-process client block (the port of the JAX
package's ``parallel/multihost.py``).

The reference's multi-node story is three processes on one laptop joined
by hand-rolled TCP (reference client1.py:276-336, server.py:116-137). The
JAX package replaces it with ``jax.distributed``; the port with
``torch.distributed``: every process calls :func:`initialize` with the
coordinator's ``HOST:PORT``, the process count and its id, and the
processes rendezvous on a TCP store at that address (the store
``init_method="tcp://HOST:PORT"`` would build, built here first so the
backend can be chosen from every rank's device before the group exists).

Backend, chosen once from the rank-to-device map and logged: NCCL when
every process has a card of its own; gloo when processes share a card
(NCCL refuses two ranks on one card: "Duplicate GPU detected") or run on
the CPU. An NCCL error is never caught to retry on gloo. Under gloo every
collective here stages its tensors through the host (``.cpu()`` before,
back to the tensor's device after): gloo's CUDA support does not cover
every collective, and one path for all of them keeps the bytes the same.

Topology: :func:`make_global_mesh` lays the ``clients`` axis
process-major, so each process holds a contiguous block of client
replicas (:func:`local_client_slice`); the FedAvg mean crosses processes
once a round (:func:`global_rows`). A single process degrades to the
ordinary mesh: every function here is then a no-op wrapper, so the
federated trainer has one code path.
"""

from __future__ import annotations

import logging
import os
import socket
from datetime import timedelta
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Mesh, local_devices, make_mesh

log = logging.getLogger(__name__)

#: Seconds the rendezvous and every collective may wait for a peer.
DEFAULT_TIMEOUT_S = 300.0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def backend() -> str | None:
    """The process group's backend ("gloo" | "nccl"), None without one."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def local_device(device: str | torch.device | None, process_id: int) -> torch.device:
    """The device process ``process_id`` trains on: the CPU, or card
    ``process_id % device_count`` of its host (processes beyond the card
    count share cards)."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    return torch.device("cuda", process_id % torch.cuda.device_count())


def choose_backend(rank_devices: list[str]) -> tuple[str, str]:
    """``(backend, reason)`` from every rank's ``host|device``: gloo when
    any rank runs on the CPU or two ranks share a card, else NCCL."""
    devices = [d.split("|", 1)[1] for d in rank_devices]
    if any(d.startswith("cpu") for d in devices):
        return "gloo", "processes run on the CPU"
    if len(set(rank_devices)) < len(rank_devices):
        shared = sorted({d for d in rank_devices if rank_devices.count(d) > 1})
        return "gloo", (
            f"processes share a card ({', '.join(shared)}): NCCL refuses two "
            "ranks on one card, so NCCL goes unexercised here"
        )
    return "nccl", "every process has a card of its own"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the process group; returns whether more than one process is
    active afterwards.

    Env fallbacks (the JAX package's names, so one launcher serves both):
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``.
    Nothing configured, or ``num_processes`` 1 without a coordinator, is
    the single-process case: no-op, returns False. A partial configuration
    raises: nothing here autodetects a cluster, and falling back to a
    single process would hide a typo'd launch."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if dist.is_initialized():
        return dist.get_world_size() > 1
    configured = coordinator_address is not None or num_processes is not None or process_id is not None
    if not configured:
        return False
    if num_processes == 1 and coordinator_address is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "multi-process runs need the coordinator HOST:PORT, the process "
            "count and this process's id together "
            f"(got coordinator={coordinator_address!r}, num_processes="
            f"{num_processes!r}, process_id={process_id!r})"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} outside [0, {num_processes})")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator_address!r} is not HOST:PORT")
    timeout = timedelta(seconds=float(timeout_s))
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0, timeout=timeout)
    dev = local_device(device, process_id)
    store.set(f"fedtpu/device/{process_id}", f"{socket.gethostname()}|{dev}")
    rank_devices = [store.get(f"fedtpu/device/{r}").decode() for r in range(num_processes)]
    chosen, reason = choose_backend(rank_devices)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    log.info(
        f"[MESH] process {process_id}/{num_processes} on {dev}: backend "
        f"{chosen} ({reason})"
    )
    dist.init_process_group(chosen, store=store, rank=process_id, world_size=num_processes, timeout=timeout)
    return num_processes > 1


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """This process's slots: under a process group, the slots of its own
    device (:func:`local_device`); else :func:`..mesh.local_devices`."""
    if process_count() == 1:
        return local_devices(device)
    return local_devices(local_device(device, process_index()))


def make_global_mesh(
    clients: int = 1,
    data: int = 1,
    *,
    axis_names: tuple[str, str] = ("clients", "data"),
    device: str | torch.device | None = None,
) -> Mesh:
    """``clients x data`` mesh over every process's slots, clients-major by
    process: client c's ``data`` slots live entirely on process
    ``c // (clients / process_count)``. Requires ``clients`` to be a
    multiple of the process count. Single process: :func:`..mesh.make_mesh`."""
    if process_count() == 1:
        return make_mesh(clients, data, axis_names=axis_names, device=device)
    devices, procs = _global_grid((clients, data), device)
    return Mesh(devices, axis_names, procs)


def _global_grid(dims: tuple[int, ...], device: str | torch.device | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Process-major slot grid (and its owner grid) for a clients-leading
    global mesh: each process contributes ``prod(dims) / P`` of its own
    slots, so a client's trailing-axes block lives on one process and only
    the clients-axis mean crosses processes."""
    P = process_count()
    clients = dims[0]
    shape = "x".join(map(str, dims))
    if clients % P:
        raise ValueError(
            f"clients={clients} must be a multiple of process_count={P} so "
            "each process owns whole client replicas (within-client axes "
            "stay in-process; only FedAvg crosses processes)"
        )
    need = int(np.prod(dims))
    per_process = need // P
    mine = process_devices(device)
    if len(mine) < per_process:
        raise ValueError(
            f"global mesh {shape} needs {per_process} slots on each of {P} "
            f"processes, process {process_index()} has {len(mine)}"
        )
    everyone = all_gather_objects([str(d) for d in mine[:per_process]])
    flat = np.empty(need, dtype=object)
    flat[:] = [torch.device(d) for slots in everyone for d in slots]
    procs = np.repeat(np.arange(P, dtype=np.int64), per_process)
    grid, owners = flat.reshape(dims), procs.reshape(dims)
    for c in range(clients):
        block = set(np.asarray(owners[c]).reshape(-1).tolist())
        if len(block) != 1:
            raise ValueError(
                f"client {c}'s within-client slot block spans processes "
                f"{sorted(block)}; each client must stay in one process"
            )
    return grid, owners


def make_global_seq_mesh(
    clients: int,
    data: int,
    seq: int,
    *,
    axis_names: tuple[str, str, str] = ("clients", "data", "seq"),
    device: str | torch.device | None = None,
) -> Mesh:
    """The ``clients x data x seq`` mesh over every process's slots,
    clients process-major: each process owns whole client replicas, so
    every client's seq ring and data-slot sum stay in-process and only
    the round's mean crosses processes (:class:`..train.seqfed.FedSeqTrainer`)."""
    if process_count() == 1:
        return make_mesh(clients, data, seq=seq, axis_names=axis_names, device=device)
    devices, procs = _global_grid((clients, data, seq), device)
    return Mesh(devices, axis_names, procs)


def local_client_slice(mesh: Mesh) -> slice:
    """Which block of the ``[C, ...]`` client axis this process feeds: one
    contiguous slice under the process-major layout. Works for any mesh
    whose first axis is ``clients``."""
    C = mesh.devices.shape[0]
    lead = mesh.processes.reshape(C, -1)[:, 0]
    mine = [c for c, p in enumerate(lead.tolist()) if p == process_index()]
    if not mine:  # a process holding no client rows feeds nothing
        return slice(0, 0)
    lo, hi = mine[0], mine[-1] + 1
    if mine != list(range(lo, hi)):
        raise ValueError("client axis is not process-contiguous; build the mesh with make_global_mesh")
    return slice(lo, hi)


# ------------------------------------------------------------ collectives
def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can take it: on the host under gloo (the
    staging named in the module docstring), on this process's card under
    NCCL."""
    return t.detach().to(_collective_device()).contiguous()


def global_rows(rows: Any, num_clients: int) -> Any:
    """The full ``[C, ...]`` array from every process's block ``[C_local,
    ...]`` (its :func:`local_client_slice` rows), in process-major order =
    the global client order: a numpy array for numpy input, a tensor on
    the input's device for a tensor. Single process: the block itself."""
    if process_count() == 1:
        if int(rows.shape[0]) != num_clients:
            raise ValueError(f"{int(rows.shape[0])} rows for {num_clients} clients")
        return rows
    as_numpy = not isinstance(rows, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(rows)) if as_numpy else rows
    src = _staged(t)
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    out = torch.cat(parts)
    if int(out.shape[0]) != num_clients:
        raise ValueError(f"{int(out.shape[0])} gathered rows for {num_clients} clients")
    return out.numpy() if as_numpy else out.to(t.device)


def global_batch(local: Mapping[str, Any], num_clients: int) -> dict[str, Any]:
    """:func:`global_rows` of every entry of a ``[C_local, ...]`` batch."""
    return {k: global_rows(v, num_clients) for k, v in local.items()}


def allgather_hosts(value: int) -> np.ndarray:
    """Every process's value of a host int scalar, as an int64 array.

    The primitive for cross-process agreement (batch counts, eval row
    counts, the DP noise seed): every process must call it at the same
    program point. Single process: the value alone, no collective."""
    if process_count() == 1:
        return np.asarray([value], np.int64)
    t = _staged(torch.tensor([int(value)], dtype=torch.int64))
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy().astype(np.int64)


def all_gather_objects(obj: Any) -> list[Any]:
    """Every process's picklable ``obj``, in process order (``[obj]``
    alone in a single process)."""
    if process_count() == 1:
        return [obj]
    out: list[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def global_array_from_replicated(value: Any) -> Any:
    """A value every process holds in full (the shared initial params,
    reference client1.py:56), made identical everywhere by process 0's
    broadcast; single process: the value itself."""
    if process_count() == 1:
        return value
    if isinstance(value, torch.Tensor):
        src = _staged(value).clone()
        dist.broadcast(src, 0)
        return src.to(value.device)
    box = [value]
    dist.broadcast_object_list(box, 0)
    return box[0]


def _collective_device() -> torch.device:
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
