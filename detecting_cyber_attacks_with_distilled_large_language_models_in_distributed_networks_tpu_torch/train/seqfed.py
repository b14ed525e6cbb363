"""FedSeqTrainer: the federated trainer over a ``clients x data x seq``
mesh (the port of the JAX package's ``train/seqfed.py``): local training
with ring attention over each client's seq slots, behind the whole
:class:`.federated.FederatedTrainer` surface.

Every feature around the trainer (evaluation and the metrics CSVs,
checkpoint and resume, DP-FedAvg, FedOpt, FedProx, personalization, whose
scope-matched side trainer is this class again, partial participation,
fault masks) runs through the inherited code; only the per-client hooks
differ (:mod:`..parallel.fedseq`). Under a process group the clients lay
process-major over the processes
(:func:`..parallel.multihost.make_global_seq_mesh`), so every ring and
every data-slot sum stays inside one process and only the round's mean
crosses processes.

Dropout trains ON: masks are hash-keyed on global coordinates, so the
trajectory does not depend on the seq (or data) slot count
(:mod:`..ops.hash_dropout`).
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from ..parallel import multihost
from ..parallel.fedseq import build_fedseq_steps, client_contexts, dense_loss, eval_client_counts, make_seq_mesh, masked_loss
from ..parallel.mesh import Mesh, fit_clients_axis
from .federated import FederatedTrainer

log = logging.getLogger(__name__)


class FedSeqTrainer(FederatedTrainer):
    """N clients x batch slots x sequence slots, each client's chunks in
    lockstep in this process."""

    splits_rows = True

    def __init__(
        self,
        cfg: ExperimentConfig,
        *,
        pad_id: int = 0,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        # seq=1 runs the same program on a ring of one chunk: the anchor of
        # the slot-count invariance tests. The CLI runs the dense trainer
        # at seq 1.
        if cfg.mesh.seq < 1:
            raise ValueError("FedSeqTrainer needs mesh.seq >= 1")
        if cfg.model.attention_impl != "ring" or cfg.model.ring_axis != "seq":
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, attention_impl="ring", ring_axis="seq")
            )
        if cfg.model.max_len % cfg.mesh.seq:
            raise ValueError(
                f"model.max_len={cfg.model.max_len} must divide into "
                f"mesh.seq={cfg.mesh.seq} equal sequence chunks"
            )
        device = resolve_device(device)
        if mesh is None:
            mesh = self._seq_mesh(cfg, device)
        nproc = multihost.process_count()
        log.info(
            f"[FEDSEQ] mesh {mesh.devices.shape[0]}x{cfg.mesh.data}x{cfg.mesh.seq} (clients x data x seq), "
            f"ring attention over {cfg.model.max_len // cfg.mesh.seq}-token chunks"
            + (f"; {nproc} processes, rings in-process" if nproc > 1 else "")
        )
        super().__init__(cfg, pad_id=pad_id, device=device, mesh=mesh)
        self._contexts = client_contexts(self.mesh, self.C, range(self.client_offset, self.client_offset + self.C_local))
        self._data = int(self.mesh.shape["data"])
        self._steps = build_fedseq_steps()

    @staticmethod
    def _seq_mesh(cfg: ExperimentConfig, device: torch.device) -> Mesh:
        """``mesh.clients x data x seq`` over this process's slots (the
        global layout under a process group), the client rows fitted to
        the slots when the configured axis does not fit or does not
        divide the client count."""
        m = cfg.mesh
        if multihost.process_count() > 1:
            return multihost.make_global_seq_mesh(m.clients, m.data, m.seq, device=device)
        C, rows, block = cfg.fed.num_clients, m.clients, m.data * m.seq
        n_dev = len(multihost.process_devices(device))
        if (rows * block > n_dev or C % rows) and block <= n_dev:
            rows = fit_clients_axis(C, block, n_dev)
            log.info(
                f"[FEDSEQ] {C} clients on {n_dev} slot(s): mesh {m.clients}x{m.data}x{m.seq} -> "
                f"{rows}x{m.data}x{m.seq} ({C // rows} client replicas per row)"
            )
        # Even one row too many for the slots raises make_mesh's message.
        return make_seq_mesh(rows, m.data, m.seq, device=device)

    # -------------------------------------------------------------- hooks
    def _client_logits(self, lane: dict, c: int, ids, mask, *, generator=None) -> torch.Tensor:
        """Client ``c``'s ring forward over its slots (logits on its first)."""
        from torch.func import functional_call

        return functional_call(
            self.model, lane, (ids, mask),
            {"deterministic": generator is None, "generator": generator, "seq": self._contexts[c]},
        ).to(self.device)

    def _client_loss(self, logits, labels, valid, *, dense: bool) -> torch.Tensor:
        if dense:
            return dense_loss(logits, labels, self._data)
        return masked_loss(logits, labels, valid, self._data)[0]

    def _client_counts(self, logits, labels, valid):
        return eval_client_counts(logits, labels, valid, self._data)

    def train_step(self, state, batch: dict, anchor=None):
        """One lockstep step over every client's slots: the dense step
        (ledger site ``fedseq.train_step``) or, for a ragged batch, the
        masked and gated one."""
        step = self._steps.ragged_step if "valid" in batch else self._steps.train_step
        return step(self, state, batch, anchor)

    def fit_local(self, state, stacked_train, **kw):
        B = self.cfg.data.batch_size if kw.get("batch_size") is None else kw["batch_size"]
        if B % self._data:
            raise ValueError(f"batch_size={B} must divide over the data axis ({self._data})")
        return super().fit_local(state, stacked_train, **kw)

    def _trace_attrs(self) -> dict:
        """Span attributes of the fedseq path: the seq slot count and the
        ring's chunk length, so a merged timeline attributes these rounds
        to their ring configuration."""
        return {
            "path": "fedseq",
            "clients": self.C,
            "seq": self.cfg.mesh.seq,
            "ring_chunk": self.cfg.model.max_len // self.cfg.mesh.seq,
        }
