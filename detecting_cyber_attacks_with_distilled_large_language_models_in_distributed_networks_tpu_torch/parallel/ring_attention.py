"""Ring attention over the seq slots of one replica (the port of the JAX
package's ``parallel/ring_attention.py``).

The sequence is split into n chunks, chunk ``s`` on seq slot ``s``, each
slot holding ``[B, H, L/n, D]`` queries, keys and values. The JAX package
runs n ring steps inside ``shard_map``: every device attends its queries
to the K/V chunk it holds, then passes the chunk to its ring neighbour
with ``ppermute``, merging with the online-softmax recurrence. No device
holds the full ``[L, L]`` scores or the full K/V.

In the port the slots of one replica live in one process (the JAX
package's multi-host layout keeps every ring on one host, and
:func:`.multihost.make_global_seq_mesh` keeps it in one process), so the
ring is a loop: slot ``s`` merges the chunks in ppermute order ``s, s-1,
..., s-n+1 (mod n)``, each chunk's global key offset rotating with it.
A chunk moves to another slot's device with ``Tensor.to`` (a
differentiable copy; a no-op between slots that share a device), never
with :func:`.mesh.slot_copy`, which detaches: the other slots' queries
send their gradients back into the chunk's dk and dv through it.

Numerics, as the JAX package's: the matmul inputs in the activation
dtype, accumulated and returned in fp32 (bf16 operands are upcast and
multiplied in fp32, exact products; TF32 stays off, :mod:`..device`);
the softmax statistics and the merge in fp32; attention dropout masks
the numerator ``pv`` and scales it by ``1 / (1 - rate)`` while the
denominator ``l`` keeps the undropped weights, the dot path's
drop-after-softmax. The mask is the coordinate-keyed hash of
:mod:`..ops.hash_dropout` on global (batch, query, key) coordinates, so
the sampled output does not depend on n. Plain PyTorch, as the JAX ring
is plain XLA: no flash kernel runs here.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.hash_dropout import hash_keep_mask
from .mesh import Mesh, axis_slots


def _place(t: torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    """``t`` on ``device``, differentiably (the same tensor when it is
    already there)."""
    if t is None or t.device == device:
        return t
    return t.to(device)


def _check_bias(bias: torch.Tensor | None) -> None:
    if bias is not None and (bias.ndim != 4 or bias.shape[1] != 1 or bias.shape[2] != 1):
        raise ValueError(
            f"ring_attention supports key-position bias [B,1,1,Lk] only, got {tuple(bias.shape)}"
        )


def _partial_attention(q, k, v, bias, scale: float, drop=None):
    """Unnormalized flash statistics of local queries against one K/V
    chunk: ``(pv, m, l)``, the exp-weighted values, the row max and the
    row denominator, all fp32.

    ``drop = (seed_words, rate, b_off, q_off, k_off)`` applies attention
    dropout with the global-coordinate hash mask: ``pv``'s weights are
    masked and scaled, ``l`` keeps the undropped ones."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    # The row max cancels out of the merged result, so its gradient is 0
    # in exact arithmetic: it is a constant here.
    m = s.amax(dim=-1).detach()
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if drop is not None:
        seed, rate, b_off, q_off, k_off = drop
        keep = hash_keep_mask(seed, p.shape, rate, offsets={0: b_off, 2: q_off, 3: k_off}, device=p.device)
        p = p * keep * (1.0 / (1.0 - rate))
    pv = torch.matmul(p.to(q.dtype).float(), v.float())
    return pv, m, l


def _merge_partial(acc, m, l, pv_i, m_i, l_i):
    """Online-softmax merge of one chunk's statistics into the running
    ``(acc, m, l)``; shared by the ring and the one-device blockwise
    variant, so their numerics stay the same."""
    m_new = torch.maximum(m, m_i)
    alpha = torch.exp(m - m_new)
    alpha_i = torch.exp(m_i - m_new)
    acc = acc * alpha[..., None] + pv_i * alpha_i[..., None]
    l = l * alpha + l_i * alpha_i
    return acc, m_new, l


def _empty_stats(q: torch.Tensor):
    b, h, lq, d = q.shape
    return (
        torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device),
        torch.full((b, h, lq), float("-inf"), dtype=torch.float32, device=q.device),
        torch.zeros((b, h, lq), dtype=torch.float32, device=q.device),
    )


def ring_attention(
    qs: Sequence[torch.Tensor],  # per seq slot: [B, H, Lq_local, D]
    ks: Sequence[torch.Tensor],  # per seq slot: [B, H, Lk_local, D]
    vs: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor] | None = None,  # per seq slot: [B, 1, 1, Lk_local]
    *,
    dropout_rate: float = 0.0,
    seed_words=None,
    deterministic: bool = True,
    batch_offset: int = 0,
) -> list[torch.Tensor]:
    """Sequence-parallel attention over one replica's seq slots: chunk
    ``s`` of each list lives on slot ``s``; returns each slot's output
    chunk, on its device, in q's dtype. A key-position bias rotates with
    its K/V chunk; only such biases are accepted (one with a query
    dimension would reach other slots' queries).

    Attention dropout (``dropout_rate``, ``seed_words``, not
    ``deterministic``): one pair of seed words for the whole ring, masks
    keyed on the global (row, query, key) coordinates, rows offset by
    ``batch_offset`` (this replica's data slot), so the sampled output is
    the same at any number of slots."""
    n = len(qs)
    if not (len(ks) == len(vs) == n) or (biases is not None and len(biases) != n):
        raise ValueError(f"ring of {n} query chunks needs as many K, V (and bias) chunks")
    for b in biases or ():
        _check_bias(b)
    rate = 0.0 if deterministic else float(dropout_rate)
    if rate > 0.0 and seed_words is None:
        raise ValueError("ring attention dropout needs seed_words")
    scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    lq, lk = int(qs[0].shape[2]), int(ks[0].shape[2])
    outs = []
    for s, q in enumerate(qs):
        dev = q.device
        acc, m, l = _empty_stats(q)
        for step in range(n):
            j = (s - step) % n  # ppermute order: the chunk slot s holds after `step` rotations
            drop = None if rate == 0.0 else (seed_words, rate, batch_offset, s * lq, j * lk)
            pv, m_i, l_i = _partial_attention(
                q, _place(ks[j], dev), _place(vs[j], dev),
                None if biases is None else _place(biases[j], dev), scale, drop,
            )
            acc, m, l = _merge_partial(acc, m, l, pv, m_i, l_i)
        # -1e9 mask addends keep l > 0 even for a fully masked row (as the
        # dot and flash paths).
        outs.append((acc / l[..., None]).to(q.dtype))
    return outs


def blockwise_attention_local(
    q: torch.Tensor,  # [B, H, L, D], one device
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,  # [B, 1, 1, L]
    *,
    n_chunks: int = 8,
) -> torch.Tensor:
    """The ring's arithmetic on one device: K/V split into ``n_chunks``
    chunks merged in order with the same partial and merge. Deterministic
    only; a parity anchor against the dot path."""
    lk = int(k.shape[2])
    if lk % n_chunks:
        raise ValueError(f"L={lk} must divide into n_chunks={n_chunks}")
    _check_bias(bias)
    ck = lk // n_chunks
    scale = 1.0 / (q.shape[-1] ** 0.5)
    acc, m, l = _empty_stats(q)
    for i in range(n_chunks):
        sl = slice(i * ck, (i + 1) * ck)
        b = None if bias is None else bias[..., sl]
        pv, m_i, l_i = _partial_attention(q, k[:, :, sl], v[:, :, sl], b, scale)
        acc, m, l = _merge_partial(acc, m, l, pv, m_i, l_i)
    return (acc / l[..., None]).to(q.dtype)


def ring_attention_sharded(
    q: torch.Tensor,  # [B, H, L, D], full tensors
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    mesh: Mesh,
    axis_name: str = "seq",
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Standalone wrapper: splits the sequence axis of full ``[B, H, L,
    D]`` tensors over ``mesh``'s ``axis_name`` slots, runs the ring and
    gathers the output back onto q's device. Dropout draws one pair of
    seed words from ``generator``. The model runs its chunks through
    :func:`ring_attention` itself."""
    from ..ops.flash_attention import draw_seed_words

    slots = axis_slots(mesh, axis_name)
    n = len(slots)
    L = int(q.shape[2])
    if L % n or int(k.shape[2]) % n:
        raise ValueError(f"sequence length {L} must divide over {n} seq slots")
    lq, lk = L // n, int(k.shape[2]) // n

    def split(t, size, dim):
        return [_place(t.narrow(dim, i * size, size), slots[i]) for i in range(n)]

    seed = None
    if not deterministic and dropout_rate > 0.0:
        if generator is None:
            raise ValueError("ring attention dropout needs a generator")
        seed = draw_seed_words(generator)
    outs = ring_attention(
        # A bias is checked chunk by chunk, as each JAX shard checks its own.
        split(q, lq, 2), split(k, lk, 2), split(v, lk, 2), None if bias is None else split(bias, lk, -1),
        dropout_rate=dropout_rate, seed_words=seed, deterministic=deterministic,
    )
    return torch.cat([_place(o, q.device) for o in outs], dim=2)
