"""DistilBERT encoder + DDoS classification head in PyTorch.

Port of the JAX package's ``models/distilbert.py``: embeddings (word +
learned position, LayerNorm eps 1e-12), N post-LayerNorm transformer
blocks (MHA -> residual -> LN -> GELU FFN -> residual -> LN), then CLS
pooling -> Dropout -> Linear(dim, n_classes) in fp32.

Module names mirror the JAX parameter tree (``encoder.layer_0.attn.q``
for ``encoder/layer_0/attn/q``), so :mod:`.convert` maps one layout onto
the other by renaming leaves alone.

Dtypes: parameters stay fp32; every Linear and embedding runs in
``cfg.compute_dtype`` (weights cast at use, as flax ``nn.Dense(dtype=)``
does); LayerNorm statistics, the attention softmax and the head run in
fp32.

Dropout (train mode, ``deterministic=False``) sits where the JAX model
puts it: the embeddings' output, each block's attention output and FFN
output (``dropout``), the attention weights (``attention_dropout``; in
the flash kernels on the flash path) and the pooled CLS vector
(``head_dropout``). Masks come from the explicit ``generator`` passed to
``forward``, never from torch's global generator, so they match the JAX
package's in distribution, not in bits.

``remat`` (``nn.remat`` in the JAX model) wraps each block in
non-reentrant ``torch.utils.checkpoint``: the block's activations are
dropped after the forward and recomputed in the backward. The recompute
must draw the same dropout masks and K1 seed words as the forward, and
``checkpoint`` replays only torch's global RNGs, so the block's
generator state is captured before it runs and the recompute draws from
a copy set to that state; the caller's generator advances once, as
without remat.

The ring path (``attention_impl="ring"`` with a :class:`SeqContext`, the
sequence-parallel trainer's forward): the batch rows split over the
context's data slots and the positions over its seq slots, chunk ``(d,
s)`` on slot ``slots[d][s]``. The JAX package runs that forward as one
SPMD program per slot under ``shard_map``, trading K/V per layer; here
one process runs each layer for every chunk before the next layer,
since layer i's ring needs every chunk's K/V of layer i
(:func:`..parallel.ring_attention.ring_attention`). Chunk ``(d, s)``
embeds the global positions ``s·L_local + arange``; the global CLS is
seq slot 0's first token, and the logits are computed once from it on
slot ``(d, 0)`` (every JAX shard computes the same logits) and gathered
onto slot ``(0, 0)``. Every dropout site (embeddings, attention weights,
attention output, FFN output, head) is hash-keyed on global coordinates
(:mod:`..ops.hash_dropout`): one pair of seed words per site and
forward, drawn from the generator in the same order at any split, rows
offset by ``d·B_local`` and positions by ``s·L_local``, so the masks do
not depend on how many slots there are. Parameters reach a slot on
another device through a differentiable ``to``. Without a context,
``"ring"`` runs the dot path (init, unsplit evaluation, ``predict`` and
serving of a sequence-parallel checkpoint), as the JAX model does
outside ``shard_map``; it never runs the flash kernels. Remat composes:
the recompute of a ring layer replays the generator and redraws the
same seed words.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..device import torch_dtype
from ..ops.attention import dot_product_attention, make_attention_bias
from ..ops.flash_attention import draw_seed_words, flash_attention
from ..ops.hash_dropout import hash_dropout


def _dropout(
    x: torch.Tensor, rate: float, deterministic: bool,
    generator: torch.Generator | None,
) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    the kept values by ``1 / (1 - rate)``, in x's dtype."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


@dataclass(frozen=True)
class SeqContext:
    """Where one replica's ring forward runs: ``slots[d][s]`` is the device
    of data slot d's sequence chunk s (a ``data x seq`` block of a mesh).
    Rows split evenly over the data slots, positions over the seq slots."""

    slots: tuple[tuple[torch.device, ...], ...]

    @classmethod
    def from_grid(cls, grid) -> "SeqContext":
        """From a ``[data, seq]`` grid of devices (a mesh row's block)."""
        g = np.asarray(grid, dtype=object)
        return cls(tuple(tuple(torch.device(d) for d in row) for row in g.reshape(g.shape[0], -1)))

    @property
    def data(self) -> int:
        return len(self.slots)

    @property
    def seq(self) -> int:
        return len(self.slots[0])


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, differentiably (itself when already there)."""
    return t if t.device == device else t.to(device)


def _site_seed(rate: float, deterministic: bool, generator: torch.Generator | None):
    """One dropout site's seed words for a ring forward (None when the
    site drops nothing): drawn once, shared by every chunk."""
    if deterministic or rate == 0.0:
        return None
    if generator is None:
        raise ValueError("train-mode dropout needs a generator")
    return draw_seed_words(generator)


def _linear(x: torch.Tensor, mod: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(
        x.to(dtype), mod.weight.to(device=x.device, dtype=dtype), mod.bias.to(device=x.device, dtype=dtype)
    )


def _layer_norm(x: torch.Tensor, mod: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """fp32 statistics, output in the activation dtype (flax LayerNorm
    with ``dtype=compute_dtype``)."""
    return F.layer_norm(
        x.float(), mod.normalized_shape, _on(mod.weight, x.device), _on(mod.bias, x.device), mod.eps
    ).to(dtype)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.q = nn.Linear(cfg.dim, cfg.dim)
        self.k = nn.Linear(cfg.dim, cfg.dim)
        self.v = nn.Linear(cfg.dim, cfg.dim)
        self.o = nn.Linear(cfg.dim, cfg.dim)

    def project(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q, k and v of ``x [B, L, dim]`` as ``[B, H, L, d]`` views."""
        cfg = self.cfg
        cd = torch_dtype(cfg.compute_dtype)
        B, L, _ = x.shape

        def split(t):  # [B, L, dim] -> [B, H, L, d]
            return t.reshape(B, L, cfg.n_heads, cfg.head_dim).transpose(1, 2)

        if cfg.fused_qkv:
            # One [3D, D] product over weights concatenated at use; the
            # parameters keep the separate q/k/v layout.
            w = torch.cat([self.q.weight, self.k.weight, self.v.weight]).to(device=x.device, dtype=cd)
            b3 = torch.cat([self.q.bias, self.k.bias, self.v.bias]).to(device=x.device, dtype=cd)
            qkv = F.linear(x.to(cd), w, b3)
            q, k, v = (split(t) for t in qkv.chunk(3, dim=-1))
        else:
            q = split(_linear(x, self.q, cd))
            k = split(_linear(x, self.k, cd))
            v = split(_linear(x, self.v, cd))
        return q, k, v

    def merge(self, ctx: torch.Tensor) -> torch.Tensor:
        """The heads of ``ctx [B, H, L, d]`` merged and projected by ``o``."""
        B, _, L, _ = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(B, L, self.cfg.dim)  # a view on flash
        return _linear(ctx, self.o, torch_dtype(self.cfg.compute_dtype))

    def forward(
        self, x: torch.Tensor, bias: torch.Tensor, deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = self.project(x)
        drop = dict(
            dropout_rate=cfg.attention_dropout, generator=generator,
            deterministic=deterministic,
        )
        if cfg.attention_impl == "flash":
            # K1 reads the q/k/v views through their strides and writes O
            # as [B, L, H, d] storage: no copy on either side of it.
            ctx = flash_attention(q, k, v, bias, **drop)
        else:
            # "dot", and "ring" outside a seq context: the unsplit math.
            ctx = dot_product_attention(q, k, v, bias, **drop)
        return self.merge(ctx)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.attn = MultiHeadSelfAttention(cfg)
        self.sa_ln = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.lin1 = nn.Linear(cfg.dim, cfg.hidden_dim)
        self.lin2 = nn.Linear(cfg.hidden_dim, cfg.dim)
        self.out_ln = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)

    def forward(
        self, x, bias, deterministic: bool = True, generator: torch.Generator | None = None,
        ring: bool = False,
    ):
        """One block on ``x [B, L, dim]``; with ``ring``, on every chunk of
        a ring forward at once (``x`` and ``bias`` nested ``[data][seq]``
        lists of chunks, see :meth:`forward_ring`)."""
        if ring:
            return self.forward_ring(x, bias, deterministic, generator)
        cfg = self.cfg
        attn_out = self.attn(x, bias, deterministic, generator)
        attn_out = _dropout(attn_out, cfg.dropout, deterministic, generator)
        return self._ffn(x, attn_out, deterministic, generator, None)

    def _ffn(self, x, attn_out, deterministic, generator, hashed) -> torch.Tensor:
        """Residual + LN, the FFN, its dropout, residual + LN. ``hashed``:
        ``(seed words, offsets)`` of the ring path's FFN dropout, else
        None (the generator's ``torch.rand`` mask)."""
        cfg = self.cfg
        cd = torch_dtype(cfg.compute_dtype)
        x = _layer_norm(x + attn_out, self.sa_ln, cd)
        h = _linear(x, self.lin1, cd)
        h = F.gelu(h, approximate="tanh" if cfg.gelu == "tanh" else "none")
        h = _linear(h, self.lin2, cd)
        if hashed is None:
            h = _dropout(h, cfg.dropout, deterministic, generator)
        else:
            h = hash_dropout(h, cfg.dropout, hashed[0], offsets=hashed[1], deterministic=deterministic)
        return _layer_norm(x + h, self.out_ln, cd)

    def forward_ring(
        self, xs: list[list[torch.Tensor]], biases: list[list[torch.Tensor]], deterministic: bool,
        generator: torch.Generator | None,
    ) -> list[list[torch.Tensor]]:
        """This block for every chunk: chunk ``(d, s)`` is ``xs[d][s]``
        ``[B_local, L_local, dim]`` on its slot. Each data row's chunks
        attend through one ring; the three dropout sites take one pair of
        seed words each, shared by every chunk."""
        # Imported here: the parallel package imports the trainers, which
        # import this module.
        from ..parallel.ring_attention import ring_attention

        cfg = self.cfg
        seeds = [_site_seed(r, deterministic, generator) for r in (cfg.attention_dropout, cfg.dropout, cfg.dropout)]
        out = []
        for d, row in enumerate(xs):
            bl, ll = int(row[0].shape[0]), int(row[0].shape[1])
            q, k, v = zip(*(self.attn.project(x) for x in row))
            ctx = ring_attention(
                q, k, v, biases[d], dropout_rate=cfg.attention_dropout, seed_words=seeds[0],
                deterministic=deterministic, batch_offset=d * bl,
            )
            new_row = []
            for s, (x, c) in enumerate(zip(row, ctx)):
                offsets = {0: d * bl, 1: s * ll}
                a = hash_dropout(self.attn.merge(c), cfg.dropout, seeds[1], offsets=offsets, deterministic=deterministic)
                new_row.append(self._ffn(x, a, deterministic, generator, (seeds[2], offsets)))
            out.append(new_row)
        return out


def _remat_block(
    block: TransformerBlock, x, bias, deterministic: bool, generator: torch.Generator | None,
    ring: bool = False,
):
    """``block(x, ...)`` with its activations recomputed in the backward.

    The recompute runs after the caller's ``functional_call`` has put the
    module's own (meta) leaves back, so the leaves this call sees are
    captured and passed in again. Its first run draws from ``generator``;
    a recompute draws from a fresh generator set to the state the first
    run started from, so it sees the same masks and seed words and leaves
    ``generator`` where the forward left it. ``ring``: ``x`` and ``bias``
    are a ring forward's nested chunk lists, the block runs every chunk
    (:meth:`TransformerBlock.forward_ring`)."""
    leaves = dict(block.named_parameters())
    start = generator.get_state() if generator is not None else None
    runs = 0

    def run(x, bias):
        nonlocal runs
        runs += 1
        g = generator
        if runs > 1 and g is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(start)
        return functional_call(block, leaves, (x, bias, deterministic, g, ring))

    # Every random draw comes from the replayed generator above, so
    # torch's global RNG states need no stashing.
    return checkpoint(run, x, bias, use_reentrant=False, preserve_rng_state=False)


class Embeddings(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.dim)
        self.ln = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)

    def forward(
        self, input_ids: torch.Tensor, deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cd = torch_dtype(self.cfg.compute_dtype)
        L = input_ids.shape[-1]
        word = self.word_embeddings(input_ids).to(cd)
        pos = self.position_embeddings.weight[:L].to(cd)[None, :, :]
        x = _layer_norm(word + pos, self.ln, cd)
        return _dropout(x, self.cfg.dropout, deterministic, generator)

    def chunk(
        self, input_ids: torch.Tensor, offsets: dict[int, int], deterministic: bool, seed_words
    ) -> torch.Tensor:
        """One ring chunk ``[B_local, L_local]`` on its slot: the word
        embeddings, the GLOBAL positions from ``offsets[1]`` on, LayerNorm
        and the hash-keyed dropout at the chunk's global offsets."""
        cd = torch_dtype(self.cfg.compute_dtype)
        dev = input_ids.device
        L, start = int(input_ids.shape[-1]), offsets[1]
        word = F.embedding(input_ids, _on(self.word_embeddings.weight, dev)).to(cd)
        pos = _on(self.position_embeddings.weight[start:start + L], dev).to(cd)[None, :, :]
        x = _layer_norm(word + pos, self.ln, cd)
        return hash_dropout(x, self.cfg.dropout, seed_words, offsets=offsets, deterministic=deterministic)


class DistilBertEncoder(nn.Module):
    """Token ids + attention mask -> last hidden states ``[B, L, dim]``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", TransformerBlock(cfg))

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
        deterministic: bool = True, generator: torch.Generator | None = None,
        seq: SeqContext | None = None,
    ):
        """Last hidden states ``[B, L, dim]``; with ``seq`` (the ring path)
        the nested ``[data][seq]`` list of hidden-state chunks, each on
        its slot."""
        if seq is not None:
            return self._forward_ring(input_ids, attention_mask, deterministic, generator, seq)
        x = self.embeddings(input_ids, deterministic, generator)
        bias = make_attention_bias(attention_mask)
        return self._layers(x, bias, deterministic, generator, False)

    def _layers(self, x, bias, deterministic, generator, ring: bool):
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i in range(self.cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                x = _remat_block(block, x, bias, deterministic, generator, ring)
            else:
                x = block(x, bias, deterministic, generator, ring)
        return x

    def _forward_ring(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, deterministic: bool,
        generator: torch.Generator | None, seq: SeqContext,
    ) -> list[list[torch.Tensor]]:
        if self.cfg.attention_impl != "ring":
            raise ValueError(f"a seq context needs attention_impl='ring', not {self.cfg.attention_impl!r}")
        B, L = (int(d) for d in input_ids.shape)
        if B % seq.data or L % seq.seq:
            raise ValueError(
                f"a [{B}, {L}] batch does not split over data={seq.data} x seq={seq.seq} slots"
            )
        bl, ll = B // seq.data, L // seq.seq

        def chunk(t: torch.Tensor, d: int, s: int) -> torch.Tensor:
            return _on(t[d * bl:(d + 1) * bl, s * ll:(s + 1) * ll], seq.slots[d][s])

        seed = _site_seed(self.cfg.dropout, deterministic, generator)
        xs = [
            [self.embeddings.chunk(chunk(input_ids, d, s), {0: d * bl, 1: s * ll}, deterministic, seed)
             for s in range(seq.seq)]
            for d in range(seq.data)
        ]
        biases = [[make_attention_bias(chunk(attention_mask, d, s)) for s in range(seq.seq)] for d in range(seq.data)]
        return self._layers(xs, biases, deterministic, generator, True)


class DDoSClassifier(nn.Module):
    """Encoder + the reference's classification head (CLS -> Linear)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = DistilBertEncoder(cfg)
        self.classifier = nn.Linear(cfg.dim, cfg.n_classes)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
        deterministic: bool = True, generator: torch.Generator | None = None,
        seq: SeqContext | None = None,
    ) -> torch.Tensor:
        """Logits ``[B, n_classes]`` in fp32. ``deterministic=False`` is
        train mode: every dropout site draws from ``generator``. With
        ``seq`` the ring forward over its slots, the logits on slot
        ``(0, 0)``."""
        if seq is not None:
            return self._forward_ring(input_ids, attention_mask, deterministic, generator, seq)
        hidden = self.encoder(input_ids, attention_mask, deterministic, generator)
        pooled = _dropout(
            hidden[:, 0, :], self.cfg.head_dropout, deterministic, generator
        )  # the CLS token (reference client1.py:62-63)
        return F.linear(pooled.float(), self.classifier.weight, self.classifier.bias)

    def _forward_ring(self, input_ids, attention_mask, deterministic, generator, seq: SeqContext) -> torch.Tensor:
        rows = self.encoder(input_ids, attention_mask, deterministic, generator, seq=seq)
        seed = _site_seed(self.cfg.head_dropout, deterministic, generator)
        out = []
        for d, row in enumerate(rows):
            # The global CLS: position 0, which seq slot 0 holds. Head
            # dropout ([B, dim], no position axis) stays hash-keyed, rows
            # offset by the data slot.
            pooled = row[0][:, 0, :]
            pooled = hash_dropout(
                pooled, self.cfg.head_dropout, seed, offsets={0: d * int(pooled.shape[0])}, deterministic=deterministic
            )
            dev = pooled.device
            logits = F.linear(pooled.float(), _on(self.classifier.weight, dev), _on(self.classifier.bias, dev))
            out.append(_on(logits, seq.slots[0][0]))
        return torch.cat(out)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A fresh fp32 state dict drawn as the JAX package initializes:
    normal(initializer_range) kernels and embeddings, zero biases,
    LayerNorm scale 1 and shift 0. Deterministic in ``generator``."""
    with torch.device("meta"):
        shapes = {k: t.shape for k, t in DDoSClassifier(cfg).state_dict().items()}
    out = {}
    for name, shape in sorted(shapes.items()):
        leaf = name.rsplit(".", 1)[-1]
        is_norm = name.rsplit(".", 2)[-2].endswith("ln")
        if leaf == "bias":
            out[name] = torch.zeros(shape)
        elif is_norm:
            out[name] = torch.ones(shape)
        else:
            out[name] = torch.empty(shape).normal_(
                0.0, cfg.initializer_range, generator=generator
            )
    return out


def model_skeleton(cfg: ModelConfig) -> DDoSClassifier:
    """The classifier's modules on the meta device: no storage, for
    ``torch.func.functional_call`` over a state dict of leaves."""
    with torch.device("meta"):
        return DDoSClassifier(cfg)


def build_trainable_params(
    cfg: ModelConfig, state_dict: dict, device: torch.device, *,
    trainable: str = "all",
) -> dict[str, torch.Tensor]:
    """Fresh fp32 leaves on ``device`` for training, copied from
    ``state_dict`` (strict: missing, unexpected or misshapen keys raise):
    ``trainable="all"`` makes every leaf require grad, ``"head"`` only
    the classifier's. The copies never alias the input, so training can
    update them in place."""
    shapes = {k: tuple(t.shape) for k, t in model_skeleton(cfg).state_dict().items()}
    if set(state_dict) != set(shapes):
        raise KeyError(
            f"state dict keys differ from the model's: missing "
            f"{sorted(set(shapes) - set(state_dict))[:4]}, unexpected "
            f"{sorted(set(state_dict) - set(shapes))[:4]}"
        )
    out = {}
    for name, shape in shapes.items():
        leaf = torch.as_tensor(state_dict[name]).detach().to(
            device=device, dtype=torch.float32, copy=True
        )
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(leaf.shape)}, want {shape}")
        out[name] = leaf.requires_grad_(
            trainable == "all" or name.startswith("classifier.")
        )
    return out


def build_model(
    cfg: ModelConfig, state_dict: dict, device: torch.device
) -> DDoSClassifier:
    """An eval-mode classifier on ``device`` holding ``state_dict``
    (strict: missing or unexpected keys raise). The module is built on the
    meta device, so no throwaway initialization runs."""
    with torch.device("meta"):
        model = DDoSClassifier(cfg)
    model.load_state_dict(
        {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in state_dict.items()},
        strict=True,
        assign=True,
    )
    return model.eval().requires_grad_(False)

