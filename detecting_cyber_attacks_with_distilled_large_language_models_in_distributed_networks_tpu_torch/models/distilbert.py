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
without remat. The ring attention path arrives with a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..device import torch_dtype
from ..ops.attention import dot_product_attention, make_attention_bias
from ..ops.flash_attention import flash_attention


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


def _linear(x: torch.Tensor, mod: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), mod.weight.to(dtype), mod.bias.to(dtype))


def _layer_norm(x: torch.Tensor, mod: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """fp32 statistics, output in the activation dtype (flax LayerNorm
    with ``dtype=compute_dtype``)."""
    return F.layer_norm(
        x.float(), mod.normalized_shape, mod.weight, mod.bias, mod.eps
    ).to(dtype)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.q = nn.Linear(cfg.dim, cfg.dim)
        self.k = nn.Linear(cfg.dim, cfg.dim)
        self.v = nn.Linear(cfg.dim, cfg.dim)
        self.o = nn.Linear(cfg.dim, cfg.dim)

    def forward(
        self, x: torch.Tensor, bias: torch.Tensor, deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        cd = torch_dtype(cfg.compute_dtype)
        B, L, _ = x.shape

        def split(t):  # [B, L, dim] -> [B, H, L, d]
            return t.reshape(B, L, cfg.n_heads, cfg.head_dim).transpose(1, 2)

        if cfg.fused_qkv:
            # One [3D, D] product over weights concatenated at use; the
            # parameters keep the separate q/k/v layout.
            w = torch.cat([self.q.weight, self.k.weight, self.v.weight]).to(cd)
            b3 = torch.cat([self.q.bias, self.k.bias, self.v.bias]).to(cd)
            qkv = F.linear(x.to(cd), w, b3)
            q, k, v = (split(t) for t in qkv.chunk(3, dim=-1))
        else:
            q = split(_linear(x, self.q, cd))
            k = split(_linear(x, self.k, cd))
            v = split(_linear(x, self.v, cd))
        drop = dict(
            dropout_rate=cfg.attention_dropout, generator=generator,
            deterministic=deterministic,
        )
        if cfg.attention_impl == "flash":
            # K1 reads the q/k/v views through their strides and writes O
            # as [B, L, H, d] storage: no copy on either side of it.
            ctx = flash_attention(q, k, v, bias, **drop)
        else:
            ctx = dot_product_attention(q, k, v, bias, **drop)
        ctx = ctx.transpose(1, 2).reshape(B, L, cfg.dim)  # a view on flash
        return _linear(ctx, self.o, cd)


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
        self, x: torch.Tensor, bias: torch.Tensor, deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        cd = torch_dtype(cfg.compute_dtype)
        attn_out = self.attn(x, bias, deterministic, generator)
        attn_out = _dropout(attn_out, cfg.dropout, deterministic, generator)
        x = _layer_norm(x + attn_out, self.sa_ln, cd)
        h = _linear(x, self.lin1, cd)
        h = F.gelu(h, approximate="tanh" if cfg.gelu == "tanh" else "none")
        h = _linear(h, self.lin2, cd)
        h = _dropout(h, cfg.dropout, deterministic, generator)
        return _layer_norm(x + h, self.out_ln, cd)


def _remat_block(
    block: TransformerBlock, x: torch.Tensor, bias: torch.Tensor,
    deterministic: bool, generator: torch.Generator | None,
) -> torch.Tensor:
    """``block(x, ...)`` with its activations recomputed in the backward.

    The recompute runs after the caller's ``functional_call`` has put the
    module's own (meta) leaves back, so the leaves this call sees are
    captured and passed in again. Its first run draws from ``generator``;
    a recompute draws from a fresh generator set to the state the first
    run started from, so it sees the same masks and seed words and leaves
    ``generator`` where the forward left it."""
    leaves = dict(block.named_parameters())
    start = generator.get_state() if generator is not None else None
    runs = 0

    def run(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        nonlocal runs
        runs += 1
        g = generator
        if runs > 1 and g is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(start)
        return functional_call(block, leaves, (x, bias, deterministic, g))

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


class DistilBertEncoder(nn.Module):
    """Token ids + attention mask -> last hidden states ``[B, L, dim]``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.attention_impl == "ring":
            raise NotImplementedError(
                "attention_impl='ring' (sequence parallel) arrives with the "
                "port's sequence-parallel slice"
            )
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", TransformerBlock(cfg))

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
        deterministic: bool = True, generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        x = self.embeddings(input_ids, deterministic, generator)
        bias = make_attention_bias(attention_mask)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i in range(self.cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                x = _remat_block(block, x, bias, deterministic, generator)
            else:
                x = block(x, bias, deterministic, generator)
        return x


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
    ) -> torch.Tensor:
        """Logits ``[B, n_classes]`` in fp32. ``deterministic=False`` is
        train mode: every dropout site draws from ``generator``."""
        hidden = self.encoder(input_ids, attention_mask, deterministic, generator)
        pooled = _dropout(
            hidden[:, 0, :], self.cfg.head_dropout, deterministic, generator
        )  # the CLS token (reference client1.py:62-63)
        return F.linear(pooled.float(), self.classifier.weight, self.classifier.bias)


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

