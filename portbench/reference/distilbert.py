"""The DistilBERT family: the post-LayerNorm encoder classifier of the
configurations ``distilbert-base`` and ``bert-large``.

Plain PyTorch in fp32 with TF32 off, written from the architecture's
description (DistilBERT's post-LayerNorm encoder with learned positions,
the reference's CLS -> dropout -> Linear head), importing nothing of the
program or of JAX. A configuration without a ``"reference"`` key is of
this family.

The family's interface (``pbcore/bench.py`` ``FAMILY_INTERFACE``):

* ``leaf_shapes`` and ``leaf_kind``: the classifier's leaves by the
  port's state-dict keys (``nn.Linear`` weights ``[out, in]``) and how
  each is initialised (``pbcore/weights.py`` draws them);
* ``class_probs`` and ``train_steps``: the reference's answers and
  training readings, through ``reference/model.py``'s shared loops;
* ``forward_flops``, ``n_trainable`` and ``attention_launch``: the work
  counts the per-layer readers divide by. ``forward_flops`` is a frozen
  copy of the port's ``utils/profiling.py`` count (2·M·N·K a contraction:
  the Q/K/V/O projections, the two attention contractions, the FFN, the
  head).
"""

from __future__ import annotations

import math

import torch

from reference.model import DropStream, Precision, adam_steps, attention_keep, softmax_rows


# -------------------------------------------------------------- leaves
def leaf_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every leaf of the classifier, by state-dict key."""
    D, F = cfg["dim"], cfg["hidden_dim"]
    shapes: dict[str, tuple[int, ...]] = {
        "encoder.embeddings.word_embeddings.weight": (cfg["vocab_size"], D),
        "encoder.embeddings.position_embeddings.weight": (cfg["max_position_embeddings"], D),
        "encoder.embeddings.ln.weight": (D,),
        "encoder.embeddings.ln.bias": (D,),
    }
    for i in range(cfg["n_layers"]):
        p = f"encoder.layer_{i}."
        for name in ("q", "k", "v", "o"):
            shapes[f"{p}attn.{name}.weight"] = (D, D)
            shapes[f"{p}attn.{name}.bias"] = (D,)
        shapes[f"{p}sa_ln.weight"] = (D,)
        shapes[f"{p}sa_ln.bias"] = (D,)
        shapes[f"{p}lin1.weight"] = (F, D)
        shapes[f"{p}lin1.bias"] = (F,)
        shapes[f"{p}lin2.weight"] = (D, F)
        shapes[f"{p}lin2.bias"] = (D,)
        shapes[f"{p}out_ln.weight"] = (D,)
        shapes[f"{p}out_ln.bias"] = (D,)
    shapes["classifier.weight"] = (cfg["n_classes"], D)
    shapes["classifier.bias"] = (cfg["n_classes"],)
    return shapes


def leaf_kind(name: str) -> str:
    """Biases zero, LayerNorm scales one, matrices and embeddings normal."""
    if name.endswith(".bias"):
        return "zero"
    if name.rsplit(".", 2)[-2].endswith("ln"):
        return "one"
    return "normal"


# ------------------------------------------------------------- forward
def _layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _gelu(x, form: str):
    if form == "tanh":
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def forward(w: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
            drop: DropStream | None = None, prec: Precision = Precision()) -> torch.Tensor:
    """Logits ``[B, n_classes]`` of ``ids``/``mask`` ``[B, L]``; training
    mode (every dropout site) when ``drop`` is given."""
    B, L = ids.shape
    D, H = cfg["dim"], cfg["n_heads"]
    d = D // H
    eps = cfg["layer_norm_eps"]

    def hid(x, rate):
        return drop.hidden(x, rate) if drop is not None else x

    e = "encoder.embeddings."
    x = w[e + "word_embeddings.weight"][ids.long()] + w[e + "position_embeddings.weight"][:L][None]
    x = hid(prec.act(_layer_norm(x, w[e + "ln.weight"], w[e + "ln.bias"], eps)), cfg["dropout"])
    bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]
    for i in range(cfg["n_layers"]):
        p = f"encoder.layer_{i}."

        def lin(t, name):
            return prec.linear(t, w[p + name + ".weight"], w[p + name + ".bias"])

        def heads(t):
            return t.reshape(B, L, H, d).transpose(1, 2)

        q, k, v = (heads(lin(x, f"attn.{n}")) for n in "qkv")
        s = prec.operand(q) @ prec.operand(k).transpose(-1, -2) * (1.0 / math.sqrt(d)) + bias
        a = torch.softmax(s, dim=-1)
        if drop is not None and cfg["attention_dropout"] > 0.0:
            rate = cfg["attention_dropout"]
            keep = attention_keep(drop.words(), a.shape, rate)
            a = a * keep * (1.0 / (1.0 - rate))
        ctx = prec.act(prec.operand(prec.act(a)) @ prec.operand(v)).transpose(1, 2).reshape(B, L, D)
        attn = hid(lin(ctx, "attn.o"), cfg["dropout"])
        x = prec.act(_layer_norm(prec.act(x + attn), w[p + "sa_ln.weight"], w[p + "sa_ln.bias"], eps))
        h = lin(prec.act(_gelu(lin(x, "lin1"), cfg["gelu"])), "lin2")
        x = prec.act(_layer_norm(prec.act(x + hid(h, cfg["dropout"])), w[p + "out_ln.weight"], w[p + "out_ln.bias"], eps))
    pooled = hid(x[:, 0, :], cfg["head_dropout"])
    return pooled @ w["classifier.weight"].T + w["classifier.bias"]


def class_probs(w: dict, cfg: dict, ids, mask, block: int, prec: Precision = Precision()) -> torch.Tensor:
    """Per-class softmax of every row, ``block`` rows at a time."""
    return softmax_rows(lambda i, m, pr: forward(w, cfg, i, m, prec=pr), ids, mask, block, prec)


def train_steps(w0: dict, cfg: dict, batches, drop_seed: int, opt: dict,
                prec: Precision = Precision(), half_batch: bool = False):
    """Adam steps from ``w0`` over ``batches``: ``reference/model.py``'s
    ``adam_steps`` with this family's training forward."""
    return adam_steps(lambda p, i, m, d, pr: forward(p, cfg, i, m, d, pr), w0, batches, drop_seed, opt, prec,
                      half_batch)


# --------------------------------------------------------------- work
def forward_flops(cfg: dict, batch: int, seq_len: int) -> float:
    """Matmul FLOPs of one classifier forward over ``[batch, seq_len]``."""
    L, D, F = seq_len, cfg["dim"], cfg["hidden_dim"]
    per_layer = 8 * L * D * D + 4 * L * L * D + 4 * L * D * F
    return float(batch) * (cfg["n_layers"] * per_layer + 2 * D * cfg["n_classes"])


def n_trainable(cfg: dict) -> int:
    """Elements of the classifier's leaves (all trainable)."""
    D, F, V, P, C = cfg["dim"], cfg["hidden_dim"], cfg["vocab_size"], cfg["max_position_embeddings"], cfg["n_classes"]
    embed = V * D + P * D + 2 * D
    layer = 4 * (D * D + D) + (D * F + F) + (F * D + D) + 4 * D
    return embed + cfg["n_layers"] * layer + D * C + C


def attention_launch(cfg: dict, batch: int, seq_len: int) -> tuple[int, int, int, int, int, bool]:
    """One K1-K3 launch a layer: every head over every key (bidirectional),
    as many key/value heads as query heads."""
    H = cfg["n_heads"]
    return batch, H, H, seq_len, cfg["dim"] // H, False
