"""Model configuration for the PyTorch port.

A copy of the JAX package's ``ModelConfig`` (fields, validation and
presets unchanged), so a registry manifest's ``model_config`` written by
either package builds the same architecture in both. The other config
classes of the JAX package arrive with the slices that need them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Transformer encoder + classification head.

    Defaults reproduce DistilBERT-base-uncased (6 layers, 768 hidden, 12 heads,
    3072 FFN, learned positions, post-LayerNorm, exact GELU) which the reference
    loads via HF ``DistilBertModel.from_pretrained`` (reference client1.py:56),
    plus the reference's classifier head: CLS pooling -> Dropout(0.3) ->
    Linear(768, 2) (reference client1.py:57-58,62-64).
    """

    vocab_size: int = 30522
    max_len: int = 128
    max_position_embeddings: int = 512  # HF DistilBERT position-table size
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    dropout: float = 0.1
    attention_dropout: float = 0.1
    head_dropout: float = 0.3
    n_classes: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0
    # Activations run in compute_dtype (bf16 on the card); params stay fp32.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # FFN activation: "tanh" is the GPT-2-style tanh GELU, within a few
    # bf16 ulps (<0.8% relative) of the erf form.
    # "exact" is HF DistilBERT's erf GELU (reference client1.py:56 via HF);
    # use it for fp32 logit-parity comparisons (ModelConfig.tiny defaults
    # to it alongside fp32 compute).
    gelu: str = "tanh"
    # "dot" (plain PyTorch attention), "flash" (the hand-written kernel,
    # ops/flash_attention.py), "ring" (sequence-parallel; not ported yet).
    attention_impl: str = "dot"
    # Compute Q/K/V with ONE [D, 3D] matmul over weights concatenated at
    # apply time (the parameter layout keeps separate q/k/v, so
    # checkpoints are unaffected).
    fused_qkv: bool = False
    # Mesh axis names of the sequence-parallel path; kept so manifests
    # written by the JAX package load unchanged.
    ring_axis: str = "seq"
    data_axis: str = "data"
    remat: bool = False

    def __post_init__(self) -> None:
        if self.n_layers < 1:
            raise ValueError(f"n_layers={self.n_layers} must be >= 1")
        if self.max_len > self.max_position_embeddings:
            raise ValueError(
                f"max_len={self.max_len} exceeds the position-embedding table "
                f"(max_position_embeddings={self.max_position_embeddings}); "
                "position indices would run off the table"
            )
        if self.attention_impl not in ("dot", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.gelu not in ("exact", "tanh"):
            raise ValueError(f"unknown gelu {self.gelu!r} (exact|tanh)")

    @property
    def head_dim(self) -> int:
        if self.dim % self.n_heads:
            raise ValueError(f"dim={self.dim} not divisible by n_heads={self.n_heads}")
        return self.dim // self.n_heads

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def distilbert_base(cls, **kw: Any) -> "ModelConfig":
        return cls(**kw)

    @classmethod
    def bert_base(cls, **kw: Any) -> "ModelConfig":
        """BERT-base-sized scale-up encoder (BASELINE.json config 4)."""
        kw.setdefault("n_layers", 12)
        return cls(**kw)

    @classmethod
    def bert_large(cls, **kw: Any) -> "ModelConfig":
        """BERT-large-sized encoder (24L/1024/16H/4096, ~335 M params)."""
        kw.setdefault("n_layers", 24)
        kw.setdefault("dim", 1024)
        kw.setdefault("n_heads", 16)
        kw.setdefault("hidden_dim", 4096)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw: Any) -> "ModelConfig":
        """Small config for tests / CI on CPU."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_len", 32)
        kw.setdefault("max_position_embeddings", 64)
        kw.setdefault("dim", 32)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 2)
        kw.setdefault("hidden_dim", 64)
        kw.setdefault("compute_dtype", "float32")
        kw.setdefault("gelu", "exact")  # fp32 tests compare against HF erf
        return cls(**kw)
